#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --pairs N
    python3 chip_smoke.py --serve
    python3 chip_smoke.py --chaos
    python3 chip_smoke.py --dist
    python3 chip_smoke.py --multihost

With ``--pairs N`` it builds the kernels and runs only N alternating
pairs of each cube16 path (phases 2 and 4) at ``cycle_block=1`` and at
the default, blocks of 9, after one unmeasured pair, and prints the walls,
the output sizes and qualities and the paired wall differences as one
JSON line before the last.  With ``--serve`` it runs phases 1 and 7
alone, with ``--chaos`` phases 1 and 6b (making the [grouped] output it
compares with), with ``--dist`` phases 1 and 6c, with ``--multihost``
phases 1 and 6d.  Without arguments:

Phases (any failure exits non-zero without the final result line):

1. build   - compile every CUDA kernel of ``parmmg_tpu_torch/csrc`` (one
             ``nvcc`` per source, in parallel); print the card's name and
             power limit as nvidia-smi reports them.
2. main    - the port's CLI remesh (``parmmg_tpu_torch.cli.main``) of the
             structured cube_mesh(16) (24,576 tets) under the planar "shock"
             iso metric h = 1.5/16 * (0.2 + 4 |x - 0.5|), one iteration, on
             the card, at the default: blocks of 9 self-width-selecting
             cycles (``ops/active.py``), the JAX package's accelerator
             configuration.  Kernel launch counts are zeroed just before
             and read just after; every kernel of the iso path (K1, K3-K8)
             must have launched, and K2 must not.  The output mesh is read
             back and checked: conforming adjacency, no live tet of volume
             <= 0, qmin > 0, tet count within 2% of the JAX CLI's at
             PARMMG_CYCLE_BLOCK=9 on this input (139,206).  Prints the
             cycles, how many ran narrow (on an [A]-row sub-mesh) and how
             many narrow attempts were discarded, the active tets against
             A (mean, max), the host reads a cycle (the synchronizing calls
             inside ``adapt_mesh``, polish included, that PyTorch's sync
             debug mode reports) and the sorts (K7, K8) at sub-mesh widths,
             all of which must have launched their kernel, and there must
             be some where a cycle ran narrow.  Fails unless a cycle ran
             narrow (the JAX CLI ran 27 of its 50 narrow); so do phases 4
             and 5 (10 and 27 of 50).  Records the rows and selected rows
             of every K3 / K4 call (no host read added) and prints their
             median and largest rows and selected shares; the reruns of
             phases 3 and 4 capture the inputs of the densest call (the
             largest selected share) for phase 8.
3. repeat  - the main path twice more: once as it is, once with the sort
             engine's wrappers (radix_sort, merge_prefix, segment_flags)
             swapped for their plain versions.  Both must write the same
             bytes (.mesh and .sol) as phase 2's run.  Then once at
             ``cycle_block=1``, one full-width cycle a dispatch: conforming,
             its tet count within 2% of the JAX CLI's 111,116 at block 1,
             its wall printed beside the block-9 run's.
4. aniso   - the same CLI on cube_mesh(16) under the planar "shock" tensor
             metric (spacing 1.5/48 * (0.2 + 4 |x - 0.5|) across the plane
             x = 0.5, 0.1 along it), one iteration, launch counts zeroed
             just before and read just after: every kernel of the tensor
             path (K2-K8) must have launched, and K1 must not.  Checked as
             phase 2, with qmin > 0 in the tensor metric's quality, the tet
             count within 2% of the JAX CLI's at block 9 (327,908), a
             SOL_TENSOR output ``.sol``, and a second run writing the same
             bytes.
             Prints the narrow-cycle lines of phase 2.
5. field   - the CLI remesh of sphere_mesh(16) (4,913 points, 24,576 tets,
             the unit ball) read from a ``.vtu`` file with three point
             fields: ``metric``, the shock size map carried onto the ball,
             (3/16) (0.2 + 2 |x|) (the cube16 map with lengths doubled;
             the JAX CLI writes 131,901 tets from it at block 9), and
             ``temp`` and
             ``vel``, a scalar and a 3-vector linear in x, y and z.  All
             flags default but ``-niter 1``: the hausd bound, ridge
             detection and the curved-boundary moves are on, and the two
             fields are P1-interpolated from a background copy of the
             input.  Launch counts zeroed just before and read just after:
             K1 and K3-K8 must have launched (K7 and K8 also from the
             field step's surface triangulation), K2 must not.
             ``driver.interpolate_fields`` is wrapped to capture its
             inputs, outputs and wall time.  Checked: the written
             ``.vtu`` read back is conforming with qmin > 0; the tet count
             within 2% of the JAX CLI's; at the interior output vertices
             whose walk did not fail, temp and vel equal the linear
             functions within 1e-4 max|f|; the captured meshes run through
             ``interpolate_fields`` on the CPU give every value within
             1e-5 max|f| of the card's; ``surface_triangulation`` on the
             card equals its CPU run bit for bit.  Prints the
             interpolation's wall time, the walk steps (mean, max), the
             failed walks that took the exhaustive search and the boundary
             points that took the surface walk, and the wall times of the
             volume walk, the exhaustive search and the surface location,
             each run again alone, and the narrow-cycle lines of phase 2.
6. grouped - the CLI with the reference CI's standard flags, ``-mesh-size
             16384 -niter 2``, on cube_mesh(32) (35,937 points, 196,608
             tets: 12 groups a pass) under the cube16 iso shock map, all
             else default (blocks of 9 cycles; unchunked, the stacked
             state fitting the card): ``parallel/groups.py``'s split /
             frozen-seam remesh / seam displacement loop.  Launch counts
             zeroed just before and read just after: K1 and K3-K8 must
             have launched, K2 must not.  Checked: a conforming output
             with qmin > 0, its tet count within 2% of the JAX CLI's at
             PARMMG_CYCLE_BLOCK=9 (229,193), 12 groups in both passes.
             Three more runs must write the same bytes: one before it
             under PyTorch's sync debug mode (it counts the host reads;
             its wall is not compared), one at chunk 8 (the state on the
             host, 8 groups a dispatch) and one with the incremental
             topology engine's band merges on, which must merge at least
             one band with every K5, K7 and K8 call of ``ops/topo_incr``
             launching its kernel.  Prints the groups a pass, the chunk,
             cycles and group-cycles, the active groups a block,
             dispatches (and saved), masked slots, the chunked run's
             pipeline segment seconds, host reads a group-cycle, the band
             merges, their widths and the kernels' shapes there, and each
             run's wall.
6c. dist   - the distributed path (``parallel/dist.py``, ``comms.py``,
             ``analysis_dev.py``, ``migrate.py``, ``migrate_dev.py``): the
             CLI with ``-ndev 4 -niter 2`` (the reference CI's) on the
             [grouped] input, four shards stacked on the card (the split,
             the communicators and their coordinate + metric echo, two
             passes of blocks of 9 cycles on every shard with the device
             analysis refresh, between them the repartitioning: flood
             labels, their repair, the band migration, the weld,
             ``rebuild_shards``, the echo; one merge), then the polish and
             the run tail.  Launch counts zeroed just before and read just
             after: K1 and K3-K8 must have launched, K2 must not, and K5,
             K7 and K8 must have launched inside the migration step (read
             between the ``dist.refresh`` and ``dist.migrate`` spans).
             Checked: a conforming output with qmin > 0, its tet count
             within 2% of the JAX CLI's (``tools/jax_cli_reference.py 32
             --metric-n 16 --ndev 4 --niter 2 --block 9``: 235,452); the
             echo 0 mismatches at the split, after the migration and on
             the adapted shards; tets moved on the band path and no
             full-view fallback; a run before it under PyTorch's sync
             debug mode (it counts the host reads) writes the same bytes;
             a ``-distributed-output`` run writes 4 rank files whose
             communicator sections, read back, pass ``check_node_comms`` /
             ``check_face_comms``; the one-pass run (``-niter 1``)
             conforming, echo 0, K1 and K3-K8 launched and K2 not, its
             tet count within 2% of the JAX CLI's (``--niter 1``:
             253,749); a graph-mode run through ``ParMesh``
             (``REPART_GRAPH``) at 4 shards and 2 passes on cube_mesh(16)
             from the decomposition ``end_slabs_partition`` (as a
             distributed input hands it to the run) is conforming with
             qmin > 0, echo 0, tets moved and no full-view fallback.
             Prints the wall, dist cycles, active shards a cycle, live
             tets a shard, the ``dist.adapt`` / ``dist.refresh`` /
             ``dist.migrate`` / ``dist.merge`` span seconds, the moved
             tets, interface faces and shared vertices of the migration,
             host reads a dist cycle and in the migration step, the band
             exchange bytes, one shard's record extraction time, the
             migration step's launches and the phase's.
6d. multihost - several processes (``parallel/multihost.py``, ``pod.py``,
             the pod runner ``parallel/multihost_run.py``): the kernels
             built here first, the runner runs [dist]'s input
             (cube_mesh(32), 196,608 tets, the cube16 iso shock map) through
             ``distributed_adapt_multi`` at 4 shards, 2 passes of 10 cycles
             in blocks of 9: a one-process reference, then 2 ranks x 2
             shards on the one card over gloo (collectives staged through
             the host).  Each rank zeroes its launch counts just before the
             run and reads them just after.  Checked: every rank's merged
             mesh and metric hash equal the reference's;
             ``mh.hot_allgather_bytes`` 0 and ``mh.band_exchange_bytes``
             above 0 on every rank; K1 and K3-K8 launched in each rank and
             K2 not; no ``nvcc`` build inside a rank; rank 0's merged mesh
             conforming with qmin > 0.  Then the drills on cube_mesh(12)
             under the cube8 map (2 passes of 4 cycles, checkpoints on),
             both packs at once (each over a file store of its own, so
             they never race for a port): rank 1 killed at its pass-1 exchange,
             the pack relaunched with resume; rank 1 wedged there, the
             heartbeat lease kills the pack (rc 9) and the same resume;
             each must end with the bytes of a one-process run.  Prints
             tets, qmin, qmean, the ranks' walls beside the one-process
             wall, band bytes beside the hot collective bytes (every
             collective inside ``hot_path``), allgather and collective
             bytes, and the drills' return codes.
6b. chaos  - the resilience layer (``resilience/``, ``parallel/groups.py``,
             ``_polish_worker.py``), each drill held to the fault-free
             bytes.  The [grouped] input and flags at chunk 8: (1)
             PMTORCH_CKPT_DIR armed: [grouped]'s bytes, 2 pass checkpoints,
             12 shard files a pass, no new shape in the ledger; (2) an nth-1
             ``dispatch.chunk`` fault: the bytes, the retry rung; (3)
             ``dispatch.chunk:hang=3;nth-1`` under a 0.5 s dispatch
             deadline, grace 0: the bytes, a watchdog expiry; (4) a CLI
             subprocess SIGKILLed once ``grouped.pass0.npz`` appears, then
             ``-resume``: the bytes, one resume.  cube_mesh(12) under the
             shock map h = 1.5/8 at ``-mesh-size 1728 -niter 2`` (6
             groups), chunk 4: (5) ``io.checkpoint`` armed: its unarmed
             bytes, no ``.npz`` or ``.tmp``; (6) every dispatch failing, 1
             retry: PMMG_LOWFAILURE, a conforming output; (7) a
             ``grouped_adapt_pass(polish=True)`` with the subprocess worker
             (PMTORCH_POLISH_SUBPROC) equals the in-process polish, the
             worker's launches on the card; (8) a dead worker and a hung
             one (PMTORCH_POLISH_TIMEOUT_S 5) each equal the polish-less
             pass, no staging left.  (9) PMTORCH_PROFILE_DIR over pass 1 of
             cube_mesh(4) at ``-mesh-size 192`` (2 groups), a CLI
             subprocess: one Chrome trace with CUDA kernel events, the
             unprofiled run's bytes.  Launch counts summed over the phase's
             runs in this process: K1 and K3-K8, not K2.  Prints each run's
             wall, the checkpoint seconds and bytes a pass (npz and shard
             snapshot) beside the pass's wall, the resumed run's wall, the
             retry's cost, the worker's cold start and polish seconds and
             the trace's size.
7. serve   - remeshing as a service: a ``PoolDaemon`` in this process
             (``parmmg_tpu_torch/serve/``; two slots a bucket, 6 cycles a
             tenant, one tenant a dispatch, streaming admission and
             autoscale on) is sent eight tenants over localhost HTTP by
             the port's ``ServeClient``, open loop at two a second (429s
             retried and counted): four classes of two, cube_mesh(12)
             under the iso shock map h = 1.5/12, cube_mesh(16) and
             cube_mesh(24) under the cube16 map, cube_mesh(12) under the
             [aniso] tensor map, the second tenant of a class with sizes
             x 1.1 (``serve_tenants``).  Launch counts zeroed before the
             first submit and read after the last fetch: all eight
             kernels, K2 and K6's tensor mode included.  Checked: every
             tenant done and its fetched mesh conforming with qmin > 0;
             the first tenant of each class byte-equal (every field and
             the metric) to its standalone ``grouped_adapt_pass(ngroups=
             1, cycles=6)`` on the card, staged by the same
             ``stage_arrays``, with a tet count within 2% of the JAX
             pool's (JAX_POOL_NTETS, ``tools/jax_serve_reference.py``);
             then the two iso12 tenants again, packed in one dispatch,
             with ``serve.slot_step`` armed on the second: it ends
             quarantined, the first writes the first run's bytes, and
             its distributed output (written at retirement) read back
             holds its live tets.  Prints meshes a second, latency p50 /
             p90 / p99, each tenant's result, queue depth and bucket
             occupancy over time, stream admissions, deferred submits,
             autoscale decisions, steps, dispatches, promotions, the
             pipeline's segment seconds and each standalone run's wall.
8. kernels - each kernel against its plain PyTorch version on the card, on
             the output mesh of its path (the capacities that path
             reached; K2 and K6's tensor mode on the aniso output and its
             metric), with its tolerance; median CUDA-event times of the
             kernel, the plain version and, where one PyTorch call computes
             the same function, that call; the profiler's device time a
             call, warm and cold (the L2 flushed before every call); the
             least time the card could take (bytes / 3.35 TB/s, operations
             / 67 TFLOP/s float32; K3 and K4 count the values of the
             selected edges only).  K8 runs on the sorted edge keys and
             face keys and, in its gathered mode, on the unsorted keys with
             K7's permutation, beside the unfused pair it replaced (the
             gather, then sorted-mode K8) as its yardstick.  K5 also on
             the [grouped] run's first band merge (the survivor flags of
             a group's edge sort) and K7 on its first edge band (keys and
             slots, 2 words).  K3 and K4 also on the call with the largest
             selected share that the iso and tensor paths gave them.  K2's
             row also gives its head share (the rows whose clipped ids
             differ from the row before: the ones it evaluates).
9. stress  - K3, K4, K5, K7 and K8 against their plain versions, exactly,
             each case 5 times (look-back order changes from run to run).
             K1 within 2e-5 / 2e-6 (NaN exactly where the plain version is
             NaN) and the same bits in every run on the rows of
             ``_k2_cases`` under an iso size map, with NaN and +-inf in
             point rows, in sizes, and in both.
             K2 within 3e-5 / 3e-6 (NaN where the plain version is NaN)
             and the same bits in every run, on 1, 3, 5, 7, 9, 255, 257,
             4097 and 2**24 + 3 rows of each of ``_k2_cases``: sorted runs
             with an INT32_MAX tail, the same viewed at a one-row offset,
             ids out of range, a long INT32_MAX tail, unsorted ids, NaN
             and +-inf in point and tensor rows, the tensors viewed at a
             one-float offset.
             K3 / K4 (output bits and count): 1, 3, 5, 7, 9, 15, 17, 4095,
             4097 and 2**24 + 3 rows, NaN and +-inf among the values, masks
             of 3% and 50%, the mask and the values each aligned or at a
             1-element offset.  K5, K7 and K8: sizes 1,
             tile - 1, tile, tile + 1 and 2**24 + 3 (the look-back crosses
             thousands of tiles); K5 on small values and on values near
             +-2**31 whose sums wrap; K7 on full-range 32-bit keys with
             negatives, all-equal, sorted and reverse-sorted keys, all
             tombstones, (16, 32) bits with tombstones, and 3 words with
             nbits (8, 16, 32); K8 in both modes on 1-3 words with
             tombstones, aligned and viewed at a 1-element offset.  A
             failure here is a look-back, stability or tail bug of the
             kernel, not a mesh bug.  Also K5 and K7 at every (rows,
             words) the [grouped] run's band merges gave them, and K3, K4,
             K5 and K7 on two streams at once (their scratch is per
             stream).
10. profile - the cube16 paths once more under torch.profiler, recording
             the device's activity only: the device busy share of the wall
             and the kernels that take it, read from the raw events; then
             once more with one auto cycle halfway through recorded with
             host and device activity: its top ops by self device time and
             its busy share by the device's events and by the sum over
             ``key_averages``.

Phase 8 also prints the CUDA launches per K2-K8 call (the profiler's
kernel count over 20 calls / 20) and fails unless K2-K6 and K8 (both
modes) are one launch a call and K7 1 + npass.

The last two lines are one JSON object with the kernel table (each row's
launches on the main path, and on the field, grouped, dist, serve and
chaos paths) and
one JSON object ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
F32_OPS_PER_S = 67e12               # H100 SXM float32 outside tensor cores
# the JAX CLI's tet count on each path's input in its accelerator
# configuration (blocks of 9 auto cycles), and how far the port's may lie
# from it: tools/jax_cli_reference.py 16 [--aniso | --sphere] --block 9
# and, for [grouped], 32 --metric-n 16 --mesh-size 16384 --niter 2
# --block 9 (on the CPU); and the cycles of those runs that ran narrow, of
# 50
JAX_CLI_NTETS = {"cube16": 139206, "cube16ani": 327908,
                 "sphere16": 131901, "cube32": 229193}
JAX_CLI_NARROW = {"cube16": 27, "cube16ani": 10, "sphere16": 27}
# the same at one cycle a dispatch (--block 1, the JAX package's default
# off the TPU)
JAX_CLI_NTETS_BLOCK1 = {"cube16": 111116, "cube16ani": 210234,
                        "sphere16": 98439}
NTETS_BOUND = 0.02
# the kernels each path must launch, and the one it must not
PATH_KERNELS = {
    "cube16": ({"edge_lengths_iso", "score_count", "score3_count",
                "tet_quality", "merge_prefix", "radix_sort",
                "segment_flags"}, "edge_lengths_ani"),
    "cube16ani": ({"edge_lengths_ani", "score_count", "score3_count",
                   "tet_quality", "merge_prefix", "radix_sort",
                   "segment_flags"}, "edge_lengths_iso"),
    "sphere16": ({"edge_lengths_iso", "score_count", "score3_count",
                  "tet_quality", "merge_prefix", "radix_sort",
                  "segment_flags"}, "edge_lengths_ani"),
}
PATH_KERNELS["cube32"] = PATH_KERNELS["cube16"]
# the [serve] tenants: four classes of two, (class, cube_mesh(n), size
# map, h); the second tenant of a class has the first's sizes x 1.1
SERVE_CLASSES = (("iso12", 12, "iso", 1.5 / 12),
                 ("cube16", 16, "iso", 1.5 / 16),
                 ("cube24", 24, "iso", 1.5 / 16),
                 ("ani12", 12, "ani", 1.5 / 48))
SERVE_SCALE = 1.1


def serve_tenants():
    """[(tenant id, class, vert, tet, met)] of the [serve] phase, the first
    tenant of every class before the second ones: cube_mesh(n) under the
    planar shock size map h (0.2 + 4 |x - 0.5|) ("iso"), or under the
    shock tensor metric with that spacing across the plane x = 0.5 and
    0.1 along it ("ani", ``analytic_ani_metric``); numpy arrays, also read
    by ``tools/jax_serve_reference.py``."""
    from parmmg_tpu_torch.utils.fixtures import (analytic_ani_metric,
                                                 analytic_iso_metric,
                                                 cube_mesh)
    out = []
    for k, s in enumerate((1.0, SERVE_SCALE)):
        for cls, n, kind, h in SERVE_CLASSES:
            vert, tet = cube_mesh(n)
            if kind == "ani":
                met = analytic_ani_metric(vert, "shock", h=s * h,
                                          h_tan=s * 0.1)
            else:
                met = analytic_iso_metric(vert, "shock", h=s * h)
            out.append((f"{cls}-{k}", cls, vert, tet, met))
    return out


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, kernels, reps: int = 20, cold: bool = False):
    """(device ms, device launches) per call of ``fn`` under torch.profiler
    over ``reps`` calls: the time of the CUDA kernels whose name contains
    one of ``kernels`` (a string or a tuple; None: every kernel, memset and
    copy on the device), None when the profiler records no device time; and
    every kernel, memset or copy on the device per call.  ``cold`` flushes
    the L2 before every call by writing a 128 MiB buffer, so the card's 50
    MB L2 holds none of the call's inputs (the write is a fill kernel or
    a memset, which the names of the kernels timed never match; it is
    counted in the launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = (kernels,) if isinstance(kernels, str) else kernels
    if cold and names is None:
        raise ValueError("a cold time needs the kernels' names")
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the profiler drops device records stamped outside its window, and
        # the device's clock can sit a little off the host's: keep 10 ms of
        # host time on either side so that 20 short calls (under 1 ms in
        # all) all fall inside it
        time.sleep(0.01)
        for _ in range(reps):
            if cold:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
        time.sleep(0.01)
    tot = 0.0
    count = 0
    for ev in prof.key_averages():
        on_card = ev.device_type == DeviceType.CUDA
        if on_card:
            count += ev.count
        if on_card if names is None else any(k in ev.key for k in names):
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            tot += t
    return (tot / reps / 1e3 if tot > 0 else None), count / reps


def _bound(nbytes: float, nops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_build():
    from parmmg_tpu_torch.ops import cuda_build
    secs = cuda_build.build_all(verbose=True)
    print(f"[build] nvcc wall {secs:.2f} s for {len(cuda_build.SOURCES)} "
          "sources")
    print(_card_line())


def _write_input(workdir: str, stem: str, n: int = 16,
                 metric_n: int | None = None):
    """cube_mesh(n) and its metric: iso shock for "cube16" (h = 1.5 /
    metric_n, metric_n defaulting to n), tensor shock for "cube16ani"."""
    import numpy as np
    from parmmg_tpu_torch.io.medit import (MeditMesh, SOL_SCALAR, SOL_TENSOR,
                                           write_mesh, write_sol)
    from parmmg_tpu_torch.utils.fixtures import (analytic_ani_metric,
                                                 analytic_iso_metric,
                                                 cube_mesh)
    vert, tet = cube_mesh(n)
    m = MeditMesh()
    m.vert, m.vref = vert, np.zeros(len(vert), np.int32)
    m.tetra, m.tref = tet, np.ones(len(tet), np.int32)
    write_mesh(os.path.join(workdir, f"{stem}.mesh"), m)
    if stem.endswith("ani"):
        met = analytic_ani_metric(vert, "shock", h=1.5 / (3 * n), h_tan=0.1)
        types = [SOL_TENSOR]
    else:
        met = analytic_iso_metric(vert, "shock", h=1.5 / (metric_n or n))
        types = [SOL_SCALAR]
    write_sol(os.path.join(workdir, f"{stem}.sol"), met, types)


def _read_output(path: str, device: str = "cuda", capP=None, capT=None):
    """(mesh with adjacency, metric [capP] or [capP, 6], .sol types) of a
    written output ``path`` (.mesh), spare metric rows 1 / the identity."""
    import torch
    from parmmg_tpu_torch.core.mesh import make_mesh
    from parmmg_tpu_torch.io.medit import read_mesh, read_sol
    from parmmg_tpu_torch.ops.adjacency import build_adjacency
    mo = read_mesh(path)
    vals, types = read_sol(path[:-len(".mesh")] + ".sol")
    dev = torch.device(device)
    mesh = build_adjacency(make_mesh(mo.vert, mo.tetra, capP=capP,
                                     capT=capT, device=dev))
    n_p = len(mo.vert)
    if vals.shape[1] == 6:
        met = torch.tensor([1, 0, 0, 1, 0, 1.0], device=dev).repeat(
            mesh.capP, 1)
    else:
        met = torch.ones(mesh.capP, device=dev)
        vals = vals[:, 0]
    met[:n_p] = torch.from_numpy(vals).to(dev, torch.float32)
    return mesh, met.contiguous(), types


class _ScoreTap:
    """Stands in for ``kernels.score_count`` / ``score3_count`` (K3 / K4)
    over a run: records every call as (kernel, rows, count), the count kept
    as its 0-d tensor and read only after the run (no host read is added),
    and clones the inputs of the calls whose indices are in ``capture``."""
    NAMES = ("score_count", "score3_count")

    def __init__(self, capture=()):
        self.capture = set(capture)
        self.calls, self.inputs = [], {}

    def __enter__(self):
        from parmmg_tpu_torch.ops import kernels
        self._real = {n: getattr(kernels, n) for n in self.NAMES}
        for name, fn in self._real.items():
            def call(mask, *vals, _fn=fn, _name=name):
                out = _fn(mask, *vals)
                if len(self.calls) in self.capture:
                    self.inputs[len(self.calls)] = tuple(
                        t.clone() for t in (mask, *vals))
                self.calls.append((_name, mask.shape[0], out[1]))
                return out
            setattr(kernels, name, call)
        return self

    def __exit__(self, *exc):
        from parmmg_tpu_torch.ops import kernels
        for name, fn in self._real.items():
            setattr(kernels, name, fn)

    def counts(self):
        """[(kernel, rows, selected rows)] of every call, in call order."""
        return [(k, n, int(c)) for k, n, c in self.calls]


def _score_picks(tag: str, calls):
    """Print the rows and selected shares K3 and K4 were given over a run
    (``_ScoreTap.counts``); returns {kernel: {"densest": call index,
    "largest": call index}}: the largest selected share (ties: more rows)
    and the most rows (ties: more selected)."""
    import numpy as np
    picks = {}
    for name in _ScoreTap.NAMES:
        idx = [i for i, c in enumerate(calls) if c[0] == name]
        if not idx:
            continue
        n = np.array([calls[i][1] for i in idx])
        sel = np.array([calls[i][2] for i in idx])
        share = sel / np.maximum(n, 1)
        dense = idx[max(range(len(idx)), key=lambda j: (share[j], n[j]))]
        large = idx[max(range(len(idx)), key=lambda j: (n[j], sel[j]))]
        picks[name] = {"densest": dense, "largest": large}
        print(f"[{tag}] {name} calls {len(idx)}: rows median "
              f"{int(np.median(n))} max {int(n.max())}; selected share "
              f"median {float(np.median(share)):.4f} max "
              f"{float(share.max()):.4f}; densest call {calls[dense][1]} "
              f"rows, {calls[dense][2]} selected; largest call "
              f"{calls[large][1]} rows, {calls[large][2]} selected")
    return picks


def _score_capture(tap: "_ScoreTap", calls, picks):
    """{kernel: {pick: (inputs, rows, selected)}} of a rerun's captured
    calls, after checking that the rerun made the same K3 / K4 calls."""
    if tap.counts() != calls:
        raise RuntimeError("a rerun of the path made other K3 / K4 calls "
                           "than the first run")
    return {name: {k: (tap.inputs[i], calls[i][1], calls[i][2])
                   for k, i in p.items()} for name, p in picks.items()}


def phase_path(workdir: str, stem: str, device: str = "cuda"):
    """One path of the CLI remesh (phase 2 "cube16" or phase 4
    "cube16ani"): launch counts, output checks; returns (launches, the
    largest shapes each kernel wrapper was given, with every K3 / K4 call's
    rows and selected rows under "score_calls" and the densest and largest
    of them under "score_picks")."""
    from parmmg_tpu_torch.io.medit import SOL_TENSOR
    from parmmg_tpu_torch.ops import kernels

    tag = "main" if stem == "cube16" else "aniso"
    _write_input(workdir, stem)
    out = os.path.join(workdir, f"{stem}.o.mesh")
    # record the largest shapes each kernel wrapper is given on the path
    shapes = {"capP": 0, "capT": 0, "capE": 0}
    wrapped = {}
    for name in ("edge_lengths_iso", "edge_lengths_ani", "tet_quality"):
        fn = getattr(kernels, name)

        def rec_shape(*a, _fn=fn, _name=name, **k):
            shapes["capP"] = max(shapes["capP"], a[0].shape[0])
            key = "capT" if _name == "tet_quality" else "capE"
            shapes[key] = max(shapes[key], a[2 if key == "capE" else 1]
                              .shape[0])
            return _fn(*a, **k)
        wrapped[name] = fn
        setattr(kernels, name, rec_shape)
    try:
        with _cycle_watch(count_reads=device == "cuda") as info, \
                _ScoreTap() as tap:
            launches, rec, wall = _run_main(workdir, stem, out, device)
    finally:
        for name, fn in wrapped.items():
            setattr(kernels, name, fn)
    shapes["score_calls"] = tap.counts()
    mesh, met, types = _read_output(out, device)
    aniso = met.dim() == 2
    bad, qmin, qmean = _check_conforming(stem, mesh, met if aniso else None)
    nbnd = int(((mesh.adja < 0) & mesh.tmask[:, None]).sum())
    if aniso != stem.endswith("ani") or (aniso and types != [SOL_TENSOR]):
        raise RuntimeError(f"{stem}: output .sol types {types}")
    print(f"[{tag}] {stem} -niter 1: ntets {rec['ntets']} qmin "
          f"{rec['qmin']:.6f} qmean {rec['qmean']:.6f} cycles "
          f"{rec['cycles']} splits {rec['nsplit']} collapses "
          f"{rec['ncollapse']} swaps {rec['nswap']} wall {wall:.3f} s")
    print(f"[{tag}] re-read output: {int(mesh.tmask.sum())} tets, {nbnd} "
          f"boundary faces, adjacency {bad}, qmin {qmin:.6f} qmean "
          f"{qmean:.6f}{' (tensor metric)' if aniso else ''}, .sol types "
          f"{types}")
    print(f"[{tag}] launches {launches}; largest capP {shapes['capP']} "
          f"capT {shapes['capT']} capE {shapes['capE']}")
    _print_cycles(tag, stem, info, device)
    shapes["score_picks"] = _score_picks(tag, shapes["score_calls"])
    must, must_not = PATH_KERNELS[stem]
    missing = sorted(k for k in must if launches[k] == 0)
    if missing or launches[must_not]:
        raise RuntimeError(f"{stem}: kernels never launched {missing}, "
                           f"{must_not} launched {launches[must_not]} "
                           f"times ({launches})")
    ref = JAX_CLI_NTETS[stem]
    if abs(rec["ntets"] - ref) > NTETS_BOUND * ref:
        raise RuntimeError(f"{rec['ntets']} tets: not within "
                           f"{NTETS_BOUND:.0%} of the JAX CLI's {ref} on "
                           "this input")
    return launches, shapes


@contextlib.contextmanager
def _cycle_watch(count_reads: bool):
    """Watch one CLI run's adaptation: yields a dict filled when the run
    is over with ``stats`` (the AdaptStats of ``adapt_mesh``), the auto
    blocks' narrow widths ``A`` and their counts rows, the narrow cycles
    at an ``A`` below the mesh's capT (``narrow_sub``), the narrow cycles
    discarded (``ops/active.COUNTS``), the sort calls (K7, K8) at a
    sub-mesh width and how many of them launched their kernel and, with
    ``count_reads``, ``reads``: the synchronizing calls inside
    ``adapt_mesh`` that PyTorch's sync debug mode reports (one warning
    each)."""
    import warnings
    import torch
    from parmmg_tpu_torch import driver
    from parmmg_tpu_torch.ops import active, kernels
    info = {"stats": [], "blocks": [], "reads": 0, "narrow_sorts": 0,
            "narrow_sort_launches": 0, "narrow_sub": 0}
    widths = set()
    real_adapt, real_auto = driver.adapt_mesh, active.adapt_cycles_auto
    real_sorts = {n: getattr(kernels, n)
                  for n in ("radix_sort", "segment_flags")}

    def adapt(*a, **k):
        if not count_reads:
            out = real_adapt(*a, **k)
        else:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = real_adapt(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            info["reads"] += sum("synchroniz" in str(w.message)
                                 for w in seen)
        info["stats"].append(out[2])
        return out

    def auto(mesh, *a, **k):
        A = active.narrow_rows(mesh.capT)
        if A < mesh.capT:
            widths.update((4 * A, 6 * A))
        out = real_auto(mesh, *a, **k)
        info["blocks"].append((A, out[4].tolist()))
        if A < mesh.capT:
            info["narrow_sub"] += int(out[4][:, 7].sum())
        return out

    def sort_watch(name):
        def call(words, *a, **k):
            before = kernels.LAUNCHES[name]
            out = real_sorts[name](words, *a, **k)
            if words[0].shape[0] in widths:
                info["narrow_sorts"] += 1
                info["narrow_sort_launches"] += \
                    kernels.LAUNCHES[name] - before
            return out
        return call
    c0 = dict(active.COUNTS)
    driver.adapt_mesh, active.adapt_cycles_auto = adapt, auto
    for n in real_sorts:
        setattr(kernels, n, sort_watch(n))
    try:
        yield info
    finally:
        driver.adapt_mesh, active.adapt_cycles_auto = real_adapt, real_auto
        for n, fn in real_sorts.items():
            setattr(kernels, n, fn)
        info.update({k: active.COUNTS[k] - c0[k] for k in c0})


def _print_cycles(tag: str, stem: str, info: dict, device: str = "cuda"):
    """The narrow-cycle lines of a watched run (:func:`_cycle_watch`).
    Fails unless a cycle ran narrow where the JAX CLI ran one on the same
    input, and on the card unless the narrow cycles sorted at their
    sub-mesh widths and every such sort launched its kernel."""
    import numpy as np
    cycles = sum(st.cycles for st in info["stats"])
    rows = [(A, r) for A, rr in info["blocks"] for r in rr]
    info["narrow"] = sum(r[7] for _, r in rows)
    ratio = np.array([r[8] / A for A, r in rows]) if rows else np.zeros(1)
    As = sorted({A for A, _ in info["blocks"]})
    print(f"[{tag}] {stem} cycles {cycles}: {len(rows)} in "
          f"{len(info['blocks'])} auto blocks, narrow {info['narrow']} "
          f"(the JAX CLI at block 9: {JAX_CLI_NARROW[stem]} of 50), "
          f"narrow attempts discarded {info['discarded']}")
    print(f"[{tag}] active tets / A over the auto cycles: mean "
          f"{float(ratio.mean()):.4f} max {float(ratio.max()):.4f} "
          f"(A {As}; a narrow cycle needs <= 0.75)")
    if info["reads"]:
        print(f"[{tag}] host reads {info['reads']} in adapt_mesh (polish "
              f"included) = {info['reads'] / max(cycles, 1):.1f} a cycle")
    print(f"[{tag}] sorts at sub-mesh widths: {info['narrow_sorts']} K7/K8 "
          f"calls, {info['narrow_sort_launches']} launched their kernel")
    if JAX_CLI_NARROW[stem] and not info["narrow"]:
        raise RuntimeError(f"{stem}: no cycle ran narrow; the JAX CLI ran "
                           f"{JAX_CLI_NARROW[stem]} narrow on this input")
    if device == "cuda" and (
            info["narrow_sorts"] != info["narrow_sort_launches"]
            or (info["narrow_sub"] and not info["narrow_sorts"])):
        raise RuntimeError(f"[{tag}] {info['narrow_sub']} narrow cycles "
                           f"on fewer rows than the mesh made "
                           f"{info['narrow_sorts']} sorts at a sub-mesh "
                           f"width, {info['narrow_sort_launches']} of which "
                           "launched their kernel")


def _run_main(workdir: str, stem: str, out: str, device: str = "cuda",
              flags=("-niter", "1")):
    """The CLI remesh of ``stem``'s input once, written to ``out``, with
    ``flags``, launch counts zeroed just before and read just after.
    Returns (launches, the -bench-json record, wall seconds)."""
    import torch
    from parmmg_tpu_torch import cli
    from parmmg_tpu_torch.ops import kernels
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    kernels.reset_launches()
    sync()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-in", os.path.join(workdir, f"{stem}.mesh"), "-sol",
                       os.path.join(workdir, f"{stem}.sol"), "-out", out,
                       *flags, "-v", "1", "-bench-json", "-device",
                       device])
    sync()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log = buf.getvalue()
    with open(out + ".log", "w") as f:
        f.write(log)
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}:\n{log[-2000:]}")
    rec = json.loads([ln for ln in log.splitlines()
                      if ln.startswith("{")][-1])
    return launches, rec, wall


def _check_conforming(what: str, mesh, met=None):
    """(adjacency check, qmin, qmean) of a re-read output; raises unless
    it is conforming with no live tet of volume <= 0 and qmin > 0."""
    from parmmg_tpu_torch.core.mesh import tet_volumes
    from parmmg_tpu_torch.ops.adjacency import check_adjacency
    from parmmg_tpu_torch.ops.quality import tet_quality
    bad = check_adjacency(mesh)
    nneg = int(((tet_volumes(mesh) <= 0) & mesh.tmask).sum())
    q = tet_quality(mesh, met)
    qmin = float(q[mesh.tmask].min())
    qmean = float(q[mesh.tmask].mean())
    if bad["asymmetric"] or bad["face_mismatch"] or nneg or qmin <= 0:
        raise RuntimeError(f"{what} output not conforming: {bad}, "
                           f"nonpositive volumes {nneg}, qmin {qmin}")
    return bad, qmin, qmean


def _same_bytes(a: str, b: str):
    """Raise with the first differing line unless files a and b are
    byte-identical."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        la, lb = fa.read().splitlines(), fb.read().splitlines()
    if la == lb:
        return
    for i, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            raise RuntimeError(f"{b} differs from {a} at line {i + 1}: "
                               f"{x[:80]!r} != {y[:80]!r}")
    raise RuntimeError(f"{b} differs from {a}: {len(lb)} lines, not "
                       f"{len(la)}")


def phase_repeat(workdir: str, device: str = "cuda", shapes=None):
    """Run the main path again as it is, then with the sort engine's
    wrappers swapped for their plain versions; both outputs must be
    byte-identical to phase_main's.  The first rerun captures the inputs
    of the densest K3 / K4 calls ``shapes["score_picks"]`` names
    (phase_path's); returns them (``_score_capture``)."""
    from parmmg_tpu_torch.ops import kernels
    ref = os.path.join(workdir, "cube16.o")
    calls, picks = _score_want(shapes)
    with _ScoreTap(i for p in picks.values() for i in p.values()) as tap:
        launches, rec2, wall2 = _run_main(
            workdir, "cube16", os.path.join(workdir, "cube16.r2.mesh"),
            device)
    captured = _score_capture(tap, calls, picks) if shapes else {}
    for ext in (".mesh", ".sol"):
        _same_bytes(ref + ext, os.path.join(workdir, "cube16.r2" + ext))
    print(f"[repeat] second run: {rec2['ntets']} tets, wall {wall2:.3f} s, "
          f"byte-identical .mesh and .sol")
    names = ("radix_sort", "merge_prefix", "segment_flags")
    saved = {n: getattr(kernels, n) for n in names}
    for n in names:
        setattr(kernels, n, getattr(kernels, n + "_plain"))
    try:
        launches, rec, wall = _run_main(
            workdir, "cube16", os.path.join(workdir, "cube16.plain.mesh"),
            device)
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)
    if any(launches[n] for n in names):
        raise RuntimeError(f"plain run launched sort kernels: {launches}")
    for ext in (".mesh", ".sol"):
        _same_bytes(ref + ext, os.path.join(workdir, "cube16.plain" + ext))
    print(f"[repeat] sort engine swapped for its plain versions: "
          f"{rec['ntets']} tets, wall {wall:.3f} s, byte-identical .mesh "
          f"and .sol")
    # what the fixed-order float sums cost: the same run with them swapped
    # for scatter_reduce's atomics (timing only: its bytes may differ)
    from parmmg_tpu_torch.ops import primitives
    fixed = primitives.fixed_order_sum

    def atomic_sum(dst, ix, vals):
        if dst.dim() > 1:
            ix = ix.view((-1,) + (1,) * (dst.dim() - 1)).expand_as(vals)
        return dst.scatter_reduce(0, ix, vals, "sum", include_self=True)
    primitives.fixed_order_sum = atomic_sum
    try:
        _, rec, wall = _run_main(
            workdir, "cube16", os.path.join(workdir, "cube16.atomic.mesh"),
            device)
    finally:
        primitives.fixed_order_sum = fixed
    print(f"[repeat] float sums by scatter_reduce atomics instead (timing "
          f"only): {rec['ntets']} tets, wall {wall:.3f} s")
    # one cycle a dispatch, full width (the configuration before the
    # worklist cycles): checked against the JAX CLI at block 1
    from parmmg_tpu_torch.ops import adapt
    default = adapt.default_cycle_block
    adapt.default_cycle_block = lambda _device: 1
    out1 = os.path.join(workdir, "cube16.b1.mesh")
    try:
        with _cycle_watch(count_reads=False) as info:
            _, rec1, wall1 = _run_main(workdir, "cube16", out1, device)
    finally:
        adapt.default_cycle_block = default
    mesh, _, _ = _read_output(out1, device)
    _check_conforming("cube16 at cycle_block=1", mesh)
    ref1 = JAX_CLI_NTETS_BLOCK1["cube16"]
    cycles1 = sum(st.cycles for st in info["stats"])
    print(f"[repeat] cycle_block=1: {rec1['ntets']} tets (the JAX CLI at "
          f"block 1: {ref1}), qmin {rec1['qmin']:.6f} qmean "
          f"{rec1['qmean']:.6f}, {cycles1} cycles, {len(info['blocks'])} "
          f"auto blocks, wall {wall1:.3f} s; cycle_block=9 (second run "
          f"above): {rec2['ntets']} tets, wall {wall2:.3f} s")
    if info["blocks"] or abs(rec1["ntets"] - ref1) > NTETS_BOUND * ref1:
        raise RuntimeError(f"cycle_block=1: {rec1['ntets']} tets, not "
                           f"within {NTETS_BOUND:.0%} of {ref1}, or "
                           f"{len(info['blocks'])} auto blocks")
    return captured


def phase_pairs(workdir: str, npairs: int, device: str = "cuda"):
    """``npairs`` alternating runs of each cube16 path at cycle_block=1
    and at the default, blocks of 9 (block 1 first in even pairs, block 9
    first in odd ones), after one unmeasured run of each; returns per
    path and block the walls, tets, qmin and qmean, and per path the
    paired differences (block 9 - block 1) of the walls."""
    import statistics
    from parmmg_tpu_torch.ops import adapt
    default = adapt.default_cycle_block
    out = {}
    try:
        for stem in ("cube16", "cube16ani"):
            _write_input(workdir, stem)
            res = {b: {"wall_s": []} for b in (1, 9)}
            for i in range(npairs + 1):
                for b in ((1, 9) if i % 2 == 0 else (9, 1)):
                    adapt.default_cycle_block = lambda _device, b=b: b
                    _, rec, wall = _run_main(
                        workdir, stem,
                        os.path.join(workdir, f"{stem}.pair{b}.mesh"),
                        device)
                    if i:           # the first pair warms up
                        res[b]["wall_s"].append(wall)
                    res[b].update({k: rec[k] for k in ("ntets", "qmin",
                                                       "qmean")})
            d = [w9 - w1 for w1, w9 in zip(res[1]["wall_s"],
                                           res[9]["wall_s"])]
            out[stem] = {
                "block1": res[1], "block9": res[9],
                "median_s": {b: statistics.median(res[b]["wall_s"])
                             for b in (1, 9)},
                "diff_9_minus_1_s": d,
                "diff_mean_s": statistics.mean(d),
                "diff_stderr_s": (statistics.stdev(d) / len(d) ** 0.5
                                  if len(d) > 1 else None),
                "block9_faster": sum(x < 0 for x in d)}
            r = out[stem]
            print(f"[pairs] {stem} {npairs} pairs: block 1 median "
                  f"{r['median_s'][1]:.3f} s ({res[1]['ntets']} tets, "
                  f"qmean {res[1]['qmean']:.4f}), block 9 median "
                  f"{r['median_s'][9]:.3f} s ({res[9]['ntets']} tets, "
                  f"qmean {res[9]['qmean']:.4f}); block 9 - block 1 "
                  f"mean {r['diff_mean_s']:+.3f} s, stderr "
                  f"{r['diff_stderr_s'] or 0:.3f} s, block 9 faster in "
                  f"{r['block9_faster']} of {len(d)}")
    finally:
        adapt.default_cycle_block = default
    return out


def _score_want(shapes, kinds=("densest",)):
    """(every K3 / K4 call, {kernel: {kind: call index}} for ``kinds``)
    that phase_path recorded in ``shapes``, or nothing to capture."""
    if not shapes:
        return [], {}
    return shapes["score_calls"], {
        name: {k: p[k] for k in kinds}
        for name, p in shapes["score_picks"].items()}


def phase_aniso_repeat(workdir: str, device: str = "cuda", shapes=None):
    """The tensor-metric path once more: the same bytes as phase 4's; the
    K3 / K4 inputs captured as in ``phase_repeat``."""
    stem = "cube16ani"
    calls, picks = _score_want(shapes)
    with _ScoreTap(i for p in picks.values() for i in p.values()) as tap:
        _, rec, wall = _run_main(workdir, stem,
                                 os.path.join(workdir, f"{stem}.r2.mesh"),
                                 device)
    for ext in (".mesh", ".sol"):
        _same_bytes(os.path.join(workdir, f"{stem}.o{ext}"),
                    os.path.join(workdir, f"{stem}.r2{ext}"))
    print(f"[aniso] second run: {rec['ntets']} tets, wall {wall:.3f} s, "
          f"byte-identical .mesh and .sol")
    return _score_capture(tap, calls, picks) if shapes else {}


def phase_field(workdir: str, device: str = "cuda"):
    """The [field] path: sphere16.vtu with its metric and two linear
    fields through the CLI on the card; returns its launch counts."""
    import numpy as np
    import torch
    from parmmg_tpu_torch import cli, driver
    from parmmg_tpu_torch.core.constants import MG_BDY
    from parmmg_tpu_torch.core.mesh import MESH_FIELDS, Mesh, make_mesh, \
        tet_volumes
    from parmmg_tpu_torch.io.vtk import read_vtu, write_vtu
    from parmmg_tpu_torch.ops import interp, kernels
    from parmmg_tpu_torch.ops.adjacency import build_adjacency, \
        check_adjacency
    from parmmg_tpu_torch.ops.quality import tet_quality
    from parmmg_tpu_torch.utils.fixtures import (ball_shock_metric,
                                                 linear_fields, sphere_mesh)
    stem = "sphere16"
    vert, tet = sphere_mesh(16)
    temp, vel = linear_fields(vert)
    src = os.path.join(workdir, f"{stem}.vtu")
    out = os.path.join(workdir, f"{stem}.o.vtu")
    write_vtu(src, vert, tet, point_data={
        "metric": ball_shock_metric(vert), "temp": temp, "vel": vel})
    seen = []
    real = driver.interpolate_fields
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def capture(bg, fields, new):
        sync()
        t0 = time.perf_counter()
        res = real(bg, fields, new)
        sync()
        seen.append((bg, [f.copy() for f in fields], new, res,
                     time.perf_counter() - t0))
        return res
    driver.interpolate_fields = capture
    kernels.reset_launches()
    sync()
    t0 = time.perf_counter()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), \
                _cycle_watch(count_reads=device == "cuda") as info:
            rc = cli.main(["-in", src, "-out", out, "-niter", "1", "-v", "1",
                           "-bench-json", "-device", device])
        sync()
    finally:
        driver.interpolate_fields = real
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log = buf.getvalue()
    with open(out + ".log", "w") as f:
        f.write(log)
    if rc != 0:
        raise RuntimeError(f"[field] cli.main returned {rc}:\n{log[-2000:]}")
    rec = json.loads([ln for ln in log.splitlines() if ln.startswith("{")][-1])
    if len(seen) != 1:
        raise RuntimeError(f"[field] interpolate_fields ran {len(seen)} "
                           "times, not once")
    bg, fields, new, res, interp_wall = seen[0]
    if not (np.array_equal(fields[0], temp) and
            np.array_equal(fields[1], vel)):
        raise RuntimeError("[field] the fields given to interpolate_fields "
                           "are not the .vtu's temp and vel")

    # the written .vtu, read back
    dev = torch.device(device)
    v_o, cells, _, _ = read_vtu(out)
    mesh = build_adjacency(make_mesh(v_o, cells[10], device=dev))
    bad = check_adjacency(mesh)
    nneg = int(((tet_volumes(mesh) <= 0) & mesh.tmask).sum())
    q = tet_quality(mesh)
    qmin = float(q[mesh.tmask].min())
    qmean = float(q[mesh.tmask].mean())
    if bad["asymmetric"] or bad["face_mismatch"] or nneg or qmin <= 0:
        raise RuntimeError(f"[field] output not conforming: {bad}, "
                           f"nonpositive volumes {nneg}, qmin {qmin}")
    print(f"[field] {stem}.vtu -niter 1 (metric, temp, vel): ntets "
          f"{rec['ntets']} qmin {rec['qmin']:.6f} qmean {rec['qmean']:.6f} "
          f"cycles {rec['cycles']} splits {rec['nsplit']} collapses "
          f"{rec['ncollapse']} swaps {rec['nswap']} wall {wall:.3f} s")
    print(f"[field] re-read output: {int(mesh.tmask.sum())} tets, "
          f"{len(v_o)} points, adjacency {bad}, qmin {qmin:.6f} qmean "
          f"{qmean:.6f}")
    print(f"[field] launches {launches}")
    _print_cycles("field", stem, info, device)
    must, must_not = PATH_KERNELS[stem]
    missing = sorted(k for k in must if launches[k] == 0)
    if device == "cuda" and (missing or launches[must_not]):
        raise RuntimeError(f"{stem}: kernels never launched {missing}, "
                           f"{must_not} launched {launches[must_not]} "
                           f"times ({launches})")
    ref = JAX_CLI_NTETS[stem]
    if abs(rec["ntets"] - ref) > NTETS_BOUND * ref:
        raise RuntimeError(f"{rec['ntets']} tets: not within "
                           f"{NTETS_BOUND:.0%} of the JAX CLI's {ref} on "
                           "this input")

    # the walks of the captured run, again, for their statistics and
    # their wall times: the volume location (walk + exhaustive search of
    # the failed walks), the exhaustive search alone, the surface location
    pts = new.vert[new.vmask]
    on_bdy = (new.vtag[new.vmask] & MG_BDY) != 0

    def timed(fn, *a):
        sync()
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        return out, time.perf_counter() - t0
    loc, t_vol = timed(interp.locate_points, bg, pts, torch.zeros(
        pts.shape[0], dtype=torch.int32, device=dev))
    _, t_exh = timed(interp.exhaustive_tets, bg, pts[loc.failed])
    sloc, t_bdy = timed(interp.locate_points_bdy, bg, pts[on_bdy])
    steps = loc.steps.float()
    nfail = int(loc.failed.sum())
    print(f"[field] interpolation wall {interp_wall:.3f} s on {device} "
          f"({pts.shape[0]} points, 2 fields); again alone: volume walk "
          f"{t_vol - t_exh:.3f} s + exhaustive search {t_exh:.3f} s, "
          f"surface location {t_bdy:.3f} s")
    print(f"[field] volume walk steps mean {float(steps.mean()):.2f} max "
          f"{int(steps.max())}; failed walks (exhaustive search) {nfail}; "
          f"boundary points on the surface walk {int(on_bdy.sum())} "
          f"(closest-triangle search kept for {int(sloc.failed.sum())})")

    # linear fields are exact at the interior vertices of working walks
    p64 = pts.double().cpu().numpy()
    ok = (~loc.failed & ~on_bdy).cpu().numpy()
    for name, got, want in zip(("temp", "vel"), res, linear_fields(p64)):
        err = float(np.abs(got - want)[ok].max()) / float(np.abs(want).max())
        print(f"[field] {name}: max error at {int(ok.sum())} interior "
              f"vertices {err:.3g} max|f|")
        if err > 1e-4:
            raise RuntimeError(f"[field] {name} not exact at interior "
                               f"vertices: {err:.3g} max|f| > 1e-4")

    # the same inputs through the CPU
    cpu = torch.device("cpu")

    def on_cpu(m):
        return Mesh(**{f: getattr(m, f).to(cpu) for f in MESH_FIELDS})
    bg_c, new_c = on_cpu(bg), on_cpu(new)
    t0 = time.perf_counter()
    res_c = real(bg_c, fields, new_c)
    cpu_wall = time.perf_counter() - t0
    for name, got, want in zip(("temp", "vel"), res, res_c):
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        same = int((got == want).all(axis=-1).sum() if got.ndim > 1
                   else (got == want).sum())
        print(f"[field] {name}: card against CPU max diff {err:.3g} max|f|, "
              f"{same} of {len(got)} values bit-equal (CPU wall "
              f"{cpu_wall:.3f} s)")
        if err > 1e-5:
            raise RuntimeError(f"[field] {name}: card and CPU differ by "
                               f"{err:.3g} max|f| > 1e-5")
    st_d = interp.surface_triangulation(bg)
    st_c = interp.surface_triangulation(bg_c)
    for name, a, b in zip(("tri", "fm", "tadj"), st_d, st_c):
        if not torch.equal(a.cpu(), b):
            raise RuntimeError(f"[field] surface_triangulation {name} on the "
                               "card differs from its CPU run")
    print(f"[field] surface_triangulation: tri, fm, tadj bit-equal to the "
          f"CPU run ({int(st_c[1].sum())} boundary faces)")
    return launches


# the [grouped] input: cube_mesh(32) under the cube16 iso shock map, the
# reference CI's standard flags, and the JAX CLI's group counts on it
GROUPED_FLAGS = ("-mesh-size", "16384", "-niter", "2")
JAX_CLI_GROUPS = [12, 12]


class _KernelTap:
    """Stands in for ``ops/topo_incr``'s ``kernels`` module: every call of
    the sort engine's wrappers made from the incremental topology engine
    is counted, with the launches it made and the (rows, words) it was
    given."""

    def __init__(self, real):
        self._real = real
        self.calls, self.launched, self.shapes = {}, {}, {}

    def __getattr__(self, name):
        fn = getattr(self._real, name)
        if name not in ("merge_prefix", "radix_sort", "segment_flags"):
            return fn
        import torch

        def call(words, *a, **k):
            before = self._real.LAUNCHES[name]
            out = fn(words, *a, **k)
            self.calls[name] = self.calls.get(name, 0) + 1
            self.launched[name] = (self.launched.get(name, 0)
                                   + self._real.LAUNCHES[name] - before)
            ws = (words,) if torch.is_tensor(words) else tuple(words)
            self.shapes.setdefault(name, set()).add((ws[0].shape[0],
                                                     len(ws)))
            return out
        return call


def _run_grouped(workdir: str, out: str, device: str, pass_kw=None,
                 count_reads: bool = False, stem: str = "cube32",
                 flags=None):
    """The [grouped] CLI remesh once, written to ``out``, with ``pass_kw``
    given to every grouped pass; returns (launches, record, wall, info):
    ``info`` holds the run's AdaptStats, the group-cycles it ran (calls of
    ``adapt_cycle_impl`` on an active slot) and, with ``count_reads``, the
    synchronizing calls inside ``grouped_adapt`` (PyTorch's sync debug
    mode, split and merge included)."""
    import warnings
    import torch
    from parmmg_tpu_torch.ops import adapt
    from parmmg_tpu_torch.parallel import groups
    real_ga, real_cycle = groups.grouped_adapt, adapt.adapt_cycle_impl
    info = {"stats": None, "reads": 0, "group_cycles": 0, "ga_wall": 0.0}

    def cycle(*a, **k):
        if k.get("active", True):
            info["group_cycles"] += 1
        return real_cycle(*a, **k)

    def ga(*a, **k):
        k.update(pass_kw or {})
        info["stats"] = k.get("stats")
        t0 = time.perf_counter()
        try:
            if not count_reads:
                return real_ga(*a, **k)
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return real_ga(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    info["reads"] += sum("synchroniz" in str(w.message)
                                         for w in seen)
        finally:
            info["ga_wall"] += time.perf_counter() - t0
    groups.grouped_adapt, adapt.adapt_cycle_impl = ga, cycle
    try:
        launches, rec, wall = _run_main(workdir, stem, out, device,
                                        flags=flags or GROUPED_FLAGS)
    finally:
        groups.grouped_adapt, adapt.adapt_cycle_impl = real_ga, real_cycle
    return launches, rec, wall, info


def phase_grouped(workdir: str, device: str = "cuda"):
    """The [grouped] path: the port's CLI with ``-mesh-size 16384 -niter 2``
    on cube_mesh(32) (35,937 points, 196,608 tets: 12 groups) under the
    cube16 iso shock map, everything else at its default (blocks of 9,
    the chunk of ``groups.group_chunk``'s memory rule: unchunked on the
    card).  Checked: K1 and K3-K8 launched and K2 not, a conforming output
    with qmin > 0, the tet count within 2% of the JAX CLI's, 12 groups in
    each pass; then the same bytes from a run before it that counts the
    host reads under PyTorch's sync debug mode, from a run at the other
    chunking (8 groups a dispatch with the state on the host, or every
    group in one) and from a run with the incremental topology engine's
    band merges on, which must merge at least one band with every K5 / K7
    / K8 call of ``ops/topo_incr`` launching its kernel.  Only the walls of
    the runs without the debug mode are compared.  Returns (launches, the
    band merges' K5 and K7 inputs, the (kernel, rows, words) shapes of the
    engine's calls)."""
    import torch
    from parmmg_tpu_torch.ops import topo_incr
    stem = "cube32"
    _write_input(workdir, stem, n=32, metric_n=16)
    # the host reads: the defaults under the sync debug mode, which slows
    # the host, so this run's wall stands apart from the others
    outr = os.path.join(workdir, f"{stem}.reads.mesh")
    reads = None
    if device == "cuda":
        _, _, wallr, infor = _run_grouped(workdir, outr, device,
                                          count_reads=True)
        reads = (infor["reads"], infor["group_cycles"], wallr)
    out = os.path.join(workdir, f"{stem}.o.mesh")
    launches, rec, wall, info = _run_grouped(workdir, out, device)
    st = info["stats"]
    se = st.sched_extra
    mesh, _, _ = _read_output(out, device)
    bad, qmin, qmean = _check_conforming(stem, mesh)
    print(f"[grouped] {stem} {' '.join(GROUPED_FLAGS)}: ntets "
          f"{rec['ntets']} qmin {rec['qmin']:.6f} qmean {rec['qmean']:.6f} "
          f"splits {rec['nsplit']} collapses {rec['ncollapse']} swaps "
          f"{rec['nswap']} wall {wall:.3f} s (grouped_adapt "
          f"{info['ga_wall']:.3f} s)")
    print(f"[grouped] re-read output: {int(mesh.tmask.sum())} tets, "
          f"adjacency {bad}, qmin {qmin:.6f} qmean {qmean:.6f}")
    print(f"[grouped] groups per pass {se['groups_per_pass']}, chunk "
          f"{se['group_chunk']}, cycles {st.cycles}, group-cycles run "
          f"{info['group_cycles']}, active groups per block "
          f"{se['active_groups_per_block']}")
    print(f"[grouped] dispatches {st.group_dispatches} (saved "
          f"{st.group_dispatches_saved}), group blocks skipped "
          f"{st.groups_skipped}, masked slots {se['cond_skipped_rows']}")
    if reads:
        for ext in (".mesh", ".sol"):
            _same_bytes(out[:-5] + ext, outr[:-5] + ext)
        print(f"[grouped] host reads {reads[0]} in grouped_adapt = "
              f"{reads[0] / max(reads[1], 1):.1f} a group-cycle (a run "
              f"before, under the sync debug mode: wall {reads[2]:.3f} s, "
              "byte-identical .mesh and .sol)")
    print(f"[grouped] launches {launches}")
    must, must_not = PATH_KERNELS[stem]
    missing = sorted(k for k in must if launches[k] == 0)
    if device == "cuda" and (missing or launches[must_not]):
        raise RuntimeError(f"{stem}: kernels never launched {missing}, "
                           f"{must_not} launched {launches[must_not]} "
                           f"times ({launches})")
    ref = JAX_CLI_NTETS[stem]
    if abs(rec["ntets"] - ref) > NTETS_BOUND * ref:
        raise RuntimeError(f"{rec['ntets']} tets: not within "
                           f"{NTETS_BOUND:.0%} of the JAX CLI's {ref} on "
                           "this input")
    if se["groups_per_pass"] != JAX_CLI_GROUPS:
        raise RuntimeError(f"groups per pass {se['groups_per_pass']}, the "
                           f"JAX CLI's {JAX_CLI_GROUPS}")

    # the other chunking: 8 groups a dispatch with the pass state on the
    # host (the JAX package's rule on its accelerator), or all in one
    alt = 0 if any(se["group_chunk"]) else 8
    outc = os.path.join(workdir, f"{stem}.c{alt}.mesh")
    _, recc, wallc, infoc = _run_grouped(workdir, outc, device,
                                         pass_kw={"chunk": alt})
    for ext in (".mesh", ".sol"):
        _same_bytes(out[:-5] + ext, outc[:-5] + ext)
    sec = infoc["stats"].sched_extra
    print(f"[grouped] chunk {alt}: {recc['ntets']} tets, dispatches "
          f"{infoc['stats'].group_dispatches}, masked slots "
          f"{sec['cond_skipped_rows']}, wall {wallc:.3f} s against "
          f"{wall:.3f} s at chunk {se['group_chunk']} (grouped_adapt "
          f"{infoc['ga_wall']:.3f} s against {info['ga_wall']:.3f} s), "
          "byte-identical .mesh and .sol")
    for tag, x in ((f"chunk {alt}", sec), ("default", se)):
        if "grp_compute_s" in x:
            print(f"[grouped] {tag}: pipeline seconds " + ", ".join(
                f"{k[4:-2]} {x[k]:.3f}" for k in (
                    "grp_upload_s", "grp_compute_s", "grp_download_s",
                    "grp_writeback_s")))

    # the incremental topology engine's band merges on
    tap = _KernelTap(topo_incr.kernels)
    samples = {}
    real_prefix, real_order = topo_incr._prefix_i32, topo_incr.band_order

    def prefix(x):
        samples.setdefault("merge_prefix", x.to(torch.int32).clone())
        return real_prefix(x)

    def order(bkeys, bslot):
        if len(bkeys) == 1:
            samples.setdefault("radix_sort", (bkeys[0].clone(),
                                              bslot.clone()))
        return real_order(bkeys, bslot)
    topo_incr.reset_counts()
    topo_incr.kernels = tap
    topo_incr._prefix_i32, topo_incr.band_order = prefix, order
    outi = os.path.join(workdir, f"{stem}.incr.mesh")
    try:
        _, reci, walli, infoi = _run_grouped(workdir, outi, device,
                                             pass_kw={"incr": True})
    finally:
        topo_incr.kernels = tap._real
        topo_incr._prefix_i32, topo_incr.band_order = real_prefix, \
            real_order
    for ext in (".mesh", ".sol"):
        _same_bytes(out[:-5] + ext, outi[:-5] + ext)
    cnt = dict(topo_incr.COUNTS)
    widths = sorted(topo_incr.BAND_WIDTHS)
    shapes = {k: sorted(v) for k, v in tap.shapes.items()}
    print(f"[grouped] incr on: {reci['ntets']} tets, wall {walli:.3f} s, "
          f"byte-identical .mesh and .sol; band merges edge "
          f"{cnt['edge_merges']} face {cnt['face_merges']}, reuses "
          f"{cnt['reuses']}, full sorts {cnt['full']}, overflows "
          f"{cnt['overflow']}; band widths (tets) {widths}")
    print(f"[grouped] incr on: topo_incr's kernel calls {tap.calls}, "
          f"launched {tap.launched}; (rows, words) {shapes}")
    if not cnt["edge_merges"] + cnt["face_merges"]:
        raise RuntimeError("[grouped] incr on: no band was merged")
    if device == "cuda" and (tap.calls != tap.launched or not all(
            tap.calls.get(k) for k in ("merge_prefix", "radix_sort"))):
        raise RuntimeError(f"[grouped] topo_incr's calls {tap.calls} did "
                           f"not all launch their kernel {tap.launched}")
    return launches, samples, shapes


# the [dist] phase: the [grouped] input through the distributed path, four
# shards stacked on the card, two passes with the repartitioning between
# them (the reference CI's -niter 2); the JAX CLI's tet count on it
# (tools/jax_cli_reference.py 32 --metric-n 16 --ndev 4 --niter 2 --block
# 9, on the CPU: 235,452 tets, 20 dist cycles, 612.8 s); then one
# graph-mode run through ParMesh on cube_mesh(16) under the cube16 map
DIST_FLAGS = ("-ndev", "4", "-niter", "2")
JAX_CLI_NTETS["cube32dist"] = 235452
# the one-pass run (tools/jax_cli_reference.py ... --niter 1 --block 9, on
# the CPU: 253,749 tets, 10 dist cycles)
DIST1_FLAGS = ("-ndev", "4", "-niter", "1")
JAX_CLI_NTETS["cube32dist1"] = 253749
DIST_GRAPH_N = 16
# the kernels the migration step itself must launch (rebuild_shards'
# face sorts and the analysis refresh's sorts)
MIGRATE_KERNELS = ("merge_prefix", "radix_sort", "segment_flags")


class _DistWatch:
    """Watches the distributed loop of the runs inside the scope: the
    run's AdaptStats, every interface echo (its comm tables, input
    coordinates and mismatch count), the stacked state after the last
    adapt cycles, the refresh's numbering, live tets a shard before the
    merge, the ``dist.*`` span seconds, each band migration's moved tets,
    interface faces and shared vertices, the kernel launches and (with
    ``count_reads``) the synchronizing calls inside
    ``distributed_adapt_multi`` (PyTorch's sync debug mode), both also
    between the ``dist.refresh`` and ``dist.migrate`` spans: the
    migration step."""

    def __init__(self, count_reads: bool = False):
        self.count_reads = count_reads
        self.seen = []
        self.info = {"stats": None, "reads": 0, "spans": {}, "echo": [],
                     "live_tets": None, "band": [], "migrate_reads": 0,
                     "migrate_launches": {}}

    def __enter__(self):
        import warnings
        import torch
        from parmmg_tpu_torch.obs import trace as otrace
        from parmmg_tpu_torch.ops import kernels
        from parmmg_tpu_torch.parallel import dist, distribute, migrate_dev
        info = self.info
        self._real = (dist.distributed_adapt_multi,
                      dist.check_interface_echo, dist.run_adapt_cycles,
                      dist._refresh, distribute.merge_shards,
                      otrace.emit_span, migrate_dev.band_migrate_iteration)
        multi, echo, cycles, refresh, merge, span, band = self._real
        mark = {}

        def w_multi(*a, **k):
            info["stats"] = k.get("stats")
            if not self.count_reads:
                return multi(*a, **k)
            with warnings.catch_warnings(record=True) as seen:
                self.seen = seen
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return multi(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    info["reads"] += self._reads()

        def w_echo(stacked, met_s, comms, vert_h):
            info["echo_args"] = (comms, vert_h)
            n = echo(stacked, met_s, comms, vert_h)
            info["echo"].append(n)
            return n

        def w_cycles(*a, **k):
            out = cycles(*a, **k)
            info["adapted"] = out
            return out

        def w_refresh(stacked, comms, n_shards, ang, glo, **k):
            info["glo"] = [g.copy() for g in glo]
            return refresh(stacked, comms, n_shards, ang, glo, **k)

        def w_merge(stacked, *a, **k):
            info["live_tets"] = stacked.tmask.sum(dim=1).tolist()
            return merge(stacked, *a, **k)

        def w_span(name, dur, *a, **k):
            if name.startswith("dist."):
                info["spans"][name] = info["spans"].get(name, 0.0) + dur
            if name == "dist.refresh":
                mark["reads"] = self._reads()
                mark["launches"] = dict(kernels.LAUNCHES)
            elif name == "dist.migrate" and mark:
                info["migrate_reads"] += self._reads() - mark["reads"]
                ml = info["migrate_launches"]
                for kk, v in kernels.LAUNCHES.items():
                    ml[kk] = ml.get(kk, 0) + v - mark["launches"][kk]
            return span(name, dur, *a, **k)

        def w_band(*a, **k):
            res = band(*a, **k)
            if res is not None and res[3] is not None:
                info["band"].append((res[5], int(
                    (res[3].face_idx >= 0).sum()) // 2, len(res[4])))
            return res
        dist.distributed_adapt_multi = w_multi
        dist.check_interface_echo = w_echo
        dist.run_adapt_cycles = w_cycles
        dist._refresh = w_refresh
        distribute.merge_shards = w_merge
        otrace.emit_span = w_span
        migrate_dev.band_migrate_iteration = w_band
        return self

    def _reads(self) -> int:
        return sum("synchroniz" in str(w.message) for w in self.seen)

    def __exit__(self, *exc):
        from parmmg_tpu_torch.obs import trace as otrace
        from parmmg_tpu_torch.parallel import dist, distribute, migrate_dev
        (dist.distributed_adapt_multi, dist.check_interface_echo,
         dist.run_adapt_cycles, dist._refresh, distribute.merge_shards,
         otrace.emit_span, migrate_dev.band_migrate_iteration) = self._real
        return False


def _run_dist(workdir: str, out: str, device: str, count_reads=False,
              flags=DIST_FLAGS):
    """The [dist] CLI remesh once, written to ``out``; returns (launches,
    record, wall, the watch's info, band exchange bytes, full-view
    fallbacks)."""
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    b0 = REGISTRY.counter("mh.band_exchange_bytes").value
    f0 = REGISTRY.counter("dist.full_view_migrations").value
    with _DistWatch(count_reads) as w:
        launches, rec, wall = _run_main(workdir, "cube32", out, device,
                                        flags=flags)
    return (launches, rec, wall, w.info,
            REGISTRY.counter("mh.band_exchange_bytes").value - b0,
            REGISTRY.counter("dist.full_view_migrations").value - f0)


def _check_migrated(tag: str, info: dict, nfull: float,
                    need_moves: bool = True):
    """Raise unless the run's migration took the band path (tets moved
    where ``need_moves``, no full-view fallback) and every echo, the last
    on the adapted shards with the current comm tables, found 0
    mismatches; returns the moved tets."""
    from parmmg_tpu_torch.parallel import dist
    comms, vert_h = info["echo_args"]
    stacked, met_s = info["adapted"]
    after = dist.check_interface_echo(stacked, met_s, comms, vert_h)
    moved = sum(b[0] for b in info["band"])
    print(f"{tag} interface echo mismatches {info['echo']} (split, then "
          f"after each migration), {after} on the adapted shards; band "
          f"migrations (moved tets, interface faces, shared vertices) "
          f"{info['band']}; full-view fallbacks {int(nfull)}")
    if len(info["echo"]) < 1 + bool(moved) or any(info["echo"]) or after:
        raise RuntimeError(f"{tag} echo mismatches {info['echo']}, "
                           f"{after}")
    if (need_moves and not moved) or nfull:
        raise RuntimeError(f"{tag} moved {moved} tets on the band path, "
                           f"{int(nfull)} full-view fallbacks")
    return moved


def _graph_run(workdir: str, device: str):
    """One graph-mode run (``repartitioningMode = REPART_GRAPH``) through
    ParMesh at 4 shards and 2 passes on cube_mesh(DIST_GRAPH_N) under the
    cube16 iso shock map, from the decomposition ``end_slabs_partition``
    (the two end slabs in one shard beside two lighter ones), handed to
    the run as the CLI hands a distributed input's: the cluster refinement
    takes only moves of positive cut gain, and from the loop's own Morton
    split none has one.  Checked conforming with qmin > 0, echo 0, tets
    moved on the band path, no full-view fallback."""
    import numpy as np
    from parmmg_tpu_torch.api.params import IParam
    from parmmg_tpu_torch.api.parmesh import ParMesh
    from parmmg_tpu_torch.core import constants as C
    from parmmg_tpu_torch.core.mesh import make_mesh
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    from parmmg_tpu_torch.ops.adjacency import build_adjacency
    from parmmg_tpu_torch.utils.fixtures import (analytic_iso_metric,
                                                 cube_mesh,
                                                 end_slabs_partition)
    n = DIST_GRAPH_N
    vert, tet = cube_mesh(n)
    pm = ParMesh(device=device)
    pm.set_mesh_size(np_=len(vert), ne=len(tet))
    pm.set_vertices(vert)
    pm.set_tetrahedra(tet + 1)
    pm.set_met_size(1, len(vert))
    pm.set_scalar_mets(analytic_iso_metric(vert, "shock", h=1.5 / 16))
    pm.set_iparameter(IParam.niter, 2)
    pm.set_iparameter(IParam.repartitioningMode, C.REPART_GRAPH)
    pm.info.n_devices = 4
    pm.info.imprim = 0
    pm._in_part = end_slabs_partition(vert, tet)
    f0 = REGISTRY.counter("dist.full_view_migrations").value
    t0 = time.perf_counter()
    with _DistWatch() as w:
        ret = pm.run()
    wall = time.perf_counter() - t0
    if ret != C.PMMG_SUCCESS:
        raise RuntimeError(f"[dist] graph mode: ParMesh.run returned {ret}")
    v, _ = pm.get_vertices()
    t, _ = pm.get_tetrahedra()
    mesh = build_adjacency(make_mesh(v, np.asarray(t) - 1, device=device))
    bad, qmin, qmean = _check_conforming("[dist] graph mode", mesh)
    print(f"[dist] graph mode (ParMesh, REPART_GRAPH, end slabs) "
          f"cube_mesh({n}) -ndev 4 -niter 2: {len(t)} tets, qmin "
          f"{qmin:.6f} qmean {qmean:.6f}, wall {wall:.3f} s, dist.migrate "
          f"{w.info['spans'].get('dist.migrate', 0.0):.3f} s")
    moved = _check_migrated("[dist] graph mode", w.info, REGISTRY.counter(
        "dist.full_view_migrations").value - f0)
    print(f"[dist] graph mode moved {moved} tets")


def phase_dist(workdir: str, device: str = "cuda"):
    """The [dist] path: the port's CLI with ``-ndev 4 -niter 2`` on the
    [grouped] input (cube_mesh(32), 196,608 tets, the cube16 iso shock
    map): four shards stacked on the card, the communicators checked by
    the coordinate + metric echo, two passes of blocks of 9 cycles on
    every shard with the device analysis refresh, and between them the
    repartitioning (flood labels, band migration, weld, rebuild, echo),
    one merge, then the polish and the run tail.  Checked: K1 and K3-K8
    launched and K2 not, K5, K7 and K8 inside the migration step too; a
    conforming output with qmin > 0, its tet count within 2% of the JAX
    CLI's; the echo 0 mismatches at the split, after the migration and
    on the adapted shards; tets moved on the band path and no full-view
    fallback; a run before it under PyTorch's sync debug mode (counting
    the host reads) writes the same bytes; a ``-distributed-output`` run
    writes 4 rank files whose communicator sections, read back, pass
    ``check_node_comms`` / ``check_face_comms``; the one-pass run
    (``-niter 1``) held to its own JAX CLI count; a graph-mode run
    (``_graph_run``).  Prints the wall, the dist cycles and the active
    shards a block, live tets a shard, the ``dist.*`` span seconds, the
    migration's moved tets, interface faces and shared vertices, host
    reads a dist cycle and in the migration step, the band exchange
    bytes, one shard's record extraction (``extract_probe_seconds``),
    the migration step's launches and the phase's.  Returns the launches
    of the default run."""
    import numpy as np
    import torch
    from parmmg_tpu_torch.io.distributed import (interface_comms_of,
                                                 load_distributed_mesh,
                                                 probe_distributed)
    from parmmg_tpu_torch.parallel.analysis_dev import extract_probe_seconds
    from parmmg_tpu_torch.parallel.comms import (check_face_comms,
                                                 check_node_comms)
    stem = "cube32"
    _write_input(workdir, stem, n=32, metric_n=16)
    flags = " ".join(DIST_FLAGS)
    # the host reads: a run under the sync debug mode, its wall apart
    outr = os.path.join(workdir, f"{stem}.dist.reads.mesh")
    reads = None
    if device == "cuda":
        _, _, wallr, infor, _, _ = _run_dist(workdir, outr, device,
                                             count_reads=True)
        reads = (infor["reads"], infor["stats"].cycles, wallr,
                 infor["migrate_reads"])
    out = os.path.join(workdir, f"{stem}.dist.mesh")
    launches, rec, wall, info, band, nfull = _run_dist(workdir, out, device)
    st = info["stats"]
    mesh, _, _ = _read_output(out, device)
    bad, qmin, qmean = _check_conforming("[dist]", mesh)
    print(f"[dist] {stem} {flags}: ntets {rec['ntets']} qmin "
          f"{rec['qmin']:.6f} qmean {rec['qmean']:.6f} splits "
          f"{rec['nsplit']} collapses {rec['ncollapse']} swaps "
          f"{rec['nswap']} wall {wall:.3f} s")
    print(f"[dist] re-read output: {int(mesh.tmask.sum())} tets, adjacency "
          f"{bad}, qmin {qmin:.6f} qmean {qmean:.6f}")
    act = st.sched_extra.get("active_shards_per_cycle", [])
    blocks = [act[i:i + 9] for i in range(0, len(act), 9)]
    print(f"[dist] dist cycles {st.cycles}, active shards a cycle by block "
          f"of 9 {blocks}; live tets a shard before the merge "
          f"{info['live_tets']}")
    print("[dist] span seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(info["spans"].items())))
    _check_migrated("[dist]", info, nfull)
    comms, _ = info["echo_args"]
    stacked, _ = info["adapted"]
    print(f"[dist] comm tables after the migration: "
          f"{int((comms.node_idx >= 0).sum())} node items, "
          f"{comms.nbr.shape[0]} shards")
    sec = extract_probe_seconds(stacked.slot(0), torch.as_tensor(
        info["glo"][0].astype(np.int32), device=stacked.device))
    print(f"[dist] band exchange bytes {int(band)}; one shard's record "
          f"extraction (extract_probe_seconds, capT {stacked.capT}) "
          f"{sec * 1e3:.3f} ms")
    if reads:
        _same_outputs(out, outr)
        print(f"[dist] host reads {reads[0]} in distributed_adapt_multi = "
              f"{reads[0] / max(reads[1], 1):.1f} a dist cycle, "
              f"{reads[3]} of them in the migration step (a run before, "
              f"under the sync debug mode: wall {reads[2]:.3f} s, "
              "byte-identical .mesh and .sol)")
    ml = info["migrate_launches"]
    print(f"[dist] launches in the migration step {ml}")
    print(f"[dist] launches {launches}")
    must, must_not = PATH_KERNELS["cube32"]
    missing = sorted(k for k in must if launches[k] == 0)
    if device == "cuda" and (missing or launches[must_not]):
        raise RuntimeError(f"[dist]: kernels never launched {missing}, "
                           f"{must_not} launched {launches[must_not]} "
                           f"times ({launches})")
    if device == "cuda" and not all(ml.get(k) for k in MIGRATE_KERNELS):
        raise RuntimeError(f"[dist]: the migration step did not launch "
                           f"{MIGRATE_KERNELS} ({ml})")
    ref = JAX_CLI_NTETS["cube32dist"]
    if abs(rec["ntets"] - ref) > NTETS_BOUND * ref:
        raise RuntimeError(f"[dist] {rec['ntets']} tets: not within "
                           f"{NTETS_BOUND:.0%} of the JAX CLI's {ref} on "
                           "this input")
    # the one-pass run, held to its own JAX CLI count
    out1 = os.path.join(workdir, f"{stem}.dist1.mesh")
    launches1, rec1, wall1, info1, _, nfull1 = _run_dist(
        workdir, out1, device, flags=DIST1_FLAGS)
    mesh1, _, _ = _read_output(out1, device)
    bad1, _, _ = _check_conforming("[dist] -niter 1", mesh1)
    print(f"[dist] {stem} {' '.join(DIST1_FLAGS)}: ntets {rec1['ntets']} "
          f"qmin {rec1['qmin']:.6f} qmean {rec1['qmean']:.6f}, dist cycles "
          f"{info1['stats'].cycles}, wall {wall1:.3f} s; re-read "
          f"{int(mesh1.tmask.sum())} tets, adjacency {bad1}")
    _check_migrated("[dist] -niter 1", info1, nfull1, need_moves=False)
    missing1 = sorted(k for k in must if launches1[k] == 0)
    if device == "cuda" and (missing1 or launches1[must_not]):
        raise RuntimeError(f"[dist] -niter 1: kernels never launched "
                           f"{missing1}, {must_not} launched "
                           f"{launches1[must_not]} times ({launches1})")
    ref1 = JAX_CLI_NTETS["cube32dist1"]
    if abs(rec1["ntets"] - ref1) > NTETS_BOUND * ref1:
        raise RuntimeError(f"[dist] -niter 1: {rec1['ntets']} tets: not "
                           f"within {NTETS_BOUND:.0%} of the JAX CLI's "
                           f"{ref1} on this input")
    # the distributed output: 4 rank files with their communicators
    outd = os.path.join(workdir, f"{stem}.distout.mesh")
    _, recd, walld, _, _, _ = _run_dist(workdir, outd, device,
                                        flags=DIST_FLAGS
                                        + ("-distributed-output",))
    nranks = 0
    while probe_distributed(outd, nranks):
        nranks += 1
    parts = [load_distributed_mesh(outd, r) for r in range(nranks)]
    comms_f = interface_comms_of(parts)
    verts = [p[0].vert for p in parts]
    tets = [np.asarray(p[0].tetra, np.int64) for p in parts]
    chk_n = check_node_comms(comms_f, verts)
    chk_f = check_face_comms(comms_f, tets, verts)
    ntf = sum(len(t) for t in tets)
    print(f"[dist] -distributed-output: {nranks} rank files, {ntf} tets "
          f"(the run's {recd['ntets']}), wall {walld:.3f} s; node comms "
          f"{chk_n}, face comms {chk_f}")
    if nranks != 4 or ntf != recd["ntets"] or chk_n["mismatch"] or \
            chk_f["mismatch"] or not chk_n["items_checked"] or \
            not chk_f["items_checked"]:
        raise RuntimeError("[dist] the distributed output's rank files or "
                           "communicators do not check")
    _graph_run(workdir, device)
    return launches


# the [multihost] phase: the runner on [dist]'s input (cube_mesh(32), the
# cube16 map, 4 shards, 2 passes of 10 cycles: the CLI's default cycles)
# on 2 ranks, and the drills on cube_mesh(12) under the cube8 map
MH_ARGS = ("--shards", "4", "--n", "32", "--h", repr(1.5 / 16), "--niter",
           "2", "--cycles", "10")
MH_DRILL_ARGS = ("--shards", "4", "--n", "12", "--h", repr(1.5 / 8),
                 "--niter", "2", "--cycles", "4")
MH_LEASE_S = 20


def _mh_start(workdir: str, tag: str, args, device: str, env=None,
              timeout: float = 600.0):
    """Start the pod runner in a subprocess, every rank's merged state
    dumped under ``workdir/mh.<tag>``; :func:`_mh_wait` reads it."""
    out_dir = os.path.join(workdir, f"mh.{tag}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cmd = [sys.executable, "-m", "parmmg_tpu_torch.parallel.multihost_run",
           "--np", "2", "--device", device, "--dump", out_dir,
           "--store", os.path.join(out_dir, "store"),
           "--timeout", str(timeout - 60), "--coll-timeout", "300",
           "--verbose", *args]
    e = dict(os.environ, PYTHONPATH=HERE, PMTORCH_RETRY_BASE_S="0",
             **(env or {}))
    return (tag, timeout, time.perf_counter(), subprocess.Popen(
        cmd, cwd=HERE, env=e, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))


def _mh_wait(started):
    """(artifact extra, wall s) of a runner :func:`_mh_start` started;
    raises on a non-zero exit, killing it past its timeout."""
    tag, timeout, t0, proc = started
    try:
        out, err = proc.communicate(
            timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"[multihost] {tag}: runner exit "
                           f"{proc.returncode}\n{err[-6000:]}")
    return json.loads(out.strip().splitlines()[-1])["extra"], wall


def phase_multihost(workdir: str, device: str = "cuda"):
    """The [multihost] path (module docstring, 6d).  Returns each kernel's
    launches in each rank: {kernel: [rank 0, rank 1]}."""
    import numpy as np
    import torch
    from parmmg_tpu_torch.core.mesh import MESH_FIELDS, mesh_from_numpy
    ex, wall = _mh_wait(_mh_start(workdir, "main", MH_ARGS + ("--parity",),
                                  device, timeout=900))
    ref, ws = ex["ref"], ex["workers"]
    print(f"[multihost] cube_mesh(32) 4 shards -niter 2 (cycles 10): "
          f"one-process reference {ref['ntets']} tets, qmin "
          f"{ref['qmin']:.6f} qmean {ref['qmean']:.6f}, run "
          f"{ref['seconds']:.3f} s ({ex['ref_wall_s']:.3f} s with its "
          "process)")
    for w in ws:
        print(f"[multihost] rank {w['rank']}/2 on {w['device']}: "
              f"{w['ntets']} tets, qmin {w['qmin']:.6f} qmean "
              f"{w['qmean']:.6f}, run {w['seconds']:.3f} s, hash "
              f"{w['hash']} (reference {ref['hash']}), band exchange bytes "
              f"{int(w['mh.band_exchange_bytes'])} of "
              f"{int(w['mh.hot_collective_bytes'])} hot collective bytes, "
              f"allgather bytes "
              f"{int(w['mh.allgather_bytes'])} (hot "
              f"{int(w['mh.hot_allgather_bytes'])}), collectives "
              f"{int(w['mh.collectives'])} moving "
              f"{int(w['mh.collective_bytes'])} bytes, nvcc builds "
              f"{w['nvcc_builds']}")
        print(f"[multihost] rank {w['rank']} launches {w['launches']}")
    print(f"[multihost] 2-rank pack wall {ex['wall_s']:.3f} s (processes "
          f"included); parity_ok {ex['parity_ok']}")
    must, must_not = PATH_KERNELS["cube32"]
    for w in ws:
        if w["hash"] != ref["hash"]:
            raise RuntimeError(f"[multihost] rank {w['rank']} hash "
                               f"{w['hash']} != reference {ref['hash']}")
        if w["mh.hot_allgather_bytes"] or not w["mh.band_exchange_bytes"]:
            raise RuntimeError(f"[multihost] rank {w['rank']}: hot "
                               f"allgather {w['mh.hot_allgather_bytes']}, "
                               f"band {w['mh.band_exchange_bytes']}")
        if w["nvcc_builds"] or w["jax_loaded"]:
            raise RuntimeError(f"[multihost] rank {w['rank']} built "
                               f"{w['nvcc_builds']} / imported jax "
                               f"{w['jax_loaded']}")
        missing = sorted(k for k in must if w["launches"][k] == 0)
        if device == "cuda" and (missing or w["launches"][must_not]):
            raise RuntimeError(f"[multihost] rank {w['rank']}: kernels "
                               f"never launched {missing}, {must_not} "
                               f"{w['launches'][must_not]}")
    with np.load(os.path.join(workdir, "mh.main", "timed.r0.npz")) as z:
        mesh = mesh_from_numpy({f: z[f] for f in MESH_FIELDS}, device)
        met = torch.from_numpy(np.array(z["met"])).to(device)
    bad, qmin, qmean = _check_conforming("[multihost]", mesh, met)
    print(f"[multihost] rank 0's merged mesh re-read: "
          f"{int(mesh.tmask.sum())} tets, adjacency {bad}, qmin {qmin:.6f}")
    # the drills, both packs at once: a crash and a wedge of rank 1 at
    # its pass-1 extend exchange (after the pass-0 checkpoint), each
    # resumed
    ck = os.path.join(workdir, "mh.ckpt")
    for d in (ck + "1", ck + "2"):
        shutil.rmtree(d, ignore_errors=True)
    crash = _mh_start(
        workdir, "crash", MH_DRILL_ARGS + (
            "--parity", "--ckpt", ck + "1", "--fault",
            "1:multihost.exchange:key=extend;nth-2"),
        device, env={"PMTORCH_RETRY_MAX": "0"})
    wedge = _mh_start(
        workdir, "wedge", MH_DRILL_ARGS + (
            "--ckpt", ck + "2", "--lease", str(MH_LEASE_S), "--fault",
            "1:multihost.exchange:key=extend;nth-2;hang=600"),
        device, env={"PMTORCH_RETRY_MAX": "0", "PMTORCH_HEARTBEAT_S": "1"})
    try:
        exc, wc = _mh_wait(crash)
    finally:
        exw, ww = _mh_wait(wedge)
    base = exc["ref"]["hash"]
    print(f"[multihost] drills on cube_mesh(12): one-process "
          f"{exc['ref']['ntets']} tets, hash {base}; crash: rc "
          f"{exc.get('crashed_rc')}, resumed {exc.get('resumed')}, hashes "
          f"{[w['hash'] for w in exc['workers']]}, {wc:.3f} s with the "
          f"reference; wedge: rc {exw.get('crashed_rc')}, stale "
          f"{exw.get('stale_heartbeat')}, resumed {exw.get('resumed')}, "
          f"hashes {[w['hash'] for w in exw['workers']]}, {ww:.3f} s "
          f"(lease {MH_LEASE_S} s)")
    for d in (ck + "1", ck + "2"):
        shutil.rmtree(d, ignore_errors=True)
    if not exc.get("crashed_rc") or not exc.get("resumed") or \
            exw.get("crashed_rc") != 9 or not exw.get("resumed") or \
            any(w["hash"] != base for w in exc["workers"] + exw["workers"]):
        raise RuntimeError("[multihost] a drill did not resume to the "
                           "one-process bytes")
    return {k: [w["launches"][k] for w in ws] for k in ws[0]["launches"]}


# the [chaos] phase: the [grouped] input at chunk 8 (checks 1-4), and
# (stem, cube_mesh(n), metric_n, flags, chunk) for checks 5-8: cube_mesh(12)
# at -mesh-size 1728 (6 groups) under the shock map of cube_mesh(8)
# (h = 1.5/8; the cube16 map refines these groups to 181,352 tets at 57 s a
# run; cube_mesh(16) at -mesh-size 4096 took ~110 s of the phase, and the
# [dist] phase needed the room), chunk 4; the profiler window (check 9) on cube_mesh(4) at
# -mesh-size 192 (2 groups): a host-bound pass launches ~10^4 ops a
# group-cycle, and its trace holds a few events each (pass 1 of
# cube_mesh(8), 3 groups, wrote 327 MB, of cube_mesh(6) 319 MB in 60 s)
CHAOS_SMALL = ("cube12c", 12, 8, ("-mesh-size", "1728", "-niter", "2"), 4)
CHAOS_PROF = ("cube4c", 4, ("-mesh-size", "192", "-niter", "2"))


@contextlib.contextmanager
def _knobs(**kv):
    """PMTORCH_* knobs set for the scope (None unsets), the fault
    registry re-armed from them at entry and exit."""
    from parmmg_tpu_torch.resilience.faults import FAULTS
    old = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    FAULTS.reset()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        FAULTS.reset()


def _counters():
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    return dict(REGISTRY.snapshot()["counters"])


def _moved(c0, name):
    return _counters().get(name, 0) - c0.get(name, 0)


def _same_outputs(a: str, b: str):
    for ext in (".mesh", ".sol"):
        _same_bytes(a[:-5] + ext, b[:-5] + ext)


class _CkptWatch:
    """Times every pass checkpoint (npz) and shard snapshot and every
    grouped pass of the runs inside the scope; sizes come from the
    files."""

    def __init__(self):
        self.npz, self.snap, self.passes = [], [], []

    def __enter__(self):
        from parmmg_tpu_torch.parallel import groups
        from parmmg_tpu_torch.resilience import checkpoint as ck
        self._real = (ck.save_pass_checkpoint, ck.snapshot_stacked,
                      groups.grouped_adapt_pass)
        save, snap, gpass = self._real

        def timed(fn, log):
            def call(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                log.append((time.perf_counter() - t0, out))
                return out
            return call
        ck.save_pass_checkpoint = timed(save, self.npz)
        ck.snapshot_stacked = timed(snap, self.snap)
        groups.grouped_adapt_pass = timed(gpass, self.passes)
        return self

    def __exit__(self, *exc):
        from parmmg_tpu_torch.parallel import groups
        from parmmg_tpu_torch.resilience import checkpoint as ck
        (ck.save_pass_checkpoint, ck.snapshot_stacked,
         groups.grouped_adapt_pass) = self._real
        return False

    def lines(self):
        out = []
        for k, ((sn, nz), (sp, fs), (pw, _)) in enumerate(
                zip(self.npz, self.snap, self.passes)):
            nb = os.path.getsize(nz) if nz else 0
            sb = sum(os.path.getsize(f) for f in fs)
            out.append(f"pass {k}: wall {pw:.3f} s; npz {sn:.3f} s "
                       f"{nb} B; shard snapshot {sp:.3f} s {sb} B in "
                       f"{len(fs)} files")
        return out


def _mem_reset(device: str) -> None:
    """Empty the allocator's cache and restart its peak counters, so that
    the next run's peaks are its own."""
    import torch
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _mem_peak(device: str) -> str:
    """The card's peak allocated and reserved bytes since
    :func:`_mem_reset`."""
    import torch
    if device != "cuda":
        return "peak memory not measured (CPU)"
    return (f"peak allocated {torch.cuda.max_memory_allocated()} B, "
            f"reserved {torch.cuda.max_memory_reserved()} B")


def _side_streams() -> int:
    """The side streams the guarded dispatch attempts made so far."""
    from parmmg_tpu_torch.parallel import groups
    return sum(len(p) for p in groups._SIDE_STREAMS.values())


def _join_abandoned():
    """Wait for abandoned dispatch attempts (they stop at their next
    progress report)."""
    import threading
    for t in threading.enumerate():
        if t.name.startswith("parmmg-watchdog-dispatch"):
            t.join(timeout=120)


def _small_state(workdir: str, device: str):
    """The small chaos input as a grouped pass takes it: (mesh, metric,
    groups) on the device."""
    from parmmg_tpu_torch.ops.analysis import analyze_mesh
    from parmmg_tpu_torch.parallel.groups import how_many_groups
    stem, _, _, flags, _ = CHAOS_SMALL
    mesh, met, _ = _read_output(os.path.join(workdir, f"{stem}.mesh"),
                                device)
    mesh = analyze_mesh(mesh).mesh
    return mesh, met, how_many_groups(int(mesh.tmask.sum()), int(flags[1]))


def _pass_bytes(out):
    from parmmg_tpu_torch.core.mesh import MESH_FIELDS
    mesh, met, part = out
    return tuple(getattr(mesh, f).cpu().numpy().tobytes()
                 for f in MESH_FIELDS) + (met.cpu().numpy().tobytes(),
                                          part.tobytes())


def phase_chaos(workdir: str, device: str = "cuda", base: str | None = None):
    """The [chaos] phase: the resilience layer on the card, every drill
    against the fault-free bytes.  On the [grouped] input at chunk 8
    (``base``: [grouped]'s output; made here when None): 1. checkpoints
    armed, no fault: the base bytes, 2 pass checkpoints and 12 shard
    files a pass, no new shape in the ledger; 2. an nth-1
    ``dispatch.chunk`` fault: the base bytes, the retry rung recorded;
    3. ``dispatch.chunk:hang=3;nth-1`` under a 0.5 s dispatch deadline
    (grace 0): the base bytes, a watchdog expiry; 4. a CLI subprocess
    SIGKILLed once ``grouped.pass0.npz`` appears, then ``-resume`` in this
    process: the base bytes, one resume.  On cube_mesh(12) at -mesh-size
    1728 under a coarser map (CHAOS_SMALL): 5. ``io.checkpoint`` armed:
    its base bytes, no
    ``.npz`` or ``.tmp`` left; 6. every dispatch failing: PMMG_LOWFAILURE
    and a conforming output; 7. ``grouped_adapt_pass(polish=True)`` with
    the subprocess worker equals the in-process polish (the worker ran on
    the card: its launches); 8. a dead and a hung worker each equal the
    polish-less pass.  9. On cube_mesh(4) at -mesh-size 192 (CHAOS_PROF),
    the profiler window over pass 1 writes one Chrome trace with CUDA
    kernel events.  Launch counts are summed over the phase's runs in this
    process: K1 and K3-K8 must launch, K2 not.
    Returns the launches."""
    import subprocess
    import torch
    from parmmg_tpu_torch import cli
    from parmmg_tpu_torch.core import constants as C
    from parmmg_tpu_torch.ops import kernels
    from parmmg_tpu_torch.ops.adapt import AdaptStats
    from parmmg_tpu_torch.parallel import groups
    from parmmg_tpu_torch.resilience import checkpoint as ck
    from parmmg_tpu_torch.resilience import recover
    from parmmg_tpu_torch.utils.compilecache import variants_by_prefix
    stem = "cube32"
    total = {k: 0 for k in kernels.LAUNCHES}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    if not os.path.exists(os.path.join(workdir, f"{stem}.mesh")):
        _write_input(workdir, stem, n=32, metric_n=16)
    if base is None:
        base = os.path.join(workdir, f"{stem}.chaos_base.mesh")
        _mem_reset(device)
        _, _, wb, _ = _run_grouped(workdir, base, device)
        print(f"[chaos] base run (defaults): wall {wb:.3f} s, "
              f"{_mem_peak(device)}")
    chunk = {"chunk": 8}

    # 1. checkpoints armed, no fault
    ckdir = os.path.join(workdir, "chaos_ck")
    subprocess.run(["rm", "-rf", ckdir], check=True)
    v0 = variants_by_prefix("")
    out1 = os.path.join(workdir, f"{stem}.chaos1.mesh")
    _mem_reset(device)
    with _knobs(PMTORCH_CKPT_DIR=ckdir), _CkptWatch() as cw:
        l1, rec1, w1, _ = _run_grouped(workdir, out1, device, pass_kw=chunk)
    add(l1)
    _same_outputs(base, out1)
    names = sorted(os.listdir(ckdir))
    npz = [n for n in names if n.endswith(".npz")]
    shards = [sum(n.startswith(f"grouped.pass{k}.") and n.endswith(".mesh")
                  for n in names) for k in range(2)]
    v1 = variants_by_prefix("")
    if npz != ["grouped.pass0.npz", "grouped.pass1.npz"] or \
            shards != JAX_CLI_GROUPS or v1 != v0:
        raise RuntimeError(f"[chaos] 1: checkpoints {npz}, shard files a "
                           f"pass {shards}, ledger variants {v0} -> {v1}")
    print(f"[chaos] 1 ckpt armed, chunk 8: {rec1['ntets']} tets, wall "
          f"{w1:.3f} s, base bytes; {npz}, shard files a pass {shards}; "
          f"no new ledger shape; {_mem_peak(device)}")
    for ln in cw.lines():
        print(f"[chaos] 1   {ln}")

    # the dispatch watchdog armed, no fault: its wall and memory against
    # run 1's (every attempt on the first side stream of the pool)
    out1b = os.path.join(workdir, f"{stem}.chaos1b.mesh")
    _mem_reset(device)
    with _knobs(PMTORCH_DEADLINE_DISPATCH_S="30"):
        l1b, _, w1b, _ = _run_grouped(workdir, out1b, device,
                                      pass_kw=chunk)
    add(l1b)
    _same_outputs(base, out1b)
    if device == "cuda" and _side_streams() != 1:
        raise RuntimeError(f"[chaos] 1b: {_side_streams()} side streams "
                           "made without an expiry, not 1")
    print(f"[chaos] 1b dispatch deadline 30 s armed, no fault, chunk 8: "
          f"wall {w1b:.3f} s ({w1b - w1:+.3f} s against run 1), base "
          f"bytes; {_mem_peak(device)}; side streams {_side_streams()}")

    # 2. a dispatch fault, retried
    c0 = _counters()
    spent = []
    real_retry = recover.retry_call

    def timed_retry(fn, *a, **k):
        runs = []

        def attempt():
            t1 = time.perf_counter()
            try:
                return fn()
            finally:
                runs.append(time.perf_counter() - t1)
        t0 = time.perf_counter()
        try:
            return real_retry(attempt, *a, **k)
        finally:
            spent.append((time.perf_counter() - t0, sum(runs)))
    out2 = os.path.join(workdir, f"{stem}.chaos2.mesh")
    recover.retry_call = timed_retry
    try:
        with _knobs(PMTORCH_FAULT="dispatch.chunk:nth-1"):
            l2, _, w2, _ = _run_grouped(workdir, out2, device, pass_kw=chunk)
    finally:
        recover.retry_call = real_retry
    add(l2)
    _same_outputs(base, out2)
    if _moved(c0, "resilience.retry") < 1 or \
            _moved(c0, "resilience.faults_injected") != 1:
        raise RuntimeError("[chaos] 2: no retry recorded")
    print(f"[chaos] 2 dispatch.chunk:nth-1: wall {w2:.3f} s ({w2 - w1:+.3f} "
          f"s against run 1), base bytes; retry rung "
          f"{_moved(c0, 'resilience.retry')}; retry_call "
          f"{sum(t for t, _ in spent):.3f} s, of which the plan's re-run "
          f"{sum(r for _, r in spent):.3f} s and backoff and bookkeeping "
          f"{sum(t - r for t, r in spent):.3f} s")

    # 3. a wedged dispatch under the watchdog
    c0 = _counters()
    out3 = os.path.join(workdir, f"{stem}.chaos3.mesh")
    _mem_reset(device)
    with _knobs(PMTORCH_FAULT="dispatch.chunk:hang=3;nth-1",
                PMTORCH_DEADLINE_DISPATCH_S="0.5",
                PMTORCH_DEADLINE_GRACE_S="0"):
        l3, _, w3, _ = _run_grouped(workdir, out3, device, pass_kw=chunk)
        _join_abandoned()
    add(l3)
    _same_outputs(base, out3)
    if _moved(c0, "resilience.watchdog_timeouts") < 1:
        raise RuntimeError("[chaos] 3: no watchdog expiry")
    if device == "cuda" and _side_streams() > 2:
        raise RuntimeError(f"[chaos] 3: {_side_streams()} side streams "
                           "for one expiry, more than 2")
    print(f"[chaos] 3 dispatch.chunk:hang=3;nth-1, deadline 0.5 s: wall "
          f"{w3:.3f} s, base bytes; watchdog expiries "
          f"{_moved(c0, 'resilience.watchdog_timeouts')}, retries "
          f"{_moved(c0, 'resilience.retry')}; {_mem_peak(device)}; side "
          f"streams {_side_streams()}")

    # 4. a real kill after pass 0, then -resume
    kdir = os.path.join(workdir, "chaos_kill")
    subprocess.run(["rm", "-rf", kdir], check=True)
    kout = os.path.join(workdir, f"{stem}.chaos4k.mesh")
    env = dict(os.environ, PMTORCH_CKPT_DIR=kdir, PMTORCH_GROUP_CHUNK="8",
               PYTHONPATH=HERE)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "parmmg_tpu_torch.cli", "-in",
         os.path.join(workdir, f"{stem}.mesh"), "-sol",
         os.path.join(workdir, f"{stem}.sol"), "-out", kout, *GROUPED_FLAGS,
         "-v", "1", "-device", device], cwd=HERE, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    p0 = os.path.join(kdir, "grouped.pass0.npz")
    try:
        while not os.path.exists(p0):
            if proc.poll() is not None:
                raise RuntimeError("[chaos] 4: the CLI ended before pass 0's "
                                   f"checkpoint: {proc.stderr.read()[-2000:]}")
            if time.perf_counter() - t0 > 300:
                raise RuntimeError("[chaos] 4: no pass 0 checkpoint in 300 s")
            time.sleep(0.02)
        tk = time.perf_counter() - t0
        proc.kill()
    finally:
        proc.kill()
        proc.wait()
    left = sorted(os.listdir(kdir))
    with _knobs(PMTORCH_CKPT_DIR=kdir):
        found = ck.latest_pass_checkpoint("grouped")
    if proc.returncode != -9 or found is None or \
            not found[0].endswith("grouped.pass0.npz"):
        raise RuntimeError(f"[chaos] 4: rc {proc.returncode}, files {left}, "
                           f"latest {found}")
    c0 = _counters()
    out4 = os.path.join(workdir, f"{stem}.chaos4.mesh")
    with _knobs(PMTORCH_CKPT_DIR=kdir):
        l4, _, w4, _ = _run_grouped(workdir, out4, device, pass_kw=chunk,
                                    flags=GROUPED_FLAGS + ("-resume",))
    add(l4)
    _same_outputs(base, out4)
    if _moved(c0, "resilience.resumes") != 1:
        raise RuntimeError("[chaos] 4: resumes "
                           f"{_moved(c0, 'resilience.resumes')}")
    print(f"[chaos] 4 SIGKILL {tk:.3f} s after start (pass 0 checkpoint "
          f"seen; files then {left}; .tmp taken: none), -resume: wall "
          f"{w4:.3f} s against the full run's {w1:.3f} s, base bytes, "
          "resumes 1")

    # the small configuration
    sstem, n, mn, sflags, schunk = CHAOS_SMALL
    _write_input(workdir, sstem, n=n, metric_n=mn)
    sbase = os.path.join(workdir, f"{sstem}.o.mesh")
    ls, recs, ws, _ = _run_grouped(workdir, sbase, device, stem=sstem,
                                   flags=sflags)
    add(ls)
    print(f"[chaos] small base: cube_mesh({n}), h = 1.5/{mn}, "
          f"{' '.join(sflags)}: "
          f"{recs['ntets']} tets, wall {ws:.3f} s")
    skw = {"chunk": schunk}

    # 5. checkpoint IO failing
    iodir = os.path.join(workdir, "chaos_io")
    subprocess.run(["rm", "-rf", iodir], check=True)
    c0 = _counters()
    out5 = os.path.join(workdir, f"{sstem}.chaos5.mesh")
    with _knobs(PMTORCH_CKPT_DIR=iodir, PMTORCH_FAULT="io.checkpoint"):
        l5, _, w5, _ = _run_grouped(workdir, out5, device, pass_kw=skw,
                                    stem=sstem, flags=sflags)
    add(l5)
    _same_outputs(sbase, out5)
    left = os.listdir(iodir) if os.path.isdir(iodir) else []
    if any(f.endswith((".npz", ".tmp")) for f in left) or \
            _moved(c0, "resilience.checkpoint_failures") < 2:
        raise RuntimeError(f"[chaos] 5: left {left}, failures "
                           f"{_moved(c0, 'resilience.checkpoint_failures')}")
    print(f"[chaos] 5 io.checkpoint: wall {w5:.3f} s, base bytes, "
          f"checkpoint failures "
          f"{_moved(c0, 'resilience.checkpoint_failures')}, files left "
          f"{left}")

    # 6. retries exhausted: LOWFAILURE with a conforming output
    c0 = _counters()
    out6 = os.path.join(workdir, f"{sstem}.chaos6.mesh")
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with _knobs(PMTORCH_FAULT="dispatch.chunk", PMTORCH_RETRY_MAX="1",
                PMTORCH_GROUP_CHUNK=str(schunk)), \
            contextlib.redirect_stdout(buf):
        rc = cli.main(["-in", os.path.join(workdir, f"{sstem}.mesh"), "-sol",
                       os.path.join(workdir, f"{sstem}.sol"), "-out", out6,
                       *sflags, "-v", "1", "-device", device])
    w6 = time.perf_counter() - t0
    add({k: kernels.LAUNCHES[k] - before[k] for k in before})
    mesh6, met6, _ = _read_output(out6, device)
    bad, qmin, _ = _check_conforming("[chaos] 6", mesh6, met6)
    if rc != C.PMMG_LOWFAILURE or _moved(c0, "resilience.lowfailure") != 1:
        raise RuntimeError(f"[chaos] 6: rc {rc}, lowfailure "
                           f"{_moved(c0, 'resilience.lowfailure')}")
    print(f"[chaos] 6 dispatch.chunk every hit, 1 retry: rc {rc} "
          f"(PMMG_LOWFAILURE), wall {w6:.3f} s, conforming "
          f"{int(mesh6.tmask.sum())} tets, qmin {qmin:.6f}")

    # 7-8. the grouped polish: in this process, in the worker, without
    mesh, met, ng = _small_state(workdir, device)

    def gpass(**kw):
        st = AdaptStats()
        b0 = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        out = groups.grouped_adapt_pass(mesh, met, ng, cycles=12,
                                        chunk=schunk, stats=st, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add({k: kernels.LAUNCHES[k] - b0[k] for k in b0})
        return _pass_bytes(out), wall, st
    plain, wp, _ = gpass()
    inproc, wi, _ = gpass(polish=True)
    if inproc == plain:
        raise RuntimeError("[chaos] 7: the grouped polish changed nothing")
    with _knobs(PMTORCH_POLISH_SUBPROC="1"):
        sub, wsub, st = gpass(polish=True)
    se = st.sched_extra
    wl = se["polish_worker_launches"][0]
    if sub != inproc or (device == "cuda" and not any(wl.values())):
        raise RuntimeError(f"[chaos] 7: worker bytes equal {sub == inproc}, "
                           f"its launches {wl}")
    print(f"[chaos] 7 grouped_adapt_pass({ng} groups, chunk {schunk}): "
          f"polish-less {wp:.3f} s, in-process polish {wi:.3f} s, worker "
          f"{wsub:.3f} s (subprocess wall "
          f"{se['polish_worker_wall_s'][0]:.3f} s: cold start "
          f"{se['polish_worker_cold_s'][0]:.3f} s, polish "
          f"{se['polish_worker_polish_s'][0]:.3f} s), worker bytes = "
          f"in-process bytes; worker launches {wl}")
    # 7b. the user's path to it: the CLI's -group-polish, one pass, in
    # this process and in the worker
    pflags = (*sflags[:2], "-niter", "1", "-group-polish")
    outs = {}
    for tag, kv in (("in-process", {}), ("worker",
                                         {"PMTORCH_POLISH_SUBPROC": "1"})):
        o = os.path.join(workdir, f"{sstem}.chaos7b_{tag}.mesh")
        with _knobs(**kv):
            lg, _, wg, ig = _run_grouped(workdir, o, device, pass_kw=skw,
                                         stem=sstem, flags=pflags)
        add(lg)
        outs[tag] = (o, wg, ig["stats"].sched_extra)
    (oi, wgi, sei), (ow, wgw, sew) = outs["in-process"], outs["worker"]
    _same_outputs(oi, ow)
    if "polish_worker_cold_s" in sei or \
            len(sew.get("polish_worker_cold_s", [])) != 1:
        raise RuntimeError("[chaos] 7b: the worker ran "
                           f"{len(sew.get('polish_worker_cold_s', []))} "
                           "times under PMTORCH_POLISH_SUBPROC, "
                           f"{'polish_worker_cold_s' in sei} without")
    print(f"[chaos] 7b CLI {' '.join(pflags)}, chunk {schunk}: in-process "
          f"wall {wgi:.3f} s, worker wall {wgw:.3f} s (cold start "
          f"{sew['polish_worker_cold_s'][0]:.3f} s, polish "
          f"{sew['polish_worker_polish_s'][0]:.3f} s), same .mesh/.sol "
          "bytes")
    pre = {d for d in os.listdir(tempfile.gettempdir())
           if d.startswith("parmmg_polish_")}
    for tag, kv in (("dead", {"PMTORCH_FAULT": "polish.worker",
                              "PMTORCH_RETRY_MAX": "1"}),
                    ("hung", {"PMTORCH_FAULT": "polish.worker:hang=120",
                              "PMTORCH_RETRY_MAX": "0",
                              "PMTORCH_POLISH_TIMEOUT_S": "5"})):
        c0 = _counters()
        with _knobs(PMTORCH_POLISH_SUBPROC="1", **kv):
            got, wdg, _ = gpass(polish=True)
        if got != plain or _moved(c0, "resilience.merged_polish") != 1:
            raise RuntimeError(f"[chaos] 8 {tag} worker: polish-less bytes "
                               f"{got == plain}, merged_polish "
                               f"{_moved(c0, 'resilience.merged_polish')}")
        print(f"[chaos] 8 {tag} worker: wall {wdg:.3f} s, the polish-less "
              "bytes, rung merged_polish")
    leaks = {d for d in os.listdir(tempfile.gettempdir())
             if d.startswith("parmmg_polish_")} - pre
    if leaks:
        raise RuntimeError(f"[chaos] 8: staging left behind {leaks}")

    # 9. the profiler window over pass 1
    pstem, pn, pflags = CHAOS_PROF
    _write_input(workdir, pstem, n=pn)
    pbase = os.path.join(workdir, f"{pstem}.o.mesh")
    lp, _, wpb, _ = _run_grouped(workdir, pbase, device, stem=pstem,
                                 flags=pflags)
    add(lp)
    pdir = os.path.join(workdir, "chaos_prof")
    subprocess.run(["rm", "-rf", pdir], check=True)
    out9 = os.path.join(workdir, f"{pstem}.chaos9.mesh")
    # in a process of its own: after a capture of ~10^6 events in this
    # process, [kernels]' profiler counts missed kernels on the H100
    env = dict(os.environ, PMTORCH_PROFILE_DIR=pdir,
               PMTORCH_PROFILE_PASS="1", PYTHONPATH=HERE)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "parmmg_tpu_torch.cli", "-in",
         os.path.join(workdir, f"{pstem}.mesh"), "-sol",
         os.path.join(workdir, f"{pstem}.sol"), "-out", out9, *pflags,
         "-v", "1", "-bench-json", "-device", device], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=600)
    w9 = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"[chaos] 9: the profiled CLI exited "
                           f"{r.returncode}: {r.stderr[-2000:]}")
    rec9 = json.loads([ln for ln in r.stdout.splitlines()
                       if ln.startswith("{")][-1])
    _same_outputs(pbase, out9)
    files = sorted(os.listdir(pdir))
    if len(files) != 1:
        raise RuntimeError(f"[chaos] 9: trace files {files}")
    tpath = os.path.join(pdir, files[0])
    with open(tpath) as fh:
        evs = json.load(fh).get("traceEvents", [])
    nk = sum(e.get("cat") == "kernel" for e in evs)
    if device == "cuda" and nk == 0:
        raise RuntimeError("[chaos] 9: no CUDA kernel event in the trace")
    print(f"[chaos] 9 profiler window pass 1, cube_mesh({pn}) "
          f"{' '.join(pflags)}, a CLI subprocess: wall {w9:.3f} s (its "
          f"remesh {rec9['wall_s']:.3f} s; {wpb:.3f} s unprofiled in this "
          f"process), same bytes; {files[0]} "
          f"{os.path.getsize(tpath)} B, {len(evs)} events, {nk} CUDA "
          "kernel events")

    print(f"[chaos] launches {total}")
    must, must_not = PATH_KERNELS["cube32"]
    missing = sorted(k for k in must if total[k] == 0)
    if device == "cuda" and (missing or total[must_not]):
        raise RuntimeError(f"[chaos] kernels never launched {missing}, "
                           f"{must_not} launched {total[must_not]} times")
    return total


# the JAX pool's tet count on the first tenant of each [serve] class, as
# its accelerator runs it (PARMMG_CYCLE_BLOCK=9, one slot, jitted; on the
# CPU, jax 0.9.0): JAX_PLATFORMS=cpu python tools/jax_serve_reference.py
JAX_POOL_NTETS = {"iso12": 28545, "cube16": 68085, "cube24": 162429,
                  "ani12": 190957}
SERVE_RATE = 2.0            # arrivals a second, open loop
SERVE_CYCLES = 6
ALL_KERNELS = ("edge_lengths_iso", "edge_lengths_ani", "score_count",
               "score3_count", "merge_prefix", "tet_quality", "radix_sort",
               "segment_flags")


def _serve_run(tenants, device: str, arm: str | None = None,
               together: bool = False, **kw):
    """Start a ``PoolDaemon(port=0)`` in this process, submit ``tenants``
    over localhost HTTP through the port's client, open loop at
    SERVE_RATE arrivals a second (a 429 is counted and retried 0.1 s
    later), wait for every request and fetch the done ones.  ``arm``: a
    fault spec armed for the run.  ``together``: start the daemon paused,
    submit every tenant at once, then resume it, so that the first step
    admits them all.  Returns a dict: the fetched arrays, the final polls,
    the daemon's report, the deferred submits, (seconds, queue depth,
    active tenants) sampled from /healthz every 0.25 s, the wall from the
    first submit to the last fetch, the daemon's /metrics series before
    the first submit and after the last fetch, its /trace summary, and
    the trace id of the pool's pipeline timers."""
    import threading
    from parmmg_tpu_torch.obs.metrics import parse_prometheus
    from parmmg_tpu_torch.resilience.faults import FAULTS
    from parmmg_tpu_torch.serve.client import (BackpressureDeferred,
                                               ServeClient)
    from parmmg_tpu_torch.serve.daemon import PoolDaemon
    d = PoolDaemon(port=0, device=device, cycles=SERVE_CYCLES,
                   start_paused=together, **kw).start()
    info = {"deferred": 0, "samples": [], "arrays": {}, "polls": {}}
    stop = threading.Event()
    try:
        cl = ServeClient(port=d.port, timeout_s=900)
        info["metrics0"] = parse_prometheus(cl.metrics_text())
        if arm:
            FAULTS.arm(arm)
        t0 = time.perf_counter()

        def sample():
            probe = ServeClient(port=d.port, timeout_s=60)
            while not stop.is_set():
                h = probe.health()
                info["samples"].append(
                    (round(time.perf_counter() - t0, 2), h["queue"],
                     h["active"]))
                stop.wait(0.25)
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        for k, (tid, _cls, vert, tet, met) in enumerate(tenants):
            pause = t0 + k / SERVE_RATE - time.perf_counter()
            if pause > 0 and not together:
                time.sleep(pause)
            while True:
                try:
                    cl.submit(vert=vert, tet=tet, met=met, tenant=tid)
                    break
                except BackpressureDeferred:
                    info["deferred"] += 1
                    time.sleep(0.1)
        if together:
            cl.resume()
        for tid, *_ in tenants:
            got = cl.wait(tid, timeout_s=900, interval_s=0.02)
            info["polls"][tid] = got
            if got["state"] == "done":
                info["arrays"][tid] = cl.fetch(tid)
        info["wall"] = time.perf_counter() - t0
        stop.set()
        sampler.join(timeout=10)
        info["report"] = cl.report()
        info["metrics1"] = parse_prometheus(cl.metrics_text())
        info["trace"] = cl.trace(last=0)["summary"]
        info["timers_id"] = d.driver.pool.timers.trace_id
    finally:
        stop.set()
        FAULTS.reset()
        d.shutdown()
    return info


@contextlib.contextmanager
def _host_spans(device: str):
    """Wall seconds and calls of the serving path's host stages while the
    block is active: npz decode and encode (the RPC edge), staging, the
    split at load, the merge and quality at retirement, and the pool's
    steps (which include the mid-step retirements).  Each wrapped call
    ends with a device synchronise, so a stage is charged its device
    work.  Yields {stage: [seconds, calls]}."""
    import threading
    import torch
    from parmmg_tpu_torch.serve import daemon, driver, pool
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    acc: dict = {}
    lock = threading.Lock()
    targets = [(daemon, "decode_npz", "npz decode"),
               (daemon, "encode_npz", "npz encode"),
               (driver.ServeDriver, "stage_payload", "stage"),
               (pool.SlotPool, "load", "load (split)"),
               (pool.SlotPool, "merge", "merge"),
               (driver.ServeDriver, "_quality", "quality"),
               (pool.SlotPool, "step", "pool steps")]
    saved = [(o, a, getattr(o, a)) for o, a, _ in targets]

    def wrap(fn, name):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                sync()
                with lock:
                    x = acc.setdefault(name, [0.0, 0])
                    x[0] += time.perf_counter() - t0
                    x[1] += 1
        return timed
    for (o, a, name), (_, _, fn) in zip(targets, saved):
        setattr(o, a, wrap(fn, name))
    try:
        yield acc
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)


def _fetched_mesh(arrays, device: str):
    import torch
    from parmmg_tpu_torch.core.mesh import mesh_from_numpy
    return (mesh_from_numpy(arrays, device),
            torch.from_numpy(arrays["met"]).to(device))


def phase_serve(workdir: str, device: str = "cuda"):
    """The [serve] path: remeshing as a service.  A ``PoolDaemon`` on the
    card (two slots a bucket, 6 cycles a tenant, one tenant a dispatch,
    streaming admission and autoscale on) serves ``serve_tenants()``'s
    eight tenants, submitted over localhost HTTP by the port's client at
    two a second.  Launch counts zeroed before the first submit and read
    after the last fetch: all eight kernels must have launched, K2 and
    K6's tensor mode (from the tensor class) included.  Checked: every
    tenant DONE, each fetched mesh conforming with qmin > 0, the first
    tenant of each class byte-equal (every field and the metric) to its
    standalone ``grouped_adapt_pass(ngroups=1, cycles=6)`` on the card,
    staged by the same ``stage_arrays``, with a tet count within 2% of
    the JAX pool's (JAX_POOL_NTETS).  Then a short second run of the two
    iso12 tenants, submitted to a paused daemon so that one step packs
    both in a chunk=2 dispatch, with ``serve.slot_step`` armed on the
    second: that packed dispatch must fault (a two-slot step, and
    ``resilience.serve_cohort_faults`` moves), the second tenant must end
    quarantined, the first must write the first run's bytes, and its
    distributed output (``write_distributed`` at retirement) read back
    must hold its live tets.  Returns the launch counts of the first
    run."""
    import numpy as np
    import torch
    from parmmg_tpu_torch.core.mesh import MESH_FIELDS, mesh_to_numpy
    from parmmg_tpu_torch.io.distributed import load_distributed_mesh
    from parmmg_tpu_torch.obs.trace import TRACER, replay_totals
    from parmmg_tpu_torch.ops import kernels as K
    from parmmg_tpu_torch.parallel.groups import grouped_adapt_pass
    from parmmg_tpu_torch.serve.admission import stage_arrays
    tenants = serve_tenants()
    # K6's tensor mode: the launches of calls given a tensor metric
    real_k6, k6_tensor = K.tet_quality, [0]

    def k6(vert, tet, tmask, met6=None):
        before = K.LAUNCHES["tet_quality"]
        out = real_k6(vert, tet, tmask, met6)
        if met6 is not None:
            k6_tensor[0] += K.LAUNCHES["tet_quality"] - before
        return out
    # every trace record of the run goes to a JSONL file, as the daemon
    # front end's --trace writes it
    trace_path = os.path.join(workdir, "serve_trace.jsonl")
    if os.path.exists(trace_path):
        os.remove(trace_path)
    K.reset_launches()
    K.tet_quality = k6
    TRACER.configure(trace_path)
    try:
        with _host_spans(device) as spans:
            run = _serve_run(tenants, device, slots_per_bucket=2)
    finally:
        TRACER.configure(None)
        K.tet_quality = real_k6
    launches = dict(K.LAUNCHES)
    rep = run["report"]
    pool = rep["pool"]
    served = len(run["arrays"])
    print(f"[serve] {len(tenants)} tenants submitted over HTTP at "
          f"{SERVE_RATE:g} a second: {served} done, {rep['failed']} failed, "
          f"quarantined {pool['quarantined']}; wall {run['wall']:.3f} s "
          f"from the first submit to the last fetch = "
          f"{served / run['wall']:.3f} meshes/s; latency (submit to "
          f"retirement) p50 {rep['latency_p50_s']:.3f} p90 "
          f"{rep['latency_p90_s']:.3f} p99 {rep['latency_p99_s']:.3f} max "
          f"{rep['latency_max_s']:.3f} s")
    for tid, cls, vert, tet, met in tenants:
        t = rep["tenants"][tid]
        q = t["quality"] or {}
        print(f"[serve] {tid}: {len(tet)} tets in -> {q.get('ntets')} out, "
              f"qmin {q.get('qmin')} qmean {q.get('qmean')}, latency "
              f"{t['latency_s']:.3f} s, cycles {t['cycles']}, ops s/c/w/m "
              f"{t['ops']}, state {t['state']}")
    changes = [x for i, x in enumerate(run["samples"])
               if i == 0 or x[1:] != run["samples"][i - 1][1:]]
    print(f"[serve] (seconds, queue depth, active tenants) from /healthz, "
          f"where they changed (sampled every 0.25 s): {changes}")
    occ = {}
    for i, step in enumerate(rep["occupancy_traj"]):
        for label, (used, n) in step.items():
            occ.setdefault(label, []).append(f"{i}:{used}/{n}")
    print(f"[serve] bucket occupancy (step:rented/slots) over "
          f"{len(rep['occupancy_traj'])} steps: "
          + "; ".join(f"{k} {' '.join(v)}" for k, v in occ.items()))
    print(f"[serve] stream admissions {rep['admission']['stream_admissions']}"
          f", deferred submits {run['deferred']} (429s retried; admission "
          f"counted {rep['admission']['deferred']}), autoscale "
          f"{rep['autoscale']}")
    print(f"[serve] pool: steps {pool['steps']}, dispatches "
          f"{pool['dispatches']}, promotions (regrows) {pool['regrows']}, "
          f"active slots per step {pool['active_per_step']}, chunk "
          f"recommendation {pool['chunk_recommendation']}; buckets at the "
          f"end {pool['buckets']}")
    # the pipeline seconds again, replayed from the trace file: the
    # pool's Timers emit one span a segment
    replayed, _ = replay_totals(trace_path, tim=run["timers_id"])
    replayed = {k: round(v, 3) for k, v in replayed.items()}
    print(f"[serve] pipeline seconds {pool['pipeline_s']}; replayed from "
          f"the trace file {replayed}; /trace summary {run['trace']}")
    if set(replayed) != set(pool["pipeline_s"]) or any(
            abs(replayed[k] - v) > 2e-3 for k, v in pool["pipeline_s"].items()):
        raise RuntimeError("[serve] the trace file's pipeline spans do not "
                           "add up to the pool's timers")
    print("[serve] host stages (wall s, calls; pool steps include the "
          "mid-step retirements' merge and quality): " + ", ".join(
              f"{k} {v[0]:.3f} x{v[1]}" for k, v in spans.items()))
    print(f"[serve] launches {launches}; K6 tensor-mode launches "
          f"{k6_tensor[0]}")
    if served != len(tenants) or rep["failed"] or pool["quarantined"]:
        raise RuntimeError(f"[serve] not every tenant was served: "
                           f"{run['polls']}")
    missing = [k for k in ALL_KERNELS if not launches[k]]
    if device == "cuda" and (missing or not k6_tensor[0]):
        raise RuntimeError(f"[serve] kernels never launched {missing} "
                           f"(K6 tensor mode {k6_tensor[0]})")
    for tid, arrays in run["arrays"].items():
        mesh, met = _fetched_mesh(arrays, device)
        _check_conforming(f"[serve] {tid}", mesh, met)
    # the first tenant of each class against its standalone pass
    for tid, cls, vert, tet, met in tenants:
        if not tid.endswith("-0"):
            continue
        m, k = stage_arrays(vert, tet, met=met, device=device)
        sync = torch.cuda.synchronize if device == "cuda" else \
            (lambda: None)
        sync()
        t0 = time.perf_counter()
        out, kout, _ = grouped_adapt_pass(m, k, 1, cycles=SERVE_CYCLES)
        sync()
        wall = time.perf_counter() - t0
        want = mesh_to_numpy(out)
        got = run["arrays"][tid]
        diff = [f for f in MESH_FIELDS if not np.array_equal(got[f],
                                                             want[f])]
        if diff or not np.array_equal(got["met"], kout.cpu().numpy()):
            raise RuntimeError(f"[serve] {tid} differs from its standalone "
                               f"grouped_adapt_pass in {diff or ['met']}")
        nt = int(got["tmask"].sum())
        ref = JAX_POOL_NTETS[cls]
        print(f"[serve] {tid}: byte-equal to the standalone "
              f"grouped_adapt_pass(ngroups=1) (every field and the metric; "
              f"its wall {wall:.3f} s); {nt} tets, the JAX pool's {ref} "
              f"({(nt - ref) / ref:+.2%})")
        if abs(nt - ref) > NTETS_BOUND * ref:
            raise RuntimeError(f"[serve] {tid}: {nt} tets not within "
                               f"{NTETS_BOUND:.0%} of the JAX pool's {ref}")
    # the fault drill: the iso12 pair submitted to a paused daemon, so the
    # first step packs both in one chunk=2 dispatch, the second armed; the
    # packed dispatch faults, the cohort falls back to a slot a dispatch,
    # and the first keeps its bytes and writes its distributed output
    pair = [t for t in tenants if t[1] == "iso12"]
    bad = pair[1][0]
    out_dir = os.path.join(workdir, "serve_out")
    os.makedirs(out_dir, exist_ok=True)
    drill = _serve_run(pair, device, arm=f"serve.slot_step:key={bad}",
                       together=True, slots_per_bucket=2, chunk=2,
                       out_dir=out_dir)
    drep = drill["report"]
    good = pair[0][0]
    state = drep["tenants"][bad]["state"]
    series = ("parmmg_resilience_serve_cohort_faults_total", frozenset())
    cohort_faults = drill["metrics1"].get(series, 0) \
        - drill["metrics0"].get(series, 0)
    per_step = drep["pool"]["active_per_step"]
    print(f"[serve] fault drill (serve.slot_step armed on {bad}, submitted "
          f"with {good} to a paused daemon, chunk 2): active slots per step "
          f"{per_step}, dispatches {drep['pool']['dispatches']}, cohort "
          f"faults {cohort_faults:g}; {bad} {state} "
          f"({drep['tenants'][bad]['reason']}), quarantined "
          f"{drep['pool']['quarantined']}; {good} "
          f"{drep['tenants'][good]['state']}, wall {drill['wall']:.3f} s")
    if 2 not in per_step or cohort_faults < 1:
        raise RuntimeError(f"[serve] the fault drill never faulted a "
                           f"two-slot dispatch: active slots per step "
                           f"{per_step}, cohort faults {cohort_faults}")
    if state != "failed" or drep["pool"]["quarantined"] != [bad] or \
            good not in drill["arrays"]:
        raise RuntimeError(f"[serve] the fault drill did not quarantine "
                           f"exactly {bad}: {drill['polls']}")
    a, b = drill["arrays"][good], run["arrays"][good]
    diff = [f for f in list(MESH_FIELDS) + ["met"]
            if not np.array_equal(a[f], b[f])]
    if diff:
        raise RuntimeError(f"[serve] fault drill: {good} differs from the "
                           f"first run in {diff}")
    files = drep["tenants"][good]["out_files"]
    back, _, _ = load_distributed_mesh(os.path.join(out_dir, f"{good}.mesh"),
                                       0)
    nt = int(a["tmask"].sum())
    print(f"[serve] fault drill: {good} byte-equal to the first run; its "
          f"write_distributed output {files} read back: {len(back.tetra)} "
          f"tets, {len(back.vert)} points (fetched: {nt} live tets)")
    if len(back.tetra) != nt or len(files) != 1:
        raise RuntimeError(f"[serve] write_distributed wrote "
                           f"{len(back.tetra)} tets, not {nt}")
    return launches


def phase_stress(repeats: int = 5, band_shapes=None):
    """K3, K4, K5, K7 and K8 exactly against their plain versions at the
    edges of their tiles and runs and at 2**24 + 3 rows, each case
    ``repeats`` times; K2 within its tolerance on ``_k2_cases``, and K1
    on their rows under an iso size map with NaN and +-inf points and
    sizes; and K5 and K7 at the shapes the [grouped] run's band merges
    gave them (``band_shapes``: kernel -> [(rows, words)])."""
    import torch
    from parmmg_tpu_torch.core.constants import INT32_MAX
    from parmmg_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    big = 2 ** 24 + 3

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int64)

    def same(name, fn, ref):
        for r in range(repeats):
            got = fn()
            if not torch.equal(got, ref):
                bad = int((got != ref).nonzero()[0, 0])
                raise RuntimeError(
                    f"[stress] {name}: run {r + 1} differs from the plain "
                    f"version first at {bad} ({int(got[bad])} != "
                    f"{int(ref[bad])}): a look-back or stability bug")
    t0 = time.perf_counter()
    ncase = 0
    tile = K._tile("pm_merge_prefix_tile")
    for n in (1, tile - 1, tile, tile + 1, big):
        near = ints(2 ** 31 - 64, 2 ** 31, n)
        near = torch.where(ints(0, 2, n) == 0, near, -near)
        for label, x in (("small values", ints(-9, 100, n)),
                         ("values near +-2**31, wrapping sums", near)):
            x = x.to(torch.int32)
            same(f"merge_prefix n={n} {label}", lambda: K.merge_prefix(x),
                 K.merge_prefix_plain(x))
            ncase += 1
    tile = K._tile("pm_radix_tile")
    for n in (1, tile - 1, tile, tile + 1, big):
        full = ints(-2 ** 31, 2 ** 31, n).to(torch.int32)
        up = full[torch.sort(full.long() & 0xFFFFFFFF).indices]
        hi = torch.where(ints(0, 10, n) < 3, INT32_MAX,
                         ints(0, 46340, n)).to(torch.int32)
        w8 = torch.where(ints(0, 10, n) < 2, INT32_MAX,
                         ints(0, 255, n)).to(torch.int32)
        cases = {
            "full-range 32-bit keys": ((full,), None),
            "all-equal keys": ((torch.full_like(full, 12345),), None),
            "sorted keys": ((up,), None),
            "reverse-sorted keys": ((up.flip(0).contiguous(),), None),
            "all tombstones, nbits 16": ((torch.full_like(full, INT32_MAX),),
                                         (16,)),
            "(16, 32) bits with tombstones": ((hi, full), (16, 32)),
            "3 words, nbits (8, 16, 32)": ((w8, hi, full), (8, 16, 32)),
        }
        for label, (words, nbits) in cases.items():
            same(f"radix_sort n={n} {label}",
                 lambda: K.radix_sort(words, nbits),
                 K.radix_sort_plain(words, nbits))
            ncase += 1
    # K8 in both modes: around one tile of rows, at 2**24 + 3 rows, on 1-3
    # words with tombstones, and on columns viewed at a 1-element offset
    # (the kernel's unaligned path)
    tile = 256 * K._fn("pm_segment_flags_rows")()
    for n in (1, tile - 1, tile, tile + 1, big):
        w3 = torch.where(ints(0, 10, 3 * (n + 1)) < 2, INT32_MAX,
                         ints(0, 3, 3 * (n + 1))).to(torch.int32)
        w3 = w3.view(3, n + 1)
        for nw in (1, 2, 3):
            # sorted columns of n + 1 rows, viewed at each offset below
            buf = tuple(w3[j] for j in range(nw))
            pbuf = K.radix_sort(buf).long()
            sbuf = tuple(w[pbuf] for w in buf)
            for off in (0, 1):
                words = tuple(w3[j, off:off + n] for j in range(nw))
                perm = K.radix_sort(words)
                srt = tuple(s[off:off + n] for s in sbuf)
                view = f"at offset {off}"
                same(f"segment_flags n={n} {nw} words {view}",
                     lambda: K.segment_flags(srt),
                     K.segment_flags_plain(srt))
                ref = K.segment_flags_plain(words, order=perm)

                def gathered(words=words, perm=perm):
                    cols, first = K.segment_flags(words, order=perm)
                    return torch.cat([first.int(), *cols])
                same(f"segment_flags gathered n={n} {nw} words {view}",
                     gathered, torch.cat([ref[1].int(), *ref[0]]))
                ncase += 2
    # K3 / K4: output bits (NaN payloads included) and count, at tails of a
    # thread's run (4, 8 or 16 rows) and of a block (256 runs), at 2**24 + 3
    # rows, with NaN and +-inf among the values, on sparse and dense masks,
    # the mask and the values each aligned or viewed at a 1-element offset
    # (the three value rows of one tensor, so their alignments differ too)
    def score_bits(fn, mask, vals):
        out, cnt = fn(mask, *vals)
        return torch.cat([out.view(torch.int32), cnt.view(1)])
    for n in (1, 3, 5, 7, 9, 15, 17, 4095, 4097, big):
        vals = torch.rand((3, n + 1), generator=gen, device=dev)
        pick = ints(0, 64, 3 * (n + 1)).view(3, n + 1)
        for code, x in ((0, float("nan")), (1, float("inf")),
                        (2, float("-inf"))):
            vals = torch.where(pick == code, x, vals)
        for share in (0.03, 0.5):
            mask = torch.rand(n + 1, generator=gen, device=dev) < share
            for mo, vo in ((0, 0), (1, 1), (1, 0), (0, 1)):
                m = mask[mo:mo + n]
                vs = tuple(vals[k, vo:vo + n] for k in range(3))
                for name, args in (("score_count", vs[:1]),
                                   ("score3_count", vs)):
                    same(f"{name} n={n} share {share} mask at offset {mo}, "
                         f"values at offset {vo}",
                         lambda: score_bits(getattr(K, name), m, args),
                         score_bits(getattr(K, name + "_plain"), m, args))
                    ncase += 1
    # K5 and K7 at the band merges' shapes: survivor flags and insertion
    # histograms [6 capT] / [4 capT], band keys with their slot word
    # [6 B] / [4 B] (non-negative, tombstones INT32_MAX), 32 bits a word
    for name, n, nw in sorted((k, n, nw) for k, v in (band_shapes or {})
                              .items() for n, nw in v):
        if name == "merge_prefix":
            for label, x in (("0/1 flags", ints(0, 2, n)),
                             ("small values", ints(-9, 100, n))):
                x = x.to(torch.int32)
                same(f"merge_prefix n={n} {label} (band merge)",
                     lambda: K.merge_prefix(x), K.merge_prefix_plain(x))
                ncase += 1
        elif name == "radix_sort":
            words = tuple(torch.where(ints(0, 10, n) < 2, INT32_MAX,
                                      ints(0, 2 ** 31 - 1, n))
                          .to(torch.int32) for _ in range(nw))
            same(f"radix_sort n={n} {nw} words (band keys)",
                 lambda: K.radix_sort(words), K.radix_sort_plain(words))
            ncase += 1
    # K3, K4, K5 and K7 on two streams at once, two calls each: every
    # stream has its own tickets and partials, tile counters, epochs and
    # status words
    x = ints(-9, 100, big).to(torch.int32)
    full = ints(-2 ** 31, 2 ** 31, big).to(torch.int32)
    mask = torch.rand(big, generator=gen, device=dev) < 0.03
    vs = tuple(torch.rand(big, generator=gen, device=dev) for _ in range(3))
    names = ("merge_prefix", "radix_sort", "score_count", "score3_count")

    def calls(suffix=""):
        f = {n: getattr(K, n + suffix) for n in names}
        return (f["merge_prefix"](x), f["radix_sort"]((full,)),
                score_bits(f["score_count"], mask, vs[:1]),
                score_bits(f["score3_count"], mask, vs))
    refs = calls("_plain")
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
    for r in range(repeats):
        torch.cuda.synchronize()
        outs = []
        for _ in range(2):
            for s in streams:
                with torch.cuda.stream(s):
                    outs.append(calls())
        torch.cuda.synchronize()
        for got in outs:
            for name, g, ref in zip(names, got, refs):
                if not torch.equal(g, ref):
                    raise RuntimeError(
                        f"[stress] {name} n={big} on two streams at once: "
                        f"run {r + 1} differs from the plain version")
    ncase += 4
    # K2: within its tolerance of the plain version (NaN rows NaN), the
    # same bits in every run
    for n in K2_SIZES:
        for label, vert, met6, ev in _k2_cases(n, gen, dev):
            ref = K.edge_lengths_ani_plain(vert, met6, ev)
            first = K.edge_lengths_ani(vert, met6, ev)
            if not torch.allclose(first, ref, rtol=3e-5, atol=3e-6,
                                  equal_nan=True):
                raise RuntimeError(f"[stress] edge_lengths_ani n={n} {label}"
                                   ": differs from the plain version")
            for r in range(1, repeats):
                if not torch.equal(K.edge_lengths_ani(vert, met6, ev)
                                   .view(torch.int32),
                                   first.view(torch.int32)):
                    raise RuntimeError(f"[stress] edge_lengths_ani n={n} "
                                       f"{label}: run {r + 1} differs")
            ncase += 1
    # K1 on the same rows under an iso size map, and with NaN and +-inf
    # points and sizes: within its tolerance of the plain version (NaN
    # where it is NaN), the same bits in every run
    for n in K2_SIZES:
        for label, vert, _, ev in _k2_cases(n, gen, dev):
            P = vert.shape[0]
            h = 0.05 + torch.rand(P, generator=gen, device=dev)
            cases = [(label, vert, h)]
            if label.startswith("NaN"):
                bad_h = h.clone()
                for x in (float("nan"), float("inf"), float("-inf")):
                    rows = torch.randint(0, P, (max(P // 50, 1),),
                                         generator=gen, device=dev)
                    bad_h[rows] = x
                cases += [(label + ", NaN and +-inf sizes", vert, bad_h),
                          ("NaN and +-inf sizes",
                           vert.nan_to_num(0.5, 0.5, 0.5), bad_h)]
            for lab, v_, h_ in cases:
                ref = K.edge_lengths_iso_plain(v_, h_, ev)
                first = K.edge_lengths_iso(v_, h_, ev)
                if not torch.allclose(first, ref, rtol=2e-5, atol=2e-6,
                                      equal_nan=True) or not torch.equal(
                                          first.isnan(), ref.isnan()):
                    raise RuntimeError(f"[stress] edge_lengths_iso n={n} "
                                       f"{lab}: differs from the plain "
                                       "version")
                for r in range(1, repeats):
                    if not torch.equal(K.edge_lengths_iso(v_, h_, ev)
                                       .view(torch.int32),
                                       first.view(torch.int32)):
                        raise RuntimeError(f"[stress] edge_lengths_iso "
                                           f"n={n} {lab}: run {r + 1} "
                                           "differs")
                ncase += 1
    print(f"[stress] {ncase} K1, K2, K3, K4, K5, K7 and K8 cases x {repeats} "
          f"runs equal to the plain versions "
          f"({time.perf_counter() - t0:.1f} s)")


def _device_events(prof):
    """(device busy seconds, {name: [ms, count]}) of a finished profiler
    run: the kernels, copies and sets on the device, read from its raw
    events (no ``key_averages`` over every event)."""
    from torch.autograd import DeviceType
    busy, by = 0, {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA
                or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        d = e.duration_ns()
        busy += d
        t = by.setdefault(e.name(), [0.0, 0])
        t[0] += d / 1e6
        t[1] += 1
    return busy / 1e9, by


def phase_profile(workdir: str, stem: str):
    """A path once more under torch.profiler recording the device's
    activity only: device busy time against wall time and the kernels that
    take it.  Then the path again with one auto cycle, halfway through the
    run's, recorded with host and device activity: the ops that take its
    device time, and its busy share both as the device's events give it
    and as the sum of every event's self device time over ``key_averages``
    (operators and kernels alike) gives it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from parmmg_tpu_torch import cli
    from parmmg_tpu_torch.ops import active
    args = ["-in", os.path.join(workdir, f"{stem}.mesh"), "-sol",
            os.path.join(workdir, f"{stem}.sol"), "-out",
            os.path.join(workdir, f"{stem}.prof.mesh"), "-niter", "1",
            "-v", "0"]
    real = active.auto_cycle
    cycles = []

    def counted(*a, **k):
        cycles.append(1)
        return real(*a, **k)
    active.auto_cycle = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if cli.main(args) != 0:
                raise RuntimeError("profiled main path failed")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        active.auto_cycle = real
    busy, by = _device_events(prof)
    print(f"[profile] {stem}: wall {wall:.3f} s (profiled, device activity "
          f"only), device busy {busy:.3f} s = {100 * busy / wall:.1f}% of "
          "wall")
    for name, (ms, count) in sorted(by.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile]   {ms:9.2f} ms  x{count:6d}  {name[:90]}")
    # the tensor path's one library call outside any kernel: the
    # eigendecomposition of the metric clamp (cuSOLVER)
    lib = [(n, t) for n, t in by.items() if "syevj" in n]
    if lib:
        print("[profile]   library: " + "; ".join(
            f"{n[:60]} {t[0]:.3f} ms x{t[1]}" for n, t in lib))
    # one auto cycle halfway through, host and device activity
    target, seen, window = max(1, len(cycles) // 2), [], {}

    def sampled(*a, **k):
        seen.append(1)
        if len(seen) != target:
            return real(*a, **k)
        torch.cuda.synchronize()
        t = time.perf_counter()
        p = profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA])
        p.start()
        try:
            out = real(*a, **k)
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - t
        finally:
            p.stop()
        window["prof"] = p
        return out
    active.auto_cycle = sampled
    try:
        if cli.main(args) != 0:
            raise RuntimeError("profiled main path failed")
    finally:
        active.auto_cycle = real
    p, w = window["prof"], window["wall"]
    evs = p.key_averages()

    def dev(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else getattr(e, "self_cuda_time_total", 0)
    summed = sum(dev(e) for e in evs) / 1e6
    wbusy = _device_events(p)[0]
    print(f"[profile] {stem} window: auto cycle {target} of {len(cycles)}, "
          f"wall {w:.3f} s (profiled, host and device activity), device "
          f"busy {wbusy:.3f} s = {100 * wbusy / w:.1f}% of wall by the "
          f"device's events, {summed:.3f} s = {100 * summed / w:.1f}% by "
          "the sum over key_averages")
    for e in sorted(evs, key=dev, reverse=True)[:12]:
        print(f"[profile]   {dev(e) / 1e3:9.2f} ms  x{e.count:6d}  "
              f"{e.key[:90]}")


def _score_fixtures(mesh, et, lens):
    """The K3 and K4 inputs of the kernel phase on an output mesh with its
    unique-edge table ``et`` and edge lengths ``lens``: (the split wave's
    cut: long edges, -lens; the edge-swap cut: edges of at most 3 shell
    tets, their three shell qualities, +inf where a shell slot is empty),
    as (cand, neg, c3, v0, v1, v2)."""
    import torch
    from parmmg_tpu_torch.ops import kernels as K
    cand = (et.emask & (lens > 1.0)).contiguous()
    neg = (-lens).contiguous()
    q = K.tet_quality(mesh.vert, mesh.tet, mesh.tmask)
    sh = et.shell3.clamp(0, mesh.capT - 1).long()
    inf = torch.full((et.ev.shape[0],), float("inf"), device=lens.device)
    v0, v1, v2 = (torch.where(et.shell3[:, k] >= 0, q[sh[:, k]], inf)
                  .contiguous() for k in range(3))
    c3 = (et.emask & (et.nshell <= 3)).contiguous()
    return cand, neg, c3, v0, v1, v2


def _k2_heads(ev, capP: int):
    """0-d int64 tensor: the rows of ``ev`` [n, 2] whose ids, clipped to
    [0, capP), differ from the row before (the first row counts): the rows
    K2 evaluates."""
    c = ev.clamp(0, capP - 1)
    return (c[1:] != c[:-1]).any(dim=1).sum() + int(c.shape[0] > 0)


K2_SIZES = (1, 3, 5, 7, 9, 255, 257, 4097, 2 ** 24 + 3)


def _k2_cases(n: int, gen, dev, npts: int = 100_003):
    """[(label, vert [P, 3], met6 [P, 6], ev [n, 2] int32)] of K2 inputs
    with n rows over P = min(npts, 8 n + 16) points: sorted runs of equal
    rows with an INT32_MAX tail (as ``unique_edges`` gives them), the same
    viewed at a one-row offset (8-byte aligned), ids out of range, a long
    INT32_MAX tail, unsorted ids, NaN and +-inf in point and tensor rows,
    the tensors viewed at a one-float offset (4-byte aligned)."""
    import torch
    from parmmg_tpu_torch.core.constants import INT32_MAX
    P = min(npts, 8 * n + 16)
    vert = torch.rand((P, 3), generator=gen, device=dev)
    r = torch.rand((P, 6), generator=gen, device=dev)
    met6 = torch.stack([1 + r[:, 0], 0.1 * r[:, 1], -0.2 * r[:, 2],
                        2 + r[:, 3], 0.05 * r[:, 4], 0.5 + r[:, 5]], dim=1)

    def runs(m, dead):
        """m rows: runs of ~5 equal pairs, sorted, the last ``dead`` rows
        INT32_MAX"""
        live = m - dead
        key = torch.randint(0, max(live // 5, 1), (live,), generator=gen,
                            device=dev).sort().values
        ab = torch.stack([key * 7919 % P, (key * 104729 + 13) % P], dim=1)
        tail = torch.full((dead, 2), INT32_MAX, device=dev)
        return torch.cat([ab, tail]).to(torch.int32).contiguous()
    sorted_ev = runs(n, 2 * n // 5)
    out = [("sorted runs, INT32_MAX tail", vert, met6, sorted_ev)]
    buf = runs(n + 1, 2 * (n + 1) // 5)
    out.append(("sorted runs viewed at a one-row offset", vert, met6,
                buf[1:]))
    wild = sorted_ev.clone()
    pick = torch.randint(0, 4, wild.shape, generator=gen, device=dev)
    wild = torch.where(pick == 0, -7, torch.where(pick == 1, P + 5, wild))
    out.append(("ids out of range", vert, met6,
                wild.to(torch.int32).contiguous()))
    out.append(("a long INT32_MAX tail", vert, met6, runs(n, n - n // 10)))
    out.append(("unsorted ids", vert, met6, torch.randint(
        -3, P + 3, (n, 2), generator=gen, device=dev, dtype=torch.int32)))
    bad_v, bad_m = vert.clone(), met6.clone()
    for k, x in enumerate((float("nan"), float("inf"), float("-inf"))):
        rows = torch.randint(0, P, (max(P // 50, 1),), generator=gen,
                             device=dev)
        bad_v[rows, k] = x
        rows = torch.randint(0, P, (max(P // 50, 1),), generator=gen,
                             device=dev)
        bad_m[rows, 2 * k] = x
    out.append(("NaN and +-inf in point and tensor rows", bad_v, bad_m,
                sorted_ev))
    flat = torch.empty(6 * P + 1, device=dev)
    flat[1:] = met6.reshape(-1)
    out.append(("tensors viewed at a one-float offset", vert,
                flat[1:].view(P, 6), sorted_ev))
    return out


def phase_kernels(launches, shapes, launches_ani, shapes_ani, workdir: str,
                  band_samples=None, score_samples=None):
    import torch
    from parmmg_tpu_torch.core.constants import INT32_MAX
    from parmmg_tpu_torch.core.mesh import tet_edge_vertices
    from parmmg_tpu_torch.ops import kernels as K
    from parmmg_tpu_torch.ops.adjacency import _face_keys
    from parmmg_tpu_torch.ops.edges import unique_edges, wave_budget

    dev = torch.device("cuda")
    # each path's output mesh at the largest capacities that path reached
    mesh, met, _ = _read_output(os.path.join(workdir, "cube16.o.mesh"),
                                capP=shapes["capP"], capT=shapes["capT"])
    mesh_a, met6, _ = _read_output(os.path.join(workdir, "cube16ani.o.mesh"),
                                   capP=shapes_ani["capP"],
                                   capT=shapes_ani["capT"])
    et = unique_edges(mesh)
    capE, capP, capT = et.ev.shape[0], mesh.capP, mesh.capT
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    K.reset_launches()

    def check(name, got, ref, rtol, atol, exact=False):
        if exact:
            ok = all(torch.equal(g, r) for g, r in zip(got, ref))
            err = max(float((g.float() - r.float()).abs().nan_to_num(0.0)
                            .max()) if g.numel() else 0.0
                      for g, r in zip(got, ref))
        else:
            ok = torch.allclose(got, ref, rtol=rtol, atol=atol)
            err = float((got - ref).abs().max())
        if not ok:
            raise RuntimeError(f"{name}: kernel disagrees with its plain "
                               f"version (max abs err {err})")
        return err

    def row(name, src, line, err, ms, plain_ms, nbytes, nops, fn, kern,
            library=None, shape="", path=launches):
        """``library``: the one PyTorch call computing the same function,
        timed by events and by the profiler (all its device work)."""
        b, by = _bound(nbytes, nops)
        library_ms = None if library is None else _time_ms(library)
        dev_ms, per_call = _device_ms(fn, kern)
        cold_ms = _device_ms(fn, kern, cold=True)[0]
        lib_dev = None if library is None else _device_ms(library, None)[0]
        r = {"name": name, "route": "cuda",
             "source": f"parmmg_tpu_torch/csrc/{src}",
             "replaces": f"parmmg_tpu/ops/pallas_kernels.py:{line}",
             "launches": int(path[name]), "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
             "bound_by": by, "library_ms": library_ms,
             "device_ms": dev_ms, "device_ms_cold": cold_ms,
             "device_launches_per_call": per_call,
             "library_device_ms": lib_dev}
        lib = ("-" if library_ms is None else
               f"{library_ms:.4f} (device {lib_dev})")
        which = "aniso" if path is launches_ani else "main"
        print(f"[kernel] {name}{shape}: max_abs_err {err:.3g} ms {ms:.4f} "
              f"(device {dev_ms}, cold {cold_ms}, {per_call:g} device "
              f"launches a call) plain {plain_ms:.4f} bound {b:.4f} ({by}) "
              f"library {lib} {which}-path launches {path[name]}")
        return r

    def sub(r, *extra):
        """A further shape of a kernel's row, for its row's JSON."""
        return {k: r[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "device_ms_cold",
            "device_launches_per_call", "library_device_ms") + extra}

    def launches_per_call(r, want, what):
        got = r["device_launches_per_call"]
        print(f"[launches] {what}: {got:g} CUDA launches a call "
              f"(profiler, 20 calls), expected {want}")
        if got != want:
            raise RuntimeError(f"{what}: {got} launches a call, not {want}")

    # K1 edge length, over the unique-edge table of the output mesh
    ev = et.ev.contiguous()
    got = K.edge_lengths_iso(mesh.vert, met, ev)
    ref = K.edge_lengths_iso_plain(mesh.vert, met, ev)
    fin = et.emask
    err = check("edge_lengths_iso", got[fin], ref[fin], 2e-5, 2e-6)
    rows.append(row("edge_lengths_iso", "edge_length_iso.cu", 134, err,
        _time_ms(lambda: K.edge_lengths_iso(mesh.vert, met, ev)),
        _time_ms(lambda: K.edge_lengths_iso_plain(mesh.vert, met, ev)),
        16 * capP + 12 * capE, 20 * capE,
        lambda: K.edge_lengths_iso(mesh.vert, met, ev), "edge_length_iso"))

    # K2 edge length, over the unique-edge table of the aniso output mesh
    # under the aniso path's own metric (read back from its .sol)
    et_a = unique_edges(mesh_a, shell_slots=0)
    ev_a = et_a.ev.contiguous()
    capE_a, capP_a = ev_a.shape[0], mesh_a.capP
    got_a = K.edge_lengths_ani(mesh_a.vert, met6, ev_a)
    ref_a = K.edge_lengths_ani_plain(mesh_a.vert, met6, ev_a)
    err = check("edge_lengths_ani", got_a, ref_a, 3e-5, 3e-6)
    heads = int(_k2_heads(ev_a, capP_a))
    rows.append(row("edge_lengths_ani", "edge_length_ani.cu", 176, err,
        _time_ms(lambda: K.edge_lengths_ani(mesh_a.vert, met6, ev_a)),
        _time_ms(lambda: K.edge_lengths_ani_plain(mesh_a.vert, met6, ev_a)),
        36 * capP_a + 12 * capE_a, 45 * capE_a,
        lambda: K.edge_lengths_ani(mesh_a.vert, met6, ev_a),
        "edge_length_ani", path=launches_ani,
        shape=f" [capE {capE_a}, {heads} heads, {int(et_a.emask.sum())} "
        "unique edges]"))
    rows[-1]["head_share"] = heads / max(capE_a, 1)
    print(f"[kernel] edge_lengths_ani head share {rows[-1]['head_share']:.4f}"
          f" (rows it evaluates)")
    launches_per_call(rows[-1], 1, "edge_lengths_ani")

    # K3 score + count: the split wave's cut (long edges, -lens)
    cand, neg, c3, v0, v1, v2 = _score_fixtures(mesh, et, got)
    g = K.score_count(cand, neg)
    r = K.score_count_plain(cand, neg)
    err = check("score_count", g, r, 0, 0, exact=True)
    # the bytes the function needs: the mask, the output, the count and
    # the values of the selected edges only (a masked-out value never
    # reaches the output)
    nsel = int(cand.sum())
    rows.append(row("score_count", "score_count.cu", 231, err,
        _time_ms(lambda: K.score_count(cand, neg)),
        _time_ms(lambda: K.score_count_plain(cand, neg)),
        5 * capE + 4 + 4 * nsel, 2 * capE,
        lambda: K.score_count(cand, neg), "score_kernel",
        shape=f" [capE {capE}, {nsel} selected]"))
    launches_per_call(rows[-1], 1, "score_count")

    # K4 score3 + count: the edge-swap cut over three shell qualities
    g = K.score3_count(c3, v0, v1, v2)
    r = K.score3_count_plain(c3, v0, v1, v2)
    err = check("score3_count", g, r, 0, 0, exact=True)
    nsel3 = int(c3.sum())
    rows.append(row("score3_count", "score_count.cu", 253, err,
        _time_ms(lambda: K.score3_count(c3, v0, v1, v2)),
        _time_ms(lambda: K.score3_count_plain(c3, v0, v1, v2)),
        5 * capE + 4 + 12 * nsel3, 4 * capE,
        lambda: K.score3_count(c3, v0, v1, v2), "score_kernel",
        shape=f" [capE {capE}, {nsel3} selected]"))
    launches_per_call(rows[-1], 1, "score3_count")
    # K3 and K4 on the densest call the iso and tensor paths gave them
    # (phase_path's record, its inputs captured in the reruns)
    for name in ("score_count", "score3_count"):
        cands = [(sel / max(n, 1), n, stem, ins, sel)
                 for stem, cap in (score_samples or {}).items()
                 if name in cap
                 for ins, n, sel in [cap[name]["densest"]]]
        if not cands:
            continue
        share, n, stem, ins, sel = max(cands, key=lambda c: c[:2])
        fn = getattr(K, name)
        plain = getattr(K, name + "_plain")
        g, ref = fn(*ins), plain(*ins)
        if int(g[1]) != sel:
            raise RuntimeError(f"{name}: the captured call counts {int(g[1])}"
                               f", the path's {sel}")
        err = check(name, g, ref, 0, 0, exact=True)
        k4 = name == "score3_count"
        d = row(name, "score_count.cu", 253 if k4 else 231, err,
                _time_ms(lambda: fn(*ins)), _time_ms(lambda: plain(*ins)),
                5 * n + 4 + (12 if k4 else 4) * sel, (4 if k4 else 2) * n,
                lambda: fn(*ins), "score_kernel",
                shape=f" [densest call of {stem}: {n} rows, {sel} selected, "
                      f"share {share:.4f}]")
        d["path"], d["rows"], d["selected"] = stem, n, sel
        next(r for r in rows if r["name"] == name)["densest"] = sub(
            d, "path", "rows", "selected")

    # K6 tet quality: iso (the main path's mode) and the tensor mode on
    # the aniso path's output and metric
    tv, tm = mesh.tet, mesh.tmask
    got = K.tet_quality(mesh.vert, tv, tm)
    ref = K.tet_quality_plain(mesh.vert, tv, tm)
    err = check("tet_quality", got, ref, 3e-5, 3e-6)
    rows.append(row("tet_quality", "tet_quality.cu", 379, err,
        _time_ms(lambda: K.tet_quality(mesh.vert, tv, tm)),
        _time_ms(lambda: K.tet_quality_plain(mesh.vert, tv, tm)),
        12 * capP + 21 * capT, 70 * capT,
        lambda: K.tet_quality(mesh.vert, tv, tm), "tet_quality_kernel"))
    launches_per_call(rows[-1], 1, "tet_quality iso")
    va, tva, tma = mesh_a.vert, mesh_a.tet, mesh_a.tmask
    capT_a = mesh_a.capT
    got = K.tet_quality(va, tva, tma, met6)
    ref = K.tet_quality_plain(va, tva, tma, met6)
    err_a = check("tet_quality aniso", got, ref, 1e-4, 1e-5)
    k6a = row("tet_quality", "tet_quality.cu", 379, err_a,
              _time_ms(lambda: K.tet_quality(va, tva, tma, met6)),
              _time_ms(lambda: K.tet_quality_plain(va, tva, tma, met6)),
              36 * capP_a + 21 * capT_a, 160 * capT_a,
              lambda: K.tet_quality(va, tva, tma, met6),
              "tet_quality_kernel", shape=f" tensor mode [capT {capT_a}]",
              path=launches_ani)
    launches_per_call(k6a, 1, "tet_quality tensor mode")
    rows[-1]["tensor_mode"] = sub(k6a, "launches")
    # K7 radix sort: the packed edge keys [6*capT] (1 word, 4 passes) and
    # the packed face keys [4*capT] (nbits (16, 32), 6 passes), as the
    # sort sites build them; exact against the plain stable-sort chain.
    # Library: torch.sort(stable=True) of the edge keys, and of the face
    # keys packed into one int64 (remapped f0 << 32 | fw as uint32), which
    # gives the same permutation
    ev6 = tet_edge_vertices(mesh.tet).reshape(-1, 2)
    ekey = torch.where(mesh.tmask.repeat_interleave(6),
                       ev6.min(1).values * capP + ev6.max(1).values,
                       INT32_MAX).to(torch.int32)
    cols = _face_keys(mesh)
    f0 = cols[:, 0].contiguous()
    fw = torch.where(f0 == INT32_MAX, INT32_MAX,
                     cols[:, 1] * capP + cols[:, 2]).to(torch.int32)
    n6, n4 = ekey.shape[0], f0.shape[0]
    fnb = (16, 32)
    npass_e, npass_f = K._radix_passes((32,)), K._radix_passes(fnb)
    order = K.radix_sort((ekey,))
    err = check("radix_sort", [order], [K.radix_sort_plain((ekey,))], 0, 0,
                exact=True)
    rows.append(row(
        "radix_sort", "radix_sort.cu", 434, err,
        _time_ms(lambda: K.radix_sort((ekey,))),
        _time_ms(lambda: K.radix_sort_plain((ekey,))), 8 * n6, 0,
        lambda: K.radix_sort((ekey,)), "radix_",
        library=lambda: torch.sort(ekey, stable=True),
        shape=f" [edge keys {n6}, {npass_e} passes]"))
    launches_per_call(rows[-1], 1 + npass_e, "radix_sort edge keys")
    forder = K.radix_sort((f0, fw), fnb)
    err = check("radix_sort faces", [forder],
                [K.radix_sort_plain((f0, fw), fnb)], 0, 0, exact=True)
    packed = (torch.where(f0 == INT32_MAX, (1 << fnb[0]) - 1, f0).long()
              << 32) | (fw.long() & 0xFFFFFFFF)
    if not torch.equal(torch.sort(packed, stable=True).indices.int(),
                       forder):
        raise RuntimeError("torch.sort of the packed face keys gives "
                           "another permutation than K7")
    face = row("radix_sort", "radix_sort.cu", 434, err,
               _time_ms(lambda: K.radix_sort((f0, fw), fnb)),
               _time_ms(lambda: K.radix_sort_plain((f0, fw), fnb)),
               12 * n4, 0, lambda: K.radix_sort((f0, fw), fnb), "radix_",
               library=lambda: torch.sort(packed, stable=True),
               shape=f" [face keys {n4}, nbits (16, 32), {npass_f} passes]")
    launches_per_call(face, 1 + npass_f, "radix_sort face keys")
    rows[-1]["face_keys"] = sub(face)
    # K7 on the [grouped] run's first edge band: the band's packed keys
    # and its slot word, 2 words of 32 bits (8 passes), as the band merge
    # sorts them.  Library: torch.sort of the pair packed into one int64
    # (both words non-negative), which gives the same permutation
    if band_samples and "radix_sort" in band_samples:
        bw = tuple(w.contiguous() for w in band_samples["radix_sort"])
        nb = bw[0].shape[0]
        npass_b = K._radix_passes((32, 32))
        border = K.radix_sort(bw)
        err = check("radix_sort band", [border], [K.radix_sort_plain(bw)],
                    0, 0, exact=True)
        bpacked = (bw[0].long() << 32) | bw[1].long()
        if not torch.equal(torch.sort(bpacked, stable=True).indices.int(),
                           border):
            raise RuntimeError("torch.sort of the packed band keys gives "
                               "another permutation than K7")
        band = row("radix_sort", "radix_sort.cu", 434, err,
                   _time_ms(lambda: K.radix_sort(bw)),
                   _time_ms(lambda: K.radix_sort_plain(bw)), 12 * nb, 0,
                   lambda: K.radix_sort(bw), "radix_",
                   library=lambda: torch.sort(bpacked, stable=True),
                   shape=f" [band keys + slots {nb}, {npass_b} passes]")
        launches_per_call(band, 1 + npass_b, "radix_sort band keys")
        rows[-1]["band_keys"] = sub(band)

    # K5 prefix sum: the flags of fixed_order_sum's groups at its most
    # common shape (tet corners -> vertices, [4*capT]: the main path's one
    # caller of K5), and, as in earlier runs, one digit histogram
    # (digit-major, block-minor over 2,048-row blocks) and a [6*capT] flag
    # vector
    from parmmg_tpu_torch.ops.primitives import _SUM_WIDTH
    idx4 = torch.where(mesh.tmask[:, None], mesh.tet, capP).T.reshape(-1)
    k4 = idx4.to(torch.int32).contiguous()
    k4 = k4[K.radix_sort((k4,), (capP.bit_length(),)).long()]
    rank4 = (torch.arange(k4.shape[0], dtype=torch.int32, device=dev)
             - torch.searchsorted(k4, k4, out_int32=True))
    start4 = (rank4 % _SUM_WIDTH == 0).to(torch.int32)
    nb = -(-n6 // 2048)
    digit = (ekey.long() & 0xFF) * nb + torch.arange(n6, device=dev) // 2048
    hist = torch.bincount(digit, minlength=256 * nb).to(torch.int32)
    ks = ekey[order.long()]
    flags = K.segment_flags_plain((ks,)).to(torch.int32)
    for label, x in ((f"fixed_order_sum start flags [4*capT {4 * capT}]",
                      start4),
                     (f"histogram {hist.shape[0]}", hist),
                     (f"flags {n6}", flags)):
        e = check("merge_prefix", [K.merge_prefix(x)],
                  [K.merge_prefix_plain(x)], 0, 0, exact=True)
        nx = x.shape[0]
        r = row("merge_prefix", "merge_prefix.cu", 358, e,
                _time_ms(lambda: K.merge_prefix(x)),
                _time_ms(lambda: K.merge_prefix_plain(x)), 8 * nx, nx,
                lambda: K.merge_prefix(x), "prefix_",
                library=lambda: torch.cumsum(x, 0, dtype=torch.int32),
                shape=f" [{label}]")
        launches_per_call(r, 1, f"merge_prefix [{label}]")
        if x is start4:
            rows.append(r)
        else:
            rows[-1]["histogram" if x is hist else "flags_6capT"] = sub(r)
    # K5 on the [grouped] run's first band merge: the survivor flags of the
    # retained edge sort [6 capT of a group]
    if band_samples and "merge_prefix" in band_samples:
        x = band_samples["merge_prefix"].contiguous()
        nx = x.shape[0]
        e = check("merge_prefix", [K.merge_prefix(x)],
                  [K.merge_prefix_plain(x)], 0, 0, exact=True)
        r = row("merge_prefix", "merge_prefix.cu", 358, e,
                _time_ms(lambda: K.merge_prefix(x)),
                _time_ms(lambda: K.merge_prefix_plain(x)), 8 * nx, nx,
                lambda: K.merge_prefix(x), "prefix_",
                library=lambda: torch.cumsum(x, 0, dtype=torch.int32),
                shape=f" [band merge survivor flags {nx}]")
        launches_per_call(r, 1, f"merge_prefix [band merge {nx}]")
        rows[-1]["band_merge_flags"] = sub(r)

    # K8 segment flags (no single library call): sorted mode over the
    # sorted edge keys [6*capT] and face keys (f0, fw) [4*capT]; gathered
    # mode, as the sort sites call it, from the unsorted keys and K7's
    # permutation, with the pair it replaced beside it as its yardstick
    # (PyTorch's gather of each key word by the int64 permutation, then
    # sorted-mode K8: not a library call)
    k8 = {}
    for label, words, p32 in ((f"edge keys {n6}", (ekey,), order),
                              (f"face keys (f0, fw) {n4}", (f0, fw), forder)):
        perm = p32.long()
        srt = tuple(w[perm] for w in words)
        nw = len(words)
        err = check("segment_flags", [K.segment_flags(srt)],
                    [K.segment_flags_plain(srt)], 0, 0, exact=True)
        r = row("segment_flags", "segment_flags.cu", 520, err,
                _time_ms(lambda: K.segment_flags(srt)),
                _time_ms(lambda: K.segment_flags_plain(srt)),
                (4 * nw + 1) * srt[0].shape[0], nw * srt[0].shape[0],
                lambda: K.segment_flags(srt), "segment_flags_kernel",
                shape=f" [sorted {label}]")
        launches_per_call(r, 1, f"segment_flags sorted {label}")
        k8["sorted", nw] = r
        got = K.segment_flags(words, order=p32)
        ref = K.segment_flags_plain(words, order=p32)
        err = check("segment_flags gathered", [got[1], *got[0]],
                    [ref[1], *ref[0]], 0, 0, exact=True)
        n = words[0].shape[0]
        r = row("segment_flags", "segment_flags.cu", 520, err,
                _time_ms(lambda: K.segment_flags(words, order=p32)),
                _time_ms(lambda: K.segment_flags_plain(words, order=p32)),
                (4 + 8 * nw + 1) * n, nw * n,
                lambda: K.segment_flags(words, order=p32),
                "segment_flags_kernel", shape=f" [gathered {label}]")
        launches_per_call(r, 1, f"segment_flags gathered {label}")

        def pair():
            return K.segment_flags(tuple(w[perm] for w in words))
        r["unfused_pair_ms"] = _time_ms(pair)
        r["unfused_pair_device_ms"], nl = _device_ms(pair, None)
        print(f"[kernel] segment_flags [gathered {label}] yardstick, the "
              f"unfused pair (gather by the int64 permutation, then sorted "
              f"K8): ms {r['unfused_pair_ms']:.4f} device "
              f"{r['unfused_pair_device_ms']} ({nl:g} device launches a "
              f"call)")
        k8["gathered", nw] = r
    rows.append(k8["sorted", 1])
    rows[-1]["face_keys"] = sub(k8["sorted", 2])
    for nw, key in ((1, "gathered_edge_keys"), (2, "gathered_face_keys")):
        rows[-1][key] = sub(k8["gathered", nw], "unfused_pair_ms",
                            "unfused_pair_device_ms")
    # the fixed-order float sum at smooth_wave's most common shape (tet
    # corners -> vertices, masked corners to the sentinel row capP; 4 and
    # 1 columns) against scatter_reduce's atomics and against PyTorch's
    # deterministic scatter_reduce, also without the sentinel row's values
    # (timing only: the port calls neither)
    from parmmg_tpu_torch.ops.primitives import fixed_order_sum
    idx4 = idx4.long()
    live4 = idx4 < capP
    pay4 = torch.rand((4 * capT, 4), generator=gen, device=dev)
    acc0 = torch.zeros((capP + 1, 4), device=dev)

    def scatter_sum(dst, ix, vals, deterministic):
        if dst.dim() > 1:
            ix = ix[:, None].expand_as(vals)
        torch.use_deterministic_algorithms(deterministic)
        try:
            return dst.scatter_reduce(0, ix, vals, "sum")
        finally:
            torch.use_deterministic_algorithms(False)

    def bits(x):
        return x.view(torch.int32)
    for cols in (4, 1):
        p, a0 = pay4[:, :cols].squeeze(1), acc0[:, :cols].squeeze(1)
        p_live, ix_live = p[live4], idx4[live4]
        fns = {
            "fixed_order_sum": lambda: fixed_order_sum(a0, idx4, p),
            "deterministic scatter_reduce":
                lambda: scatter_sum(a0, idx4, p, True),
            "deterministic scatter_reduce without the sentinel row":
                lambda: scatter_sum(a0, ix_live, p_live, True),
            "scatter_reduce atomics": lambda: scatter_sum(a0, idx4, p, False),
        }
        ref = fns["scatter_reduce atomics"]()[:capP]
        parts = []
        for name, fn in fns.items():
            out = fn()
            rel = float(((out[:capP] - ref).abs()
                         / ref.abs().clamp(min=1e-30)).max())
            same = all(torch.equal(bits(out), bits(fn())) for _ in range(10))
            parts.append(f"{name} ms {_time_ms(fn):.4f} (max rel diff to "
                         f"atomics {rel:.3g}, same bits on 10 calls {same})")
        print(f"[sum] [{4 * capT} x {cols} -> {capP + 1}, "
              f"{int((~live4).sum())} to the sentinel row]: "
              + "; ".join(parts))
    order_k = ("edge_lengths_iso", "edge_lengths_ani", "score_count",
               "score3_count", "merge_prefix", "tet_quality", "radix_sort",
               "segment_flags")
    rows.sort(key=lambda r: order_k.index(r["name"]))
    print(f"[kernel] shapes capP {capP} capT {capT} capE {capE} "
          f"(wave budget K {wave_budget(capT)}); aniso capP {capP_a} capT "
          f"{capT_a} capE {capE_a}")
    return rows


def main(argv=()) -> int:
    sys.path.insert(0, HERE)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "parmmg_tpu_torch")):
        print("chip_smoke: parmmg_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    workdir = os.path.join(HERE, "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    if list(argv) in (["--serve"], ["--chaos"], ["--dist"],
                      ["--multihost"]):
        phase = {"--serve": phase_serve, "--chaos": phase_chaos,
                 "--dist": phase_dist,
                 "--multihost": phase_multihost}[argv[0]]
        try:
            phase_build()
            launches = phase(workdir)
        except Exception:
            traceback.print_exc()
            print("chip_smoke: FAILED", file=sys.stderr)
            return 1
        print(json.dumps({f"{argv[0][2:]}_launches": launches}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if len(argv) == 2 and argv[0] == "--pairs":
        try:
            phase_build()
            pairs = phase_pairs(workdir, int(argv[1]))
        except Exception:
            traceback.print_exc()
            print("chip_smoke: FAILED", file=sys.stderr)
            return 1
        print(json.dumps({"pairs": pairs}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    walls = {}

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        walls[name] = round(time.perf_counter() - t0, 3)
        return out
    try:
        timed("build", phase_build)
        launches, shapes = timed("main", phase_path, workdir, "cube16")
        score_samples = {"cube16": timed("repeat", phase_repeat, workdir,
                                         shapes=shapes)}
        launches_ani, shapes_ani = timed("aniso", phase_path, workdir,
                                         "cube16ani")
        score_samples["cube16ani"] = timed(
            "aniso_repeat", phase_aniso_repeat, workdir, shapes=shapes_ani)
        launches_field = timed("field", phase_field, workdir)
        launches_grouped, band_samples, band_shapes = timed(
            "grouped", phase_grouped, workdir)
        launches_dist = timed("dist", phase_dist, workdir)
        launches_mh = timed("multihost", phase_multihost, workdir)
        launches_chaos = timed(
            "chaos", phase_chaos, workdir,
            base=os.path.join(workdir, "cube32.o.mesh"))
        launches_serve = timed("serve", phase_serve, workdir)
        rows = timed("kernels", phase_kernels, launches, shapes,
                     launches_ani, shapes_ani, workdir, band_samples,
                     score_samples)
        timed("stress", phase_stress, band_shapes=band_shapes)
        timed("profile", phase_profile, workdir, "cube16")
        timed("profile_ani", phase_profile, workdir, "cube16ani")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    for r in rows:
        r["field_launches"] = int(launches_field[r["name"]])
        r["grouped_launches"] = int(launches_grouped[r["name"]])
        r["serve_launches"] = int(launches_serve[r["name"]])
        r["chaos_launches"] = int(launches_chaos[r["name"]])
        r["dist_launches"] = int(launches_dist[r["name"]])
        r["multihost_launches"] = [int(v) for v in launches_mh[r["name"]]]
    print(f"[walls] seconds a phase {walls}, "
          f"{sum(walls.values()):.3f} in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
