"""Two-level decomposition: sub-device remesh groups (port of
``parallel/groups.py``).

The reference splits each rank's mesh into ``-mesh-size``-element groups
and remeshes them one at a time (``PMMG_splitPart_grps`` /
``howManyGroups``, grpsplit_pmmg.c:47,1551-1614, capped at
``PMMG_REMESHER_NGRPS_MAX``); the group is the unit that bounds the
remesher's working set.  Group interfaces are frozen exactly like rank
interfaces (MG_PARBDY — the ``split_to_shards`` freeze contract,
tag_pmmg.c:39-124) and displaced between outer iterations
(``partition.move_interfaces``), so previously frozen seams get remeshed
by a later pass: the two-level loop of the reference.

The JAX package keeps the groups as slots of a stacked pytree and runs
one compiled cycle program per slot with ``lax.map``.  The port keeps the
same stacked layout (:class:`~parmmg_tpu_torch.core.mesh.MeshStack`, a
leading group axis) and runs the same body slot after slot in a Python
loop; nothing is batched across groups, so the device holds one group's
working set at a time, as under ``lax.map``.  The quiet mask and the
smoothing cadence, ``lax.cond``s there, are host branches here.

Chunked dispatch (``group_chunk``) keeps the pass state on the host
between dispatches and uploads the active groups of each chunk plan
(``parallel/sched.py``).  The port chunks only when the stacked state
would not fit the card beside a group's working set; chunked and
unchunked runs write the same bytes.  The smoothing cadence and the
quiet-group scheduler with its per-slot mask are always on (the JAX
package's defaults).

The resilience layer (``resilience/``) is the JAX package's: a failed
chunk dispatch is re-run from the intact host state under ``retry_call``
(ladder rung ``retry``; exhaustion raises ``RetryBudgetExhausted``, the
driver's ``PMMG_LOWFAILURE``), each dispatch bounded by the
``PMTORCH_DEADLINE_DISPATCH_S`` watchdog; ``polish=True`` (the CLI's
``-group-polish``) polishes the groups before each merge, a chunked
pass's in a fresh process under ``PMTORCH_POLISH_SUBPROC``
(``_polish_worker.py``); ``grouped_adapt``
checkpoints every pass under ``PMTORCH_CKPT_DIR``, resumes from the
newest (``resume=True``) behind the crash-loop breaker, and opens the
``PMTORCH_PROFILE_*`` profiler window.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..api import knobs
from ..core import constants as C
from ..core.mesh import MESH_FIELDS, MeshStack
from ..obs import trace as otrace
from ..ops.topo_incr import TopoState, topo_init
from ..resilience.watchdog import progress


def _log(level: int, msg: str, verbose: int) -> None:
    if verbose >= level:
        print(msg)


def how_many_groups(ne: int, target: int) -> int:
    """Group count with the reference's clamps (grpsplit_pmmg.c:47)."""
    if target <= 0:
        return 1
    return max(1, min((ne + target - 1) // target, C.REMESHER_NGRPS_MAX))


# the stacked state may take this share of the card's memory before the
# pass chunks it: the rest holds one group's cycle working set (sorts and
# candidate tables several times a group's state) and the allocator's cache
STACK_SHARE = 0.25


def group_chunk(ngroups: int, group_bytes: int, device_bytes: int | None,
                chunk: int | None = None) -> int:
    """Groups per dispatch (0 = all groups in one dispatch, the state
    resident on the device).

    ``device_bytes`` is the device's memory (None on the CPU, which never
    chunks).  The pass chunks only when ``ngroups`` slots of
    ``group_bytes`` take more than ``STACK_SHARE`` of it, and then takes
    as many groups a dispatch as fit in that share (at least one).  The
    JAX package's fixed 8 on its accelerator is a rule of the TPU's HBM;
    on the card a grouped run at the reference CI's sizes is a few hundred
    MB.  ``chunk`` overrides the rule.  Returns 0 when the chunk would
    cover every group anyway."""
    if chunk is not None:
        c = max(0, int(chunk))
    elif device_bytes is None or ngroups * group_bytes <= \
            STACK_SHARE * device_bytes:
        c = 0
    else:
        c = max(1, int(STACK_SHARE * device_bytes) // max(1, group_bytes))
    return 0 if c >= ngroups else c


def block_schedule(c0: int, nblk: int, cycles: int, noswap: bool):
    """(flags, pres) for the cycle block starting at global cycle ``c0``:
    swap every 3rd cycle plus the final two cycles, which also run with
    the split's prescreen off (exact veto).  Shared with the serving pool
    of the JAX package."""
    flags = tuple((cc % 3 == 2 or cc >= cycles - 2) and not noswap
                  for cc in range(c0, c0 + nblk))
    pres = tuple(cc < cycles - 2 for cc in range(c0, c0 + nblk))
    return flags, pres


def block_converged(cs: np.ndarray, flags: tuple, noswap: bool) -> bool:
    """The grouped loop's early-exit rule on a block's summed counts
    ``cs`` [nblk, >=3] (host numpy): any swap-inclusive cycle posting
    zero split+collapse+swap ends the sizing loop."""
    return any((flags[i] or noswap) and
               int(cs[i][0]) + int(cs[i][1]) + int(cs[i][2]) == 0
               for i in range(len(flags)))


def _topo_map(fn, topo: TopoState) -> TopoState:
    return TopoState(*[fn(x) for x in topo])


def _group_block(flags: tuple, pres: tuple, nomove: bool, noinsert: bool,
                 hausd):
    """The fused cycle block over the group axis: ``run(stacked, met_s,
    wave, active, incr, topo)`` runs ``len(flags)`` cycles of
    ``adapt_cycle_impl`` on each slot of the MeshStack, one slot after
    another, and returns (stacked, met_s, counts [n, nblk, 9], topo).

    ``active`` [n] bool host mask (``parallel/sched.py``): a masked slot
    (quiet group of an unchunked dispatch, repeat-padded tail row of a
    chunk plan) returns its state unchanged with zero counts.
    The smoothing cadence: a cycle following a full no-op cycle of its
    slot skips smoothing when its own topology counts are
    zero (``adapt_cycle_impl(smooth_idle=)``); the idle carry is read
    from each cycle's counts (one host read a cycle but the block's
    last).  ``incr`` / ``topo``: the incremental topology engine's
    switch and per-slot state (``ops/topo_incr``), threaded whether or
    not ``incr`` is on."""
    from ..ops.adapt import adapt_cycle_impl
    nblk = len(flags)

    def run(stacked: MeshStack, met_s, wave: int, active, incr: bool,
            topo: TopoState):
        # every completed cycle reports progress to a dispatch watchdog
        # (PMTORCH_DEADLINE_DISPATCH_S; free without one)
        meshes, mets, tps, counts = [], [], [], []
        for g in range(stacked.ngroups):
            m, k = stacked.slot(g), met_s[g]
            tp = _topo_map(lambda x: x[g], topo)
            act = bool(active[g])
            rows = []
            idle = False
            for cc, dosw in enumerate(flags):
                with otrace.scope(f"grp_cycle{cc}"):
                    m, k, cnt, tp = adapt_cycle_impl(
                        m, k, wave + cc, do_swap=dosw,
                        do_smooth=not nomove, do_insert=not noinsert,
                        hausd=hausd, final_rebuild=(cc == nblk - 1),
                        prescreen=pres[cc], active=act, smooth_idle=idle,
                        topo=tp, incr=incr)
                progress()
                rows.append(cnt)
                if act and cc + 1 < nblk:
                    s, c, w, mv = cnt[:4].tolist()
                    idle = s + c + w == 0 and mv == 0
            meshes.append(m)
            mets.append(k)
            tps.append(tp)
            counts.append(torch.stack(rows))
        out_topo = TopoState(*[torch.stack(xs) for xs in zip(*tps)])
        return (MeshStack.stack(meshes), torch.stack(mets),
                torch.stack(counts), out_topo)

    return run


def _group_polish_block(noinsert: bool, noswap: bool, nomove: bool,
                        hausd):
    """The grouped sliver polish over the group axis: ``run(stacked,
    met_s, wave, active)`` runs ``sliver_polish_impl`` on each active slot
    of the MeshStack, one slot after another, and returns (stacked, met_s,
    counts [n, 4]); an inactive slot (a retired group of the wave-major
    polish, a padded tail row of a chunk plan) keeps its state with counts
    [0, 0, 0, live tets].  The ledger's ``groups.polish_block``."""
    from ..ops.adapt import sliver_polish_impl
    from ..utils.compilecache import governed

    @governed("groups.polish_block", budget=4)
    def run(stacked: MeshStack, met_s, wave: int, active):
        meshes, counts = [], []
        for g in range(stacked.ngroups):
            m = stacked.slot(g)
            if bool(active[g]):
                m, cnt = sliver_polish_impl(
                    m, met_s[g], wave, do_collapse=not noinsert,
                    do_swap=not noswap, do_smooth=not nomove, hausd=hausd)
            else:
                cnt = torch.stack([torch.zeros((), dtype=torch.int32,
                                               device=m.tet.device)] * 3
                                  + [m.tmask.sum(dtype=torch.int32)])
            progress()
            meshes.append(m)
            counts.append(cnt)
        return MeshStack.stack(meshes), met_s, torch.stack(counts)

    return run


def _pad_groups(x, g_new: int):
    """Pad a stacked state's (MeshStack, TopoState or tensor) leading
    group axis to ``g_new`` with dead groups (all zeros: masks False,
    counts 0 — every wave is a no-op on a fully dead mesh)."""
    def pad(a):
        g = a.shape[0]
        if g >= g_new:
            return a
        return torch.cat([a, torch.zeros((g_new - g,) + tuple(a.shape[1:]),
                                         dtype=a.dtype, device=a.device)])
    if isinstance(x, MeshStack):
        return x.map(pad)
    if isinstance(x, TopoState):
        return _topo_map(pad, x)
    return pad(x)


# side streams of the guarded dispatch attempts, per device, reused by
# every dispatch: an attempt takes the first one no live attempt holds and
# a new one only while an abandoned attempt still runs on every other
# (the caching allocator keeps a cache a stream, K5/K7 scratch a stream)
_SIDE_STREAMS: dict = {}
_BUSY_STREAMS: set = set()
_STREAM_LOCK = threading.Lock()


def _claim_stream(device):
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    with _STREAM_LOCK:
        pool = _SIDE_STREAMS.setdefault(dev, [])
        s = next((s for s in pool if s.cuda_stream not in _BUSY_STREAMS),
                 None)
        if s is None:
            s = torch.cuda.Stream(dev)
            pool.append(s)
        _BUSY_STREAMS.add(s.cuda_stream)
    return s


def _release_stream(s) -> None:
    with _STREAM_LOCK:
        _BUSY_STREAMS.discard(s.cuda_stream)


def _pipeline_chunks(fn, stacked: MeshStack, met_s, wave: int, plans, tim,
                     device, incr: bool = False,
                     topo: TopoState | None = None,
                     done: dict | None = None):
    """Chunked dispatch over gathered group-index slices of the
    host-resident state.

    ``plans``: [(idx_exec [chunk], nreal)] from the quiet-group scheduler
    (``parallel/sched.py``).  Each plan's rows of the mesh, metric and (with
    ``topo``) topology state are gathered on the host and uploaded to
    ``device`` (``upload``), run through ``fn`` there (``compute``: the
    call, then a wait for the card), downloaded (``download``) and written
    back to the host state (``writeback``): only the first ``nreal`` rows,
    the repeat-padded tail rows being masked off by ``pad_mask`` and never
    written.  With ``topo``, ``fn(slice, met, wave, mask, incr, topo)``
    is a cycle block (:func:`_group_block`); without, ``fn(slice, met,
    wave, mask)`` is the polish block, which takes and returns no
    topology state.  Each chunk is written
    back before the next one is gathered, so the device holds one chunk
    at a time.  ``tim`` (``utils.timers.Timers``) records the four
    segments.  Returns the per-plan host count arrays (trimmed to nreal),
    in plan order.

    Fault tolerance: the host state changes only in a plan's writeback,
    its last step, so a plan whose dispatch fails (a failed launch;
    injectable as ``dispatch.chunk``) left its rows intact, and is re-run
    from them under ``retry_call``: the result is the same bytes.
    Exhaustion raises ``RetryBudgetExhausted``.  ``done`` (a dict)
    records each plan's counts under its index once its writeback ran: a
    caller catching a failure can tell which plans already advanced their
    rows (the serve pool's fault isolation retries only the others).

    Watchdog (``PMTORCH_DEADLINE_DISPATCH_S`` > 0): each attempt runs in a
    monitor thread and expires when no progress comes for that long (the
    upload, every cycle or polished slot, the download); the expiry is a
    ``WatchdogTimeout`` retried like a fault.  The abandoned attempt stops
    at its next progress report (``watchdog.Abandoned``); until then it
    runs on beside the retry, so a guarded attempt on the card runs on a
    side stream no live attempt holds (:func:`_claim_stream`: the first
    of the device's pool, another only while an abandoned attempt still
    runs; K5 and K7 keep scratch a stream, ``ops/kernels.py``), with its
    own segment timers folded into ``tim`` when it commits, and an
    attempt whose plan was already written back writes nothing (a late
    writeback would overwrite rows a later block advanced)."""
    from ..resilience.faults import faultpoint
    from ..resilience.recover import retry_call
    from ..resilience.watchdog import deadline_knob, run_with_deadline
    from ..utils.timers import Timers
    from .sched import pad_mask
    ddl = deadline_knob("PMTORCH_DEADLINE_DISPATCH_S")
    own_stream = ddl > 0 and torch.device(device).type == "cuda"
    out: list = [None] * len(plans)
    commit = threading.Lock()

    def attempt(pi, ix, nreal, tm):
        with tm("upload", sync=device):
            sl = stacked.map(lambda a: a[ix].to(device))
            kl = met_s[ix].to(device)
            tl = None if topo is None else \
                _topo_map(lambda a: a[ix].to(device), topo)
        progress()
        faultpoint("dispatch.chunk", key=str(pi))
        mask = pad_mask(len(ix), nreal)
        with otrace.annotate(f"grp_dispatch_chunk{pi}"), \
                tm("compute", sync=device):
            if tl is None:
                m, k, cnt = fn(sl, kl, wave, mask)
                tp = None
            else:
                m, k, cnt, tp = fn(sl, kl, wave, mask, incr, tl)
        with tm("download"):
            mh = m.map(lambda a: a[:nreal].cpu())
            kh = k[:nreal].cpu()
            th = None if tp is None else \
                _topo_map(lambda a: a[:nreal].cpu(), tp)
            cnt_h = cnt[:nreal].cpu().numpy()
        progress()
        with commit:
            if out[pi] is not None:
                return              # a late attempt: the plan committed
            with tm("writeback"):
                rows = ix[:nreal]
                for f in MESH_FIELDS:
                    getattr(stacked, f)[rows] = getattr(mh, f)
                met_s[rows] = kh
                if th is not None:
                    for d, a in zip(topo, th):
                        d[rows] = a
            out[pi] = cnt_h
            if tm is not tim:
                for name, secs in tm.acc.items():
                    tim.add(name, secs, tm.count[name])
        if done is not None:
            done[pi] = cnt_h

    def guarded(pi, ix, nreal):
        if ddl <= 0:
            return attempt(pi, ix, nreal, tim)

        def body():
            tm = Timers()
            if not own_stream:
                return attempt(pi, ix, nreal, tm)
            s = _claim_stream(device)
            try:
                with torch.cuda.stream(s):
                    return attempt(pi, ix, nreal, tm)
            finally:
                _release_stream(s)
        return run_with_deadline(body, ddl, "dispatch.chunk", beats=True)

    for pi, (idx, nreal) in enumerate(plans):
        ix = torch.from_numpy(np.asarray(idx, np.int64))
        try:
            guarded(pi, ix, nreal)
        except Exception as e:
            retry_call(lambda: guarded(pi, ix, nreal),
                       site="dispatch.chunk", initial_failure=e)
    return out


def _polish_subproc() -> bool:
    """Whether a chunked pass polishes its groups in a subprocess worker
    (``PMTORCH_POLISH_SUBPROC``; unset: in this process)."""
    v = knobs.get("PMTORCH_POLISH_SUBPROC")
    return bool(v) and v != "0"


def polish_waves(polish_block, stacked: MeshStack, met_s, ngroups: int,
                 chunk: int, tim, device, verbose: int = 0,
                 sched=None, emit=None) -> list:
    """The wave-major grouped polish over compacted chunks: up to 4
    waves, each dispatching the still-active groups through
    :func:`_pipeline_chunks`; a group retires at its own
    collapse + swap == 0 point.  Mutates the host state in place; returns
    the active groups a wave.  Shared by the in-process polish and the
    worker (``_polish_worker.py``), so both write the same bytes.
    ``emit(msg)`` prints a wave's line (default: ``otrace.log`` at level
    2)."""
    from .sched import chunk_plans
    traj = []
    pol_act = np.arange(ngroups)
    for w in range(4):
        if not len(pol_act):
            break
        plans = chunk_plans(pol_act, chunk)
        if sched is not None:
            sched.dispatches += len(plans)
        parts = _pipeline_chunks(polish_block, stacked, met_s, 2000 + w,
                                 plans, tim, device)
        if sched is not None:
            sched.note_plan_pads(plans)
        cnts = np.concatenate(parts)                  # [n_act, 4]
        traj.append(len(pol_act))
        tot = cnts.sum(axis=0, dtype=np.int64).tolist()
        msg = (f"  grp polish w{w}: collapse {tot[0]} swap {tot[1]} "
               f"move {tot[2]} over {len(pol_act)} active groups")
        if emit is None:
            otrace.log(2, msg, verbose=verbose)
        else:
            emit(msg)
        pol_act = pol_act[(cnts[:, 0] + cnts[:, 1]) > 0]
    return traj


def _polish_in_worker(stacked: MeshStack, met_s, ngroups: int, chunk: int,
                      noinsert, noswap, nomove, hausd, device, verbose,
                      stats):
    """The grouped polish of a chunked pass in a fresh process
    (``python -m parmmg_tpu_torch.parallel._polish_worker in.npz
    out.npz``), retried under ``retry_call``; a worker that keeps exiting
    non-zero (injectable: ``polish.worker``) or outlives
    ``PMTORCH_POLISH_TIMEOUT_S`` degrades one rung (``merged_polish``): the
    groups stay unpolished and the caller's merged polish and repair tail
    still run.  Returns (stacked, met_s).  The staging directory is
    removed in every case.  The worker's cold start (import, CUDA context,
    loading the built kernels) and polish seconds land in
    ``stats.sched_extra`` and the registry, with the worker's kernel
    launches."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    import tempfile
    import time
    from ..obs.metrics import REGISTRY
    from ..resilience.faults import subprocess_fault_env
    from ..resilience.recover import (RetryBudgetExhausted, WorkerExitError,
                                      ladder_step, retry_call)
    from ..resilience.watchdog import (WatchdogTimeout, deadline_knob,
                                       record_timeout)
    td = tempfile.mkdtemp(prefix="parmmg_polish_")
    try:
        inp, outp = f"{td}/in.npz", f"{td}/out.npz"
        np.savez(inp, met=met_s.numpy(), chunk=chunk, ngroups=ngroups,
                 noinsert=noinsert, noswap=noswap, nomove=nomove,
                 hausd=(np.nan if hausd is None else hausd),
                 device=str(device), threads=torch.get_num_threads(),
                 **{f: getattr(stacked, f).numpy() for f in MESH_FIELDS})
        env0 = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env0["PYTHONPATH"] = (env0.get("PYTHONPATH", "") + os.pathsep
                              + root).lstrip(os.pathsep)
        wdl = deadline_knob("PMTORCH_POLISH_TIMEOUT_S")
        walls = []

        def invoke():
            if os.path.exists(outp):
                os.unlink(outp)         # a stale partial output
            env = dict(env0)
            env.update(subprocess_fault_env("polish.worker"))
            t0 = time.perf_counter()
            try:
                r = subprocess.run(
                    [sys.executable, "-m",
                     "parmmg_tpu_torch.parallel._polish_worker", inp,
                     outp], stderr=subprocess.PIPE, text=True, env=env,
                    timeout=wdl or None)
            except subprocess.TimeoutExpired as te:
                # run() killed the worker: drop any partial output
                if os.path.exists(outp):
                    os.unlink(outp)
                record_timeout("polish.worker", wdl)
                raise WatchdogTimeout("polish.worker", wdl) from te
            walls.append(time.perf_counter() - t0)
            if r.returncode != 0:
                raise WorkerExitError("polish.worker", r.returncode,
                                      r.stderr)
            return r
        try:
            r = retry_call(invoke, site="polish.worker")
            with np.load(outp) as z:
                stacked = MeshStack(**{f: torch.from_numpy(np.array(z[f]))
                                       for f in MESH_FIELDS})
                met_s = torch.from_numpy(np.array(z["met"]))
                cold, pol = float(z["cold_s"]), float(z["polish_s"])
                launches = json.loads(str(z["launches"]))
            REGISTRY.gauge("groups.polish_worker_cold_s").set(cold)
            REGISTRY.gauge("groups.polish_worker_polish_s").set(pol)
            if stats is not None:
                se = stats.sched_extra
                se.setdefault("polish_worker_wall_s", []).append(walls[-1])
                se.setdefault("polish_worker_cold_s", []).append(cold)
                se.setdefault("polish_worker_polish_s", []).append(pol)
                se.setdefault("polish_worker_launches", []).append(launches)
            if r.stderr:
                otrace.log(2, r.stderr.rstrip("\n"), verbose=verbose)
        except RetryBudgetExhausted as e:
            REGISTRY.counter("resilience.polish_worker_failures").inc()
            ladder_step("merged_polish", site="polish.worker",
                        detail=str(e.__cause__ or e))
            otrace.log(1, "  ## Warning: grouped polish worker failed "
                          f"({e.__cause__ or e}); skipping grouped polish "
                          "— the merged polish + repair tail still runs.",
                       err=True)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    return stacked, met_s


def grouped_adapt_pass(mesh, met, ngroups: int, cycles: int = 12,
                       part: np.ndarray | None = None,
                       verbose: int = 0, stats=None,
                       noinsert: bool = False, noswap: bool = False,
                       nomove: bool = False, hausd: float | None = None,
                       cap_mult: float = 3.0, timers=None,
                       chunk: int | None = None, incr: bool = False,
                       polish: bool = False, ckpt_tag: str | None = None,
                       ckpt_it: int = 0):
    """One outer pass: split into groups, run adapt cycle blocks over the
    group axis, [polish the groups,] merge.  Returns (mesh, met,
    part_of_merged).

    The per-group program is the SAME ``adapt_cycle_impl`` as the
    whole-mesh path (frozen MG_PARBDY group seams make it correct).
    Cycles run in blocks of ``default_cycle_block`` of the mesh's device
    (9 on the card, 1 on the CPU); a block whose counts report a capacity
    overflow grows every group (``grow_shards``), re-initialises the
    topology state and reruns; a swap-inclusive cycle with zero
    split+collapse+swap over all groups ends the loop.

    Quiet-group scheduler (``parallel/sched.py``): per-group counts mark
    groups quiet once a swap-inclusive block is a no-op for them; chunked
    dispatches then gather only the active groups, and the per-slot mask
    skips quiet slots of an unchunked dispatch and the padded tail rows
    of chunk plans.  Skipping is exact (sched module docstring).
    ``chunk`` overrides :func:`group_chunk`'s memory rule (the JAX
    package's PARMMG_GROUP_CHUNK); ``incr`` (default off, as in the JAX
    package's PARMMG_INCR_TOPO) turns on the band merges of the
    incremental topology engine.

    ``polish``: after the sizing loop, up to 4 waves of the sliver polish
    on every group (seams still frozen): unchunked, all groups a wave
    until one posts no collapse or swap; chunked, the wave-major polish
    over compacted chunks (:func:`polish_waves`), in a subprocess worker
    under ``PMTORCH_POLISH_SUBPROC``.  A polish dispatch that keeps
    failing degrades to the ``merged_polish`` rung (the groups keep what
    was polished) instead of failing the pass.

    ``ckpt_tag`` / ``ckpt_it``: with ``PMTORCH_CKPT_DIR`` armed and pass
    ``ckpt_it`` due, the pre-merge stacked state is written as per-group
    shard files (``resilience.checkpoint.snapshot_stacked``).

    The pipeline's segment seconds land in ``timers`` as "grp <segment>"
    and, with the scheduler's counters and trajectories, in
    ``stats.sched_extra``; the scheduler's counters and the segment
    seconds also land in the metrics registry (``groups.*``)."""
    from ..core.mesh import mesh_to_host
    from ..ops.adapt import default_cycle_block
    from ..utils.timers import Timers
    from .distribute import grow_shards, merge_shards, split_to_shards
    from .partition import fix_contiguity, morton_partition
    from .sched import QuietGroupScheduler

    dev = mesh.device
    vert_h, tet_h, _, _, _ = mesh_to_host(mesh)
    if part is None:
        cent = vert_h[tet_h].mean(axis=1)
        part = fix_contiguity(tet_h, morton_partition(cent, ngroups))

    stacked, met_s = split_to_shards(mesh, met, part, ngroups,
                                     cap_mult=cap_mult)
    group_bytes = (met_s[0].nbytes + sum(getattr(stacked, f)[0].nbytes
                                         for f in MESH_FIELDS))
    dev_bytes = torch.cuda.get_device_properties(dev).total_memory \
        if dev.type == "cuda" else None
    chunk = group_chunk(ngroups, group_bytes, dev_bytes, chunk)
    # chunked dispatch: pad the group axis to whole chunks, and keep the
    # stacked state on the host between dispatches (only the chunk in
    # flight occupies the device)
    if chunk:
        g_exec = -(-ngroups // chunk) * chunk
        stacked = _pad_groups(stacked, g_exec).map(lambda a: a.cpu())
        met_s = _pad_groups(met_s, g_exec).cpu()
    else:
        g_exec = ngroups
    state_dev = torch.device("cpu") if chunk else dev

    sched = QuietGroupScheduler(ngroups, g_exec, chunk)
    topo_s = topo_init(stacked.capT, stack=g_exec, device=state_dev)
    # pipeline segment timers on a LOCAL registry: folded into
    # stats.sched_extra and (prefixed) into the caller's Timers at the end
    ltim = Timers()
    block = default_cycle_block(dev)
    c = 0
    regrows = 0
    dirty_traj: list[int] = []
    while c < cycles:
        nblk = min(block, cycles - c)
        flags, pres = block_schedule(c, nblk, cycles, noswap)
        step = _group_block(flags, pres, nomove, noinsert, hausd)
        swap_inc = any(flags) or noswap
        pres_all_on = all(pres)
        act, plans = sched.plan_block(pres_all_on)
        with otrace.context(block=c, chunk=chunk or 0):
            if chunk:
                parts = _pipeline_chunks(step, stacked, met_s, c, plans,
                                         ltim, dev, incr, topo_s)
                sched.note_plan_pads(plans)
                counts_act = np.concatenate(parts) if parts else \
                    np.zeros((0, nblk, 9), np.int32)
                _log(2, f"  grp block {c}..{c + nblk - 1}: active "
                        f"{len(act)}/{g_exec} groups, {len(plans)} "
                        "dispatches", verbose)
            else:
                # unchunked: compaction cannot change the dispatch, so
                # the quiet mask is what skips converged groups
                stacked, met_s, counts, topo_s = step(
                    stacked, met_s, c, sched.block_mask(pres_all_on),
                    incr, topo_s)
                counts_act = counts.cpu().numpy()   # [g_exec, nblk, 9]
        sched.record_block(act, counts_act, swap_inc, pres_all_on)
        # quiet groups contribute exact zeros (that is what marked them)
        cs = counts_act.sum(axis=0, dtype=np.int64)     # [nblk, 9]
        cs_l = cs.tolist()
        for i in range(nblk):
            tot = cs_l[i]
            # counts[8]: dirty tets pending at each cycle start, summed
            # over groups — the band-occupancy trajectory
            dirty_traj.append(tot[8])
            if stats is not None:
                stats.nsplit += tot[0]
                stats.ncollapse += tot[1]
                stats.nswap += tot[2]
                stats.nmoved += tot[3]
                stats.cycles += 1
            _log(3, f"  grp cycle {c + i}: split {tot[0]} collapse "
                    f"{tot[1]} swap {tot[2]} move {tot[3]} over {ngroups} "
                    "groups", verbose)
        if any(row[4] != 0 for row in cs_l):
            if regrows >= 6:
                raise MemoryError("group capacity exhausted")
            stacked, met_s = grow_shards(stacked, met_s, 2 * stacked.capP,
                                         2 * stacked.capT)
            # the regrow changes capT: the retained sorts are stale —
            # re-init (ok False: the next derivation is a full rebuild)
            topo_s = topo_init(stacked.capT, stack=g_exec, device=state_dev)
            regrows += 1
            # the wave top-K budgets scale with capT: every quiet proof is
            # stale at the new capacity — reactivate the full set
            sched.on_regrow()
            continue        # re-run the block: truncated winners rerun
        c += nblk
        if block_converged(cs, flags, noswap):
            break
    pol_traj: list[int] = []
    if polish and not (noinsert and noswap and nomove):
        from ..resilience.recover import RetryBudgetExhausted, ladder_step
        polish_block = _group_polish_block(noinsert, noswap, nomove, hausd)
        if chunk and _polish_subproc():
            stacked, met_s = _polish_in_worker(
                stacked, met_s, ngroups, chunk, noinsert, noswap, nomove,
                hausd, dev, verbose, stats)
        elif chunk:
            try:
                pol_traj = polish_waves(polish_block, stacked, met_s,
                                        ngroups, chunk, ltim, dev,
                                        verbose, sched)
            except RetryBudgetExhausted as e:
                # the polish is a quality tail, not the sizing loop: a
                # persistent dispatch fault skips the remaining waves (the
                # state is conforming either way; committed chunks keep
                # their polish) instead of failing the whole pass
                ladder_step("merged_polish", site="dispatch.chunk",
                            detail=str(e.__cause__ or e))
                otrace.log(1, "  ## Warning: grouped polish dispatch kept "
                              f"failing ({e.__cause__ or e}); skipping the "
                              "remaining grouped polish waves — the "
                              "merged polish + repair tail still runs.",
                           err=True)
        else:
            for w in range(4):
                stacked, met_s, cnt = polish_block(
                    stacked, met_s, 2000 + w, np.ones(g_exec, bool))
                tot = cnt.sum(dim=0).tolist()
                _log(2, f"  grp polish {w}: collapse {tot[0]} swap "
                        f"{tot[1]} move {tot[2]}", verbose)
                if tot[0] == 0 and tot[1] == 0:
                    break
    # the pass's scheduler counters and pipeline seconds land in the
    # registry whether or not the caller threaded stats / timers through
    from ..obs.metrics import REGISTRY
    REGISTRY.counter("groups.dispatches").inc(sched.dispatches)
    REGISTRY.counter("groups.dispatches_saved").inc(sched.saved_dispatches)
    REGISTRY.counter("groups.group_blocks_skipped").inc(
        sched.skipped_group_blocks)
    REGISTRY.counter("groups.cond_skipped").inc(sched.cond_skipped)
    for k, v in ltim.acc.items():
        REGISTRY.counter(f"groups.pipeline.{k}_s").inc(v)
    if stats is not None:
        stats.group_dispatches += sched.dispatches
        stats.group_dispatches_saved += sched.saved_dispatches
        stats.groups_skipped += sched.skipped_group_blocks
        se = stats.sched_extra
        se["cond_skipped_rows"] = se.get("cond_skipped_rows", 0) + \
            sched.cond_skipped
        se.setdefault("group_chunk", []).append(chunk)
        se.setdefault("active_groups_per_block", []).extend(
            sched.active_per_block)
        se.setdefault("groups_per_pass", []).append(ngroups)
        if dirty_traj:
            se.setdefault("incr_dirty_per_cycle", []).extend(dirty_traj)
        if pol_traj:
            se.setdefault("polish_active_per_wave", []).extend(pol_traj)
        for k, v in ltim.acc.items():
            se[f"grp_{k}_s"] = se.get(f"grp_{k}_s", 0.0) + v
    if timers is not None:
        for k, v in ltim.acc.items():
            timers.add(f"grp {k}", v, ltim.count[k])
    if ckpt_tag is not None:
        from ..resilience.checkpoint import snapshot_stacked
        snapshot_stacked(ckpt_tag, ckpt_it, stacked, ngroups)
    return merge_shards(stacked, met_s, return_part=True, device=dev)


@otrace.profile_guard()
def grouped_adapt(mesh, met, target_size: int, niter: int = 3,
                  cycles: int = 12, verbose: int = 0, stats=None,
                  noinsert: bool = False, noswap: bool = False,
                  nomove: bool = False, hausd: float | None = None,
                  ifc_layers: int = 2, timers=None, resume: bool = False,
                  ckpt_tag: str = "grouped", **pass_kw):
    """The two-level outer loop on one device: grouped passes with
    interface displacement between them (the rank-level loop of
    libparmmg1.c:636-948 collapsed onto one device, groups as the only
    level).  Engaged by the driver when ``-mesh-size`` yields >= 2
    groups.  ``pass_kw`` goes to every :func:`grouped_adapt_pass`
    (``chunk``, ``incr``, ``cap_mult``, ``polish``).

    Durability (``PMTORCH_CKPT_DIR`` armed): the merged state and the
    displaced partition are checkpointed after every completed pass, the
    last included (``<ckpt_tag>.pass<k>.npz``); ``resume=True`` restarts
    after the newest checkpoint of the same run fingerprint instead of
    from scratch, and writes the bytes of an uninterrupted run.  The
    crash-loop breaker: resuming into the same pass more than
    ``PMTORCH_RESUME_MAX`` times returns the checkpointed state
    (``lowfailure`` rung).  ``PMTORCH_PROFILE_DIR`` opens the profiler
    window over the ``PMTORCH_PROFILE_PASS`` passes."""
    from ..core.mesh import mesh_to_host
    from ..obs.metrics import REGISTRY
    from ..resilience import checkpoint as ckpt
    from .partition import move_interfaces

    part = None
    it0 = 0
    fp = None
    if resume or ckpt.ckpt_config()[0]:
        fp = ckpt.run_fingerprint(mesh, met, target_size, niter, cycles,
                                  noinsert, noswap, nomove, hausd,
                                  ifc_layers)
    if resume:
        found = ckpt.latest_pass_checkpoint(ckpt_tag, fingerprint=fp)
        if found is not None:
            path, k = found
            mesh, met, part, _ = ckpt.load_pass_checkpoint(path,
                                                           mesh.device)
            it0 = k + 1
            REGISTRY.counter("resilience.resumes").inc()
            otrace.event("ckpt.resumed", tag=ckpt_tag, it=it0, path=path)
            otrace.log(1, f"  resume: loaded {path}; restarting at outer "
                          f"pass {it0}", err=True)
            # crash-loop breaker: a pass resumed into more than
            # PMTORCH_RESUME_MAX times kills the run deterministically;
            # the last conforming checkpointed state is the answer
            _, esc = ckpt.crash_loop(ckpt_tag, fp, it0)
            if esc:
                from ..resilience.recover import ladder_step
                ladder_step("lowfailure", site="ckpt.resume",
                            detail=f"crash loop at pass {it0}: returning "
                                   "last conforming checkpoint")
                return mesh, met
    for it in range(it0, max(1, niter)):
        otrace.profile_pass_begin(it)
        with otrace.context(**{"pass": it}):
            ne = int(mesh.tmask.sum())
            # a displaced partition fixes the group count (its labels
            # index the previous split); fresh iterations re-derive it
            ngroups = (int(part.max()) + 1) if part is not None \
                else how_many_groups(ne, target_size)
            if ngroups < 2:
                from ..ops.adapt import adapt_mesh
                mesh, met, st = adapt_mesh(mesh, met, verbose=verbose,
                                           noinsert=noinsert, noswap=noswap,
                                           nomove=nomove, hausd=hausd)
                if stats is not None:
                    stats += st
                part = None
                ckpt.save_pass_checkpoint(ckpt_tag, it, mesh, met, part,
                                          fingerprint=fp)
                otrace.profile_pass_end(it)
                continue
            _log(2, f"  grouped pass {it}: {ngroups} groups of {ne} tets",
                 verbose)
            mesh, met, part_m = grouped_adapt_pass(
                mesh, met, ngroups, cycles=cycles, part=part,
                verbose=verbose, stats=stats, noinsert=noinsert,
                noswap=noswap, nomove=nomove, hausd=hausd, timers=timers,
                ckpt_tag=ckpt_tag, ckpt_it=it, **pass_kw)
            if it + 1 < max(1, niter):
                _, tet_h, _, _, _ = mesh_to_host(mesh)
                part = move_interfaces(tet_h, part_m, ngroups,
                                       nlayers=ifc_layers)
                # the displaced labels are pass it+1's exact input: what
                # makes a resumed run write the uninterrupted run's bytes
                ckpt.save_pass_checkpoint(ckpt_tag, it, mesh, met, part,
                                          fingerprint=fp)
            else:
                # the last pass checkpoints too (no part: no next pass),
                # so a kill in the caller's tail does not redo the passes
                ckpt.save_pass_checkpoint(ckpt_tag, it, mesh, met, None,
                                          fingerprint=fp)
        otrace.profile_pass_end(it)
    return mesh, met
