#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final result line):

1. build   - compile every CUDA kernel of ``parmmg_tpu_torch/csrc`` (one
             ``nvcc`` per source, in parallel); print the card's name and
             power limit as nvidia-smi reports them.
2. main    - the port's CLI remesh (``parmmg_tpu_torch.cli.main``) of the
             structured cube_mesh(16) (24,576 tets) under the planar "shock"
             iso metric h = 1.5/16 * (0.2 + 4 |x - 0.5|), one iteration, on
             the card.  Kernel launch counts are zeroed just before and read
             just after; every kernel of the path must have launched.  The
             output mesh is read back and checked: conforming adjacency, no
             live tet of volume <= 0, qmin > 0, tet count within 2% of the
             JAX CLI's 111,116 on this input.
3. repeat  - the main path twice more: once as it is, once with the sort
             engine's wrappers (radix_sort, merge_prefix, segment_flags)
             swapped for their plain versions.  Both must write the same
             bytes (.mesh and .sol) as phase 2's run.
4. kernels - each kernel against its plain PyTorch version on the card, on
             the output mesh of phase 2 (the capacities the main path
             reached), with its tolerance; median CUDA-event times of the
             kernel, the plain version and, where one PyTorch call computes
             the same function, that call; the least time the card could
             take (bytes / 3.35 TB/s, operations / 67 TFLOP/s float32).
5. profile - the main path once more under torch.profiler.

The last two lines are one JSON object with the kernel table and one JSON
object ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
F32_OPS_PER_S = 67e12               # H100 SXM float32 outside tensor cores
JAX_CLI_NTETS = {16: 111116}        # tools/jax_cli_reference.py 16 (CPU)


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


def _device_ms(fn, kernels, reps: int = 20):
    """Device time per call of ``fn``: the CUDA kernels whose name contains
    one of ``kernels`` (a string or a tuple), summed over ``reps`` calls
    under torch.profiler and divided by ``reps``; None when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot = 0.0
    for ev in prof.key_averages():
        if any(k in ev.key for k in names):
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            tot += t
    return tot / reps / 1e3 if tot > 0 else None


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


def phase_main(workdir: str, n: int = 16, device: str = "cuda"):
    import numpy as np
    import torch
    from parmmg_tpu_torch.core.mesh import make_mesh, tet_volumes
    from parmmg_tpu_torch.io.medit import (MeditMesh, SOL_SCALAR,
                                           read_mesh, write_mesh, write_sol)
    from parmmg_tpu_torch.ops import kernels
    from parmmg_tpu_torch.ops.adjacency import build_adjacency, \
        check_adjacency
    from parmmg_tpu_torch.ops.quality import tet_quality
    from parmmg_tpu_torch.utils.fixtures import analytic_iso_metric, \
        cube_mesh

    vert, tet = cube_mesh(n)
    m = MeditMesh()
    m.vert, m.vref = vert, np.zeros(len(vert), np.int32)
    m.tetra, m.tref = tet, np.ones(len(tet), np.int32)
    src = os.path.join(workdir, "cube16.mesh")
    out = os.path.join(workdir, "cube16.o.mesh")
    write_mesh(src, m)
    write_sol(os.path.join(workdir, "cube16.sol"),
              analytic_iso_metric(vert, "shock", h=1.5 / 16), [SOL_SCALAR])

    # record the largest shapes each kernel wrapper is given on the path
    shapes = {"capP": 0, "capT": 0}
    wrapped = {}
    for name in ("edge_lengths_iso", "tet_quality"):
        fn = getattr(kernels, name)

        def rec_shape(*a, _fn=fn, _name=name, **k):
            shapes["capP"] = max(shapes["capP"], a[0].shape[0])
            if _name == "tet_quality":
                shapes["capT"] = max(shapes["capT"], a[1].shape[0])
            return _fn(*a, **k)
        wrapped[name] = fn
        setattr(kernels, name, rec_shape)
    try:
        launches, rec, wall = _run_main(workdir, out, device)
    finally:
        for name, fn in wrapped.items():
            setattr(kernels, name, fn)
    mo = read_mesh(out)
    dev = torch.device(device)
    mesh = build_adjacency(make_mesh(mo.vert, mo.tetra, device=dev))
    bad = check_adjacency(mesh)
    nbnd = int(((mesh.adja < 0) & mesh.tmask[:, None]).sum())
    vol = tet_volumes(mesh)
    nneg = int(((vol <= 0) & mesh.tmask).sum())
    q = tet_quality(mesh)
    qmin = float(q[mesh.tmask].min())
    qmean = float(q[mesh.tmask].mean())
    if bad["asymmetric"] or bad["face_mismatch"] or nneg or qmin <= 0:
        raise RuntimeError(f"output not conforming: {bad}, nonpositive "
                           f"volumes {nneg}, qmin {qmin}")
    print(f"[main] cube_mesh({n}) shock h=1.5/16 -niter 1: ntets "
          f"{rec['ntets']} qmin {rec['qmin']:.6f} qmean {rec['qmean']:.6f} "
          f"cycles {rec['cycles']} splits {rec['nsplit']} collapses "
          f"{rec['ncollapse']} swaps {rec['nswap']} wall {wall:.3f} s")
    print(f"[main] re-read output: {int(mesh.tmask.sum())} tets, "
          f"{nbnd} boundary faces, adjacency {bad}, qmin {qmin:.6f} "
          f"qmean {qmean:.6f}")
    print(f"[main] launches {launches}; largest capP {shapes['capP']} "
          f"capT {shapes['capT']}")
    ref = JAX_CLI_NTETS.get(n)
    if ref is not None and abs(rec["ntets"] - ref) > 0.02 * ref:
        raise RuntimeError(f"{rec['ntets']} tets: not within 2% of the JAX "
                           f"CLI's {ref} on this input")
    return launches, shapes


def _run_main(workdir: str, out: str, device: str = "cuda"):
    """The main path once (written by phase_main's inputs to ``out``),
    launch counts zeroed just before and read just after.  Returns
    (launches, the -bench-json record, wall seconds)."""
    import torch
    from parmmg_tpu_torch import cli
    from parmmg_tpu_torch.ops import kernels
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    kernels.reset_launches()
    sync()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-in", os.path.join(workdir, "cube16.mesh"), "-sol",
                       os.path.join(workdir, "cube16.sol"), "-out", out,
                       "-niter", "1", "-v", "1", "-bench-json",
                       "-device", device])
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


def phase_repeat(workdir: str, device: str = "cuda"):
    """Run the main path again as it is, then with the sort engine's
    wrappers swapped for their plain versions; both outputs must be
    byte-identical to phase_main's."""
    from parmmg_tpu_torch.ops import kernels
    ref = os.path.join(workdir, "cube16.o")
    launches, rec, wall = _run_main(
        workdir, os.path.join(workdir, "cube16.r2.mesh"), device)
    for ext in (".mesh", ".sol"):
        _same_bytes(ref + ext, os.path.join(workdir, "cube16.r2" + ext))
    print(f"[repeat] second run: {rec['ntets']} tets, wall {wall:.3f} s, "
          f"byte-identical .mesh and .sol")
    names = ("radix_sort", "merge_prefix", "segment_flags")
    saved = {n: getattr(kernels, n) for n in names}
    for n in names:
        setattr(kernels, n, getattr(kernels, n + "_plain"))
    try:
        launches, rec, wall = _run_main(
            workdir, os.path.join(workdir, "cube16.plain.mesh"), device)
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
            workdir, os.path.join(workdir, "cube16.atomic.mesh"), device)
    finally:
        primitives.fixed_order_sum = fixed
    print(f"[repeat] float sums by scatter_reduce atomics instead (timing "
          f"only): {rec['ntets']} tets, wall {wall:.3f} s")


def phase_profile(workdir: str):
    """The main path once more under torch.profiler: device busy time
    against wall time, and the ops that take the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from parmmg_tpu_torch import cli
    args = ["-in", os.path.join(workdir, "cube16.mesh"), "-sol",
            os.path.join(workdir, "cube16.sol"), "-out",
            os.path.join(workdir, "cube16.prof.mesh"), "-niter", "1",
            "-v", "0"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if cli.main(args) != 0:
            raise RuntimeError("profiled main path failed")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    evs = prof.key_averages()

    def dev(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else getattr(e, "self_cuda_time_total", 0)
    busy = sum(dev(e) for e in evs) / 1e6
    top = sorted(evs, key=dev, reverse=True)[:12]
    print(f"[profile] wall {wall:.3f} s (profiled), device busy "
          f"{busy:.3f} s = {100 * busy / wall:.1f}% of wall")
    for e in top:
        print(f"[profile]   {dev(e) / 1e3:9.2f} ms  x{e.count:6d}  "
              f"{e.key[:90]}")


def phase_kernels(launches, shapes, workdir: str):
    import torch
    from parmmg_tpu_torch.core.constants import INT32_MAX
    from parmmg_tpu_torch.core.mesh import make_mesh, tet_edge_vertices
    from parmmg_tpu_torch.io.medit import read_mesh, read_sol
    from parmmg_tpu_torch.ops import kernels as K
    from parmmg_tpu_torch.ops.adjacency import _face_keys, build_adjacency
    from parmmg_tpu_torch.ops.edges import unique_edges, wave_budget

    dev = torch.device("cuda")
    mo = read_mesh(os.path.join(workdir, "cube16.o.mesh"))
    vals, _ = read_sol(os.path.join(workdir, "cube16.o.sol"))
    n_p = len(mo.vert)
    # the output mesh at the largest capacities the main path reached
    mesh = build_adjacency(make_mesh(mo.vert, mo.tetra, capP=shapes["capP"],
                                     capT=shapes["capT"], device=dev))
    met = torch.ones(mesh.capP, device=dev)
    met[:n_p] = torch.from_numpy(vals[:, 0]).to(dev, torch.float32)
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
            library_ms=None, shape=""):
        b, by = _bound(nbytes, nops)
        dev_ms = _device_ms(fn, kern)
        r = {"name": name, "route": "cuda",
             "source": f"parmmg_tpu_torch/csrc/{src}",
             "replaces": f"parmmg_tpu/ops/pallas_kernels.py:{line}",
             "launches": int(launches[name]), "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
             "bound_by": by, "library_ms": library_ms,
             "device_ms": dev_ms}
        lib = "-" if library_ms is None else f"{library_ms:.4f}"
        print(f"[kernel] {name}{shape}: max_abs_err {err:.3g} ms {ms:.4f} "
              f"(device {dev_ms}) plain {plain_ms:.4f} bound {b:.4f} ({by}) "
              f"library {lib} main-path launches {launches[name]}")
        return r

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

    # K3 score + count: the split wave's cut (long edges, -lens)
    cand = (et.emask & (got > 1.0)).contiguous()
    neg = (-got).contiguous()
    g = K.score_count(cand, neg)
    r = K.score_count_plain(cand, neg)
    err = check("score_count", g, r, 0, 0, exact=True)
    rows.append(row("score_count", "score_count.cu", 231, err,
        _time_ms(lambda: K.score_count(cand, neg)),
        _time_ms(lambda: K.score_count_plain(cand, neg)),
        9 * capE + 4, 2 * capE, lambda: K.score_count(cand, neg),
        "score_kernel"))

    # K4 score3 + count: the edge-swap cut over three shell qualities
    q = K.tet_quality(mesh.vert, mesh.tet, mesh.tmask)
    sh = et.shell3.clamp(0, capT - 1).long()
    inf = torch.full((capE,), float("inf"), device=dev)
    v0, v1, v2 = (torch.where(et.shell3[:, k] >= 0, q[sh[:, k]], inf)
                  .contiguous() for k in range(3))
    c3 = (et.emask & (et.nshell <= 3)).contiguous()
    g = K.score3_count(c3, v0, v1, v2)
    r = K.score3_count_plain(c3, v0, v1, v2)
    err = check("score3_count", g, r, 0, 0, exact=True)
    rows.append(row("score3_count", "score_count.cu", 253, err,
        _time_ms(lambda: K.score3_count(c3, v0, v1, v2)),
        _time_ms(lambda: K.score3_count_plain(c3, v0, v1, v2)),
        17 * capE + 4, 4 * capE, lambda: K.score3_count(c3, v0, v1, v2),
        "score_kernel"))

    # K6 tet quality: iso (the main path's mode) and aniso
    tv, tm = mesh.tet, mesh.tmask
    got = K.tet_quality(mesh.vert, tv, tm)
    ref = K.tet_quality_plain(mesh.vert, tv, tm)
    err = check("tet_quality", got, ref, 3e-5, 3e-6)
    rows.append(row("tet_quality", "tet_quality.cu", 379, err,
        _time_ms(lambda: K.tet_quality(mesh.vert, tv, tm)),
        _time_ms(lambda: K.tet_quality_plain(mesh.vert, tv, tm)),
        12 * capP + 21 * capT, 70 * capT,
        lambda: K.tet_quality(mesh.vert, tv, tm), "tet_quality_kernel"))
    w = 1.0 / met.clamp(min=1e-30) ** 2
    off = 0.2 * w[:, None] * (torch.rand((capP, 3), generator=gen,
                                         device=dev) - 0.5)
    met6 = torch.stack([w, off[:, 0], off[:, 1], 1.5 * w, off[:, 2],
                        0.7 * w], dim=1).contiguous()
    got = K.tet_quality(mesh.vert, tv, tm, met6)
    ref = K.tet_quality_plain(mesh.vert, tv, tm, met6)
    err_a = check("tet_quality aniso", got, ref, 1e-4, 1e-5)
    ms_a = _time_ms(lambda: K.tet_quality(mesh.vert, tv, tm, met6))
    pms_a = _time_ms(lambda: K.tet_quality_plain(mesh.vert, tv, tm, met6))
    print(f"[kernel] tet_quality aniso mode: max_abs_err {err_a:.3g} ms "
          f"{ms_a:.4f} plain {pms_a:.4f} bound "
          f"{_bound(36 * capP + 21 * capT, 160 * capT)[0]:.4f} (bytes)")
    # K7 radix sort: the packed edge keys [6*capT] (1 word, 4 passes) and
    # the packed face keys [4*capT] (nbits (16, 32), 6 passes), as the
    # sort sites build them; exact against the plain stable-sort chain
    ev6 = tet_edge_vertices(mesh.tet).reshape(-1, 2)
    ekey = torch.where(mesh.tmask.repeat_interleave(6),
                       ev6.min(1).values * capP + ev6.max(1).values,
                       INT32_MAX).to(torch.int32)
    cols = _face_keys(mesh)
    f0 = cols[:, 0].contiguous()
    fw = torch.where(f0 == INT32_MAX, INT32_MAX,
                     cols[:, 1] * capP + cols[:, 2]).to(torch.int32)
    n6, n4 = ekey.shape[0], f0.shape[0]
    order = K.radix_sort((ekey,))
    err = check("radix_sort", [order], [K.radix_sort_plain((ekey,))], 0, 0,
                exact=True)
    lib = _time_ms(lambda: torch.sort(ekey, stable=True))
    radix = ("radix_", "prefix_")
    rows.append(row(
        "radix_sort", "radix_sort.cu", 434, err,
        _time_ms(lambda: K.radix_sort((ekey,))),
        _time_ms(lambda: K.radix_sort_plain((ekey,))), 8 * n6, 0,
        lambda: K.radix_sort((ekey,)), radix, library_ms=lib,
        shape=f" [edge keys {n6}]"))
    fnb = (16, 32)
    err = check("radix_sort faces", [K.radix_sort((f0, fw), fnb)],
                [K.radix_sort_plain((f0, fw), fnb)], 0, 0, exact=True)
    face = row("radix_sort", "radix_sort.cu", 434, err,
               _time_ms(lambda: K.radix_sort((f0, fw), fnb)),
               _time_ms(lambda: K.radix_sort_plain((f0, fw), fnb)),
               12 * n4, 0, lambda: K.radix_sort((f0, fw), fnb), radix,
               shape=f" [face keys {n4}, nbits (16, 32)]")
    rows[-1]["face_keys"] = {k: face[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "device_ms")}

    # K5 prefix sum: one pass's digit histogram (digit-major, block-minor,
    # as inside K7) and a [6*capT] flag vector
    tile = K._tile("pm_radix_tile")
    nb = -(-n6 // tile)
    digit = (ekey.long() & 0xFF) * nb + torch.arange(n6, device=dev) // tile
    hist = torch.bincount(digit, minlength=256 * nb).to(torch.int32)
    ks = ekey[order.long()]
    flags = K.segment_flags_plain((ks,)).to(torch.int32)
    errs = [check("merge_prefix", [K.merge_prefix(x)],
                  [K.merge_prefix_plain(x)], 0, 0, exact=True)
            for x in (hist, flags)]
    nh = hist.shape[0]
    rows.append(row(
        "merge_prefix", "merge_prefix.cu", 358, errs[0],
        _time_ms(lambda: K.merge_prefix(hist)),
        _time_ms(lambda: K.merge_prefix_plain(hist)), 8 * nh, nh,
        lambda: K.merge_prefix(hist), "prefix_",
        library_ms=_time_ms(lambda: torch.cumsum(hist, 0,
                                                 dtype=torch.int32)),
        shape=f" [histogram {nh}]"))
    fl = row("merge_prefix", "merge_prefix.cu", 358, errs[1],
             _time_ms(lambda: K.merge_prefix(flags)),
             _time_ms(lambda: K.merge_prefix_plain(flags)), 8 * n6, n6,
             lambda: K.merge_prefix(flags), "prefix_",
             library_ms=_time_ms(lambda: torch.cumsum(flags, 0,
                                                      dtype=torch.int32)),
             shape=f" [flags {n6}]")
    rows[-1]["flags_6capT"] = {k: fl[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "device_ms")}

    # K8 segment flags over the sorted edge keys (no single library call)
    err = check("segment_flags", [K.segment_flags((ks,))],
                [K.segment_flags_plain((ks,))], 0, 0, exact=True)
    rows.append(row(
        "segment_flags", "segment_flags.cu", 520, err,
        _time_ms(lambda: K.segment_flags((ks,))),
        _time_ms(lambda: K.segment_flags_plain((ks,))), 5 * n6, n6,
        lambda: K.segment_flags((ks,)), "segment_flags_kernel",
        shape=f" [sorted edge keys {n6}]"))
    # the fixed-order float sum at smooth_wave's most common shape (tet
    # corners -> vertices, masked corners to the sentinel row capP; 4 and
    # 1 columns) against scatter_reduce's atomics and against PyTorch's
    # deterministic scatter_reduce, also without the sentinel row's values
    # (timing only: the port calls neither)
    from parmmg_tpu_torch.ops.primitives import fixed_order_sum
    idx4 = torch.where(mesh.tmask[:, None], mesh.tet, capP).T.reshape(-1)
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
    order_k = ("edge_lengths_iso", "score_count", "score3_count",
               "merge_prefix", "tet_quality", "radix_sort", "segment_flags")
    rows.sort(key=lambda r: order_k.index(r["name"]))
    print(f"[kernel] shapes capP {capP} capT {capT} capE {capE} "
          f"(wave budget K {wave_budget(capT)})")
    return rows


def main() -> int:
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
    try:
        phase_build()
        launches, shapes = phase_main(workdir)
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the main path: "
                               f"{missing} ({launches})")
        phase_repeat(workdir)
        rows = phase_kernels(launches, shapes, workdir)
        phase_profile(workdir)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
