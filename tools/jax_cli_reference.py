#!/usr/bin/env python3
"""Run the JAX package's CLI on an input that ``chip_smoke.py`` remeshes
with the port, and print its one-line JSON report.

    JAX_PLATFORMS=cpu python tools/jax_cli_reference.py [n] [workdir] \
        [--aniso | --sphere] [--block N] [--metric-n M] \
        [--mesh-size N] [--niter N] [--ndev N]

The input is cube_mesh(n) (default 16), written as Medit ``.mesh``/``.sol``;
the run is ``-niter 1``.  The metric is the planar "shock" iso metric
h = 1.5/M (M = ``--metric-n``, default n), or with ``--aniso`` the planar
"shock" tensor metric
``analytic_ani_metric(vert, "shock", h=1.5/(3n), h_tan=0.1)`` (spacing
0.2-2.2 h across the plane x = 0.5, 0.1 along it).

With ``--sphere`` the input is sphere_mesh(n), written as ``sphere<n>.vtu``
with three point fields: ``metric``, the shock size map carried onto the
unit ball, ``(3/16) (0.2 + 2 |x|)``; ``temp`` and ``vel``, a scalar and a
3-vector linear in x, y and z (``parmmg_tpu_torch.utils.fixtures``
``ball_shock_metric`` and ``linear_fields``).  The CLI reads the metric
from the file, carries the other two fields through the remesh by P1
interpolation, and writes ``sphere<n>.jax.vtu``; all other flags keep
their defaults (hausd bound, ridge detection, curved-boundary moves).

``--mesh-size N`` and ``--niter N`` pass the CLI flags of the same names:
with N below the tet count the run takes the grouped path
(``parallel/groups.py``), and the tool prints the group count of each
outer pass on its second JSON line (``groups``), its ``cycles`` counting
the grouped passes' cycles.  A distributed run adds ``dist_cycles``, the
cycles of its shard-resident passes.  The reference CI's
standard matrix is ``--mesh-size 16384 --niter 2``; on cube_mesh(32) with
``--metric-n 16`` that is 12 groups, the input of ``chip_smoke.py``'s
``[grouped]`` phase.

``--ndev N`` passes ``-ndev N`` (the distributed path,
``parallel/dist.py``: N shards with frozen interfaces) and, before JAX is
imported, ``--xla_force_host_platform_device_count=N`` so that the CPU
offers N devices.  ``--metric-n 16 --ndev 4 --niter 1 --block 9`` on
cube_mesh(32) is the input of ``chip_smoke.py``'s ``[dist]`` phase.

``--block N`` sets ``PARMMG_CYCLE_BLOCK=N`` for the run, the JAX package's
own knob for the cycles per dispatch: 9 is its accelerator configuration
(fused blocks of self-width-selecting cycles, ``ops/active.py``), 1 the
default on the CPU.  After the CLI's line the tool prints a second JSON
line: the run's cycles, its auto blocks and how many cycles ran narrow
(counts column 7 of ``adapt_cycles_auto``'s rows), and the block.

The port's own result on the same input is what ``chip_smoke.py`` prints
on its ``[main]``, ``[aniso]`` and ``[field]`` lines, so the two can be set
side by side.

The JAX package's compile-ledger listener takes (event, duration) while
newer jax also passes keyword metadata; the listener is wrapped to drop
the keywords before the run, as the parity tests do.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tolerant_ledger_listener():
    import parmmg_tpu.ops.adapt  # noqa: F401  (installs the listener)
    from jax._src import monitoring
    from parmmg_tpu.utils.compilecache import CompileLedger

    def tolerant(cb):
        if getattr(cb, "__func__", None) is CompileLedger._on_event:
            return lambda event, duration, **_kw: cb(event, duration)
        return cb
    monitoring._event_duration_secs_listeners[:] = [
        tolerant(c) for c in monitoring._event_duration_secs_listeners]


def _count_cycles(tally: dict) -> None:
    """Wrap adapt_mesh and adapt_cycles_auto to count the run's cycles,
    its blocks and the narrow cycles into ``tally``."""
    from parmmg_tpu import driver
    from parmmg_tpu.ops import active
    from parmmg_tpu.parallel import dist, groups
    tally.update(cycles=0, narrow=0, blocks=0, groups=[])
    cap = {}
    adapt_mesh, auto = driver.adapt_mesh, active.adapt_cycles_auto
    grouped_pass = groups.grouped_adapt_pass
    dist_multi = dist.distributed_adapt_multi

    def counted_dist(*a, **kw):
        st = kw.get("stats")
        c0 = st.cycles if st is not None else 0
        out = dist_multi(*a, **kw)
        if st is not None:
            tally["dist_cycles"] = st.cycles - c0
        return out

    def counted_pass(mesh, met, ngroups, *a, **kw):
        tally["groups"].append(int(ngroups))
        st = kw.get("stats")
        c0 = st.cycles if st is not None else 0
        out = grouped_pass(mesh, met, ngroups, *a, **kw)
        if st is not None:
            tally["cycles"] += st.cycles - c0
        return out

    def counted_adapt_mesh(*a, **kw):
        out = adapt_mesh(*a, **kw)
        tally["cycles"] += out[2].cycles
        return out

    def counted_auto(mesh, *a, **kw):
        # capacities only grow, so the compiled blocks of an outgrown
        # capacity never run again: dropping them keeps the process under
        # the kernel's count of memory mappings, which the tensor path's
        # 9-cycle blocks otherwise exhaust (LLVM "Cannot allocate memory")
        if cap.setdefault("T", mesh.capT) != mesh.capT:
            import jax
            jax.clear_caches()
            cap["T"] = mesh.capT
        out = auto(mesh, *a, **kw)
        rows = np.asarray(out[4])
        tally["blocks"] += 1
        tally["narrow"] += int(rows[:, 7].sum())
        return out
    driver.adapt_mesh = counted_adapt_mesh
    active.adapt_cycles_auto = counted_auto
    groups.grouped_adapt_pass = counted_pass
    dist.distributed_adapt_multi = counted_dist


def write_sphere_input(workdir: str, n: int) -> str:
    """sphere_mesh(n) with its metric, temp and vel point fields, as
    ``<workdir>/sphere<n>.vtu``; returns the path."""
    from parmmg_tpu.io.vtk import write_vtu
    from parmmg_tpu.utils.fixtures import sphere_mesh
    from parmmg_tpu_torch.utils.fixtures import (ball_shock_metric,
                                                 linear_fields)
    vert, tet = sphere_mesh(n)
    temp, vel = linear_fields(vert)
    path = os.path.join(workdir, f"sphere{n}.vtu")
    write_vtu(path, vert, tet, point_data={
        "metric": ball_shock_metric(vert), "temp": temp, "vel": vel})
    return path


def main(argv) -> int:
    sys.path.insert(0, HERE)
    aniso = "--aniso" in argv
    sphere = "--sphere" in argv
    argv = [a for a in argv if a not in ("--aniso", "--sphere")]
    if "--block" in argv:
        i = argv.index("--block")
        os.environ["PARMMG_CYCLE_BLOCK"] = str(int(argv[i + 1]))
        del argv[i:i + 2]
    opts = {}
    for flag in ("--metric-n", "--mesh-size", "--niter", "--ndev"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = int(argv[i + 1])
            del argv[i:i + 2]
    if opts.get("--ndev", 1) > 1:
        # the CPU's device count is fixed when JAX first initialises
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") +
            f" --xla_force_host_platform_device_count={opts['--ndev']}")
    rc = _run(argv, aniso, sphere, opts)
    print(json.dumps(dict(TALLY, block=int(
        os.environ.get("PARMMG_CYCLE_BLOCK", "0") or 0))))
    return rc


TALLY: dict = {}


def _run(argv, aniso: bool, sphere: bool, opts: dict) -> int:
    n = int(argv[0]) if argv else 16
    workdir = argv[1] if len(argv) > 1 else tempfile.mkdtemp()
    hn = opts.get("--metric-n", n)
    flags = ["-niter", str(opts.get("--niter", 1)), "-v", "1",
             "-bench-json"]
    if "--mesh-size" in opts:
        flags += ["-mesh-size", str(opts["--mesh-size"])]
    if "--ndev" in opts:
        flags += ["-ndev", str(opts["--ndev"])]
    from parmmg_tpu import cli
    _count_cycles(TALLY)
    if sphere:
        _tolerant_ledger_listener()
        src = write_sphere_input(workdir, n)
        return cli.main(["-in", src, "-out",
                         os.path.join(workdir, f"sphere{n}.jax.vtu")]
                        + flags)
    from parmmg_tpu.io.medit import MeditMesh, write_mesh, write_sol
    from parmmg_tpu.utils.fixtures import (analytic_ani_metric,
                                           analytic_iso_metric, cube_mesh)
    _tolerant_ledger_listener()
    vert, tet = cube_mesh(n)
    m = MeditMesh()
    m.vert, m.vref = vert, np.zeros(len(vert), np.int32)
    m.tetra, m.tref = tet, np.ones(len(tet), np.int32)
    stem = f"cube{n}ani" if aniso else f"cube{n}"
    src = os.path.join(workdir, f"{stem}.mesh")
    sol = os.path.join(workdir, f"{stem}.sol")
    write_mesh(src, m)
    if aniso:
        write_sol(sol, analytic_ani_metric(vert, "shock", h=1.5 / (3 * hn),
                                           h_tan=0.1), [3])
    else:
        write_sol(sol, analytic_iso_metric(vert, "shock", h=1.5 / hn), [1])
    return cli.main(["-in", src, "-sol", sol, "-out",
                     os.path.join(workdir, f"{stem}.jax.mesh")] + flags)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
