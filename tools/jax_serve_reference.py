#!/usr/bin/env python3
"""Serve the first tenant of each ``chip_smoke.py`` ``[serve]`` class
through the JAX package's serving driver, and print one JSON line of the
results.

    JAX_PLATFORMS=cpu python tools/jax_serve_reference.py [--block N]

The tenants are ``chip_smoke.serve_tenants()``'s: cube_mesh(12) under the
iso shock map h = 1.5/12 (0.2 + 4 |x - 0.5|), cube_mesh(16) and
cube_mesh(24) under the cube16 map (h = 1.5/16), and cube_mesh(12) under
the shock tensor metric (``analytic_ani_metric(vert, "shock", h=1.5/48,
h_tan=0.1)``).  Each is staged by the JAX package's
``serve.admission.stage_arrays`` and served alone by a
``ServeDriver(cycles=6)`` (one slot, one group a dispatch), jitted, as
the pool runs on its accelerator.

``--block N`` sets ``PARMMG_CYCLE_BLOCK=N`` (default 9, the JAX package's
accelerator configuration and the port's ``default_cycle_block`` on the
card: a tenant's 6 cycles run as one block).  The printed object maps
each class to its tets, qmin, qmean, cycles, regrows and operation
counts (split, collapse, swap, move), with the block and the CPU wall of
each class; ``chip_smoke.py`` holds the card's tet counts to these.

The JAX package's compile-ledger listener takes (event, duration) while
newer jax also passes keyword metadata; the listener is wrapped to drop
the keywords before the run, as the parity tests do.  Between classes
the compiled programs are dropped (``jax.clear_caches``), which keeps
the process under the kernel's count of memory mappings.
"""
from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path.insert(0, HERE)
    block = 9
    if "--block" in argv:
        block = int(argv[argv.index("--block") + 1])
    os.environ["PARMMG_CYCLE_BLOCK"] = str(block)
    import jax
    import chip_smoke
    from jax_cli_reference import _tolerant_ledger_listener
    _tolerant_ledger_listener()
    from parmmg_tpu.serve.admission import stage_arrays
    from parmmg_tpu.serve.driver import ServeDriver

    out = {"block": block}
    for tid, cls, vert, tet, met in chip_smoke.serve_tenants():
        if not tid.endswith("-0"):
            continue
        t0 = time.perf_counter()
        drv = ServeDriver(slots_per_bucket=1, chunk=1, cycles=6,
                          autoscale=False, stream=False)
        mesh, kmet = stage_arrays(vert, tet, met=met)
        drv.submit(mesh=mesh, met=kmet, tenant=tid)
        rep = drv.run()
        t = rep["tenants"][tid]
        if t["state"] != "done":
            print(json.dumps({"class": cls, "state": t["state"],
                              "reason": t["reason"]}), file=sys.stderr)
            return 1
        st = drv.requests[tid].stats
        out[cls] = {"tets": t["quality"]["ntets"],
                    "qmin": t["quality"]["qmin"],
                    "qmean": t["quality"]["qmean"],
                    "cycles": t["cycles"], "regrows": st.regrows,
                    "ops": t["ops"],
                    "cpu_wall_s": round(time.perf_counter() - t0, 3)}
        print(f"{cls}: {out[cls]}", file=sys.stderr, flush=True)
        jax.clear_caches()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
