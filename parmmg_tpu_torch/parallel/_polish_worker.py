"""Subprocess worker: the grouped sliver polish of a chunked pass from a
host-state file (the port's copy of ``parallel/_polish_worker.py``).

    python -m parmmg_tpu_torch.parallel._polish_worker in.npz out.npz

Why a subprocess: the worker has a CUDA context of its own, so a crash
there (a sticky CUDA error poisons the process that hits it) costs the
quality tail, not the run: the parent treats a non-zero exit as "skip the
grouped polish" (ladder rung ``merged_polish``) and its merged polish and
repair tail still run.

Protocol: ``in.npz`` holds the stacked mesh fields, ``met``, ``chunk``,
``ngroups``, the ``noinsert`` / ``noswap`` / ``nomove`` switches,
``hausd`` (NaN for none), ``device`` (the parent's: the worker runs
there, and exits 4 when it names a CUDA device and none is present; it
never carries on on the CPU) and ``threads`` (the parent's torch thread
count, so CPU float reductions split alike).  ``out.npz`` holds the
polished fields, ``met``, ``cold_s`` (import, CUDA context and loading
the kernels the parent built: ``ops/cuda_build`` finds them fresh in
``build/`` and runs no ``nvcc``), ``polish_s`` and ``launches`` (the
kernel launch counts of ``ops/kernels.py``, as JSON).  The polish is
``groups.polish_waves``, the parent's own wave-major polish, so the worker
writes the bytes the in-process polish writes on the same device.  Wave
lines go to stderr, which the parent relays through ``obs.trace.log``.

A forced failure (``PMTORCH_FAULT_FORCE`` naming ``polish.worker``, set by
the parent's ``resilience.faults.subprocess_fault_env``) exits 3, or
sleeps S seconds on ``polish.worker:hang=S``, before torch is imported.
"""
from __future__ import annotations

import sys
import time

_T0 = time.perf_counter()

if __name__ == "__main__":
    from ..api import knobs
    _force = knobs.get("PMTORCH_FAULT_FORCE")
    if _force.startswith("polish.worker"):
        _, _, _act = _force.partition(":")
        if _act.startswith("hang="):
            # the wedged-worker drill: sleep, then carry on; the parent's
            # PMTORCH_POLISH_TIMEOUT_S is what must kill this process
            # lint: ok(R3) — pre-torch protocol line, relayed by the parent
            print(f"injected hang: {_force}", file=sys.stderr, flush=True)
            time.sleep(float(_act[5:]))
        else:
            # lint: ok(R3) — pre-torch fast exit: this line must not import
            # obs (it would pull in the rest of the package)
            print("injected fault: polish.worker (PMTORCH_FAULT_FORCE)",
                  file=sys.stderr, flush=True)
            raise SystemExit(3)

import numpy as np  # noqa: E402


# lint: ok(R3) — worker->parent stderr protocol: the parent relays these
# lines into its own log
def main(inp: str, outp: str) -> int:
    z = dict(np.load(inp))
    device = str(z["device"])
    import torch
    if device.startswith("cuda") and not torch.cuda.is_available():
        print(f"polish worker: the parent's device {device} is not "
              "available here", file=sys.stderr, flush=True)
        return 4
    torch.set_num_threads(int(z["threads"]))
    from ..core.mesh import MESH_FIELDS, MeshStack
    from ..utils.timers import Timers
    from .groups import _group_polish_block, polish_waves
    dev = torch.device(device)
    if dev.type == "cuda":
        from ..ops import cuda_build
        torch.cuda.init()
        torch.zeros(1, device=dev)
        for name in cuda_build.SOURCES:
            cuda_build.load(name)
    cold = time.perf_counter() - _T0
    stacked = MeshStack(**{f: torch.from_numpy(z[f]) for f in MESH_FIELDS})
    met_s = torch.from_numpy(z["met"])
    hausd = float(z["hausd"]) if np.isfinite(z["hausd"]) else None
    block = _group_polish_block(bool(z["noinsert"]), bool(z["noswap"]),
                                bool(z["nomove"]), hausd)
    t1 = time.perf_counter()
    polish_waves(block, stacked, met_s, int(z["ngroups"]), int(z["chunk"]),
                 Timers(), dev,
                 emit=lambda msg: print(msg.strip(), file=sys.stderr,
                                        flush=True))
    pol = time.perf_counter() - t1
    print(f"polish worker: cold start {cold:.3f} s, polish {pol:.3f} s "
          f"on {device}", file=sys.stderr, flush=True)
    import json
    from ..ops.kernels import LAUNCHES
    np.savez(outp, met=met_s.numpy(), cold_s=cold, polish_s=pol,
             launches=np.asarray(json.dumps(LAUNCHES)),
             **{f: getattr(stacked, f).numpy() for f in MESH_FIELDS})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
