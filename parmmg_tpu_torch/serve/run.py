"""File-based front end of the serving pool: submit a batch of tenant mesh
files to one pool and write each tenant's adapted mesh as distributed
files (the counterpart of the JAX package's ``scripts/serve_run.py``):

    python -m parmmg_tpu_torch.serve.run --out OUTDIR a.mesh b.mesh c.vtu

Each input may carry a sidecar metric ``<stem>.sol`` (picked up when it
exists; a ``.vtu`` may hold a "metric" point field instead); without one
the -optim metric is computed.  Prints one JSON report: per-tenant state,
latency, qmin, qmean and output files, and the pool's aggregates.  Exits
1 when a tenant failed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from ..obs.trace import TRACER
    from .driver import ServeDriver

    ap = argparse.ArgumentParser(
        prog="python -m parmmg_tpu_torch.serve.run",
        description="Remesh a batch of mesh files through one pool.")
    ap.add_argument("meshes", nargs="+", help=".mesh/.meshb/.vtu inputs")
    ap.add_argument("--out", default="serve_out",
                    help="output directory for each tenant's files")
    ap.add_argument("--cycles", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append every trace record to this JSONL file")
    ap.add_argument("-v", "--verbose", action="count", default=0)
    args = ap.parse_args(argv)
    if args.trace:
        TRACER.configure(args.trace)

    os.makedirs(args.out, exist_ok=True)
    drv = ServeDriver(out_dir=args.out, cycles=args.cycles,
                      verbose=args.verbose, device=args.device)
    for p in args.meshes:
        stem = os.path.splitext(p)[0]
        sol = stem + ".sol"
        drv.submit(path=p, sol=sol if os.path.exists(sol) else None,
                   tenant=os.path.basename(stem))
    rep = drv.run()
    rep.pop("occupancy_traj", None)
    print(json.dumps(rep, default=str))
    return 0 if rep["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
