#!/usr/bin/env python3
"""Paired walls of the grouped CLI remesh on the card: one tree against
another (card only).

    python3 tools/grouped_ab.py --other DIR [--pairs N] [--bare]

Runs ``chip_smoke.py``'s [grouped] input (cube_mesh(32) under the cube16
iso shock map, ``-mesh-size 16384 -niter 2``, defaults otherwise) through
``python -m parmmg_tpu_torch.cli`` of this checkout ("this") and of the
checkout at DIR ("other", e.g. a ``git archive`` of the parent commit),
each in a fresh process, in the order other, this, this, other, N times,
after one unmeasured run of each (which builds the kernels of its tree).
``--bare`` adds a third tree: this checkout with ``obs.trace.scope`` (the
NVTX range of every group-cycle) and ``parallel.groups.progress`` (the
dispatch watchdog's beat) replaced by no-ops, run after each "this".
Every run must write the tet count of the first.  After the warm-ups it
prints, for each tree, a digest of its built kernels (``build/lib*.so``)
and of their sources (``parmmg_tpu_torch/csrc``), so that a gap between
the trees can be told from a difference in what they loaded.  Prints the
card's name and power limit and, as its last line, one JSON object: each
tree's walls
(the CLI's own ``wall_s``: input read to report, output write excluded),
their medians and quartiles, and the paired differences this - other.
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("-mesh-size", "16384", "-niter", "2")

_BARE = ("import contextlib, sys\n"
         "from parmmg_tpu_torch.obs import trace\n"
         "from parmmg_tpu_torch.parallel import groups\n"
         "trace.scope = lambda name: contextlib.nullcontext()\n"
         "groups.progress = lambda: None\n"
         "from parmmg_tpu_torch import cli\n"
         "sys.exit(cli.main(sys.argv[1:]))\n")


def _run(root: str, work: str, out: str, bare: bool = False) -> dict:
    args = ["-in", os.path.join(work, "cube32.mesh"), "-sol",
            os.path.join(work, "cube32.sol"), "-out", out, *FLAGS, "-v",
            "1", "-bench-json", "-device", "cuda"]
    cmd = [sys.executable, "-c", _BARE, *args] if bare else \
        [sys.executable, "-m", "parmmg_tpu_torch.cli", *args]
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=root), timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{root}: exit {r.returncode}\n{r.stderr[-2000:]}")
    return json.loads([ln for ln in r.stdout.splitlines()
                       if ln.startswith("{")][-1])


def _digest(pattern: str) -> str:
    """sha256 over the named files' names and bytes, in name order."""
    h = hashlib.sha256()
    for p in sorted(glob.glob(pattern)):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _stats(xs):
    s = sorted(xs)
    q = lambda f: s[min(len(s) - 1, int(f * (len(s) - 1) + 0.5))]  # noqa
    return {"median": q(0.5), "q1": q(0.25), "q3": q(0.75)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--bare", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    print(chip_smoke._card_line())
    work = tempfile.mkdtemp(prefix="grouped_ab_", dir=os.path.join(
        HERE, "build"))
    chip_smoke._write_input(work, "cube32", n=32, metric_n=16)
    other = os.path.abspath(a.other)
    out = os.path.join(work, "o.mesh")
    trees = [("other", other, False), ("this", HERE, False)]
    if a.bare:
        trees.append(("bare", HERE, True))
    ref = None
    for name, root, bare in trees:                 # unmeasured warm-ups
        rec = _run(root, work, out, bare)
        ref = ref or rec["ntets"]
        print(f"[ab] warm-up {name}: {rec['ntets']} tets {rec['wall_s']} s")
    digests = {name: {"libs": _digest(os.path.join(root, "build",
                                                    "lib*.so")),
                      "csrc": _digest(os.path.join(
                          root, "parmmg_tpu_torch", "csrc", "*"))}
               for name, root, _ in trees}
    print(f"[ab] kernel digests {digests}")
    walls = {name: [] for name, _, _ in trees}
    for p in range(a.pairs):
        order = ["other", "this", "this", "other"]
        for name in order:
            runs = [(name, *next((r, b) for n, r, b in trees if n == name))]
            if name == "this" and a.bare:
                runs.append(("bare", HERE, True))
            for n, root, bare in runs:
                rec = _run(root, work, out, bare)
                if rec["ntets"] != ref:
                    raise RuntimeError(f"{n}: {rec['ntets']} tets, not {ref}")
                walls[n].append(rec["wall_s"])
                print(f"[ab] pair {p} {n}: {rec['wall_s']} s")
    diffs = [t - o for t, o in zip(walls["this"], walls["other"])]
    res = {"tets": ref, "walls": walls, "digests": digests,
           "stats": {k: _stats(v) for k, v in walls.items()},
           "this_minus_other": diffs}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
