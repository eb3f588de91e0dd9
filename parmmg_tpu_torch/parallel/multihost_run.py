"""The pod runner: one distributed run over P processes of this host
(port of ``scripts/multihost_run.py``).

    python -m parmmg_tpu_torch.parallel.multihost_run [--np 2] [--shards 4]
        [--n 4] [--h H] [--niter 2] [--cycles 4] [--device cuda]
        [--part end_slabs] [--parity] [--ckpt DIR] [--lease S]
        [--fault RANK:SPEC] [--store DIR] [--dump DIR] [--timeout S]
        [--out PATH] [--verbose]

The parent spawns ``--np`` workers on 127.0.0.1 at a free port (or, with
``--store DIR``, over a file store there, which no other pack can take
between the parent's pick and the ranks' bind), each a rank of one
``torch.distributed`` gloo group (``parallel/multihost.py``) on its own
device (``cuda:{LOCAL_RANK % device_count}``; every rank on ``cuda:0``
on a one-card machine).  Every worker builds the same input, cube_mesh(n)
at 4x capacity under the planar shock size map of size ``--h`` (default
1.8 / n), and runs ``dist.distributed_adapt_multi`` on ``--shards``
shards, G = shards / np a rank (from the loop's own partition, or with
``--part end_slabs`` from ``fixtures.end_slabs_partition``, 4 shards).
It hashes the merged mesh's fields and the metric and writes a JSON
sidecar: its seconds, the hash, the merged tets, qmin and qmean, the
``mh.*`` counters, its kernel launches and the ``nvcc`` builds it ran
(none, when the parent built the kernels first, as it does on the card);
``--dump DIR`` also writes each rank's merged mesh fields and metric as
``<pack>.r<rank>.npz``.

- ``--parity`` runs a one-process reference of the same input in its own
  subprocess first; the artifact's ``parity_ok`` holds every rank's hash
  to it.
- The parent kills the pack on the first non-zero exit (a dead rank
  stalls its peers' collectives), or when a rank that has beaten its
  heartbeat stops beating for ``--lease`` seconds (rc 9: a wedged rank).
  With ``--ckpt DIR`` the workers checkpoint every pass there and a
  failed pack is relaunched once with ``resume``: it re-enters after the
  newest checkpoint and must end with the uninterrupted bytes.
- ``--fault RANK:SPEC`` arms ``PMTORCH_FAULT=SPEC`` in that rank only
  (the crash drill: ``1:multihost.exchange:key=extend;nth-2`` with
  ``PMTORCH_RETRY_MAX=0``; the wedge drill adds ``;hang=600``).

The parent prints one artifact line (``obs/artifact.make_artifact``,
kind MULTIHOST).  The JAX runner's warm phase and shared compile cache
are left out: the port compiles nothing in a rank.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------
def mesh_hash(mesh, met) -> str:
    """blake2b of the merged mesh's fields and the metric, host bytes."""
    from ..core.mesh import MESH_FIELDS
    h = hashlib.blake2b(digest_size=16)
    for f in MESH_FIELDS:
        h.update(getattr(mesh, f).detach().cpu().contiguous().numpy()
                 .tobytes())
    h.update(met.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def worker_input(n: int, h: float, device):
    """The input every rank builds: cube_mesh(n) at 4x capacity, analysed,
    under the planar shock iso map of size ``h`` (1.0 beyond the live
    rows)."""
    import torch
    from ..core.mesh import make_mesh
    from ..ops.analysis import analyze_mesh
    from ..utils.fixtures import analytic_iso_metric, cube_mesh
    vert, tet = cube_mesh(n)
    mesh = make_mesh(vert, tet, capP=4 * len(vert), capT=4 * len(tet),
                     device=device)
    mesh = analyze_mesh(mesh).mesh
    hv = analytic_iso_metric(vert, "shock", h=h)
    met = torch.ones(mesh.capP, dtype=mesh.vert.dtype, device=device)
    met[: len(hv)] = torch.as_tensor(hv, dtype=mesh.vert.dtype,
                                     device=device)
    return mesh, met


def worker(cfg: dict) -> None:
    import torch
    from ..obs.metrics import REGISTRY
    from ..ops import kernels
    from ..ops.quality import tet_quality
    from ..utils.compilecache import ledger_snapshot
    from . import multihost
    from .dist import distributed_adapt_multi

    init = cfg.get("init_method")
    multihost.init_multihost(init_method=init,
                             timeout_s=cfg.get("coll_timeout", 600.0))
    rank = multihost.rank()
    dev = multihost.local_device(cfg["device"])
    torch.set_num_threads(1)            # P ranks share the host's cores
    mesh, met = worker_input(cfg["n"], cfg["h"], dev)
    part = None
    if cfg.get("part") == "end_slabs":
        from ..utils.fixtures import cube_mesh, end_slabs_partition
        part = end_slabs_partition(*cube_mesh(cfg["n"]))
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, met_m, _ = distributed_adapt_multi(
        mesh, met, cfg["shards"], niter=cfg["niter"],
        cycles=cfg["cycles"], verbose=cfg["verbose"], part=part,
        ckpt_tag="mh" if cfg.get("ckpt") else None,
        resume=bool(cfg.get("resume")))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tm = out.tmask
    q = tet_quality(out, met_m)[tm]
    counters = REGISTRY.snapshot()["counters"]
    wrk = {
        "rank": rank, "processes": multihost.world_size(),
        "device": str(dev), "seconds": dt, "hash": mesh_hash(out, met_m),
        "ntets": int(tm.sum()), "qmin": float(q.min()),
        "qmean": float(q.mean()),
        "launches": dict(kernels.LAUNCHES),
        "nvcc_builds": sorted(k for k in ledger_snapshot()
                              if k.startswith("nvcc.")),
        "jax_loaded": "jax" in sys.modules,
        **{k: counters.get(k, 0.0) for k in (
            "mh.hot_allgather_bytes", "mh.allgather_bytes",
            "mh.band_exchange_bytes", "mh.collective_bytes",
            "mh.hot_collective_bytes",
            "mh.collectives", "mh.handoffs", "resilience.resumes",
            "resilience.heartbeats", "resilience.checkpoints")},
    }
    if cfg.get("dump"):
        import numpy as np
        from ..core.mesh import mesh_to_numpy
        np.savez(os.path.join(cfg["dump"], f"{cfg['tag']}.r{rank}.npz"),
                 met=met_m.cpu().numpy(), **mesh_to_numpy(out))
    with open(cfg["sidecar"], "w") as fh:
        json.dump(wrk, fh)
    if multihost.is_multiprocess():
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------
def launch(args, np_proc: int, tmpdir: str, resume: bool = False,
           fault: tuple[int, str] | None = None, tag: str = "run"):
    """One pack: spawn ``np_proc`` workers and supervise them.  Returns
    (rc, the workers' sidecars (None for a rank that wrote none), info
    {"stale_heartbeat": [...]} when a lease expired)."""
    from ..resilience.watchdog import stale_ranks
    procs, sidecars = [], []
    info: dict = {}
    lease = float(args.lease or 0)
    hb_dir = os.path.join(tmpdir, f"hb.{tag}")
    init = None
    if args.store:
        os.makedirs(args.store, exist_ok=True)
        init = f"file://{os.path.abspath(args.store)}/store.{tag}"
    else:
        port = free_port()
    for r in range(np_proc):
        side = os.path.join(tmpdir, f"{tag}.w{r}.json")
        sidecars.append(side)
        cfg = {"n": args.n, "h": args.h, "shards": args.shards,
               "niter": args.niter, "cycles": args.cycles,
               "device": args.device, "sidecar": side,
               "ckpt": bool(args.ckpt), "resume": resume,
               "init_method": init, "coll_timeout": args.coll_timeout,
               "verbose": 2 if args.verbose else 0,
               "part": args.part, "dump": args.dump, "tag": tag}
        env = dict(os.environ)
        for k in ("PMTORCH_FAULT", "PMTORCH_MH_HEARTBEAT_DIR",
                  "PMTORCH_CKPT_DIR"):
            env.pop(k, None)
        env.update({"WORLD_SIZE": str(np_proc), "RANK": str(r),
                    "LOCAL_RANK": str(r),
                    "PYTHONPATH": os.pathsep.join(
                        [_ROOT] + [p for p in env.get(
                            "PYTHONPATH", "").split(os.pathsep) if p])})
        if init is None:
            env.update({"MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": str(port)})
        if args.ckpt:
            env["PMTORCH_CKPT_DIR"] = args.ckpt
        if lease > 0:
            env["PMTORCH_MH_HEARTBEAT_DIR"] = hb_dir
        if fault is not None and fault[0] == r:
            env["PMTORCH_FAULT"] = fault[1]
        log = open(os.path.join(tmpdir, f"{tag}.w{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "parmmg_tpu_torch.parallel.multihost_run",
             "--worker", json.dumps(cfg)], env=env, cwd=_ROOT,
            stdout=log, stderr=subprocess.STDOUT), log))
    rc = 0
    deadline = time.time() + args.timeout
    live = set(range(np_proc))
    failed = False
    while live and time.time() < deadline:
        for r in sorted(live):
            code = procs[r][0].poll()
            if code is None:
                continue
            live.discard(r)
            if code != 0:
                rc = rc or code
                failed = True
        if not failed and lease > 0 and live:
            stale = stale_ranks(hb_dir, lease, sorted(live))
            if stale:
                # a wedged rank is a crashed rank that did not exit
                print(f"multihost_run: heartbeat lease expired for "
                      f"rank(s) {stale} ({tag}); killing the pack",
                      file=sys.stderr)
                info["stale_heartbeat"] = stale
                rc = rc or 9
                failed = True
        if failed and live:
            for r in sorted(live):
                procs[r][0].kill()
        time.sleep(0.1)
    for r in sorted(live):
        procs[r][0].kill()
        print(f"multihost_run: TIMEOUT ({tag})", file=sys.stderr)
        rc = rc or 124
    for p, log in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
    if rc and args.verbose:
        for r in range(np_proc):
            with open(os.path.join(tmpdir, f"{tag}.w{r}.log")) as fh:
                tail = fh.read()[-3000:]
            print(f"--- {tag} rank {r} log tail ---\n{tail}",
                  file=sys.stderr)
    sides = []
    for s in sidecars:
        try:
            with open(s) as fh:
                sides.append(json.load(fh))
        except (OSError, ValueError):
            sides.append(None)
    return rc, sides, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multihost_run")
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--h", type=float, default=None,
                    help="shock map size (default 1.8 / n)")
    ap.add_argument("--niter", type=int, default=2)
    ap.add_argument("--cycles", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--part", default="", choices=("", "end_slabs"),
                    help="start from fixtures.end_slabs_partition")
    ap.add_argument("--dump", default="",
                    help="write each rank's merged mesh + metric here")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="wall seconds a pack may take")
    ap.add_argument("--coll-timeout", type=float, default=600.0,
                    help="seconds a collective waits for its peers")
    ap.add_argument("--store", default="",
                    help="file-store directory instead of a TCP port")
    ap.add_argument("--ckpt", default="",
                    help="pass-checkpoint dir (arms resume after a crash)")
    ap.add_argument("--lease", type=float, default=0.0,
                    help="heartbeat lease seconds (0 = off)")
    ap.add_argument("--parity", action="store_true",
                    help="run the one-process reference for parity_ok")
    ap.add_argument("--fault", default="",
                    help="RANK:SPEC — PMTORCH_FAULT=SPEC in that rank only")
    ap.add_argument("--out", default="")
    ap.add_argument("--verbose", action="store_true",
                    help="workers log at verbosity 2; print their log "
                         "tails when a pack fails")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(json.loads(args.worker))
        return 0
    if args.h is None:
        args.h = 1.8 / args.n
    extra: dict = {"processes": args.np, "shards": args.shards,
                   "n": args.n, "h": args.h, "niter": args.niter,
                   "cycles": args.cycles, "device": args.device}
    if args.device.startswith("cuda"):
        # every rank must find every library built: build once, here
        from ..ops.cuda_build import build_all
        extra["build_s"] = build_all()
    tmpdir = tempfile.mkdtemp(prefix="pmtorch_mh_")
    fault = None
    if args.fault:
        fr, _, spec = args.fault.partition(":")
        fault = (int(fr), spec)
    if args.parity:
        t0 = time.time()
        rc, sides, _ = launch(args, 1, tmpdir, tag="ref")
        if rc != 0 or sides[0] is None:
            print("multihost_run: reference run failed", file=sys.stderr)
            return rc or 1
        extra["ref"] = sides[0]
        extra["ref_wall_s"] = time.time() - t0
    t0 = time.time()
    rc, sides, info = launch(args, args.np, tmpdir, fault=fault,
                             tag="timed")
    extra.update(info)
    if rc != 0 and args.ckpt:
        # the pod's failure mode: relaunch from the newest checkpoint
        # (the fault is not re-armed: the crash consumed it)
        extra["crashed_rc"] = rc
        rc, sides, _ = launch(args, args.np, tmpdir, resume=True,
                              tag="resumed")
        extra["resumed"] = True
    if rc != 0 or any(s is None for s in sides):
        print("multihost_run: FAILED", file=sys.stderr)
        return rc or 1
    extra["wall_s"] = time.time() - t0
    extra["workers"] = sides
    extra["hash"] = sides[0]["hash"]
    extra["ranks_agree"] = len({s["hash"] for s in sides}) == 1
    if "ref" in extra:
        extra["parity_ok"] = all(s["hash"] == extra["ref"]["hash"]
                                 for s in sides)
    from ..obs.artifact import make_artifact
    doc = make_artifact("MULTIHOST", metric="multihost_adapt",
                        value=max(s["seconds"] for s in sides), unit="s",
                        extra=extra)
    payload = json.dumps(doc)
    shutil.rmtree(tmpdir, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(payload + "\n")
    sys.stdout.write(payload + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
