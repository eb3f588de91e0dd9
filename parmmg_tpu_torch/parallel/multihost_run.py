"""The pod runner: one distributed run over P processes of this host
(port of ``scripts/multihost_run.py``).

    python -m parmmg_tpu_torch.parallel.multihost_run [--np 2] [--shards 4]
        [--n 4] [--h H] [--niter 2] [--cycles 4] [--device cuda]
        [--part end_slabs] [--parity] [--ckpt DIR] [--lease S]
        [--fault RANK:SPEC] [--store DIR] [--dump DIR] [--timeout S]
        [--isolate-cards] [--profile] [--out PATH] [--verbose]

The parent spawns ``--np`` workers on 127.0.0.1 at a free port (or, with
``--store DIR``, over a file store there, which no other pack can take
between the parent's pick and the ranks' bind), each a rank of one
``torch.distributed`` group (``parallel/multihost.py``) on its own
device (``cuda:{LOCAL_RANK % device_count}``): over NCCL when every rank
has a card of its own, over gloo on the CPU and when ranks share a card
(every rank on ``cuda:0`` on a one-card machine).  Every worker builds
the same input, cube_mesh(n) at 4x capacity under the planar shock size
map of size ``--h`` (default 1.8 / n), and runs
``dist.distributed_adapt_multi`` on ``--shards`` shards, G = shards / np
a rank (from the loop's own partition, or with
``--part end_slabs`` from ``fixtures.end_slabs_partition``, 4 shards).
It hashes the merged mesh's fields and the metric and writes a JSON
sidecar: its backend, its seconds, the hash, the merged tets, qmin and
qmean, the ``mh.*`` counters (bytes, count and host seconds by kind, the
first collective of each kind's seconds, staged and halo bytes, the
halo layout of every comm-table rebuild), its kernel launches in the
run (the quality report after it is not counted) and the
``nvcc`` builds it ran (none, when the parent built the kernels first,
as it does on the card); ``--profile`` adds each rank's device busy
seconds and its NCCL kernels' seconds from ``torch.profiler``;
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
- ``--isolate-cards`` lets rank r see only the r-th visible card
  (``CUDA_VISIBLE_DEVICES``): the ranks sit on cards of their own but
  each sees one card, so their placement is a shared ``cuda:0`` and
  their group gloo, staged through the host; the same pack without it
  runs over NCCL.
- ``--fault RANK:SPEC`` arms ``PMTORCH_FAULT=SPEC`` in that rank only
  (the crash drill: ``1:multihost.exchange:key=extend;nth-2`` with
  ``PMTORCH_RETRY_MAX=0``; the wedge drill adds ``;hang=600``).

The parent prints one artifact line (``obs/artifact.make_artifact``,
kind MULTIHOST).  The JAX runner's warm phase and shared compile cache
are left out: the port compiles nothing in a rank.  The spawn and the
supervision (:func:`rank_env`, :func:`start_ranks`, :func:`supervise`)
are shared with the CLI's self-launch (``cli.py``, ``-ndev N`` across
cards).
"""
from __future__ import annotations

import argparse
import contextlib
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


def device_seconds(prof) -> dict:
    """The device's busy seconds of a finished profiler run (its kernels,
    copies and sets, from the raw device events) and those of the NCCL
    kernels among them (names starting ``nccl``)."""
    from torch.autograd import DeviceType
    busy = nccl = 0
    n_nccl = 0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA
                or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        d = e.duration_ns()
        busy += d
        if e.name().lower().startswith("nccl"):
            nccl += d
            n_nccl += 1
    return {"device_busy_s": busy / 1e9, "nccl_device_s": nccl / 1e9,
            "nccl_kernels": n_nccl}


def worker(cfg: dict) -> None:
    import torch
    from ..obs.metrics import REGISTRY
    from ..ops import kernels
    from ..ops.quality import tet_quality
    from ..utils.compilecache import ledger_snapshot
    from . import multihost
    from .dist import distributed_adapt_multi

    multihost.init_multihost(init_method=cfg.get("init_method"),
                             timeout_s=cfg.get("coll_timeout", 600.0),
                             device=cfg["device"])
    rank = multihost.rank()
    dev = multihost.local_device(cfg["device"])
    torch.set_num_threads(1)            # P ranks share the host's cores
    mesh, met = worker_input(cfg["n"], cfg["h"], dev)
    part = None
    if cfg.get("part") == "end_slabs":
        from ..utils.fixtures import cube_mesh, end_slabs_partition
        part = end_slabs_partition(*cube_mesh(cfg["n"]))
    pack_state: dict = {}
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) \
        if cfg.get("profile") and dev.type == "cuda" else None
    kernels.reset_launches()
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        out, met_m, _ = distributed_adapt_multi(
            mesh, met, cfg["shards"], niter=cfg["niter"],
            cycles=cfg["cycles"], verbose=cfg["verbose"], part=part,
            ckpt_tag="mh" if cfg.get("ckpt") else None,
            resume=bool(cfg.get("resume")), pack_state=pack_state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    # the run's launches, before the quality report below launches K6
    launches = dict(kernels.LAUNCHES)
    device_time = device_seconds(prof) if prof is not None else {}
    snap = REGISTRY.snapshot()
    counters = snap["counters"]
    tm = out.tmask
    q = tet_quality(out, met_m)[tm]
    wrk = {
        "rank": rank, "processes": multihost.world_size(),
        "backend": multihost.backend(),
        "init_s": multihost.join_seconds(),
        "device": str(dev), "seconds": dt, "hash": mesh_hash(out, met_m),
        "ntets": int(tm.sum()), "qmin": float(q.min()),
        "qmean": float(q.mean()),
        "launches": launches,
        "halo_layouts": pack_state.get("history", []),
        **device_time,
        "nvcc_builds": sorted(k for k in ledger_snapshot()
                              if k.startswith("nvcc.")),
        "jax_loaded": "jax" in sys.modules,
        **{k: counters.get(k, 0.0) for k in (
            "mh.hot_allgather_bytes", "mh.allgather_bytes",
            "mh.band_exchange_bytes", "mh.collective_bytes",
            "mh.hot_collective_bytes", "mh.staged_bytes", "mh.halo_bytes",
            "mh.halo_allgather_bytes", "mh.collective_s",
            "mh.collectives", "mh.handoffs", "resilience.resumes",
            "resilience.heartbeats", "resilience.checkpoints",
            "resilience.halo_dense")},
        **{k: v for k, v in counters.items()
           if k.startswith(("mh.collective_bytes.", "mh.collective_s.",
                            "mh.collectives."))},
        **{k: v for k, v in snap["gauges"].items()
           if k.startswith("mh.first_collective_s.")},
    }
    if cfg.get("dump"):
        import numpy as np
        from ..core.mesh import mesh_to_numpy
        np.savez(os.path.join(cfg["dump"], f"{cfg['tag']}.r{rank}.npz"),
                 met=met_m.cpu().numpy(), **mesh_to_numpy(out))
    with open(cfg["sidecar"], "w") as fh:
        json.dump(wrk, fh)
    multihost.leave()


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------
def visible_cards() -> list[str]:
    """The cards this process may hand to its ranks: the entries of
    ``CUDA_VISIBLE_DEVICES``, or, where it is unset or empty, every
    card's index (``nvidia-smi``)."""
    from ..api import knobs
    vis = knobs.launcher("CUDA_VISIBLE_DEVICES")
    if vis.strip():
        return [v.strip() for v in vis.split(",") if v.strip()]
    out = subprocess.run(["nvidia-smi", "--query-gpu=index",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return [v.strip() for v in out.splitlines() if v.strip()]


def rank_env(np_proc: int, r: int, port: int | None = None,
             base: dict | None = None) -> dict:
    """The environment of rank ``r`` of ``np_proc``: ``base`` (this
    process's environment by default) with the launcher variables
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, and ``MASTER_ADDR`` /
    ``MASTER_PORT`` for a TCP rendezvous on ``port``) and the repo root
    first on ``PYTHONPATH``."""
    env = dict(os.environ if base is None else base)
    env.update({"WORLD_SIZE": str(np_proc), "RANK": str(r),
                "LOCAL_RANK": str(r),
                "PYTHONPATH": os.pathsep.join(
                    [_ROOT] + [p for p in env.get(
                        "PYTHONPATH", "").split(os.pathsep) if p])})
    if port is not None:
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    return env


def start_ranks(cmds, envs, logs=None, cwd: str = _ROOT):
    """Start one process a rank: ``cmds[r]`` under ``envs[r]``, its
    stdout and stderr to the file ``logs[r]``, or this process's where
    ``logs`` (or its entry) is None.  Returns [(Popen, open log or
    None)], in rank order, for :func:`supervise`."""
    procs = []
    for r, (cmd, env) in enumerate(zip(cmds, envs)):
        log = open(logs[r], "w") if logs and logs[r] else None
        kw = {"stdout": log, "stderr": subprocess.STDOUT} if log else {}
        procs.append((subprocess.Popen(cmd, env=env, cwd=cwd, **kw), log))
    return procs


def supervise(procs, timeout: float | None = None, lease: float = 0.0,
              hb_dir: str | None = None, tag: str = "run"):
    """Wait for the ranks :func:`start_ranks` started.  The first
    non-zero exit kills the pack (a dead rank stalls its peers'
    collectives), as does a rank that has beaten its heartbeat under
    ``hb_dir`` and then stops for ``lease`` seconds (rc 9: a wedged rank)
    or a pack still running after ``timeout`` seconds (rc 124).  Returns
    (rc: the first non-zero exit code, else 0; info {"stale_heartbeat":
    [...]} when a lease expired)."""
    from ..resilience.watchdog import stale_ranks
    info: dict = {}
    rc = 0
    deadline = None if timeout is None else time.time() + timeout
    live = set(range(len(procs)))
    failed = False
    try:
        while live and (deadline is None or time.time() < deadline):
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
            if live:
                time.sleep(0.1)
        for r in sorted(live):
            procs[r][0].kill()
            print(f"multihost_run: TIMEOUT ({tag})", file=sys.stderr)
            rc = rc or 124
    finally:
        # every rank is done or killed by now, unless this loop was
        # interrupted: then the pack goes with it
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            if log is not None:
                log.close()
    return rc, info


def launch(args, np_proc: int, tmpdir: str, resume: bool = False,
           fault: tuple[int, str] | None = None, tag: str = "run"):
    """One pack: spawn ``np_proc`` workers and supervise them.  Returns
    (rc, the workers' sidecars (None for a rank that wrote none), info
    {"stale_heartbeat": [...]} when a lease expired)."""
    lease = float(args.lease or 0)
    hb_dir = os.path.join(tmpdir, f"hb.{tag}")
    init = port = None
    if args.store:
        os.makedirs(args.store, exist_ok=True)
        init = f"file://{os.path.abspath(args.store)}/store.{tag}"
    else:
        port = free_port()
    cmds, envs, logs, sidecars = [], [], [], []
    for r in range(np_proc):
        side = os.path.join(tmpdir, f"{tag}.w{r}.json")
        sidecars.append(side)
        cfg = {"n": args.n, "h": args.h, "shards": args.shards,
               "niter": args.niter, "cycles": args.cycles,
               "device": args.device, "sidecar": side,
               "ckpt": bool(args.ckpt), "resume": resume,
               "init_method": init, "coll_timeout": args.coll_timeout,
               "verbose": 2 if args.verbose else 0,
               "part": args.part, "dump": args.dump, "tag": tag,
               "profile": args.profile}
        base = dict(os.environ)
        for k in ("PMTORCH_FAULT", "PMTORCH_MH_HEARTBEAT_DIR",
                  "PMTORCH_CKPT_DIR"):
            base.pop(k, None)
        env = rank_env(np_proc, r, port, base)
        if args.ckpt:
            env["PMTORCH_CKPT_DIR"] = args.ckpt
        if lease > 0:
            env["PMTORCH_MH_HEARTBEAT_DIR"] = hb_dir
        if fault is not None and fault[0] == r:
            env["PMTORCH_FAULT"] = fault[1]
        if args.isolate_cards and np_proc > 1:
            env["CUDA_VISIBLE_DEVICES"] = visible_cards()[r]
        cmds.append([sys.executable, "-m",
                     "parmmg_tpu_torch.parallel.multihost_run", "--worker",
                     json.dumps(cfg)])
        envs.append(env)
        logs.append(os.path.join(tmpdir, f"{tag}.w{r}.log"))
    rc, info = supervise(start_ranks(cmds, envs, logs), timeout=args.timeout,
                         lease=lease, hb_dir=hb_dir, tag=tag)
    if rc and args.verbose:
        for r in range(np_proc):
            with open(logs[r]) as fh:
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
    ap.add_argument("--isolate-cards", action="store_true",
                    help="rank r sees only the r-th visible card: every "
                         "rank on a card of its own, but each sees one "
                         "card, so the placement is a shared cuda:0 and "
                         "the group gloo (the host-staged comparison)")
    ap.add_argument("--profile", action="store_true",
                    help="on the card: each rank's device busy seconds "
                         "and its NCCL kernels' seconds (torch.profiler)")
    ap.add_argument("--out", default="")
    ap.add_argument("--verbose", action="store_true",
                    help="workers log at verbosity 2; print their log "
                         "tails when a pack fails")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        try:
            worker(json.loads(args.worker))
        except Exception:                   # noqa: BLE001 - a dead rank
            # exit at once: the group's teardown would wait on peers
            # parked inside a collective; the parent kills the pack
            import traceback
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
        return 0
    if args.h is None:
        args.h = 1.8 / args.n
    extra: dict = {"processes": args.np, "shards": args.shards,
                   "n": args.n, "h": args.h, "niter": args.niter,
                   "cycles": args.cycles, "device": args.device}
    # every rank must find every library built: build once, here
    from .. import native
    if native.available():
        native.build()
    if args.device.startswith("cuda"):
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
    extra["backend"] = sides[0]["backend"]
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
