"""Several processes: the ranks of a ``torch.distributed`` group (port of
``parallel/multihost.py``).

The reference scales across nodes with MPI ranks; the JAX package with
``jax.distributed`` processes whose ``shard_map`` programs span every
device.  The port runs P ranks of one ``torch.distributed`` process
group, each on its own device (``cuda:{LOCAL_RANK % device_count}``),
each holding G = N / P consecutive logical shards of a distributed run
as its own :class:`~parmmg_tpu_torch.core.mesh.MeshStack`.  Every rank
runs the same driver on the same input and takes every host decision
from tables that every rank receives whole (the reference's every rank
agrees idiom); only band-sized tables cross ranks on the hot path.

This module holds the process layer:

- :func:`ranks_for` gives the ranks P of an N-shard run: the largest
  divisor of N not above the visible cards, or the launcher's world size,
  which must divide N;
- :func:`init_multihost` joins the group from torch's own launcher
  variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``; ``torchrun``, the CLI's self-launch and the pod runner
  set them), with a timeout, so that a desync fails instead of hanging;
  at one process it does nothing.  The backend follows the placement
  (:func:`placement`, :func:`backend_for`): NCCL when every rank holds a
  card of its own, gloo for ranks on the CPU and for ranks that share a
  card (NCCL refuses two ranks on one device).  There is no knob and no
  fallback: a failed NCCL init or collective fails the run.
  :func:`leave` tears the group down once every rank is past its last
  collective;
- the collectives, in one small set of helpers: :func:`all_gather_rows`
  (leading axes concatenated in rank order, every table of a call in one
  collective), :func:`all_to_all_rows` (row j of every rank's table to
  rank j: the halo exchange of ``comms.py``), :func:`all_reduce` (sum /
  max / min, of integers and flags only, so that every rank's result is
  bit for bit the same), :func:`agree` (4 bytes a rank) and
  :func:`send_recv` (the group handoff's whole shards), and
  :func:`all_gather_json` (a small record of every rank, in rank
  order).  Under NCCL the tensors stay on the card; under gloo a card
  tensor is copied to the host first, counted on ``mh.staged_bytes`` (0
  under NCCL).  They count what they move on ``mh.collective_bytes`` and
  ``mh.collective_bytes.<kind>`` (band, halo, packs, agree, handoff,
  pull, report), inside a :func:`hot_path` section also on
  ``mh.hot_collective_bytes`` (the band exchange, the halo and analysis
  packs, the migration pool and the agreements), and the host seconds
  spent inside them on ``mh.collective_s`` and
  ``mh.collective_s.<kind>``, the first of each kind's on the gauge
  ``mh.first_collective_s.<kind>`` (under NCCL the enqueue and the host
  reads that wait for the card; the NCCL kernels' own seconds are read
  from the profiler);
- :func:`pull_host` is the metered escape hatch: a whole-state
  allgather, counted on ``mh.allgather_bytes`` and, inside a
  :func:`hot_path` section, on ``mh.hot_allgather_bytes`` (held to 0 by
  the pod runner's checks; ``PMTORCH_MH_STRICT=1`` raises there).
  :func:`cold_io` exempts durable output (checkpoints, the final merge);
- :func:`require_single_process` guards the host paths that need the
  whole state of every shard (the full-view fallbacks): they raise
  rather than compute on one rank's part;
- :func:`mh_uniform` marks a value that is agreed across ranks, or
  rank-scoped by a stated protocol (rank 0 writes).
"""
from __future__ import annotations

import contextlib
import datetime
import time

import numpy as np
import torch

from ..api import knobs

__all__ = [
    "agree", "all_gather_json", "all_gather_rows", "all_reduce",
    "all_to_all_rows", "backend", "backend_for", "cold_io", "hot_path",
    "in_hot_path", "init_multihost", "is_multiprocess", "join_seconds",
    "leave", "local_device", "mh_uniform", "placement", "pull_host", "rank",
    "ranks_for", "require_single_process", "send_recv", "world_size",
]

# seconds a collective may wait for the other ranks before the group
# fails it (a desync then raises instead of hanging)
DEFAULT_TIMEOUT_S = 600.0
# the joined group: its backend, this rank's device (the wire of NCCL)
# and the seconds the join took
_GROUP = {"backend": None, "device": None, "join_s": 0.0}


def mh_uniform(value, why: str):
    """Identity marker: ``value`` is the same on every rank, or
    rank-scoped by the protocol ``why`` states (e.g. rank 0 writes a file
    every rank computed the payload of).  ``why`` must not be empty."""
    if not why or not why.strip():
        raise ValueError("mh_uniform() requires a non-empty 'why' "
                         "describing the cross-rank agreement")
    return value


def ranks_for(n_shards: int, n_cards: int,
              launched: int | None = None) -> int:
    """The ranks P of a run of ``n_shards`` shards, one card a rank: the
    largest divisor of ``n_shards`` not above ``n_cards`` (1 with one
    card or none), each rank then holding G = N / P shards.  Under a
    launcher that started ``launched`` > 1 ranks, P is that count, and it
    must divide ``n_shards`` (``ValueError`` otherwise)."""
    n = max(1, int(n_shards))
    if launched is not None and launched > 1:
        if n % launched:
            raise ValueError(
                f"-ndev {n} does not split over the {launched} ranks the "
                f"launcher started: the shard count must be a multiple of "
                "the rank count")
        return int(launched)
    cap = max(1, min(n, int(n_cards)))
    return max(d for d in range(1, cap + 1) if n % d == 0)


def placement(device: str, world_size: int,
              n_cards: int) -> list[torch.device]:
    """Every rank's device, rank r at index r: ``cuda:{r % n_cards}`` for
    ``device="cuda"`` (ranks share a card when there are more ranks than
    cards), the device as given otherwise.  Raises on ``cuda`` without a
    card."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * int(world_size)
    if n_cards < 1:
        raise RuntimeError("device 'cuda' asked for, but no CUDA device "
                           "is present")
    return [torch.device("cuda", r % n_cards)
            for r in range(int(world_size))]


def backend_for(devices) -> str:
    """The backend of a group whose ranks sit on ``devices``: ``nccl``
    when every rank holds a card of its own, ``gloo`` for ranks on the
    CPU and for ranks that share a card."""
    devs = [torch.device(d) for d in devices]
    if devs and all(d.type == "cuda" and d.index is not None
                    for d in devs) and \
            len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def init_multihost(init_method: str | None = None,
                   world_size: int | None = None, rank: int | None = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S,
                   device: str = "cuda") -> bool:
    """Join the process group of a several-process run, each rank on its
    device of :func:`placement` (``device``: "cuda", the default, or
    "cpu"), over the backend :func:`backend_for` gives that placement.

    ``world_size`` / ``rank`` default to the launcher's ``WORLD_SIZE`` /
    ``RANK``; ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``).  Under NCCL the rank's card becomes the current
    device and is bound to the group (``device_id``).  Returns False, and
    does nothing, at one process; True once the group exists (also when
    it already did).  Collectives that wait longer than ``timeout_s`` for
    a peer fail; an init that fails raises, on no other backend."""
    if world_size is None:
        world_size = int(knobs.launcher("WORLD_SIZE") or 1)
    if rank is None:
        rank = int(knobs.launcher("RANK") or 0)
    if world_size <= 1:
        return False
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    t0 = time.perf_counter()
    dev = torch.device(device)
    devs = placement(device, world_size, torch.cuda.device_count()
                     if dev.type == "cuda" else 0)
    be = backend_for(devs)
    me = local_device(device, backend=be, local=int(
        knobs.launcher("LOCAL_RANK") or rank))
    kw = {}
    if be == "nccl":
        torch.cuda.set_device(me)
        kw["device_id"] = me
    dist.init_process_group(
        be, init_method=init_method or "env://",
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=float(timeout_s)), **kw)
    _GROUP.update(backend=be, device=me, join_s=time.perf_counter() - t0)
    return True


def join_seconds() -> float:
    """The seconds :func:`init_multihost` took to join the group (0.0
    without one)."""
    return _GROUP["join_s"] if is_multiprocess() else 0.0


def leave() -> None:
    """Leave the group: a barrier, so that no rank tears down while a
    peer is still inside a collective, then ``destroy_process_group``;
    the process is single-process after it.  At one process: nothing.
    A failing rank must not call this (its peers may be parked in a
    collective it will never enter): it exits at once instead."""
    if not is_multiprocess():
        return
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    _GROUP.update(backend=None, device=None)


def backend() -> str | None:
    """The joined group's backend ("nccl" or "gloo"); None at one
    process."""
    return _GROUP["backend"] if is_multiprocess() else None


def is_multiprocess() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if is_multiprocess() else 1


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if is_multiprocess() else 0


def local_device(device: str = "cuda", backend: str | None = None,
                 local: int | None = None) -> torch.device:
    """This rank's device: ``cuda:{local % device_count}`` for
    ``device="cuda"`` (``local``: by default ``LOCAL_RANK``; under gloo
    every rank on ``cuda:0`` on a one-card machine); any other device as
    given.  Under NCCL (``backend``, by default the joined group's) a
    rank beyond the cards raises instead of sharing one."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local is None:
        local = int(knobs.launcher("LOCAL_RANK") or 0)
    n = torch.cuda.device_count()
    if (backend or _GROUP["backend"]) == "nccl" and local >= n:
        raise RuntimeError(
            f"LOCAL_RANK {local} has no card of its own ({n} cards): NCCL "
            "takes one rank a card")
    return placement(device, local + 1, n)[local]


# ---------------------------------------------------------------------------
# the collectives (every cross-rank byte of the port goes through here)
# ---------------------------------------------------------------------------
def _count(nbytes: int, kind: str = "packs") -> None:
    from ..obs.metrics import REGISTRY
    REGISTRY.counter("mh.collective_bytes").inc(float(nbytes))
    REGISTRY.counter(f"mh.collective_bytes.{kind}").inc(float(nbytes))
    if in_hot_path():
        REGISTRY.counter("mh.hot_collective_bytes").inc(float(nbytes))


@contextlib.contextmanager
def _timed(kind: str):
    """One collective of ``kind``: counted on ``mh.collectives`` and
    ``mh.collectives.<kind>``, its host seconds on ``mh.collective_s`` and
    ``mh.collective_s.<kind>``, and the first of its kind's seconds on the
    gauge ``mh.first_collective_s.<kind>`` (NCCL connects its peers
    there)."""
    from ..obs.metrics import REGISTRY
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        n = REGISTRY.counter(f"mh.collectives.{kind}")
        if not n.value:
            REGISTRY.gauge(f"mh.first_collective_s.{kind}").set(dt)
        n.inc()
        REGISTRY.counter("mh.collectives").inc()
        REGISTRY.counter("mh.collective_s").inc(dt)
        REGISTRY.counter(f"mh.collective_s.{kind}").inc(dt)


def _wire() -> torch.device:
    """Where the collectives' tensors live: the rank's card under NCCL,
    the host under gloo."""
    return _GROUP["device"] if backend() == "nccl" else torch.device("cpu")


def _on_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the wire's device; a card tensor copied to the host for
    gloo counts its bytes on ``mh.staged_bytes``."""
    wire = _wire()
    if t.device == wire:
        return t
    if t.device.type == "cuda" and wire.type == "cpu":
        from ..obs.metrics import REGISTRY
        REGISTRY.counter("mh.staged_bytes").inc(
            float(t.numel() * t.element_size()))
    return t.to(wire)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` as a flat uint8 tensor on the wire's device (no
    backend takes a bool for every op, and one buffer carries every
    table of a call)."""
    t = t.detach().contiguous().reshape(-1)
    if not t.numel():
        return torch.zeros(0, dtype=torch.uint8, device=_wire())
    return _on_wire(t.view(torch.uint8))


def _from_bytes(b: torch.Tensor, dtype, shape) -> torch.Tensor:
    """The inverse of :func:`_as_bytes`: a copy of the bytes ``b`` (rows
    of whole elements) as ``dtype`` in ``shape``, on ``b``'s device."""
    return b.clone().view(dtype).reshape(shape)


def all_gather_rows(*tensors, kind: str = "packs", to_host: bool = False):
    """Each tensor's leading axis concatenated across the ranks in rank
    order (the rows of rank 0 first), as tensors on each input's device,
    or, with ``to_host``, on the host after one copy of the gathered
    bytes: every tensor of the call travels in ONE all_gather of its
    bytes.  The shapes must agree across ranks.  At one process: the
    inputs (on the host with ``to_host``)."""
    if not is_multiprocess():
        return tuple(t.cpu() for t in tensors) if to_host else tensors
    import torch.distributed as dist
    with _timed(kind):
        P = dist.get_world_size()
        bufs = [_as_bytes(t) for t in tensors]
        flat = torch.cat(bufs) if bufs else torch.zeros(
            0, dtype=torch.uint8, device=_wire())
        n_all = flat.numel()
        got = torch.empty(P, n_all, dtype=torch.uint8, device=flat.device)
        dist.all_gather(list(got.unbind(0)), flat)
        _count(n_all * P, kind)
        if to_host:
            got = got.cpu()
        out, off = [], 0
        for t, b in zip(tensors, bufs):
            n = b.numel()
            part = _from_bytes(got[:, off:off + n], t.dtype,
                               (P * t.shape[0],) + tuple(t.shape[1:]))
            off += n
            out.append(part if to_host else part.to(t.device))
        return tuple(out)


def all_to_all_rows(*tensors, kind: str = "halo"):
    """Row j of each tensor (leading axis: the P ranks) sent to rank j:
    returns tensors of the same shapes whose row j is what rank j sent
    this rank, on each input's device.  Every tensor of the call travels
    in ONE ``all_to_all_single`` of equal splits.  At one process: the
    inputs."""
    if not is_multiprocess():
        return tensors
    import torch.distributed as dist
    with _timed(kind):
        P = dist.get_world_size()
        rows = [_as_bytes(t).view(P, -1) for t in tensors]
        flat = torch.cat(rows, dim=1)
        got = torch.empty_like(flat)
        dist.all_to_all_single(got, flat)
        _count(flat.numel(), kind)
        out, off = [], 0
        for t, r in zip(tensors, rows):
            n = r.shape[1]
            out.append(_from_bytes(got[:, off:off + n], t.dtype,
                                   t.shape).to(t.device))
            off += n
        return tuple(out)


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced elementwise across the ranks (``op`` sum / max /
    min), on ``t``'s device and dtype (bools as int32 on the wire).  At
    one process: ``t``."""
    if not is_multiprocess():
        return t
    import torch.distributed as dist
    with _timed("agree"):
        wire = t.detach()
        if wire.dtype == torch.bool:
            wire = wire.to(torch.int32)
        wire = _on_wire(wire).clone()
        dist.all_reduce(wire, op=getattr(dist.ReduceOp, _OPS[op]))
        _count(wire.numel() * wire.element_size() * dist.get_world_size(),
               "agree")
        return wire.to(t.dtype).to(t.device)


def agree(value: int) -> list[int]:
    """Every rank's ``value`` (an int32), in rank order: a 4-byte
    agreement.  At one process: ``[value]``."""
    if not is_multiprocess():
        return [int(value)]
    (allv,) = all_gather_rows(torch.tensor([int(value)], dtype=torch.int32),
                              kind="agree", to_host=True)
    return [int(v) for v in allv.tolist()]


def all_gather_json(obj, kind: str = "report") -> list:
    """Every rank's JSON-serialisable ``obj``, in rank order: its length
    agreed first, then the bytes, padded to the longest, in one
    :func:`all_gather_rows`.  At one process: ``[obj]``."""
    import json
    if not is_multiprocess():
        return [obj]
    raw = json.dumps(obj).encode()
    width = max(agree(len(raw)))
    buf = torch.zeros(1, width, dtype=torch.uint8)
    buf[0, :len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    (rows,) = all_gather_rows(buf, kind=kind, to_host=True)
    return [json.loads(bytes(r.tolist()).rstrip(b"\0").decode())
            for r in rows]


def send_recv(sends, recvs):
    """Point-to-point byte transfers between ranks, all posted together:
    ``sends`` [(dst rank, tag, tensor)], ``recvs`` [(src rank, tag,
    like tensor)].  Returns the received tensors (each shaped and typed
    like its ``like``, on its device), in ``recvs`` order."""
    import torch.distributed as dist
    with _timed("handoff"):
        ops, bufs = [], []
        for dst, tag, t in sends:
            b = _as_bytes(t)
            ops.append(dist.P2POp(dist.isend, b, int(dst), tag=int(tag)))
            _count(b.numel(), "handoff")
        for src, tag, like in recvs:
            b = torch.empty(like.numel() * like.element_size(),
                            dtype=torch.uint8, device=_wire())
            ops.append(dist.P2POp(dist.irecv, b, int(src), tag=int(tag)))
            bufs.append(b)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [_from_bytes(b, like.dtype, like.shape).to(like.device)
                for b, (_, _, like) in zip(bufs, recvs)]


# ---------------------------------------------------------------------------
# hot-path metering (the pull_host escape hatch's tripwire)
# ---------------------------------------------------------------------------
_HOT_DEPTH = [0]


@contextlib.contextmanager
def hot_path():
    """Mark a section as the hot path: a :func:`pull_host` inside it is
    counted on ``mh.hot_allgather_bytes`` and raises under
    ``PMTORCH_MH_STRICT=1``.  Entering one beats this rank's heartbeat
    (``resilience/watchdog.beat``), which the pod runner's lease reads."""
    from ..resilience.watchdog import beat
    beat()
    _HOT_DEPTH[0] += 1
    try:
        yield
    finally:
        _HOT_DEPTH[0] -= 1


@contextlib.contextmanager
def cold_io():
    """Exempt a nested IO section (a checkpoint, the final merge) from the
    hot-path meter: replicating state for durable output is that path's
    designed cost."""
    d, _HOT_DEPTH[0] = _HOT_DEPTH[0], 0
    try:
        yield
    finally:
        _HOT_DEPTH[0] = d


def in_hot_path() -> bool:
    return _HOT_DEPTH[0] > 0


def _note_allgather(nbytes: int, what: str = "") -> None:
    """Meter one escape-hatch allgather: total bytes always; hot bytes, a
    trace event and the ``PMTORCH_MH_STRICT`` tripwire inside
    :func:`hot_path`."""
    from ..obs import trace as otrace
    from ..obs.metrics import REGISTRY
    REGISTRY.counter("mh.allgather_bytes").inc(float(nbytes))
    if in_hot_path():
        REGISTRY.counter("mh.hot_allgather_bytes").inc(float(nbytes))
        otrace.event("mh.hot_allgather", nbytes=int(nbytes),
                     what=str(what))
        if knobs.get("PMTORCH_MH_STRICT") == "1":
            raise RuntimeError(
                f"hot-path allgather of {nbytes} bytes"
                + (f" ({what})" if what else "")
                + " — the band path must route through pod.gather_band "
                "[PMTORCH_MH_STRICT]")


def require_single_process(what: str) -> None:
    """Raise ``NotImplementedError`` on a several-process run: ``what``
    needs the whole state of every shard on one host."""
    if is_multiprocess():
        raise NotImplementedError(
            f"{what} is single-process: it needs the whole state of every "
            "shard; the band path must hold on a several-process run")


def pull_host(x, what: str = "") -> np.ndarray:
    """Host numpy copy of ``x``; across processes the rows of every rank
    (``x`` holds this rank's, leading axis), metered: the bytes count on
    ``mh.allgather_bytes`` and, inside :func:`hot_path`, on
    ``mh.hot_allgather_bytes``."""
    if isinstance(x, np.ndarray):
        return x
    if not is_multiprocess():
        return x.detach().cpu().numpy()
    (full,) = all_gather_rows(x.detach(), kind="pull", to_host=True)
    _note_allgather(full.numel() * full.element_size(), what)
    return full.numpy()
