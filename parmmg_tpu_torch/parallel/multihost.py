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

- :func:`init_multihost` joins the group from torch's own launcher
  variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``;
  ``torchrun`` and the pod runner set them), with a timeout, so that a
  desync fails instead of hanging; at one process it does nothing;
- the collectives, in one small set of helpers: :func:`all_gather_rows`
  (leading axes concatenated in rank order, every table of a call in one
  collective), :func:`all_reduce` (sum / max / min), :func:`agree` (4
  bytes a rank) and :func:`send_recv` (the group handoff's whole
  shards).  Only these helpers stage tensors through the host for gloo,
  and they count what they move on ``mh.collective_bytes`` (and, inside
  a :func:`hot_path` section, on ``mh.hot_collective_bytes``: the band
  exchange, the halo and analysis packs, the migration pool and the
  agreements).  The backend is gloo (:data:`BACKEND`), the one this
  release runs; there is no fallback to another backend or to one
  process;
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

import numpy as np
import torch

from ..api import knobs

__all__ = [
    "agree", "all_gather_rows", "all_reduce", "cold_io", "hot_path",
    "in_hot_path", "init_multihost", "is_multiprocess", "local_device",
    "mh_uniform", "pull_host", "rank", "require_single_process",
    "send_recv", "world_size",
]

# seconds a collective may wait for the other ranks before the group
# fails it (a desync then raises instead of hanging)
DEFAULT_TIMEOUT_S = 600.0
# the process group's backend: collectives staged through the host (NCCL
# needs a machine with one card a rank, ROADMAP 11e)
BACKEND = "gloo"


def mh_uniform(value, why: str):
    """Identity marker: ``value`` is the same on every rank, or
    rank-scoped by the protocol ``why`` states (e.g. rank 0 writes a file
    every rank computed the payload of).  ``why`` must not be empty."""
    if not why or not why.strip():
        raise ValueError("mh_uniform() requires a non-empty 'why' "
                         "describing the cross-rank agreement")
    return value


def init_multihost(init_method: str | None = None,
                   world_size: int | None = None, rank: int | None = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group of a several-process run.

    ``world_size`` / ``rank`` default to the launcher's ``WORLD_SIZE`` /
    ``RANK``; ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``).  Returns False, and does nothing, at one process;
    True once the group exists (also when it already did).  Collectives
    that wait longer than ``timeout_s`` for a peer fail."""
    if world_size is None:
        world_size = int(knobs.launcher("WORLD_SIZE") or 1)
    if rank is None:
        rank = int(knobs.launcher("RANK") or 0)
    if world_size <= 1:
        return False
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    dist.init_process_group(
        BACKEND, init_method=init_method or "env://",
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return True


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


def local_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for
    ``device="cuda"`` (every rank on ``cuda:0`` on a one-card machine);
    any other device as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(knobs.launcher("LOCAL_RANK") or 0)
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


# ---------------------------------------------------------------------------
# the collectives (every cross-rank byte of the port goes through here)
# ---------------------------------------------------------------------------
def _count(nbytes: int) -> None:
    from ..obs.metrics import REGISTRY
    REGISTRY.counter("mh.collectives").inc()
    REGISTRY.counter("mh.collective_bytes").inc(float(nbytes))
    if in_hot_path():
        REGISTRY.counter("mh.hot_collective_bytes").inc(float(nbytes))


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The host bytes of ``t`` as a flat uint8 tensor (gloo takes no
    tensor on a card and no bool for every op)."""
    t = t.detach().contiguous().cpu().reshape(-1)
    return t.view(torch.uint8) if t.numel() else torch.zeros(
        0, dtype=torch.uint8)


def all_gather_rows(*tensors):
    """Each tensor's leading axis concatenated across the ranks in rank
    order (the rows of rank 0 first), as tensors on each input's device:
    every tensor of the call travels in ONE all_gather of its bytes.  The
    shapes must agree across ranks.  At one process: the inputs."""
    if not is_multiprocess():
        return tensors
    import torch.distributed as dist
    P = dist.get_world_size()
    bufs = [_as_bytes(t) for t in tensors]
    flat = torch.cat(bufs) if bufs else torch.zeros(0, dtype=torch.uint8)
    got = [torch.empty_like(flat) for _ in range(P)]
    dist.all_gather(got, flat)
    _count(flat.numel() * P)
    out, off = [], 0
    for t, b in zip(tensors, bufs):
        n = b.numel()
        parts = [g[off:off + n].clone().view(t.dtype).reshape(t.shape)
                 for g in got]
        off += n
        out.append(torch.cat(parts, dim=0).to(t.device))
    return tuple(out)


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced elementwise across the ranks (``op`` sum / max /
    min), on ``t``'s device and dtype (bools as int32 on the wire).  At
    one process: ``t``."""
    if not is_multiprocess():
        return t
    import torch.distributed as dist
    wire = t.detach().cpu()
    if wire.dtype == torch.bool:
        wire = wire.to(torch.int32)
    wire = wire.clone()
    dist.all_reduce(wire, op=getattr(dist.ReduceOp, _OPS[op]))
    _count(wire.numel() * wire.element_size() * dist.get_world_size())
    return wire.to(t.dtype).to(t.device)


def agree(value: int) -> list[int]:
    """Every rank's ``value`` (an int32), in rank order: a 4-byte
    agreement.  At one process: ``[value]``."""
    if not is_multiprocess():
        return [int(value)]
    (allv,) = all_gather_rows(torch.tensor([int(value)], dtype=torch.int32))
    return [int(v) for v in allv.tolist()]


def send_recv(sends, recvs):
    """Point-to-point byte transfers between ranks, all posted together:
    ``sends`` [(dst rank, tag, tensor)], ``recvs`` [(src rank, tag,
    like tensor)].  Returns the received tensors (each shaped and typed
    like its ``like``, on its device), in ``recvs`` order."""
    import torch.distributed as dist
    ops, bufs = [], []
    for dst, tag, t in sends:
        b = _as_bytes(t)
        ops.append(dist.P2POp(dist.isend, b, int(dst), tag=int(tag)))
        _count(b.numel())
    for src, tag, like in recvs:
        b = torch.empty(like.numel() * like.element_size(),
                        dtype=torch.uint8)
        ops.append(dist.P2POp(dist.irecv, b, int(src), tag=int(tag)))
        bufs.append(b)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.view(like.dtype).reshape(like.shape).to(like.device)
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
    (full,) = all_gather_rows(x.detach().cpu())
    _note_allgather(full.numel() * full.element_size(), what)
    return full.numpy()
