"""The pod layer of a distributed run: the rank topology, the band
exchange and the group handoff (port of ``parallel/pod.py``).

A run of N logical shards over P ranks gives each rank G = N / P
consecutive shards, rows ``row0 .. row0 + G - 1`` of the global stack
(``row0 = rank * G``); shard ids stay global everywhere (comm tables,
labels, the host numbering mirror).  :func:`activate` installs the
:class:`PodContext` of one driver call, and the functions of the
distributed path read it through :func:`current` (no signature churn):
:func:`shard_ids` gives the global ids of the rows a stack holds,
:func:`local` cuts a rank's rows out of a host table of every shard.
Without a context, or at one process, every shard is local.

- :func:`gather_band`: the one exchange of every hot-path host stage.
  Each rank's band-sized device tables (leading axis: its rows) are
  gathered to every rank as host numpy tables of every shard, all the
  tables of a call in one ``all_gather`` (``multihost.all_gather_rows``:
  on the card under NCCL, then one copy of the gathered bytes to the
  host); at one process it is a host copy.  Every call counts its bytes on
  ``mh.band_exchange_bytes`` (and ``mh.band_exchange_bytes.<what>``).
  Across processes each exchange beats the heartbeat and is a
  ``multihost.exchange`` faultpoint riding ``retry_call``; it re-raises
  on exhaustion, so a rank dies rather than desyncs (its peers sit in
  the collective): the pod runner's crash-and-resume from the pass
  checkpoint is the ladder there, and its heartbeat lease the deadline.
- :func:`plan_handoff` / :func:`maybe_handoff`: the group handoff
  (``distributegrps`` at rank granularity) — when the ranks' loads skew
  past ``PMTORCH_MH_IMBALANCE``, whole shards move to other ranks
  (``distribute.permute_shards``: a send / recv pair of each shard that
  changes rank), the comm tables and the numbering mirror remapped in
  lockstep (:func:`permute_comms`).  Off by default
  (``PMTORCH_MH_HANDOFF``): a handoff renumbers the shards, so the
  parity of P ranks with one process holds with it off.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..api import knobs
from ..obs import trace as otrace
from ..obs.metrics import REGISTRY
from . import multihost


# ---------------------------------------------------------------------------
# pod context
# ---------------------------------------------------------------------------
class PodContext:
    """The rank topology of one distributed run: ``n_shards`` logical
    shards over ``n_dev`` ranks (one device each), G consecutive rows a
    rank; this rank holds rows ``row0 .. row0 + G - 1``."""

    def __init__(self, n_shards: int):
        self.n_shards = int(n_shards)
        self.n_dev = multihost.world_size()
        self.pid = multihost.rank()
        if self.n_shards % self.n_dev:
            raise ValueError(
                f"n_shards={self.n_shards} must be a multiple of the "
                f"{self.n_dev} ranks (G logical shards a rank)")
        self.G = self.n_shards // self.n_dev
        self.row0 = self.pid * self.G

    def multi(self) -> bool:
        return self.n_dev > 1

    def rows(self) -> range:
        """The global ids of this rank's shards."""
        return range(self.row0, self.row0 + self.G)


_ACTIVE: list = []


@contextlib.contextmanager
def activate(n_shards: int):
    """Install the pod context for one driver call."""
    ctx = PodContext(n_shards)
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def current() -> PodContext | None:
    return _ACTIVE[-1] if _ACTIVE else None


def _multi_ctx() -> PodContext | None:
    ctx = current()
    return ctx if ctx is not None and ctx.multi() else None


def row0() -> int:
    """Global id of this rank's first shard (0 at one process)."""
    ctx = _multi_ctx()
    return 0 if ctx is None else ctx.row0


def shard_ids(n_rows: int, device) -> torch.Tensor:
    """[n_rows] int32: the global shard ids of the rows of a stack this
    rank holds."""
    return torch.arange(row0(), row0() + n_rows, dtype=torch.int32,
                        device=device)


def local(table):
    """This rank's rows of a host table of every shard (numpy array or
    list, leading axis the global shard id); the table at one process."""
    ctx = _multi_ctx()
    if ctx is None:
        return table
    return table[ctx.row0:ctx.row0 + ctx.G]


def n_global(n_rows: int) -> int:
    """Shards of the run, from the rows of a stack this rank holds."""
    ctx = _multi_ctx()
    return n_rows if ctx is None else ctx.n_shards


# ---------------------------------------------------------------------------
# the band exchange
# ---------------------------------------------------------------------------
def gather_band(*arrays, what: str = ""):
    """Band-sized device tables of this rank's shards as host numpy
    tables of every shard (a single array for a single input); the
    module docstring has the failure and hang semantics."""
    if multihost.is_multiprocess():
        host = _exchange(arrays, what)
    else:
        host = tuple(x.cpu().numpy() for x in arrays)
    nbytes = float(sum(h.nbytes for h in host))
    REGISTRY.counter("mh.band_exchange_bytes").inc(nbytes)
    if what:
        REGISTRY.counter(f"mh.band_exchange_bytes.{what}").inc(nbytes)
    return host[0] if len(host) == 1 else host


def _exchange(arrays, what: str) -> tuple:
    """One band exchange across processes: every table in one collective,
    retried through ``retry_call``; an exhausted budget re-raises (a local
    fallback would desync the ranks parked inside the collective)."""
    from ..resilience.faults import faultpoint
    from ..resilience.recover import retry_call
    from ..resilience.watchdog import beat

    def attempt():
        beat()
        faultpoint("multihost.exchange", key=what or None)
        full = multihost.all_gather_rows(*arrays, kind="band",
                                         to_host=True)
        return tuple(t.numpy() for t in full)

    return retry_call(attempt, site="multihost.exchange")


# ---------------------------------------------------------------------------
# the group handoff (distributegrps at rank granularity)
# ---------------------------------------------------------------------------
def handoff_enabled() -> bool:
    return knobs.get("PMTORCH_MH_HANDOFF") == "1"


def plan_handoff(sizes, n_dev: int,
                 max_imbalance: float | None = None) -> np.ndarray | None:
    """LPT re-assignment of logical shards to ranks.

    ``sizes``: [S] live tets a shard.  Returns ``perm`` (new row -> old
    row, G rows a rank, ascending old rows within a rank) or None when
    the placement is within ``max_imbalance`` (``PMTORCH_MH_IMBALANCE``)
    of the mean rank load, or the greedy plan does not lower the
    bottleneck."""
    sizes = np.asarray(sizes, np.int64).reshape(-1)
    S_l = len(sizes)
    if n_dev <= 1 or S_l % n_dev:
        return None
    G = S_l // n_dev
    if max_imbalance is None:
        max_imbalance = float(knobs.get("PMTORCH_MH_IMBALANCE"))
    load = sizes.reshape(n_dev, G).sum(axis=1)
    mean = float(load.mean())
    if mean <= 0 or float(load.max()) - mean <= max_imbalance * mean:
        return None
    order = np.argsort(-sizes, kind="stable")
    dev_rows: list[list[int]] = [[] for _ in range(n_dev)]
    dev_load = np.zeros(n_dev, np.int64)
    for r in order:
        free = [d for d in range(n_dev) if len(dev_rows[d]) < G]
        d = min(free, key=lambda i: (int(dev_load[i]), i))
        dev_rows[d].append(int(r))
        dev_load[d] += sizes[r]
    if int(dev_load.max()) >= int(load.max()):
        return None                      # no bottleneck win: stay put
    perm = np.concatenate(
        [np.sort(np.asarray(rows, np.int64)) for rows in dev_rows])
    if np.array_equal(perm, np.arange(S_l)):
        return None
    return perm


def permute_comms(comms, perm: np.ndarray):
    """The comm tables under a logical-shard permutation: rows reordered
    (new row ``i`` = old row ``perm[i]``), every embedded shard id (nbr,
    owner) rewritten through the inverse map; item order untouched, so
    the ordering contract survives a handoff."""
    import dataclasses
    S_l = len(perm)
    inv = np.empty(S_l, np.int64)
    inv[perm] = np.arange(S_l)
    nbr = comms.nbr[perm]
    nbr = np.where(nbr >= 0, inv[np.clip(nbr, 0, S_l - 1)],
                   nbr).astype(comms.nbr.dtype)
    owner = []
    for i in range(S_l):
        ow = comms.owner[perm[i]]
        owner.append(inv[np.clip(ow, 0, S_l - 1)].astype(ow.dtype))
    return dataclasses.replace(
        comms, nbr=nbr, node_idx=comms.node_idx[perm],
        node_cnt=comms.node_cnt[perm], face_idx=comms.face_idx[perm],
        face_cnt=comms.face_cnt[perm], owner=owner)


def maybe_handoff(stacked, met_s, glo_d, glo, comms, verbose: int = 0):
    """Rebalance the shards across ranks when the load skew warrants it.
    Returns (stacked, met_s, glo_d, glo, comms, shards moved); the inputs
    and 0 when the plan is a no-op, and at one process when the
    permutation fails after its retries (a skipped handoff keeps every
    invariant).  Across processes such a failure re-raises: one rank
    skipping the permutation that the others apply would desync them."""
    from ..resilience.recover import RetryBudgetExhausted, retry_call
    from .distribute import permute_shards

    ctx = current()
    if ctx is None:
        return stacked, met_s, glo_d, glo, comms, 0
    sizes = gather_band(stacked.tmask.sum(dim=1, dtype=torch.int32),
                        what="handoff_sizes")
    perm = plan_handoff(sizes, ctx.n_dev)
    if perm is None:
        return stacked, met_s, glo_d, glo, comms, 0
    moved = int(np.sum(perm // ctx.G != np.arange(len(perm)) // ctx.G))
    try:
        stacked2, met2, glo_d2 = retry_call(
            lambda: permute_shards(stacked, met_s, glo_d, perm),
            site="multihost.exchange")
    except RetryBudgetExhausted as e:
        if ctx.multi():
            raise
        REGISTRY.counter("mh.handoff_skipped").inc()
        otrace.log(1, f"  ## pod handoff skipped after retries ({e!r})",
                   err=True)
        return stacked, met_s, glo_d, glo, comms, 0
    glo2 = [glo[int(p)] for p in perm]
    comms2 = permute_comms(comms, perm)
    REGISTRY.counter("mh.handoffs").inc(moved)
    otrace.event("mh.handoff", moved=moved, n_dev=ctx.n_dev)
    loads = np.asarray(sizes).reshape(ctx.n_dev, -1).sum(1).tolist()
    otrace.log(2, f"  pod handoff: {moved} shard(s) changed rank (loads "
                  f"{loads})", verbose=verbose)
    return stacked2, met2, glo_d2, glo2, comms2, moved
