"""Host mirrors of a distributed run's shard state and its global vertex
numbering (port of the numbering helpers of ``parallel/migrate.py``).

The persistent global numbering (``glo``: per shard, the global id of
every vertex row, -1 at dead or unnumbered rows) keys the cross-shard
analysis refresh: split-time ids for the input vertices, fresh ids for
the vertices an adapt pass creates (shard-private by the freeze
contract, so a disjoint id block a shard is exact), the ids of dead rows
dropped.  The device path assigns the fresh ids (``migrate_dev.py``) and
ships band-sized tables of them and of the newly-dead rows to the host
mirror; :func:`extend_global_ids_from_vmask` is the host path, from the
liveness masks, when the device budgets miss.

The band migration between passes (flood labels, ``migrate_shards``,
the welds) comes with the repartitioning slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ShardViews:
    """Host views of the stacked shards (one pull)."""
    vert: np.ndarray    # [S, capP, 3]
    vtag: np.ndarray
    vref: np.ndarray
    vmask: np.ndarray
    tet: np.ndarray     # [S, capT, 4]
    tref: np.ndarray
    tmask: np.ndarray
    ftag: np.ndarray    # [S, capT, 4]
    fref: np.ndarray
    etag: np.ndarray    # [S, capT, 6]
    met: np.ndarray     # [S, capP(, 6)]
    npoin: np.ndarray   # [S]
    nelem: np.ndarray   # [S]


def pull_views(stacked, met_s) -> ShardViews:
    """One device -> host copy of the shard state (a ``MeshStack`` and its
    stacked metric); every field a writable numpy copy."""
    h = {f.name: getattr(stacked, f.name).cpu().numpy().copy()
         for f in dataclasses.fields(ShardViews) if f.name != "met"}
    return ShardViews(met=met_s.cpu().numpy().copy(), **h)


def extend_global_ids_from_vmask(glo: list[np.ndarray],
                                 vmask: np.ndarray, top: int):
    """Fresh global ids for adapt-created vertices (shard-private by the
    freeze contract, so a disjoint id block per shard is exact), from the
    [S, capP] liveness masks; dead rows lose their id.  Returns the new
    top."""
    for s, g in enumerate(glo):
        fresh = vmask[s] & (g < 0)
        n = int(fresh.sum())
        if n:
            g[fresh] = top + np.arange(n, dtype=np.int64)
            top += n
        dead = ~vmask[s]
        g[dead] = -1
    return top


def apply_fresh_ids(glo: list[np.ndarray], rows: np.ndarray,
                    gids: np.ndarray) -> None:
    """Write device-assigned fresh ids into the host numbering mirror:
    ``rows``/``gids`` are [S, K] compacted tables (-1 pads) from
    ``migrate_dev.extend_ids_device``."""
    for s, g in enumerate(glo):
        m = rows[s] >= 0
        g[rows[s][m]] = gids[s][m].astype(np.int64)


def kill_glo_rows(glo: list[np.ndarray], rows: np.ndarray,
                  cnt: np.ndarray) -> None:
    """Drop the ids of newly-dead vertex rows from the host mirror:
    ``rows`` [S, K] compacted (pad >= capP or -1), ``cnt`` [S] live
    counts — the delta of the liveness mask since the last sync
    (``migrate_dev.dead_glo_rows``), band-sized where the mask is
    O(mesh).  glo >= 0 only at live id-carrying rows, so killing the
    delta keeps that invariant without shipping the mask."""
    for s, g in enumerate(glo):
        r = rows[s][: int(cnt[s])]
        r = r[(r >= 0) & (r < len(g))]
        g[r] = -1
