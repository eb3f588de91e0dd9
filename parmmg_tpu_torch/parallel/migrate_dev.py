"""The device half of the global vertex numbering of a distributed run
(port of the numbering of ``parallel/migrate_dev.py``).

The numbering lives on the device as an int32 copy ``glo_d`` [S, capP]
in lockstep with the host mirror (``migrate.py``): after an adapt pass
:func:`extend_ids_device` hands out fresh ids to the new vertices and
:func:`dead_glo_rows` compacts the rows that died, and only those
band-sized tables reach the host.  Both have a static budget; on a miss
(or when :func:`session_ids_fit` says the int32 ids could wrap) the
caller takes the host path from the liveness masks.

The band migration (``band_migrate_iteration``, the welds, the flood
repair) comes with the repartitioning slice.
"""
from __future__ import annotations

import torch

from ..ops.primitives import nonzero_pad


def _rows(mask, K: int, fill: int):
    """[S, K] first K True columns of each row of ``mask``, padded."""
    return torch.stack([nonzero_pad(m, K, fill) for m in mask])


def extend_ids_device(glo_d, vmask, top: int, KN: int):
    """Assign fresh global ids to adapt-created vertices on the device.

    Fresh = live rows with glo < 0; ids are a disjoint block a shard
    starting at ``top`` (the assignment of the host
    ``extend_global_ids_from_vmask``: ascending rows within a shard,
    shards in order).  Returns (glo', new top (0-d), fresh_rows [S, KN]
    int32 (-1 pads), fresh_gids [S, KN] int32 (-1 pads), ok (0-d bool):
    every shard's fresh rows fit ``KN``)."""
    S, capP = glo_d.shape
    dev = glo_d.device
    fresh = vmask & (glo_d < 0)
    nf = fresh.sum(dim=1)
    ok = (nf <= KN).all()
    base = top + torch.cat([torch.zeros(1, dtype=nf.dtype, device=dev),
                            torch.cumsum(nf, 0)[:-1]])
    rows = _rows(fresh, KN, capP)
    gids = (base[:, None] + torch.arange(KN, device=dev)).to(torch.int32)
    valid = rows < capP
    glo2 = glo_d.clone()
    sidx = torch.arange(S, device=dev)[:, None].expand(S, KN)
    glo2[sidx[valid], rows[valid]] = gids[valid]
    # dead rows lose their id
    glo2 = torch.where(vmask, glo2, torch.full_like(glo2, -1))
    minus = torch.full_like(gids, -1)
    return (glo2, top + nf.sum(),
            torch.where(valid, rows, -1).to(torch.int32),
            torch.where(valid, gids, minus), ok)


def dead_glo_rows(glo_d, vmask, KD: int):
    """Compacted newly-dead vertex rows: rows that carry an id but whose
    liveness has dropped (collapses since the last mirror sync).
    Returns (rows [S, KD] int32 (pad capP), cnt [S] int32, ok (0-d
    bool)); ok False = budget overflow, the caller takes the host path."""
    capP = glo_d.shape[1]
    dead = (glo_d >= 0) & ~vmask
    cnt = dead.sum(dim=1, dtype=torch.int32)
    rows = _rows(dead, KD, capP).to(torch.int32)
    return rows, cnt, (cnt <= KD).all()


def session_ids_fit(top: int, n_shards: int, KN: int) -> bool:
    """Whether this pass's fresh-id block provably fits the int32 device
    numbering: :func:`extend_ids_device` hands out at most ``n_shards *
    KN`` ids from ``top``, and the counter must never wrap int32."""
    return int(top) + int(n_shards) * int(KN) < 2 ** 31
