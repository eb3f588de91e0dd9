"""The device half of the migration between distributed passes and of the
global vertex numbering (port of ``parallel/migrate_dev.py``).

ParMmg's loop touches only moving groups and OLDPARBDY entities between
iterations (distributegrps_pmmg.c:1631-1841, analys_pmmg.c:1571).  Here
the whole between-pass pipeline runs on the stacked shards on the device,
and the host sees only compacted band- and interface-sized tables:

- :func:`device_migrate`: the donor floor (deepest flood layer first, the
  moveinterfaces_pmmg.c:1343 front order), band compaction, the package
  transfer between shards (a gather across the stack), arrival resolution
  by global id including slot resurrection, vertex-slot allocation,
  liveness and the numbering's arrivals, all at static shapes;
- :func:`exposed_face_probe`: every shard's exposed faces as global-id
  triples, compacted to an interface-sized budget;
- :func:`retag_device`: the freeze / unfreeze retag against the new
  interface;
- :func:`band_region_probe` + :func:`band_weld`: the near-duplicate weld
  on the one-ring region of the arrivals;
- :func:`repair_flood_labels`: contiguity and reachability repair of the
  flood labels on a band-sized probe (moveinterfaces_pmmg.c:475-720);
- :func:`graph_repartition_labels_band`: graph-mode labels from
  O(S G^2 + interface) tables;
- :func:`extend_ids_device` / :func:`dead_glo_rows`: fresh ids for the
  vertices an adapt pass created and the rows that died, as band-sized
  tables for the host mirror (``migrate.py``).

Budget overflows set ``ok`` False and the caller falls back to the
full-view path (``migrate.py``), the correctness oracle.  No function
writes into its input tensors: on ``ok`` False the fallback needs the
original state.  Every row-wise prefix sum is one K5 launch over the
flattened rows (:func:`_row_cumsum`), and a compaction
(``jnp.nonzero(size=K)``) is one of those and a scatter, with no host
read; a ``.at[].set(mode="drop")`` writes into a dump row that is cut
off after.

Global ids are int32 on the device (``glo_d`` [S, capP], in lockstep with
the host mirror, which is int64); :func:`session_ids_fit` says when the
int32 ids could wrap, and the caller then takes the host path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import (FACE_EDGES, IARE, IDIR, INT32_MAX, MG_BDY,
                              MG_NOSURF, MG_PARBDY, MG_PARBDYBDY, MG_REQ,
                              PARBDY_TAGS)
from ..obs import trace as otrace
from ..ops import kernels
from ..utils.compilecache import bucket, governed

_I32 = torch.int32


# ---------------------------------------------------------------------------
# shared idioms
# ---------------------------------------------------------------------------
def _row_cumsum(x):
    """[S, n] int64: the inclusive prefix sum of every row of the bool or
    int32 ``x`` (``jnp.cumsum(x, axis=1)``), from one K5 prefix sum over
    the flattened rows, less the rows before each."""
    S, n = x.shape
    incl = kernels.merge_prefix(x.reshape(-1).to(_I32)).view(S, n)
    before = torch.cat([torch.zeros(1, dtype=_I32, device=x.device),
                        incl[:-1, -1]]) if n else incl[:, :0]
    return (incl - before[:, None]).long()


def _compact(mask, K: int, fill: int):
    """[S, K] int64: the first K True columns of each row of ``mask``,
    padded with ``fill`` (``jnp.nonzero(m, size=K, fill_value=fill)`` a
    row), without a host read: the ranks of a row prefix sum, then one
    scatter."""
    S, n = mask.shape
    pos = _row_cumsum(mask) - 1
    tgt = torch.where(mask & (pos < K), pos, K)
    out = torch.full((S, K + 1), fill, dtype=torch.int64, device=mask.device)
    src = torch.arange(n, device=mask.device).expand(S, n)
    return out.scatter(1, tgt, src)[:, :K]


def _set_rows(x, idx, vals):
    """``x.at[sidx, idx].set(vals, mode="drop")`` for ``x`` [S, n, ...],
    ``idx`` [S, m] (an index n is dropped), into a copy of ``x``."""
    S, n = x.shape[:2]
    pad = torch.zeros((S, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    out = torch.cat([x, pad], dim=1)
    sidx = torch.arange(S, device=x.device)[:, None].expand_as(idx)
    out[sidx, idx.long()] = vals if not torch.is_tensor(vals) \
        else vals.to(x.dtype)
    return out[:, :n]


def _mark(S: int, n: int, idx, device):
    """[S, n] bool, True at ``idx`` [S, m] (indices n are dropped)."""
    return _set_rows(torch.zeros((S, n), dtype=torch.bool, device=device),
                     idx.reshape(S, -1), True)


def _lexsort_rows(*keys):
    """Stable sort permutation of every row by ``keys`` [S, n] (MAJOR key
    first): ``jnp.lexsort(keys[::-1])`` a row."""
    order = torch.sort(keys[-1], dim=1, stable=True).indices
    for k in keys[-2::-1]:
        order = order.gather(1, torch.sort(k.gather(1, order), dim=1,
                                           stable=True).indices)
    return order


def _take(x, idx):
    """``x[sidx, idx]`` for ``x`` [S, n, ...] and ``idx`` [S, ...]."""
    S = x.shape[0]
    sidx = torch.arange(S, device=x.device).view((S,) + (1,) * (idx.dim()
                                                                - 1))
    return x[sidx.expand_as(idx), idx.long()]


# ---------------------------------------------------------------------------
# the migration program
# ---------------------------------------------------------------------------
@governed("migrate_dev.device_migrate", budget=4)
def device_migrate(stacked, met_s, glo_d, labels, depth, KB: int, KV: int):
    """Apply the displaced partition on the device.

    ``glo_d``: [S, capP] int32 global vertex ids (-1 dead).
    ``labels``/``depth``: flood output [S, capT].
    ``KB``: max moved tets per shard (and max arrivals per shard);
    ``KV``: max new vertex rows per shard.

    Returns (stacked', met', glo_d', info) with info a dict of
      ok          0-d bool: every budget respected; when False the
                  outputs are UNDEFINED and the caller must fall back
      nmoved      0-d total moved tets
      arr_rows/arr_gids [S, KV] newly allocated vertex rows (-1 pad)
      dep_slots   [S, KB] departed tet slots (capT pad)
      arr_slots   [S, KB] arrival tet slots (capT pad)
      labels, dead_rows [S, KV] (capP pad), dead_cnt [S], ok_parts [6].
    The inputs are not written."""
    S, capT = stacked.tmask.shape
    capP = stacked.capP
    dev = stacked.device
    me = torch.arange(S, dtype=_I32, device=dev)[:, None]
    live = stacked.tmask
    nlive = live.sum(dim=1)

    # ---- donor floor: revert deepest flood layers first -----------------
    floor = torch.clamp(nlive // 2 + 1, max=6)
    moved0 = live & (labels != me)
    nmove0 = moved0.sum(dim=1)
    excess = torch.clamp(nmove0 - (nlive - floor), min=0)
    ordd = torch.sort(torch.where(moved0, -depth, INT32_MAX), dim=1,
                      stable=True).indices
    rank = torch.empty_like(ordd).scatter_(
        1, ordd, torch.arange(capT, device=dev).expand(S, capT))
    revert = moved0 & (rank < excess[:, None])
    labels = torch.where(revert, me, labels).to(_I32)
    moved = moved0 & ~revert
    nmove = moved.sum(dim=1)
    nmoved = nmove.sum()
    ok_kb = (nmove <= KB).all()

    # ---- band compaction + cross-shard pool -----------------------------
    midx = _compact(moved, KB, capT)
    mvalid = midx < capT
    mslot = midx.clamp(max=capT - 1)
    src2 = torch.arange(S, device=dev)[:, None].expand(S, KB)
    mdst = torch.where(mvalid, labels[src2, mslot], S).to(_I32)
    P = S * KB
    p_src = src2.reshape(P)
    p_slot = mslot.reshape(P)
    p_dst = mdst.reshape(P)
    # payload gathers (the band all-to-all of the sharded original)
    p_tet = stacked.tet[p_src, p_slot]                     # [P,4] local
    ptc = p_tet.clamp(0, capP - 1).long()
    ps4 = p_src[:, None].expand(P, 4)
    p_gt = glo_d[ps4, ptc]
    p_tref = stacked.tref[p_src, p_slot]
    p_ftag = stacked.ftag[p_src, p_slot]
    p_fref = stacked.fref[p_src, p_slot]
    p_etag = stacked.etag[p_src, p_slot]
    p_vert = stacked.vert[ps4, ptc]
    p_vtag = stacked.vtag[ps4, ptc]
    p_vref = stacked.vref[ps4, ptc]
    p_met = met_s[ps4, ptc]

    # sort the pool by destination -> contiguous per-recipient segments
    sdst, ordp = torch.sort(p_dst, stable=True)
    ar = torch.arange(S, dtype=sdst.dtype, device=dev)
    seg_start = torch.searchsorted(sdst, ar)
    seg_cnt = torch.searchsorted(sdst, ar, right=True) - seg_start
    ok_arr = (seg_cnt <= KB).all()
    win = seg_start[:, None] + torch.arange(KB, device=dev)  # [S,KB]

    def take_seg(arr):
        """[P, ...] sorted-pool array -> [S, KB, ...] per recipient (the
        pool padded by KB rows, so no segment window clamps)."""
        pad = torch.zeros((KB,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                          device=dev)
        return torch.cat([arr[ordp], pad])[win]

    avalid = torch.arange(KB, device=dev)[None, :] < seg_cnt[:, None]
    a_gt = torch.where(avalid[..., None], take_seg(p_gt), -1)
    a_tref = take_seg(p_tref)
    a_ftag = take_seg(p_ftag)
    a_fref = take_seg(p_fref)
    a_etag = take_seg(p_etag)
    a_vert = take_seg(p_vert)                              # [S,KB,4,3]
    a_vtag = take_seg(p_vtag)
    a_vref = take_seg(p_vref)
    a_met = take_seg(p_met)

    # ---- departures ------------------------------------------------------
    tmask1 = live & ~moved

    # ---- arrival vertex resolution by global id -------------------------
    # recipient's current gid -> row table (dead rows sort last)
    gkey = torch.where(glo_d >= 0, glo_d, INT32_MAX)
    gsorted, gord = torch.sort(gkey, dim=1, stable=True)
    A4 = KB * 4
    agid = a_gt.reshape(S, A4)
    a4valid = agid >= 0
    pos = torch.searchsorted(gsorted, torch.where(a4valid, agid, 0)
                             .contiguous())
    posc = pos.clamp(max=capP - 1)
    found = a4valid & (gsorted.gather(1, posc) == agid)
    found_row = gord.gather(1, posc)                       # [S,A4]

    # unique missing gids per shard: sort, head-detect, allocate
    mkey = torch.where(a4valid & ~found, agid, INT32_MAX)
    msort, mord = torch.sort(mkey, dim=1, stable=True)
    mhead = torch.ones((S, A4), dtype=torch.bool, device=dev)
    mhead[:, 1:] = msort[:, 1:] != msort[:, :-1]
    mhead = mhead & (msort != INT32_MAX)
    n_new = mhead.sum(dim=1)
    free_v = glo_d < 0
    fidx = _compact(free_v, KV, capP)
    nfree = free_v.sum(dim=1)
    ok_kv = (n_new <= KV).all()
    ok_free = (n_new <= nfree).all()
    seg_id = _row_cumsum(mhead) - 1                     # [S,A4]
    new_row_sorted = torch.where(
        mhead, fidx.gather(1, seg_id.clamp(0, KV - 1)), capP)
    # broadcast the head's row to its duplicates (same gid, same segment)
    head_row_of_seg = torch.full((S, A4 + 1), -1, dtype=torch.int64,
                                 device=dev).scatter_reduce(
        1, torch.where(mhead, seg_id, A4), new_row_sorted, "amax",
        include_self=True)
    row_sorted = head_row_of_seg.gather(1, seg_id.clamp(0, A4 - 1))
    # unsort back to arrival-corner order
    row_missing = torch.zeros_like(row_sorted).scatter_(1, mord, row_sorted)
    a_row = torch.where(found, found_row, row_missing)
    a_row = torch.where(a4valid, a_row, capP)

    # ---- scatter new vertex rows ----------------------------------------
    # payload source: the sorted head corners (first occurrence wins)
    tgt_new = torch.where(mhead, new_row_sorted, capP)     # [S,A4]
    vert2 = _set_rows(stacked.vert, tgt_new, _take(
        a_vert.reshape(S, A4, 3), mord))
    vtag2 = _set_rows(stacked.vtag, tgt_new,
                      a_vtag.reshape(S, A4).gather(1, mord))
    vref2 = _set_rows(stacked.vref, tgt_new,
                      a_vref.reshape(S, A4).gather(1, mord))
    met2 = _set_rows(met_s, tgt_new, _take(
        a_met.reshape((S, A4) + tuple(a_met.shape[3:])), mord))
    glo2 = _set_rows(glo_d, tgt_new, torch.where(mhead, msort, 0))

    # ---- place arrival tets in free slots -------------------------------
    tfree = _compact(~tmask1, KB, capT)
    nfree_t = (~tmask1).sum(dim=1)
    ok_slots = (seg_cnt <= nfree_t).all()
    arr_slot = torch.where(avalid, tfree, capT)            # [S,KB]
    lt = a_row.reshape(S, KB, 4).clamp(0, capP - 1)
    tet2 = _set_rows(stacked.tet, arr_slot, lt)
    tref2 = _set_rows(stacked.tref, arr_slot, a_tref)
    ftag2 = _set_rows(stacked.ftag, arr_slot, a_ftag)
    fref2 = _set_rows(stacked.fref, arr_slot, a_fref)
    etag2 = _set_rows(stacked.etag, arr_slot, a_etag)
    tmask2 = _set_rows(tmask1, arr_slot, True)

    # ---- liveness + watermarks ------------------------------------------
    ref = _mark(S, capP, torch.where(tmask2[..., None], tet2, capP), dev)
    glo2 = torch.where(ref, glo2, -1)
    rowsP = torch.arange(1, capP + 1, dtype=_I32, device=dev)
    npoin2 = torch.where(ref, rowsP, 0).max(dim=1).values
    rowsT = torch.arange(1, capT + 1, dtype=_I32, device=dev)
    nelem2 = torch.where(tmask2, rowsT, 0).max(dim=1).values

    out = dataclasses.replace(
        stacked, vert=vert2, vtag=vtag2, vref=vref2, vmask=ref,
        tet=tet2, tref=tref2, tmask=tmask2, ftag=ftag2, fref=fref2,
        etag=etag2, npoin=npoin2.to(_I32), nelem=nelem2.to(_I32))
    # newly-allocated vertex rows, compacted to [S, KV] for the host
    # numbering mirror
    alloc_tgt = torch.where(mhead, seg_id.clamp(0, KV - 1), KV)
    arr_rows = torch.full((S, KV + 1), -1, dtype=_I32, device=dev).scatter(
        1, alloc_tgt, new_row_sorted.to(_I32))[:, :KV]
    arr_gids = torch.full((S, KV + 1), -1, dtype=_I32, device=dev).scatter(
        1, alloc_tgt, msort.to(_I32))[:, :KV]
    # newly-DEAD vertex rows (id-carrying before, unreferenced after the
    # departures): the band-sized liveness delta of the host mirror
    # (migrate.kill_glo_rows); dying rows are vertices of departed tets,
    # so the KV budget bounds them too
    newly_dead = (glo_d >= 0) & ~ref
    n_dead = newly_dead.sum(dim=1)
    ok_dead = (n_dead <= KV).all()
    dead_rows = _compact(newly_dead, KV, capP).to(_I32)
    ok_parts = torch.stack([ok_kb, ok_arr, ok_kv, ok_free, ok_slots,
                            ok_dead])
    info = dict(ok=ok_parts.all(), nmoved=nmoved, arr_rows=arr_rows,
                arr_gids=arr_gids, dep_slots=midx.to(_I32),
                arr_slots=arr_slot.to(_I32), labels=labels,
                dead_rows=dead_rows, dead_cnt=n_dead.to(_I32),
                ok_parts=ok_parts)
    return out, met2, glo2.to(_I32), info


# ---------------------------------------------------------------------------
# exposed-face probe
# ---------------------------------------------------------------------------
def _face_triples(stacked, glo_d):
    """[S, capT*4, 3] sorted global-id triples of every face slot."""
    S, capT = stacked.tmask.shape
    capP = stacked.capP
    gtet = glo_d.gather(1, stacked.tet.clamp(0, capP - 1).long()
                        .reshape(S, -1)).reshape(S, capT, 4)
    tri = torch.sort(gtet[:, :, torch.as_tensor(IDIR, device=gtet.device)],
                     dim=-1).values
    return tri.reshape(S, capT * 4, 3)


@governed("migrate_dev.exposed_face_probe", budget=4)
def exposed_face_probe(stacked, glo_d, KF: int):
    """Per-shard exposed faces as global-id triples, compacted.

    Returns (keys [S, KF, 3] int32 sorted-gid triples (-1 pad),
             slots [S, KF] int32 4*tet+face (capT*4 pad),
             cnt [S] int32, ok 0-d bool)."""
    S, capT = stacked.tmask.shape
    n = capT * 4
    tri = _face_triples(stacked, glo_d)
    valid = stacked.tmask.repeat_interleave(4, dim=1)
    c = [torch.where(valid, tri[..., i], INT32_MAX) for i in range(3)]
    order = _lexsort_rows(*c)
    k0, k1, k2 = (x.gather(1, order) for x in c)
    eq_next = (k0[:, 1:] == k0[:, :-1]) & (k1[:, 1:] == k1[:, :-1]) & \
        (k2[:, 1:] == k2[:, :-1]) & (k0[:, :-1] != INT32_MAX)
    no = torch.zeros((S, 1), dtype=torch.bool, device=tri.device)
    same = torch.cat([eq_next, no], 1) | torch.cat([no, eq_next], 1)
    exposed = ~same & (k0 != INT32_MAX)
    cnt = exposed.sum(dim=1, dtype=_I32)
    sel = _compact(exposed, KF, n)
    selc = sel.clamp(max=n - 1)
    hit = sel < n
    keys = torch.stack([k0, k1, k2], -1).gather(
        1, selc[..., None].expand(S, KF, 3))
    keys = torch.where(hit[..., None], keys, -1).to(_I32)
    slots = torch.where(hit, order.gather(1, selc), n).to(_I32)
    return keys, slots, cnt, (cnt <= KF).all()


# ---------------------------------------------------------------------------
# freeze / unfreeze retag, fully on the device
# ---------------------------------------------------------------------------
def _freeze_bits_t(tags, is_edge_or_vert: bool):
    """Tensor mirror of ``migrate._freeze_bits`` (int32 tags, same
    bits)."""
    user_req = (tags & MG_REQ) != 0
    out = tags | PARBDY_TAGS
    if is_edge_or_vert:
        out = torch.where((tags & MG_BDY) != 0, out | MG_PARBDYBDY, out)
    return torch.where(user_req, out & ~MG_NOSURF, out)


def _unfreeze_bits_t(tags, is_edge_or_vert: bool):
    """Tensor mirror of ``migrate._unfreeze_bits``."""
    was = (tags & MG_PARBDY) != 0
    user_req = was & ((tags & MG_NOSURF) == 0) & ((tags & MG_REQ) != 0)
    true_bdy = was & ((tags & MG_PARBDYBDY) != 0)
    out = torch.where(was, tags & ~(PARBDY_TAGS | MG_PARBDYBDY), tags)
    if is_edge_or_vert:
        out = torch.where(true_bdy, out | MG_BDY, out)
    return torch.where(user_req, out | MG_REQ, out)


@governed("migrate_dev.retag_device", budget=2)
def retag_device(stacked, glo_d, ifc_slots, ifc_vrows):
    """Reconcile the freeze tags with the NEW interface, on the device.

    ``ifc_slots`` [S, KF2] int32 4*tet+face slots of the new interface
    (pad capT*4); ``ifc_vrows`` [S, KN] shared-vertex rows (pad capP).
    Faces / vertices: membership by slot / row.  Edges: every local slot
    of a geometric edge of any interface face (un)freezes: membership by
    a sort on the global edge keys and a segment OR."""
    S, capT = stacked.tmask.shape
    capP = stacked.capP
    dev = stacked.device
    tm = stacked.tmask

    # ---- faces ----
    slot_ifc = _mark(S, capT * 4, ifc_slots, dev).reshape(S, capT, 4)
    cur_f = ((stacked.ftag & MG_PARBDY) != 0) & tm[..., None]
    ftag = torch.where(slot_ifc & ~cur_f,
                       _freeze_bits_t(stacked.ftag, False), stacked.ftag)
    ftag = torch.where(cur_f & ~slot_ifc, _unfreeze_bits_t(ftag, False),
                       ftag)

    # ---- edges ----
    n6 = capT * 6
    gtet = glo_d.gather(1, stacked.tet.clamp(0, capP - 1).long()
                        .reshape(S, -1)).reshape(S, capT, 4)
    ev = torch.sort(gtet[:, :, torch.as_tensor(IARE, device=dev)],
                    dim=-1).values
    valid = tm.repeat_interleave(6, dim=1)
    ka = torch.where(valid, ev[..., 0].reshape(S, n6), INT32_MAX)
    kb = torch.where(valid, ev[..., 1].reshape(S, n6), INT32_MAX)
    # interface-edge markers: the 3 edges of every interface face
    mark = torch.zeros((S, capT, 6), dtype=torch.bool, device=dev)
    for f in range(4):
        for j in range(3):
            e = int(FACE_EDGES[f, j])
            mark[:, :, e] |= slot_ifc[:, :, f]
    mark = mark.reshape(S, n6) & valid
    ordj = _lexsort_rows(ka, kb)
    ka_s, kb_s = ka.gather(1, ordj), kb.gather(1, ordj)
    first = torch.ones((S, n6), dtype=torch.bool, device=dev)
    first[:, 1:] = (ka_s[:, 1:] != ka_s[:, :-1]) | (kb_s[:, 1:] !=
                                                     kb_s[:, :-1])
    seg = _row_cumsum(first) - 1
    tot = torch.zeros((S, n6), dtype=_I32, device=dev).scatter_reduce(
        1, seg, mark.gather(1, ordj).to(_I32), "amax", include_self=True)
    in_new = torch.zeros((S, n6), dtype=torch.bool, device=dev).scatter(
        1, ordj, tot.gather(1, seg) > 0).reshape(S, capT, 6)
    in_new = in_new & tm[..., None]
    cur = ((stacked.etag & MG_PARBDY) != 0) & tm[..., None]
    etag = torch.where(in_new & ~cur, _freeze_bits_t(stacked.etag, True),
                       stacked.etag)
    etag = torch.where(cur & ~in_new, _unfreeze_bits_t(etag, True), etag)

    # ---- vertices ----
    new_v = _mark(S, capP, ifc_vrows, dev)
    cur_v = ((stacked.vtag & MG_PARBDY) != 0) & stacked.vmask
    vtag = torch.where(new_v & ~cur_v, _freeze_bits_t(stacked.vtag, True),
                       stacked.vtag)
    vtag = torch.where(cur_v & ~new_v, _unfreeze_bits_t(vtag, True), vtag)
    return dataclasses.replace(stacked, ftag=ftag, etag=etag, vtag=vtag)


# ---------------------------------------------------------------------------
# band-scoped weld region probe
# ---------------------------------------------------------------------------
@governed("migrate_dev.band_region_probe", budget=4)
def band_region_probe(stacked, glo_d, seed_tets, KW: int, KWp: int):
    """Tets/vertices within one ring of the seed tet rows, compacted.

    ``seed_tets`` [S, KB] local tet slots (pad >= capT): the migration's
    arrival tets (their vertices span the whole band, including the old,
    now interior interface where the duplicate pairs live).  Returns
    (trow [S,KW], vrow [S,KWp], tcnt, vcnt, v_open [S,KWp] bool — vertex
    has an incident tet OUTSIDE the region (must not be welded away),
    ok)."""
    S, capT = stacked.tmask.shape
    capP = stacked.capP
    dev = stacked.device
    tm = stacked.tmask
    seed = torch.as_tensor(seed_tets, device=dev)
    seed_vids = torch.where((seed < capT)[..., None],
                            _take(stacked.tet, seed.clamp(0, capT - 1)),
                            capP)
    vmark = _mark(S, capP, seed_vids, dev)
    tc = stacked.tet.clamp(0, capP - 1).long().reshape(S, -1)

    def ring(vm):
        touch = vm.gather(1, tc).reshape(S, capT, 4).any(dim=2) & tm
        vm2 = _mark(S, capP, torch.where(touch[..., None], stacked.tet,
                                         capP), dev)
        return touch, vm | vm2

    _, vm1 = ring(vmark)
    touch2, vm2 = ring(vm1)
    vin = vm2 & stacked.vmask
    tcnt = touch2.sum(dim=1, dtype=_I32)
    vcnt = vin.sum(dim=1, dtype=_I32)
    ok = (tcnt <= KW).all() & (vcnt <= KWp).all()
    trow = _compact(touch2, KW, capT).to(_I32)
    vrow = _compact(vin, KWp, capP).to(_I32)
    # vertices with an incident tet outside the region stay frozen for
    # the weld (rewriting them would dangle the outside tets)
    vopen = _mark(S, capP, torch.where((tm & ~touch2)[..., None],
                                       stacked.tet, capP), dev)
    v_open = vopen.gather(1, vrow.clamp(0, capP - 1).long())
    return trow, vrow, tcnt, vcnt, v_open, ok


# ---------------------------------------------------------------------------
# the numbering
# ---------------------------------------------------------------------------
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
    rows = _compact(fresh, KN, capP)
    gids = (base[:, None] + torch.arange(KN, device=dev)).to(_I32)
    valid = rows < capP
    glo2 = _set_rows(glo_d, rows, torch.where(valid, gids, 0))
    # dead rows lose their id
    glo2 = torch.where(vmask, glo2, torch.full_like(glo2, -1))
    minus = torch.full_like(gids, -1)
    return (glo2, top + nf.sum(),
            torch.where(valid, rows, -1).to(_I32),
            torch.where(valid, gids, minus), ok)


def dead_glo_rows(glo_d, vmask, KD: int):
    """Compacted newly-dead vertex rows: rows that carry an id but whose
    liveness has dropped (collapses since the last mirror sync).
    Returns (rows [S, KD] int32 (pad capP), cnt [S] int32, ok (0-d
    bool)); ok False = budget overflow, the caller takes the host path."""
    capP = glo_d.shape[1]
    dead = (glo_d >= 0) & ~vmask
    cnt = dead.sum(dim=1, dtype=_I32)
    return _compact(dead, KD, capP).to(_I32), cnt, (cnt <= KD).all()


def session_ids_fit(top: int, n_shards: int, KN: int) -> bool:
    """Whether this pass's fresh-id block provably fits the int32 device
    numbering: :func:`extend_ids_device` hands out at most ``n_shards *
    KN`` ids from ``top``, and the counter must never wrap int32."""
    return int(top) + int(n_shards) * int(KN) < 2 ** 31


def has_multiway_face_run(eq: np.ndarray) -> bool:
    """True when the sorted exposed-face keys contain a run of length
    > 2 — a global-id triple exposed by 3+ shards (non-manifold parallel
    face).  ``eq`` is the consecutive-equality mask of the lexsorted
    keys; two adjacent True entries mean three equal keys.  The
    consecutive-pair linking of :func:`band_migrate_iteration` would
    double-link the middle slot, so the caller falls back to the
    full-view path for that iteration."""
    return eq.size > 1 and bool(np.any(eq[1:] & eq[:-1]))


# ---------------------------------------------------------------------------
# host orchestration: one O(band + interface) migration iteration
# ---------------------------------------------------------------------------
def band_migrate_iteration(stacked, met_s, glo_d, glo: list[np.ndarray],
                           labels_d, depth_d, shared_prev: np.ndarray,
                           n_shards: int, verbose: int = 0):
    """Run device_migrate + the interface rebuild with band-sized host
    work.

    ``glo_d``: [S, capP] int32 device numbering (in lockstep with the host
    ``glo`` mirror); ``shared_prev``: gids shared across shards before
    this migration (candidates for the incremental shared-vertex update:
    a gid can only BECOME shared through a band arrival).

    Returns (stacked, met_s, glo_d, comms, shared_now, nmoved, arr_slots)
    or None when a device budget overflowed: the caller then falls back
    to the full-view path with its inputs, which this function leaves
    untouched (the host mirror too)."""
    from .comms import pad_comm_tables
    from .migrate import apply_fresh_ids, kill_glo_rows
    from .pod import gather_band
    S = n_shards
    capT = stacked.capT
    capP = stacked.capP
    dev = stacked.device
    # a 2-layer advancing front can move a large fraction of a donor and
    # concentrate on one recipient: the band budget scales with capacity
    # (so a grow retry raises it), not with a fixed floor
    KB = max(256, capT // 2)
    KV = max(256, capP // 2)
    KF = max(512, capT // 2)

    stacked2, met2, glo_d2, info = device_migrate(
        stacked, met_s, glo_d, labels_d, depth_d, KB=KB, KV=KV)
    ok = bool(info["ok"])
    nmoved = int(info["nmoved"])
    if not ok:
        if verbose >= 1:
            names = ("nmove<=KB", "arrivals<=KB", "new_v<=KV",
                     "new_v<=free_v", "arrivals<=free_t", "dead<=KV")
            parts = info["ok_parts"].tolist()
            bad = [n for n, p in zip(names, parts) if not p]
            otrace.log(1, f"  band migrate overflow: {bad}",
                       verbose=verbose)
        return None
    if nmoved == 0:
        return stacked2, met2, glo_d2, None, shared_prev, 0, None

    # ---- exposed-face probe (budget-checked BEFORE any mirror mutation:
    # the fallback must find the numbering untouched) ---------------------
    keys, slots, cnt, okf = exposed_face_probe(stacked2, glo_d2, KF=KF)
    if not bool(okf):
        return None

    # ---- cross-shard face match ------------------------------------------
    keys, slots, cnt = gather_band(keys, slots, cnt, what="faces")
    ks, sl, sh = [], [], []
    for s in range(S):
        n = int(cnt[s])
        ks.append(keys[s][:n])
        sl.append(slots[s][:n])
        sh.append(np.full(n, s, np.int32))
    K = np.concatenate(ks) if ks else np.zeros((0, 3), np.int32)
    SL = np.concatenate(sl)
    SH = np.concatenate(sh)
    order = np.lexsort((K[:, 2], K[:, 1], K[:, 0]))
    Ks, SLs, SHs = K[order], SL[order], SH[order]
    eq = (Ks[1:] == Ks[:-1]).all(1)
    if has_multiway_face_run(eq):
        return None

    # ---- host glo mirror sync (arrivals + newly-dead delta), after the
    # pairing guard: a None return above leaves the mirror untouched ----
    arr_rows, arr_gids, dead_rows, dead_cnt, arr_slots = gather_band(
        info["arr_rows"], info["arr_gids"], info["dead_rows"],
        info["dead_cnt"], info["arr_slots"], what="migrate_glo")
    apply_fresh_ids(glo, arr_rows, arr_gids)
    kill_glo_rows(glo, dead_rows, dead_cnt)

    pair = np.concatenate([eq, [False]])
    iA = np.where(pair)[0]
    iB = iA + 1
    face_lists = [[[] for _ in range(S)] for _ in range(S)]
    ifc_face_slots = [[] for _ in range(S)]
    for a, b, sa, sb in zip(SHs[iA], SHs[iB], SLs[iA], SLs[iB]):
        a, b = int(a), int(b)
        face_lists[a][b].append(int(sa))
        face_lists[b][a].append(int(sb))
        ifc_face_slots[a].append(int(sa))
        ifc_face_slots[b].append(int(sb))

    # ---- incremental shared-vertex update -------------------------------
    # candidates: previously shared ∪ band-arrival gids ∪ interface-face
    # endpoint gids (the only routes by which a gid can become shared)
    endp = Ks[iA].reshape(-1).astype(np.int64)
    cands = np.unique(np.concatenate(
        [shared_prev.astype(np.int64),
         arr_gids[arr_gids >= 0].astype(np.int64), endp]))
    rows_per = []
    live_per = []
    for s in range(S):
        o = np.argsort(glo[s], kind="stable")
        gs = glo[s][o]
        lo = np.searchsorted(gs, cands)
        loc = np.clip(lo, 0, len(gs) - 1)
        hit = (gs[loc] == cands) & (cands >= 0)
        row = np.where(hit, o[loc], -1)
        # liveness IS the id hit: glo >= 0 only at live rows
        live = hit & (row >= 0)
        rows_per.append(np.where(live, row, -1))
        live_per.append(live)
    nliv = np.sum(live_per, axis=0)
    shared = nliv >= 2
    shared_now = cands[shared]
    owner_of = np.full(len(cands), -1, np.int32)
    for s in range(S):
        owner_of[live_per[s]] = s          # ascending: max rank wins
    node_lists = [[[] for _ in range(S)] for _ in range(S)]
    ifc_vert_rows = [[] for _ in range(S)]
    owner = [np.full(capP, s, np.int32) for s in range(S)]
    sh_idx = np.where(shared)[0]           # ascending gid order (A.4)
    for s in range(S):
        rows_s = rows_per[s][sh_idx]
        here = rows_s >= 0
        ifc_vert_rows[s] = [int(r) for r in rows_s[here]]
        owner[s][rows_s[here]] = owner_of[sh_idx][here]
    for ci in sh_idx:
        holders = [s for s in range(S) if live_per[s][ci]]
        for i in range(len(holders)):
            for j in range(i + 1, len(holders)):
                a, b = holders[i], holders[j]
                node_lists[a][b].append(int(rows_per[a][ci]))
                node_lists[b][a].append(int(rows_per[b][ci]))

    comms = pad_comm_tables(node_lists, face_lists, owner, S)

    # ---- retag on the device (bucketed table widths, the JAX package's
    # compile-governor shapes) ---------------------------------------------
    KF2 = bucket(max(len(x) for x in ifc_face_slots), floor=256,
                 scheme="pow2")
    KN = bucket(max(len(x) for x in ifc_vert_rows), floor=256,
                scheme="pow2")
    slots_d = np.full((S, KF2), capT * 4, np.int32)
    vrows_d = np.full((S, KN), capP, np.int32)
    for s in range(S):
        slots_d[s, :len(ifc_face_slots[s])] = ifc_face_slots[s]
        vrows_d[s, :len(ifc_vert_rows[s])] = ifc_vert_rows[s]
    stacked2 = retag_device(stacked2, glo_d2,
                            torch.as_tensor(slots_d, device=dev),
                            torch.as_tensor(vrows_d, device=dev))
    otrace.log(2, f"  band migration: moved {nmoved} tets, "
                  f"{len(iA)} interface faces, "
                  f"{int(shared.sum())} shared vertices "
                  "(device path)", verbose=verbose)
    return (stacked2, met2, glo_d2, comms, shared_now, nmoved,
            arr_slots)


def band_weld(stacked, met_s, glo_d, glo: list[np.ndarray],
              arr_slots: np.ndarray, n_shards: int, verbose: int = 0):
    """Region-scoped near-duplicate weld after a band migration.

    Pulls only the one-ring neighbourhood of the arrival vertices of every
    recipient shard and runs the sequential weld there
    (``distribute._weld_close_pairs``); vertices with incident tets
    outside the region are poisoned, so the weld cannot dangle outside
    references.  Returns (stacked, glo_d, nweld), nweld -1 when the
    region budget cannot hold (the caller's full-weld signal)."""
    from .distribute import _weld_close_pairs
    from .pod import gather_band
    S = n_shards
    capT = stacked.capT
    capP = stacked.capP
    dev = stacked.device
    KW = max(512, capT // 2)
    KWp = max(512, capP // 2)
    seed = torch.as_tensor(np.ascontiguousarray(arr_slots), device=dev)
    while True:
        trow, vrow, tcnt, vcnt, v_open, ok = band_region_probe(
            stacked, glo_d, seed, KW=KW, KWp=KWp)
        if bool(ok):
            break
        if KW >= capT and KWp >= capP:
            return stacked, glo_d, -1
        # the probe budget is a compaction table, not a capacity: a big
        # arrival neighbourhood just needs a wider table
        KW = min(capT, KW * 2)
        KWp = min(capP, KWp * 2)
    trow_d, vrow_d = trow, vrow
    trow, vrow, tcnt, vcnt, v_open = gather_band(
        trow, vrow, tcnt, vcnt, v_open, what="weld_probe")
    # one region gather on the device, one band exchange of its tables
    tr_c = trow_d.clamp(0, capT - 1)
    vr_c = vrow_d.clamp(0, capP - 1)
    tet_r, tref_r, ftag_r, etag_r, vert_r, vtag_r, met_r = gather_band(
        _take(stacked.tet, tr_c), _take(stacked.tref, tr_c),
        _take(stacked.ftag, tr_c), _take(stacked.etag, tr_c),
        _take(stacked.vert, vr_c), _take(stacked.vtag, vr_c),
        _take(met_s, vr_c), what="weld_region")
    tet_d = tmask_d = vmask_d = None
    glo_d_out = glo_d
    ntot = 0
    for s in range(S):
        nt, nv = int(tcnt[s]), int(vcnt[s])
        if nt == 0 or nv == 0:
            continue
        vr_s = vrow[s][:nv]
        l2r = np.full(capP, -1, np.int64)
        l2r[vr_s] = np.arange(nv)
        tloc = l2r[tet_r[s][:nt]]
        if (tloc < 0).any():        # ring closure failed: skip the shard
            continue
        vtag_s = vtag_r[s][:nv].copy()
        vtag_s[v_open[s][:nv]] |= np.int32(-0x80000000)   # poison
        tet2, vkeep, tkeep = _weld_close_pairs(
            vert_r[s][:nv], tloc.astype(np.int32), vtag_s,
            met_r[s][:nv], tref_r[s][:nt], ftag_r[s][:nt],
            etag_r[s][:nt])
        if vkeep.all() and tkeep.all() and np.array_equal(tet2, tloc):
            continue
        ntot += int((~vkeep).sum())
        if tet_d is None:
            tet_d = stacked.tet.clone()
            tmask_d = stacked.tmask.clone()
            vmask_d = stacked.vmask.clone()
            glo_d_out = glo_d.clone()
        chg = np.where(np.any(tet2 != tloc, axis=1) | ~tkeep)[0]
        rows_g = torch.as_tensor(trow[s][chg].astype(np.int64), device=dev)
        tet_g = vr_s[np.clip(tet2[chg], 0, nv - 1)].astype(np.int32)
        tet_d[s, rows_g] = torch.as_tensor(tet_g, device=dev)
        dead_t = trow[s][np.where(~tkeep)[0]]
        if len(dead_t):
            tmask_d[s, torch.as_tensor(dead_t.astype(np.int64),
                                       device=dev)] = False
        dead_v = vr_s[np.where(~vkeep)[0]]
        if len(dead_v):
            dv = torch.as_tensor(dead_v.astype(np.int64), device=dev)
            vmask_d[s, dv] = False
            glo[s][dead_v] = -1
            # the DEVICE numbering drops the welded gids too: the next
            # adapt cycles run before extend_ids_device and can reuse
            # these slots, and a stale gid there would resurrect under
            # the old identity
            glo_d_out[s, dv] = -1
    if ntot == 0:
        return stacked, glo_d_out, 0
    otrace.log(2, f"  band weld: {ntot} near-duplicate pairs "
                  "contracted", verbose=verbose)
    out = dataclasses.replace(stacked, tet=tet_d, tmask=tmask_d,
                              vmask=vmask_d)
    return out, glo_d_out, ntot


# ---------------------------------------------------------------------------
# flood-label contiguity / reachability repair
# ---------------------------------------------------------------------------
# The flood propagates colours by vertex priorities, so each colour region
# is vertex-connected to its seeds by construction; but priority ties can
# cut a region off its front (an unreachable moving blob), and two fronts
# meeting can enclose an unflooded pocket of retained tets.  ParMmg
# repairs exactly these on the displaced partition: sub-blob merge
# (moveinterfaces_pmmg.c:475-626) and destination reachability
# (:627-720).  Here both run on a band-sized compacted probe (moving tets
# + their retained 1-ring).

def _band_of(stacked, labels):
    """(moving, band) [S, capT]: the tets leaving their shard, and those
    plus their retained face neighbours."""
    S, capT = stacked.tmask.shape
    me = torch.arange(S, dtype=_I32, device=stacked.device)[:, None]
    tm = stacked.tmask
    moving = tm & (labels != me)
    nbrc = (stacked.adja >> 2).clamp(0, capT - 1).long().reshape(S, -1)
    has = (stacked.adja >= 0) & tm[..., None]
    nbr_mov = has & moving.gather(1, nbrc).reshape(S, capT, 4)
    ring = tm & ~moving & nbr_mov.any(dim=2)
    return moving, moving | ring


@governed("migrate_dev.flood_band_counts", budget=4)
def flood_band_counts(stacked, labels, n_shards: int):
    """[S] int32: band size (moving + retained 1-ring) of every shard."""
    return _band_of(stacked, labels)[1].sum(dim=1, dtype=_I32)


@governed("migrate_dev.flood_probe", budget=4)
def flood_probe(stacked, labels, depth, n_shards: int, KB: int):
    """The band of every shard, compacted to ``KB`` rows: (cnt [S], rows
    [S, KB] (capT pad), their labels (-1 pad), depths (0 pad), tets
    [S, KB, 4] (-1 pad), out_touch [S, KB]: the row holds a vertex of a
    retained tet outside the band)."""
    S, capT = stacked.tmask.shape
    capP = stacked.capP
    dev = stacked.device
    tm = stacked.tmask
    _, band = _band_of(stacked, labels)
    cnt = band.sum(dim=1, dtype=_I32)
    rows = _compact(band, KB, capT)
    rv = rows < capT
    rc = rows.clamp(max=capT - 1)
    # vertices held by a retained tet OUTSIDE the band: a ring component
    # with no such vertex is an enclosed island
    vout = _mark(S, capP, torch.where((tm & ~band)[..., None],
                                      stacked.tet, capP), dev)
    row_tet = torch.where(rv[..., None], _take(stacked.tet, rc), 0)
    out_touch = vout.gather(1, row_tet.clamp(0, capP - 1).long()
                            .reshape(S, -1)).reshape(S, KB, 4).any(dim=2)
    return (cnt, rows.to(_I32),
            torch.where(rv, labels.gather(1, rc), -1),
            torch.where(rv, depth.gather(1, rc), 0),
            torch.where(rv[..., None], row_tet, -1),
            out_touch & rv)


@governed("migrate_dev.apply_label_fixes", budget=4)
def _apply_label_fixes(labels, rows, newlab):
    capT = labels.shape[1]
    tgt = torch.where((rows >= 0) & (rows < capT) & (newlab >= 0), rows,
                      capT)
    return _set_rows(labels, tgt, torch.where(newlab >= 0, newlab, 0))


def _vertex_components(rtet: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """Connected components (by shared vertex) among the selected rows.

    Returns [n] int component id (-1 on unselected rows): min-label
    propagation over the (row, vertex) incidence, O(band x diameter)
    numpy passes."""
    n = rtet.shape[0]
    rows = np.repeat(np.arange(n), rtet.shape[1])
    verts = rtet.reshape(-1)
    keep = (verts >= 0) & sel[rows]
    rows, verts = rows[keep], verts[keep]
    if not len(rows):
        return np.full(n, -1, np.int64)
    uv, vid = np.unique(verts, return_inverse=True)
    comp = np.where(sel, np.arange(n), n).astype(np.int64)
    for _ in range(64):                    # >> any real blob diameter
        vmin = np.full(len(uv), n, np.int64)
        np.minimum.at(vmin, vid, comp[rows])
        new_c = comp.copy()
        np.minimum.at(new_c, rows, vmin[vid])
        if (new_c == comp).all():
            break
        comp = new_c
    comp[~sel] = -1
    return comp


def repair_flood_labels(stacked, labels_d, depth_d, n_shards: int,
                        verbose: int = 0):
    """Contiguity + reachability repair on the flood-displaced labels.

    - an unreachable moving blob (a same-colour vertex-connected
      component with no depth-1 member, cut off its seed front by colour
      competition) reverts to its owner;
    - an enclosed retained pocket (a ring component touching no retained
      tet outside the band) joins the surrounding moving colour (majority
      among vertex-adjacent moving rows).

    Returns (labels_d, nfixed).  ParMmg: moveinterfaces_pmmg.c:475-626
    (fix_contiguity) and :627-720 (check_reachability)."""
    from .pod import gather_band
    cnts = gather_band(flood_band_counts(stacked, labels_d, n_shards),
                       what="flood_counts")
    if int(cnts.max()) == 0:
        return labels_d, 0
    capT = stacked.capT
    KB = bucket(int(cnts.max()), floor=1024, cap=capT, scheme="pow2")
    cnt, rows, lab, dep, rtet, out_touch = gather_band(
        *flood_probe(stacked, labels_d, depth_d, n_shards, KB),
        what="flood_probe")
    new_lab = np.full((n_shards, KB), -1, np.int32)
    nfixed = 0
    for s in range(n_shards):
        n = int(cnt[s])
        if n == 0:
            continue
        lab_s = np.array(lab[s][:n])
        dep_s = dep[s][:n]
        rtet_s = rtet[s][:n]
        touch_s = out_touch[s][:n]
        fixed_s = np.zeros(n, bool)
        # --- moving blobs: same-colour components need a depth-1 seed ---
        for c in np.unique(lab_s):
            c = int(c)
            if c == s or c < 0:
                continue
            selc = lab_s == c
            comp = _vertex_components(rtet_s, selc)
            for cid in np.unique(comp[selc]):
                mem = comp == cid
                if not (dep_s[mem] == 1).any():
                    lab_s[mem] = s              # revert: unreachable
                    fixed_s |= mem
        # --- retained pockets: ring components with no outside anchor --
        selr = lab_s == s
        comp = _vertex_components(rtet_s, selr)
        rows_i = np.repeat(np.arange(n), rtet_s.shape[1])
        verts_i = rtet_s.reshape(-1)
        vok = verts_i >= 0
        rows_i, verts_i = rows_i[vok], verts_i[vok]
        mov_i = (lab_s[rows_i] != s) & (lab_s[rows_i] >= 0)
        for cid in np.unique(comp[selr]):
            mem = comp == cid
            if touch_s[mem].any():
                continue                        # anchored to the interior
            vset = np.unique(verts_i[mem[rows_i]])
            nbr = mov_i & np.isin(verts_i, vset)
            if not nbr.any():
                continue
            vals, freq = np.unique(lab_s[rows_i[nbr]],
                                   return_counts=True)
            lab_s[mem] = int(vals[np.argmax(freq)])
            fixed_s |= mem
        if fixed_s.any():
            new_lab[s, :n][fixed_s] = lab_s[fixed_s]
            nfixed += int(fixed_s.sum())
    if nfixed == 0:
        return labels_d, 0
    otrace.log(2, f"  flood repair: relabeled {nfixed} band tets "
                  "(contiguity/reachability)", verbose=verbose)
    dev = labels_d.device
    labels_d = _apply_label_fixes(labels_d, torch.as_tensor(rows,
                                                            device=dev),
                                  torch.as_tensor(new_lab, device=dev))
    return labels_d, nfixed


# ---------------------------------------------------------------------------
# graph-balancing labels from device-compacted tables
# ---------------------------------------------------------------------------
# ParMmg's graph mode gathers ONLY the group graph to rank 0 and runs
# METIS on it (metis_pmmg.c:845-1550).  Here the cluster assignment, the
# cluster weights, the intra-shard cluster adjacency (from adja) and the
# interface-slot cluster ids are computed on the device, and only
# O(S*G^2 + interface) tables reach the host.

@governed("migrate_dev.graph_probe", budget=4)
def graph_probe(stacked, face_idx, n_shards: int, G: int):
    """Per shard: morton cluster id per live tet [S, capT], live count
    [S], cluster weights [S, G], intra-shard cluster-pair face counts
    [S, G*G], and the cluster id at each comm face slot [S, K, I]."""
    from ..ops.edges import morton_codes
    capP, capT = stacked.capP, stacked.capT
    dev = stacked.device
    face_idx = torch.as_tensor(face_idx, device=dev)
    out = []
    for s in range(n_shards):
        tm = stacked.tmask[s]
        tet = stacked.tet[s]
        adja = stacked.adja[s]
        p = stacked.vert[s][tet.clamp(0, capP - 1).long()]    # [T,4,3]
        cent = (((p[:, 0] + p[:, 1]) + p[:, 2]) + p[:, 3]) / 4.0
        code = morton_codes(cent, tm, bits=10)
        key = torch.where(tm, code, INT32_MAX)
        order = torch.sort(key, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(capT, device=dev))
        nlive = tm.sum(dtype=_I32)
        # equal-count chunks along the curve = the redistribution groups
        clus = torch.clamp((rank * G) // torch.clamp(nlive, min=1), 0,
                           G - 1)
        clus = torch.where(tm, clus, 0).to(_I32)
        cw = torch.bincount(torch.where(tm, clus, G).long(),
                            minlength=G + 1)[:G].to(_I32)
        # intra-shard cluster adjacency from adja (cross-shard faces are
        # adja = -1 at the frozen interface and counted via the comms)
        nb = adja >> 2
        nbrt = nb.clamp(0, capT - 1).long()
        tid = torch.arange(capT, dtype=_I32, device=dev)[:, None]
        own = (adja >= 0) & tm[:, None] & (tid < nb) & tm[nbrt]
        ci = clus[:, None].expand(capT, 4)
        cj = clus[nbrt]
        cross = own & (ci != cj)
        pk = torch.where(cross, torch.minimum(ci, cj) * G +
                         torch.maximum(ci, cj), G * G)
        pcnt = torch.bincount(pk.reshape(-1).long(),
                              minlength=G * G + 1)[:G * G].to(_I32)
        fidx = face_idx[s]
        ft = torch.div(fidx, 4, rounding_mode="floor").clamp(0, capT - 1)
        cif = torch.where(fidx >= 0, clus[ft.long()], -1)
        out.append((clus, nlive, cw, pcnt, cif))
    return tuple(torch.stack(x) for x in zip(*out))


def _labels_from_parts(clus, tmask, new_part, n_shards: int):
    """[S, capT] int32: the new shard of every live tet's cluster (its
    own shard on dead slots)."""
    G = new_part.shape[0] // n_shards
    me = torch.arange(n_shards, dtype=_I32, device=clus.device)[:, None]
    lab = new_part[(me * G + clus).long()]
    return torch.where(tmask, lab, me).to(_I32)


def graph_repartition_labels_band(stacked, comms, n_shards: int,
                                  clusters_per_shard: int = 8,
                                  verbose: int = 0):
    """Graph-balancing labels on the device: [S, capT] target shard of
    every tet, from O(S*G^2 + interface) host tables only (the algorithm
    of ``migrate.graph_repartition_labels`` without the full views
    pull), or None when no cluster graph exists."""
    from .partition import refine_partition
    from .pod import gather_band
    S, G = n_shards, clusters_per_shard
    # the comm-table pad shape on the tables' own ladders (geo / 64
    # items, pow2 / 2 neighbours), as the JAX package buckets it
    fi = comms.face_idx
    If = bucket(fi.shape[2], floor=64, scheme="geo")
    Kn = bucket(fi.shape[1], floor=2, scheme="pow2",
                cap=max(fi.shape[1], n_shards - 1))
    if (Kn, If) != fi.shape[1:]:
        fi2 = np.full((fi.shape[0], Kn, If), -1, fi.dtype)
        fi2[:, :fi.shape[1], :fi.shape[2]] = fi
        fi = fi2
    clus, nlive, cw, pcnt, cif = graph_probe(
        stacked, np.ascontiguousarray(fi), S, G)
    cw, pcnt, cif = gather_band(cw, pcnt, cif, what="graph")
    nclu = S * G
    pi, pj, w = [], [], []
    for s in range(S):
        mat = pcnt[s]
        nz = np.where(mat > 0)[0]
        if len(nz):
            pi.append(s * G + nz // G)
            pj.append(s * G + nz % G)
            w.append(mat[nz].astype(float))
    # interface edges: the comm tables are ordered identically on both
    # sides of a pair, so zipping the two shards' slot-cluster rows gives
    # the cross-shard cluster pairs
    nbr = comms.nbr
    fcnt = comms.face_cnt
    for s in range(S):
        for k in range(nbr.shape[1]):
            b = int(nbr[s, k])
            if b <= s:
                continue
            n_items = int(fcnt[s, k])
            if n_items == 0:
                continue
            kb = int(np.where(nbr[b] == s)[0][0])
            ca = cif[s, k, :n_items]
            cb = cif[b, kb, :n_items]
            okm = (ca >= 0) & (cb >= 0)
            key = (s * G + ca[okm]).astype(np.int64) * nclu + \
                (b * G + cb[okm])
            uk, cnts = np.unique(key, return_counts=True)
            pi.append((uk // nclu).astype(np.int64))
            pj.append((uk % nclu).astype(np.int64))
            w.append(cnts.astype(float))
    if not pi:
        return None
    pi = np.concatenate(pi)
    pj = np.concatenate(pj)
    w = np.concatenate(w)
    init = np.repeat(np.arange(S, dtype=np.int32), G)
    new_part = refine_partition(init, S, (pi, pj), w,
                                elem_w=cw.reshape(-1).astype(float),
                                npasses=5)
    nmv = int((new_part != init).sum())
    otrace.log(2, f"  graph band labels: {nmv}/{nclu} clusters "
                  "reassigned", verbose=verbose)
    return _labels_from_parts(clus, stacked.tmask,
                              torch.as_tensor(new_part, device=clus.device),
                              S)
