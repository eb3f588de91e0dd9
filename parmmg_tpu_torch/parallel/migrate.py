"""Shard-to-shard interface migration between distributed passes, and
the host mirrors of the shard state (port of ``parallel/migrate.py``).

ParMmg displaces the group interfaces between outer iterations by moving
only the affected groups with third-party communicator repair
(``PMMG_part_moveInterfaces`` moveinterfaces_pmmg.c:1306,
``PMMG_transfer_all_grps`` distributegrps_pmmg.c:1631-1841).  Here:

- **labels on the device** (:func:`flood_labels`): the bigger shard's
  colour invades the smaller across the frozen interface, ``nlayers``
  tet-ball waves (PMMG_get_ifcDirection / PMMG_mark_boulevolp), over the
  stacked shard axis.  One scatter-max seeds the neighbours' priorities at
  the interface vertices from the comm tables; each wave is a gather and
  a scatter-max into a dump row (a max is order-independent, so the card
  gives the same labels on every run).
- **the full-view path** (:func:`migrate_shards` +
  :func:`weld_shard_bands`): host views of every shard, band packages
  moved by global id, the interface rebuilt from the views and the
  freeze / unfreeze retag, then sparse writes to the device.  It is the
  fallback when a band budget of ``migrate_dev.py`` overflows, and the
  band path's correctness oracle.
- :func:`rebuild_shards`: adjacency and boundary tags of every shard
  after a migration (K7 + K8 through ``build_adjacency``'s face sort).
- **graph mode** (:func:`graph_repartition_labels`): morton clusters of
  every shard, their adjacency graph from one face sort keyed by global
  ids, and the cluster -> shard map rebalanced by
  ``partition.refine_partition`` (the metis_pmmg.c:845-1550 role).

The persistent global numbering (``glo``: per shard, the global id of
every vertex row, -1 at dead or unnumbered rows) keys all of it:
split-time ids for the input vertices, fresh ids for the vertices an
adapt pass creates (shard-private by the freeze contract, so a disjoint
id block a shard is exact), the ids of dead rows dropped.  The device
path assigns the fresh ids (``migrate_dev.py``) and ships band-sized
tables of them and of the newly-dead rows to the host mirror;
:func:`extend_global_ids_from_vmask` is the host path, from the liveness
masks, when the device budgets miss.

Tags are int32 tensors in the port; the host arithmetic works on their
uint32 views, so every mask keeps the JAX package's bits.  No write goes
into an input tensor: every device update writes a copy, so that a
caller's fallback still holds the state it passed in.

Known deviations from ParMmg (as in the JAX package): no contiguity
repair on this path's labels beyond ``migrate_dev.repair_flood_labels``,
and the donor floor ``ne_min`` reverts the deepest flood layer first
rather than the reference's first-come order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import (IARE, IDIR, MG_BDY, MG_NOSURF, MG_PARBDY,
                              MG_PARBDYBDY, MG_REQ, PARBDY_TAGS)
from ..obs import trace as otrace
from ..utils.compilecache import governed
from .comms import InterfaceComms

_SIZE_CLAMP = 1 << 22   # priority = min(size, clamp) * S + colour stays int32
_U32 = np.uint32


# ---------------------------------------------------------------------------
# device-side advancing-front labels
# ---------------------------------------------------------------------------
def _scatter_max(dst, idx, vals):
    """``dst`` [S, n + 1] with ``vals`` [S, m] max-scattered at ``idx``
    [S, m] (an index n lands in the dump column)."""
    return dst.scatter_reduce(1, idx.long(), vals, "amax", include_self=True)


@governed("migrate.flood_labels", budget=2)
def flood_labels(stacked, node_idx, nbr, sizes, n_shards: int,
                 nlayers: int = 2):
    """([L, capT] int32 target shard of every tet, [L, capT] int32 flood
    depth: the wave at which the tet flipped, 0 = kept) of the L shards
    this rank holds.  Garbage on dead slots.  ``node_idx`` / ``nbr`` are
    the comm tables of every shard, ``sizes`` [S] the live tets of every
    shard: a wave's scatter-max runs on the rank's own shards, and what
    it knows of the other shards is their sizes and the comm tables.

    Priority of colour c = (tet count of shard c, c) lexicographic,
    packed into one int32 (sizes clamped at 2^22: beyond that 'bigger' is
    a tie and the id breaks it).  A tet flips to the strongest colour at
    its corners when that colour beats its own; flipped tets push their
    colour to their corners, one tet-ball layer a wave."""
    from . import pod
    S = n_shards
    L = stacked.ngroups                  # the shards this rank holds
    dev = stacked.device
    capP, capT = stacked.capP, stacked.capT
    node_idx = torch.as_tensor(pod.local(node_idx), device=dev)
    nbr = torch.as_tensor(pod.local(nbr), device=dev)
    sizes = torch.as_tensor(sizes, device=dev).to(torch.int32)

    def pri_of(c):
        return torch.clamp(sizes[c.clamp(0, S - 1).long()],
                           max=_SIZE_CLAMP) * S + c

    me = pod.shard_ids(L, dev)
    neg = torch.full((L, 1), -1, dtype=torch.int32, device=dev)
    vpri = torch.cat([torch.where(stacked.vmask, pri_of(me)[:, None],
                                  torch.full_like(stacked.vtag, -1)), neg],
                     dim=1)                                  # [L, capP+1]
    # seed: every interface vertex sees the priorities of the OTHER
    # shards that share it (static knowledge of the node comm tables)
    I = node_idx.shape[2]
    idx = node_idx.reshape(L, -1)
    nb_pri = torch.where(nbr >= 0, pri_of(nbr), -1).to(torch.int32)
    nb_pri = nb_pri.repeat_interleave(I, dim=1)
    safe = torch.where((idx >= 0) & (nb_pri >= 0), idx, capP)
    vpri = _scatter_max(vpri, safe, nb_pri)
    label = me[:, None].expand(L, capT).clone()
    depth = torch.zeros((L, capT), dtype=torch.int32, device=dev)
    tm = stacked.tmask
    tc = stacked.tet.clamp(0, capP - 1).long().reshape(L, -1)
    tgt = torch.where(tm[..., None], stacked.tet, capP).reshape(L, -1)
    for w in range(nlayers):
        corner = torch.gather(vpri, 1, tc).reshape(L, capT, 4)
        tp = corner.max(dim=2).values
        better = tm & (tp > pri_of(label))
        label = torch.where(better, tp % S, label).to(torch.int32)
        depth = torch.where(better, w + 1, depth).to(torch.int32)
        # propagate the flipped colour to the tet's corners
        lp = torch.where(tm, pri_of(label), -1).to(torch.int32)
        vpri = _scatter_max(vpri, tgt, lp.repeat_interleave(4, dim=1))
    return label, depth


# ---------------------------------------------------------------------------
# freeze / unfreeze tag semantics (numpy, applied to selected slots)
# ---------------------------------------------------------------------------
def _freeze_bits(tags: np.ndarray, is_edge_or_vert: bool) -> np.ndarray:
    """Interface freeze (split_to_shards contract; tag_pmmg.c:39-124) of
    uint32 tags."""
    out = tags.copy()
    user_req = (out & MG_REQ) != 0
    true_bdy = (out & MG_BDY) != 0
    out |= _U32(PARBDY_TAGS)
    if is_edge_or_vert:
        out[true_bdy] |= _U32(MG_PARBDYBDY)
    out[user_req] &= ~_U32(MG_NOSURF)
    return out


def _unfreeze_bits(tags: np.ndarray, is_edge_or_vert: bool) -> np.ndarray:
    """Drop the freeze from uint32 tags leaving the interface
    (merge_shards / PMMG_updateTag untag contract, tag_pmmg.c:126-207).
    ``MG_OLDPARBDY`` is not set: the analysis refresh re-derives every
    classification from the global numbering, and a residual bit would
    block every untagged-cavity guard where the band needs remeshing."""
    out = tags.copy()
    was_ifc = (out & MG_PARBDY) != 0
    user_req = was_ifc & ((out & MG_NOSURF) == 0) & ((out & MG_REQ) != 0)
    true_bdy = was_ifc & ((out & MG_PARBDYBDY) != 0)
    out[was_ifc] &= ~_U32(PARBDY_TAGS | MG_PARBDYBDY)
    if is_edge_or_vert:
        out[true_bdy] |= _U32(MG_BDY)
    out[user_req] |= _U32(MG_REQ)
    return out


# ---------------------------------------------------------------------------
# host mirrors
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardViews:
    """Host views of the stacked shards (one pull); tags int32."""
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


def extend_global_ids(glo: list[np.ndarray], views: ShardViews, top: int):
    return extend_global_ids_from_vmask(glo, views.vmask, top)


def apply_fresh_ids(glo: list[np.ndarray], rows: np.ndarray,
                    gids: np.ndarray) -> None:
    """Write device-assigned fresh ids into the host numbering mirror:
    ``rows``/``gids`` are [S, K] compacted tables (-1 pads) from
    ``migrate_dev.extend_ids_device`` / ``device_migrate``'s arrivals."""
    for s, g in enumerate(glo):
        m = rows[s] >= 0
        g[rows[s][m]] = gids[s][m].astype(np.int64)


def kill_glo_rows(glo: list[np.ndarray], rows: np.ndarray,
                  cnt: np.ndarray) -> None:
    """Drop the ids of newly-dead vertex rows from the host mirror:
    ``rows`` [S, K] compacted (pad >= capP or -1), ``cnt`` [S] live
    counts — the delta of the liveness mask since the last sync
    (``migrate_dev.dead_glo_rows`` / ``device_migrate``), band-sized where
    the mask is O(mesh).  glo >= 0 only at live id-carrying rows, so
    killing the delta keeps that invariant without shipping the mask."""
    for s, g in enumerate(glo):
        r = rows[s][: int(cnt[s])]
        r = r[(r >= 0) & (r < len(g))]
        g[r] = -1


# ---------------------------------------------------------------------------
# interface recomputation from per-shard views (global-id matching)
# ---------------------------------------------------------------------------
def _shard_face_table(tet_live: np.ndarray, slots_live: np.ndarray,
                      glo_s: np.ndarray):
    """(sorted-global-triple keys, 4*tetslot+face) for every face of the
    shard's live tets; plus an 'exposed' mask (face unmatched in-shard)."""
    nt = len(tet_live)
    if nt == 0:
        return (np.zeros((0, 3), np.int64), np.zeros(0, np.int64),
                np.zeros(0, bool))
    gtet = glo_s[tet_live]                                  # [nt,4] global
    tri = np.sort(gtet[:, IDIR], axis=2).reshape(nt * 4, 3)  # [4nt,3]
    slot4 = (4 * slots_live[:, None] +
             np.arange(4)[None, :]).reshape(-1)
    order = np.lexsort((tri[:, 2], tri[:, 1], tri[:, 0]))
    ts = tri[order]
    same_next = np.concatenate([(ts[1:] == ts[:-1]).all(1), [False]])
    same_prev = np.concatenate([[False], same_next[:-1]])
    exposed = np.empty(nt * 4, bool)
    exposed[order] = ~(same_next | same_prev)
    return tri, slot4, exposed


def recompute_interface(views: ShardViews, glo: list[np.ndarray],
                        n_shards: int):
    """Match exposed faces across shards by global key; derive shared
    vertices from global-id incidence.  Returns
    (face_lists[a][b] local 4*tet_slot+face ordered by key,
     node_lists[a][b] local vertex rows ordered by global id,
     owner[s] [capP] owner shard per local vertex,
     ifc_face_slots[s] / ifc_vert_rows[s] for retagging)."""
    S = n_shards
    keys_all, slots_all, shard_all = [], [], []
    for s in range(S):
        live = np.where(views.tmask[s])[0]
        tri, slot4, exposed = _shard_face_table(
            views.tet[s][live], live, glo[s])
        keys_all.append(tri[exposed])
        slots_all.append(slot4[exposed])
        shard_all.append(np.full(int(exposed.sum()), s, np.int32))
    K = np.concatenate(keys_all) if keys_all else np.zeros((0, 3), np.int64)
    SL = np.concatenate(slots_all)
    SH = np.concatenate(shard_all)
    order = np.lexsort((K[:, 2], K[:, 1], K[:, 0]))
    Ks, SLs, SHs = K[order], SL[order], SH[order]
    pair = np.concatenate([(Ks[1:] == Ks[:-1]).all(1), [False]])
    iA = np.where(pair)[0]
    iB = iA + 1
    # conforming mesh: a face key appears in at most 2 shards
    face_lists = [[[] for _ in range(S)] for _ in range(S)]
    ifc_face_slots = [[] for _ in range(S)]
    for a, b, sa, sb in zip(SHs[iA], SHs[iB], SLs[iA], SLs[iB]):
        a, b = int(a), int(b)
        face_lists[a][b].append(int(sa))
        face_lists[b][a].append(int(sb))
        ifc_face_slots[a].append(int(sa))
        ifc_face_slots[b].append(int(sb))

    # shared vertices by global-id incidence of live vertex sets
    live_g = [glo[s][views.vmask[s]] for s in range(S)]
    live_l = [np.where(views.vmask[s])[0] for s in range(S)]
    allg = np.concatenate(live_g) if live_g else np.zeros(0, np.int64)
    alls = np.concatenate([np.full(len(g), s, np.int32)
                           for s, g in enumerate(live_g)])
    alll = np.concatenate(live_l) if live_l else np.zeros(0, np.int64)
    o = np.argsort(allg, kind="stable")
    gs, ss, ls = allg[o], alls[o], alll[o]
    head = np.concatenate([[True], gs[1:] != gs[:-1]])
    seg = np.cumsum(head) - 1
    cnt = np.bincount(seg)
    shared_seg = cnt > 1
    node_lists = [[[] for _ in range(S)] for _ in range(S)]
    owner = [np.full(views.vmask[s].shape[0], s, np.int32)
             for s in range(S)]
    ifc_vert_rows = [[] for _ in range(S)]
    bounds = np.where(head)[0]
    for b0 in np.where(shared_seg)[0]:
        lo = bounds[b0]
        hi = lo + cnt[b0]
        shards_here = ss[lo:hi]
        locals_here = ls[lo:hi]
        own = int(shards_here.max())
        for s_, l_ in zip(shards_here, locals_here):
            owner[int(s_)][int(l_)] = own
            ifc_vert_rows[int(s_)].append(int(l_))
        for i in range(len(shards_here)):
            for j in range(len(shards_here)):
                if shards_here[i] < shards_here[j]:
                    a, b = int(shards_here[i]), int(shards_here[j])
                    node_lists[a][b].append(int(locals_here[i]))
                    node_lists[b][a].append(int(locals_here[j]))
    # the shared-vertex loop walks the sorted segments, so the node lists
    # come in ascending global id order on both sides (the A.4 contract)
    return face_lists, node_lists, owner, ifc_face_slots, ifc_vert_rows


def comms_from_lists(face_lists, node_lists, owner,
                     n_shards: int) -> InterfaceComms:
    """Pad pair item lists into the device-ready comm tables
    (``comms.pad_comm_tables``)."""
    from .comms import pad_comm_tables
    return pad_comm_tables(node_lists, face_lists, owner, n_shards)


# ---------------------------------------------------------------------------
# the migration step
# ---------------------------------------------------------------------------
def enforce_ne_min(labels: np.ndarray, tmask: np.ndarray, n_shards: int,
                   ne_min: int | None = None,
                   depth: np.ndarray | None = None) -> np.ndarray:
    """Donor floor: a shard keeps at least ne_min tets
    (moveinterfaces_pmmg.c:1343 semantics, min(6, ne/2+1) scaled).

    Excess moves are reverted DEEPEST flood layer first (``depth`` from
    flood_labels) so the retained prefix stays a connected advancing
    front; without ``depth`` in slot order."""
    S = n_shards
    lab = labels.copy()
    for s in range(S):
        live = tmask[s]
        n = int(live.sum())
        floor = ne_min if ne_min is not None else min(6, n // 2 + 1)
        moved = np.where(live & (lab[s] != s))[0]
        excess = len(moved) - (n - floor)
        if excess > 0:
            if depth is not None:
                # stable sort by flood depth: deepest (latest-flipped)
                # layers revert first, ties keep slot order
                moved = moved[np.argsort(depth[s][moved], kind="stable")]
            lab[s][moved[len(moved) - excess:]] = s
    return lab


def migrate_shards(stacked, met_s, views: ShardViews,
                   glo: list[np.ndarray], labels: np.ndarray,
                   n_shards: int, verbose: int = 0):
    """Apply the displaced partition on the host views: move labelled tet
    bands between shards, weld by global id, refreeze the new interface,
    rebuild the comms.

    Mutates ``views`` and ``glo`` in place (they are this iteration's host
    mirrors); returns (stacked, met_s, comms, nmoved).  Device updates are
    sparse writes into copies, slot ids stay stable, and no global mesh
    is materialised (PMMG_transfer_all_grps role).

    Phases (a shard can be donor AND recipient, so all sender data is
    extracted before any mirror is mutated): A. extract band packages,
    B. capacity check (+ slot-stable grow), C. removals + arrivals on the
    mirrors, D. interface recomputation + freeze/unfreeze retag, E. one
    sparse push to the device."""
    S = n_shards

    moves = []            # (src, dst, src_tet_slots)
    nmoved = 0
    for s in range(S):
        m = views.tmask[s] & (labels[s] != s)
        if not m.any():
            continue
        for r in np.unique(labels[s][m]):
            slots = np.where(m & (labels[s] == int(r)))[0]
            moves.append((s, int(r), slots))
            nmoved += len(slots)
    if nmoved == 0:
        return stacked, met_s, None, 0

    # ---------- A. extract packages (before any mutation) ----------------
    pkg = {}
    for s, r, slots in moves:
        p = pkg.setdefault(r, dict(gt=[], tref=[], ftag=[], fref=[],
                                   etag=[], bank={}))
        gt = glo[s][views.tet[s][slots]]                   # [k,4] global
        p["gt"].append(gt)
        p["tref"].append(views.tref[s][slots].copy())
        p["ftag"].append(views.ftag[s][slots].copy())
        p["fref"].append(views.fref[s][slots].copy())
        p["etag"].append(views.etag[s][slots].copy())
        uq, first = np.unique(gt.reshape(-1), return_index=True)
        lrows = views.tet[s][slots].reshape(-1)[first]
        for gid, lrow in zip(uq, lrows):
            gid = int(gid)
            if gid not in p["bank"]:
                p["bank"][gid] = (views.vert[s][lrow].copy(),
                                  views.vtag[s][lrow],
                                  views.vref[s][lrow],
                                  views.met[s][lrow].copy())

    # ---------- B. capacity check ----------------------------------------
    while True:
        capP = views.vert.shape[1]
        capT = views.tet.shape[1]
        need_grow = False
        for r, p in pkg.items():
            need_g = np.unique(np.concatenate(p["gt"]).reshape(-1))
            known = np.isin(need_g, glo[r][glo[r] >= 0])
            n_new_v = int((~known).sum())
            free_v = int((glo[r] < 0).sum())
            arriving_t = sum(len(g) for g in p["gt"])
            departing_t = int((views.tmask[r] & (labels[r] != r)).sum())
            free_t = capT - int(views.tmask[r].sum()) + departing_t
            if n_new_v > free_v or arriving_t > free_t:
                need_grow = True
                break
        if not need_grow:
            break
        # slot-stable device grow (zaldy_pmmg.c regrow analogue) + mirror
        # and label/glo padding
        from .distribute import grow_shards
        stacked, met_s = grow_shards(stacked, met_s, 2 * capP, 2 * capT)
        views.vert = _padP(views.vert, capP)
        views.vtag = _padP(views.vtag, capP)
        views.vref = _padP(views.vref, capP)
        views.vmask = _padP(views.vmask, capP, False)
        views.met = _padP(views.met, capP)
        views.tet = _padT(views.tet, capT)
        views.tref = _padT(views.tref, capT)
        views.tmask = _padT(views.tmask, capT, False)
        views.ftag = _padT(views.ftag, capT)
        views.fref = _padT(views.fref, capT)
        views.etag = _padT(views.etag, capT)
        labels = np.concatenate(
            [labels, np.zeros((S, capT), labels.dtype)], axis=1)
        for s in range(S):
            glo[s] = np.concatenate([glo[s], np.full(capP, -1, np.int64)])
    capP = views.vert.shape[1]

    upd_v = {s: [] for s in range(S)}    # (rows, vert, vtag, vref, met)
    upd_t = {s: [] for s in range(S)}    # (rows, tet, tref, ftag, fref, etag)
    mask_dirty = set()

    # ---------- C1. removals ---------------------------------------------
    for s, r, slots in moves:
        views.tmask[s][slots] = False
        mask_dirty.add(s)

    # ---------- C2. arrivals ---------------------------------------------
    for r, p in pkg.items():
        gt_all = np.concatenate(p["gt"])
        need_g = np.unique(gt_all.reshape(-1))
        # known rows: any slot still holding that global id (including
        # rows whose tets just left — shared vertices are frozen, so the
        # slot data is still valid and is simply resurrected)
        hold = glo[r] >= 0
        have_g = glo[r][hold]
        have_l = np.where(hold)[0]
        o = np.argsort(have_g, kind="stable")
        have_g, have_l = have_g[o], have_l[o]
        pos = np.searchsorted(have_g, need_g)
        pos_c = np.clip(pos, 0, max(0, len(have_g) - 1))
        known = (have_g[pos_c] == need_g) if len(have_g) \
            else np.zeros(len(need_g), bool)
        new_g = need_g[~known]
        free = np.where(glo[r] < 0)[0]
        tgt_rows = free[: len(new_g)]
        lut_g = np.concatenate([have_g, new_g])
        lut_l = np.concatenate([have_l, tgt_rows])
        o2 = np.argsort(lut_g, kind="stable")
        lut_g, lut_l = lut_g[o2], lut_l[o2]
        if len(new_g):
            vv = np.stack([p["bank"][int(g_)][0] for g_ in new_g])
            vt = np.asarray([p["bank"][int(g_)][1] for g_ in new_g],
                            views.vtag.dtype)
            vr = np.asarray([p["bank"][int(g_)][2] for g_ in new_g])
            vm = np.stack([p["bank"][int(g_)][3] for g_ in new_g])
            views.vert[r][tgt_rows] = vv
            views.vtag[r][tgt_rows] = vt
            views.vref[r][tgt_rows] = vr
            views.met[r][tgt_rows] = vm
            glo[r][tgt_rows] = new_g
            upd_v[r].append((tgt_rows, vv, vt, vr, vm))
        # tet rows into free slots
        k = len(gt_all)
        tfree = np.where(~views.tmask[r])[0]
        t_rows = tfree[:k]
        lt = lut_l[np.searchsorted(lut_g, gt_all.reshape(-1))]\
            .reshape(-1, 4).astype(np.int32)
        tr_ = np.concatenate(p["tref"])
        ftg = np.concatenate(p["ftag"])
        frf = np.concatenate(p["fref"])
        etg = np.concatenate(p["etag"])
        views.tet[r][t_rows] = lt
        views.tref[r][t_rows] = tr_
        views.ftag[r][t_rows] = ftg
        views.fref[r][t_rows] = frf
        views.etag[r][t_rows] = etg
        views.tmask[r][t_rows] = True
        mask_dirty.add(r)
        upd_t[r].append((t_rows, lt, tr_, ftg, frf, etg))

    # ---------- C3. final vertex liveness + watermarks -------------------
    for s in range(S):
        live = views.tet[s][views.tmask[s]]
        ref = np.zeros(capP, bool)
        if len(live):
            ref[live.reshape(-1)] = True
        if not np.array_equal(ref, views.vmask[s]):
            mask_dirty.add(s)
        views.vmask[s] = ref
        glo[s][~ref] = -1          # dead rows become allocatable again
        used_v = np.where(ref)[0]
        used_t = np.where(views.tmask[s])[0]
        views.npoin[s] = (used_v.max() + 1) if len(used_v) else 0
        views.nelem[s] = (used_t.max() + 1) if len(used_t) else 0

    # ---------- D. recompute the interface + retag -----------------------
    face_lists, node_lists, owner, ifc_face_slots, ifc_vert_rows = \
        recompute_interface(views, glo, S)
    tag_updates = _retag_interfaces(views, glo, ifc_face_slots,
                                    ifc_vert_rows, S)
    comms = comms_from_lists(face_lists, node_lists, owner, S)

    # ---------- E. one sparse push to the device -------------------------
    stacked, met_s = _push_updates(stacked, met_s, views, upd_v, upd_t,
                                   mask_dirty, tag_updates, S)
    otrace.log(2, f"  migration: moved {nmoved} tets across "
                  f"{len(moves)} shard pairs", verbose=verbose)
    return stacked, met_s, comms, nmoved


def _padP(a, n, fill=0):
    pad = [(0, 0)] * a.ndim
    pad[1] = (0, n)
    return np.pad(a, pad, constant_values=fill)


_padT = _padP


def _retag_interfaces(views: ShardViews, glo, ifc_face_slots,
                      ifc_vert_rows, S):
    """Per shard, reconcile freeze tags with the NEW interface: unfreeze
    entities that left it, freeze entities that joined.  Membership is
    decided at the geometric-entity level (global keys) and applied to
    every local slot of the entity.  Returns per-shard sparse updates
    {field: (rows..., int32 values)} and mutates the views."""
    out = []
    for s in range(S):
        tm = views.tmask[s]
        upd = {}
        # ---- faces ----
        ft = views.ftag[s].view(_U32)
        slot_ifc = np.zeros((views.tet.shape[1], 4), bool)
        if ifc_face_slots[s]:
            sl = np.asarray(ifc_face_slots[s], np.int64)
            slot_ifc[sl // 4, sl % 4] = True
        cur_ifc = (ft & MG_PARBDY) != 0
        cur_ifc[~tm] = False
        to_unfreeze = cur_ifc & ~slot_ifc
        to_freeze = slot_ifc & ~cur_ifc
        ftr, ftc = np.where(to_unfreeze | to_freeze)
        if len(ftr):
            vals = ft[ftr, ftc].copy()
            un = to_unfreeze[ftr, ftc]
            vals[un] = _unfreeze_bits(vals[un], False)
            vals[~un] = _freeze_bits(vals[~un], False)
            ft[ftr, ftc] = vals
            upd["ftag"] = (ftr, ftc, vals.view(np.int32))
        # ---- edges ----
        # global interface edge keys = edges of the new interface faces,
        # packed with the CURRENT id bound (session ids grow
        # monotonically, so a fixed base could alias distinct edges)
        et = views.etag[s].view(_U32)
        g = glo[s]
        base = np.int64(max(int(g.max()) + 1, 1))
        if ifc_face_slots[s]:
            sl = np.asarray(ifc_face_slots[s], np.int64)
            tri = np.sort(g[views.tet[s][sl // 4]][
                np.arange(len(sl))[:, None], IDIR[sl % 4]], axis=1)
            ek = np.concatenate([
                tri[:, [0, 1]], tri[:, [0, 2]], tri[:, [1, 2]]])
            ekey = np.unique(ek[:, 0] * base + ek[:, 1])
        else:
            ekey = np.zeros(0, np.int64)
        gtet = g[views.tet[s]]
        ev = np.sort(gtet[:, IARE], axis=2)             # [T,6,2]
        slot_key = ev[..., 0] * base + ev[..., 1]
        in_new = np.zeros(slot_key.shape, bool)
        if len(ekey):
            p = np.searchsorted(ekey, slot_key)
            pc = np.clip(p, 0, len(ekey) - 1)
            in_new = ekey[pc] == slot_key
        in_new[~tm] = False
        cur = (et & MG_PARBDY) != 0
        cur[~tm] = False
        eu = cur & ~in_new
        ef = in_new & ~cur
        er, ec = np.where(eu | ef)
        if len(er):
            vals = et[er, ec].copy()
            un = eu[er, ec]
            vals[un] = _unfreeze_bits(vals[un], True)
            vals[~un] = _freeze_bits(vals[~un], True)
            et[er, ec] = vals
            upd["etag"] = (er, ec, vals.view(np.int32))
        # ---- vertices ----
        vt = views.vtag[s].view(_U32)
        new_ifc_v = np.zeros(len(vt), bool)
        if ifc_vert_rows[s]:
            new_ifc_v[np.asarray(ifc_vert_rows[s], np.int64)] = True
        curv = (vt & MG_PARBDY) != 0
        curv[~views.vmask[s]] = False
        vu = curv & ~new_ifc_v
        vf = new_ifc_v & ~curv
        vr = np.where(vu | vf)[0]
        if len(vr):
            vals = vt[vr].copy()
            un = vu[vr]
            vals[un] = _unfreeze_bits(vals[un], True)
            vals[~un] = _freeze_bits(vals[~un], True)
            vt[vr] = vals
            upd["vtag"] = (vr, vals.view(np.int32))
        out.append(upd)
    return out


def _push_updates(stacked, met_s, views: ShardViews, upd_v, upd_t,
                  mask_dirty, tag_updates, S):
    """Apply the collected sparse updates to copies of the stacked shards.
    Transfers are O(band + interface) for the data arrays; the liveness
    masks of touched shards go up whole (1-byte bools)."""
    from .dist import _on
    dev = stacked.device
    f = {k: getattr(stacked, k).clone() for k in
         ("vert", "vtag", "vref", "vmask", "tet", "tref", "tmask", "ftag",
          "fref", "etag")}
    met_d = met_s.clone()
    for s in range(S):
        for rows, vv, vt, vr_, vm in upd_v[s]:
            r = _on(dev, rows).long()
            f["vert"][s, r] = _on(dev, vv).to(f["vert"].dtype)
            f["vtag"][s, r] = _on(dev, vt).to(torch.int32)
            f["vref"][s, r] = _on(dev, vr_).to(torch.int32)
            met_d[s, r] = _on(dev, vm).to(met_d.dtype)
        for rows, lt, tr_, ftg, frf, etg in upd_t[s]:
            r = _on(dev, rows).long()
            f["tet"][s, r] = _on(dev, lt).to(torch.int32)
            f["tref"][s, r] = _on(dev, tr_).to(torch.int32)
            f["ftag"][s, r] = _on(dev, ftg).to(torch.int32)
            f["fref"][s, r] = _on(dev, frf).to(torch.int32)
            f["etag"][s, r] = _on(dev, etg).to(torch.int32)
        if s in mask_dirty:
            f["vmask"][s] = _on(dev, views.vmask[s])
            f["tmask"][s] = _on(dev, views.tmask[s])
        upd = tag_updates[s]
        for name in ("ftag", "etag"):
            if name in upd:
                rr, cc, vals = upd[name]
                f[name][s, _on(dev, rr).long(), _on(dev, cc).long()] = \
                    _on(dev, vals).to(torch.int32)
        if "vtag" in upd:
            rr, vals = upd["vtag"]
            f["vtag"][s, _on(dev, rr).long()] = \
                _on(dev, vals).to(torch.int32)
    out = dataclasses.replace(
        stacked, npoin=_on(dev, views.npoin).to(torch.int32),
        nelem=_on(dev, views.nelem).to(torch.int32), **f)
    return out, met_d


def weld_shard_bands(stacked, views: ShardViews, glo: list[np.ndarray],
                     n_shards: int, touched=None, verbose: int = 0):
    """Sequential near-duplicate weld INSIDE each shard after migration.

    Independent refinement on both sides of a frozen interface leaves
    near-coincident interior point pairs; once the band migrates, both
    copies live in ONE shard and deadlock the batched collapse.  Welds
    them on the host views (``distribute._weld_close_pairs``); only
    untagged pairs are touched, so the comm tables stay valid.  Returns
    (stacked, nweld)."""
    from .dist import _on
    from .distribute import _weld_close_pairs

    dev = stacked.device
    tet_d = tmask_d = vmask_d = None
    ntot = 0
    for s in (range(n_shards) if touched is None else touched):
        tm = views.tmask[s]
        live = np.where(tm)[0]
        if not len(live):
            continue
        tet_live = views.tet[s][live]
        # dead rows must not take part: candidacy is vtag == 0 and the
        # weld radius is a median over candidates; an all-ones poison tag
        # (never 0) keeps the grow-padded and stale rows out
        vtag_live = views.vtag[s].copy()
        vtag_live[~views.vmask[s]] = -1
        tet2, vkeep, tkeep = _weld_close_pairs(
            views.vert[s], tet_live, vtag_live, views.met[s],
            views.tref[s][live], views.ftag[s][live],
            views.etag[s][live])
        if vkeep.all() and tkeep.all() and \
                np.array_equal(tet2, tet_live):
            continue
        ntot += int((~vkeep).sum())
        views.tet[s][live] = tet2
        views.tmask[s][live[~tkeep]] = False
        ref = np.zeros(views.vmask.shape[1], bool)
        alive = views.tet[s][views.tmask[s]]
        if len(alive):
            ref[alive.reshape(-1)] = True
        views.vmask[s] = ref
        glo[s][~ref] = -1
        if tet_d is None:
            tet_d = stacked.tet.clone()
            tmask_d = stacked.tmask.clone()
            vmask_d = stacked.vmask.clone()
        chg = live[np.any(tet2 != tet_live, axis=1) | ~tkeep]
        if len(chg):
            tet_d[s, _on(dev, chg).long()] = _on(
                dev, views.tet[s][chg]).to(torch.int32)
        tmask_d[s] = _on(dev, views.tmask[s])
        vmask_d[s] = _on(dev, views.vmask[s])
    if ntot:
        otrace.log(2, f"  band weld: {ntot} near-duplicate pairs "
                      "contracted", verbose=verbose)
    if ntot == 0:
        return stacked, 0
    return dataclasses.replace(stacked, tet=tet_d, tmask=tmask_d,
                               vmask=vmask_d), ntot


def rebuild_shards(stacked):
    """Adjacency + boundary-tag propagation of every shard after a
    migration (the MMG3D_hashTetra re-hash analogue): ``build_adjacency``
    sorts every shard's faces through K7 and K8."""
    from ..core.mesh import MeshStack
    from ..ops.adjacency import boundary_edge_tags, build_adjacency
    return MeshStack.stack([boundary_edge_tags(build_adjacency(
        stacked.slot(g))) for g in range(stacked.ngroups)])


# ---------------------------------------------------------------------------
# group-graph repartitioning labels (graph-balancing mode)
# ---------------------------------------------------------------------------
def graph_repartition_labels(views: ShardViews, glo, n_shards: int,
                             clusters_per_shard: int = 8) -> np.ndarray:
    """Per-tet target-shard labels from a GROUP-graph repartition: each
    shard's live tets clustered along the morton curve (the reference's
    redistribution groups), the cluster adjacency graph from ONE face
    sort keyed by the global vertex ids (intra-shard and interface faces
    alike), the cluster -> shard map rebalanced by the weighted KL/FM
    refinement (``partition.refine_partition``, the METIS k-way role;
    metis_pmmg.c:845-1550 gathers only the group graph).  The moves then
    ride the band migration.  Returns labels [S, capT] int32."""
    from .partition import morton_partition, refine_partition
    S = n_shards
    capT = views.tet.shape[1]
    labels = np.tile(np.arange(S, dtype=np.int32)[:, None], (1, capT))
    cl_local = np.full((S, capT), -1, np.int64)
    all_tri, all_cl = [], []
    cweights = []
    offset = 0
    for s in range(S):
        live = np.where(views.tmask[s])[0]
        if not len(live):
            cweights.append(np.zeros(clusters_per_shard))
            offset += clusters_per_shard
            continue
        cent = views.vert[s][views.tet[s][live]].mean(axis=1)
        c = morton_partition(cent, min(clusters_per_shard, len(live)))
        cl_local[s, live] = c + offset
        cw = np.bincount(c, minlength=clusters_per_shard).astype(float)
        cweights.append(cw)
        gtet = glo[s][views.tet[s][live]]
        tri = np.sort(gtet[:, IDIR], axis=2).reshape(-1, 3)
        all_tri.append(tri)
        all_cl.append(np.repeat(c + offset, 4))
        offset += clusters_per_shard
    nclu = offset
    cw = np.concatenate(cweights)
    if not all_tri:
        return labels
    tri = np.concatenate(all_tri)
    cl4 = np.concatenate(all_cl)
    o = np.lexsort((tri[:, 2], tri[:, 1], tri[:, 0]))
    ts, cs = tri[o], cl4[o]
    same = np.concatenate([(ts[1:] == ts[:-1]).all(1), [False]])
    ia = np.where(same)[0]
    ca, cb = cs[ia], cs[ia + 1]
    cross = ca != cb
    pi = np.minimum(ca[cross], cb[cross])
    pj = np.maximum(ca[cross], cb[cross])
    # aggregate multiplicity (face count between cluster pairs)
    key = pi * nclu + pj
    uk, wcnt = np.unique(key, return_counts=True)
    pi_u = (uk // nclu).astype(np.int64)
    pj_u = (uk % nclu).astype(np.int64)
    init = np.repeat(np.arange(S, dtype=np.int32), clusters_per_shard)
    new_part = refine_partition(init, S, (pi_u, pj_u),
                                wcnt.astype(float), elem_w=cw,
                                npasses=5)
    for s in range(S):
        live = cl_local[s] >= 0
        labels[s][live] = new_part[cl_local[s][live]]
    return labels
