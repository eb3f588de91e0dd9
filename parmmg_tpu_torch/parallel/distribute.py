"""Split a mesh into groups and merge groups back (port of
``parallel/distribute.py``: ``split_to_shards``, ``_weld_close_pairs``,
``grow_shards``, ``merge_shards``).

Reference analogues: ``PMMG_distribute_mesh`` (distributemesh_pmmg.c:1109)
splits the mesh along a partition; ``PMMG_merge_parmesh``
(mergemesh_pmmg.c:1571) gathers everything back and dedups interface
entities.  Here the groups are the slots of a :class:`MeshStack` (leading
group axis) and interface vertices are deduplicated at merge time by
*exact* coordinate match — sound because interface points are frozen
(``MG_PARBDY | MG_REQ``; reference tag contract tag_pmmg.c:39-124) and
the split carries every coordinate bit for bit.

The interface tagging applied here IS the freeze contract: interface
faces get MG_PARBDY|MG_BDY|MG_REQ|MG_NOSURF, their edges and vertices
likewise (+ MG_PARBDYBDY on entities that are also true boundary), so the
group-local adapt operator (ops/adapt.py) leaves the interface untouched.
Tags are int32 tensors in the port; the host arithmetic below works on
their uint32 views, so every mask keeps the JAX package's bits.

``permute_shards`` (the multi-device group handoff) comes with the
repartitioning between distributed passes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import (FACE_EDGES, IDIR, MG_BDY, MG_NOSURF,
                              MG_PARBDY, MG_PARBDYBDY, MG_REQ, PARBDY_TAGS)
from ..core.mesh import MeshStack, make_mesh, mesh_to_host, replace
from ..ops.adjacency import boundary_edge_tags, build_adjacency
from ..utils.compilecache import bucket


def _u32(t: torch.Tensor) -> np.ndarray:
    """Host uint32 copy of an int32 tag tensor (same bits)."""
    return t.cpu().numpy().astype(np.int32, copy=True).view(np.uint32)


def _i32(a: np.ndarray, device) -> torch.Tensor:
    """int32 tensor of a uint32 host tag array (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
        device)


def split_to_shards(mesh, met, part: np.ndarray, nparts: int,
                    cap_mult: float = 3.0, return_l2g: bool = False):
    """Split a Mesh into ``nparts`` group meshes, stacked on the mesh's
    device.

    Returns (MeshStack [nparts, ...], met stacked [nparts, capP(, 6)]),
    plus the per-part local->global vertex maps when ``return_l2g`` (the
    input of ``comms.build_interface_comms``).
    All groups share one capacity (``cap_mult`` x the largest group,
    rounded up the geometric bucket ladder from 64)."""
    dev = mesh.device
    vert, tet, vref, tref, vtag = mesh_to_host(mesh)
    vtag = vtag.astype(np.int32, copy=False).view(np.uint32)
    vm = mesh.vmask.cpu().numpy()
    tm = mesh.tmask.cpu().numpy()
    methost = met.cpu().numpy()[vm]
    # per-tet face/edge tags + refs travel with the tets: ridge (MG_GEO)
    # and reference data must survive the split
    ftag_h = _u32(mesh.ftag)[tm]
    fref_h = mesh.fref.cpu().numpy()[tm]
    etag_h = _u32(mesh.etag)[tm]
    part = np.asarray(part, np.int32)
    assert part.shape[0] == len(tet)

    # interface faces: faces shared by tets of different parts
    n = len(tet)
    faces = np.sort(tet[:, IDIR].reshape(n * 4, 3), axis=1)
    key = (faces[:, 0].astype(np.int64) << 42) | \
          (faces[:, 1].astype(np.int64) << 21) | faces[:, 2].astype(np.int64)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    same = ks[1:] == ks[:-1]
    fA = order[:-1][same]
    fB = order[1:][same]
    cross = part[fA // 4] != part[fB // 4]
    ifc_faces = np.concatenate([fA[cross], fB[cross]])   # global face slots

    ifc_vert = np.zeros(len(vert), bool)
    ifc_vert[faces[ifc_faces].reshape(-1)] = True

    maxP = maxT = 0
    locals_ = []
    for p in range(nparts):
        sel = part == p
        ltet_g = tet[sel]
        used = np.zeros(len(vert), bool)
        used[ltet_g.reshape(-1)] = True
        gids = np.where(used)[0]
        locals_.append((gids, ltet_g, np.where(sel)[0]))
        maxP = max(maxP, len(gids))
        maxT = max(maxT, len(ltet_g))

    # bucketed capacities: drifting group sizes collapse onto the
    # geometric ladder, as in the JAX package (its compile governor)
    capP = bucket(int(cap_mult * maxP), floor=64)
    capT = bucket(int(cap_mult * maxT), floor=64)

    face_is_ifc = np.zeros(n * 4, bool)
    face_is_ifc[ifc_faces] = True
    face_is_ifc = face_is_ifc.reshape(n, 4)

    shards_m = []
    shards_met = []
    for p in range(nparts):
        gids, ltet_g, tsel = locals_[p]
        g2l = np.full(len(vert), -1, np.int64)
        g2l[gids] = np.arange(len(gids))
        ltet = g2l[ltet_g].astype(np.int32)
        sm = make_mesh(vert[gids], ltet, vref=vref[gids], tref=tref[tsel],
                       capP=capP, capT=capT, device=dev)
        np_, nt_ = len(gids), len(ltet)
        # freeze the interface: vertices.  MG_NOSURF marks REQ as OURS —
        # a vertex the user already required must NOT carry NOSURF, or
        # the merge would strip the user's REQ with the freeze
        svtag = np.zeros(capP, np.uint32)
        svtag[:np_] = vtag[gids]
        on_ifc = ifc_vert[gids]
        user_req_v = (svtag[:np_] & MG_REQ) != 0
        svtag[:np_][on_ifc] |= PARBDY_TAGS
        svtag[:np_][on_ifc & user_req_v] &= ~np.uint32(MG_NOSURF)
        true_bdy = (vtag[gids] & MG_BDY) != 0
        svtag[:np_][on_ifc & true_bdy] |= MG_PARBDYBDY
        # faces + edges: carry the global tags/refs, then freeze interface
        sftag = np.zeros((capT, 4), np.uint32)
        setag = np.zeros((capT, 6), np.uint32)
        sfref = np.zeros((capT, 4), np.int32)
        sftag[:nt_] = ftag_h[tsel]
        setag[:nt_] = etag_h[tsel]
        sfref[:nt_] = fref_h[tsel]
        lf_ifc = face_is_ifc[tsel]                       # [nt,4]
        user_req_f = (sftag[:nt_] & MG_REQ) != 0
        sftag[:nt_][lf_ifc] |= PARBDY_TAGS
        sftag[:nt_][lf_ifc & user_req_f] &= ~np.uint32(MG_NOSURF)
        e_ifc_m = np.zeros((nt_, 6), bool)
        for f in range(4):
            for e in FACE_EDGES[f]:
                e_ifc_m[:, e] |= lf_ifc[:, f]
        pre_bdy_e = (setag[:nt_] & MG_BDY) != 0
        user_req_e = (setag[:nt_] & MG_REQ) != 0
        setag[:nt_][e_ifc_m] |= PARBDY_TAGS
        setag[:nt_][e_ifc_m & pre_bdy_e] |= MG_PARBDYBDY
        setag[:nt_][e_ifc_m & user_req_e] &= ~np.uint32(MG_NOSURF)
        sm = replace(sm, vtag=_i32(svtag, dev),
                     ftag=torch.maximum(sm.ftag, _i32(sftag, dev)),
                     etag=torch.maximum(sm.etag, _i32(setag, dev)),
                     fref=torch.from_numpy(sfref).to(dev))
        shards_m.append(boundary_edge_tags(build_adjacency(sm)))
        lmet = np.zeros((capP,) + methost.shape[1:], methost.dtype)
        lmet[:np_] = methost[gids]
        shards_met.append(torch.from_numpy(lmet).to(dev))

    if return_l2g:
        return (MeshStack.stack(shards_m), torch.stack(shards_met),
                [loc[0] for loc in locals_])
    return MeshStack.stack(shards_m), torch.stack(shards_met)


def _weld_close_pairs(vert, tet, vtag, met, tref, ftag, etag,
                      tol_rel: float = 0.1):
    """Contract near-coincident untagged vertex pairs, sequentially.

    Independent refinement on the two sides of a frozen interface can
    drop interior points a tiny distance apart; after the merge these
    tangled clusters deadlock the batched collapse wave (every single
    contraction inverts a sliver spanning the gap), while a SEQUENTIAL
    pass resolves the chain pair by pair, trying both directions, as the
    reference's one-op-at-a-time remesher would.  Host-side, O(pairs);
    pairs are vertices closer than ``tol_rel`` x their metric size with
    BOTH tags clear, welded only when every rewritten tet stays positive
    and every dying tet is untagged.

    Returns (tet, vkeep, tkeep) — updated connectivity plus vertex/tet
    keep masks."""
    n = len(vert)
    if met is None:
        return tet, np.ones(n, bool), np.ones(len(tet), bool)
    if met.ndim == 1:
        href = met
    else:  # aniso: isotropic proxy h ~ 1/sqrt(mean diagonal eigenvalue)
        diag = (met[:, 0] + met[:, 3] + met[:, 5]) / 3.0
        href = 1.0 / np.sqrt(np.maximum(diag, 1e-30))
    free = vtag == 0
    if not free.any():
        return tet, np.ones(n, bool), np.ones(len(tet), bool)
    # vectorized prefilter: any pair within the weld radius collides in
    # at least one of the 8 half-cell-shifted grids at cell = 2*radius
    cell = max(1e-12, 2.0 * float(np.median(tol_rel * href[free])))
    fidx = np.where(free)[0]
    fv = vert[fidx]
    sus = np.zeros(len(fidx), bool)
    for sx in (0.0, 0.5):
        for sy in (0.0, 0.5):
            for sz in (0.0, 0.5):
                k = np.floor(fv / cell +
                             np.array([sx, sy, sz])).astype(np.int64)
                kk = (k[:, 0] << 42) ^ (k[:, 1] << 21) ^ k[:, 2]
                _, inv, cnts = np.unique(kk, return_inverse=True,
                                         return_counts=True)
                sus |= cnts[inv] > 1
    cand_v = fidx[sus]
    if not len(cand_v):
        return tet, np.ones(n, bool), np.ones(len(tet), bool)
    import collections
    import itertools
    key = np.round(vert / cell).astype(np.int64)
    cells = collections.defaultdict(list)
    for i in cand_v:
        cells[tuple(key[i])].append(int(i))
    cand_pairs = []
    for k, lst in cells.items():
        for dx in itertools.product((-1, 0, 1), repeat=3):
            k2 = (k[0] + dx[0], k[1] + dx[1], k[2] + dx[2])
            other = cells.get(k2)
            if not other:
                continue
            for i in lst:
                for j in other:
                    if i < j:
                        d = np.linalg.norm(vert[i] - vert[j])
                        if d < tol_rel * min(href[i], href[j]):
                            cand_pairs.append((d, i, j))
    if not cand_pairs:
        return tet, np.ones(n, bool), np.ones(len(tet), bool)
    cand_pairs.sort()
    # vertex -> tets incidence, restricted to tets touching a candidate
    touch = np.isin(tet, cand_v).any(axis=1)
    inc = collections.defaultdict(set)
    for t_i in np.where(touch)[0]:
        for v in tet[t_i]:
            inc[int(v)].add(int(t_i))
    tet = tet.copy()
    tkeep = np.ones(len(tet), bool)
    vkeep = np.ones(n, bool)

    def try_weld(rm, kp):
        ball = [t_i for t_i in inc[rm] if tkeep[t_i]]
        dying, moved = [], []
        for t_i in ball:
            row = tet[t_i]
            if kp in row:
                # must carry no tags to die silently, and a weld must
                # not bridge different regions
                if ftag[t_i].any() or etag[t_i].any():
                    return False
                dying.append(t_i)
            else:
                moved.append(t_i)
        if len({int(tref[t_i]) for t_i in ball}) > 1:
            return False
        for t_i in moved:
            row = np.where(tet[t_i] == rm, kp, tet[t_i])
            p = vert[row]
            if np.dot(p[1] - p[0], np.cross(p[2] - p[0], p[3] - p[0])) \
                    <= 1e-30:
                return False
        for t_i in dying:
            tkeep[t_i] = False
        for t_i in moved:
            tet[t_i] = np.where(tet[t_i] == rm, kp, tet[t_i])
            inc[kp].add(t_i)
        vkeep[rm] = False
        return True

    for _d, i, j in cand_pairs:
        if not (vkeep[i] and vkeep[j]):
            continue
        if not try_weld(j, i):
            try_weld(i, j)
    return tet, vkeep, tkeep


def grow_shards(shards: MeshStack, mets: torch.Tensor, new_capP: int,
                new_capT: int):
    """Grow every group's capacity, group axis intact.

    The static-shape analogue of the reference's realloc
    (zaldy_pmmg.c:140-254): buffers are zero/False-padded on the capacity
    axis (-1 for ``adja``), so vertex/tet SLOT IDS are preserved and the
    frozen-interface contract stays valid.  Works on a stack on the card
    or on the host (the chunked pipeline keeps its state there)."""
    capP, capT = shards.capP, shards.capT
    dP, dT = new_capP - capP, new_capT - capT
    if dP <= 0 and dT <= 0:
        return shards, mets

    def pad(x, d, fill=0):
        if d <= 0:
            return x
        extra = torch.full((x.shape[0], d) + tuple(x.shape[2:]), fill,
                           dtype=x.dtype, device=x.device)
        return torch.cat([x, extra], dim=1)

    out = dataclasses.replace(
        shards,
        vert=pad(shards.vert, dP), vref=pad(shards.vref, dP),
        vtag=pad(shards.vtag, dP), vmask=pad(shards.vmask, dP, False),
        tet=pad(shards.tet, dT), tref=pad(shards.tref, dT),
        tmask=pad(shards.tmask, dT, False), adja=pad(shards.adja, dT, -1),
        ftag=pad(shards.ftag, dT), fref=pad(shards.fref, dT),
        etag=pad(shards.etag, dT))
    return out, pad(mets, dP)


def merge_shards(shards: MeshStack, mets=None, return_part: bool = False,
                 device=None):
    """Merge the groups back into one Mesh (+ metric) on ``device``
    (default: the stack's device).

    Interface vertices are deduplicated by exact coordinate bytes — valid
    because MG_PARBDY points are frozen during group-local adaptation.
    With ``return_part``, also returns the source-group label of every
    merged tet (a partition of the merged mesh, ready for interface
    displacement)."""
    dev = shards.device if device is None else torch.device(device)
    host = shards.map(lambda t: t.cpu().numpy())
    met_h = None if mets is None else mets.cpu().numpy()
    nsh = host.vert.shape[0]
    all_v, all_tag, all_ref, all_met = [], [], [], []
    all_t, all_tref, all_src = [], [], []
    all_ft, all_fr, all_et = [], [], []
    off = 0
    for s in range(nsh):
        vm, tm = host.vmask[s], host.tmask[s]
        new_id = np.cumsum(vm) - 1
        vert = host.vert[s][vm]
        tet = new_id[host.tet[s][tm]].astype(np.int32).reshape(-1, 4)
        all_v.append(vert)
        all_tag.append(host.vtag[s][vm].view(np.uint32))
        all_ref.append(host.vref[s][vm])
        all_t.append(tet + off)
        all_tref.append(host.tref[s][tm])
        all_ft.append(host.ftag[s][tm].view(np.uint32))
        all_fr.append(host.fref[s][tm])
        all_et.append(host.etag[s][tm].view(np.uint32))
        all_src.append(np.full(len(tet), s, np.int32))
        if met_h is not None:
            all_met.append(met_h[s][vm])
        off += len(vert)
    vert = np.concatenate(all_v)
    vtag = np.concatenate(all_tag)
    vref = np.concatenate(all_ref)
    tet = np.concatenate(all_t)
    tref = np.concatenate(all_tref)
    # face/edge tags travel back with the tets; interface faces become
    # interior (drop the freeze + BDY bits); interface edges keep their
    # true-boundary nature via PARBDYBDY and USER-required status via the
    # absence of MG_NOSURF (tag_pmmg.c NOSURF semantics)
    ftag_m = np.concatenate(all_ft)
    fref_m = np.concatenate(all_fr)
    etag_m = np.concatenate(all_et)
    f_ifc = (ftag_m & MG_PARBDY) != 0
    f_user = f_ifc & ((ftag_m & MG_NOSURF) == 0) & \
        ((ftag_m & MG_REQ) != 0)
    ftag_m[f_ifc] &= ~np.uint32(PARBDY_TAGS)
    ftag_m[f_user] |= MG_REQ
    e_ifc = (etag_m & MG_PARBDY) != 0
    e_truebdy = (etag_m & MG_PARBDYBDY) != 0
    e_user = e_ifc & ((etag_m & MG_NOSURF) == 0) & \
        ((etag_m & MG_REQ) != 0)
    etag_m[e_ifc] &= ~np.uint32(PARBDY_TAGS | MG_PARBDYBDY)
    etag_m[e_ifc & e_truebdy] |= MG_BDY
    etag_m[e_user] |= MG_REQ

    # dedup PARBDY vertices by coordinate bytes
    is_ifc = (vtag & MG_PARBDY) != 0
    keys = vert.astype(np.float64).tobytes()
    rows = np.frombuffer(keys, dtype=np.dtype((np.void, 24)))
    _, first_idx, inv = np.unique(rows, return_index=True,
                                  return_inverse=True)
    canon = first_idx[inv.reshape(-1)]
    remap = np.arange(len(vert))
    remap[is_ifc] = canon[is_ifc]
    keep = np.zeros(len(vert), bool)
    keep[remap] = True
    new_id = np.cumsum(keep) - 1
    tet = new_id[remap[tet]].astype(np.int32)
    # drop the PARBDY tags (interfaces no longer exist) but keep the
    # true-boundary info carried by MG_PARBDYBDY
    vtag2 = vtag[keep].copy()
    was_truebdy = (vtag2 & MG_PARBDYBDY) != 0
    was_parbdy = (vtag2 & MG_PARBDY) != 0
    was_user_req = was_parbdy & ((vtag2 & MG_NOSURF) == 0) & \
        ((vtag2 & MG_REQ) != 0)
    vtag2 &= ~np.uint32(PARBDY_TAGS | MG_PARBDYBDY)
    vtag2[was_truebdy] |= MG_BDY
    vtag2[was_parbdy & ~was_truebdy] &= ~np.uint32(MG_BDY)
    vtag2[was_user_req] |= MG_REQ

    vert_k = vert[keep]
    vref_k = vref[keep]
    met_k = np.concatenate(all_met)[keep] if met_h is not None else None
    src_k = np.concatenate(all_src)
    # sequential weld of near-coincident interior pairs left by
    # independent refinement across the frozen interface
    tet, vkeep2, tkeep2 = _weld_close_pairs(
        vert_k, tet, vtag2, met_k, tref, ftag_m, etag_m)
    if not (vkeep2.all() and tkeep2.all()):
        nid = np.cumsum(vkeep2) - 1
        tet = nid[tet[tkeep2]].astype(np.int32)
        tref = tref[tkeep2]
        ftag_m = ftag_m[tkeep2]
        fref_m = fref_m[tkeep2]
        etag_m = etag_m[tkeep2]
        src_k = src_k[tkeep2]
        vert_k = vert_k[vkeep2]
        vref_k = vref_k[vkeep2]
        vtag2 = vtag2[vkeep2]
        if met_k is not None:
            met_k = met_k[vkeep2]

    m = make_mesh(vert_k, tet, vref=vref_k, tref=tref, device=dev)
    vtag_full = np.zeros(m.capP, np.uint32)
    vtag_full[: len(vtag2)] = vtag2
    ftag_full = np.zeros((m.capT, 4), np.uint32)
    ftag_full[: len(ftag_m)] = ftag_m
    fref_full = np.zeros((m.capT, 4), np.int32)
    fref_full[: len(fref_m)] = fref_m
    etag_full = np.zeros((m.capT, 6), np.uint32)
    etag_full[: len(etag_m)] = etag_m
    m = replace(m, vtag=_i32(vtag_full, dev), ftag=_i32(ftag_full, dev),
                fref=torch.from_numpy(fref_full).to(dev),
                etag=_i32(etag_full, dev))
    m = boundary_edge_tags(build_adjacency(m))
    out_met = None
    if met_k is not None:
        full = np.zeros((m.capP,) + met_k.shape[1:], met_k.dtype)
        full[: len(met_k)] = met_k
        out_met = torch.from_numpy(full).to(dev)
    if return_part:
        return m, out_met, src_k
    return m, out_met
