"""Batched edge collapse (port of ``ops/collapse.py``): short edges merge
one endpoint into the other under Mmg's colver constraints; winners own
their removed vertex's whole ball, so simultaneous application is exact.
Dying tets donate their face/edge tags through keyed joins restricted to
the donor band (exactly the full-width join's result)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import (EPSD, IDIR, INT32_MAX, LLONG, LSHRT, MG_BDY,
                              MG_CRN, MG_GEO, MG_NOM, MG_PARBDY, MG_REF,
                              MG_REQ, QUAL_FLOOR)
from ..core.mesh import Mesh, replace, tet_edge_vertices, tet_face_vertices
from .edges import (NEG_INF, PACK_LIMIT, PRI_MIN, claim_channels,
                    edge_lengths, scatter_argmax2, segmented_max,
                    segmented_or, sort_pairs, topk_prep, unique_edges,
                    wave_budget)
from .primitives import (lexsort, reduce_drop, segment_first, set_drop,
                         topk_lowest_index)
from .quality import corner_metric, edge_length_iso, quality_from_points


class CollapseResult(NamedTuple):
    mesh: Mesh
    ncollapse: torch.Tensor          # 0-d int32
    surface_changed: torch.Tensor    # 0-d bool: a dying tet donated tags
    deferred: torch.Tensor           # 0-d bool: candidates exceeded K


def _removable(vtag, other_vtag, edge_tag):
    """May vertex v be deleted by collapsing along this edge?"""
    free = (vtag & (MG_REQ | MG_CRN | MG_PARBDY | MG_NOM)) == 0
    on_bdy = (vtag & MG_BDY) != 0
    bdy_ok = ~on_bdy | (((edge_tag & MG_BDY) != 0) &
                        ((other_vtag & MG_BDY) != 0))
    on_geo = (vtag & MG_GEO) != 0
    geo_ok = ~on_geo | (((edge_tag & MG_GEO) != 0) &
                        ((other_vtag & (MG_GEO | MG_CRN)) != 0))
    on_ref = (vtag & MG_REF) != 0
    ref_ok = ~on_ref | (((edge_tag & MG_REF) != 0) &
                        ((other_vtag & (MG_REF | MG_CRN)) != 0))
    return free & bdy_ok & geo_ok & ref_ok


def _full(shape, val, like):
    return torch.full(shape, val, dtype=like.dtype, device=like.device)


def collapse_wave(mesh: Mesh, met: torch.Tensor, lmin: float = LSHRT,
                  lmax: float = LLONG, sliver_q: float | None = None,
                  hausd: float | None = None, budget_div: int = 8,
                  et=None, lens=None, stale_tets=None,
                  vtan=None, vact=None, wwin=None) -> CollapseResult:
    """One independent-set collapse wave; ``sliver_q`` switches to the
    bad-element mode (edges of tets below ``sliver_q``, strict ball
    improvement).  ``et``/``lens``/``stale_tets``: shared-table mode, the
    split's modification footprint defers stale candidates.  ``vact``
    (active vertices of a narrow cycle) and ``wwin`` (the morton window,
    ``ops/active.py``) [capP] bool keep the edges with both endpoints
    in the set."""
    capT, capP = mesh.capT, mesh.capP
    dev = mesh.device
    if et is None:
        et = unique_edges(mesh)
    if lens is None:
        lens = edge_lengths(mesh, et, met)
    Efull = et.ev.shape[0]
    va_f = et.ev[:, 0].clamp(0, capP - 1).long()
    vb_f = et.ev[:, 1].clamp(0, capP - 1).long()
    frozen_edge = (et.etag & (MG_REQ | MG_PARBDY)) != 0
    tvl = mesh.tet.long()
    q_tet = bad_tet = None
    if sliver_q is None:
        short = et.emask & (lens < lmin) & ~frozen_edge
        if stale_tets is not None:
            idx = torch.where(stale_tets[:, None], mesh.tet,
                              _full((), capP, mesh.tet)).reshape(-1)
            stale_v = reduce_drop(
                torch.zeros(capP + 1, dtype=torch.bool, device=dev), idx,
                stale_tets.repeat_interleave(4), "amax")[:capP]
            short = short & ~stale_v[va_f] & ~stale_v[vb_f]
    else:
        q_tet = quality_from_points(mesh.vert[tvl], corner_metric(met, tvl))
        bad_tet = mesh.tmask & (q_tet < sliver_q)
        bad_edge = reduce_drop(
            torch.zeros(Efull, dtype=torch.bool, device=dev),
            et.edge_id.reshape(-1), bad_tet.repeat_interleave(6), "amax")
        short = et.emask & bad_edge & ~frozen_edge & (lens < lmax)
    if vact is not None:
        short = short & vact[va_f] & vact[vb_f]
    if wwin is not None:
        short = short & wwin[va_f] & wwin[vb_f]
    ta_f, tb_f = mesh.vtag[va_f], mesh.vtag[vb_f]
    rem_b_f = _removable(tb_f, ta_f, et.etag)
    rem_a_f = _removable(ta_f, tb_f, et.etag)
    pre = short & (rem_a_f | rem_b_f)

    if hausd is not None:
        from .analysis import boundary_vertex_normals, ridge_vertex_tangents
        vn = boundary_vertex_normals(mesh)
        on_bdy_f = (et.etag & MG_BDY) != 0
        d_f = mesh.vert[vb_f] - mesh.vert[va_f]
        na_f, nb_f = vn[va_f], vn[vb_f]
        t_a = d_f - na_f * (na_f * d_f).sum(-1, keepdim=True)
        t_b = d_f - nb_f * (nb_f * d_f).sum(-1, keepdim=True)
        dev_s = torch.linalg.norm(0.125 * (t_a - t_b), dim=-1)
        tanv = vtan if vtan is not None \
            else ridge_vertex_tangents(mesh, et=et)
        on_line_f = (et.etag & (MG_GEO | MG_REF)) != 0
        ta_l = tanv[va_f] * (tanv[va_f] * d_f).sum(-1, keepdim=True)
        tb_l = tanv[vb_f] * (tanv[vb_f] * d_f).sum(-1, keepdim=True)
        dev_l = torch.linalg.norm(0.125 * (ta_l - tb_l), dim=-1)
        dev_s = torch.where(on_line_f, dev_l, dev_s)
        pre = pre & ~(on_bdy_f & (dev_s > hausd))

    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    false0 = torch.zeros((), dtype=torch.bool, device=dev)
    if not bool(pre.any()):
        return CollapseResult(mesh, zero_i, false0, false0)

    K = min(Efull, wave_budget(capT, budget_div))
    if sliver_q is None:
        prio = lens
    else:
        prio = reduce_drop(
            torch.full((Efull,), float("inf"), device=dev),
            et.edge_id.reshape(-1),
            torch.where(bad_tet, q_tet,
                        torch.full_like(q_tet, float("inf")))
            .repeat_interleave(6), "amin")
    neg, npre = topk_prep(pre, prio)
    defer = npre > K
    _, sel = topk_lowest_index(neg, K)
    lens_c = lens[sel]
    va = va_f[sel]
    vb = vb_f[sel]
    cand = pre[sel]
    del_b = rem_b_f[sel]
    rm = torch.where(del_b, vb, va)
    kp = torch.where(del_b, va, vb)

    s, t = claim_channels(-lens_c, cand)
    is_top, v_s, v_t = scatter_argmax2(rm, s, t, cand, capP)
    kept_of = set_drop(torch.zeros(capP, dtype=torch.int32, device=dev),
                       torch.where(is_top, rm, torch.full_like(rm, capP)),
                       kp.to(torch.int32))

    tv = mesh.tet
    vpos = mesh.vert[tvl]
    vs_c = v_s[tvl]
    vt_c = v_t[tvl]
    has_c = torch.isfinite(vs_c)
    tmax_s = torch.where(mesh.tmask[:, None], vs_c,
                         torch.full_like(vs_c, NEG_INF)).max(dim=1).values
    selc = (vs_c == tmax_s[:, None]) & torch.isfinite(tmax_s)[:, None]
    tsel = torch.where(selc, vt_c, torch.full_like(vt_c, PRI_MIN))
    tmax_t = tsel.max(dim=1).values
    corner_max = selc & (tsel == tmax_t[:, None])
    claimed = corner_max & has_c
    has_cl = claimed.any(dim=1) & mesh.tmask
    kc = torch.argmax(claimed.to(torch.uint8), dim=1)
    ar0 = torch.arange(capT, device=dev)
    rm_v = tv[ar0, kc]
    kept_v = kept_of[rm_v.clamp(0, capP - 1).long()]
    kept_c = kept_v.clamp(0, capP - 1).long()
    kept_p = mesh.vert[kept_c]
    contains_kept = torch.zeros(capT, dtype=torch.bool, device=dev)
    for j in range(4):
        contains_kept = contains_kept | ((tv[:, j] == kept_v) & (kc != j))
    active_cl = has_cl & ~contains_kept

    oh = torch.arange(4, device=dev)[None, :] == kc[:, None]
    p = torch.where(oh[..., None], kept_p[:, None, :], vpos)
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    d3 = p[:, 3] - p[:, 0]
    vol = (d1 * torch.linalg.cross(d2, d3, dim=-1)).sum(-1) / 6.0
    bad = vol <= EPSD
    for f in range(4):
        i0, i1, i2 = (int(x) for x in IDIR[f])
        n_old = torch.linalg.cross(vpos[:, i1] - vpos[:, i0],
                                   vpos[:, i2] - vpos[:, i0], dim=-1)
        n_new = torch.linalg.cross(p[:, i1] - p[:, i0],
                                   p[:, i2] - p[:, i0], dim=-1)
        isb = (mesh.ftag[:, f] & MG_BDY) != 0
        flip = (n_old * n_new).sum(-1) <= 0
        bad = bad | (isb & flip & (kc != f))
    if met.dim() == 1:        # overlong new edges: iso only, as in JAX
        for j in range(4):
            lnew = edge_length_iso(kept_p, p[:, j], met[kept_c],
                                   met[tvl[:, j]])
            bad = bad | ((lnew > lmax) & (kc != j))

    inf = float("inf")
    mq = corner_metric(met, tvl)
    q_ball = quality_from_points(vpos, mq) if sliver_q is None else q_tet
    idx4c = torch.cat([torch.where(mesh.tmask, tv[:, k],
                                   _full((), capP, tv)) for k in range(4)])
    ballq_old = reduce_drop(
        torch.full((capP + 1,), inf, device=dev), idx4c,
        torch.where(mesh.tmask, q_ball, torch.full_like(q_ball, inf))
        .repeat(4), "amin")
    mq_cl = None if mq is None else torch.where(
        oh[..., None], met[kept_c][:, None, :], mq)
    qv = quality_from_points(p, mq_cl)
    row_val = torch.where(bad, torch.full_like(qv, -inf), qv)
    mism4 = torch.cat([has_c[:, k] & ~corner_max[:, k] & mesh.tmask
                       for k in range(4)])
    tv_cat = torch.cat([tv[:, k] for k in range(4)])
    idx_cat = torch.cat([
        torch.where(active_cl, rm_v, _full((), capP, rm_v)),
        torch.where(mism4, tv_cat, _full((), capP, tv_cat))])
    val_cat = torch.cat([
        torch.where(active_cl, row_val, torch.full_like(row_val, inf)),
        torch.where(mism4, torch.full(mism4.shape, -inf, device=dev),
                    torch.full(mism4.shape, inf, device=dev))])
    ballq_new = reduce_drop(torch.full((capP + 1,), inf, device=dev),
                            idx_cat, val_cat, "amin")
    if sliver_q is None:
        ok = (ballq_new[:capP] >= 0.3 * ballq_old[:capP]) & \
             (ballq_new[:capP] > QUAL_FLOOR)
        geombad = ~ok
    else:
        geombad = ~(ballq_new[:capP] > ballq_old[:capP])

    capPt = torch.full_like(rm, capP)
    idx_rk = torch.cat([torch.where(cand, rm, capPt),
                        torch.where(cand, kp, capPt)])
    cl_s = reduce_drop(torch.full((capP + 1,), NEG_INF, device=dev), idx_rk,
                       s.repeat(2), "amax")
    eq_rm = cand & (s == cl_s[rm])
    eq_kp = cand & (s == cl_s[kp])
    idx_rk2 = torch.cat([torch.where(eq_rm, rm, capPt),
                         torch.where(eq_kp, kp, capPt)])
    cl_t = reduce_drop(torch.full((capP + 1,), PRI_MIN, dtype=torch.int32,
                                  device=dev), idx_rk2, t.repeat(2), "amax")
    claim_ok = eq_rm & (t == cl_t[rm]) & eq_kp & (t == cl_t[kp])

    win = cand & is_top & ~geombad[rm] & claim_ok
    ncol = win.sum(dtype=torch.int32)
    if int(ncol) == 0:
        out = mesh
        schg = false0
    else:
        new_tet, tmask, vmask, ftag, fref, etag, schg = _collapse_apply(
            mesh, win, rm, kp)
        out = replace(mesh, tet=new_tet, tmask=tmask, vmask=vmask,
                      ftag=ftag, fref=fref, etag=etag)
    return CollapseResult(out, ncol, schg, defer)


def _collapse_apply(mesh: Mesh, win, rm, kp):
    """Vertex remap, dead-tet detection and the donor tag joins."""
    capT, capP = mesh.capT, mesh.capP
    dev = mesh.device
    remap = torch.arange(capP, dtype=torch.int32, device=dev)
    remap = set_drop(remap, torch.where(win, rm, torch.full_like(rm, capP)),
                     kp.to(torch.int32))
    new_tet = remap[mesh.tet.long()]
    dup = torch.zeros(capT, dtype=torch.bool, device=dev)
    for i in range(4):
        for j in range(i + 1, 4):
            dup = dup | (new_tet[:, i] == new_tet[:, j])
    dead = dup & mesh.tmask
    tmask = mesh.tmask & ~dead
    vmask = set_drop(mesh.vmask,
                     torch.where(win, rm, torch.full_like(rm, capP)), False)
    has_donor_info = bool(
        (dead[:, None] & ((mesh.ftag != 0) | (mesh.fref != 0))).any() or
        (dead[:, None] & (mesh.etag != 0)).any())
    if has_donor_info:
        ftag, fref, etag = _collapse_tag_joins(mesh, new_tet, dead, tmask)
    else:
        ftag, fref, etag = mesh.ftag, mesh.fref, mesh.etag
    return (new_tet, tmask, vmask, ftag, fref, etag,
            torch.tensor(has_donor_info, device=dev))


def _tag_joins_core(new_tet, ftag, fref, etag, donor, recv, capP: int):
    """Keyed face and edge joins over ``new_tet``'s rows: OR (tags) / max
    (refs) of the donors' values per key, returned per receiving slot
    (add_tag [n,4], add_ref [n,4], add_e [n,6])."""
    n = new_tet.shape[0]
    dev = new_tet.device
    F4 = n * 4
    big = INT32_MAX
    fvn = torch.sort(tet_face_vertices(new_tet).reshape(F4, 3), dim=1).values
    donor_f = donor.repeat_interleave(4)
    rel_f = donor_f | recv.repeat_interleave(4)
    bigf = torch.full((F4,), big, dtype=torch.int32, device=dev)
    if capP <= PACK_LIMIT:
        w_f = torch.where(rel_f, fvn[:, 1] * capP + fvn[:, 2], bigf)
        k0_f = torch.where(rel_f, fvn[:, 0], bigf)
        order_f = lexsort(k0_f, w_f)
        first_f = segment_first(k0_f[order_f], w_f[order_f])
    else:
        cs = [torch.where(rel_f, fvn[:, j], bigf) for j in range(3)]
        order_f = lexsort(*cs)
        first_f = segment_first(*[c[order_f] for c in cs])
    pos_f = torch.arange(F4, device=dev)
    seg_f = torch.cummax(torch.where(first_f, pos_f,
                                     torch.zeros_like(pos_f)), 0).values
    is_last_f = torch.ones_like(first_f)
    is_last_f[:-1] = first_f[1:]
    last_idx = torch.where(is_last_f, seg_f, torch.full_like(seg_f, F4))
    zf = torch.zeros((), dtype=torch.int32, device=dev)
    dtag_f = torch.where(donor_f[order_f], ftag.reshape(F4)[order_f], zf)
    tot_tag = set_drop(torch.zeros(F4, dtype=torch.int32, device=dev),
                       last_idx, segmented_or(first_f, dtag_f))
    add_tag = torch.zeros(F4, dtype=torch.int32, device=dev)
    add_tag[order_f] = tot_tag[seg_f]
    dref_f = torch.where(donor_f[order_f], fref.reshape(F4)[order_f], zf)
    tot_ref = set_drop(torch.zeros(F4, dtype=torch.int32, device=dev),
                       last_idx, segmented_max(first_f, dref_f))
    add_ref = torch.zeros(F4, dtype=torch.int32, device=dev)
    add_ref[order_f] = tot_ref[seg_f]

    ev_new = tet_edge_vertices(new_tet).reshape(n * 6, 2)
    ka = torch.minimum(ev_new[:, 0], ev_new[:, 1])
    kb = torch.maximum(ev_new[:, 0], ev_new[:, 1])
    donor_s = donor.repeat_interleave(6)
    rel = recv.repeat_interleave(6) | donor_s
    order, _, _, first = sort_pairs(ka, kb, rel, capP)
    pos = torch.arange(n * 6, device=dev)
    seg = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                       0).values
    dtag = torch.where(donor_s[order], etag.reshape(n * 6)[order], zf)
    is_last = torch.ones_like(first)
    is_last[:-1] = first[1:]
    total_at_head = set_drop(
        torch.zeros(n * 6, dtype=torch.int32, device=dev),
        torch.where(is_last, seg, torch.full_like(seg, n * 6)),
        segmented_or(first, dtag))
    add_e = torch.zeros(n * 6, dtype=torch.int32, device=dev)
    add_e[order] = total_at_head[seg]
    return add_tag.reshape(n, 4), add_ref.reshape(n, 4), add_e.reshape(n, 6)


def _collapse_tag_joins(mesh: Mesh, new_tet, dead, tmask):
    """Donor-band joins: the dead tets plus every live tet containing a
    vertex of a remapped dead tet hold every key a donor can match, so
    joining over that band gives the full-width result (see the JAX
    package's coverage proof); the band is compacted at its exact size."""
    capT, capP = mesh.capT, mesh.capP
    dev = mesh.device
    rv = reduce_drop(
        torch.zeros(capP + 1, dtype=torch.bool, device=dev),
        torch.where(dead[:, None], new_tet,
                    torch.full_like(new_tet, capP)).reshape(-1),
        dead.repeat_interleave(4), "amax")[:capP]
    band = dead | (tmask & rv[new_tet.long()].any(dim=1))
    rows = torch.nonzero(band).flatten()
    bt, br, be = _tag_joins_core(new_tet[rows], mesh.ftag[rows],
                                 mesh.fref[rows], mesh.etag[rows],
                                 dead[rows], tmask[rows], capP)
    add_tag = torch.zeros((capT, 4), dtype=torch.int32, device=dev)
    add_tag[rows] = bt
    add_ref = torch.zeros((capT, 4), dtype=torch.int32, device=dev)
    add_ref[rows] = br
    add_e = torch.zeros((capT, 6), dtype=torch.int32, device=dev)
    add_e[rows] = be
    ftag = torch.where(tmask[:, None], mesh.ftag | add_tag, mesh.ftag)
    fref = torch.where(tmask[:, None] & (mesh.fref == 0) & (add_ref != 0),
                       add_ref, mesh.fref)
    etag = torch.where(tmask[:, None], mesh.etag | add_e, mesh.etag)
    return ftag, fref, etag
