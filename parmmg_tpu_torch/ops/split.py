"""Batched edge split (port of ``ops/split.py``): each wave splits an
independent set of long edges (an edge wins iff its whole shell nominated
it), inserting midpoints (Bezier-lifted on the surface with ``hausd``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import (IARE, LLONG, MG_BDY, MG_CRN, MG_GEO, MG_NOM,
                              MG_PARBDY, MG_REF, MG_REQ, QUAL_FLOOR)
from ..core.mesh import Mesh, replace
from .edges import (NEG_INF, PRI_MIN, EdgeTable, claim_channels,
                    edge_lengths, free_rows, topk_prep, unique_edges,
                    wave_budget)
from .primitives import nonzero_pad, reduce_drop, set_drop, \
    topk_lowest_index
from .quality import quality_from_points


class SplitResult(NamedTuple):
    mesh: Mesh
    met: torch.Tensor
    nsplit: torch.Tensor      # 0-d int32
    overflow: torch.Tensor    # 0-d bool: capacity exhausted
    modified: torch.Tensor    # [capT] bool tets rewritten / created
    deferred: torch.Tensor    # 0-d bool: budget-cut viable winners


def _lift_corrections(mesh: Mesh, et: EdgeTable, va, vb, vtan):
    """Bezier midpoint offsets for regular boundary edges and curved
    feature-line edges (zeros elsewhere)."""
    from .analysis import boundary_vertex_normals, ridge_vertex_tangents
    vn = boundary_vertex_normals(mesh)
    sing = MG_GEO | MG_CRN | MG_REQ | MG_PARBDY | MG_NOM | MG_REF
    ta, tb = mesh.vtag[va], mesh.vtag[vb]
    regular = ((et.etag & MG_BDY) != 0) & \
        ((et.etag & (MG_GEO | MG_REQ | MG_PARBDY | MG_REF)) == 0) & \
        ((ta & sing) == 0) & ((tb & sing) == 0)
    d = mesh.vert[vb] - mesh.vert[va]
    na, nb = vn[va], vn[vb]
    t_a = d - na * (na * d).sum(-1, keepdim=True)
    t_b = d - nb * (nb * d).sum(-1, keepdim=True)
    corr = 0.125 * (t_a - t_b)
    lift = torch.where(regular[:, None], corr, torch.zeros_like(corr))
    tan = vtan if vtan is not None else ridge_vertex_tangents(mesh, et=et)
    hard = MG_CRN | MG_REQ | MG_PARBDY | MG_NOM
    on_line = ((et.etag & (MG_GEO | MG_REF)) != 0) & \
        ((et.etag & (MG_REQ | MG_PARBDY)) == 0) & \
        ((ta & hard) == 0) & ((tb & hard) == 0)
    ta_l = tan[va] * (tan[va] * d).sum(-1, keepdim=True)
    tb_l = tan[vb] * (tan[vb] * d).sum(-1, keepdim=True)
    corr_l = 0.125 * (ta_l - tb_l)
    return torch.where(on_line[:, None], corr_l, lift)


def split_wave(mesh: Mesh, met: torch.Tensor, lmax: float = LLONG,
               hausd: float | None = None, budget_div: int = 8,
               fem_only: bool = False, et: EdgeTable | None = None,
               lens: torch.Tensor | None = None,
               vtan: torch.Tensor | None = None,
               prescreen: bool = True,
               vact: torch.Tensor | None = None) -> SplitResult:
    """One independent-set split wave (see the JAX package's docstring:
    ``fem_only`` targets interior edges with both endpoints on the
    boundary; ``et``/``lens`` share a caller's table of THIS mesh).
    ``vact`` [capP] bool keeps the edges with both endpoints active (the
    narrow cycles of ``ops/active.py``); splits are not window-limited."""
    capT, capP = mesh.capT, mesh.capP
    dev = mesh.device
    if et is None:
        et = unique_edges(mesh)
    if lens is None:
        lens = edge_lengths(mesh, et, met)
    va = et.ev[:, 0].clamp(0, capP - 1).long()
    vb = et.ev[:, 1].clamp(0, capP - 1).long()
    frozen_edge = (et.etag & (MG_REQ | MG_PARBDY)) != 0
    if fem_only:
        both_bdy = ((mesh.vtag[va] & MG_BDY) != 0) & \
            ((mesh.vtag[vb] & MG_BDY) != 0)
        cand = et.emask & ((et.etag & MG_BDY) == 0) & both_bdy & \
            ~frozen_edge
    else:
        cand = et.emask & (lens > lmax) & ~frozen_edge
    if vact is not None:
        cand = cand & vact[va] & vact[vb]
    lift_corr = None
    if hausd is not None:
        lift_corr = _lift_corrections(mesh, et, va, vb, vtan)

    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    false0 = torch.zeros((), dtype=torch.bool, device=dev)
    if not bool(cand.any()):
        return SplitResult(mesh, met, zero_i, false0,
                           torch.zeros(capT, dtype=torch.bool, device=dev),
                           false0)

    capE = et.ev.shape[0]
    ar0 = torch.arange(capT, device=dev)
    s, t = claim_channels(lens, cand)
    eid = et.edge_id.long()
    tes = torch.where(mesh.tmask[:, None], s[eid],
                      torch.full(eid.shape, NEG_INF, device=dev))
    t_te = t[eid]
    best_s = tes.max(dim=1).values
    at_best = (tes == best_s[:, None]) & torch.isfinite(best_s)[:, None]
    tet_t = torch.where(at_best, t_te, torch.full_like(t_te, PRI_MIN))
    best_t = tet_t.max(dim=1).values
    nominate = at_best & (tet_t == best_t[:, None])
    if prescreen:
        q_par = quality_from_points(mesh.vert[mesh.tet.long()])
        nominate = nominate & (q_par > 2.0 * QUAL_FLOOR)[:, None]
    has_nom = nominate.any(dim=1)
    loc_n = torch.argmax(nominate.to(torch.uint8), dim=1)
    e_n = eid[ar0, loc_n].clamp(0, capE - 1)

    nom_count = reduce_drop(
        torch.zeros(capE, dtype=torch.int32, device=dev),
        torch.where(has_nom, e_n, torch.full_like(e_n, capE)), 1, "sum")
    win0 = cand & (nom_count == et.nshell) & (et.nshell > 0)

    KW = min(wave_budget(capT, budget_div), capE)
    KH = min(2 * wave_budget(capT, budget_div), capT)
    neg, nwin = topk_prep(win0, -lens)
    vals, wc = topk_lowest_index(neg, KW)
    wv = vals > NEG_INF
    wcc = wc.clamp(0, capE - 1)
    nsh = et.nshell[wcc]
    sh0 = torch.where(wv, nsh, torch.zeros_like(nsh))
    toff0 = torch.cumsum(sh0, 0) - sh0
    shell_fit = (toff0 + sh0) <= KH
    defer = (nwin > KW) | (wv & ~shell_fit).any()
    wv = wv & shell_fit

    keep0 = set_drop(torch.zeros(capE, dtype=torch.bool, device=dev),
                     torch.where(wv, wc, torch.full_like(wc, capE)), True)
    has0 = has_nom & keep0[e_n]
    hidx = nonzero_pad(has0, KH, capT)
    hv0 = hidx < capT
    hc = hidx.clamp(0, capT - 1)
    arK = torch.arange(KH, device=dev)
    loc0 = loc_n[hc]
    e0 = e_n[hc].clamp(0, capE - 1)
    iare = torch.from_numpy(IARE).to(dev)
    il = iare[loc0, 0]
    jl = iare[loc0, 1]
    rows0 = mesh.tet[hc]
    mid_row = 0.5 * (mesh.vert[va[e0]] + mesh.vert[vb[e0]])
    if lift_corr is not None:
        mid_row = mid_row + lift_corr[e0]
    pts0 = mesh.vert[rows0.long()]
    p1 = pts0.clone()
    p1[arK, jl] = mid_row
    p2 = pts0.clone()
    p2[arK, il] = mid_row
    q1 = quality_from_points(p1)
    q2 = quality_from_points(p2)
    rowbad = hv0 & ~((q1 > QUAL_FLOOR) & (q2 > QUAL_FLOOR))
    veto_e = reduce_drop(
        torch.zeros(capE + 1, dtype=torch.bool, device=dev),
        torch.where(rowbad, e0, torch.full_like(e0, capE)), rowbad,
        "amax")[:capE]

    okv = wv & ~veto_e[wcc]
    win_i = okv.to(torch.int32)
    new_off = torch.cumsum(win_i, 0) - win_i
    frow_p, nfree_p = free_rows(mesh.vmask, KW)
    fits_p = new_off < torch.clamp(nfree_p, max=KW)
    sh = torch.where(okv & fits_p, nsh, torch.zeros_like(nsh))
    toff = torch.cumsum(sh, 0) - sh
    frow_t, nfree_t = free_rows(mesh.tmask, KH)
    fits_cap = fits_p & ((toff + sh) <= torch.clamp(nfree_t, max=KH))
    ok = okv & fits_cap
    overflow = (okv & ~fits_cap).any()
    nwin = ok.sum(dtype=torch.int32)

    va_w, vb_w = va[wcc], vb[wcc]
    mid = 0.5 * (mesh.vert[va_w] + mesh.vert[vb_w])
    if lift_corr is not None:
        mid = mid + lift_corr[wcc]
    mid_id_w = frow_p[new_off.clamp(0, KW - 1).long()]
    tgt_w = torch.where(ok, mid_id_w, torch.full_like(mid_id_w, capP))
    vert = set_drop(mesh.vert, tgt_w, mid)
    vmask = set_drop(mesh.vmask, tgt_w, True)
    vtag = set_drop(mesh.vtag, tgt_w, et.etag[wcc])
    vref = set_drop(mesh.vref, tgt_w,
                    torch.minimum(mesh.vref[va_w], mesh.vref[vb_w]))
    met_new = set_drop(met, tgt_w, 0.5 * (met[va_w] + met[vb_w]))

    alloc = set_drop(torch.full((capE, 2), -1, dtype=torch.int32,
                                device=dev),
                     torch.where(ok, wc, torch.full_like(wc, capE)),
                     torch.stack([mid_id_w.to(torch.int32),
                                  toff.to(torch.int32)], dim=1))
    al_row = alloc[e0]
    hv = hv0 & (al_row[:, 0] >= 0)
    mh = al_row[:, 0].clamp(0, capP - 1)
    new_tid_r = frow_t[(al_row[:, 1] + et.shell_rank[hc, loc0])
                       .clamp(0, KH - 1).long()]
    tgt1 = torch.where(hv, hc, torch.full_like(hc, capT))
    tgt2 = torch.where(hv, new_tid_r.clamp(0, capT - 1),
                       torch.full_like(hc, capT))
    tet1_rows = rows0.clone()
    tet1_rows[arK, jl] = mh
    tet2_rows = rows0.clone()
    tet2_rows[arK, il] = mh
    tet_out = set_drop(mesh.tet, tgt1, tet1_rows)
    tet_out = set_drop(tet_out, tgt2, tet2_rows)
    tmask = set_drop(mesh.tmask, tgt2, True)
    tref = set_drop(mesh.tref, tgt2, mesh.tref[hc])

    ftag1r, fref1r, etag1r, ftag2r, fref2r, etag2r = _split_tags_rows(
        mesh, hc, il, jl)
    ftag = set_drop(set_drop(mesh.ftag, tgt1, ftag1r), tgt2, ftag2r)
    frf = set_drop(set_drop(mesh.fref, tgt1, fref1r), tgt2, fref2r)
    etag_out = set_drop(set_drop(mesh.etag, tgt1, etag1r), tgt2, etag2r)

    zero_l = torch.zeros_like(mid_id_w)
    npoin = torch.maximum(mesh.npoin, torch.where(
        ok, mid_id_w + 1, zero_l).max().to(torch.int32))
    nelem = torch.maximum(mesh.nelem, torch.where(
        hv, new_tid_r + 1, torch.zeros_like(new_tid_r)).max().to(torch.int32))
    out = replace(mesh, vert=vert, vmask=vmask, vtag=vtag, vref=vref,
                  tet=tet_out, tmask=tmask, tref=tref, ftag=ftag, fref=frf,
                  etag=etag_out, npoin=npoin, nelem=nelem)
    modified = set_drop(set_drop(torch.zeros(capT, dtype=torch.bool,
                                             device=dev), tgt1, True),
                        tgt2, True)
    return SplitResult(out, met_new, nwin, overflow, modified, defer)


def _split_tags_rows(mesh: Mesh, hc, il, jl):
    """Tag inheritance for the two halves of each split tet (see the JAX
    package): the cut face is interior, new edges inside an old face
    inherit that face's MG_BDY/MG_REF, everything else inherits."""
    KH = hc.shape[0]
    arK = torch.arange(KH, device=hc.device)
    ftag0 = mesh.ftag[hc]
    fref0 = mesh.fref[hc]
    etag0 = mesh.etag[hc]

    def one_half(repl):
        kept = torch.where(repl == il, jl, il)
        ftag = ftag0.clone()
        ftag[arK, kept] = 0
        fref = fref0.clone()
        fref[arK, kept] = 0
        out = etag0.clone()
        for el in range(6):
            a, b = int(IARE[el][0]), int(IARE[el][1])
            touches_repl = (repl == a) | (repl == b)
            other = torch.where(repl == a, torch.full_like(repl, b),
                                torch.full_like(repl, a))
            is_split_edge = ((il == a) & (jl == b)) | ((il == b) & (jl == a))
            rem = 6 - (il + jl + other)
            in_old_face = touches_repl & ~is_split_edge & \
                (other != il) & (other != jl)
            face_t = ftag0[arK, rem.clamp(0, 3)]
            new_t = face_t & (MG_BDY | MG_REF)
            out[:, el] = torch.where(in_old_face, new_t, out[:, el])
        return ftag, fref, out

    ftag1, fref1, etag1 = one_half(jl)
    ftag2, fref2, etag2 = one_half(il)
    return ftag1, fref1, etag1, ftag2, fref2, etag2
