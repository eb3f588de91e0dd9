"""Batched topology swaps (port of ``ops/swap.py``): the combined 3-2
interior / 2-2 boundary edge-swap wave and the 2-3 face swap, which pairs
faces off ``adja`` or, with ``facesort=True`` as the JAX package runs it
on the TPU, straight off the face sort (bit-identical).  Improvement
gate: new worst quality > SWAP_GAIN * old worst (Mmg's 1.053)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import (EDGE_FACES, EPSD, IDIR, INT32_MAX, MG_BDY,
                              MG_GEO, MG_NOM, MG_OPNBDY, MG_PARBDY, MG_REF,
                              MG_REQ, QUAL_FLOOR)
from ..core.mesh import Mesh, replace
from .adjacency import bdy_tags_from_sort, face_sort
from .edges import (PACK_LIMIT, claim_shells, free_rows, scatter_argmax2,
                    segmented_or, sort_pairs, topk_prep, topk_prep3,
                    unique_edges, wave_budget)
from .primitives import set_drop, topk_lowest_index
from .quality import corner_metric, quality_from_points

SWAP_GAIN = 1.053


def _quality(vert, tets, met):
    """Quality of the tets with vertex ids ``tets`` [..., 4] (int64)."""
    return quality_from_points(vert[tets], corner_metric(met, tets))

# local edge index for a corner pair (i, j) — inverse of IARE
_EDGE_OF = np.zeros((4, 4), np.int64)
for _e, (_i, _j) in enumerate([[0, 1], [0, 2], [0, 3],
                               [1, 2], [1, 3], [2, 3]]):
    _EDGE_OF[_i, _j] = _EDGE_OF[_j, _i] = _e

_F32_EPS = float(np.finfo(np.float32).eps)


class SwapResult(NamedTuple):
    mesh: Mesh
    nswap: torch.Tensor        # 0-d int32
    deferred: torch.Tensor     # 0-d bool


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _first_dup(x0, x1, win, capP):
    """Winners whose key (min, max) repeats an earlier winner's."""
    order_d, _, _, first_d = sort_pairs(torch.minimum(x0, x1),
                                        torch.maximum(x0, x1), win, capP)
    dup = torch.zeros_like(win)
    dup[order_d] = win[order_d] & ~first_d
    return dup


def swap_edges_wave(mesh: Mesh, met: torch.Tensor,
                    hausd: float | None = None,
                    budget_div: int = 8,
                    vact: torch.Tensor | None = None,
                    wwin: torch.Tensor | None = None) -> SwapResult:
    """Combined edge-swap wave: 3-2 interior + 2-2 boundary, one pass
    over the K worst shells (see the JAX package's docstring).  ``vact``
    (active vertices of a narrow cycle) and ``wwin`` (the morton window,
    ``ops/active.py``) [capP] bool keep the edges with both endpoints in
    the set."""
    capT, capP = mesh.capT, mesh.capP
    dev = mesh.device
    et = unique_edges(mesh)
    Efull = et.ev.shape[0]
    eof = torch.from_numpy(_EDGE_OF).to(dev)
    inf = float("inf")

    ft0_, ft1_, ft2_ = et.shell3[:, 0], et.shell3[:, 1], et.shell3[:, 2]
    q_tet = _quality(mesh.vert, mesh.tet.long(), met)
    s0f = ft0_.clamp(0, capT - 1).long()
    s1f = ft1_.clamp(0, capT - 1).long()
    s2f = ft2_.clamp(0, capT - 1).long()
    infs = torch.full((Efull,), inf, device=dev)
    qs0 = torch.where(ft0_ >= 0, q_tet[s0f], infs)
    qs1 = torch.where(ft1_ >= 0, q_tet[s1f], infs)
    qs2 = torch.where(ft2_ >= 0, q_tet[s2f], infs)
    pair_ok_f = (ft0_ >= 0) & (ft1_ >= 0) & \
        (mesh.tref[s0f] == mesh.tref[s1f])
    pre32 = et.emask & (et.nshell == 3) & (et.etag == 0) & \
        pair_ok_f & (ft2_ >= 0) & (mesh.tref[s0f] == mesh.tref[s2f])
    frozen22 = (et.etag & (MG_GEO | MG_REQ | MG_PARBDY | MG_NOM |
                           MG_REF | MG_OPNBDY)) != 0
    pre22 = et.emask & (et.nshell == 2) & ((et.etag & MG_BDY) != 0) & \
        ~frozen22 & pair_ok_f
    for keep in (vact, wwin):
        if keep is not None:
            ok = keep[et.ev[:, 0].clamp(0, capP - 1).long()] & \
                keep[et.ev[:, 1].clamp(0, capP - 1).long()]
            pre32 = pre32 & ok
            pre22 = pre22 & ok
    pre = pre32 | pre22
    K = min(Efull, wave_budget(capT, budget_div))
    neg, npre = topk_prep3(pre, qs0, qs1, qs2)
    defer = npre > K
    _, sel = topk_lowest_index(neg, K)

    ev_c = et.ev[sel]
    shell3_c = et.shell3[sel]
    E = K
    ar = torch.arange(E, device=dev)
    false_e = torch.zeros(E, dtype=torch.bool, device=dev)

    t0, t1, t2 = shell3_c[:, 0], shell3_c[:, 1], shell3_c[:, 2]
    s0 = t0.clamp(0, capT - 1).long()
    s1 = t1.clamp(0, capT - 1).long()
    s2 = t2.clamp(0, capT - 1).long()
    a = ev_c[:, 0].clamp(0, capP - 1)
    b = ev_c[:, 1].clamp(0, capP - 1)
    tv0 = mesh.tet[s0]
    tv1 = mesh.tet[s1]
    base32 = pre32[sel]
    base22 = pre22[sel]

    is_ab0 = (tv0 == a[:, None]) | (tv0 == b[:, None])
    ordr = torch.sort(is_ab0.to(torch.int32), dim=1, stable=True).indices
    y1 = tv0[ar, ordr[:, 0]]
    y2 = tv0[ar, ordr[:, 1]]
    y1_in1 = (tv1 == y1[:, None]).any(dim=1)
    y2_in1 = (tv1 == y2[:, None]).any(dim=1)
    c22 = torch.where(y1_in1, y1, y2)
    p22 = torch.where(y1_in1, y2, y1)
    is_abc1 = (tv1 == a[:, None]) | (tv1 == b[:, None]) | \
        (tv1 == c22[:, None])
    q22 = tv1[ar, torch.argmax((~is_abc1).to(torch.uint8), dim=1)]
    base22 = base22 & (y1_in1 ^ y2_in1) & (is_abc1.sum(dim=1) == 3)
    p32, q32 = y1, y2
    is_pq1 = (tv1 == p32[:, None]) | (tv1 == q32[:, None])
    r32 = tv1[ar, torch.argmax((~(is_abc1 | is_pq1)).to(torch.uint8),
                               dim=1)]
    s1_has_p = (tv1 == p32[:, None]).any(dim=1)
    t_pr = torch.where(s1_has_p, s1, s2)
    t_qr = torch.where(s1_has_p, s2, s1)

    x0 = torch.where(base32, p32, p22)
    x1 = torch.where(base32, q32, q22)
    x2 = torch.where(base32, r32, c22)
    u1 = torch.where(base32, t_pr, s0)
    u2 = torch.where(base32, t_qr, s1)
    tu1 = mesh.tet[u1]
    tu2 = mesh.tet[u2]

    tgt = torch.stack([a, b, x0, x1, x2], dim=1)

    def pos5(tv):
        eqm = tv[:, None, :] == tgt[:, :, None]
        return torch.argmax(eqm.to(torch.uint8), dim=2), eqm.any(dim=2)

    P0, in0 = pos5(tv0)
    P1, in1 = pos5(tu1)
    P2, in2 = pos5(tu2)
    ring_ok = in1[:, 2] & in1[:, 4] & in2[:, 3] & in2[:, 4]
    base32 = base32 & ring_ok
    base22 = base22 & ring_ok

    et0, et1r, et2r = mesh.etag[s0], mesh.etag[u1], mesh.etag[u2]
    ft0, ft1r, ft2r = mesh.ftag[s0], mesh.ftag[u1], mesh.ftag[u2]
    fr0, fr1r, fr2r = mesh.fref[s0], mesh.fref[u1], mesh.fref[u2]

    def ecol(rows, pi, pj):
        return torch.gather(rows, 1, eof[pi, pj][:, None])[:, 0]

    def fcol(rows, pi):
        return torch.gather(rows, 1, pi[:, None])[:, 0]

    vert = mesh.vert
    al, bl = a.long(), b.long()
    x0l, x1l, x2l = x0.long(), x1.long(), x2.long()
    zero_u = torch.zeros(E, dtype=torch.int32, device=dev)
    ft_bdy1 = fcol(ft0, P0[:, 4])
    ft_bdy2 = fcol(ft2r, P2[:, 4])
    fr_bdy1 = fcol(fr0, P0[:, 4])
    fr_bdy2 = fcol(fr2r, P2[:, 4])
    bad_face_bits = MG_REQ | MG_PARBDY | MG_NOM | MG_OPNBDY
    base22 = base22 & ((ft_bdy1 & MG_BDY) != 0) & \
        ((ft_bdy2 & MG_BDY) != 0) & \
        (((ft_bdy1 | ft_bdy2) & bad_face_bits) == 0) & \
        (ft_bdy1 == ft_bdy2) & (fr_bdy1 == fr_bdy2) & \
        (fcol(ft0, P0[:, 2]) == 0) & (fcol(ft2r, P2[:, 3]) == 0)
    newf = ft_bdy1
    newfr = fr_bdy1
    newe22 = MG_BDY | (newf & MG_REF)

    pa_, pb_ = vert[al], vert[bl]
    pp_, pq_ = vert[x0l], vert[x1l]
    pc_ = vert[x2l]
    n_abp = _cross(pb_ - pa_, pp_ - pa_)
    n_abq = _cross(pq_ - pa_, pb_ - pa_)
    nn = torch.sqrt((n_abp * n_abp).sum(-1)) + EPSD
    hloc = torch.sqrt(torch.maximum(torch.maximum(
        ((pb_ - pa_) ** 2).sum(-1), ((pp_ - pa_) ** 2).sum(-1)),
        ((pq_ - pa_) ** 2).sum(-1)))
    cmax = torch.stack([pt_.abs().max(dim=-1).values
                        for pt_ in (pa_, pb_, pc_, pp_, pq_)]).max(
                            dim=0).values
    off_plane = ((n_abp * (pq_ - pa_)).sum(-1)).abs() / nn
    noise_op = 32.0 * _F32_EPS * cmax * hloc * hloc / nn
    tol_op = 1e-5 * hloc + noise_op
    if hausd is not None:
        tol_op = torch.clamp(tol_op, min=hausd)
    base22 = base22 & (off_plane <= tol_op)

    def area(nv):
        return 0.5 * torch.sqrt((nv * nv).sum(-1))

    a_old = area(n_abp) + area(n_abq)
    a_new = area(_cross(pq_ - pp_, pa_ - pp_)) + \
        area(_cross(pq_ - pp_, pb_ - pp_))
    noise_ar = 32.0 * _F32_EPS * cmax * hloc
    tol_ar = 1e-5 * (a_old + EPSD) + noise_ar
    if hausd is not None:
        tol_ar = torch.maximum(tol_ar, hausd * hloc)
    base22 = base22 & ((a_old - a_new).abs() <= tol_ar)
    kmin = torch.minimum(x0, x1)
    kmax = torch.maximum(x0, x1)
    if capP <= PACK_LIMIT:
        if et.skey.shape[0] == Efull:
            ekey = et.skey
        else:
            ekey = torch.sort(torch.where(
                et.emask, et.ev[:, 0] * capP + et.ev[:, 1],
                torch.full_like(et.ev[:, 0], INT32_MAX))).values
        pkey = kmin * capP + kmax
        loc = torch.searchsorted(ekey, pkey)
        exists = ekey[loc.clamp(0, Efull - 1)] == pkey
    else:
        zero_e = torch.zeros_like(et.ev[:, 0])
        aa = torch.cat([torch.where(et.emask, et.ev[:, 0], zero_e), kmin])
        bb = torch.cat([torch.where(et.emask, et.ev[:, 1], zero_e), kmax])
        vv = torch.cat([et.emask, base22])
        n_all = Efull + E
        order, _, _, first = sort_pairs(aa, bb, vv, capP)
        is_edge = (order < Efull) & vv[order]
        has_edge = segmented_or(first, is_edge.to(torch.int32))
        is_last = torch.ones_like(first)
        is_last[:-1] = first[1:]
        pos = torch.arange(n_all, device=dev)
        seg = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                           0).values
        total = set_drop(torch.zeros(n_all, dtype=torch.int32,
                                     device=dev),
                         torch.where(is_last, seg,
                                     torch.full_like(seg, n_all)),
                         has_edge)
        exists = set_drop(false_e,
                          torch.where(order >= Efull, order - Efull,
                                      torch.full_like(order, E)),
                          total[seg] > 0)
    base22 = base22 & ~exists

    cfaces = torch.from_numpy(EDGE_FACES).to(dev)
    face_clean = torch.ones(E, dtype=torch.bool, device=dev)
    for rows, Pm in ((ft0, P0), (ft1r, P1), (ft2r, P2)):
        lae = eof[Pm[:, 0], Pm[:, 1]]
        for k in range(2):
            face_clean = face_clean & (fcol(rows, cfaces[lae, k]) == 0)
    base32 = base32 & face_clean

    cand = base32 | base22

    def signed_vol(v0, v1, v2, v3):
        q0, q1, q2, q3 = vert[v0], vert[v1], vert[v2], vert[v3]
        return ((q1 - q0) * _cross(q2 - q0, q3 - q0)).sum(-1)

    sv_a = signed_vol(x0l, x1l, x2l, al)
    sv_b = signed_vol(x0l, x1l, x2l, bl)
    cand = cand & (sv_a * sv_b < 0) & (sv_a.abs() > EPSD) & \
        (sv_b.abs() > EPSD)
    flip_a = sv_a < 0
    flip_b = sv_b < 0

    def orient(v0, v1, v2, v3, flip):
        return torch.stack([torch.where(flip, v1, v0),
                            torch.where(flip, v0, v1), v2, v3], dim=1)

    new_a = orient(x0, x1, x2, a, flip_a)
    new_b = orient(x0, x1, x2, b, flip_b)

    q_old = torch.minimum(q_tet[s0], q_tet[s1])
    q_old = torch.minimum(q_old, torch.where(base32, q_tet[s2],
                                             torch.full_like(q_old, inf)))
    new_ab = torch.cat([new_a, new_b])
    q_ab = _quality(vert, new_ab.long(), met)
    q_new = torch.minimum(q_ab[:E], q_ab[E:])
    cand = cand & (q_new > torch.clamp(SWAP_GAIN * q_old, min=QUAL_FLOOR))

    def route_f(col0, col1, col2, flip):
        return torch.stack([torch.where(flip, col1, col0),
                            torch.where(flip, col0, col1), col2, zero_u],
                           dim=1)

    def route_e(cols, flip):
        flipped = [cols[0], cols[3], cols[4], cols[1], cols[2], cols[5]]
        return torch.stack([torch.where(flip, f, n)
                            for n, f in zip(cols, flipped)], dim=1)

    def routed(y_idx):
        py0, py2 = P0[:, y_idx], P2[:, y_idx]
        po0, po1, po2 = P0[:, 1 - y_idx], P1[:, 1 - y_idx], P2[:, 1 - y_idx]
        flip = flip_a if y_idx == 0 else flip_b
        ftag_n = route_f(fcol(ft2r, po2), fcol(ft1r, po1),
                         torch.where(base32, fcol(ft0, po0), newf), flip)
        fref_n = route_f(fcol(fr2r, po2), fcol(fr1r, po1),
                         torch.where(base32, fcol(fr0, po0), newfr), flip)
        e0 = torch.where(base32, ecol(et0, P0[:, 2], P0[:, 3]), newe22)
        e1 = ecol(et1r, P1[:, 2], P1[:, 4])
        e2 = ecol(et0, P0[:, 2], py0)
        e3 = ecol(et2r, P2[:, 3], P2[:, 4])
        e4 = torch.where(base32, ecol(et0, P0[:, 3], py0),
                         ecol(et2r, P2[:, 3], py2))
        e5 = ecol(et2r, P2[:, 4], py2) | \
            torch.where(base22, ecol(et0, P0[:, 4], py0), zero_u)
        return ftag_n, fref_n, route_e([e0, e1, e2, e3, e4, e5], flip)

    ftag_a, fref_a, etag_a = routed(0)
    ftag_b, fref_b, etag_b = routed(1)

    s2eff = torch.where(base32, s2, s0)
    win = claim_shells(q_new - q_old, cand, (s0, s1, s2eff), capT)
    win = win & ~_first_dup(x0, x1, win & base22, capP)

    capTt = torch.full_like(s0, capT)
    idx2 = torch.cat([torch.where(win, s0, capTt),
                      torch.where(win, s1, capTt)])
    out = replace(
        mesh,
        tet=set_drop(mesh.tet, idx2, torch.cat([new_a, new_b])),
        ftag=set_drop(mesh.ftag, idx2, torch.cat([ftag_a, ftag_b])),
        fref=set_drop(mesh.fref, idx2, torch.cat([fref_a, fref_b])),
        etag=set_drop(mesh.etag, idx2, torch.cat([etag_a, etag_b])),
        tmask=set_drop(mesh.tmask, torch.where(win & base32, s2, capTt),
                       False))
    return SwapResult(out, win.sum(dtype=torch.int32), defer)


def _pair_fields_adja(mesh: Mesh, q_tet, capT: int):
    """swap23 pairing off ``adja``: per tet, the face toward its worst
    eligible neighbour (fstar, t2, f2, cand)."""
    adja = mesh.adja
    nb = adja >> 2
    nf = adja & 3
    valid = (adja >= 0) & mesh.tmask[:, None]
    nb_s = nb.clamp(0, capT - 1).long()
    tid = torch.arange(capT, device=mesh.device)[:, None]
    own = valid & (tid < nb) & mesh.tmask[nb_s]
    nf_s = nf.clamp(0, 3).long()
    own = own & (mesh.ftag == 0) & (mesh.ftag[nb_s, nf_s] == 0)
    q_nb = torch.where(own, q_tet[nb_s],
                       torch.full(own.shape, float("inf"),
                                  device=mesh.device))
    fstar = torch.argmin(q_nb, dim=1)
    arT = torch.arange(capT, device=mesh.device)
    return fstar, nb_s[arT, fstar], nf_s[arT, fstar], own[arT, fstar]


def _pair_fields_facesort(mesh: Mesh, q_tet, capT: int,
                          set_bdy_tags: bool = True):
    """swap23 pairing straight off the face-sort records, with no [capT,4]
    ``adja``: bit-identical to :func:`_pair_fields_adja` on every row the
    wave reads (matched twins are the ``adja >= 0`` entries; the
    two-channel max over (-q_twin, -f) reproduces argmin's first-index
    tie-break; rows that are no candidate hold 0, and every read of them
    is masked by ``cand_full``).  With ``set_bdy_tags`` the MG_BDY
    tagging of the ``build_adjacency`` it replaces is applied from the
    same sort (not on a sub-mesh, whose cut faces are not boundary).
    Returns (mesh, fstar, t2_full, f2_full, cand_full)."""
    t, f, partner, matched, valid_s = face_sort(mesh)
    if set_bdy_tags:
        mesh = bdy_tags_from_sort(mesh, t, f, matched, valid_s)
    p = partner.long()
    tp, fp = t[p], f[p]
    tl, fl, tpl, fpl = t.long(), f.long(), tp.long(), fp.long()
    own_s = matched & (t < tp) & (mesh.ftag[tl, fl] == 0) & \
        (mesh.ftag[tpl, fpl] == 0)
    is_star, _, _ = scatter_argmax2(t, -q_tet[tpl], -f, own_s, capT)
    tbl = set_drop(torch.zeros((capT, 3), dtype=torch.int32,
                               device=mesh.device),
                   torch.where(is_star, t, torch.full_like(t, capT)),
                   torch.stack([f, tp, fp], dim=1))
    cand_full = torch.zeros(capT, dtype=torch.bool, device=mesh.device)
    cand_full[tl[own_s]] = True
    return (mesh, tbl[:, 0].long(), tbl[:, 1].long(), tbl[:, 2].long(),
            cand_full)


def swap23_wave(mesh: Mesh, met: torch.Tensor, budget_div: int = 8,
                wwin: torch.Tensor | None = None, facesort: bool = False,
                set_bdy_tags: bool = True) -> SwapResult:
    """2-to-3 swap: interior faces whose two tets improve as an edge fan
    (T1, T2 sharing (p,q,r) with apexes a, b become (p,q,a,b), (q,r,a,b),
    (r,p,a,b)).  Reads ``adja``, or with ``facesort`` pairs the faces off
    the face sort of ``mesh`` as it stands (replaying the MG_BDY tagging
    of the ``build_adjacency`` call that path skips, unless
    ``set_bdy_tags`` is False) and leaves ``adja`` stale, as the JAX
    package does.  ``wwin`` [capP] bool keeps the pairs whose first tet
    lies wholly in the morton window (``ops/active.py``)."""
    capT, capP = mesh.capT, mesh.capP
    dev = mesh.device
    inf = float("inf")
    q_tet = _quality(mesh.vert, mesh.tet.long(), met)
    if facesort:
        mesh, fstar, t2_full, f2_full, cand_full = _pair_fields_facesort(
            mesh, q_tet, capT, set_bdy_tags)
    else:
        fstar, t2_full, f2_full, cand_full = _pair_fields_adja(mesh, q_tet,
                                                               capT)
    if wwin is not None:
        cand_full = cand_full & \
            wwin[mesh.tet.clamp(0, capP - 1).long()].all(dim=1)
    q_pair = torch.minimum(q_tet, torch.where(cand_full, q_tet[t2_full],
                                              torch.full_like(q_tet, inf)))
    F = min(capT, wave_budget(capT, budget_div))
    neg, ncand = topk_prep(cand_full, q_pair)
    defer = ncand > F
    _, sel = topk_lowest_index(neg, F)
    ar = torch.arange(F, device=dev)
    t1 = sel
    f1 = fstar[sel]
    t2 = t2_full[sel]
    f2 = f2_full[sel]
    cand = cand_full[sel]

    idir = torch.from_numpy(IDIR).to(dev)
    tv1 = mesh.tet[t1]
    tv2 = mesh.tet[t2]
    pqr = tv1[ar[:, None], idir[f1]]
    a = tv1[ar, f1]
    b = tv2[ar, f2]
    p, q, r = pqr[:, 0], pqr[:, 1], pqr[:, 2]

    def mk(v0, v1, v2, v3):
        return torch.stack([v0, v1, v2, v3], dim=1)

    def signed_vol(tets):
        pts = mesh.vert[tets.long()]
        d1 = pts[:, 1] - pts[:, 0]
        d2 = pts[:, 2] - pts[:, 0]
        d3 = pts[:, 3] - pts[:, 0]
        return (d1 * _cross(d2, d3)).sum(-1)

    n1 = mk(p, q, a, b)
    n2 = mk(q, r, a, b)
    n3 = mk(r, p, a, b)
    pos = (signed_vol(n1) > EPSD) & (signed_vol(n2) > EPSD) & \
        (signed_vol(n3) > EPSD)
    cand = cand & (mesh.tref[t1] == mesh.tref[t2])
    q_old = torch.minimum(q_tet[t1], q_tet[t2])
    q_fan = _quality(mesh.vert, torch.cat([n1, n2, n3]).long(), met)
    q_new = torch.minimum(torch.minimum(q_fan[:F], q_fan[F:2 * F]),
                          q_fan[2 * F:])
    cand = cand & pos & \
        (q_new > torch.clamp(SWAP_GAIN * q_old, min=QUAL_FLOOR))

    win = claim_shells(q_new - q_old, cand, (t1, t2), capT)
    win = win & ~_first_dup(a, b, win, capP)
    frow_t, nfree_t = free_rows(mesh.tmask, F)
    w_i = win.to(torch.int32)
    off = torch.cumsum(w_i, 0) - w_i
    win = win & (off < torch.clamp(nfree_t, max=F))
    w_i = win.to(torch.int32)
    off = torch.cumsum(w_i, 0) - w_i
    t3 = frow_t[off.clamp(0, F - 1)]

    eof = torch.from_numpy(_EDGE_OF).to(dev)
    pos_p1, pos_q1, pos_r1 = idir[f1][:, 0], idir[f1][:, 1], idir[f1][:, 2]
    eqm2 = tv2[:, None, :] == pqr[:, :, None]
    P2x = torch.argmax(eqm2.to(torch.uint8), dim=2)
    pos_p2, pos_q2, pos_r2 = P2x[:, 0], P2x[:, 1], P2x[:, 2]
    zero_u = torch.zeros(F, dtype=torch.int32, device=dev)

    def route_f(arr, pos_opp1, pos_opp2):
        return torch.stack([zero_u, zero_u, arr[t2, pos_opp2],
                            arr[t1, pos_opp1]], dim=1)

    def route_e(pos_x1, pos_y1, pos_x2, pos_y2):
        et_ = mesh.etag
        return torch.stack([et_[t1, eof[pos_x1, pos_y1]],
                            et_[t1, eof[pos_x1, f1]],
                            et_[t2, eof[pos_x2, f2]],
                            et_[t1, eof[pos_y1, f1]],
                            et_[t2, eof[pos_y2, f2]], zero_u], dim=1)

    ftag_n = [route_f(mesh.ftag, pos_r1, pos_r2),
              route_f(mesh.ftag, pos_p1, pos_p2),
              route_f(mesh.ftag, pos_q1, pos_q2)]
    fref_n = [route_f(mesh.fref, pos_r1, pos_r2),
              route_f(mesh.fref, pos_p1, pos_p2),
              route_f(mesh.fref, pos_q1, pos_q2)]
    etag_n = [route_e(pos_p1, pos_q1, pos_p2, pos_q2),
              route_e(pos_q1, pos_r1, pos_q2, pos_r2),
              route_e(pos_r1, pos_p1, pos_r2, pos_p2)]

    capTt = torch.full_like(t1, capT)
    idx3 = torch.cat([torch.where(win, tt, capTt) for tt in (t1, t2, t3)])
    t3w = torch.where(win, t3, capTt)
    nsw = w_i.sum(dtype=torch.int32)
    nelem = torch.maximum(mesh.nelem, torch.where(
        win, t3 + 1, torch.zeros_like(t3)).max().to(torch.int32))
    out = replace(
        mesh,
        tet=set_drop(mesh.tet, idx3, torch.cat([n1, n2, n3])),
        tmask=set_drop(mesh.tmask, t3w, True),
        tref=set_drop(mesh.tref, t3w, mesh.tref[t1]),
        ftag=set_drop(mesh.ftag, idx3, torch.cat(ftag_n)),
        etag=set_drop(mesh.etag, idx3, torch.cat(etag_n)),
        fref=set_drop(mesh.fref, idx3, torch.cat(fref_n)),
        nelem=nelem)
    return SwapResult(out, nsw, defer)
