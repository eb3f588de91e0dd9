"""Generalized edge swaps for shell degree 4-6 (port of
``ops/swapgen.py``): the ring around an interior edge is re-triangulated
by the best of its fan triangulations, each triangle giving the two tets
(T, a) and (T, b)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import EDGE_FACES, EPSD, LLONG, QUAL_FLOOR
from ..core.mesh import Mesh, replace
from ..utils.compilecache import governed
from .edges import claim_shells, free_rows, unique_edges, wave_budget
from .primitives import set_drop, topk_lowest_index
from .quality import (corner_metric, edge_length_ani, edge_length_iso,
                      quality_from_points)
from .swap import SWAP_GAIN, _EDGE_OF

RING_MAX = 6
NTRI = RING_MAX - 2
NT_NEW = 2 * NTRI


class SwapGenResult(NamedTuple):
    mesh: Mesh
    nswap: torch.Tensor      # 0-d int32


def swapgen_wave(mesh: Mesh, met: torch.Tensor, budget_div: int = 8,
                 lmax: float | None = None) -> SwapGenResult:
    if lmax is None:
        lmax = LLONG
    capT, capP = mesh.capT, mesh.capP
    dev = mesh.device
    inf = float("inf")
    et = unique_edges(mesh, shell_slots=RING_MAX)
    Efull = et.ev.shape[0]
    eof = torch.from_numpy(_EDGE_OF).to(dev)
    efaces = torch.from_numpy(EDGE_FACES).to(dev)

    tvl = mesh.tet.long()
    q_tet = quality_from_points(mesh.vert[tvl], corner_metric(met, tvl))
    sh_f = et.shell3
    shc_f = sh_f.clamp(0, capT - 1).long()
    slot_valid_f = sh_f >= 0
    qs = torch.where(slot_valid_f, q_tet[shc_f],
                     torch.full(sh_f.shape, inf, device=dev))
    q_shell_f = qs.min(dim=1).values
    tref0 = mesh.tref[shc_f[:, 0]]
    same_ref = (~slot_valid_f | (mesh.tref[shc_f] == tref0[:, None])).all(1)
    pre = et.emask & (et.etag == 0) & (et.nshell >= 4) & \
        (et.nshell <= RING_MAX) & same_ref
    K = min(Efull, wave_budget(capT, budget_div))
    _, selx = topk_lowest_index(
        torch.where(pre, -q_shell_f, torch.full_like(q_shell_f, -inf)), K)

    ar = torch.arange(K, device=dev)
    cand = pre[selx]
    n = et.nshell[selx].long()
    sh = sh_f[selx]
    shc = sh.clamp(0, capT - 1).long()
    slot_valid = (sh >= 0) & \
        (torch.arange(RING_MAX, device=dev)[None, :] < n[:, None])
    a = et.ev[selx, 0].clamp(0, capP - 1)
    b = et.ev[selx, 1].clamp(0, capP - 1)
    q_old = q_shell_f[selx]

    tvs = mesh.tet[shc]                                   # [K,6,4]
    is_a = tvs == a[:, None, None]
    is_b = tvs == b[:, None, None]
    is_ab = is_a | is_b
    cand = cand & (~slot_valid | (is_ab.sum(2) == 2)).all(dim=1)
    pos_a = torch.argmax(is_a.to(torch.uint8), dim=2)
    pos_b = torch.argmax(is_b.to(torch.uint8), dim=2)
    ordr = torch.sort(is_ab.to(torch.int32), dim=2, stable=True).indices
    x = torch.gather(tvs, 2, ordr[:, :, 0:1])[:, :, 0]
    y = torch.gather(tvs, 2, ordr[:, :, 1:2])[:, :, 0]

    lae = eof[pos_a, pos_b]
    ftags_sh = mesh.ftag[shc]
    fc = torch.gather(ftags_sh, 2, efaces[lae][..., 0:1])[..., 0]
    fc2 = torch.gather(ftags_sh, 2, efaces[lae][..., 1:2])[..., 0]
    cand = cand & (~slot_valid | ((fc == 0) & (fc2 == 0))).all(dim=1)

    ring = torch.zeros((K, RING_MAX), dtype=torch.int32, device=dev)
    tet_of_pair = torch.zeros((K, RING_MAX), dtype=torch.int64, device=dev)
    ring[:, 0] = x[:, 0]
    ring[:, 1] = y[:, 0]
    used = torch.zeros((K, RING_MAX), dtype=torch.bool, device=dev)
    used[:, 0] = True
    used = used | ~slot_valid
    cur = y[:, 0]
    for step in range(2, RING_MAX):
        active = step < n
        has = (~used) & ((x == cur[:, None]) | (y == cur[:, None]))
        j = torch.argmax(has.to(torch.uint8), dim=1)
        found = has.any(dim=1)
        xj = x[ar, j]
        yj = y[ar, j]
        other = torch.where(xj == cur, yj, xj)
        ring[:, step] = torch.where(active, other, ring[:, 0])
        tet_of_pair[:, step - 1] = torch.where(active, j,
                                               tet_of_pair[:, step - 1])
        used[ar, j] = used[ar, j] | (active & found)
        cand = cand & (~active | found)
        cur = torch.where(active, other, cur)
    r0 = ring[:, 0]
    has_close = (~used) & (((x == cur[:, None]) & (y == r0[:, None])) |
                           ((y == cur[:, None]) & (x == r0[:, None])))
    jc = torch.argmax(has_close.to(torch.uint8), dim=1)
    cand = cand & has_close.any(dim=1)
    nm1 = (n - 1).clamp(0, RING_MAX - 1)
    tet_of_pair[ar, nm1] = jc

    # rows with a shell wider than RING_MAX are never candidates; their
    # ring positions are clamped so every gather stays in range
    n_ix = n.clamp(max=RING_MAX)
    rpos = torch.arange(RING_MAX, device=dev)[None, :]
    rp1 = torch.where(rpos + 1 < n_ix[:, None], rpos + 1,
                      torch.zeros_like(rpos))
    ring_next = torch.gather(ring, 1, rp1)
    tp = torch.gather(shc, 1, tet_of_pair)
    tvp = mesh.tet[tp]
    pa_p = torch.argmax((tvp == a[:, None, None]).to(torch.uint8), dim=2)
    pb_p = torch.argmax((tvp == b[:, None, None]).to(torch.uint8), dim=2)
    pr_p = torch.argmax((tvp == ring[:, :, None]).to(torch.uint8), dim=2)
    pn_p = torch.argmax((tvp == ring_next[:, :, None]).to(torch.uint8),
                        dim=2)
    etag_p = mesh.etag[tp]
    ftag_p = mesh.ftag[tp]
    fref_p = mesh.fref[tp]

    def _take(rows, idx):
        return torch.gather(rows, 2, idx[..., None])[..., 0]

    ring_etag = _take(etag_p, eof[pr_p, pn_p])
    spoke_a = _take(etag_p, eof[pr_p, pa_p])
    spoke_b = _take(etag_p, eof[pr_p, pb_p])
    face_a = _take(ftag_p, pb_p)
    face_b = _take(ftag_p, pa_p)
    fref_a = _take(fref_p, pb_p)
    fref_b = _take(fref_p, pa_p)

    pav = mesh.vert[a.long()]
    pbv = mesh.vert[b.long()]
    ringp = mesh.vert[ring.clamp(0, capP - 1).long()]

    def ring_at(idx):
        m = torch.where(idx < n_ix, idx, idx - n_ix)
        return torch.where(m < n_ix, m, torch.zeros_like(m))

    def _elen(gu, gv):
        gu, gv = gu.long(), gv.long()
        length = edge_length_iso if met.dim() == 1 else edge_length_ani
        return length(mesh.vert[gu], mesh.vert[gv], met[gu], met[gv])

    kvalid = torch.arange(NTRI, device=dev)[None, :] < (n - 2)[:, None]
    mvalid = kvalid.repeat_interleave(2, dim=1)
    fan_q, fan_ok, fan_tets, fan_flip = [], [], [], []
    zk = torch.zeros(K, dtype=torch.int64, device=dev)
    for c in range(RING_MAX):
        active_fan = (c < n) & cand
        vols_a, vols_b, tris = [], [], []
        diag_long = torch.zeros(K, dtype=torch.bool, device=dev)
        for k in range(NTRI):
            i_i = ring_at(zk + c)
            i_j = ring_at(zk + c + k + 1)
            i_k = ring_at(zk + c + k + 2)
            pi, pj, pk = ringp[ar, i_i], ringp[ar, i_j], ringp[ar, i_k]
            nrm = torch.linalg.cross(pj - pi, pk - pi, dim=-1)
            vols_a.append((nrm * (pav - pi)).sum(-1))
            vols_b.append(-(nrm * (pbv - pi)).sum(-1))
            tris.append((i_i, i_j, i_k))
            kv = k < (n - 2)
            if k > 0:
                diag_long = diag_long | (
                    kv & (_elen(ring[ar, i_i], ring[ar, i_j]) > lmax))
            diag_long = diag_long | (
                kv & (k < n - 3) &
                (_elen(ring[ar, i_i], ring[ar, i_k]) > lmax))
        va_s = torch.stack(vols_a, 1)
        vb_s = torch.stack(vols_b, 1)
        tot_a = torch.where(kvalid, va_s, torch.zeros_like(va_s)).sum(dim=1)
        sgn = torch.where(tot_a >= 0, torch.ones_like(tot_a),
                          -torch.ones_like(tot_a))
        ok = (~kvalid | ((va_s * sgn[:, None] > EPSD) &
                         (vb_s * sgn[:, None] > EPSD))).all(dim=1) & \
            ~diag_long
        flip = sgn < 0
        tet_rows = []
        for (i_i, i_j, i_k) in tris:
            gi, gj, gk = ring[ar, i_i], ring[ar, i_j], ring[ar, i_k]
            tet_rows.append(torch.stack([torch.where(flip, gj, gi),
                                         torch.where(flip, gi, gj), gk, a],
                                        1))
            tet_rows.append(torch.stack([torch.where(flip, gi, gj),
                                         torch.where(flip, gj, gi), gk, b],
                                        1))
        rows = torch.stack(tet_rows, 1)                  # [K, NT_NEW, 4]
        rl = rows.reshape(K * NT_NEW, 4).long()
        qf = quality_from_points(mesh.vert[rl],
                                 corner_metric(met, rl)).reshape(K, NT_NEW)
        fan_q.append(torch.where(mvalid, qf,
                                 torch.full_like(qf, inf)).min(dim=1).values)
        fan_ok.append(active_fan & ok)
        fan_tets.append(rows)
        fan_flip.append(flip)

    fq = torch.stack(fan_q, 1)
    fok = torch.stack(fan_ok, 1)
    fq_m = torch.where(fok, fq, torch.full_like(fq, -inf))
    best_c = torch.argmax(fq_m, dim=1)
    q_new = fq_m[ar, best_c]
    cand = cand & fok.any(dim=1) & \
        (q_new > torch.clamp(SWAP_GAIN * q_old, min=QUAL_FLOOR))

    sh_eff = tuple(torch.where(slot_valid[:, k], shc[:, k], shc[:, 0])
                   for k in range(RING_MAX))
    win = claim_shells(q_new - q_old, cand, sh_eff, capT)

    LF = 2 * K
    frow_t, nfree_t = free_rows(mesh.tmask, LF)
    extra = torch.where(win, n - 4, torch.zeros_like(n))
    off = torch.cumsum(extra, 0) - extra
    win = win & ((off + extra) <= torch.clamp(nfree_t, max=LF))
    extra = torch.where(win, n - 4, torch.zeros_like(n))
    off = torch.cumsum(extra, 0) - extra

    tets_best = torch.stack(fan_tets, 1)[ar, best_c]      # [K, NT_NEW, 4]
    flip_best = torch.stack(fan_flip, 1)[ar, best_c]
    zero_u = torch.zeros(K, dtype=torch.int32, device=dev)

    def route(c_arr, k, apex_is_a):
        eff_flip = flip_best if apex_is_a else ~flip_best
        i_j = ring_at(c_arr + k + 1)
        i_k = ring_at(c_arr + k + 2)
        pair_j = i_j
        f_src = face_a if apex_is_a else face_b
        fr_src = fref_a if apex_is_a else fref_b
        sp_src = spoke_a if apex_is_a else spoke_b
        is_first = k == 0
        nlast = k == (n - 3)
        pair_c = ring_at(c_arr)
        pair_last = ring_at(c_arr + k + 2)
        f0 = f_src[ar, pair_j]
        f1 = torch.where(nlast, f_src[ar, pair_last], zero_u)
        f2 = f_src[ar, pair_c] if is_first else zero_u
        fr0 = fr_src[ar, pair_j]
        fr1 = torch.where(nlast, fr_src[ar, pair_last], zero_u)
        fr2 = fr_src[ar, pair_c] if is_first else zero_u
        ftag_n = torch.stack([torch.where(eff_flip, f1, f0),
                              torch.where(eff_flip, f0, f1), f2, zero_u], 1)
        fref_n = torch.stack([torch.where(eff_flip, fr1, fr0),
                              torch.where(eff_flip, fr0, fr1), fr2, zero_u],
                             1)
        e0 = ring_etag[ar, pair_c] if is_first else zero_u
        e1 = torch.where(nlast, ring_etag[ar, pair_last], zero_u)
        e2 = sp_src[ar, ring_at(c_arr)]
        e3 = ring_etag[ar, pair_j]
        e4 = sp_src[ar, i_j]
        e5 = sp_src[ar, i_k]
        cols = [e0, e1, e2, e3, e4, e5]
        flipped = [cols[0], cols[3], cols[4], cols[1], cols[2], cols[5]]
        etag_n = torch.stack([torch.where(eff_flip, fv, nv)
                              for nv, fv in zip(cols, flipped)], 1)
        return ftag_n, fref_n, etag_n

    ftag_rows, fref_rows, etag_rows = [], [], []
    for k in range(NTRI):
        for apex_is_a in (True, False):
            fa, fr, ea = route(best_c, k, apex_is_a)
            ftag_rows.append(fa)
            fref_rows.append(fr)
            etag_rows.append(ea)
    ftag_new = torch.stack(ftag_rows, 1)
    fref_new = torch.stack(fref_rows, 1)
    etag_new = torch.stack(etag_rows, 1)

    nsw = win.sum(dtype=torch.int32)
    out = mesh
    if int(nsw) > 0:
        idx_all = []
        for m in range(NT_NEW):
            valid_m = win & (m < 2 * (n - 2))
            pool = frow_t[(off + torch.clamp(m - n, min=0)).clamp(0, LF - 1)]
            tgt = torch.where(m < n, shc[:, min(m, RING_MAX - 1)], pool)
            idx_all.append(torch.where(valid_m, tgt,
                                       torch.full_like(tgt, capT)))
        idx_cat = torch.cat(idx_all)

        def flat(x_):
            return x_.transpose(0, 1).reshape(NT_NEW * K, x_.shape[2])

        out = replace(
            mesh,
            tet=set_drop(mesh.tet, idx_cat, flat(tets_best)),
            ftag=set_drop(mesh.ftag, idx_cat, flat(ftag_new)),
            fref=set_drop(mesh.fref, idx_cat, flat(fref_new)),
            etag=set_drop(mesh.etag, idx_cat, flat(etag_new)),
            tmask=set_drop(mesh.tmask, idx_cat, True),
            tref=set_drop(mesh.tref, idx_cat, tref0[selx].repeat(NT_NEW)))
    used_hi = torch.where(extra > 0,
                          frow_t[(off + extra - 1).clamp(0, LF - 1)] + 1,
                          torch.zeros_like(extra))
    nelem = torch.maximum(mesh.nelem, used_hi.max().to(torch.int32))
    return SwapGenResult(replace(out, nelem=nelem), nsw)


# the ledger's front door for callers outside a cycle (tests, diagnostics):
# the JAX package's ``ops.swapgen_wave`` entry point; the cycles call
# swapgen_wave itself
swapgen_wave_j = governed("ops.swapgen_wave", budget=4)(swapgen_wave)
