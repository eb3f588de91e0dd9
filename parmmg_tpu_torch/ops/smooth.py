"""Batched vertex smoothing (port of ``ops/smooth.py``): ball-centroid
proposals for interior points, tangential moves on flat boundary patches,
a 3-step relaxation cascade gated on the ball's min quality, and a
wave-rotated hash independent set."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import (EPSD, IDIR, MG_BDY, MG_CRN, MG_GEO, MG_NOM,
                              MG_PARBDY, MG_REF, MG_REQ, QUAL_FLOOR)
from ..core.mesh import Mesh, replace
from .edges import PRI_MIN, _mul32, morton_codes, to_int32_bits
from .primitives import reduce_drop
from .quality import corner_metric, quality_from_points

FLAT_RATIO = 0.9998
_IDIR = IDIR.tolist()


class SmoothResult(NamedTuple):
    mesh: Mesh
    nmoved: torch.Tensor     # 0-d int32


def _wave_hash(capP: int, wave: int, device) -> torch.Tensor:
    """Bijective per-wave vertex priority (uint32 mix of the JAX package,
    in int64 with 32-bit masks)."""
    h = _mul32(torch.arange(capP, dtype=torch.int64, device=device),
               2654435761)
    h = (h + (wave % 2 ** 32) * 2246822519) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    h = _mul32(h, 2654435761)
    h = h ^ (h >> 13)
    return to_int32_bits(h)


def morton_window_mask(vert: torch.Tensor, vmask: torch.Tensor, wave,
                       nwin: int) -> torch.Tensor:
    """[capP] bool: the vertices of the ``wave % nwin``-th contiguous,
    equal-population segment of the morton curve (the window rotation of
    ``ops/active.py``).  15-bit codes, a 1024-bin histogram of the live
    vertices and its CDF rank: integer arithmetic only."""
    code = morton_codes(vert, vmask, bits=5)
    b = (code >> 5).long()
    hist = torch.zeros(1024, dtype=torch.int32, device=vert.device)
    hist = hist.index_add(0, b, vmask.to(torch.int32))
    cdf = torch.cumsum(hist, 0, dtype=torch.int32)
    n_live = torch.clamp(cdf[-1], min=1)
    rank0 = (cdf - hist)[b]
    win = torch.div(rank0 * nwin, n_live, rounding_mode="floor")
    return win == int(wave) % nwin


def smooth_wave(mesh: Mesh, met: torch.Tensor, wave: int = 0,
                relax: float = 1.0,
                opt_q: float | None = None,
                vact: torch.Tensor | None = None) -> SmoothResult:
    """One smoothing wave; ``opt_q`` moves interior vertices of balls
    below ``opt_q`` along the height of their worst tet instead.
    ``vact`` [capP] bool restricts the moves to active vertices (the
    narrow cycles and windows of ``ops/active.py``)."""
    capT, capP = mesh.capT, mesh.capP
    dev = mesh.device
    inf = float("inf")
    movable_int = mesh.vmask & ((mesh.vtag & (MG_BDY | MG_REQ | MG_CRN |
                                              MG_PARBDY)) == 0)
    reg_bdy = mesh.vmask & ((mesh.vtag & MG_BDY) != 0) & \
        ((mesh.vtag & (MG_REQ | MG_CRN | MG_PARBDY | MG_GEO | MG_NOM |
                       MG_REF)) == 0)
    if vact is not None:
        movable_int = movable_int & vact
        reg_bdy = reg_bdy & vact
    tv = mesh.tet
    tvl = tv.long()
    vpos = mesh.vert[tvl]
    centroid = vpos.mean(dim=1)
    capPt = torch.full_like(tv[:, 0], capP)
    idx4 = torch.cat([torch.where(mesh.tmask, tv[:, k], capPt)
                      for k in range(4)])
    pay = torch.cat([torch.cat([centroid, torch.ones((capT, 1), device=dev)],
                               dim=1)] * 4)
    acc4 = reduce_drop(torch.zeros((capP + 1, 4), device=dev), idx4, pay,
                       "sum")
    prop = acc4[:capP, :3] / torch.clamp(acc4[:capP, 3:], min=1.0)

    isb = ((mesh.ftag & MG_BDY) != 0) & mesh.tmask[:, None]
    fv = tv[:, _IDIR]
    fp = mesh.vert[fv.long()]
    fn = torch.linalg.cross(fp[:, :, 1] - fp[:, :, 0],
                            fp[:, :, 2] - fp[:, :, 0], dim=-1)
    fc = fp.mean(dim=2)
    farea = 0.5 * torch.sqrt((fn * fn).sum(-1))
    idx12 = torch.cat([torch.where(isb[:, f], fv[:, f, k], capPt)
                       for f in range(4) for k in range(3)])
    w4 = torch.where(isb, farea, torch.zeros_like(farea))
    fn_unit = fn / (torch.linalg.norm(fn, dim=-1, keepdim=True) + EPSD)
    pay_f = torch.cat([fn, w4[..., None] * fc, w4[..., None], fn_unit,
                       torch.ones_like(w4)[..., None]], dim=-1)
    pay12 = torch.cat([pay_f[:, f] for f in range(4) for _ in range(3)])
    sacc = reduce_drop(torch.zeros((capP + 1, 11), device=dev), idx12, pay12,
                       "sum")
    nacc, cacc, aacc = sacc[:, :3], sacc[:, 3:6], sacc[:, 6]
    uacc, ucnt = sacc[:, 7:10], sacc[:, 10]
    navg = nacc[:capP] / (torch.linalg.norm(nacc[:capP], dim=-1,
                                            keepdim=True) + EPSD)
    ratio = torch.linalg.norm(uacc[:capP], dim=-1) / \
        torch.clamp(ucnt[:capP], min=1.0)
    flat = (ratio >= FLAT_RATIO) & (aacc[:capP] > 0)
    bdy_ok = reg_bdy & flat
    cbar = cacc[:capP] / torch.clamp(aacc[:capP, None], min=EPSD)
    dvec = cbar - mesh.vert
    dvec = dvec - (dvec * navg).sum(-1, keepdim=True) * navg
    prop = torch.where(bdy_ok[:, None], mesh.vert + dvec, prop)
    movable = movable_int | bdy_ok

    mq = corner_metric(met, tvl)
    q_old = quality_from_points(vpos, mq)
    minq_old = reduce_drop(
        torch.full((capP + 1,), inf, device=dev), idx4,
        torch.where(mesh.tmask, q_old, torch.full_like(q_old, inf))
        .repeat(4), "amin")[:capP]

    if opt_q is not None:
        sworst = torch.where(mesh.tmask, -q_old,
                             torch.full_like(q_old, -inf))
        vworst = reduce_drop(torch.full((capP + 1,), -inf, device=dev), idx4,
                             sworst.repeat(4), "amax")[:capP]
        dacc = torch.zeros((capP + 1, 4), device=dev)
        for k in range(4):
            i0, i1, i2 = _IDIR[k]
            p0 = vpos[:, i0]
            nrm = torch.linalg.cross(vpos[:, i1] - p0, vpos[:, i2] - p0,
                                     dim=-1)
            n2 = torch.clamp((nrm * nrm).sum(-1, keepdim=True), min=EPSD)
            d = nrm * (((vpos[:, k] - p0) * nrm).sum(-1, keepdim=True) / n2)
            is_w = mesh.tmask & (sworst >= vworst[tvl[:, k]])
            pay_w = torch.cat([torch.where(is_w[:, None], d,
                                           torch.zeros_like(d)),
                               is_w[:, None].to(torch.float32)], dim=1)
            dacc = reduce_drop(dacc, torch.where(is_w, tv[:, k], capPt),
                               pay_w, "sum")
        cnt = torch.clamp(dacc[:capP, 3:], min=1.0)
        prop_opt = mesh.vert + dacc[:capP, :3] / cnt
        use_opt = movable_int & (minq_old < opt_q) & (dacc[:capP, 3] > 0)
        prop = torch.where(use_opt[:, None], prop_opt, prop)

    mq4 = None if mq is None else mq.repeat(4, 1, 1)
    newpos = mesh.vert
    best_gain = torch.zeros(capP, device=dev)
    tmask4 = mesh.tmask.repeat(4)
    for step in (relax, 0.5 * relax, 0.25 * relax):
        cand_pos = mesh.vert + step * (prop - mesh.vert)
        cand_pos = torch.where(movable[:, None], cand_pos, mesh.vert)
        newp = cand_pos[tvl]
        variants = []
        for k in range(4):
            vk = vpos.clone()
            vk[:, k] = newp[:, k]
            variants.append(vk)
        qv = quality_from_points(torch.cat(variants), mq4)
        minq_new = reduce_drop(
            torch.full((capP + 1,), inf, device=dev), idx4,
            torch.where(tmask4, qv, torch.full_like(qv, inf)), "amin")
        gain = minq_new[:capP] - minq_old
        ok = (minq_new[:capP] > torch.clamp(minq_old, min=QUAL_FLOOR)) & \
            movable
        take = ok & (gain > best_gain)
        newpos = torch.where(take[:, None], cand_pos, newpos)
        best_gain = torch.where(take, gain, best_gain)
    gain_tol = torch.where(minq_old < 0.2, torch.zeros_like(minq_old),
                           0.02 * minq_old)
    improves = best_gain > gain_tol

    h = _wave_hash(capP, int(wave), dev)
    vpri = torch.where(improves, h, torch.full_like(h, PRI_MIN))
    vpri_c = vpri[tvl]
    tclaim = torch.where(mesh.tmask[:, None], vpri_c,
                         torch.full_like(vpri_c, PRI_MIN)).max(dim=1).values
    mism4 = torch.cat([improves[tvl[:, k]] & (tclaim != vpri_c[:, k])
                       for k in range(4)])
    lost = reduce_drop(torch.zeros(capP + 1, dtype=torch.bool, device=dev),
                       idx4, mism4, "amax")
    win = improves & ~lost[:capP]
    vert = torch.where(win[:, None], newpos, mesh.vert)
    return SmoothResult(replace(mesh, vert=vert), win.sum(dtype=torch.int32))
