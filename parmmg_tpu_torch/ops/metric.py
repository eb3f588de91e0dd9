"""Metric synthesis, clamping, hausd bound and gradation (port of
``ops/metric.py``).  A metric is an iso size map [capP] or a packed tensor
map [capP, 6] (m11, m12, m13, m22, m23, m33); the hausd bound and the
gradation apply to iso metrics only and return a tensor metric as it is,
as in the JAX package."""
from __future__ import annotations

import numpy as np
import torch

from ..core.constants import (HGRAD_DEFAULT, IDIR, MG_BDY, MG_CRN, MG_GEO,
                              MG_NOM, MG_PARBDY, MG_REQ)
from ..core.mesh import Mesh, tet_edge_vertices
from .primitives import reduce_drop


def metric_hsiz(mesh: Mesh, hsiz: float) -> torch.Tensor:
    """Constant target size (Mmg -hsiz)."""
    return torch.full((mesh.capP,), hsiz, dtype=torch.float32,
                      device=mesh.device)


def metric_optim(mesh: Mesh) -> torch.Tensor:
    """Local mean incident-edge length per vertex (Mmg -optim)."""
    ev = tet_edge_vertices(mesh.tet).reshape(-1, 2)
    evl = ev.long()
    l = torch.sqrt(torch.clamp(
        ((mesh.vert[evl[:, 1]] - mesh.vert[evl[:, 0]]) ** 2).sum(-1),
        min=0.0))
    valid = mesh.tmask.repeat_interleave(6)
    w = valid.to(torch.float32)
    acc = torch.zeros(mesh.capP + 1, device=mesh.device)
    cnt = torch.zeros(mesh.capP + 1, device=mesh.device)
    for side in range(2):
        idx = torch.where(valid, ev[:, side],
                          torch.full_like(ev[:, side], mesh.capP))
        acc = reduce_drop(acc, idx, l * w, "sum")
        cnt = reduce_drop(cnt, idx, w, "sum")
    h = acc[:-1] / torch.clamp(cnt[:-1], min=1.0)
    return torch.where(mesh.vmask, h, torch.ones_like(h))


def hausd_metric_bound(mesh: Mesh, met, hausd: float, hmin: float):
    """Bound boundary sizes by the surface approximation tolerance
    (h <= sqrt(8 hausd / kappa)); host numpy, once per run.  Iso only."""
    from .analysis import boundary_vertex_normals
    if met.dim() != 1:
        return met
    vn = boundary_vertex_normals(mesh).cpu().numpy()
    tm = mesh.tmask.cpu().numpy()
    tet = mesh.tet.cpu().numpy()[tm]
    ftag = mesh.ftag.cpu().numpy()[tm]
    vtag = mesh.vtag.cpu().numpy()
    tris = []
    for f in range(4):
        sel = (ftag[:, f] & MG_BDY) != 0
        if sel.any():
            tris.append(tet[sel][:, IDIR[f]])
    if not tris:
        return met
    tris = np.concatenate(tris)
    ed = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]])
    sing = MG_GEO | MG_CRN | MG_REQ | MG_PARBDY | MG_NOM
    ok = ((vtag[ed[:, 0]] & sing) == 0) & ((vtag[ed[:, 1]] & sing) == 0)
    ed = ed[ok]
    if not len(ed):
        return met
    vh = mesh.vert.cpu().numpy()
    dn = np.linalg.norm(vn[ed[:, 0]] - vn[ed[:, 1]], axis=1)
    dl = np.linalg.norm(vh[ed[:, 0]] - vh[ed[:, 1]], axis=1)
    kappa = dn / np.maximum(dl, 1e-30)
    kv = np.zeros(mesh.capP)
    np.maximum.at(kv, ed[:, 0], kappa)
    np.maximum.at(kv, ed[:, 1], kappa)
    with np.errstate(divide="ignore"):
        h_geom = np.sqrt(8.0 * hausd / np.maximum(kv, 1e-30))
    h_geom = np.maximum(np.where(kv > 1e-12, h_geom, np.inf), hmin)
    return torch.minimum(met, torch.from_numpy(h_geom).to(met))


def clamp_metric(met: torch.Tensor, hmin: float, hmax: float):
    """Iso: clamp sizes to [hmin, hmax]; tensor: clamp each tensor's
    eigenvalues to [1/hmax^2, 1/hmin^2] and rebuild V diag(w) V^T."""
    if met.dim() == 1:
        return torch.clamp(met, hmin, hmax)
    from .quality import unpack_sym
    w, v = torch.linalg.eigh(unpack_sym(met))
    w = torch.clamp(w, 1.0 / hmax ** 2, 1.0 / hmin ** 2)
    mc = torch.einsum("...ij,...j,...kj->...ik", v, w, v)
    return torch.stack([mc[..., 0, 0], mc[..., 0, 1], mc[..., 0, 2],
                        mc[..., 1, 1], mc[..., 1, 2], mc[..., 2, 2]], -1)


def gradation(mesh: Mesh, met: torch.Tensor, hgrad: float = HGRAD_DEFAULT,
              max_sweeps: int = 20) -> torch.Tensor:
    """Bound relative size growth along edges (Mmg -hgrad): h_b <= h_a +
    (hgrad - 1) d, by ``max_sweeps`` Jacobi scatter-min sweeps.  Iso
    only: a tensor metric is returned as it is."""
    if met.dim() != 1:
        return met
    ev = tet_edge_vertices(mesh.tet).reshape(-1, 2)
    evl = ev.long()
    valid = mesh.tmask.repeat_interleave(6)
    d = torch.sqrt(torch.clamp(
        ((mesh.vert[evl[:, 1]] - mesh.vert[evl[:, 0]]) ** 2).sum(-1),
        min=0.0))
    slope = hgrad - 1.0
    n = met.shape[0]
    i0 = torch.where(valid, ev[:, 0], torch.full_like(ev[:, 0], n))
    i1 = torch.where(valid, ev[:, 1], torch.full_like(ev[:, 1], n))
    for _ in range(max_sweeps):
        cap0 = met[evl[:, 1]] + slope * d
        cap1 = met[evl[:, 0]] + slope * d
        lim = torch.full((n + 1,), float("inf"), dtype=met.dtype,
                         device=met.device)
        lim = reduce_drop(lim, i0, cap0, "amin")
        lim = reduce_drop(lim, i1, cap1, "amin")
        met = torch.minimum(met, lim[:-1])
    return met
