"""Synthetic meshes and metrics for tests and the chip smoke run.

The port's own numpy copy of the generators in
``parmmg_tpu/utils/fixtures.py``.
"""
from __future__ import annotations

import numpy as np

# Kuhn/Freudenthal split of a unit cell into 6 tets sharing the main
# diagonal; corner i of the cell has offsets (i&1, (i>>1)&1, (i>>2)&1)
_KUHN_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 5, 7],
    [0, 2, 3, 7],
    [0, 2, 6, 7],
    [0, 4, 5, 7],
    [0, 4, 6, 7],
], dtype=np.int64)


def cube_mesh(n: int = 4):
    """Structured [0,1]^3 cube: (n+1)^3 vertices, 6*n^3 tets.

    Returns (vert [np,3] float64, tet [ne,4] int32), positively oriented.
    """
    k = n + 1
    g = np.arange(k) / n
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    vert = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, l):
        return (i * k + j) * k + l

    ii, jj, ll = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                             indexing="ij")
    base = np.stack([ii.ravel(), jj.ravel(), ll.ravel()], 1)
    corners = np.empty((base.shape[0], 8), np.int64)
    for c in range(8):
        off = np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1])
        q = base + off
        corners[:, c] = vid(q[:, 0], q[:, 1], q[:, 2])
    tet = corners[:, _KUHN_TETS].reshape(-1, 4)
    tet = _orient_positive(vert, tet)
    return vert, tet.astype(np.int32)


def sphere_mesh(n: int = 8):
    """Unit ball: cube_mesh(n) mapped radially onto the ball (graded)."""
    vert, tet = cube_mesh(n)
    c = vert * 2.0 - 1.0
    linf = np.max(np.abs(c), axis=1)
    l2 = np.linalg.norm(c, axis=1)
    scale = np.where(l2 > 1e-12, linf / np.maximum(l2, 1e-12), 1.0)
    vert = c * scale[:, None]
    tet = _orient_positive(vert, tet)
    return vert, tet.astype(np.int32)


def torus_mesh(nu: int = 12, nc: int = 4, R: float = 1.0, r: float = 0.4):
    """Solid torus of centreline radius R and tube radius r: a square
    cross-section of nc cells mapped onto the disk, extruded around nu
    stations with periodic Kuhn cells (conforming across the wrap)."""
    kc = nc + 1
    g = np.arange(kc) / nc * 2.0 - 1.0
    A, B = np.meshgrid(g, g, indexing="ij")
    ab = np.stack([A.ravel(), B.ravel()], axis=1)
    linf = np.max(np.abs(ab), axis=1)
    l2 = np.linalg.norm(ab, axis=1)
    scale = np.where(l2 > 1e-12, linf / np.maximum(l2, 1e-12), 1.0)
    disk = ab * scale[:, None] * r
    vert = []
    for u in np.arange(nu) / nu * 2.0 * np.pi:
        x = (R + disk[:, 0]) * np.cos(u)
        y = (R + disk[:, 0]) * np.sin(u)
        vert.append(np.stack([x, y, disk[:, 1]], axis=1))
    vert = np.concatenate(vert)

    def vid(i, j, l):
        return (i % nu) * (kc * kc) + j * kc + l

    ii, jj, ll = np.meshgrid(np.arange(nu), np.arange(nc), np.arange(nc),
                             indexing="ij")
    base = np.stack([ii.ravel(), jj.ravel(), ll.ravel()], 1)
    corners = np.empty((base.shape[0], 8), np.int64)
    for c in range(8):
        off = np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1])
        q = base + off
        corners[:, c] = vid(q[:, 0], q[:, 1], q[:, 2])
    tet = corners[:, _KUHN_TETS].reshape(-1, 4)
    tet = _orient_positive(vert, tet)
    return vert, tet.astype(np.int32)


def cylinder_mesh(n: int = 6, r: float = 0.5):
    """Solid cylinder (radius r, height 1, axis z): cube_mesh(n) with the
    (x, y) cross-section mapped onto the disk; the cap rims are curved
    ridge lines."""
    vert, tet = cube_mesh(n)
    c = vert[:, :2] * 2.0 - 1.0
    linf = np.max(np.abs(c), axis=1)
    l2 = np.linalg.norm(c, axis=1)
    scale = np.where(l2 > 1e-12, linf / np.maximum(l2, 1e-12), 1.0)
    vert = np.concatenate([c * scale[:, None] * r, vert[:, 2:]], axis=1)
    tet = _orient_positive(vert, tet)
    return vert, tet.astype(np.int32)


def _orient_positive(vert, tet):
    p = vert[tet]
    det = np.einsum("ti,ti->t", p[:, 1] - p[:, 0],
                    np.cross(p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]))
    flip = det < 0
    tet = tet.copy()
    tet[flip, 0], tet[flip, 1] = tet[flip, 1], tet[flip, 0].copy()
    return tet


def analytic_iso_metric(vert: np.ndarray, kind: str = "uniform",
                        h: float = 0.1):
    """Test metrics: uniform h, or a planar 'shock' refinement band."""
    if kind == "uniform":
        return np.full(vert.shape[0], h)
    if kind == "shock":
        d = np.abs(vert[:, 0] - 0.5)
        return h * (0.2 + 4.0 * d)
    raise ValueError(kind)


def analytic_ani_metric(vert: np.ndarray, kind: str = "shock",
                        h: float = 0.1, h_tan: float = 0.45):
    """Packed tensor test metrics [n, 6] (m11, m12, m13, m22, m23, m33):
    ``shock`` asks for spacing ``h (0.2 + 4 |x - 0.5|)`` across the plane
    x = 0.5 and ``h_tan`` along it."""
    if kind == "shock":
        d = np.abs(vert[:, 0] - 0.5)
        hx = h * (0.2 + 4.0 * d)
        m = np.zeros((vert.shape[0], 6))
        m[:, 0] = 1.0 / hx ** 2
        m[:, 3] = 1.0 / h_tan ** 2
        m[:, 5] = 1.0 / h_tan ** 2
        return m
    raise ValueError(kind)


def ball_shock_metric(vert: np.ndarray, h: float = 3.0 / 16.0):
    """The planar "shock" iso size map of ``analytic_iso_metric`` carried
    from the unit cube onto the ball [-1, 1]^3 (lengths doubled): size
    ``h (0.2 + 2 |x|)``, smallest on the plane x = 0."""
    return h * (0.2 + 2.0 * np.abs(vert[:, 0]))


def linear_fields(vert: np.ndarray):
    """A scalar and a 3-vector field, both linear in (x, y, z), which P1
    interpolation reproduces exactly: (temp [n], vel [n, 3])."""
    x, y, z = vert[:, 0], vert[:, 1], vert[:, 2]
    temp = 1.0 + 2.0 * x - 3.0 * y + 0.5 * z
    vel = np.stack([x + y, 2.0 * y - z + 1.0, 3.0 * z - x], axis=1)
    return temp, vel


def end_slabs_partition(vert: np.ndarray, tet: np.ndarray,
                        core: float = 0.05) -> np.ndarray:
    """[ne] int32: a 4-part decomposition of the unit cube in x slabs for
    the ``shock`` map (refined around x = 0.5): part 0 holds the two end
    slabs x < 0.1 and x >= 0.9, part 2 the shock's core |x - 0.5| <
    ``core``, parts 1 and 3 the slabs between (by tet centroid).  After a
    pass the end slabs' clusters have more faces to parts 1 and 3 than to
    each other, and parts 1 and 3 have room, so graph-mode
    repartitioning moves some of them."""
    x = vert[tet].mean(axis=1)[:, 0]
    cuts = [0.1, 0.5 - core, 0.5 + core, 0.9]
    return np.array([0, 1, 2, 3, 0], np.int32)[np.searchsorted(cuts, x)]


def steady_state_migration_scenario(niter: int = 4, cycles: int = 2,
                                    n_shards: int = 2, device="cuda",
                                    return_all: bool = False):
    """``niter`` distributed passes with the migration between them over
    a small cube whose interface sizes drift every pass: cube_mesh(2) at
    6x capacity under a uniform size 0.4, ``n_shards`` shards stacked on
    ``device`` (the card unless the caller asks for the CPU).  Returns
    the adapted merged mesh, or (mesh, met, part) with ``return_all``."""
    import torch
    from ..api.parmesh import resolve_device
    from ..core.mesh import make_mesh
    from ..ops.analysis import analyze_mesh
    from ..parallel import dist

    vert, tet = cube_mesh(2)
    m = make_mesh(vert, tet, capP=6 * len(vert), capT=6 * len(tet),
                  device=resolve_device(device))
    m = analyze_mesh(m).mesh
    met = torch.full((m.capP,), 0.4, dtype=m.vert.dtype, device=m.device)
    out, met_m, part = dist.distributed_adapt_multi(
        m, met, n_shards, niter=niter, cycles=cycles)
    return (out, met_m, part) if return_all else out
