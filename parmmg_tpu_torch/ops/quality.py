"""Tet quality and metric edge lengths (port of ``ops/quality.py``).

Quality is normalised so the equilateral tet scores 1:
``Q = ALPHA_TET * V / (sum_e l(e)^2)^{3/2}``.  The iso metric is a size
``h`` per vertex; quality in an iso metric is Euclidean (a constant local
scale cancels), as in the JAX package.  ``tet_quality`` dispatches to the
K6 kernel (``ops/kernels.tet_quality``); the waves evaluate hypothetical
configurations with :func:`quality_from_points`, as the reference does.
"""
from __future__ import annotations

import torch

from ..core.constants import ALPHA_TET, EPSD, IARE
from ..core.mesh import Mesh, tet_edge_vertices

_EDGE_I = IARE[:, 0].tolist()
_EDGE_J = IARE[:, 1].tolist()


def unpack_sym(m6: torch.Tensor) -> torch.Tensor:
    """[..., 6] packed symmetric -> [..., 3, 3]."""
    m11, m12, m13, m22, m23, m33 = m6.unbind(-1)
    row0 = torch.stack([m11, m12, m13], -1)
    row1 = torch.stack([m12, m22, m23], -1)
    row2 = torch.stack([m13, m23, m33], -1)
    return torch.stack([row0, row1, row2], -2)


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once (a fused multiply-add), through
    float64 where the float32 product is exact."""
    return (a.double() * b.double() + c.double()).float()


def quad_form(e: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """e^T M e for e [..., 3] and M [..., 3, 3] (broadcast), rounded as
    ``jnp.einsum("...i,...ij,...j->...")`` rounds on the CPU: XLA's first
    dot sums e_i M_ij over i as a chain of FMAs, its second sums e_j d_j
    over j with plain adds."""
    d = [_fma(m[..., 2, j], e[..., 2],
              _fma(m[..., 1, j], e[..., 1], m[..., 0, j] * e[..., 0]))
         for j in range(3)]
    return e[..., 0] * d[0] + e[..., 1] * d[1] + e[..., 2] * d[2]


def det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3]: ``jnp.linalg.det``'s closed form for
    3x3, with the multiply-adds XLA's CPU code fuses, so the bits agree."""
    s = _fma(a[..., 0, 0] * a[..., 1, 1], a[..., 2, 2],
             a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0])
    s = _fma(a[..., 0, 2] * a[..., 1, 0], a[..., 2, 1], s)
    s = _fma(-(a[..., 0, 2] * a[..., 1, 1]), a[..., 2, 0], s)
    s = _fma(-(a[..., 0, 0] * a[..., 1, 2]), a[..., 2, 1], s)
    return _fma(-(a[..., 0, 1] * a[..., 1, 0]), a[..., 2, 2], s)


def iso_to_tensor(h: torch.Tensor) -> torch.Tensor:
    """Iso size h -> packed tensor diag(1/h^2)."""
    w = 1.0 / torch.clamp(h, min=EPSD) ** 2
    z = torch.zeros_like(w)
    return torch.stack([w, z, z, w, z, w], -1)


def edge_length_iso(p0, p1, h0, h1):
    """Metric length of segment p0p1 with linearly varying iso size
    (log-mean of 1/h, arithmetic mean when h0 ~ h1)."""
    d = torch.sqrt(torch.clamp(((p1 - p0) ** 2).sum(-1), min=0.0))
    r0 = 1.0 / torch.clamp(h0, min=EPSD)
    r1 = 1.0 / torch.clamp(h1, min=EPSD)
    close = (r0 - r1).abs() < 1e-6 * torch.maximum(r0, r1)
    one = torch.ones_like(r0)
    ratio = torch.where(close, one, h0 / torch.clamp(h1, min=EPSD))
    logr = torch.log(torch.clamp(ratio, min=EPSD))
    lm = torch.where(close, 0.5 * (r0 + r1),
                     (r1 - r0) / torch.where(close, one, logr))
    return d * lm


def edge_length_ani(p0, p1, m0, m1):
    """Aniso metric length from the endpoint tensors [..., 6]:
    l_i = sqrt(e^T M_i e), l = 2/3 (l0^2 + l0 l1 + l1^2) / (l0 + l1)."""
    e = p1 - p0
    q0 = quad_form(e, unpack_sym(m0))
    q1 = quad_form(e, unpack_sym(m1))
    l0 = torch.sqrt(torch.clamp(q0, min=0.0))
    l1 = torch.sqrt(torch.clamp(q1, min=0.0))
    s = torch.clamp(l0 + l1, min=EPSD)
    return (2.0 / 3.0) * (l0 * l0 + l0 * l1 + l1 * l1) / s


def corner_metric(met: torch.Tensor, tets: torch.Tensor):
    """The per-corner metric for :func:`quality_from_points` of the tets
    with vertex ids ``tets`` [..., 4]: None under an iso metric (quality
    is Euclidean, a constant local scale cancels), the packed tensors
    [..., 4, 6] under a tensor metric."""
    return None if met.dim() == 1 else met[tets]


def tet_edge_lengths(mesh: Mesh, met: torch.Tensor) -> torch.Tensor:
    """[capT, 6] metric length of every tet edge (iso [capP] or packed
    tensor [capP, 6] metric)."""
    ev = tet_edge_vertices(mesh.tet).long()
    p0 = mesh.vert[ev[..., 0]]
    p1 = mesh.vert[ev[..., 1]]
    length = edge_length_iso if met.dim() == 1 else edge_length_ani
    return length(p0, p1, met[ev[..., 0]], met[ev[..., 1]])


def quality_from_points(p: torch.Tensor, m6: torch.Tensor | None = None):
    """Quality of tets given corners ``p`` [..., 4, 3]; ``m6`` optional
    per-corner packed metric [..., k, 6] averaged over its corner axis."""
    d1 = p[..., 1, :] - p[..., 0, :]
    d2 = p[..., 2, :] - p[..., 0, :]
    d3 = p[..., 3, :] - p[..., 0, :]
    vol = (d1 * torch.linalg.cross(d2, d3, dim=-1)).sum(-1) / 6.0
    e = p[..., _EDGE_J, :] - p[..., _EDGE_I, :]
    if m6 is None:
        rap = (e * e).sum(-1).sum(-1)
        num = ALPHA_TET * vol
    else:
        # the metric branch rounds as the JAX package's does on the CPU:
        # the quadratic forms and the determinant as above, the six edge
        # terms summed left to right (torch's sum pairs them)
        mbar = unpack_sym(m6.mean(dim=-2))
        l2 = quad_form(e, mbar[..., None, :, :])
        rap = l2[..., 0]
        for k in range(1, 6):
            rap = rap + l2[..., k]
        det = det3(mbar)
        num = ALPHA_TET * vol * torch.sqrt(torch.clamp(det, min=0.0))
    q = num / torch.clamp(rap, min=EPSD) ** 1.5
    return torch.where(vol > 0, torch.clamp(q, max=1.0),
                       torch.clamp(q, max=0.0))


def tet_quality(mesh: Mesh, met: torch.Tensor | None = None):
    """[capT] quality, 0 on dead slots (K6 kernel on the card)."""
    from .kernels import tet_quality as k6
    met6 = met if (met is not None and met.dim() == 2) else None
    return k6(mesh.vert, mesh.tet, mesh.tmask, met6)


def quality_histogram(q: torch.Tensor, tmask: torch.Tensor, nbins: int = 5):
    """(counts[nbins], qmin, qmean, n_bad) over valid tets."""
    n = torch.clamp(tmask.sum(), min=1)
    qmin = torch.where(tmask, q, torch.full_like(q, torch.inf)).min()
    qmean = torch.where(tmask, q, torch.zeros_like(q)).sum() / n
    edges = torch.linspace(0.0, 1.0, nbins + 1, device=q.device)
    qc = torch.clamp(q, 0.0, 1.0 - 1e-9)
    idx = torch.clamp(torch.searchsorted(edges, qc, right=True) - 1,
                      0, nbins - 1)
    counts = torch.zeros(nbins, dtype=torch.int32, device=q.device)
    counts.index_add_(0, idx, tmask.to(torch.int32))
    n_bad = ((q <= 0.0) & tmask).sum()
    return counts, qmin, qmean, n_bad


def length_histogram(mesh: Mesh, met: torch.Tensor, nbins: int = 9):
    """Edge-length statistics over unique edges: (counts, lmin, lmax,
    lmean) in the reference's 9-bin layout."""
    from .primitives import lexsort
    big = 2147483647
    ev = tet_edge_vertices(mesh.tet).reshape(-1, 2)
    a = torch.minimum(ev[:, 0], ev[:, 1])
    b = torch.maximum(ev[:, 0], ev[:, 1])
    lens = tet_edge_lengths(mesh, met).reshape(-1)
    valid = mesh.tmask.repeat_interleave(6)
    a = torch.where(valid, a, torch.full_like(a, big))
    b = torch.where(valid, b, torch.full_like(b, big))
    order = lexsort(a, b)
    ka, kb = a[order], b[order]
    first = torch.ones_like(valid)
    first[1:] = (ka[1:] != ka[:-1]) | (kb[1:] != kb[:-1])
    uniq = first & valid[order]
    lv = lens[order]
    n = torch.clamp(uniq.sum(), min=1)
    inf = torch.full_like(lv, torch.inf)
    lmin = torch.where(uniq, lv, inf).min()
    lmax = torch.where(uniq, lv, -inf).max()
    lmean = torch.where(uniq, lv, torch.zeros_like(lv)).sum() / n
    bounds = torch.tensor([0.0, 0.3, 0.6, 0.7071, 0.9, 1.3, 1.4142, 2.0,
                           5.0, float("inf")], device=lv.device)
    idx = torch.clamp(torch.searchsorted(bounds, lv, right=True) - 1,
                      0, nbins - 1)
    counts = torch.zeros(nbins, dtype=torch.int32, device=lv.device)
    counts.index_add_(0, idx, uniq.to(torch.int32))
    return counts, lmin, lmax, lmean
