"""Background-mesh localization and P1 interpolation (port of
``ops/interp.py``).

After a remesh, the metric and the user's solution fields are carried from
the *background* copy of the mesh taken before adaptation onto the new
vertices: each new vertex is located in the background tetrahedra by an
adjacency walk with barycentric sign tests, with an exhaustive search for
the walks that fail, then P1-interpolated.  Boundary vertices are located
on the background's boundary triangles instead (a surface walk with a
closest-triangle search), so that a point on a curved boundary takes its
value from the surface.  For a tensor metric the inverse tensors are
combined barycentrically and inverted back.

The JAX package runs each walk as a ``lax.while_loop`` under ``vmap``: every
lane steps until the slowest is done.  Here a walk is one loop over all
points at once, with the same step rule: a point that has stopped keeps
its tet and its step count.  The loop reads the host once every
``_CHECK_EVERY`` steps, to drop the points that have stopped from the set
that steps on; a point that stops inside those steps is carried, masked,
to their end.  The exhaustive searches run only on the points that need
them, picked out on the host, in chunks that bound their ``[chunk, capT]``
temporaries to about 2**24 elements.

Every sum here is written out term by term, and every product is its own
elementwise op (no ``einsum``, no matmul, no fused cross product), so a
CUDA tensor and a CPU tensor go through the same IEEE operations in the
same order: a walk, and so a tie between two tets or triangles, comes out
the same on the card as on the CPU.  The one exception is the 3x3
inversion of tensor metrics (``torch.linalg.inv``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import EPSD, IDIR, MG_BDY
from ..core.mesh import Mesh, _table
from .edges import sort_pairs
from .quality import unpack_sym

# steps a walk takes between two reads of its active set to the host
_CHECK_EVERY = 8


class LocateResult(NamedTuple):
    tet: torch.Tensor     # [M] int32 containing (or closest) background tet
    bary: torch.Tensor    # [M, 4] barycentric coordinates in that tet
    failed: torch.Tensor  # [M] bool: the walk failed (fallback used)
    steps: torch.Tensor   # [M] int32 walk steps


class SurfLocateResult(NamedTuple):
    tri: torch.Tensor     # [M] int32 surface slot (4 * tet + face)
    bary: torch.Tensor    # [M, 3] triangle barycentric coordinates
    dist: torch.Tensor    # [M] distance to the triangle's plane (signed)
    failed: torch.Tensor  # [M] bool: the closest-triangle search was used


def _sum(x):
    """Sum over the last axis, left to right."""
    parts = x.unbind(-1)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _cross(a, b):
    """Cross product over the last axis, broadcast (``jnp.cross``'s
    formula)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _dot(a, b):
    return _sum(a * b)


def _vol(q0, q1, q2, q3):
    """Six times the signed volume of (q0, q1, q2, q3), broadcast."""
    return _dot(q1 - q0, _cross(q2 - q0, q3 - q0))


def _point(w, v):
    """sum_k w[..., k] v[..., k, :]: the point of weights w [..., k] on
    corners v [..., k, 3]."""
    out = w[..., 0, None] * v[..., 0, :]
    for k in range(1, w.shape[-1]):
        out = out + w[..., k, None] * v[..., k, :]
    return out


def _bary_of(p, pt):
    """Barycentric coordinates of ``pt`` [..., 3] in the tets of corner
    points ``p`` [..., 4, 3] (broadcast): each face-opposite volume over
    the tet's."""
    p0, p1, p2, p3 = p.unbind(-2)
    vol = _vol(p0, p1, p2, p3)
    vols = torch.stack([_vol(pt, p1, p2, p3), _vol(p0, pt, p2, p3),
                        _vol(p0, p1, pt, p3), _vol(p0, p1, p2, pt)], -1)
    return vols / torch.where(vol.abs() > EPSD, vol,
                              torch.ones_like(vol))[..., None]


def _barycentric(bg_vert, bg_tet, tid, pt):
    """Barycentric coordinates of points ``pt`` [M, 3] in background tets
    ``tid`` [M]."""
    return _bary_of(bg_vert[bg_tet[tid.long()].long()], pt)


def _walk(t, pts, step, max_steps: int):
    """Step every point until ``step`` stops it or ``max_steps`` steps
    have run.  ``step(t, pts) -> (next tet, stop)`` for a subset of the
    points.  Returns (tets, steps)."""
    steps = torch.zeros(t.shape[0], dtype=torch.int32, device=t.device)
    ids = torch.arange(t.shape[0], device=t.device)
    s = 0
    while s < max_steps and ids.numel():
        tt, pp = t[ids], pts[ids]
        st = torch.zeros_like(ids, dtype=torch.int32)
        live = torch.ones_like(ids, dtype=torch.bool)
        for _ in range(min(_CHECK_EVERY, max_steps - s)):
            nxt, stop = step(tt, pp)
            tt = torch.where(live, nxt, tt)
            st += live.to(torch.int32)
            live &= ~stop
        s += min(_CHECK_EVERY, max_steps - s)
        t = t.index_put((ids,), tt)
        steps = steps.index_put((ids,), st, accumulate=True)
        ids = ids[live]                      # the one host read of a chunk
    return t, steps


def _fallback_chunk(nf: int) -> int:
    """Points per exhaustive-search chunk: bounds the [chunk, nf]
    temporaries to about 2**24 elements."""
    return max(1, (1 << 24) // max(nf, 1))


def locate_points(bg: Mesh, points: torch.Tensor, start: torch.Tensor,
                  max_steps: int = 256, tol: float = -1e-4) -> LocateResult:
    """Walk-locate each point [M, 3] in the background mesh from the tet
    hints ``start`` [M]; the failed walks take the exhaustive search (the
    live tet whose smallest barycentric coordinate is largest)."""
    adja = bg.adja

    def step(t, pt):
        bar = _barycentric(bg.vert, bg.tet, t, pt)
        inside = bar.min(-1).values >= tol
        worst = bar.argmin(-1)
        nxt = adja[t.long(), worst]
        stop = inside | (nxt < 0)
        return torch.where(stop, t, nxt >> 2), stop

    tids, steps = _walk(start.to(torch.int32), points, step, max_steps)
    bary = _barycentric(bg.vert, bg.tet, tids, points)
    failed = ~(bary.min(-1).values >= tol)

    fidx = failed.nonzero().squeeze(1)
    if fidx.numel():
        tids[fidx], bary[fidx] = exhaustive_tets(bg, points[fidx])
    return LocateResult(tids, bary, failed, steps)


def exhaustive_tets(bg: Mesh, points: torch.Tensor):
    """For each point [M, 3], the live tet whose smallest barycentric
    coordinate is largest, and the coordinates there: (tet [M] int32,
    bary [M, 4]).  Chunks of points bound the [chunk, capT]
    temporaries."""
    p = bg.vert[bg.tet.long()]                         # [T, 4, 3]
    tids = torch.empty(points.shape[0], dtype=torch.int32,
                       device=points.device)
    bary = torch.empty((points.shape[0], 4), dtype=points.dtype,
                       device=points.device)
    chunk = _fallback_chunk(bg.capT)
    for i in range(0, points.shape[0], chunk):
        bar = _bary_of(p, points[i: i + chunk, None, :])   # [C, T, 4]
        score = torch.where(bg.tmask, bar.min(-1).values,
                            torch.full((), float("-inf"), device=bar.device))
        best = score.argmax(-1)
        tids[i: i + chunk] = best.to(torch.int32)
        bary[i: i + chunk] = bar[torch.arange(bar.shape[0],
                                              device=bar.device), best]
    return tids, bary


def _weights(bary):
    """Barycentric weights clipped to the simplex (the closest-point
    semantics for points that fell outside)."""
    w = bary.clamp(0.0, 1.0)
    return w / _sum(w)[..., None].clamp(min=EPSD)


def _combine(values, corners, bary):
    vals = values[corners.long()]                       # [M, k, ...]
    w = _weights(bary)
    w = w.reshape(w.shape + (1,) * (vals.dim() - 2))
    out = vals[:, 0] * w[:, 0]
    for k in range(1, vals.shape[1]):
        out = out + vals[:, k] * w[:, k]
    return out


def _combine_ani(met6, corners, bary):
    """Invert each corner tensor, combine with the barycentric weights,
    invert back (the reference's scheme for tensor metrics)."""
    w = _weights(bary)
    eye = torch.eye(3, dtype=met6.dtype, device=met6.device) * EPSD
    m = unpack_sym(met6[corners.long()])
    minv = torch.linalg.inv(m + eye)
    comb = w[:, 0, None, None] * minv[:, 0]
    for k in range(1, w.shape[1]):
        comb = comb + w[:, k, None, None] * minv[:, k]
    out = torch.linalg.inv(comb + eye)
    return torch.stack([out[:, 0, 0], out[:, 0, 1], out[:, 0, 2],
                        out[:, 1, 1], out[:, 1, 2], out[:, 2, 2]], -1)


def interp_p1(values, bg_tet, loc: LocateResult):
    """P1-interpolate per-vertex values [capP_bg, ...] at located points."""
    return _combine(values, bg_tet[loc.tet.long()], loc.bary)


def interp_metric_ani(met6, bg_tet, loc: LocateResult):
    """Tensor metric [capP_bg, 6] at located points, by inverse-tensor
    combination."""
    return _combine_ani(met6, bg_tet[loc.tet.long()], loc.bary)


def _surface_tri(bg: Mesh):
    return bg.tet[:, _table(IDIR, bg.device)].reshape(bg.capT * 4, 3)


def surface_triangulation(bg: Mesh):
    """The background's boundary surface as a fixed-shape triangle set:
    (tri [4T, 3] vertex ids, fmask [4T], tadj [4T, 3]), one slot per
    (tet, face); ``tadj[s, i]`` is the surface slot across the edge
    opposite local vertex i, or -1.  The edges are paired by the sort
    engine (``edges.sort_pairs``: K7, then K8 in its gathered mode), a
    stable sort, so the pairing at non-manifold edges is the JAX
    package's."""
    F = bg.capT * 4
    tri = _surface_tri(bg)
    fm = (((bg.ftag & MG_BDY) != 0) & bg.tmask[:, None]).reshape(F)
    pairs = ((1, 2), (0, 2), (0, 1))
    a = torch.cat([torch.minimum(tri[:, i], tri[:, j]) for i, j in pairs])
    b = torch.cat([torch.maximum(tri[:, i], tri[:, j]) for i, j in pairs])
    dev = bg.device
    slot = torch.arange(F, dtype=torch.int32, device=dev).repeat(3)
    eloc = torch.arange(3, dtype=torch.int32, device=dev).repeat_interleave(F)
    order, ka, _, first = sort_pairs(a, b, fm.repeat(3), bg.capP)
    eq_next = ~first[1:] & (ka[:-1] != torch.iinfo(torch.int32).max)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    same_next = torch.cat([eq_next, no])
    same_prev = torch.cat([no, eq_next])
    idx = torch.arange(3 * F, device=dev)
    partner = torch.where(same_next, idx + 1,
                          torch.where(same_prev, idx - 1, idx))
    sls, els = slot[order], eloc[order]
    nb = torch.where(same_next | same_prev, sls[partner],
                     torch.full_like(sls, -1))
    tadj = torch.full((F, 3), -1, dtype=torch.int32, device=dev)
    tadj.index_put_((sls.long(), els.long()), nb)
    return tri, fm, tadj


def _bar_tri(p, a, b, c):
    """Barycentric coordinates [..., 3] of ``p`` projected on the
    triangles (a, b, c), and its signed distance to their planes."""
    n = _cross(b - a, c - a)
    n2 = _dot(n, n).clamp(min=EPSD)
    w0 = _dot(_cross(b - p, c - p), n)
    w1 = _dot(_cross(c - p, a - p), n)
    w2 = _dot(_cross(a - p, b - p), n)
    bar = torch.stack([w0, w1, w2], -1) / n2[..., None]
    dist = _dot(p - a, n) / n2.sqrt()
    return bar, dist


def _clipped(bar):
    cb = bar.clamp(0.0, 1.0)
    return cb / _sum(cb)[..., None].clamp(min=EPSD)


def _norm(x):
    return _dot(x, x).sqrt()


def locate_points_bdy(bg: Mesh, points: torch.Tensor,
                      start: torch.Tensor | None = None,
                      max_steps: int = 256,
                      tol: float = -1e-4) -> SurfLocateResult:
    """Surface walk-location of boundary points on the background's
    boundary triangles.  A walk crosses the edge of the most negative
    projected barycentric; a point past a vertex or an edge takes the
    clipped barycentrics.  The closest-triangle search runs on the
    suspect points (failed walks, and landings farther from their
    triangle than 5% of its diameter: the wrong side of a closed
    surface) and wins where it is closer than the walk's landing."""
    tri, fm, tadj = surface_triangulation(bg)
    F = tri.shape[0]
    first = fm.to(torch.uint8).argmax().to(torch.int32)
    if start is None:
        start = first.expand(points.shape[0]).clone()
    else:
        start = torch.where(fm[start.long().clamp(0, F - 1)],
                            start.to(torch.int32), first)
    vert = bg.vert

    def step(t, pt):
        v = vert[tri[t.long()].long()]
        bar, _ = _bar_tri(pt, v[:, 0], v[:, 1], v[:, 2])
        inside = bar.min(-1).values >= tol
        nxt = tadj[t.long(), bar.argmin(-1)]
        stop = inside | (nxt < 0)
        return torch.where(stop, t, nxt), stop

    tids, _ = _walk(start, points, step, max_steps)
    v = vert[tri[tids.long()].long()]                  # [M, 3, 3]
    bary, dist = _bar_tri(points, v[:, 0], v[:, 1], v[:, 2])
    failed = ~(bary.min(-1).values >= tol)
    cb = _clipped(bary)
    dwalk = _norm(points - _point(cb, v))
    diam = torch.maximum(torch.maximum(_dot(v[:, 1] - v[:, 0],
                                            v[:, 1] - v[:, 0]),
                                       _dot(v[:, 2] - v[:, 0],
                                            v[:, 2] - v[:, 0])),
                         _dot(v[:, 2] - v[:, 1], v[:, 2] - v[:, 1])).sqrt()

    use_fb = torch.zeros_like(failed)
    sidx = (failed | (dwalk > 0.05 * diam + 1e-12)).nonzero().squeeze(1)
    if sidx.numel():
        vall = vert[tri.long()]                        # [F, 3, 3]
        v0, v1, v2 = vall.unbind(1)
        n = _cross(v1 - v0, v2 - v0)
        n2 = _dot(n, n).clamp(min=EPSD)
        inf = torch.full((), float("inf"), device=points.device)
        chunk = _fallback_chunk(F)
        for i in range(0, sidx.numel(), chunk):
            sel = sidx[i: i + chunk]
            pt = points[sel][:, None, :]               # [C, 1, 3]
            w0 = _dot(_cross(v1 - pt, v2 - pt), n)
            w1 = _dot(_cross(v2 - pt, v0 - pt), n)
            w2 = _dot(_cross(v0 - pt, v1 - pt), n)
            cbf = _clipped(torch.stack([w0, w1, w2], -1) / n2[:, None])
            e = pt - _point(cbf, vall)
            d = torch.where(fm, _dot(e, e), inf)
            best = d.argmin(-1)
            rows = torch.arange(sel.numel(), device=sel.device)
            fb_d = d[rows, best].sqrt()
            use = failed[sel] | (dwalk[sel] > fb_d * (1.0 + 1e-3) + 1e-12)
            tids[sel] = torch.where(use, best.to(torch.int32), tids[sel])
            bary[sel] = torch.where(use[:, None], cbf[rows, best], bary[sel])
            dist[sel] = torch.where(use, fb_d, dist[sel])
            use_fb[sel] = use
    return SurfLocateResult(tids, bary, dist, use_fb)


def interp_p1_tri(values, bg: Mesh, loc: SurfLocateResult):
    """P1 interpolation over the located surface triangles."""
    return _combine(values, _surface_tri(bg)[loc.tri.long()], loc.bary)


def interp_metric_ani_tri(met6, bg: Mesh, loc: SurfLocateResult):
    """Inverse-tensor interpolation over the located surface triangles."""
    return _combine_ani(met6, _surface_tri(bg)[loc.tri.long()], loc.bary)


def interpolate_from_background(bg: Mesh, bg_met: torch.Tensor, mesh: Mesh,
                                met: torch.Tensor,
                                bg_fields: torch.Tensor | None = None,
                                only_new: torch.Tensor | None = None,
                                start: torch.Tensor | None = None):
    """Carry the metric (and fields) from a background mesh onto
    ``mesh``'s vertices.  ``only_new`` [capP] bool selects the vertices to
    overwrite (default: every live one); the others keep ``met``.
    Boundary vertices of the selection take the surface location.
    Returns (met', fields' or None, LocateResult)."""
    sel = mesh.vmask if only_new is None else (only_new & mesh.vmask)
    pts = mesh.vert
    if start is None:
        start = torch.zeros(mesh.capP, dtype=torch.int32, device=mesh.device)
    loc = locate_points(bg, pts, start)
    bidx = (((mesh.vtag & MG_BDY) != 0) & sel).nonzero().squeeze(1)
    sloc = locate_points_bdy(bg, pts[bidx]) if bidx.numel() else None
    if bg_met.dim() == 1:
        met_i = interp_p1(bg_met, bg.tet, loc)
        met_b = interp_p1_tri(bg_met, bg, sloc) if sloc is not None else None
    else:
        met_i = interp_metric_ani(bg_met, bg.tet, loc)
        met_b = interp_metric_ani_tri(bg_met, bg, sloc) \
            if sloc is not None else None
    if sloc is not None:
        met_i[bidx] = met_b.to(met_i.dtype)
    met_out = torch.where(sel.reshape(sel.shape + (1,) * (met.dim() - 1)),
                          met_i.to(met.dtype), met)
    fields_out = None
    if bg_fields is not None:
        fields_out = interp_p1(bg_fields, bg.tet, loc)
        if sloc is not None:
            fields_out[bidx] = interp_p1_tri(bg_fields, bg, sloc).to(
                fields_out.dtype)
    return met_out, fields_out, loc
