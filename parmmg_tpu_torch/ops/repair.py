"""Sequential last-resort repair of pathological sliver clusters (host).

Port of ``parmmg_tpu/ops/repair.py``: ``sequential_repair`` is the same
host-numpy pass (copied; tags arrive as int32 bit patterns), and
``repair_mesh`` wraps it for the port's torch Mesh.

The batched independent-set waves (ops/adapt.py) fix 99.9+% of bad
elements, but tangled clusters — stacks of near-flat tets where every
single parallel move inverts a neighbor — deadlock them: each candidate
is vetoed GIVEN the others' stationarity, while a sequential pass
resolves the chain one op at a time.  The reference remesher is fully
sequential (MMG3D_opttyp cascades collapse/swap/move per element,
mmg3d/opttyp.c via libparmmg1.c), so this pass reproduces exactly that
freedom for the tail: host numpy, worst-first, ball-local, a few dozen
tets at most.

Scope guard: only cavities with no face/edge tags are touched (tag
routing stays the batched kernels' job); frozen vertices are respected.
"""
from __future__ import annotations

import collections

import numpy as np

from ..core.constants import (
    IARE, IDIR, MG_BDY, MG_CRN, MG_GEO, MG_NOM, MG_PARBDY, MG_REF, MG_REQ)

_FROZEN_V = MG_REQ | MG_CRN | MG_PARBDY | MG_NOM


def _qual(p):
    """Euclidean tet quality (vol / sum |e|^2 ^1.5, ALPHA-normalized) for
    a [*,4,3] array — matches ops.quality.quality_from_points(iso)."""
    d1 = p[..., 1, :] - p[..., 0, :]
    d2 = p[..., 2, :] - p[..., 0, :]
    d3 = p[..., 3, :] - p[..., 0, :]
    vol = np.einsum("...i,...i->...", d1, np.cross(d2, d3)) / 6.0
    ee = 0.0
    for a in range(4):
        for b in range(a + 1, 4):
            e = p[..., b, :] - p[..., a, :]
            ee = ee + np.einsum("...i,...i->...", e, e)
    den = np.maximum(ee, 1e-30) ** 1.5
    return 8.48528137423857 * 6.0 * vol / den          # ALPHA_TET * 6V


def sequential_repair(vert, tet, tmask, vtag, vmask, tref, ftag, etag,
                      fref, q_floor: float = 1e-3, max_rounds: int = 4,
                      allow_collapse: bool = True, allow_swap: bool = True,
                      allow_move: bool = True):
    """Repair tets with quality < q_floor by sequential local ops.

    Operates on numpy copies; returns
    (vert, tet, tmask, vmask, tref, ftag, etag, fref, nfixed).
    Ops per bad tet, in order of preference: collapse an edge (both
    directions), 2-3/3-2 swap, relocate a free vertex (damped centroid
    line search) — each validated on the CURRENT state: no inversion
    anywhere in the touched ball and strict improvement of the cavity
    minimum.  Every touched cavity must be fully untagged (tag routing
    stays the batched kernels' job), so rewritten/resurrected slots carry
    all-zero face/edge tags by construction.
    """
    vert = np.array(vert, copy=True)
    tet = np.array(tet, copy=True)
    tmask = np.array(tmask, copy=True)
    vmask = np.array(vmask, copy=True)
    tref = np.array(tref, copy=True)
    ftag = np.array(ftag, copy=True)
    etag = np.array(etag, copy=True)
    fref = np.array(fref, copy=True)
    inc = collections.defaultdict(set)
    for t_i in np.where(tmask)[0]:
        for v in tet[t_i]:
            inc[int(v)].add(int(t_i))

    def ball(v):
        return [t for t in inc[v] if tmask[t]]

    def ball_q(ts):
        if not ts:
            return np.inf
        return float(_qual(vert[tet[np.asarray(ts)]]).min())

    _HARD_TAGS = MG_REQ | MG_PARBDY | MG_NOM

    def _edge_slot(t, a, b):
        tv = tet[t]
        for e, (i, j) in enumerate(IARE):
            u, v = int(tv[i]), int(tv[j])
            if (u == a and v == b) or (u == b and v == a):
                return e
        return -1

    def try_collapse(rm, kp):
        """Contract rm -> kp.  Interior vertices need a fully-untagged
        cavity (as before); a plain MG_BDY vertex may now slide along a
        boundary edge onto another boundary vertex (Mmg chkcol_bdy rule)
        with SEQUENTIAL tag routing: dying tets' tagged faces/edges are
        re-keyed (rm->kp) and OR-ed onto the surviving slots — the
        one-at-a-time version of collapse_wave's keyed joins.  This is
        the boundary-cap fix: the flattest surviving clusters sit ON the
        surface where the old all-untagged guard made them untouchable.
        """
        if vtag[rm] & (_FROZEN_V | MG_GEO | MG_REF):
            return False
        on_bdy = bool(vtag[rm] & MG_BDY)
        brm = ball(rm)
        if not brm:
            return False
        if on_bdy:
            if not (vtag[kp] & MG_BDY):
                return False
            # the contraction edge must itself be a boundary edge
            e_bdy = False
            for t in brm:
                e = _edge_slot(t, rm, kp)
                if e >= 0 and (etag[t][e] & MG_BDY):
                    e_bdy = True
                    break
            if not e_bdy:
                return False
            # restriction applies to entities INCIDENT TO rm (the Mmg
            # chkcol_bdy scope): hard-frozen faces/edges at rm, or a
            # feature line (GEO/REF edge) through rm, refuse; peripheral
            # tags elsewhere in the cavity are fine — dying tets' tags
            # are routed by the keyed join below
            for t in brm:
                tv_t = tet[t]
                for f in range(4):
                    if int(tv_t[f]) != rm and \
                            (ftag[t][f] & _HARD_TAGS):
                        return False     # face containing rm hard-frozen
                for e, (i, j) in enumerate(IARE):
                    if rm in (int(tv_t[i]), int(tv_t[j])) and \
                            (etag[t][e] & (_HARD_TAGS | MG_GEO | MG_REF)):
                        return False
        else:
            if not all(_untagged(t) for t in brm):
                return False
        dying = [t for t in brm if kp in tet[t]]
        moved = [t for t in brm if kp not in tet[t]]
        old_min = ball_q(brm)
        rows = []
        for t in moved:
            row = np.where(tet[t] == rm, kp, tet[t])
            rows.append(row)
        if rows:
            q_new = _qual(vert[np.asarray(rows)])
            if (q_new <= 0).any() or q_new.min() <= old_min:
                return False
        if on_bdy:
            # surface fold-over guard: boundary faces that contain rm
            # must keep their orientation after the move
            for t, row in zip(moved, rows):
                for f in range(4):
                    if not (ftag[t][f] & MG_BDY):
                        continue
                    tri = [int(tet[t][i]) for i in IDIR[f]]
                    if rm not in tri:
                        continue
                    tri_new = [kp if v == rm else v for v in tri]
                    n_old = np.cross(vert[tri[1]] - vert[tri[0]],
                                     vert[tri[2]] - vert[tri[0]])
                    n_new = np.cross(vert[tri_new[1]] - vert[tri_new[0]],
                                     vert[tri_new[2]] - vert[tri_new[0]])
                    if np.dot(n_old, n_new) <= 0:
                        return False
        # ---- tag routing from dying tets (sequential keyed join) ----
        def holders(v):
            """Tets that will contain v AFTER the remap rm->kp."""
            s = set(inc[v])
            if v == kp:
                s |= inc[rm]
            return s

        for t in dying:
            for f in range(4):
                if not (ftag[t][f] or fref[t][f]):
                    continue
                tri = [int(tet[t][i]) for i in IDIR[f]]
                key = frozenset(kp if v == rm else v for v in tri)
                if len(key) < 3:
                    continue             # face degenerates with the tet
                ks = list(key)
                cands = (holders(ks[0]) & holders(ks[1]) & holders(ks[2]))
                for t2 in cands:
                    if not tmask[t2] or t2 in dying:
                        continue
                    tv2 = [kp if int(v) == rm else int(v)
                           for v in tet[t2]]
                    for f2 in range(4):
                        if frozenset(tv2[i] for i in IDIR[f2]) == key:
                            ftag[t2][f2] |= ftag[t][f]
                            if fref[t2][f2] == 0:
                                fref[t2][f2] = fref[t][f]
            for e, (i, j) in enumerate(IARE):
                if not etag[t][e]:
                    continue
                a2 = kp if int(tet[t][i]) == rm else int(tet[t][i])
                b2 = kp if int(tet[t][j]) == rm else int(tet[t][j])
                if a2 == b2:
                    continue             # the contracted edge itself
                for t2 in (holders(a2) & holders(b2)):
                    if not tmask[t2] or t2 in dying:
                        continue
                    tv2 = [kp if int(v) == rm else int(v)
                           for v in tet[t2]]
                    for e2, (i2, j2) in enumerate(IARE):
                        u, v = tv2[i2], tv2[j2]
                        if (u == a2 and v == b2) or (u == b2 and v == a2):
                            etag[t2][e2] |= etag[t][e]
        for t in dying:
            tmask[t] = False
        for t, row in zip(moved, rows):
            tet[t] = row
            inc[int(kp)].add(t)
        vmask[rm] = False           # no orphan live vertices
        return True

    def _untagged(t):
        return not (ftag[t].any() or etag[t].any())

    def try_swap23(t):
        """2-3 swap on any interior untagged face of t."""
        if not _untagged(t):
            return False
        tv = tet[t]
        for f in range(4):
            tri = [int(tv[i]) for i in IDIR[f]]
            commons = (inc[tri[0]] & inc[tri[1]] & inc[tri[2]])
            commons = [c for c in commons if tmask[c] and c != t]
            if len(commons) != 1:
                continue
            t2 = commons[0]
            if not _untagged(t2):
                continue
            a = int(tv[f])
            b = int(next(v for v in tet[t2] if v not in tri))
            p, q, r = tri
            cav = [t, t2]
            old_min = ball_q(cav)
            rows = np.array([[p, q, a, b], [q, r, a, b], [r, p, a, b]])
            qn = _qual(vert[rows])
            if (qn <= 0).any():                  # try the mirrored fan
                rows = rows[:, [0, 1, 3, 2]]
                qn = _qual(vert[rows])
            if (qn <= 0).any() or qn.min() <= old_min * 1.02:
                continue
            dead = np.where(~tmask)[0]
            if not len(dead):
                continue
            free = int(dead[0])
            tet[t] = rows[0]
            tet[t2] = rows[1]
            tet[free] = rows[2]
            tmask[free] = True
            # the resurrected slot must not inherit a prior tenant's tags
            ftag[free] = 0
            etag[free] = 0
            fref[free] = 0
            tref[free] = tref[t]
            for row, ti in ((rows[0], t), (rows[1], t2), (rows[2], free)):
                for v in row:
                    inc[int(v)].add(int(ti))
            return True
        return False

    def try_swap32(t):
        """3-2 swap on any interior untagged 3-shell edge of t."""
        if not _untagged(t):
            return False
        tv = tet[t]
        for i, j in IARE:
            a, b = int(tv[i]), int(tv[j])
            shell = [c for c in (inc[a] & inc[b]) if tmask[c]]
            if len(shell) != 3:
                continue
            if not all(_untagged(c) for c in shell):
                continue
            ring = []
            for c in shell:
                ring += [int(v) for v in tet[c] if v != a and v != b]
            ring = list(dict.fromkeys(ring))
            if len(ring) != 3:
                continue
            p, q, r = ring
            old_min = ball_q(shell)
            for newa, newb in (([p, q, r, a], [q, p, r, b]),
                               ([q, p, r, a], [p, q, r, b])):
                rows = np.array([newa, newb])
                qn = _qual(vert[rows])
                if (qn > 0).all() and qn.min() > old_min * 1.02:
                    t1, t2, t3 = shell
                    tet[t1] = rows[0]
                    tet[t2] = rows[1]
                    tmask[t3] = False
                    for row, ti in ((rows[0], t1), (rows[1], t2)):
                        for v in row:
                            inc[int(v)].add(int(ti))
                    return True
        return False

    def try_relocate(v):
        if vtag[v] & (_FROZEN_V | MG_BDY | MG_GEO | MG_REF):
            return False
        bv = ball(v)
        if not bv:
            return False
        rows = tet[np.asarray(bv)]
        old_min = float(_qual(vert[rows]).min())
        cent = vert[rows].mean(axis=(0, 1))
        p0 = vert[v].copy()
        for step in (1.0, 0.5, 0.25, 0.1):
            vert[v] = p0 + step * (cent - p0)
            q = _qual(vert[rows])
            if (q > 0).all() and q.min() > old_min * 1.02:
                return True
            vert[v] = p0
        return False

    nfixed = 0
    if not (allow_collapse or allow_swap or allow_move):
        max_rounds = 0
    for _ in range(max_rounds):
        live = np.where(tmask)[0]
        if not len(live):
            break
        q = _qual(vert[tet[live]])
        bad = live[q < q_floor]
        if not len(bad):
            break
        order = bad[np.argsort(q[q < q_floor])]
        progressed = False
        for t in order:
            if not tmask[t]:
                continue
            if _qual(vert[tet[t]][None])[0] >= q_floor:
                continue
            done = False
            if allow_collapse:
                # edges sorted by length: shortest first (the cap)
                pts = vert[tet[t]]
                el = [(np.linalg.norm(pts[j] - pts[i]), i, j)
                      for i, j in IARE]
                for _d, i, j in sorted(el):
                    a, b = int(tet[t][i]), int(tet[t][j])
                    if try_collapse(a, b) or try_collapse(b, a):
                        done = True
                        break
            if not done and allow_swap:
                done = try_swap23(t) or try_swap32(t)
            if not done and allow_move:
                for k in range(4):
                    if try_relocate(int(tet[t][k])):
                        done = True
                        break
            if done:
                nfixed += 1
                progressed = True
        if not progressed:
            break
    return vert, tet, tmask, vmask, tref, ftag, etag, fref, nfixed


def _quality_probe(vert, tet):
    """Tet quality of every slot (the repair tail's first look, the JAX
    package's ``repair.quality_probe`` entry point)."""
    from .quality import quality_from_points
    return quality_from_points(vert[tet.long()])


def repair_mesh(mesh, met, q_floor: float = 1e-3,
                allow_collapse: bool = True, allow_swap: bool = True,
                allow_move: bool = True):
    """Run sequential_repair on a Mesh and rebuild adjacency / boundary
    tags; a cheap no-op when no live tet is below ``q_floor``."""
    import torch
    from ..core.mesh import replace
    from .adjacency import build_adjacency, boundary_edge_tags
    from ..utils.compilecache import track

    q = track("repair.quality_probe", _quality_probe, mesh.vert, mesh.tet)
    if not bool((mesh.tmask & (q < q_floor)).any()):
        return mesh, 0

    def h(t):
        return t.cpu().numpy()

    (vert, tet, tmask, vmask, tref, ftag, etag, fref,
     nfixed) = sequential_repair(
        h(mesh.vert), h(mesh.tet), h(mesh.tmask), h(mesh.vtag),
        h(mesh.vmask), h(mesh.tref), h(mesh.ftag), h(mesh.etag),
        h(mesh.fref), q_floor=q_floor, allow_collapse=allow_collapse,
        allow_swap=allow_swap, allow_move=allow_move)
    if nfixed == 0:
        return mesh, 0
    live = np.where(tmask)[0]
    nelem = int(live.max()) + 1 if len(live) else 0
    dev = mesh.device

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = replace(
        mesh, vert=d(vert), tet=d(tet), tmask=d(tmask), vmask=d(vmask),
        tref=d(tref), ftag=d(ftag), etag=d(etag), fref=d(fref),
        nelem=torch.tensor(max(nelem, int(mesh.nelem)), dtype=torch.int32,
                           device=dev))
    out = boundary_edge_tags(build_adjacency(out))
    return out, nfixed
