"""Mesh partitioners, host side (the port's copy of ``parallel/partition.py``).

Reference: ParMmg partitions with METIS (``PMMG_part_meshElts2metis``,
metis_pmmg.c:1271) for the initial element split, with
edge weights boosting old parallel interfaces (metis_pmmg.c:746-843) so
they land inside partitions on later iterations.

v1 provides:
- Morton (Z-order) space-filling-curve partitioning of tet centroids —
  geometric, fast, cache/gather friendly (the SFC ordering also replaces
  SCOTCH renumbering, which is pointless on TPU);
- a greedy BFS graph-growing partitioner with optional per-face weights —
  the structural slot where METIS-parity (interface-weight 1e6 and the
  metric-aware alpha=28 weighting, metis_pmmg.c:280) plugs in; meshkit's
  C++ kernel (``native/``) where g++ exists, a numpy BFS where not;
- contiguity correction (majority-neighbor relabel of stranded islands,
  reference moveinterfaces_pmmg.c:176-626 flavor).
"""
from __future__ import annotations

import numpy as np


def _morton3(u: np.ndarray) -> np.ndarray:
    """Interleave 21-bit coords into a 63-bit Morton key. u: [n,3] in [0,1)."""
    q = np.clip((u * (1 << 21)).astype(np.uint64), 0, (1 << 21) - 1)

    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
        return x

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def morton_partition(centroids: np.ndarray, nparts: int,
                     weights: np.ndarray | None = None) -> np.ndarray:
    """Equal-weight contiguous-along-curve partition of points."""
    # host-by-contract inputs (signature: np.ndarray): astype is a
    # dtype view/copy of host memory, never a device pull
    c = centroids.astype(np.float64, copy=False)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-30)
    key = _morton3((c - lo) / span * 0.999999)
    order = np.argsort(key, kind="stable")
    w = np.ones(len(c)) if weights is None \
        else weights.astype(np.float64, copy=False)
    cw = np.cumsum(w[order])
    total = cw[-1]
    part_sorted = np.minimum((cw - 1e-12) / total * nparts,
                             nparts - 1e-9).astype(np.int32)
    part = np.empty(len(c), np.int32)
    part[order] = part_sorted
    return part


def build_dual_graph(tet: np.ndarray):
    """Tet-tet adjacency as CSR (host), via sorted faces."""
    n = len(tet)
    faces = np.sort(tet[:, [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]]]
                    .reshape(n * 4, 3), axis=1)
    key = (faces[:, 0].astype(np.int64) << 42) | \
          (faces[:, 1].astype(np.int64) << 21) | faces[:, 2].astype(np.int64)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    same = ks[1:] == ks[:-1]
    i = order[:-1][same] // 4
    j = order[1:][same] // 4
    src = np.concatenate([i, j])
    dst = np.concatenate([j, i])
    o = np.argsort(src, kind="stable")
    src, dst = src[o], dst[o]
    xadj = np.zeros(n + 1, np.int64)
    np.add.at(xadj, src + 1, 1)
    xadj = np.cumsum(xadj)
    return xadj, dst.astype(np.int32)


def _greedy_seeds(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """The BFS seeds: ``nparts`` tets spread along the Morton curve."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-30)
    key = _morton3((c - lo) / span * 0.999999)
    order = np.argsort(key)
    return order[np.linspace(0, len(c) - 1, nparts).astype(int)]


def greedy_partition(tet: np.ndarray, centroids: np.ndarray, nparts: int,
                     weights: np.ndarray | None = None) -> np.ndarray:
    """BFS graph growing from spread seeds; balanced by element weight.

    Runs meshkit's C++ kernel (``native/meshkit.cpp``, built with g++)
    wherever a compiler exists, as the JAX package does; a failed build
    raises.  :func:`greedy_partition_numpy`, a different walk, is the JAX
    package's fallback and runs only where no compiler exists.
    """
    from .. import native
    if not native.available():
        return greedy_partition_numpy(tet, centroids, nparts, weights)
    adja = native.build_adjacency(np.asarray(tet, np.int32))
    return native.greedy_partition(
        adja, nparts, _greedy_seeds(centroids, nparts).astype(np.int64),
        None if weights is None else np.asarray(weights, np.float64))


def greedy_partition_numpy(tet: np.ndarray, centroids: np.ndarray,
                           nparts: int,
                           weights: np.ndarray | None = None) -> np.ndarray:
    """The numpy BFS of :func:`greedy_partition` (the JAX package's
    fallback): each round, every part in order of load takes one tet off
    its queue."""
    n = len(tet)
    xadj, adj = build_dual_graph(tet)
    w = np.ones(n) if weights is None else np.asarray(weights, float)
    target = w.sum() / nparts
    seeds = _greedy_seeds(centroids, nparts)
    part = np.full(n, -1, np.int32)
    from collections import deque
    queues = [deque([s]) for s in seeds]
    loads = np.zeros(nparts)
    remaining = n
    while remaining:
        progressed = False
        for p in np.argsort(loads):
            qd = queues[p]
            while qd:
                t = qd.popleft()
                if part[t] == -1:
                    part[t] = p
                    loads[p] += w[t]
                    remaining -= 1
                    for v in adj[xadj[t]:xadj[t + 1]]:
                        if part[v] == -1:
                            qd.append(v)
                    progressed = True
                    break
            if loads[p] > target * 1.05:
                continue
        if not progressed:
            # disconnected leftovers: assign to least-loaded part
            rest = np.where(part == -1)[0]
            for t in rest:
                p = int(np.argmin(loads))
                part[t] = p
                loads[p] += w[t]
            remaining = 0
    return part


def metric_edge_weights(tet: np.ndarray, vert: np.ndarray,
                        met: np.ndarray,
                        ifc_pairs: tuple[np.ndarray, np.ndarray] | None
                        = None, alpha: float = 28.0) -> dict:
    """Metric-aware dual-graph edge weights (PMMG_computeWgt,
    metis_pmmg.c:280-300): a face between two tets
    whose edges are far from unit metric length gets weight
    ``min(exp(alpha * mean|len-1|), 1e6)`` so partition cuts avoid
    regions that still need remeshing; old-interface faces get the flat
    1e6 boost (metis_pmmg.c:746-843) so previous interfaces fall inside
    partitions on the next iteration.

    Returns {"pairs": (i, j), "w": weights} aligned with the matched
    face pairs of the dual graph.
    """
    n = len(tet)
    faces = np.sort(tet[:, [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]]]
                    .reshape(n * 4, 3), axis=1)
    key = (faces[:, 0].astype(np.int64) << 42) | \
          (faces[:, 1].astype(np.int64) << 21) | faces[:, 2].astype(np.int64)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    same = ks[1:] == ks[:-1]
    fa, fb = order[:-1][same], order[1:][same]
    i, j = fa // 4, fb // 4
    tri = faces[fa]                                   # [m,3] shared face
    # mean deviation of the 3 face edge metric lengths from 1
    h = met if met.ndim == 1 else None
    ev = np.stack([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [0, 2]]], axis=1)
    p0 = vert[ev[..., 0]]
    p1 = vert[ev[..., 1]]
    d = np.linalg.norm(p1 - p0, axis=-1)
    if h is not None:
        hm = 0.5 * (h[ev[..., 0]] + h[ev[..., 1]])
        L = d / np.maximum(hm, 1e-30)
    else:  # aniso: use mean of the two endpoint tensor lengths (approx)
        L = d
    dev = np.abs(L - 1.0).mean(axis=1)
    w = np.minimum(np.exp(alpha * dev / 3.0), 1.0e6)
    if ifc_pairs is not None:
        mark = np.zeros(n, bool)
        mark[np.asarray(ifc_pairs[0])] = True
        boost = mark[i] & mark[j]
        w = np.where(boost, 1.0e6, w)
    return {"pairs": (i.astype(np.int64), j.astype(np.int64)), "w": w}


def refine_partition(part: np.ndarray, nparts: int,
                     pairs: tuple[np.ndarray, np.ndarray],
                     w: np.ndarray, elem_w: np.ndarray | None = None,
                     npasses: int = 3, tol: float = 1.05) -> np.ndarray:
    """Weighted boundary refinement of a partition (KL/FM-flavored).

    The production consumer of :func:`metric_edge_weights` — the role of
    METIS k-way refinement under PMMG_computeWgt edge weighting
    (metis_pmmg.c:280-300,746-843): cut-boundary tets
    move to the neighbor part they are most heavily connected to, so
    partition cuts avoid regions whose edges are far from unit metric
    length (still to be remeshed) and previous-interface bands.

    Vectorized sweeps: per pass, every cut tet computes its connection
    weight to each adjacent part and moves when the gain is positive and
    the destination stays under ``tol`` x target load.  A few passes
    suffice (the cut only shrinks); callers re-run fix_contiguity after.
    """
    i, j = pairs
    part = np.asarray(part, np.int32).copy()
    n = len(part)
    ew = np.ones(n) if elem_w is None else np.asarray(elem_w, float)
    target = ew.sum() / nparts
    src = np.concatenate([i, j])
    oth = np.concatenate([j, i])
    ww = np.concatenate([w, w])
    for _ in range(npasses):
        cut = part[i] != part[j]
        if not cut.any():
            break
        cand = np.unique(np.concatenate([i[cut], j[cut]]))
        cidx = np.full(n, -1, np.int64)
        cidx[cand] = np.arange(len(cand))
        sel = cidx[src] >= 0
        conn = np.zeros((len(cand), nparts))
        np.add.at(conn, (cidx[src[sel]], part[oth[sel]]), ww[sel])
        cur = conn[np.arange(len(cand)), part[cand]]
        best_p = np.argmax(conn, axis=1).astype(np.int32)
        gain = conn[np.arange(len(cand)), best_p] - cur
        loads = np.bincount(part, weights=ew, minlength=nparts)
        move = (gain > 0) & (best_p != part[cand])
        if not move.any():
            break
        # capacity-aware admission: within each destination, admit movers
        # in gain order while the CUMULATIVE weight keeps the destination
        # under tol*target — simultaneous moves cannot overshoot (the
        # load check alone only blocks inflow against stale loads)
        mi = cand[move]
        gp = best_p[move]
        gw = ew[mi]
        gg = gain[move]
        o = np.lexsort((-gg, gp))
        mi, gp, gw = mi[o], gp[o], gw[o]
        seg = np.concatenate([[True], gp[1:] != gp[:-1]])
        cs = np.cumsum(gw)
        base = np.maximum.accumulate(np.where(seg, cs - gw, 0))
        within = cs - base                     # inclusive per-dest cumsum
        okm = loads[gp] + within <= tol * target
        if not okm.any():
            break
        part[mi[okm]] = gp[okm]
    return part


def correct_empty_parts(part: np.ndarray, nparts: int,
                        tet: np.ndarray) -> np.ndarray:
    """Donate one boundary element to every empty part
    (PMMG_correct_meshElts2metis, metis_pmmg.c:542-637)."""
    part = part.copy()
    counts = np.bincount(part, minlength=nparts)
    empties = np.where(counts == 0)[0]
    if len(empties) == 0:
        return part
    xadj, adj = build_dual_graph(tet)
    donors = np.argsort(counts)[::-1]
    for e in empties:
        big = donors[0]
        # pick an element of the big part with a neighbor outside it
        cand = np.where(part == big)[0]
        for t in cand:
            nb = adj[xadj[t]:xadj[t + 1]]
            if (part[nb] != big).any() or len(nb) < 4:
                part[t] = e
                break
        else:
            part[cand[0]] = e
        counts = np.bincount(part, minlength=nparts)
        donors = np.argsort(counts)[::-1]
    return part


def move_interfaces(tet: np.ndarray, part: np.ndarray, nparts: int,
                    nlayers: int = 2,
                    ne_min: int | None = None) -> np.ndarray:
    """Advancing-front interface displacement
    (PMMG_part_moveInterfaces, moveinterfaces_pmmg.c:1306-1466): for
    ``nlayers`` waves, the *larger* part's color advances across the
    interface into the smaller part (priority = part tet count,
    PMMG_get_ifcDirection :77-98), by flooding the tet balls of front
    vertices; a part never shrinks below ``ne_min``
    (min(6, ne/2+1), :1343).  Returns the displaced partition — old
    interfaces end up strictly inside the winning part, so the next
    adaptation can remesh them (the core idea of the iterative
    remesh-repartition scheme).
    """
    n = len(tet)
    part = part.copy()
    if ne_min is None:
        ne_min = min(6, n // (2 * max(nparts, 1)) + 1)
    nvert = int(tet.max()) + 1
    for _ in range(nlayers):
        sizes = np.bincount(part, minlength=nparts).astype(np.int64)
        # vertex color: the max-priority (larger part wins; ties by id)
        # among incident tets — the owner-priority merge of the reference
        pri = sizes[part] * np.int64(nparts) + part     # unique ordering
        vpri = np.zeros(nvert, np.int64)
        np.maximum.at(vpri, tet.reshape(-1), np.repeat(pri, 4))
        vcol = (vpri % nparts).astype(np.int32)
        # front vertices: incident to ≥2 colors
        vmin = np.full(nvert, np.int64(1) << 60)
        np.minimum.at(vmin, tet.reshape(-1), np.repeat(pri, 4))
        front = vmin != vpri
        # advance: every tet touching a front vertex whose winning color
        # differs takes that color (ball flood), respecting ne_min
        tfront = front[tet].any(axis=1)
        # winning color per tet = max vertex color priority over corners
        wpri = vpri[tet].max(axis=1)
        wcol = (wpri % nparts).astype(np.int32)
        change = tfront & (wcol != part)
        # donor-side floor: do not let a part drop below ne_min
        donors = part[change]
        loss = np.bincount(donors, minlength=nparts)
        allowed = sizes - ne_min
        scale_ok = loss <= np.maximum(allowed, 0)
        blocked = ~scale_ok[donors]
        if blocked.any():
            # keep only as many moves per donor as allowed (first-come)
            idx = np.where(change)[0]
            keep = np.ones(len(idx), bool)
            budget = np.maximum(allowed, 0).copy()
            for q, t in enumerate(idx):
                d = part[t]
                if budget[d] > 0:
                    budget[d] -= 1
                else:
                    keep[q] = False
            change[:] = False
            change[idx[keep]] = True
        part[change] = wcol[change]
    return fix_contiguity(tet, part)


def partition_metrics(tet: np.ndarray, part: np.ndarray,
                      nparts: int) -> dict:
    """Edge-cut + imbalance diagnostics (for tests and the LB driver)."""
    xadj, adj = build_dual_graph(tet)
    src = np.repeat(np.arange(len(tet)), np.diff(xadj))
    cut = int((part[src] != part[adj]).sum()) // 2
    counts = np.bincount(part, minlength=nparts)
    imb = float(counts.max() / max(1.0, counts.mean()))
    return {"edge_cut": cut, "imbalance": imb,
            "counts": counts.tolist()}


def fix_contiguity(tet: np.ndarray, part: np.ndarray) -> np.ndarray:
    """Relabel all but the largest connected blob of each color into a
    neighboring color (reference PMMG_fix_contiguity semantics,
    moveinterfaces_pmmg.c:475)."""
    n = len(tet)
    xadj, adj = build_dual_graph(tet)
    part = part.copy()
    # connected components within colors
    comp = np.full(n, -1, np.int64)
    ncomp = 0
    from collections import deque
    for s in range(n):
        if comp[s] != -1:
            continue
        comp[s] = ncomp
        dq = deque([s])
        while dq:
            t = dq.popleft()
            for v in adj[xadj[t]:xadj[t + 1]]:
                if comp[v] == -1 and part[v] == part[t]:
                    comp[v] = ncomp
                    dq.append(v)
        ncomp += 1
    sizes = np.bincount(comp, minlength=ncomp)
    # biggest component per color keeps it
    keep = {}
    for cid in range(ncomp):
        col = part[np.argmax(comp == cid)]
        if col not in keep or sizes[cid] > sizes[keep[col]]:
            keep[col] = cid
    keepset = set(keep.values())
    for cid in range(ncomp):
        if cid in keepset:
            continue
        idx = np.where(comp == cid)[0]
        # majority neighboring color outside this comp
        votes = {}
        for t in idx:
            for v in adj[xadj[t]:xadj[t + 1]]:
                if comp[v] != cid:
                    votes[part[v]] = votes.get(part[v], 0) + 1
        if votes:
            newc = max(votes, key=votes.get)
            part[idx] = newc
    return part
