"""Parallel surface analysis across shards — PMMG_analys equivalent (the
port's copy of ``parallel/analysis_par.py``, host numpy).

The reference reproduces Mmg's sequential surface analysis *across rank
boundaries* (analys_pmmg.c, SURVEY §2.4): ridge
detection on parallel edges by exchanging face normals (``PMMG_setdhd``
:2001), corner/singularity classification of parallel points by reducing
per-rank incident-special-edge counts (``PMMG_singul`` :1679), and normal
accumulation at parallel points (``PMMG_hashNorver`` :199-1171,
``_communication_nor`` :799).

Model reproduced here, in three reductions keyed by *global* entity ids
(the ordering/ownership contract of the comm layer):

1. every true-boundary face lives in exactly one shard, so each surface
   edge has 1 or 2 local boundary-face records per shard; edges with both
   records local get the dihedral test locally; edges split across shards
   exchange one normal each way and both sides run the same test
   (deterministic: both compute the identical dot product);
2. the *global* set of special (ridge/ref/non-manifold) edges is the
   deduplicated union over shards; a vertex's singularity class follows
   from its global incident-special count (2 -> ridge point, 1 or >2 ->
   corner) — the reference's int-comm count reduction;
3. vertex normals: area-weighted boundary-face normals accumulated once
   per face (faces are uniquely owned) and summed across shards at
   interface points.

Host-side implementation over numpy shard arrays + InterfaceComms; the
device refresh (``analysis_dev.py``) runs the same reductions on the
shard stack, and this module is its fallback when the shared-record
budget overflows.
"""
from __future__ import annotations

import numpy as np

from ..core.constants import (
    ANGEDG, IDIR, MG_BDY, MG_CRN, MG_GEO, MG_NOM, MG_PARBDY, MG_REF)
from .comms import InterfaceComms, global_node_numbering


def extend_numbering(comms: InterfaceComms, npoin_new: list[int]
                     ) -> list[np.ndarray]:
    """Global numbering for ADAPTED shards: comm-table vertices keep the
    split-time numbering (interfaces are frozen, so slots are stable);
    vertices created by adaptation get fresh, globally-unique ids (they
    are shard-private by the freeze contract).  The PMMG_update_analys
    prerequisite (analys_pmmg.c:1571): entity matching across shards
    stays keyed by the pre-adaptation numbering."""
    base = global_node_numbering(comms, [len(o) for o in comms.owner])
    top = max((int(g.max()) if len(g) else 0) for g in base) + 1
    out = []
    for s, g in enumerate(base):
        extra = npoin_new[s] - len(g)
        ext = np.concatenate([
            g, top + np.arange(max(0, extra), dtype=np.int64)])
        top += max(0, extra)
        out.append(ext)
    return out


def analyze_shards(verts: list[np.ndarray], tets: list[np.ndarray],
                   ftags: list[np.ndarray], frefs: list[np.ndarray],
                   comms: InterfaceComms, angedg: float = ANGEDG,
                   glo: list[np.ndarray] | None = None):
    """Cross-shard surface analysis.

    ``glo`` overrides the global numbering — required when shards have
    grown past the comm tables' vertex range (adaptation creates
    shard-private vertices; give them unique global ids, see
    ``extend_numbering``).

    Returns per-shard:
      vtag_add[s]    uint32 bits (MG_BDY/GEO/CRN/REF/NOM) for vertices,
      special_edges[s]  [k,3] rows (lva, lvb, tagbits) for edge tagging,
      vnormal[s]     [np,3] unit outward normals (0 off-surface).
    """
    S = len(verts)
    if glo is None:
        glo = global_node_numbering(comms, [len(v) for v in verts])

    # ---- collect boundary-face edge records per shard -------------------
    # rec: (gkey_lo, gkey_hi, local_a, local_b, nx, ny, nz, fref, shard)
    recs = []
    for s in range(S):
        is_bdy = ((ftags[s] & MG_BDY) != 0) & ((ftags[s] & MG_PARBDY) == 0)
        tet = tets[s]
        for f in range(4):
            sel = np.where(is_bdy[:, f])[0]
            if not len(sel):
                continue
            tri = tet[sel][:, IDIR[f]]
            p = verts[s][tri]
            nrm = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            fr = frefs[s][sel, f]
            for a, b in ((0, 1), (1, 2), (0, 2)):
                la, lb = tri[:, a], tri[:, b]
                ga, gb = glo[s][la], glo[s][lb]
                lo = np.minimum(ga, gb)
                hi = np.maximum(ga, gb)
                recs.append((lo, hi, la, lb, nrm, fr,
                             np.full(len(sel), s)))
    if not recs:
        return ([np.zeros(len(v), np.uint32) for v in verts],
                [np.zeros((0, 3), np.int64) for _ in verts],
                [np.zeros((len(v), 3)) for v in verts])
    lo = np.concatenate([r[0] for r in recs])
    hi = np.concatenate([r[1] for r in recs])
    la = np.concatenate([r[2] for r in recs])
    lb = np.concatenate([r[3] for r in recs])
    nrm = np.concatenate([r[4] for r in recs])
    fr = np.concatenate([r[5] for r in recs])
    sh = np.concatenate([r[6] for r in recs])

    # ---- global edge grouping ------------------------------------------
    key = lo.astype(np.int64) << 32 | hi
    order = np.argsort(key, kind="stable")
    ks = key[order]
    seg_start = np.concatenate([[True], ks[1:] != ks[:-1]])
    seg_id = np.cumsum(seg_start) - 1
    nseg = int(seg_id[-1]) + 1 if len(seg_id) else 0
    cnt = np.bincount(seg_id, minlength=nseg)

    # dihedral + ref + manifold tests per global edge
    nu = nrm[order] / np.maximum(
        np.linalg.norm(nrm[order], axis=1, keepdims=True), 1e-30)
    first_of = np.zeros(nseg, np.int64)
    first_of[seg_id[seg_start]] = np.where(seg_start)[0]
    # pairwise dot for 2-record segments
    is2 = cnt == 2
    i1 = first_of[np.where(is2)[0]]
    dot = np.einsum("ij,ij->i", nu[i1], nu[i1 + 1])
    ridge_seg = np.zeros(nseg, bool)
    ridge_seg[np.where(is2)[0]] = dot < angedg
    ref_seg = np.zeros(nseg, bool)
    ref_seg[np.where(is2)[0]] = fr[order][i1] != fr[order][i1 + 1]
    nom_seg = cnt != 2
    special_seg = ridge_seg | ref_seg | nom_seg
    tagbits_seg = (np.where(ridge_seg, MG_GEO, 0)
                   | np.where(ref_seg, MG_REF, 0)
                   | np.where(nom_seg, MG_NOM, 0)).astype(np.uint32)

    # ---- vertex classification by global incident-special count ---------
    glo_lo = lo[order][seg_start]          # [nseg] endpoint global ids
    glo_hi = hi[order][seg_start]
    maxg = int(max(glo_lo.max(), glo_hi.max())) + 1 if nseg else 1
    nsing = np.zeros(maxg, np.int64)
    sp = np.where(special_seg)[0]
    np.add.at(nsing, glo_lo[sp], 1)
    np.add.at(nsing, glo_hi[sp], 1)
    has_ref = np.zeros(maxg, bool)
    np.maximum.at(has_ref, glo_lo[np.where(ref_seg)[0]], True)
    np.maximum.at(has_ref, glo_hi[np.where(ref_seg)[0]], True)
    has_nom = np.zeros(maxg, bool)
    np.maximum.at(has_nom, glo_lo[np.where(nom_seg)[0]], True)
    np.maximum.at(has_nom, glo_hi[np.where(nom_seg)[0]], True)
    on_bdy_g = np.zeros(maxg, bool)
    on_bdy_g[glo_lo] = True
    on_bdy_g[glo_hi] = True

    gtag = np.where(on_bdy_g, MG_BDY, 0).astype(np.uint32)
    gtag |= np.where(nsing == 2, MG_GEO, 0).astype(np.uint32)
    gtag |= np.where((nsing == 1) | (nsing > 2), MG_CRN, 0
                     ).astype(np.uint32)
    gtag |= np.where(has_ref, MG_REF, 0).astype(np.uint32)
    gtag |= np.where(has_nom, MG_NOM, 0).astype(np.uint32)

    # ---- normals: one face record per (face, corner); dedup per face ----
    # each boundary face contributed 3 edge records; corner contribution
    # per face = appears in exactly 2 of its 3 edge records -> add once
    # with weight 1/2
    gacc = np.zeros((maxg, 3))
    np.add.at(gacc, lo, 0.5 * nrm)
    np.add.at(gacc, hi, 0.5 * nrm)

    # ---- scatter back per shard ----------------------------------------
    vtag_add, special_edges, vnormal = [], [], []
    for s in range(S):
        g = glo[s]
        safe = np.clip(g, 0, maxg - 1)
        # rows with g < 0 are dead slots (the session numbering marks
        # reusable holes with -1): no classification, no normal
        ok = (g >= 0) & (g < maxg)
        vt = np.where(ok, gtag[safe], 0).astype(np.uint32)
        vtag_add.append(vt)
        vn = np.where(ok[:, None], gacc[safe], 0.0)
        nl = np.linalg.norm(vn, axis=1, keepdims=True)
        vnormal.append(np.where(nl > 1e-30, vn / np.maximum(nl, 1e-30), 0))
        # special edges present in this shard (by its own records)
        mine = sh[order] == s
        segm = special_seg[seg_id] & mine
        rows = np.stack([la[order][segm], lb[order][segm],
                         tagbits_seg[seg_id][segm].astype(np.int64)], 1)
        # dedup (an edge appears once per adjacent local bdy face)
        if len(rows):
            rows = np.unique(rows, axis=0)
        special_edges.append(rows.astype(np.int64))
    return vtag_add, special_edges, vnormal
