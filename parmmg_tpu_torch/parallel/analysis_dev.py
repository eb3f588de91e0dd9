"""Device-resident cross-shard surface analysis (port of
``parallel/analysis_dev.py``; the reference's PMMG_update_analys).

The host ``analysis_par.analyze_shards`` pulls every shard's arrays and
re-derives the classification in numpy; this module is the device
refresh of the distributed pass, on the shard stack:

- every shard extracts its boundary-face edge records at width
  [12*capT] (three edges per boundary face), keyed by the persistent
  GLOBAL vertex numbering;
- records whose two endpoints are NOT both interface (MG_PARBDY)
  vertices can only ever meet records of the same shard — they are
  grouped and classified locally (sort/segment: dihedral ridge test on
  2-record edges, ref-mismatch, non-manifold on counts != 2 — the
  PMMG_setdhd / MG_NOM rules);
- potentially-shared records (both endpoints interface) are compacted
  into a fixed [KS] buffer per shard and gathered from every shard (the
  JAX package's ``all_gather``: one collective across the ranks of a
  several-process run, none at one process): one global grouping of the
  packs of every shard classifies them and each shard reads back the
  verdicts of its own records;
- vertex singularity classification (corner = 1 or >2 incident special
  edges, ridge point = 2; PMMG_singul:1679) needs GLOBAL incident counts:
  each special edge contributes +1 at its endpoints exactly once (the
  globally-first record's shard owns the contribution), and interface
  vertices sum their partial counts over the node comm tables (the
  halo exchange of ``comms.py``);
- edge tags are rewritten in place: stale classification bits are
  cleared on plain-boundary slots, record slots receive their verdicts,
  and a keyed OR-join propagates the special bits to every other local
  slot of the same edge.

Sorts go through the port's sort engine: ``_sort2`` is a two-word K7
sort with K8's gathered flags (the JAX package's ``jnp.lexsort``), the
keyed join ``ops.edges.sort_pairs``; the segment scans are ``cummax``
(the running head index) and ``ops.primitives.seg_scan``.

The [KS] shared-record budget is static; if a shard exceeds it the
refresh reports overflow and the caller falls back to the host path
(never a silent truncation).  The JAX package extracts each group's
records twice-light (its ``lax.map`` keeps one group's table live at a
time); the port keeps every shard's record table from the first phase to
the last.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import (IDIR, INT32_MAX, INT32_MIN, MG_BDY, MG_CRN,
                              MG_GEO, MG_NOM, MG_PARBDY, MG_REF)
from ..core.mesh import Mesh, tet_edge_vertices
from ..ops import kernels
from ..ops.edges import segmented_or, sort_pairs
from ..ops.primitives import nonzero_pad, reduce_drop, set_drop

CLS = MG_GEO | MG_CRN | MG_REF | MG_NOM
_EDGE_PAIRS = ((0, 1), (1, 2), (0, 2))


def _sort2(a, b, valid):
    """Two-column ascending sort of (a, b) int32 id pairs, invalid last:
    a two-word K7 sort (signed order: the sign bits flipped) and K8's
    gathered head flags.  Returns (order int64, first)."""
    big = torch.full_like(a, INT32_MAX)
    aa = torch.where(valid, a, big).to(torch.int32) ^ INT32_MIN
    bb = torch.where(valid, b, big).to(torch.int32) ^ INT32_MIN
    order = kernels.radix_sort((aa.contiguous(), bb.contiguous()))
    _, first = kernels.segment_flags((aa.contiguous(), bb.contiguous()),
                                     order=order)
    return order.long(), first


def _head_index(first):
    """Row index of each sorted row's segment head (the JAX package's
    ``associative_scan(maximum)`` of the head positions)."""
    n = first.shape[0]
    ar = torch.arange(n, device=first.device)
    return torch.cummax(torch.where(first, ar, torch.zeros_like(ar)),
                        dim=0).values


def _seg_fields(first, valid_sorted):
    """(seg_id, cnt_of_my_segment, is_last) helpers for a sorted run."""
    n = first.shape[0]
    seg = _head_index(first)
    tot = torch.zeros(n, dtype=torch.int32, device=first.device)
    tot = tot.index_add(0, seg, valid_sorted.to(torch.int32))
    is_last = torch.ones_like(first)
    if n > 1:
        is_last[:-1] = first[1:]
    return seg, tot[seg], is_last


def _dot3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _classify_sorted(first, valid_s, nu_s, fref_s, angedg: float):
    """Per-ROW verdict bits for a sorted record run: the segment verdict
    (ridge/ref/non-manifold) broadcast to every member row.  Returns (row
    verdicts int32, head-row mask)."""
    n = first.shape[0]
    seg, cnt, _ = _seg_fields(first, valid_s)
    nxt_same = torch.zeros_like(first)
    if n > 1:
        nxt_same[:-1] = ~first[1:]
    dot = _dot3(nu_s, torch.roll(nu_s, -1, dims=0))
    ref_mis = fref_s != torch.roll(fref_s, -1, dims=0)
    two = first & (cnt == 2) & nxt_same
    ridge_h = two & (dot < angedg)
    ref_h = two & ref_mis
    nom_h = first & valid_s & (cnt != 2)
    zero = torch.zeros((), dtype=torch.int32, device=first.device)
    bits_h = (torch.where(ridge_h, MG_GEO, zero)
              | torch.where(ref_h, MG_REF, zero)
              | torch.where(nom_h, MG_NOM, zero)).to(torch.int32)
    # segment heads are their own head index: the verdict of a row is its
    # head's
    bits_row = torch.where(valid_s, bits_h[seg], zero)
    return bits_row, first & valid_s


class _Records(NamedTuple):
    """Boundary-face edge records of ONE shard at width R = 12*capT (3
    edges x 4 faces per tet)."""
    la: torch.Tensor       # [R] local endpoint a
    lb: torch.Tensor       # [R] local endpoint b
    valid: torch.Tensor    # [R] record is a live plain-boundary face edge
    nu: torch.Tensor       # [R, 3] unit face normal
    frf: torch.Tensor      # [R] face ref
    trow: torch.Tensor     # [R] tet row
    le: torch.Tensor       # [R] local edge slot 0..5
    g_lo: torch.Tensor     # [R] global endpoint min
    g_hi: torch.Tensor     # [R] global endpoint max
    loc_rec: torch.Tensor  # [R] purely-local record
    sh_rec: torch.Tensor   # [R] potentially-shared record


def _extract_records(mesh: Mesh, glo) -> _Records:
    """The [R] record table of one shard (the rank-local half of the
    reference's analys exchange); ``glo`` [capP] int32 global ids."""
    from ..ops.swap import _EDGE_OF
    capT, capP = mesh.capT, mesh.capP
    dev = mesh.device
    la_l, lb_l, valid_l, nrm_l, fref_l, le_l = [], [], [], [], [], []
    trow = torch.arange(capT, dtype=torch.int32, device=dev)
    tet = mesh.tet.long()
    for f in range(4):
        tri = tet[:, torch.as_tensor(IDIR[f], device=dev)]        # [T,3]
        p = mesh.vert[tri]
        u, v = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
        nrm = torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                           u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                           u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)
        ft = mesh.ftag[:, f]
        is_b = mesh.tmask & ((ft & MG_BDY) != 0) & ((ft & MG_PARBDY) == 0)
        for (a, b) in _EDGE_PAIRS:
            la_l.append(tri[:, a])
            lb_l.append(tri[:, b])
            valid_l.append(is_b)
            nrm_l.append(nrm)
            fref_l.append(mesh.fref[:, f])
            eid = int(_EDGE_OF[IDIR[f][a], IDIR[f][b]])
            le_l.append(torch.full((capT,), eid, dtype=torch.int32,
                                   device=dev))
    la = torch.cat(la_l).to(torch.int32)
    lb = torch.cat(lb_l).to(torch.int32)
    lac, lbc = la.clamp(0, capP - 1).long(), lb.clamp(0, capP - 1).long()
    valid = torch.cat(valid_l)
    nrm = torch.cat(nrm_l)
    nl = torch.sqrt(_dot3(nrm, nrm))
    nu = nrm / torch.clamp(nl, min=1e-30)[:, None]
    frf = torch.cat(fref_l)
    glo_i = glo.to(torch.int32)
    ga, gb = glo_i[lac], glo_i[lbc]
    pb = (mesh.vtag & MG_PARBDY) != 0
    both_ifc = pb[lac] & pb[lbc]
    return _Records(la, lb, valid, nu, frf, trow.repeat(12),
                    torch.cat(le_l), torch.minimum(ga, gb),
                    torch.maximum(ga, gb), valid & ~both_ifc,
                    valid & both_ifc)


def _local_bits(rec: _Records, angedg: float):
    """Local grouping + verdicts for the purely-local records.
    Returns (bits_rec [R] int32, head_rec [R] bool)."""
    order, first = _sort2(rec.g_lo, rec.g_hi, rec.loc_rec)
    bits_srt, head_srt = _classify_sorted(
        first, rec.loc_rec[order], rec.nu[order], rec.frf[order], angedg)
    bits_rec = torch.empty_like(bits_srt)
    bits_rec[order] = bits_srt
    head_rec = torch.empty_like(head_srt)
    head_rec[order] = head_srt
    return bits_rec, head_rec


def _shared_pack(rec: _Records, KS: int):
    """Compact the potentially-shared records into the fixed [KS]
    exchange buffer.  Returns (pack dict, overflow bool tensor)."""
    R = rec.la.shape[0]
    ovf = rec.sh_rec.sum() > KS
    widx = nonzero_pad(rec.sh_rec, KS, R)
    wv = widx < R
    wc = widx.clamp(0, R - 1)
    big = torch.full((KS,), INT32_MAX, dtype=torch.int32,
                     device=widx.device)
    pack = {
        "glo": torch.where(wv, rec.g_lo[wc], big),
        "ghi": torch.where(wv, rec.g_hi[wc], big),
        "nu": torch.where(wv[:, None], rec.nu[wc],
                          torch.zeros((), dtype=rec.nu.dtype,
                                      device=wv.device)),
        "fref": torch.where(wv, rec.frf[wc], torch.zeros_like(big)),
        "row": torch.where(wv, wc, R).to(torch.int32),
        "valid": wv,
    }
    return pack, ovf


def _vertex_payload(mesh: Mesh, rec: _Records, bits_rec, head_rec):
    """Per-vertex partials of the int-comm reduction: [capP, 4] float32
    columns (nsing, has_ref, has_nom, on_bdy)."""
    capP = mesh.capP
    dev = mesh.device
    contrib = head_rec & (bits_rec != 0)
    la, lb, valid = rec.la, rec.lb, rec.valid
    cap = torch.full_like(la, capP)

    def ends(sel):
        return torch.cat([torch.where(sel, la, cap),
                          torch.where(sel, lb, cap)])
    zi = torch.zeros(capP + 1, dtype=torch.int32, device=dev)
    nsing = reduce_drop(zi, ends(contrib), 1, "sum")[:capP]
    on_bdy = reduce_drop(zi, ends(valid), 1, "amax")[:capP]
    has_ref = reduce_drop(zi, ends(contrib & ((bits_rec & MG_REF) != 0)),
                          1, "amax")[:capP]
    has_nom = reduce_drop(zi, ends(contrib & ((bits_rec & MG_NOM) != 0)),
                          1, "amax")[:capP]
    return torch.stack([nsing, has_ref, has_nom, on_bdy],
                       dim=1).to(torch.float32)               # [capP, 4]


def _vtag_from_payload(vtag, vmask, payload, acc):
    """Final vertex classification from the local payload + the summed
    neighbor contributions (any leading axes)."""
    nsing_t = payload[..., 0].to(torch.int32) + acc[..., 0].to(torch.int32)
    ref_t = (payload[..., 1] > 0) | (acc[..., 1] > 0)
    nom_t = (payload[..., 2] > 0) | (acc[..., 2] > 0)
    bdy_t = (payload[..., 3] > 0) | (acc[..., 3] > 0)
    zero = torch.zeros((), dtype=torch.int32, device=vtag.device)
    gtag = torch.where(bdy_t, MG_BDY, zero)
    gtag = gtag | torch.where(nsing_t == 2, MG_GEO, zero)
    gtag = gtag | torch.where((nsing_t == 1) | (nsing_t > 2), MG_CRN, zero)
    gtag = gtag | torch.where(ref_t, MG_REF, zero)
    gtag = gtag | torch.where(nom_t, MG_NOM, zero)
    vtag_new = (vtag & ~CLS) | (gtag & CLS) | (gtag & MG_BDY)
    return torch.where(vmask, vtag_new, vtag)


def _etag_rewrite(mesh: Mesh, rec: _Records, bits_rec):
    """Edge-tag rewrite: clear stale classification on plain-boundary
    slots, write record verdicts, then OR-join the special bits onto
    every local slot of the same (local vertex pair) edge."""
    capT, capP = mesh.capT, mesh.capP
    dev = mesh.device
    R = rec.la.shape[0]
    la, lb, valid = rec.la, rec.lb, rec.valid
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    plain = ((mesh.etag & MG_BDY) != 0) & ((mesh.etag & MG_PARBDY) == 0)
    etag_flat = (mesh.etag & ~torch.where(plain, CLS, zero)).reshape(-1)
    # record-slot verdicts: colliding writes (two boundary faces of one
    # tet sharing the edge) carry identical verdict bits
    slot_flat = torch.where(valid, rec.trow * 6 + rec.le, capT * 6)
    slot_c = slot_flat.clamp(0, capT * 6 - 1).long()
    merged = etag_flat[slot_c] | torch.where(valid, bits_rec, zero)
    etag_new = set_drop(etag_flat, slot_flat, merged)
    # keyed OR-join: donors = special records (local pair), receivers =
    # all live tet-edge slots
    ev = tet_edge_vertices(mesh.tet).reshape(capT * 6, 2)
    ka = torch.minimum(ev[:, 0], ev[:, 1])
    kb = torch.maximum(ev[:, 0], ev[:, 1])
    alive6 = mesh.tmask.repeat_interleave(6)
    don_v = valid & (bits_rec != 0)
    n_all = capT * 6 + R
    aa = torch.cat([ka, torch.minimum(la, lb)])
    bb = torch.cat([kb, torch.maximum(la, lb)])
    vvv = torch.cat([alive6, don_v])
    order_j, _, _, first_j = sort_pairs(aa, bb, vvv, capP)
    seg_j = _head_index(first_j)
    is_don = (order_j >= capT * 6) & vvv[order_j]
    dbits = torch.where(is_don, bits_rec[(order_j - capT * 6).clamp(
        0, R - 1)], zero)
    or_run = segmented_or(first_j, dbits)
    is_last_j = torch.ones_like(first_j)
    if n_all > 1:
        is_last_j[:-1] = first_j[1:]
    tot = set_drop(torch.zeros(n_all, dtype=torch.int32, device=dev),
                   torch.where(is_last_j, seg_j, n_all), or_run)
    add_srt = tot[seg_j]
    recv_rows = (order_j < capT * 6) & vvv[order_j]
    tgt_j = torch.where(recv_rows, order_j, capT * 6)
    merged_j = etag_new[tgt_j.clamp(0, capT * 6 - 1)] | add_srt
    etag_new = set_drop(etag_new, tgt_j, merged_j)
    return etag_new.reshape(capT, 6)


def _analysis_stack(stacked, glo_s, node_idx_s, nbr_s, angedg: float,
                    KS: int, exchange):
    """The refresh over every shard of ``stacked`` (a MeshStack, the L
    shards this rank holds): local verdicts and shared packs a shard, one
    global grouping of the packs of every shard of the run (gathered
    across the ranks, in global shard order), the per-shard tails,
    ``exchange(payload, node_idx, nbr)`` (a halo exchange; the comm
    tables of every shard) and the vertex classification.
    Returns (vtag [L, capP], etag [L, capT, 6], overflow bool of this
    rank's shards)."""
    from . import multihost, pod
    L = stacked.ngroups
    capP = stacked.capP
    dev = stacked.device
    recs, bits_all, head_all, packs, ovf = [], [], [], [], []
    for g in range(L):
        rec = _extract_records(stacked.slot(g), glo_s[g])
        b, h = _local_bits(rec, angedg)
        pack, o = _shared_pack(rec, KS)
        recs.append(rec)
        bits_all.append(b)
        head_all.append(h)
        packs.append(pack)
        ovf.append(o)
    # the gather: every logical shard's pack, logical order
    keys = list(packs[0])
    gath = dict(zip(keys, multihost.all_gather_rows(
        *(torch.stack([p[k] for p in packs]) for k in keys))))
    S = gath["valid"].shape[0]           # shards of the run
    logical_of = torch.arange(S, device=dev).repeat_interleave(KS)
    gv = gath["valid"].reshape(-1)
    order_g, first_g = _sort2(gath["glo"].reshape(-1),
                              gath["ghi"].reshape(-1), gv)
    bits_g, head_g = _classify_sorted(
        first_g, gv[order_g], gath["nu"].reshape(-1, 3)[order_g],
        gath["fref"].reshape(-1)[order_g], angedg)
    mine = gv[order_g]
    g_tgt = torch.where(mine, logical_of[order_g], S)
    j_tgt = torch.where(mine, order_g % KS, 0)
    zi = torch.zeros((S + 1) * KS, dtype=torch.int32, device=dev)
    flat = g_tgt * KS + j_tgt
    r0 = pod.row0()
    sh_bits = reduce_drop(zi, flat, bits_g, "amax")[:S * KS].view(
        S, KS)[r0:r0 + L]
    sh_head = reduce_drop(zi, flat, (head_g & mine).to(torch.int32),
                          "amax")[:S * KS].view(S, KS)[r0:r0 + L] > 0
    etags, payloads = [], []
    for g in range(L):
        row = packs[g]["row"]
        b = reduce_drop(bits_all[g], row, sh_bits[g], "amax")
        h = reduce_drop(head_all[g].to(torch.int32), row,
                        (sh_head[g] & packs[g]["valid"]).to(torch.int32),
                        "amax") > 0
        payloads.append(_vertex_payload(stacked.slot(g), recs[g], b, h))
        etags.append(_etag_rewrite(stacked.slot(g), recs[g], b))
    payload = torch.stack(payloads)                       # [L, capP, 4]
    recv = exchange(payload, node_idx_s, nbr_s)           # [L, K, I, 4]
    acc = []
    for g in range(L):
        ni = node_idx_s[r0 + g]
        fl = torch.where(ni >= 0, ni, capP)
        acc.append(reduce_drop(
            torch.zeros((capP + 1, 4), dtype=torch.float32, device=dev),
            fl.reshape(-1), recv[g].reshape(-1, 4), "sum")[:capP])
    vtag_new = _vtag_from_payload(stacked.vtag, stacked.vmask, payload,
                                  torch.stack(acc))
    return vtag_new, torch.stack(etags), torch.stack(ovf).any()


def shard_analysis_body(stacked, glo_s, node_idx_s, nbr_s, angedg: float,
                        KS: int, packed_M: int | None = None):
    """The refresh of every logical shard of the stack (the JAX package's
    ``shard_analysis_body`` and its grouped layouts, which differ only in
    how the vertex reduction's exchange is laid out), the vertex
    reduction through :func:`comms.halo_exchange` (``packed_M``: its
    packed layout across processes).  Returns (vtag [L, capP], etag
    [L, capT, 6], overflow bool)."""
    from .comms import halo_exchange

    def exchange(vals, send_idx, nbr):
        return halo_exchange(vals, send_idx, nbr, packed_M=packed_M)
    return _analysis_stack(stacked, glo_s, node_idx_s, nbr_s, angedg, KS,
                           exchange)


def extract_probe_seconds(mesh_g: Mesh, glo_g, repeats: int = 3) -> float:
    """Wall seconds of ONE [12*capT] record-table extraction of one shard
    (median of ``repeats`` runs after a warm one, the device synchronized
    around each); also set on the ``analysis.extract1x_s`` gauge."""
    def sync():
        if mesh_g.device.type == "cuda":
            torch.cuda.synchronize(mesh_g.device)

    def once():
        rec = _extract_records(mesh_g, glo_g)
        # scalar sinks keep every field of the extraction computed
        return (rec.g_lo.sum() + rec.g_hi.sum(), rec.nu.sum(),
                rec.frf.sum(), rec.loc_rec.sum(), rec.sh_rec.sum())
    once()
    sync()
    ts = []
    for _ in range(max(1, int(repeats))):
        t0 = time.perf_counter()
        once()
        sync()
        ts.append(time.perf_counter() - t0)
    sec = float(np.median(ts))
    from ..obs.metrics import REGISTRY
    REGISTRY.gauge("analysis.extract1x_s").set(sec)
    return sec


def dist_analysis(angedg: float, KS: int):
    """The refresh program: fn(stacked, glo_s [L, capP] int32,
    node_idx_s, nbr_s, packed_M=None) -> (vtag, etag, overflow)."""
    def fn(stacked, glo_s, node_idx_s, nbr_s, packed_M=None):
        return shard_analysis_body(stacked, glo_s, node_idx_s, nbr_s,
                                   angedg, KS, packed_M=packed_M)
    return fn
