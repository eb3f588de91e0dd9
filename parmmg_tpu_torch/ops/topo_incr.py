"""Incremental topology maintenance: dirty-band edge table and adjacency
(port of ``ops/topo_incr.py``).

The sort-based topology primitives (``ops/edges.unique_edges``,
``ops/adjacency.build_adjacency``) re-sort ALL 6*capT / 4*capT slot keys
every cycle even when a wave commits a few winners — the decay regime
every long adaptation ends in.  Mmg maintains its edge/tetra hash tables
incrementally across operator applications (MMG3D_hashTetra,
hash_pmmg.c).  This module is the sort-idiom analogue:

* each wave's *dirty tet set* (rows it created, killed or re-verticed) is
  accumulated as a [capT] bool mask — exact by construction, an
  elementwise diff of (tet, tmask) across the wave, the ONLY inputs the
  slot keys depend on;
* at the next table derivation the dirty tets' slots are re-keyed into a
  fixed-width band (:func:`incr_band_width`, a rung of the geometric
  bucket ladder) and merged into the RETAINED sorted key table: survivors
  compact by rank (K5 prefix sum), band entries are sorted (K7) and
  binary-search their insertion position (lexicographic lower bound over
  the dense survivor table), and ONE packed scatter materialises the
  merged order;
* overflow (more dirty tets than the band) falls back to the full sort,
  so exactness is by construction, never sampled.

Exactness: the full sort is STABLE, so its order is exactly "sort by
(key..., slot index)".  Slot keys are pure functions of the owning tet's
(tet row, tmask) — dead and padded slots key to INT32_MAX — so a slot's
key can only change when its tet is dirty.  The merge partitions slots
into survivors (clean, keys unchanged, relative order retained) and the
band (dirty, re-keyed from the current mesh) and merges them under the
SAME (key..., slot) order; slot indices are unique, so the merged
permutation is the unique sorted order: the same bits as a fresh stable
sort.  Tag payloads (etag) are not retained — the shared epilogue
re-gathers them from the current mesh.

The JAX package picks its branches (knob on, state valid, band fits; no
dirty tet at all) with ``lax.cond``; the port reads the dirty count and
the state's flag on the host, once per derivation, and only when the
incremental path is on (``incr``): off, the full sort runs with no read.
``PARMMG_INCR_TOPO`` is the ``incr`` argument of the grouped drivers
(default off, as in the JAX package); the band width is always the
ladder rung of :func:`incr_band_width`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import INT32_MAX
from ..core.mesh import Mesh, tet_edge_vertices, tet_face_vertices
from ..utils.compilecache import bucket
from . import kernels
from .primitives import nonzero_pad

# band merges and their widths since the last reset (chip_smoke.py reads
# them: the incremental path must be seen to merge)
COUNTS = {"edge_merges": 0, "face_merges": 0, "reuses": 0, "full": 0,
          "overflow": 0}
BAND_WIDTHS: set = set()


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    BAND_WIDTHS.clear()


def incr_band_width(capT: int) -> int:
    """Dirty-band width in TETS for a capacity: one rung of the geometric
    bucket ladder at capT//16 (floor 1024, capped at capT)."""
    return bucket(max(1, capT // 16), floor=1024, cap=capT)


class TopoState(NamedTuple):
    """Retained sorted-table + dirty-band state of one mesh (group slot).

    ``ekey``/``eslot`` are the packed edge sort (sorted keys + the sort
    permutation = original slot ids) retained from the last edge-table
    derivation; ``fk0``/``fkw``/``fslot`` the same for the 2-column face
    sort.  ``eok``/``fok`` gate reuse (False = no retained table — full
    rebuild regardless of the knob).  ``edirty``/``fdirty`` accumulate
    the tets touched since the LAST derivation of each table."""
    ekey: torch.Tensor     # [6*capT] int32 sorted packed edge keys
    eslot: torch.Tensor    # [6*capT] int32 edge sort permutation
    eok: torch.Tensor      # [] bool
    edirty: torch.Tensor   # [capT] bool
    fk0: torch.Tensor      # [4*capT] int32 sorted face key major column
    fkw: torch.Tensor      # [4*capT] int32 sorted face key packed minors
    fslot: torch.Tensor    # [4*capT] int32 face sort permutation
    fok: torch.Tensor      # [] bool
    fdirty: torch.Tensor   # [capT] bool


def topo_init(capT: int, stack: int | None = None,
              device="cpu") -> TopoState:
    """All-zeros state (ok=False: the first derivation is a full
    rebuild).  ``stack`` prepends a group axis.  ``topo_init(capT, G)``
    on the CPU is the host-resident stacked state of the chunked grouped
    pipeline (the JAX package's ``topo_init_np``), written in place by
    its writebacks."""
    def z(shape, dt):
        s = shape if stack is None else (stack,) + shape
        return torch.zeros(s, dtype=dt, device=device)
    i32, b = torch.int32, torch.bool
    return TopoState(
        ekey=z((6 * capT,), i32), eslot=z((6 * capT,), i32),
        eok=z((), b), edirty=z((capT,), b),
        fk0=z((4 * capT,), i32), fkw=z((4 * capT,), i32),
        fslot=z((4 * capT,), i32), fok=z((), b), fdirty=z((capT,), b))


def mark_dirty(topo: TopoState, tet0: torch.Tensor, tmask0: torch.Tensor,
               mesh: Mesh) -> TopoState:
    """Accumulate the dirty tet set across one wave: a tet is dirty iff
    its vertex row or liveness changed — exactly the inputs the edge and
    face slot keys depend on."""
    d = (mesh.tet != tet0).any(dim=1) | (mesh.tmask != tmask0)
    return topo._replace(edirty=topo.edirty | d, fdirty=topo.fdirty | d)


# ---------------------------------------------------------------------------
# the sorted-band merge
# ---------------------------------------------------------------------------

def _prefix_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum — the merge's scan backbone (survivor
    rank compaction + insertion-shift histogram): K5."""
    return kernels.merge_prefix(x.to(torch.int32).contiguous())


def _lower_bound(qkeys, qslot, keys, slot):
    """Lexicographic lower bound of each (qkeys..., qslot) query in the
    dense ascending (keys..., slot) table: the first index whose entry
    compares >= the query.  ``bit_length`` iterations of gathers."""
    n = slot.shape[0]
    dev = qslot.device
    lo = torch.zeros(qslot.shape, dtype=torch.int32, device=dev)
    hi = torch.full(qslot.shape, n, dtype=torch.int32, device=dev)
    for _ in range(max(1, int(n).bit_length())):
        mid = (lo + hi) >> 1
        mc = mid.clamp(0, n - 1).long()
        less = torch.zeros(qslot.shape, dtype=torch.bool, device=dev)
        eq = torch.ones(qslot.shape, dtype=torch.bool, device=dev)
        for qk, k in zip(qkeys, keys):
            kv = k[mc]
            less = less | (eq & (kv < qk))
            eq = eq & (kv == qk)
        kv = slot[mc]
        less = less | (eq & (kv < qslot))
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo


def band_order(bkeys, bslot):
    """Stable band sort permutation, ascending by (bkeys..., bslot): the
    slot rides as an explicit trailing radix word, because band record
    order differs from slot order.  K7."""
    words = tuple(k.contiguous() for k in bkeys) + (bslot.contiguous(),)
    return kernels.radix_sort(words)


def merge_sorted_band(keys, slot, sd, bkeys, bslot):
    """Merge a re-keyed dirty band into a retained stable sort.

    ``keys`` (tuple of [n] int32 columns) + ``slot`` [n] are the retained
    sorted table (ascending by (keys..., slot)); ``sd`` [n] marks the
    sorted positions owned by dirty tets (tombstones: their keys are
    stale).  ``bkeys``/``bslot`` [m] are the band's fresh records — every
    slot of every dirty tet, dead slots keyed INT32_MAX with their REAL
    slot id, pad entries keyed INT32_MAX with slot INT32_MAX.

    Survivors compact by prefix-sum rank into a dense table padded with
    (+inf, +inf) sentinels; the band sorts locally and each entry
    lower-bounds its insertion position; band j lands at pos_j + j,
    survivor i shifts by the inclusive prefix of the insertion histogram
    at <= i, which places every live record exactly once, and
    sentinel/pad rows land at index >= n, where they are dropped (the
    scatters write them to a dump row past the end).  Returns the merged
    (keys list, slot): the same bits as a fresh stable sort of the
    current keys."""
    n = slot.shape[0]
    m = bslot.shape[0]
    nk = len(keys)
    dev = slot.device
    keep = ~sd
    # survivor ranks: dense position = (# keepers at <= i) - 1
    r = _prefix_i32(keep) - 1
    tgt = torch.where(keep, r, n).long()
    pay = torch.stack(list(keys) + [slot], dim=1)             # [n, nk+1]
    sur = torch.full((n + 1, nk + 1), INT32_MAX, dtype=torch.int32,
                     device=dev)
    sur[tgt] = pay                 # rows below n written once; n is a dump
    sur = sur[:n]
    skeys = [sur[:, j] for j in range(nk)]
    sslot = sur[:, nk]
    # band sort: (keys..., slot) ascending — pads (all INT32_MAX) last
    border = band_order(bkeys, bslot).long()
    bks = [bk[border] for bk in bkeys]
    bs = bslot[border]
    pos = _lower_bound(bks, bs, skeys, sslot)                 # [m]
    # survivor shift = inclusive prefix of the insertion histogram (pad
    # entries are parked at bin n and excluded from the prefix)
    real = bs != INT32_MAX
    hist = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    hist.scatter_add_(0, torch.where(real, pos, n).long(),
                      torch.ones(m, dtype=torch.int32, device=dev))
    shift = _prefix_i32(hist[:n])
    sur_final = torch.arange(n, dtype=torch.int32, device=dev) + shift
    band_final = pos + torch.arange(m, dtype=torch.int32, device=dev)
    idx = torch.cat([sur_final, band_final])
    idx = torch.where(idx < n, idx, n).long()
    pay_all = torch.cat([sur, torch.stack(bks + [bs], dim=1)])
    merged = torch.zeros((n + 1, nk + 1), dtype=torch.int32, device=dev)
    merged[idx] = pay_all
    merged = merged[:n]
    return [merged[:, j].contiguous() for j in range(nk)], \
        merged[:, nk].contiguous()


# ---------------------------------------------------------------------------
# band record extraction
# ---------------------------------------------------------------------------

def edge_band_records(mesh: Mesh, dt: torch.Tensor):
    """Fresh packed edge keys + slot ids for the 6 edge slots of each
    band tet ``dt`` ([B], capT-padded).  Dead tets key INT32_MAX with
    their REAL slot ids (tombstones); pads (dt == capT) get slot
    INT32_MAX and are dropped by the merge."""
    capT = mesh.capT
    dev = mesh.device
    dt = dt.to(torch.int32)
    dtc = dt.clamp(0, capT - 1).long()
    ev = tet_edge_vertices(mesh.tet[dtc])                    # [B, 6, 2]
    a = torch.minimum(ev[..., 0], ev[..., 1])
    b = torch.maximum(ev[..., 0], ev[..., 1])
    live = mesh.tmask[dtc] & (dt < capT)
    key = torch.where(live[:, None], a * mesh.capP + b, INT32_MAX)
    slot = torch.where(
        (dt < capT)[:, None],
        dt[:, None] * 6 + torch.arange(6, dtype=torch.int32,
                                       device=dev)[None, :], INT32_MAX)
    return key.reshape(-1).to(torch.int32), slot.reshape(-1).to(torch.int32)


def face_band_records(mesh: Mesh, dt: torch.Tensor):
    """Fresh (major, packed-minor) face keys + slot ids for the 4 face
    slots of each band tet (conventions of :func:`edge_band_records`;
    the packed branch of ``ops/adjacency.face_sort`` bit for bit)."""
    capT = mesh.capT
    dev = mesh.device
    dt = dt.to(torch.int32)
    dtc = dt.clamp(0, capT - 1).long()
    fv = torch.sort(tet_face_vertices(mesh.tet[dtc]), dim=-1).values
    live = mesh.tmask[dtc] & (dt < capT)
    k0 = torch.where(live[:, None], fv[..., 0], INT32_MAX)
    kw = torch.where(live[:, None], fv[..., 1] * mesh.capP + fv[..., 2],
                     INT32_MAX)
    slot = torch.where(
        (dt < capT)[:, None],
        dt[:, None] * 4 + torch.arange(4, dtype=torch.int32,
                                       device=dev)[None, :], INT32_MAX)
    return (k0.reshape(-1).to(torch.int32), kw.reshape(-1).to(torch.int32),
            slot.reshape(-1).to(torch.int32))


# ---------------------------------------------------------------------------
# table derivations (band-merged or full)
# ---------------------------------------------------------------------------

def _band_route(ok, dirty, incr: bool, B: int) -> str:
    """"full", "reuse" or "merge": the JAX package's two ``lax.cond``s
    (band when ``incr`` & ok & nd <= B; inside it, reuse when nd == 0),
    decided on the host from one read of (ok, nd) — none when ``incr``
    is off."""
    if not incr:
        return "full"
    okv, nd = torch.stack([ok.to(torch.int64),
                           dirty.sum(dtype=torch.int64)]).tolist()
    if not okv:
        return "full"
    if nd > B:
        COUNTS["overflow"] += 1
        return "full"
    return "reuse" if nd == 0 else "merge"


def incr_unique_edges(mesh: Mesh, topo: TopoState, incr: bool,
                      shell_slots: int = 0):
    """EdgeTable via the retained sort: band-merge when ``incr``, the
    state is valid and the dirty set fits the band; otherwise the full
    packed sort (the same bits as ``ops/edges.unique_edges`` either way:
    both feed the shared epilogue).  Consumes ``edirty``.  Returns
    (EdgeTable, new TopoState)."""
    from .edges import PACK_LIMIT, unique_edges, unique_edges_from_sorted
    capT = mesh.capT
    n6 = capT * 6
    dev = mesh.device
    clean = torch.zeros(capT, dtype=torch.bool, device=dev)
    if mesh.capP > PACK_LIMIT:
        # the merge needs single-int32 packed keys; oversized id spaces
        # keep the exact legacy path (never reached at group shapes)
        et = unique_edges(mesh, shell_slots=shell_slots)
        return et, topo._replace(
            eok=torch.zeros((), dtype=torch.bool, device=dev), edirty=clean)
    B = incr_band_width(capT)
    route = _band_route(topo.eok, topo.edirty, incr, B)
    first = None
    if route == "full":
        COUNTS["full"] += 1
        ev = tet_edge_vertices(mesh.tet).reshape(n6, 2)
        a = torch.minimum(ev[:, 0], ev[:, 1])
        b = torch.maximum(ev[:, 0], ev[:, 1])
        valid = mesh.tmask.repeat_interleave(6)
        key = torch.where(valid, a * mesh.capP + b, INT32_MAX).to(
            torch.int32)
        order = kernels.radix_sort((key,))
        (ks,), first = kernels.segment_flags((key,), order=order)
    elif route == "reuse":
        # no dirty tet since the last derivation: the retained sort IS
        # the fresh sort (keys depend only on tet/tmask)
        COUNTS["reuses"] += 1
        ks, order = topo.ekey, topo.eslot
    else:
        COUNTS["edge_merges"] += 1
        BAND_WIDTHS.add(("edge", B))
        sd = topo.edirty[torch.div(topo.eslot, 6,
                                   rounding_mode="floor").long()]
        dt = nonzero_pad(topo.edirty, B, capT)
        bkey, bslot = edge_band_records(mesh, dt)
        (ks,), order = merge_sorted_band((topo.ekey,), topo.eslot, sd,
                                         (bkey,), bslot)
    et = unique_edges_from_sorted(mesh, order, ks, shell_slots=shell_slots,
                                  first=first)
    topo = topo._replace(ekey=ks, eslot=order.to(torch.int32),
                         eok=torch.ones((), dtype=torch.bool, device=dev),
                         edirty=clean)
    return et, topo


def incr_build_adjacency(mesh: Mesh, topo: TopoState, incr: bool,
                         set_bdy_tags: bool = True):
    """Adjacency (and boundary tags) via the retained face sort — the
    incremental form of ``ops/adjacency.build_adjacency`` (merged face
    records feed the SAME pairing epilogue).  Consumes ``fdirty``.
    Returns (mesh with adja/ftag, new TopoState)."""
    from .adjacency import (_face_keys, adjacency_from_records,
                            build_adjacency, face_records_from_sorted)
    from .edges import PACK_LIMIT
    capT = mesh.capT
    dev = mesh.device
    clean = torch.zeros(capT, dtype=torch.bool, device=dev)
    if mesh.capP > PACK_LIMIT:
        return (build_adjacency(mesh, set_bdy_tags=set_bdy_tags),
                topo._replace(fok=torch.zeros((), dtype=torch.bool,
                                              device=dev), fdirty=clean))
    B = incr_band_width(capT)
    route = _band_route(topo.fok, topo.fdirty, incr, B)
    if route == "full":
        COUNTS["full"] += 1
        cols = _face_keys(mesh)
        c0 = cols[:, 0].contiguous()
        w = torch.where(c0 == INT32_MAX, INT32_MAX,
                        cols[:, 1] * mesh.capP + cols[:, 2]).to(torch.int32)
        order = kernels.radix_sort((c0, w), nbits=(16, 32))
        (k0, kw), first = kernels.segment_flags((c0, w), order=order)
    else:
        if route == "reuse":
            COUNTS["reuses"] += 1
            k0, kw, order = topo.fk0, topo.fkw, topo.fslot
        else:
            COUNTS["face_merges"] += 1
            BAND_WIDTHS.add(("face", B))
            sd = topo.fdirty[torch.div(topo.fslot, 4,
                                       rounding_mode="floor").long()]
            dt = nonzero_pad(topo.fdirty, B, capT)
            bk0, bkw, bslot = face_band_records(mesh, dt)
            (k0, kw), order = merge_sorted_band(
                (topo.fk0, topo.fkw), topo.fslot, sd, (bk0, bkw), bslot)
        first = kernels.segment_flags((k0, kw))
    t, f, partner, matched, _ = face_records_from_sorted(
        mesh, order, k0, kw, first=first)
    mesh = adjacency_from_records(mesh, t, f, partner, matched,
                                  set_bdy_tags=set_bdy_tags)
    topo = topo._replace(fk0=k0, fkw=kw, fslot=order.to(torch.int32),
                         fok=torch.ones((), dtype=torch.bool, device=dev),
                         fdirty=clean)
    return mesh, topo
