"""Unique mesh edges, candidate scoring and claim priorities (port of
``ops/edges.py``).

All 6*capT tet edges are sorted by (min vid, max vid); the first slot of
each key segment is the unique edge.  The sorts and segment heads run on
the sort engine as the JAX package runs them on the TPU: ``radix_sort``
(K7) and ``segment_flags`` (K8).  ``edge_lengths`` (K1
for an iso metric, K2 for a tensor metric) and ``topk_prep`` / ``topk_prep3`` (K3 / K4) dispatch to the CUDA kernels
of ``ops/kernels.py`` too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import INT32_MAX, INT32_MIN
from ..core.mesh import Mesh, tet_edge_vertices
from . import kernels
from .primitives import nonzero_pad, reduce_drop, seg_scan, set_drop

PACK_LIMIT = 46340     # floor(sqrt(2^31)): a*capP+b stays in int32
PRI_MIN = INT32_MIN    # tie-channel sentinel (< every hash)
NEG_INF = float("-inf")


def wave_budget(capT: int, div: int = 8) -> int:
    """Per-wave top-K compaction budget shared by every wave."""
    return max(2048, capT // div)


def free_rows(mask: torch.Tensor, K: int):
    """First ``K`` dead rows (``mask`` False), padded with ``cap``; and
    the number of dead rows.  Returns (rows [K] int64, nfree 0-d)."""
    cap = mask.shape[0]
    return nonzero_pad(~mask, K, cap), (~mask).sum(dtype=torch.int32)


def sort_pairs(a, b, valid, capP: int):
    """Sort (a, b) id pairs ascending, invalid slots last.  Returns
    (order [n] int64, ka, kb, first) like the JAX package: one packed
    key when capP <= PACK_LIMIT, two key words otherwise.  K8 gathers the
    sorted keys and flags them in one launch."""
    big = torch.full_like(a, INT32_MAX)
    if capP <= PACK_LIMIT:
        key = torch.where(valid, a * capP + b, big).to(torch.int32)
        order = kernels.radix_sort((key,))
        (ks,), first = kernels.segment_flags((key,), order=order)
        inv = ks == INT32_MAX
        ka = torch.where(inv, big, torch.div(ks, capP, rounding_mode="floor"))
        kb = torch.where(inv, big, ks % capP)
        return order.long(), ka, kb, first
    aa = torch.where(valid, a, big).to(torch.int32)
    bb = torch.where(valid, b, big).to(torch.int32)
    order = kernels.radix_sort((aa, bb))
    (ka, kb), first = kernels.segment_flags((aa, bb), order=order)
    return order.long(), ka, kb, first


def segmented_or(first, values):
    """Inclusive segmented bitwise-OR scan (segment totals at the last
    element of each segment)."""
    return seg_scan(first, values, "or")


def segmented_max(first, values):
    """Inclusive segmented max scan."""
    return seg_scan(first, values, "max")


class EdgeTable(NamedTuple):
    """Unique edges; capE = 6*capT masked slots (see the JAX package)."""
    ev: torch.Tensor          # [capE, 2] int32
    emask: torch.Tensor       # [capE] bool
    etag: torch.Tensor        # [capE] int32
    nshell: torch.Tensor      # [capE] int32
    edge_id: torch.Tensor     # [capT, 6] int32
    shell3: torch.Tensor      # [capE, S] int32 (-1 unused)
    shell_rank: torch.Tensor  # [capT, 6] int32
    skey: torch.Tensor        # [capE] sorted packed keys, or [0]


def unique_edges(mesh: Mesh, shell_slots: int = 3) -> EdgeTable:
    capT = mesh.capT
    n6 = capT * 6
    ev = tet_edge_vertices(mesh.tet).reshape(n6, 2)
    a = torch.minimum(ev[:, 0], ev[:, 1])
    b = torch.maximum(ev[:, 0], ev[:, 1])
    valid = mesh.tmask.repeat_interleave(6)
    order, ka, kb, first = sort_pairs(a, b, valid, mesh.capP)
    return _edges_epilogue(mesh, order, ka, kb, first, shell_slots)


def unique_edges_from_sorted(mesh: Mesh, order, ks, shell_slots: int = 0,
                             first=None) -> EdgeTable:
    """EdgeTable from a precomputed packed edge sort: ``order`` the
    stable permutation of the 6*capT slot keys, ``ks`` the ascending
    packed keys (a*capP+b, INT32_MAX on invalid slots), as
    ``sort_pairs``' packed branch gives them, and ``first`` their
    segment flags (computed when not given).  Needs capP <= PACK_LIMIT."""
    ks = ks.to(torch.int32).contiguous()
    if first is None:
        first = kernels.segment_flags((ks,))
    inv = ks == INT32_MAX
    big = torch.full_like(ks, INT32_MAX)
    ka = torch.where(inv, big, torch.div(ks, mesh.capP, rounding_mode="floor"))
    kb = torch.where(inv, big, ks % mesh.capP)
    return _edges_epilogue(mesh, order.long(), ka, kb, first, shell_slots)


def _edges_epilogue(mesh: Mesh, order, ka, kb, first,
                    shell_slots: int) -> EdgeTable:
    capT = mesh.capT
    n6 = capT * 6
    dev = mesh.device
    i32 = dict(dtype=torch.int32, device=dev)
    valid_s = ka != INT32_MAX
    pos = torch.arange(n6, **i32)
    tags = torch.where(valid_s, mesh.etag.reshape(n6)[order],
                       torch.zeros((), **i32))
    seg_head = torch.cummax(torch.where(first, pos, torch.zeros((), **i32)),
                            dim=0).values
    or_scan = segmented_or(first, tags)
    eid_sorted = seg_head
    rank = pos - seg_head
    is_last = torch.ones_like(first)
    is_last[:-1] = first[1:]

    emask = first & valid_s
    ev_u = torch.stack([ka, kb], dim=1)
    head_pay = torch.stack([or_scan, rank + 1], dim=1)
    head_tbl = set_drop(torch.zeros((n6, 2), **i32),
                        torch.where(is_last, eid_sorted,
                                    torch.full_like(eid_sorted, n6)),
                        head_pay)
    etag = head_tbl[:, 0].contiguous()
    nshell = head_tbl[:, 1].contiguous()
    back = torch.zeros((n6, 2), **i32)
    back[order] = torch.stack([eid_sorted, rank], dim=1)
    edge_id = back[:, 0].reshape(capT, 6).contiguous()
    shell_rank = back[:, 1].reshape(capT, 6).contiguous()
    if shell_slots > 0:
        tet_of_slot = torch.div(order, 6, rounding_mode="floor").to(
            torch.int32)
        tgt_e = torch.where(valid_s & (rank < shell_slots), eid_sorted,
                            torch.full_like(eid_sorted, n6))
        shell3 = set_drop(torch.full((n6, shell_slots), -1, **i32),
                          (tgt_e, rank.clamp(0, shell_slots - 1)),
                          tet_of_slot)
    else:
        shell3 = torch.zeros((n6, 0), **i32)
    if shell_slots > 0 and mesh.capP <= PACK_LIMIT:
        skey = torch.where(valid_s, ka * mesh.capP + kb,
                           torch.full_like(ka, INT32_MAX))
    else:
        skey = torch.zeros((0,), **i32)
    return EdgeTable(ev=ev_u, emask=emask, etag=etag, nshell=nshell,
                     edge_id=edge_id, shell3=shell3, shell_rank=shell_rank,
                     skey=skey)


def edge_lengths(mesh: Mesh, et: EdgeTable, met: torch.Tensor):
    """[capE] metric length of each unique edge: K1 for an iso metric
    [capP], K2 for a packed tensor metric [capP, 6]."""
    if met.dim() == 1:
        return kernels.edge_lengths_iso(mesh.vert, met, et.ev)
    return kernels.edge_lengths_ani(mesh.vert, met, et.ev)


def topk_prep(cand: torch.Tensor, val: torch.Tensor):
    """``(where(cand, -val, -inf), sum(cand))`` (K3 kernel)."""
    return kernels.score_count(cand, val.contiguous())


def topk_prep3(cand, v0, v1, v2):
    """``topk_prep`` of ``min(v0, min(v1, v2))`` (K4 kernel)."""
    return kernels.score3_count(cand, v0.contiguous(), v1.contiguous(),
                                v2.contiguous())


def unique_priority(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Unique int32 priority per slot (higher = better score), ties
    broken by sort rank; masked slots get 0 (the JAX package keeps it for
    reference and tests; the waves use the two-channel claims)."""
    n = score.shape[0]
    neg = torch.where(mask, -score, torch.full_like(score, float("inf")))
    order = priority_order(neg)
    rank = torch.zeros(n, dtype=torch.int32, device=score.device)
    rank[order.long()] = torch.arange(n, dtype=torch.int32,
                                      device=score.device)
    return torch.where(mask, n - rank, torch.zeros_like(rank))


def priority_order(neg: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of a float32 vector through the radix
    engine: K7 over the order-preserving uint32 image of the floats."""
    return kernels.radix_sort((kernels.f32_sort_u32(neg.contiguous()),))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> the int32 with the same bit pattern."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def tie_hash(n: int, salt: int = 0, device="cpu") -> torch.Tensor:
    """Unique pseudo-random int32 per slot: a bijective avalanche mix of
    the index, computed in int64 with 32-bit masks (uint32 arithmetic of
    the JAX package)."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    x = (x + (salt * 2246822519) % 2 ** 32) & 0xFFFFFFFF
    x = _mul32(x, 2654435761)
    x = x ^ (x >> 16)
    x = _mul32(x, 2246822519)
    x = x ^ (x >> 13)
    x = _mul32(x, 3266489917)
    x = x ^ (x >> 16)
    return to_int32_bits(x)


def claim_channels(score: torch.Tensor, mask: torch.Tensor, salt: int = 0):
    """(s, t) channels of the two-channel claim scheme."""
    s = torch.where(mask, score.to(torch.float32),
                    torch.full_like(score, NEG_INF, dtype=torch.float32))
    t = torch.where(mask, tie_hash(score.shape[0], salt, score.device),
                    torch.full(score.shape, PRI_MIN, dtype=torch.int32,
                               device=score.device))
    return s, t


def scatter_argmax2(site, s, t, mask, nsites: int):
    """Is each slot the unique (s,t)-max among slots scattered to its
    site?  Returns (is_max, c_s [nsites+1], c_t [nsites+1])."""
    dev = s.device
    sited = site.clamp(0, nsites - 1).long()
    safe = torch.where(mask, site, torch.full_like(site, nsites))
    c_s = reduce_drop(torch.full((nsites + 1,), NEG_INF, device=dev), safe,
                      torch.where(mask, s, torch.full_like(s, NEG_INF)),
                      "amax")
    at_max = mask & (s == c_s[sited])
    safe2 = torch.where(at_max, site, torch.full_like(site, nsites))
    c_t = reduce_drop(torch.full((nsites + 1,), PRI_MIN, dtype=torch.int32,
                                 device=dev), safe2,
                      torch.where(at_max, t, torch.full_like(t, PRI_MIN)),
                      "amax")
    return at_max & (t == c_t[sited]), c_s, c_t


def claim_shells(score, cand, shells, capT: int):
    """Exclusive multi-slot claims: a winner is the (score, tie-hash)
    max at every shell slot it touches (see the JAX package)."""
    ps, pt = claim_channels(score, cand)
    k = len(shells)
    shs = torch.stack(shells).long()                      # [k, E]
    idx = torch.where(cand[None, :], shs,
                      torch.full_like(shs, capT)).reshape(-1)
    cl_s = reduce_drop(torch.full((capT + 1,), NEG_INF, device=ps.device),
                       idx, ps.repeat(k), "amax")
    eq = cand & (ps[None, :] == cl_s[shs]).all(dim=0)
    idx2 = torch.where(eq[None, :], shs,
                       torch.full_like(shs, capT)).reshape(-1)
    cl_t = reduce_drop(torch.full((capT + 1,), PRI_MIN, dtype=torch.int32,
                                  device=ps.device), idx2, pt.repeat(k),
                       "amax")
    return eq & (pt[None, :] == cl_t[shs]).all(dim=0)


def morton_codes(pts: torch.Tensor, valid: torch.Tensor, bits: int = 10):
    """[n] int32 morton codes normalised over the ``valid`` rows' box."""
    inf = torch.full_like(pts, float("inf"))
    lo = torch.where(valid[:, None], pts, inf).min(dim=0).values
    hi = torch.where(valid[:, None], pts, -inf).max(dim=0).values
    u = torch.clamp((pts - lo) / torch.clamp(hi - lo, min=1e-30),
                    0.0, 1.0 - 1e-7)
    q = (u * float(1 << bits)).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return to_int32_bits(code & 0xFFFFFFFF)
