"""Torch counterparts of the array idioms the JAX package relies on.

- ``x.at[idx].set(v, mode="drop")`` with an out-of-range sentinel index
  -> :func:`set_drop` (rows with a sentinel are dropped before the write;
  callers keep the remaining indices unique where the reference relied on
  ``unique_indices=True``: a duplicate ``index_put_`` on CUDA has no
  defined winner);
- ``.at[].max/min/add`` -> :func:`reduce_drop` (``scatter_reduce`` with
  the destination included, exactly like JAX's; a float sum on the card
  goes through :func:`fixed_order_sum`, since CUDA's ``scatter_reduce``
  adds with atomics in no fixed order);
- ``jnp.nonzero(m, size=K, fill_value=cap)`` -> :func:`nonzero_pad`;
- ``jnp.lexsort`` -> :func:`lexsort` (stable sorts chained, minor key
  first); ``jnp.argsort`` -> :func:`argsort` (stable);
- ``lax.top_k`` -> :func:`topk_lowest_index`: torch.topk orders ties
  differently, lax.top_k puts the lowest index first;
- ``lax.associative_scan`` of the segmented OR / max -> :func:`seg_scan`,
  a Hillis-Steele doubling scan (log2 n steps, exact for OR and max).
"""
from __future__ import annotations

import torch

from . import kernels

_SUM_WIDTH = 32        # values added per row of one fixed_order_sum level


def _valid(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx >= 0) & (idx < n)


def set_drop(dst: torch.Tensor, idx, vals) -> torch.Tensor:
    """Out-of-place ``dst.at[idx].set(vals, mode="drop")``.  ``idx`` is a
    tensor (first axis) or a tuple of tensors (leading axes)."""
    out = dst.clone()
    if isinstance(idx, tuple):
        ok = torch.ones_like(idx[0], dtype=torch.bool)
        for ax, ix in enumerate(idx):
            ok &= _valid(ix, dst.shape[ax])
        sel = tuple(ix[ok].long() for ix in idx)
    else:
        ok = _valid(idx, dst.shape[0])
        sel = (idx[ok].long(),)
    if not isinstance(vals, torch.Tensor) or vals.dim() == 0:
        out[sel] = vals
    else:
        out[sel] = vals[ok].to(dst.dtype)
    return out


def reduce_drop(dst: torch.Tensor, idx: torch.Tensor, vals, reduce: str):
    """Out-of-place ``dst.at[idx].{max,min,add}(vals, mode="drop")`` along
    the first axis; ``reduce`` is "amax", "amin" or "sum"."""
    ok = _valid(idx, dst.shape[0])
    if not isinstance(vals, torch.Tensor):
        vals = torch.full(idx.shape + dst.shape[1:], vals, dtype=dst.dtype,
                          device=dst.device)
    vals = vals[ok].to(dst.dtype)
    ix = idx[ok].long()
    if dst.dtype == torch.bool:
        out = dst.to(torch.int32)
        return reduce_drop(out, ix, vals.to(torch.int32), reduce).bool()
    if reduce == "sum" and dst.is_floating_point() and dst.is_cuda:
        return fixed_order_sum(dst, ix, vals)
    if dst.dim() > 1:
        ix = ix.view((-1,) + (1,) * (dst.dim() - 1)).expand_as(vals)
    return dst.scatter_reduce(0, ix, vals, reduce, include_self=True)


def fixed_order_sum(dst: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``dst.at[idx].add(vals)`` (``idx`` in range) whose
    float bits do not depend on thread scheduling: the same inputs give
    the same bits on every run.

    The values are stably sorted by destination (K7), each value gets its
    rank inside its destination's run (``pos - seg_head``, the head found
    by binary search: a ``cummax`` scan costs ~1 ms a call on the card),
    and the runs are summed in fixed groups of ``_SUM_WIDTH``: every group
    is a zero-padded row reduced by a fixed tree of elementwise adds, and
    a run longer than one group is summed again from its group sums, level
    by level, until one value per destination is left.  That value is added
    to ``dst`` once.  PyTorch's deterministic ``scatter_reduce`` gives the
    same guarantee but adds each destination's run one value after
    another, and the sentinel row of masked values holds up to ~10^6 of
    them: 25x slower on the card at smooth_wave's shape."""
    out = dst.clone()
    n = idx.shape[0]
    if n == 0:
        return out
    dev = dst.device
    v = vals.to(dst.dtype).reshape(n, -1)
    nbits = max(1, (dst.shape[0] - 1).bit_length())
    key = idx.to(torch.int32).contiguous()
    order = kernels.radix_sort((key,), nbits=(min(nbits, 32),))
    # the first level's keys come sorted and flagged from one K8 launch
    (key,), first = kernels.segment_flags((key,), order=order)
    v = v[order.long()]
    while True:
        pos = torch.arange(key.shape[0], dtype=torch.int32, device=dev)
        rank = pos - torch.searchsorted(key, key, out_int32=True)
        col = (rank % _SUM_WIDTH).long()
        start = col == 0
        grp = kernels.merge_prefix(start.to(torch.int32)).long() - 1
        ngrp, nseg = torch.stack([grp[-1] + 1, first.sum()]).tolist()
        blk = torch.zeros((ngrp, _SUM_WIDTH, v.shape[1]), dtype=v.dtype,
                          device=dev)
        blk[grp, col] = v
        w = _SUM_WIDTH
        while w > 1:
            w //= 2
            blk = blk[:, :w] + blk[:, w:]
        key, v = key[start], blk[:, 0]
        if ngrp == nseg:
            break
        first = kernels.segment_flags((key,))
    k = key.long()
    out[k] = out[k] + v.reshape((ngrp,) + tuple(dst.shape[1:]))
    return out


def segment_first(*cols) -> torch.Tensor:
    """[n] bool: True at row 0 and wherever any of the sorted columns
    differs from the row before."""
    first = torch.ones(cols[0].shape[0], dtype=torch.bool,
                       device=cols[0].device)
    if cols[0].shape[0] > 1:
        neq = cols[0][1:] != cols[0][:-1]
        for c in cols[1:]:
            neq = neq | (c[1:] != c[:-1])
        first[1:] = neq
    return first


def nonzero_pad(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """First ``size`` indices where ``mask`` is True, padded with ``fill``
    (int64)."""
    idx = torch.nonzero(mask).flatten()[:size]
    if idx.shape[0] < size:
        pad = torch.full((size - idx.shape[0],), fill, dtype=idx.dtype,
                         device=idx.device)
        idx = torch.cat([idx, pad])
    return idx


def argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def lexsort(*keys) -> torch.Tensor:
    """Stable sort permutation by ``keys`` (MAJOR key first), i.e.
    ``jnp.lexsort(keys[::-1])``."""
    order = argsort(keys[-1])
    for k in keys[-2::-1]:
        order = order[argsort(k[order])]
    return order


def topk_lowest_index(x: torch.Tensor, k: int):
    """``lax.top_k(x, k)``: the k largest values, descending, ties in
    ascending index order."""
    s = torch.sort(x, descending=True, stable=True)
    return s.values[:k], s.indices[:k]


def seg_scan(first: torch.Tensor, values: torch.Tensor, op: str):
    """Inclusive segmented scan (``op`` "or" or "max") over segments whose
    heads are marked by ``first``."""
    f = first.clone()
    v = values.clone()
    n = v.shape[0]
    d = 1
    while d < n:
        vp = v[:-d]
        comb = (v[d:] | vp) if op == "or" else torch.maximum(v[d:], vp)
        v_new = v.clone()
        v_new[d:] = torch.where(f[d:], v[d:], comb)
        f_new = f.clone()
        f_new[d:] = f[d:] | f[:-d]
        v, f = v_new, f_new
        d *= 2
    return v
