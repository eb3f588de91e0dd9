"""The port's hand-written CUDA kernels, their wrappers and plain versions.

The eight TPU kernels of ``parmmg_tpu/ops/pallas_kernels.py``, each
replaced by a CUDA kernel in ``csrc/`` (K1 runs on the iso-metric path, K2
on the tensor-metric path, the others on both):

=================  ==========================  ===========================
wrapper            CUDA source                 replaces
=================  ==========================  ===========================
edge_lengths_iso   csrc/edge_length_iso.cu     edge_length_iso_pallas (K1)
edge_lengths_ani   csrc/edge_length_ani.cu     edge_length_ani_pallas (K2)
score_count        csrc/score_count.cu         score_count_pallas (K3)
score3_count       csrc/score_count.cu         score3_count_pallas (K4)
merge_prefix       csrc/merge_prefix.cu        merge_prefix_pallas (K5)
tet_quality        csrc/tet_quality.cu         quality_pallas (K6)
radix_sort         csrc/radix_sort.cu          radix_sort_pallas (K7)
segment_flags      csrc/segment_flags.cu       segment_flags_pallas (K8)
=================  ==========================  ===========================

Every wrapper is one launch a call except ``radix_sort``: 1 + npass
launches (a histogram of every digit pass, then one one-sweep pass per
8-bit digit), and no K5 scan.  ``score_count``, ``score3_count``,
``merge_prefix`` and ``radix_sort`` keep a few small buffers on the device
between calls (K3/K4's count word, tile counters, epochs, K5's status
words), one set for each stream they are called on
(``_scratch``); K7 takes its row-sized buffers from PyTorch's allocator
on every call.  ``segment_flags(words, order=perm)`` gathers the columns
through a sort's permutation in the same launch and returns them with
their flags, so a sort site needs no separate gather of its keys.
``f32_sort_u32`` (the float image K7 sorts, no ``pallas_call`` in the JAX
package) is plain torch.

A wrapper runs the kernel for CUDA tensors and raises if it cannot
(missing ``nvcc``, failed build, refused launch); it runs the plain
PyTorch version beside it only when the tensors lie on the CPU.  Each
wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.constants import EPSD, INT32_MAX
from . import cuda_build
from .quality import edge_length_ani, quality_from_points

LAUNCHES = {"edge_lengths_iso": 0, "edge_lengths_ani": 0, "score_count": 0,
            "score3_count": 0, "tet_quality": 0, "merge_prefix": 0,
            "radix_sort": 0, "segment_flags": 0}

_P = ctypes.c_void_p
_SIGS = {
    "pm_edge_lengths_iso": ("edge_length_iso",
                            [_P, _P, _P, _P, ctypes.c_int,
                             ctypes.c_longlong, _P]),
    "pm_edge_lengths_ani": ("edge_length_ani",
                            [_P, _P, _P, _P, ctypes.c_int,
                             ctypes.c_longlong, _P]),
    "pm_score_count": ("score_count",
                       [_P, _P, _P, _P, _P, ctypes.c_longlong, _P]),
    "pm_score3_count": ("score_count",
                        [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P]),
    "pm_score_scratch_ints": ("score_count", []),
    "pm_tet_quality": ("tet_quality",
                       [_P, _P, _P, _P, _P, ctypes.c_int,
                        ctypes.c_longlong, _P]),
    "pm_merge_prefix": ("merge_prefix",
                        [_P, _P, ctypes.c_longlong, _P, _P,
                         ctypes.c_longlong, _P]),
    "pm_merge_prefix_tile": ("merge_prefix", []),
    "pm_radix_sort": ("radix_sort",
                      [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
                       ctypes.c_longlong, ctypes.c_longlong, _P]),
    "pm_radix_tile": ("radix_sort", []),
    "pm_segment_flags": ("segment_flags",
                         [_P, _P, _P, ctypes.c_int, _P, _P, _P, _P, _P,
                          ctypes.c_longlong, _P]),
    "pm_segment_flags_rows": ("segment_flags", []),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_FNS: dict = {}


def _fn(sym: str):
    """The ctypes function ``sym``, bound once."""
    f = _FNS.get(sym)
    if f is None:
        src, argtypes = _SIGS[sym]
        f = getattr(cuda_build.load(src), sym)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[sym] = f
    return f


def _check(name, t, dtype, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _on_card(*ts) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    any other device."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _launch(sym, *args):
    rc = _fn(sym)(*args)
    if rc != 0:
        raise RuntimeError(f"{sym}: CUDA error {rc}")


def _stream(t):
    """The raw handle of the current stream on ``t``'s (CUDA) device."""
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K1 / K2: iso / aniso edge length with the endpoint gathers folded in
# ---------------------------------------------------------------------------
def _endpoints(vert, met, ev):
    capP = vert.shape[0]
    i0 = ev[:, 0].clamp(0, capP - 1).long()
    i1 = ev[:, 1].clamp(0, capP - 1).long()
    return vert[i0], vert[i1], met[i0], met[i1]


def edge_lengths_iso_plain(vert, met, ev):
    """K1's function in the Pallas kernel's form: the log ratio of the
    two clamped sizes (``quality.edge_length_iso`` divides the unclamped
    first size; the two differ only where a size is below EPSD, a -inf
    size included).  Every clamp keeps NaN."""
    p0, p1, h0, h1 = _endpoints(vert, met, ev)
    d = torch.sqrt(torch.clamp(((p1 - p0) ** 2).sum(-1), min=0.0))
    ha = torch.clamp(h0, min=EPSD)
    hb = torch.clamp(h1, min=EPSD)
    r0, r1 = 1.0 / ha, 1.0 / hb
    close = (r0 - r1).abs() < 1e-6 * torch.maximum(r0, r1)
    one = torch.ones_like(r0)
    logr = torch.log(torch.clamp(torch.where(close, one, ha / hb), min=EPSD))
    lm = torch.where(close, 0.5 * (r0 + r1),
                     (r1 - r0) / torch.where(close, one, logr))
    return d * lm


def edge_lengths_ani_plain(vert, met6, ev):
    return edge_length_ani(*_endpoints(vert, met6, ev))


def _edge_lengths(name, plain, vert, met, ev, met_cols):
    capP = vert.shape[0]
    _check("vert", vert, torch.float32, (capP, 3))
    _check("met", met, torch.float32, (capP,) + met_cols)
    _check("ev", ev, torch.int32)
    if ev.dim() != 2 or ev.shape[1] != 2:
        raise ValueError("ev must be [n, 2]")
    if not _on_card(vert, met, ev):
        return plain(vert, met, ev)
    n = ev.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=vert.device)
    if n:
        _launch(f"pm_{name}", vert.data_ptr(), met.data_ptr(), ev.data_ptr(),
                out.data_ptr(), capP, n, _stream(vert))
        LAUNCHES[name] += 1
    return out


def edge_lengths_iso(vert, met, ev):
    """[capE] metric length of edges ``ev`` [capE, 2] (ids clipped to
    [0, capP)) under the iso size map ``met`` [capP]."""
    return _edge_lengths("edge_lengths_iso", edge_lengths_iso_plain, vert,
                         met, ev, ())


def edge_lengths_ani(vert, met6, ev):
    """[capE] metric length of edges ``ev`` [capE, 2] (ids clipped to
    [0, capP)) under the packed tensor metric ``met6`` [capP, 6].  One
    launch a call, any alignment of ``ev`` and ``met6`` (a view at an
    element offset takes scalar loads); a NaN quadratic form gives NaN, as
    in the plain version."""
    return _edge_lengths("edge_lengths_ani", edge_lengths_ani_plain, vert,
                         met6, ev, (6,))


# ---------------------------------------------------------------------------
# K3 / K4: masked negated score + exact candidate count
# ---------------------------------------------------------------------------
def score_count_plain(mask, val):
    return (torch.where(mask, -val, torch.full_like(val, -torch.inf)),
            mask.sum(dtype=torch.int32))


def score3_count_plain(mask, v0, v1, v2):
    return score_count_plain(mask, torch.minimum(v0, torch.minimum(v1, v2)))


def _score_args(mask, vals):
    n = mask.shape[0]
    _check("mask", mask, torch.bool, (n,))
    for i, v in enumerate(vals):
        _check(f"v{i}", v, torch.float32, (n,))
    return n


def _score(name, plain, mask, vals):
    n = _score_args(mask, vals)
    if not _on_card(mask, *vals):
        return plain(mask, *vals)
    dev = mask.device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    s = _stream(out)
    # one 64-bit word, the blocks done and their count, left at 0
    ctrl = _scratch(name, dev, s, {"ctrl": (
        _tile("pm_score_scratch_ints"), torch.int32, True)})["ctrl"]
    _launch(f"pm_{name}", mask.data_ptr(), *(v.data_ptr() for v in vals),
            out.data_ptr(), cnt.data_ptr(), ctrl.data_ptr(), n, s)
    LAUNCHES[name] += 1
    return out, cnt


def score_count(mask, val):
    """(where(mask, -val, -inf) [N] float32, sum(mask) 0-d int32).  One
    launch a call, any alignment of ``mask`` and ``val``."""
    return _score("score_count", score_count_plain, mask, (val,))


def score3_count(mask, v0, v1, v2):
    """``score_count`` of ``min(v0, min(v1, v2))`` (NaN propagating)."""
    return _score("score3_count", score3_count_plain, mask, (v0, v1, v2))


# ---------------------------------------------------------------------------
# K6: tet quality with the corner gathers folded in
# ---------------------------------------------------------------------------
def tet_quality_plain(vert, tet, tmask, met6=None):
    capP = vert.shape[0]
    tv = tet.clamp(0, capP - 1).long()
    p = vert[tv]
    if met6 is None:
        q = quality_from_points(p)
    else:
        q = quality_from_points(p, met6[tv].mean(dim=1)[:, None, :])
    return torch.where(tmask, q, torch.zeros_like(q))


def tet_quality(vert, tet, tmask, met6=None):
    """[capT] quality of every tet slot, 0 where ``tmask`` is False;
    ``met6`` [capP, 6] selects the aniso mode (tet-mean metric).  One
    launch a call.  On the card ``tet`` must start 16-byte aligned (the
    kernel loads a row's four ids at once) and ``met6`` 8-byte aligned."""
    capP, capT = vert.shape[0], tet.shape[0]
    _check("vert", vert, torch.float32, (capP, 3))
    _check("tet", tet, torch.int32, (capT, 4))
    _check("tmask", tmask, torch.bool, (capT,))
    ts = (vert, tet, tmask)
    if met6 is not None:
        _check("met6", met6, torch.float32, (capP, 6))
        ts = ts + (met6,)
    if not _on_card(*ts):
        return tet_quality_plain(vert, tet, tmask, met6)
    if tet.data_ptr() % 16 or (met6 is not None and met6.data_ptr() % 8):
        raise ValueError("tet_quality: tet must start 16-byte aligned and "
                         "met6 8-byte aligned")
    out = torch.empty(capT, dtype=torch.float32, device=vert.device)
    if capT:
        _launch("pm_tet_quality", vert.data_ptr(), tet.data_ptr(),
                tmask.data_ptr(),
                None if met6 is None else met6.data_ptr(),
                out.data_ptr(), capP, capT, _stream(vert))
        LAUNCHES["tet_quality"] += 1
    return out


_TILES: dict = {}


def _tile(sym) -> int:
    """A size the CUDA source defines (a tile's elements, a scratch's
    ints), read once."""
    t = _TILES.get(sym)
    if t is None:
        t = _TILES[sym] = int(_fn(sym)())
    return t


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# (kernel, device, stream) -> {name: tensor}: the small state K3, K4, K5
# and K7 keep on the card between calls (count words, tile counters,
# epochs, status words), one set a stream, so calls on different streams
# never share it
_SCRATCH: dict = {}


def _scratch(kernel, dev, stream, sizes):
    """Scratch of ``kernel`` on ``dev`` for calls on ``stream``: ``sizes``
    maps a name to (elements, dtype, zeroed).  A buffer is made at first
    use and remade larger when a call needs more; a zeroed one starts as
    zeros, and the kernels leave it in the state they expect to find it
    in."""
    bufs = _SCRATCH.setdefault((kernel, dev, stream), {})
    for name, (numel, dtype, zeroed) in sizes.items():
        b = bufs.get(name)
        if b is None or b.numel() < numel:
            make = torch.zeros if zeroed else torch.empty
            bufs[name] = make(numel, dtype=dtype, device=dev)
    return bufs


# ---------------------------------------------------------------------------
# K5: inclusive int32 prefix sum
# ---------------------------------------------------------------------------
def merge_prefix_plain(x):
    return torch.cumsum(x, 0, dtype=torch.int32)


def merge_prefix(x):
    """Inclusive prefix sum of an int32 vector, wrapping like int32
    ``cumsum``: [n] -> [n] int32."""
    _check("x", x, torch.int32)
    if x.dim() != 1:
        raise ValueError("x must be 1-D")
    if not _on_card(x):
        return merge_prefix_plain(x)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n:
        # epoch << 32 | tile counter, and one status word a tile, never
        # cleared after the first zeroing: the epoch tags each call's words
        s = _stream(x)
        sc = _scratch("merge_prefix", x.device, s, {
            "ctrl": (1, torch.int64, True),
            "status": (_cdiv(n, _tile("pm_merge_prefix_tile")), torch.int64,
                       True)})
        st = sc["status"]
        _launch("pm_merge_prefix", x.data_ptr(), out.data_ptr(), n,
                sc["ctrl"].data_ptr(), st.data_ptr(), st.numel(), s)
        LAUNCHES["merge_prefix"] += 1
    return out


# ---------------------------------------------------------------------------
# K7: stable LSD radix sort permutation of 1-3 int32 words
# ---------------------------------------------------------------------------
_RADIX_MAX_PASSES = 12


def _radix_args(words, nbits):
    words = tuple(words)
    if not words:
        raise ValueError("radix_sort needs at least one key word")
    n = words[0].shape[0]
    for j, w in enumerate(words):
        _check(f"words[{j}]", w, torch.int32, (n,))
    nbits = (32,) * len(words) if nbits is None else tuple(map(int, nbits))
    if len(nbits) != len(words) or not all(1 <= b <= 32 for b in nbits):
        raise ValueError(f"nbits {nbits} must give 1..32 bits per word")
    return words, nbits, n


def _radix_passes(nbits) -> int:
    """8-bit digit passes of a sort with these per-word bit counts."""
    return sum(len(range(0, b, 8)) for b in nbits)


def radix_sort_plain(words, nbits=None):
    words, nbits, n = _radix_args(words, nbits)
    order = torch.arange(n, device=words[0].device)
    for w, bits in list(zip(words, nbits))[::-1]:     # minor word first
        k = w.long() & 0xFFFFFFFF                       # uint32 order
        if bits < 31:
            k = torch.where(w == INT32_MAX, (1 << bits) - 1, k)
        order = order[torch.sort(k[order], stable=True).indices]
    return order.to(torch.int32)


def radix_sort(words, nbits=None):
    """Stable sort permutation [n] int32 of the key whose major word is
    ``words[0]``; each word orders as uint32.  ``nbits[j]`` bounds word j
    below 2**nbits[j]; a word with nbits < 31 has its INT32_MAX
    tombstones remapped to 2**nbits - 1, as ``radix_sort_pallas`` does."""
    words, nbits, n = _radix_args(words, nbits)
    if not _on_card(*words):
        return radix_sort_plain(words, nbits)
    if len(words) > 3:
        raise ValueError("the CUDA radix sort takes 1-3 key words")
    if n >= 2 ** 31:
        raise ValueError("radix_sort takes fewer than 2**31 rows")
    dev = words[0].device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    tiles = _cdiv(n, _tile("pm_radix_tile"))
    s = _stream(out)
    # kept: ctrl {tile counter, blocks done} and hist, left zeroed by every
    # call, and the digits' bases
    sc = _scratch("radix_sort", dev, s, {
        "ctrl": (2, torch.int32, True),
        "hist": (_RADIX_MAX_PASSES * 256, torch.int32, True),
        "base": (_RADIX_MAX_PASSES * 256, torch.int32, False)})
    # per call, in one allocation: two sets of int64 status words a (tile,
    # digit), cleared by the kernels themselves; the pass order between
    # passes; and, when a word takes several passes, two buffers that carry
    # its key in sorted order from one of its passes to the next instead of
    # gathering it each pass (faster on the card: `tools/k7_variants.py`)
    nst = 4 * tiles * 256                    # int32 slots of the status words
    carry = max(nbits) > 8
    work = torch.empty(nst + (3 if carry else 1) * n, dtype=torch.int32,
                       device=dev)
    p = work.data_ptr()
    tmp = p + 4 * nst
    ptrs = [w.data_ptr() for w in words] + [None] * (3 - len(words))
    bits = list(nbits) + [0] * (3 - len(nbits))
    _launch("pm_radix_sort", *ptrs, len(words), *bits, out.data_ptr(), tmp,
            tmp + 4 * n if carry else None, tmp + 8 * n if carry else None,
            sc["ctrl"].data_ptr(), sc["hist"].data_ptr(),
            sc["base"].data_ptr(), p, tiles, n, s)
    LAUNCHES["radix_sort"] += 1
    return out


def f32_sort_u32(x):
    """int32 bit pattern of the uint32 image of float32 ``x`` whose
    unsigned order is the stable float sort's order: -0.0 == +0.0, all
    NaNs equal and after +inf (``pallas_kernels.f32_sort_u32``)."""
    x = torch.where(x == 0.0, torch.zeros_like(x), x.to(torch.float32))
    b = x.view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(b >> 31 != 0, b ^ 0xFFFFFFFF, b | 0x80000000)
    u = torch.where(torch.isnan(x), 0xFFFFFFFF, u)
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


# ---------------------------------------------------------------------------
# K8: segment-start flags over sorted columns, optionally gathered first
# ---------------------------------------------------------------------------
def _segment_args(words, order):
    words = tuple(words)
    if not words:
        raise ValueError("segment_flags needs at least one column")
    n = words[0].shape[0]
    for j, w in enumerate(words):
        _check(f"words[{j}]", w, torch.int32, (n,))
    if order is not None:
        _check("order", order, torch.int32, (n,))
    return words, n


def segment_flags_plain(words, order=None):
    words, n = _segment_args(words, order)
    if order is not None:
        o = order.long()
        words = tuple(w[o] for w in words)
    first = torch.ones(n, dtype=torch.bool, device=words[0].device)
    if n > 1:
        neq = words[0][1:] != words[0][:-1]
        for w in words[1:]:
            neq = neq | (w[1:] != w[:-1])
        first[1:] = neq
    return first if order is None else (words, first)


def segment_flags(words, order=None):
    """[n] bool: True at row 0 and wherever any column differs from the
    row before (the heads of equal-key runs of sorted columns).

    With ``order`` (an int32 [n] permutation, as ``radix_sort`` returns
    it) the columns are gathered first, ``words[j][order]``, in the same
    launch: returns (the gathered columns, their flags).  One launch a
    call in either mode."""
    words, n = _segment_args(words, order)
    ts = words if order is None else words + (order,)
    if not _on_card(*ts):
        return segment_flags_plain(words, order)
    if len(words) > 3:
        raise ValueError("the CUDA segment flags take 1-3 columns")
    if order is not None and n >= 2 ** 31:
        raise ValueError("gathered segment_flags takes fewer than 2**31 rows")
    dev = words[0].device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    srt = (None if order is None else
           tuple(torch.empty(n, dtype=torch.int32, device=dev)
                 for _ in words))
    if n:
        pad = [None] * (3 - len(words))
        ptrs = [w.data_ptr() for w in words] + pad
        sptrs = ([None] * 3 if srt is None
                 else [w.data_ptr() for w in srt] + pad)
        _launch("pm_segment_flags", *ptrs, len(words),
                None if order is None else order.data_ptr(), *sptrs,
                out.data_ptr(), n, _stream(out))
        LAUNCHES["segment_flags"] += 1
    return out if order is None else (srt, out)
