"""The port's sort engine (K7 radix sort, K5 prefix scan, K8 segment
flags), the swap23 face-sort pairing and the fixed-order float sum, held
against the JAX package.

The JAX side runs the Pallas kernels with ``interpret=True`` as
tests/test_pallas_sort.py does, and its sort sites with the engine forced
(``PARMMG_TPU_PALLAS=1 PARMMG_PALLAS_SORT=1``); the port side runs the
wrappers, which take their plain PyTorch versions for CPU tensors.  Every
comparison is bit-exact: permutations, flags and prefix sums are integers,
and a stable radix sort equals a chain of stable sorts exactly.  The one
float comparison is the fixed-order sum against ``scatter_reduce``:
equal on integer-valued floats (exact in any order), rtol 1e-6 on random
floats (another summation order), and equal bits from call to call.
"""
import filecmp

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.ops import pallas_kernels as pk
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.core.constants import MG_BDY
from parmmg_tpu_torch.ops import kernels as K
from parmmg_tpu_torch.utils.fixtures import cube_mesh
from torch_parity import jax_ledger_listener_compat  # noqa: F401

I32_MAX = 2147483647


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _radix_pair(words, nbits=None):
    ref = np.asarray(pk.radix_sort_pallas(
        tuple(jnp.asarray(w) for w in words), nbits=nbits, interpret=True))
    got = K.radix_sort(tuple(_t(w) for w in words), nbits)
    assert got.dtype == torch.int32
    return got.numpy(), ref


# ---- K7 ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 1025, 3000])
def test_radix_one_word(n):
    k = _rng(n).integers(0, max(2, n // 8), n).astype(np.int32)
    got, ref = _radix_pair((k,))
    assert np.array_equal(got, ref)
    assert np.array_equal(got, np.argsort(k, kind="stable"))


@pytest.mark.parametrize("nw", [2, 3])
def test_radix_multi_word(nw):
    rng = _rng(20 + nw)
    words = [rng.integers(0, 5, 1025).astype(np.int32) for _ in range(nw)]
    got, ref = _radix_pair(words)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, np.lexsort(words[::-1]))


def test_radix_int32max_tombstones():
    rng = _rng(3)
    k = rng.integers(0, 9, 1025).astype(np.int32)
    k[rng.random(1025) < 0.4] = I32_MAX
    got, ref = _radix_pair((k,))
    assert np.array_equal(got, ref)


def test_radix_nbits16_tombstones():
    # the packed face-sort shape: a 16-bit major word with tombstones
    rng = _rng(4)
    s = rng.integers(0, 46340, 3000).astype(np.int32)
    s[rng.random(3000) < 0.3] = I32_MAX
    w = rng.integers(0, 1 << 20, 3000).astype(np.int32)
    got, ref = _radix_pair((s, w), nbits=(16, 32))
    assert np.array_equal(got, ref)


def test_radix_all_equal_keys():
    got, ref = _radix_pair((np.full(1025, 7, np.int32),))
    assert np.array_equal(got, ref)
    assert np.array_equal(got, np.arange(1025))


def test_radix_float_image_matches_argsort():
    rng = _rng(5)
    n = 1025
    x = rng.normal(size=n).astype(np.float32)
    for val, p in ((0.0, 0.15), (-0.0, 0.15), (np.inf, 0.1),
                   (-np.inf, 0.1), (np.nan, 0.1)):
        x[rng.random(n) < p] = val
    u = K.f32_sort_u32(_t(x))
    assert np.array_equal(
        u.numpy(), np.asarray(pk.f32_sort_u32(jnp.asarray(x)))
        .astype(np.int64).astype(np.uint32).view(np.int32))
    got = K.radix_sort((u,)).numpy()
    assert np.array_equal(got, np.asarray(jnp.argsort(jnp.asarray(x))))
    ref = np.asarray(pk.radix_sort_pallas(
        (pk.f32_sort_u32(jnp.asarray(x)).astype(jnp.int32),),
        interpret=True))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("n", [5119, 5121, 2 * 5120 + 3])
def test_radix_full_range_uint32_order(n):
    # every 32-bit pattern may occur: negatives sort after the
    # non-negatives (uint32 order), INT32_MAX is not a tombstone at 32 bits
    rng = _rng(40 + n)
    k = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    k[rng.random(n) < 0.1] = -1
    k[rng.random(n) < 0.1] = I32_MAX
    k[:4] = (-2 ** 31, 0, -1, I32_MAX)
    got, ref = _radix_pair((k,))
    assert np.array_equal(got, ref)
    assert np.array_equal(got, np.argsort(k.view(np.uint32), kind="stable"))


def test_radix_three_words_8_16_32():
    rng = _rng(44)
    n = 5121
    a = rng.integers(0, 255, n).astype(np.int32)
    b = rng.integers(0, 1 << 16, n).astype(np.int32)
    c = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    a[rng.random(n) < 0.2] = I32_MAX
    b[rng.random(n) < 0.2] = I32_MAX
    got, ref = _radix_pair((a, b, c), nbits=(8, 16, 32))
    assert np.array_equal(got, ref)
    ra = np.where(a == I32_MAX, 255, a)
    rb = np.where(b == I32_MAX, (1 << 16) - 1, b)
    assert np.array_equal(got, np.lexsort((c.view(np.uint32), rb, ra)))


# ---- K5 / K8 ----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 1023, 1025, 3000])
def test_merge_prefix_matches_pallas(n):
    x = _rng(n).integers(-50, 1000, n).astype(np.int32)
    got = K.merge_prefix(_t(x))
    assert got.dtype == torch.int32
    ref = np.asarray(pk.merge_prefix_pallas(jnp.asarray(x), interpret=True))
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n", [4095, 4096, 4097, 3 * 4096 + 5])
def test_merge_prefix_wrapping_sums(n):
    # values near +-2**31 whose running sum wraps, over several of the
    # card scan's 4,096-element tiles and a ragged tail
    rng = _rng(60 + n)
    x = rng.integers(2 ** 31 - 64, 2 ** 31, n, dtype=np.int64)
    x = np.where(rng.random(n) < 0.5, x, -x).astype(np.int32)
    got = K.merge_prefix(_t(x))
    ref = np.asarray(pk.merge_prefix_pallas(jnp.asarray(x), interpret=True))
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), np.cumsum(x, dtype=np.int32))
    assert np.abs(np.cumsum(x.astype(np.int64))).max() >= 2 ** 31


# case -> (gathered, number of words, n, keys): "random" keys in 0..5,
# "equal" all 3, "tombstones" random with ~1/4 INT32_MAX rows.  n = 2051
# crosses the Pallas 1024-element seam; 1029 leaves a ragged tail past the
# card kernel's 8-row threads; 1 is a lone row.
_SEG_CASES = {
    "one_word": (False, 1, 2051, "random"),
    "two_words": (False, 2, 2051, "random"),
    "all_equal": (False, 1, 2051, "equal"),
    "three_words": (False, 3, 2051, "random"),
    "tombstones_tail": (False, 2, 1029, "tombstones"),
    "one_row": (False, 1, 1, "random"),
    "gathered_one_word": (True, 1, 2051, "random"),
    "gathered_two_words": (True, 2, 2051, "random"),
    "gathered_three_words": (True, 3, 2051, "random"),
    "gathered_one_row": (True, 1, 1, "random"),
    "gathered_tail": (True, 2, 1029, "random"),
    "gathered_all_equal": (True, 1, 2051, "equal"),
    "gathered_tombstones": (True, 3, 2051, "tombstones"),
}


@pytest.mark.parametrize("case", list(_SEG_CASES))
def test_segment_flags_matches_pallas(case):
    """K8 against ``segment_flags_pallas``: sorted mode on sorted columns;
    gathered mode on unsorted columns and their stable sort permutation,
    against the Pallas kernel on the numpy-gathered columns."""
    gathered, nw, n, kind = _SEG_CASES[case]
    rng = _rng(7)
    if kind == "equal":
        words = [np.full(n, 3, np.int32) for _ in range(nw)]
    else:
        words = [rng.integers(0, 6, n).astype(np.int32) for _ in range(nw)]
        if kind == "tombstones":
            for w in words:
                w[rng.random(n) < 0.25] = I32_MAX
    o = np.lexsort(words[::-1]).astype(np.int32)     # stable, major first
    srt = [w[o] for w in words]
    ref = np.asarray(pk.segment_flags_pallas(
        tuple(jnp.asarray(w) for w in srt), interpret=True))
    if gathered:
        cols, got = K.segment_flags(tuple(_t(w) for w in words),
                                    order=_t(o))
        assert len(cols) == nw
        for c, w in zip(cols, srt):
            assert c.dtype == torch.int32
            assert np.array_equal(c.numpy(), w)
    else:
        got = K.segment_flags(tuple(_t(w) for w in srt))
    assert np.array_equal(got.numpy(), ref)


def test_cpu_sort_wrappers_count_no_launch():
    K.reset_launches()
    k = torch.randint(0, 9, (100,), dtype=torch.int32)
    K.radix_sort((k, k))
    K.merge_prefix(k)
    K.segment_flags((k,))
    assert all(v == 0 for v in K.LAUNCHES.values())
    with pytest.raises(TypeError):
        K.radix_sort((k.long(),))
    with pytest.raises(ValueError):
        K.radix_sort((k,), nbits=(16, 32))
    # the gathered mode's permutation: int32, contiguous, one a row
    o = torch.arange(100, dtype=torch.int32)
    K.segment_flags((k,), order=o)
    assert all(v == 0 for v in K.LAUNCHES.values())
    with pytest.raises(TypeError):
        K.segment_flags((k,), order=o.long())
    with pytest.raises(ValueError):
        K.segment_flags((k,), order=o[:99])
    with pytest.raises(ValueError):
        K.segment_flags((k,), order=torch.arange(200, dtype=torch.int32)[::2])


# ---- sort sites against the JAX package with the engine forced --------------

@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv("PARMMG_TPU_PALLAS", "1")
    monkeypatch.setenv("PARMMG_PALLAS_SORT", "1")


def _cube_pair(n, capP=None):
    """The same analysed cube on both sides (port mesh, JAX mesh)."""
    from parmmg_tpu.core import mesh as jmesh
    from parmmg_tpu_torch.ops.analysis import analyze_mesh
    v, t = cube_mesh(n)
    m = analyze_mesh(tmesh.make_mesh(v, t, capP=capP or 4 * len(v),
                                     capT=4 * len(t))).mesh
    f = tmesh.mesh_to_numpy(m)
    return m, jmesh.Mesh(**{k: jnp.asarray(a) for k, a in f.items()})


def _same(got, ref):
    for g, r in zip(got, ref):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        if r.dtype == np.uint32:
            r = r.view(np.int32)
        assert np.array_equal(g, r)


def test_sort_pairs_site(forced):
    from parmmg_tpu.ops import edges as JE
    from parmmg_tpu_torch.ops import edges as TE
    rng = _rng(8)
    n = 700
    a = rng.integers(0, 40, n).astype(np.int32)
    b = rng.integers(0, 40, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    for cap in (40, TE.PACK_LIMIT + 1):      # packed and two-word branch
        _same(TE.sort_pairs(_t(a), _t(b), _t(valid), cap),
              JE.sort_pairs(jnp.asarray(a), jnp.asarray(b),
                            jnp.asarray(valid), cap))


def test_unique_edges_sites(forced):
    from parmmg_tpu.ops import edges as JE
    from parmmg_tpu_torch.ops import edges as TE
    tm, jm = _cube_pair(2)
    _same(TE.unique_edges(tm), jax.jit(JE.unique_edges)(jm))
    # the packed sort's (order, keys) fed back through the epilogue
    ev = tmesh.tet_edge_vertices(tm.tet).reshape(-1, 2)
    order, ka, kb, _ = TE.sort_pairs(ev.min(1).values, ev.max(1).values,
                                     tm.tmask.repeat_interleave(6), tm.capP)
    ks = torch.where(ka == I32_MAX, ka, ka * tm.capP + kb)
    _same(TE.unique_edges_from_sorted(tm, order, ks, shell_slots=3),
          JE.unique_edges_from_sorted(jm, jnp.asarray(order.numpy()),
                                      jnp.asarray(ks.numpy()),
                                      shell_slots=3))


@pytest.mark.parametrize("packed", [True, False])
def test_face_sort_site(forced, packed):
    from parmmg_tpu.ops import adjacency as JA
    from parmmg_tpu_torch.ops import adjacency as TA
    from parmmg_tpu_torch.ops.edges import PACK_LIMIT
    # capP past PACK_LIMIT takes the three-word branch
    tm, jm = _cube_pair(2, capP=None if packed else PACK_LIMIT + 1)
    trec, jrec = TA.face_sort(tm), jax.jit(JA.face_sort)(jm)
    _same(trec, jrec)
    fields = tmesh.mesh_to_numpy(tm)
    _same(tmesh.mesh_to_numpy(
        TA.adjacency_from_records(tm, *trec[:4])).values(),
        [getattr(JA.adjacency_from_records(jm, *jrec[:4]), f)
         for f in fields])


def test_unique_priority_site(forced):
    from parmmg_tpu.ops.edges import unique_priority as j_up
    from parmmg_tpu_torch.ops.edges import unique_priority
    rng = _rng(9)
    n = 600
    score = (np.round(rng.random(n) * 8) / 8).astype(np.float32)
    mask = rng.random(n) < 0.7
    got = unique_priority(_t(score), _t(mask))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(j_up(jnp.asarray(score),
                                          jnp.asarray(mask))))


# ---- swap23 off the face sort ----------------------------------------------

@pytest.fixture(scope="module")
def swapped():
    """A seeded cube(3) state after the edge-swap wave (port and JAX
    sides equal): 3 port cycles at h=0.3, interior vertices jittered by
    N(0, 0.06), then ``swap_edges_wave``."""
    from parmmg_tpu_torch.ops import adapt as TAd, analysis as TN
    from parmmg_tpu_torch.ops import swap as TW
    v, t = cube_mesh(3)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=8 * len(v),
                                        capT=8 * len(t))).mesh
    met = torch.full((m.capP,), 0.3)
    for c in range(3):
        m, met, _ = TAd.adapt_cycle_impl(m, met, c, do_swap=False,
                                         hausd=0.01)
    rng = np.random.default_rng(5)
    inner = (m.vmask & ((m.vtag & MG_BDY) == 0)).numpy()
    vert = m.vert.numpy().copy()
    vert[inner] += (rng.standard_normal((inner.sum(), 3))
                    * 0.06).astype(np.float32)
    m = tmesh.replace(m, vert=torch.from_numpy(vert))
    return TW.swap_edges_wave(m, met, hausd=0.01).mesh, met


def _fields(m, skip=()):
    return {k: v for k, v in tmesh.mesh_to_numpy(m).items() if k not in skip}


def test_swap23_facesort_matches_jax(swapped):
    import functools
    from parmmg_tpu.core import mesh as jmesh
    from parmmg_tpu.ops import swap as JW
    from parmmg_tpu_torch.ops import swap as TW
    tm, met = swapped
    jm = jmesh.Mesh(**{k: jnp.asarray(a)
                       for k, a in tmesh.mesh_to_numpy(tm).items()})
    j23 = jax.jit(functools.partial(JW.swap23_wave, facesort=True))(
        jm, jnp.asarray(met.numpy()))
    t23 = TW.swap23_wave(tm, met, facesort=True)
    assert int(t23.nswap) == int(j23.nswap) > 0
    assert bool(t23.deferred) == bool(j23.deferred)
    got = _fields(t23.mesh)
    for f in jmesh.MESH_FIELDS:
        a = np.asarray(getattr(j23.mesh, f))
        assert np.array_equal(got[f], a.view(np.int32) if a.dtype ==
                              np.uint32 else a), f


def test_swap23_facesort_matches_adja_pairing(swapped):
    from parmmg_tpu_torch.ops import adjacency as TA, swap as TW
    tm, met = swapped
    fs = TW.swap23_wave(tm, met, facesort=True)
    ad = TW.swap23_wave(TA.build_adjacency(tm), met)
    assert int(fs.nswap) == int(ad.nswap) > 0
    # the face-sort path leaves adja stale; everything else is equal,
    # and so is the adjacency rebuilt at the cycle's end
    assert all(np.array_equal(a, b) for a, b in zip(
        _fields(fs.mesh, ("adja",)).values(),
        _fields(ad.mesh, ("adja",)).values()))
    assert all(np.array_equal(a, b) for a, b in zip(
        _fields(TA.build_adjacency(fs.mesh)).values(),
        _fields(TA.build_adjacency(ad.mesh)).values()))


def test_cli_facesort_on_off_byte_identical(tmp_path, monkeypatch):
    from parmmg_tpu_torch import cli
    from parmmg_tpu_torch.io.medit import MeditMesh, write_mesh
    from parmmg_tpu_torch.ops import adapt as TAd, adjacency as TA, swap as TW
    v, t = cube_mesh(3)
    m = MeditMesh()
    m.vert, m.vref = v, np.zeros(len(v), np.int32)
    m.tetra, m.tref = t, np.ones(len(t), np.int32)
    src = str(tmp_path / "cube3.mesh")
    write_mesh(src, m)
    # the cycle pairs swap23 off the face sort; "off" swaps in the pairing
    # off a rebuilt adja, as the JAX package runs it off the TPU
    calls = []

    def adja_pairing(mesh, met, budget_div=8, wwin=None, facesort=False,
                     set_bdy_tags=True):
        calls.append(facesort)
        return TW.swap23_wave(TA.build_adjacency(mesh, set_bdy_tags), met,
                              budget_div=budget_div, wwin=wwin)
    outs = []
    for on in (True, False):
        if not on:
            monkeypatch.setattr(TAd, "swap23_wave", adja_pairing)
        out = str(tmp_path / f"facesort_{on}.mesh")
        assert cli.main(["-in", src, "-hsiz", "0.3", "-niter", "1", "-v",
                         "-1", "-out", out, "-device", "cpu"]) == 0
        outs.append(out)
    assert calls and all(calls)
    assert filecmp.cmp(*outs, shallow=False)


# ---- the fixed-order float sum (deterministic sums on the card) ------------

def _sum_inputs(seed, integer):
    rng = _rng(seed)
    nd, n = 200, 3000
    idx = rng.integers(0, nd, n)
    idx[: n // 3] = nd - 1                   # one heavy row, as a sentinel
    shape = (n, 3)
    if integer:
        vals = rng.integers(-8, 9, shape).astype(np.float32)
        dst = rng.integers(-8, 9, (nd, 3)).astype(np.float32)
    else:
        vals = rng.random(shape).astype(np.float32)
        dst = rng.random((nd, 3)).astype(np.float32)
    return _t(dst), _t(idx), _t(vals)


def test_fixed_order_sum_exact_on_integer_values():
    from parmmg_tpu_torch.ops.primitives import fixed_order_sum
    dst, idx, vals = _sum_inputs(10, True)
    ref = dst.scatter_reduce(0, idx[:, None].expand_as(vals), vals, "sum")
    assert torch.equal(fixed_order_sum(dst, idx, vals), ref)
    assert torch.equal(fixed_order_sum(dst[:, 0].contiguous(), idx,
                                       vals[:, 0]), ref[:, 0])


def test_fixed_order_sum_close_on_random_floats():
    from parmmg_tpu_torch.ops.primitives import fixed_order_sum
    dst, idx, vals = _sum_inputs(11, False)
    ref = dst.scatter_reduce(0, idx[:, None].expand_as(vals), vals, "sum")
    torch.testing.assert_close(fixed_order_sum(dst, idx, vals), ref,
                               rtol=1e-6, atol=0)


def test_fixed_order_sum_same_bits_every_call():
    from parmmg_tpu_torch.ops.primitives import fixed_order_sum
    dst, idx, vals = _sum_inputs(12, False)
    a = fixed_order_sum(dst, idx, vals)
    b = fixed_order_sum(dst, idx, vals)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
