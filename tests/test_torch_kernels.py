"""Port kernels (K1 edge length, K3/K4 scoring, K6 quality) against the
JAX package's Pallas kernels, run in interpret mode as tests/test_pallas.py
and tests/test_hotloop.py run them (K2 in tests/test_torch_aniso.py).  On
the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves, K2 included (rtol 3e-5 / atol 3e-6), are held against the same
plain versions by the ``cuda``-marked test (and by chip_smoke.py).

Tolerances: K1 rtol 2e-5 / atol 2e-6; K6 iso rtol 3e-5 / atol 3e-6, aniso
rtol 1e-4 / atol 1e-5 (float32 formulas evaluated in another order);
K3/K4 scores bit-identical and counts exact (a sign flip, a select and
an integer sum)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.ops import pallas_kernels as pk
from parmmg_tpu_torch.ops import kernels as K
from torch_parity import jax_ledger_listener_compat  # noqa: F401


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("n", [1, 130, 3000])
def test_edge_lengths_iso_matches_pallas(n):
    rng = _rng(n)
    P = 500
    vert = rng.random((P, 3)).astype(np.float32)
    met = (0.02 + rng.random(P)).astype(np.float32)
    met[:50] = met[50:100]               # some equal-size edges (close)
    ev = rng.integers(-3, P + 3, (n, 2)).astype(np.int32)  # clipped ids
    i0, i1 = np.clip(ev[:, 0], 0, P - 1), np.clip(ev[:, 1], 0, P - 1)
    ref = np.asarray(pk.edge_length_iso_pallas(
        jnp.asarray(vert[i0]), jnp.asarray(vert[i1]), jnp.asarray(met[i0]),
        jnp.asarray(met[i1]), interpret=True))
    got = K.edge_lengths_iso(torch.from_numpy(vert), torch.from_numpy(met),
                             torch.from_numpy(ev)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("aniso", [False, True])
def test_tet_quality_matches_pallas(aniso):
    rng = _rng(7 + aniso)
    P, T = 300, 2000
    vert = rng.random((P, 3)).astype(np.float32)
    tet = rng.integers(0, P, (T, 4)).astype(np.int32)
    tmask = rng.random(T) > 0.2
    met6 = None
    if aniso:
        w = (1.0 + 4.0 * rng.random(P)).astype(np.float32)
        met6 = np.stack([w, 0.1 * w, -0.05 * w, 1.5 * w, 0.02 * w, 0.8 * w],
                        1).astype(np.float32)
    p = jnp.asarray(vert[tet])
    m6bar = None if met6 is None else jnp.asarray(met6[tet].mean(axis=1))
    ref = np.asarray(pk.quality_pallas(p, m6bar, interpret=True))
    ref = np.where(tmask, ref, 0.0)
    got = K.tet_quality(torch.from_numpy(vert), torch.from_numpy(tet),
                        torch.from_numpy(tmask),
                        None if met6 is None else torch.from_numpy(met6))
    tol = dict(rtol=1e-4, atol=1e-5) if aniso else dict(rtol=3e-5,
                                                         atol=3e-6)
    np.testing.assert_allclose(got.numpy(), ref, **tol)


@pytest.mark.parametrize("aniso", [False, True])
def test_tet_quality_edge_cases_match_pallas(aniso):
    """K6 on dead, inverted and degenerate tets and on ids out of range
    (clamped to [0, capP)), against the Pallas kernel on the clamped
    corners.  A tet whose four corners coincide has quality 0 in the port;
    the Pallas kernel on the CPU gives NaN there (XLA flushes rap^1.5 =
    1e-45, a denormal, to 0 and divides 0 by it), so that one row is held
    to 0 instead."""
    rng = _rng(21 + aniso)
    P = 64
    vert = rng.random((P, 3)).astype(np.float32)
    vert[1] = vert[0]                        # a coincident pair
    vert[2:5] = vert[5] + np.float32(0.5) * (vert[6] - vert[5]) * (
        np.arange(3, dtype=np.float32)[:, None])   # 2..6 on one line
    vert[10:14] = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]]  # coplanar
    vert[20:24] = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]  # vol > 0
    good = [20, 21, 22, 23]
    tet = np.array([
        good,                  # live
        good,                  # dead
        [20, 22, 21, 23],      # inverted
        [10, 11, 12, 13],      # flat
        [0, 1, 7, 8],          # collapsed edge
        [2, 3, 4, 9],          # three corners on a line (to rounding)
        [-5, 3, P + 7, 2 ** 31 - 1],    # ids out of range, clamped
        [-1, -1, -1, -1],      # all clamped to 0: four equal corners
        [30, 31, 32, 33],
    ], np.int32)
    tet = np.concatenate([tet, rng.integers(0, P, (40, 4), dtype=np.int32)])
    tmask = np.ones(len(tet), bool)
    tmask[1] = False
    tmask[-7:-3] = False
    met6 = None
    if aniso:
        w = (1.0 + 4.0 * rng.random(P)).astype(np.float32)
        met6 = np.stack([w, 0.1 * w, -0.05 * w, 1.5 * w, 0.02 * w, 0.8 * w],
                        1).astype(np.float32)
    tc = np.clip(tet, 0, P - 1)
    m6bar = None if met6 is None else jnp.asarray(met6[tc].mean(axis=1))
    ref = np.asarray(pk.quality_pallas(jnp.asarray(vert[tc]), m6bar,
                                       interpret=True))
    ref = np.where(tmask, ref, 0.0)
    got = K.tet_quality(torch.from_numpy(vert), torch.from_numpy(tet),
                        torch.from_numpy(tmask),
                        None if met6 is None else torch.from_numpy(met6))
    got = got.numpy()
    point = 7
    assert got[point] == 0.0
    assert got[1] == 0.0 and (got[-7:-3] == 0.0).all()
    assert got[2] < 0.0 < got[0]
    assert (got[3:5] == 0.0).all() and abs(got[5]) < 1e-6
    keep = np.arange(len(tet)) != point
    tol = dict(rtol=1e-4, atol=1e-5) if aniso else dict(rtol=3e-5,
                                                         atol=3e-6)
    np.testing.assert_allclose(got[keep], ref[keep], **tol)


def _same_scores(got, ref):
    """Bit for bit, but for the payload of a NaN: a NaN row is NaN in both
    (XLA's canonical NaN; PyTorch's CPU minimum gives all ones)."""
    got, ref = np.asarray(got), np.asarray(ref)
    nan = np.isnan(ref)
    return (got.shape == ref.shape and np.array_equal(np.isnan(got), nan)
            and np.array_equal(got[~nan].view(np.uint32),
                               ref[~nan].view(np.uint32)))


def _specials(rng, n, v0, v2, mask):
    """NaN and +-inf in v0 and v2, at selected and unselected rows."""
    for v in (v0, v2):
        for x in (np.nan, np.inf, -np.inf):
            for want in (True, False):
                rows = np.flatnonzero(mask == want)
                if rows.size:
                    v[rng.choice(rows, min(2, rows.size),
                                 replace=False)] = x


@pytest.mark.parametrize("n", [1, 15, 17, 127, 1000, 4099])
def test_score_kernels_bit_identical(n):
    """K3 / K4 against the Pallas kernels: a random, an all-false and an
    all-true mask, each also with NaN and +-inf in v0 and v2 at selected
    and unselected rows, and a mask viewed at offset 1 of a longer
    tensor."""
    rng = _rng(n + 11)
    v0, v1, v2 = (rng.random(n).astype(np.float32) for _ in range(3))
    v1[::7] = np.inf
    longer = torch.from_numpy(rng.random(n + 1) > 0.5)
    at1 = longer[1:]                     # a contiguous view at offset 1
    assert at1.is_contiguous() and at1.storage_offset() == 1
    masks = [torch.from_numpy(m) for m in (
        rng.random(n) > 0.5, np.zeros(n, bool), np.ones(n, bool))]
    for tmask, special in [(m, s) for m in masks for s in (False, True)] + [
            (at1, True)]:
        mask = tmask.numpy()
        a0, a2 = v0.copy(), v2.copy()
        if special:
            _specials(rng, n, a0, a2, mask)
        neg, cnt = pk.score_count_pallas(jnp.asarray(mask, jnp.float32),
                                         jnp.asarray(a0), interpret=True)
        g, c = K.score_count(tmask, torch.from_numpy(a0))
        assert _same_scores(g.numpy(), neg)
        assert int(c) == int(cnt) == int(mask.sum())
        neg3, cnt3 = pk.score3_count_pallas(
            jnp.asarray(mask, jnp.float32), jnp.asarray(a0),
            jnp.asarray(v1), jnp.asarray(a2), interpret=True)
        g3, c3 = K.score3_count(tmask, *(torch.from_numpy(a)
                                         for a in (a0, v1, a2)))
        assert _same_scores(g3.numpy(), neg3)
        assert int(c3) == int(cnt3) == int(mask.sum())


def test_cpu_wrappers_run_plain_and_count_nothing():
    K.reset_launches()
    vert = torch.rand(10, 3)
    met = torch.rand(10) + 0.1
    ev = torch.randint(0, 10, (20, 2), dtype=torch.int32)
    tet = torch.randint(0, 10, (5, 4), dtype=torch.int32)
    tm = torch.ones(5, dtype=torch.bool)
    mask = torch.rand(20) > 0.5
    assert torch.equal(K.edge_lengths_iso(vert, met, ev),
                       K.edge_lengths_iso_plain(vert, met, ev))
    assert torch.equal(K.tet_quality(vert, tet, tm),
                       K.tet_quality_plain(vert, tet, tm))
    met6 = torch.rand(10, 6)
    assert torch.equal(K.edge_lengths_ani(vert, met6, ev),
                       K.edge_lengths_ani_plain(vert, met6, ev))
    K.score_count(mask, met.repeat(2))
    K.score3_count(mask, met.repeat(2), met.repeat(2), met.repeat(2))
    assert all(v == 0 for v in K.LAUNCHES.values())
    with pytest.raises(TypeError):
        K.edge_lengths_iso(vert.double(), met, ev)
    with pytest.raises(ValueError):
        K.tet_quality(vert, tet[:, :3].contiguous(), tm)
    with pytest.raises(ValueError):
        K.edge_lengths_ani(vert, met6[:, :3].contiguous(), ev)


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from parmmg_tpu_torch import cli
    from parmmg_tpu_torch.api import ParMesh
    with pytest.raises(RuntimeError, match="device"):
        ParMesh()
    mesh = tmp_path / "m.mesh"
    mesh.write_text("MeshVersionFormatted 2\nDimension 3\nVertices\n4\n"
                    "0 0 0 0\n1 0 0 0\n0 1 0 0\n0 0 1 0\nTetrahedra\n1\n"
                    "1 2 3 4 1\nEnd\n")
    with pytest.raises(RuntimeError, match="-device|device"):
        cli.main(["-in", str(mesh), "-noout"])


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    vert = torch.rand(5000, 3, generator=g).to(dev)
    met = (torch.rand(5000, generator=g) + 0.05).to(dev)
    ev = torch.randint(0, 5000, (30000, 2), generator=g,
                       dtype=torch.int32).to(dev)
    tet = torch.randint(0, 5000, (20000, 4), generator=g,
                        dtype=torch.int32).to(dev)
    tm = (torch.rand(20000, generator=g) > 0.1).to(dev)
    torch.testing.assert_close(K.edge_lengths_iso(vert, met, ev),
                               K.edge_lengths_iso_plain(vert, met, ev),
                               rtol=2e-5, atol=2e-6)
    # K1 with NaN and +-inf point and size rows: NaN where the plain
    # version is NaN (every clamp keeps NaN), its value elsewhere
    pts = vert.clone()
    pts[::97, 0] = float("nan")
    pts[1::89, 1] = float("inf")
    pts[2::83, 2] = float("-inf")
    hs = met.clone()
    hs[3::101] = float("nan")
    hs[4::103] = float("inf")
    hs[5::107] = float("-inf")
    for p_, h_ in ((pts, met), (vert, hs), (pts, hs)):
        got = K.edge_lengths_iso(p_, h_, ev)
        ref = K.edge_lengths_iso_plain(p_, h_, ev)
        assert bool(ref.isnan().any())
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-6,
                                   equal_nan=True)
    w = 1.0 / met ** 2
    met6 = torch.stack([w, 0.1 * w, -0.2 * w, 2.0 * w, 0.05 * w, 0.5 * w],
                       dim=1).contiguous()
    torch.testing.assert_close(K.edge_lengths_ani(vert, met6, ev),
                               K.edge_lengths_ani_plain(vert, met6, ev),
                               rtol=3e-5, atol=3e-6)
    torch.testing.assert_close(K.tet_quality(vert, tet, tm),
                               K.tet_quality_plain(vert, tet, tm),
                               rtol=3e-5, atol=3e-6)
    # K2 on rows as the path gives them (sorted runs of equal edges, an
    # INT32_MAX tail), at tails of a thread's and a warp's rows, the ids
    # also viewed at a one-row offset (8-byte aligned), with NaN and +-inf
    # point rows: NaN where the plain version is NaN, every row of a run
    # its head's bits, one launch a call
    rng = np.random.default_rng(3)
    bad = vert.clone()
    bad[::97, 0] = float("nan")
    bad[1::89, 1] = float("inf")
    bad[2::83, 2] = float("-inf")
    for m in (1, 3, 5, 7, 9, 255, 257, 4097, 30001):
        key = np.sort(rng.integers(0, max(m // 5, 1), m + 1))
        rows = np.stack([key * 7919 % 5000, (key * 104729 + 13) % 5000],
                        axis=1).astype(np.int32)
        rows[m + 1 - 2 * (m + 1) // 5:] = 2147483647
        rows = torch.from_numpy(rows).to(dev)
        for pts in (vert, bad):
            for e in (rows[:m], rows[1:]):
                before = K.LAUNCHES["edge_lengths_ani"]
                got = K.edge_lengths_ani(pts, met6, e)
                assert K.LAUNCHES["edge_lengths_ani"] == before + 1
                torch.testing.assert_close(
                    got, K.edge_lengths_ani_plain(pts, met6, e), rtol=3e-5,
                    atol=3e-6, equal_nan=True)
                c = e.clamp(0, 4999)
                head = torch.ones(m, dtype=torch.bool, device=dev)
                head[1:] = (c[1:] != c[:-1]).any(dim=1)
                pos = torch.arange(m, device=dev)
                src = torch.where(head, pos, 0).cummax(dim=0).values
                bits = got.view(torch.int32)
                assert torch.equal(bits, bits[src])
    mask = (torch.rand(30000, generator=g) > 0.5).to(dev)
    v = torch.rand(30000, generator=g).to(dev)
    for got, ref in ((K.score_count(mask, v), K.score_count_plain(mask, v)),
                     (K.score3_count(mask, v, v.flip(0), v.roll(3)),
                      K.score3_count_plain(mask, v, v.flip(0), v.roll(3)))):
        assert torch.equal(got[0], ref[0])
        assert int(got[1]) == int(ref[1])
    # K3 / K4 bit for bit (NaN payloads included) and counts exact: tails,
    # NaN and +-inf in v0 and v2 at selected and unselected rows, all-false
    # and all-true masks, the mask and the values viewed at a 1-element
    # offset; one launch a call; then calls on a second stream
    rng = np.random.default_rng(3)

    def bits(x):
        return x.view(torch.int32)

    def score_case(mask, v0, v1, v2):
        before = (K.LAUNCHES["score_count"], K.LAUNCHES["score3_count"])
        for got, ref in ((K.score_count(mask, v0),
                          K.score_count_plain(mask, v0)),
                         (K.score3_count(mask, v0, v1, v2),
                          K.score3_count_plain(mask, v0, v1, v2))):
            assert torch.equal(bits(got[0]), bits(ref[0]))
            assert got[1].dim() == 0 and int(got[1]) == int(ref[1])
        assert (K.LAUNCHES["score_count"], K.LAUNCHES["score3_count"]) == (
            before[0] + 1, before[1] + 1)
    for m in (1, 15, 17, 4099, 30001):
        vs = [rng.random(m + 1).astype(np.float32) for _ in range(3)]
        vs[1][::7] = np.inf
        for kind in ("random", "false", "true"):
            mk = {"random": rng.random(m + 1) > 0.5,
                  "false": np.zeros(m + 1, bool),
                  "true": np.ones(m + 1, bool)}[kind]
            for special in (False, True):
                a = [x.copy() for x in vs]
                if special:
                    _specials(rng, m, a[0][:m], a[2][:m], mk[:m])
                    _specials(rng, m, a[0][1:], a[2][1:], mk[1:])
                t = [torch.from_numpy(x).to(dev) for x in (mk, *a)]
                score_case(*(x[:m] for x in t))
                score_case(*(x[1:] for x in t))       # offset 1
                score_case(t[0][1:], *(x[:m] for x in t[1:]))
    side = torch.cuda.Stream(device=dev)
    mk = torch.from_numpy(rng.random(300001) > 0.9).to(dev)
    vs = [torch.from_numpy(rng.random(300001).astype(np.float32)).to(dev)
          for _ in range(3)]
    refs = (K.score_count_plain(mk, vs[0]), K.score3_count_plain(mk, *vs))
    torch.cuda.synchronize()
    outs = []
    for _ in range(2):
        for st in (torch.cuda.current_stream(dev), side):
            with torch.cuda.stream(st):
                outs.append((K.score_count(mk, vs[0]),
                             K.score3_count(mk, *vs)))
    torch.cuda.synchronize()
    for pair in outs:
        for got, ref in zip(pair, refs):
            assert torch.equal(bits(got[0]), bits(ref[0]))
            assert int(got[1]) == int(ref[1])
    # K7 / K5 / K8: exact, at sizes that span many tiles and a ragged tail
    n = 300001
    key = torch.randint(0, 1 << 20, (n,), generator=g, dtype=torch.int32)
    key[::7] = 2147483647
    hi = torch.randint(0, 46340, (n,), generator=g, dtype=torch.int32)
    hi[::5] = 2147483647
    key, hi = key.to(dev), hi.to(dev)
    for words, nbits in (((key,), None), ((hi, key), (16, 32)),
                         ((hi, key, key.flip(0).contiguous()), None)):
        assert torch.equal(K.radix_sort(words, nbits),
                           K.radix_sort_plain(words, nbits))
    x = torch.randint(-9, 100, (n,), generator=g, dtype=torch.int32).to(dev)
    assert torch.equal(K.merge_prefix(x), K.merge_prefix_plain(x))
    # K5 on values near +-2**31 whose sums wrap, and K5 / K7 at 2**24 + 3
    # rows, where the look-back crosses thousands of tiles
    big = 2 ** 24 + 3
    xw = torch.randint(2 ** 31 - 64, 2 ** 31, (big,), generator=g,
                       dtype=torch.int64)
    xw = torch.where(torch.rand(big, generator=g) < 0.5, xw, -xw)
    for xs in (xw[:n].to(torch.int32), xw.to(torch.int32)):
        xs = xs.to(dev)
        assert torch.equal(K.merge_prefix(xs), K.merge_prefix_plain(xs))
    kb = torch.randint(-2 ** 31, 2 ** 31, (big,), generator=g,
                       dtype=torch.int64).to(torch.int32).to(dev)
    for words, nbits in (((kb,), None), ((kb.flip(0).contiguous() & 0xFFFF,
                                          kb), (16, 32))):
        assert torch.equal(K.radix_sort(words, nbits),
                           K.radix_sort_plain(words, nbits))
    ks = key[K.radix_sort((key,)).long()]
    assert torch.equal(K.segment_flags((ks,)), K.segment_flags_plain((ks,)))
    # K8 in both modes, exactly: around one tile of rows, on a column
    # viewed at a 1-element offset (the kernel's unaligned path), on 1-3
    # words; one launch a call
    tile = 256 * K._fn("pm_segment_flags_rows")()
    w3 = torch.randint(0, 4, (3, 3 * tile + 9), generator=g,
                       dtype=torch.int32)
    w3[:, ::11] = 2147483647
    w3 = w3.to(dev)
    for m in (1, tile - 1, tile, tile + 1, 3 * tile + 8):
        for nw in (1, 2, 3):
            # sorted columns of m + 1 rows, viewed at each offset below
            buf = tuple(w3[j, :m + 1] for j in range(nw))
            pbuf = K.radix_sort(buf).long()
            sbuf = tuple(w[pbuf] for w in buf)
            for off in (0, 1):
                words = tuple(w3[j, off:off + m] for j in range(nw))
                perm = K.radix_sort(words)
                srt = tuple(s[off:off + m] for s in sbuf)
                assert off == 0 or srt[0].data_ptr() % 16
                before = K.LAUNCHES["segment_flags"]
                assert torch.equal(K.segment_flags(srt),
                                   K.segment_flags_plain(srt))
                got = K.segment_flags(words, order=perm)
                ref = K.segment_flags_plain(words, order=perm)
                assert K.LAUNCHES["segment_flags"] == before + 2
                assert torch.equal(got[1], ref[1])
                assert all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
    # K6 at a capT that is not a multiple of its block, dead tets included
    for m in (1, 511, 513, 20001):
        tq, mq = tet[:m], tm[:m]
        torch.testing.assert_close(K.tet_quality(vert, tq, mq),
                                   K.tet_quality_plain(vert, tq, mq),
                                   rtol=3e-5, atol=3e-6)
        torch.testing.assert_close(K.tet_quality(vert, tq, mq, met6),
                                   K.tet_quality_plain(vert, tq, mq, met6),
                                   rtol=1e-4, atol=1e-5)
    # the fixed-order float sum: the same bits on every call, close to the
    # CPU's sequential scatter_reduce
    from parmmg_tpu_torch.ops.primitives import reduce_drop
    idx = torch.randint(0, 5001, (n,), generator=g)
    idx[: n // 3] = 5000
    vals = torch.rand((n, 3), generator=g)
    dst = torch.zeros(5001, 3)
    a = reduce_drop(dst.to(dev), idx.to(dev), vals.to(dev), "sum")
    b = reduce_drop(dst.to(dev), idx.to(dev), vals.to(dev), "sum")
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    torch.testing.assert_close(a.cpu(), reduce_drop(dst, idx, vals, "sum"),
                               rtol=1e-4, atol=0)
