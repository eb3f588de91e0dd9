"""The port's incremental topology engine (``parmmg_tpu_torch/ops/topo_incr.py``)
and the grouped path's hooks of ``adapt_cycle_impl`` / ``sliver_polish``,
held against the JAX package (``parmmg_tpu/ops/topo_incr.py``).

Every comparison is exact: the engine is integer work (keys, slots,
permutations, prefix sums, masks), and the JAX functions run jitted, as
the JAX package's own tests run them (``pk.sort_perm`` takes its
``lexsort`` reference and ``_prefix_i32`` its ``cumsum`` on the CPU).  The
cases mirror the fast ones of ``tests/test_topo_incr.py``: the band-width
ladder and its override, the tombstone merge against a fresh stable sort
(fuzzed with dead slots and pads), the overflow fallback (a band of 2),
the reuse of a clean retained table, and the band merges of a real wave
(a split wave's dirty tets on cube_mesh(2)).  The inputs come from numpy's
default_rng with fixed seeds.

Port-only: three cycles with the engine threaded write the same bytes
with the band merges on and off; a masked cycle (``active=False``) and a
masked polish return their input and the row described in
``adapt_cycle_impl``'s docstring.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.ops import topo_incr as JT
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.ops import adapt as TAd, analysis as TN
from parmmg_tpu_torch.ops import adjacency as TA, edges as TE
from parmmg_tpu_torch.ops import split as TP, topo_incr as TT
from parmmg_tpu_torch.utils.fixtures import analytic_iso_metric, cube_mesh
from torch_parity import jax_ledger_listener_compat  # noqa: F401

I32_MAX = 2147483647


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _jmesh(tm):
    f = tmesh.mesh_to_numpy(tm)
    return jmesh.Mesh(**{k: jnp.asarray(v) for k, v in f.items()})


def _jtopo(tp):
    return JT.TopoState(*[jnp.asarray(x.numpy()) for x in tp])


def _eq(t, j):
    a = np.asarray(j)
    b = t.numpy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return a.shape == b.shape and np.array_equal(a, b)


def _assert_topo(tp, jtp):
    for name, a, b in zip(TT.TopoState._fields, tp, jtp):
        assert _eq(a, b), name


def _assert_et(et, jet):
    for name in TE.EdgeTable._fields:
        assert _eq(getattr(et, name), getattr(jet, name)), name


def _assert_mesh(tm, jm):
    got = tmesh.mesh_to_numpy(tm)
    for f in jmesh.MESH_FIELDS:
        assert np.array_equal(got[f], np.asarray(getattr(jm, f))), f


# ---- band width ladder ------------------------------------------------------

def test_incr_band_width_ladder_and_override(monkeypatch):
    monkeypatch.delenv("PARMMG_INCR_BAND", raising=False)
    for capT in (64, 1024, 9216, 49152, 98304, 147456, 1 << 20):
        assert TT.incr_band_width(capT) == JT.incr_band_width(capT), capT
        assert 1 <= TT.incr_band_width(capT) <= capT
    assert TT.incr_band_width(64) == 64
    assert TT.incr_band_width(1 << 20) < 1 << 20
    widths = [TT.incr_band_width(c) for c in range(64, 40000, 64)]
    assert all(a <= b for a, b in zip(widths, widths[1:]))
    # the port reads no environment variable: the JAX package's
    # PARMMG_INCR_BAND override leaves the port on its ladder
    for band, capT in ((7, 9216), (999999, 64), (2, 192)):
        monkeypatch.delenv("PARMMG_INCR_BAND", raising=False)
        ladder = JT.incr_band_width(capT)
        monkeypatch.setenv("PARMMG_INCR_BAND", str(band))
        assert JT.incr_band_width(capT) == max(1, min(band, capT))
        assert TT.incr_band_width(capT) == ladder


def test_topo_init_layout():
    for stack in (None, 3):
        j = JT.topo_init(48, stack=stack)
        t = TT.topo_init(48, stack=stack)
        for name, a, b in zip(TT.TopoState._fields, t, j):
            assert _eq(a, b) and a.dtype == (
                torch.bool if np.asarray(b).dtype == bool
                else torch.int32), name
    # the chunked pipeline's host-resident stack (JAX: topo_init_np)
    jn = JT.topo_init_np(4, 48)
    tn = TT.topo_init(48, stack=4, device="cpu")
    assert all(_eq(a, b) and a.device.type == "cpu" for a, b in zip(tn, jn))


# ---- the sorted-band merge ----------------------------------------------------

def _merge_case(rng, ncols, n, slots_per_tet=3):
    """A retained stable sort of old keys, a dirty set re-keyed (dead dirty
    slots key INT32_MAX with their real slot id), the band padded with
    (MAX, MAX) rows (tests/test_topo_incr.py's generator)."""
    ntet = n // slots_per_tet
    old = rng.integers(0, 50, size=(n, ncols)).astype(np.int32)
    old[rng.random(n) < 0.15] = I32_MAX
    order = np.lexsort(tuple(old[:, j] for j in range(ncols))[::-1])
    dirty_slot = np.repeat(rng.random(ntet) < 0.4, slots_per_tet)
    new = old.copy()
    fresh = rng.integers(0, 50, size=(n, ncols)).astype(np.int32)
    fresh[rng.random(n) < 0.3] = I32_MAX
    new[dirty_slot] = fresh[dirty_slot]
    didx = np.flatnonzero(dirty_slot).astype(np.int32)
    B = len(didx) + int(rng.integers(0, 5))
    bslot = np.full(B, I32_MAX, np.int32)
    bslot[: len(didx)] = didx
    bkeys = np.full((B, ncols), I32_MAX, np.int32)
    bkeys[: len(didx)] = new[didx]
    return new, order, dirty_slot, bkeys, bslot, old


@pytest.mark.parametrize("ncols", [1, 2])
def test_merge_sorted_band_exact_and_stable(ncols):
    """25 fuzz cases: the port's merge equals jitted JAX's and a fresh
    stable sort of the new keys, permutation and key columns."""
    rng = np.random.default_rng(1234 + ncols)
    jmerge = jax.jit(JT.merge_sorted_band)
    for trial in range(25):
        n = int(rng.integers(6, 120)) // 3 * 3 or 3
        new, order, dmask, bkeys, bslot, old = _merge_case(rng, ncols, n)
        ks = [old[order, j] for j in range(ncols)]
        args = (ks, order.astype(np.int32), dmask[order],
                [bkeys[:, j] for j in range(ncols)], bslot)
        jk, js = jmerge([jnp.asarray(k) for k in args[0]],
                        jnp.asarray(args[1]), jnp.asarray(args[2]),
                        [jnp.asarray(k) for k in args[3]],
                        jnp.asarray(args[4]))
        tk, ts = TT.merge_sorted_band([_t(k) for k in args[0]],
                                      _t(args[1]), _t(args[2]),
                                      [_t(k) for k in args[3]],
                                      _t(args[4]))
        ref = np.lexsort(tuple(new[:, j] for j in range(ncols))[::-1])
        assert _eq(ts, js) and np.array_equal(ts.numpy(), ref), trial
        for j in range(ncols):
            assert _eq(tk[j], jk[j]), (trial, j)
            assert np.array_equal(tk[j].numpy(), new[ref, j])


def test_band_order_and_lower_bound_exact():
    rng = np.random.default_rng(5)
    for nw in (1, 2):
        m = 301
        keys = [rng.integers(0, 40, m).astype(np.int32) for _ in range(nw)]
        slot = rng.permutation(m).astype(np.int32)
        pad = rng.random(m) < 0.2
        for k in keys:
            k[pad] = I32_MAX
        slot[pad] = I32_MAX
        j = jax.jit(JT.band_order)([jnp.asarray(k) for k in keys],
                                   jnp.asarray(slot))
        t = TT.band_order([_t(k) for k in keys], _t(slot))
        assert _eq(t, j)
        # a dense ascending table and queries into it
        n = 257
        tab = [np.sort(rng.integers(0, 40, n)).astype(np.int32)]
        if nw == 2:
            tab.append(rng.integers(0, 40, n).astype(np.int32))
            o = np.lexsort((tab[1], tab[0]))
            tab = [tab[0][o], tab[1][o]]
        tslot = np.arange(n, dtype=np.int32)
        q = [rng.integers(0, 45, 90).astype(np.int32) for _ in range(nw)]
        qs = rng.integers(0, n + 3, 90).astype(np.int32)
        jl = jax.jit(JT._lower_bound)([jnp.asarray(x) for x in q],
                                      jnp.asarray(qs),
                                      [jnp.asarray(x) for x in tab],
                                      jnp.asarray(tslot))
        tl = TT._lower_bound([_t(x) for x in q], _t(qs),
                             [_t(x) for x in tab], _t(tslot))
        assert _eq(tl, jl)


def test_prefix_i32_exact():
    rng = np.random.default_rng(77)
    for n in (1, 127, 128, 1025, 6144):
        x = rng.integers(0, 3, n).astype(np.int32)
        t = TT._prefix_i32(_t(x))
        assert t.dtype == torch.int32
        assert _eq(t, jnp.cumsum(jnp.asarray(x), dtype=jnp.int32))


# ---- the engine on a real wave ------------------------------------------------

@pytest.fixture(scope="module")
def wave_state():
    """cube_mesh(2) at 4x capacity, its first edge table and adjacency
    derived through the engine (the retained state), then one split wave
    under the shock map h = 0.5 (0.2 + 4 |x - 0.5|): the wave's dirty
    tets, half of the live ones, are the band."""
    v, t = cube_mesh(2)
    m0 = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=4 * len(v),
                                         capT=4 * len(t))).mesh
    h = np.ones(m0.capP, np.float32)
    h[: len(v)] = analytic_iso_metric(v, "shock", h=0.5)
    met = torch.from_numpy(h)
    tp = TT.topo_init(m0.capT)
    et0, tp = TT.incr_unique_edges(m0, tp, True)
    m0, tp = TT.incr_build_adjacency(m0, tp, True)
    res = TP.split_wave(m0, met, et=et0,
                        lens=TE.edge_lengths(m0, et0, met))
    assert int(res.nsplit) > 0
    return m0, res.mesh, tp


def test_mark_dirty_exact(wave_state):
    m0, m1, tp = wave_state
    j = jax.jit(JT.mark_dirty)(_jtopo(tp), jnp.asarray(m0.tet.numpy()),
                               jnp.asarray(m0.tmask.numpy()), _jmesh(m1))
    t = TT.mark_dirty(tp, m0.tet, m0.tmask, m1)
    _assert_topo(t, j)
    assert 0 < int(t.edirty.sum()) < int(m1.tmask.sum())


def _jit_edges(incr):
    return jax.jit(lambda mm, tt: JT.incr_unique_edges(
        mm, tt, jnp.asarray(incr), shell_slots=0))


def _jit_adj(incr):
    return jax.jit(lambda mm, tt: JT.incr_build_adjacency(
        mm, tt, jnp.asarray(incr)))


@pytest.mark.parametrize("incr", [True, False])
def test_incr_tables_after_a_wave_exact(wave_state, monkeypatch, incr):
    """The split wave's dirty tets merged into the retained edge and face
    sorts (incr on: band merges, K5 + K7 at band widths) or the full sorts
    (incr off): the edge table, the adjacency and the new state equal
    jitted JAX's and the legacy derivations of the port."""
    monkeypatch.delenv("PARMMG_INCR_BAND", raising=False)
    m0, m1, tp = wave_state
    tp = TT.mark_dirty(tp, m0.tet, m0.tmask, m1)
    TT.reset_counts()
    et, tp_e = TT.incr_unique_edges(m1, tp, incr)
    jet, jtp_e = _jit_edges(incr)(_jmesh(m1), _jtopo(tp))
    _assert_et(et, jet)
    _assert_topo(tp_e, jtp_e)
    for name in TE.EdgeTable._fields:
        assert torch.equal(getattr(et, name),
                           getattr(TE.unique_edges(m1, shell_slots=0),
                                   name)), name
    m2, tp_f = TT.incr_build_adjacency(m1, tp_e, incr)
    jm2, jtp_f = _jit_adj(incr)(_jmesh(m1), jtp_e)
    _assert_mesh(m2, jm2)
    _assert_topo(tp_f, jtp_f)
    legacy = TA.build_adjacency(m1)
    for f in tmesh.MESH_FIELDS:
        assert torch.equal(getattr(m2, f), getattr(legacy, f)), f
    if incr:
        assert TT.COUNTS["edge_merges"] == 1 == TT.COUNTS["face_merges"]
        B = TT.incr_band_width(m1.capT)
        assert TT.BAND_WIDTHS == {("edge", B), ("face", B)}
    else:
        assert TT.COUNTS["full"] == 2 and not TT.BAND_WIDTHS


def test_incr_overflow_falls_back_exact(wave_state, monkeypatch):
    """More dirty tets than a band of 2: the full sorts rebuild the tables
    (the same bits as JAX's fallback and as the legacy derivations), and
    the state is refreshed: dirty cleared, ok set."""
    monkeypatch.setenv("PARMMG_INCR_BAND", "2")
    monkeypatch.setattr(TT, "incr_band_width", lambda capT: 2)
    m0, m1, tp = wave_state
    tp = TT.mark_dirty(tp, m0.tet, m0.tmask, m1)
    TT.reset_counts()
    et, tp_e = TT.incr_unique_edges(m1, tp, True)
    jet, jtp_e = _jit_edges(True)(_jmesh(m1), _jtopo(tp))
    _assert_et(et, jet)
    _assert_topo(tp_e, jtp_e)
    m2, tp_f = TT.incr_build_adjacency(m1, tp_e, True)
    jm2, jtp_f = _jit_adj(True)(_jmesh(m1), jtp_e)
    _assert_mesh(m2, jm2)
    _assert_topo(tp_f, jtp_f)
    assert TT.COUNTS["overflow"] == 2 and TT.COUNTS["full"] == 2
    assert bool(tp_f.eok) and bool(tp_f.fok)
    assert not bool(tp_f.edirty.any()) and not bool(tp_f.fdirty.any())


def test_incr_nd0_reuses_retained_table(wave_state):
    """A clean state (no dirty tet): the tables come from the retained
    sorts wholesale, equal to jitted JAX's and to the legacy derivations."""
    m0, _, tp = wave_state
    TT.reset_counts()
    et, tp_e = TT.incr_unique_edges(m0, tp, True)
    m2, _ = TT.incr_build_adjacency(m0, tp_e, True)
    assert TT.COUNTS["reuses"] == 2 and TT.COUNTS["full"] == 0
    jet, jtp_e = _jit_edges(True)(_jmesh(m0), _jtopo(tp))
    _assert_et(et, jet)
    _assert_mesh(m2, _jit_adj(True)(_jmesh(m0), jtp_e)[0])
    _assert_mesh(m2, _jmesh(TA.build_adjacency(m0)))


# ---- adapt_cycle_impl's grouped hooks ---------------------------------------

def _cube_shock(n=3, capmul=4):
    v, t = cube_mesh(n)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=capmul * len(v),
                                        capT=capmul * len(t))).mesh
    h = np.ones(m.capP, np.float32)
    h[: len(v)] = analytic_iso_metric(v, "shock", h=1.5 / (2 * n))
    return m, torch.from_numpy(h)


def test_cycles_with_incr_on_and_off_write_the_same_bytes():
    """Three cycles (the third swap-inclusive, the smoothing cadence's
    carry read from each row) with the engine threaded: band merges on and
    off give the same meshes, metrics and counts rows; rows are 9 wide
    with [8] the dirty tets at the cycle's start."""
    outs = []
    for incr in (False, True):
        m, met = _cube_shock()
        tp = TT.topo_init(m.capT)
        TT.reset_counts()
        rows = []
        for c in range(3):
            m, met, cnt, tp = TAd.adapt_cycle_impl(
                m, met, c, do_swap=c == 2, topo=tp, incr=incr,
                final_rebuild=True)
            rows.append(cnt.tolist())
        outs.append((m, met, rows, dict(TT.COUNTS)))
    (ma, ka, ra, ca), (mb, kb, rb, cb) = outs
    for f in tmesh.MESH_FIELDS:
        assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    assert torch.equal(ka, kb) and ra == rb
    assert all(len(r) == 9 for r in ra)
    assert ra[0][8] == 0 and ra[1][8] > 0
    assert sum(r[0] + r[1] for r in ra) > 0
    assert ca["edge_merges"] == 0 and ca["face_merges"] == 0
    assert cb["edge_merges"] + cb["face_merges"] >= 2


@pytest.mark.parametrize("with_topo", [False, True])
def test_inactive_cycle_returns_its_input(with_topo):
    """``active=False``: the input objects come back, the counts row is
    zeros but [5] (live tets) and, with the engine, [8] (the dirty tets
    pending)."""
    m, met = _cube_shock()
    tp = TT.topo_init(m.capT)
    tp = tp._replace(edirty=m.tmask & (torch.arange(m.capT) % 5 == 0))
    kw = dict(topo=tp, incr=True) if with_topo else {}
    out = TAd.adapt_cycle_impl(m, met, 3, active=False, **kw)
    assert out[0] is m and out[1] is met
    row = [0] * 5 + [int(m.tmask.sum())] + [0, 0]
    if with_topo:
        assert out[3] is tp
        row.append(int(tp.edirty.sum()))
    assert out[2].tolist() == row and out[2].dtype == torch.int32
    live = TAd.adapt_cycle_impl(m, met, 3, active=True, **kw)
    assert live[2][0] > 0 and live[0] is not m
