"""The port's worklist cycles (``parmmg_tpu_torch/ops/active.py``) and the
block dispatch of ``adapt_mesh`` held against the JAX package.

Exact (integer and boolean arrays bit for bit, floats to the tolerances of
``test_torch_waves.py``): ``morton_window_mask``, ``narrow_rows``,
``dirty_from_diff`` for each field it watches, ``closure_active``,
``extract_active``, ``writeback_active``, ``build_adjacency`` without
boundary tags, and each wave under ``vact`` / ``wwin`` on the same float
inputs.  Small functions run jitted on the JAX side.  Whole cycles and
blocks run under ``jax.disable_jit()``: the port follows eager JAX op by
op, and eager ``lax.cond`` runs only the branch its predicate picks.

The inputs are a seeded state of cube_mesh(4): a few port cycles under the
planar shock metric, then interior jitter from numpy's default_rng.  Its
tet capacity lets the narrow sub-mesh take every row (A = capT, one morton
window), so narrow and full cycles share their shapes and eager JAX
compiles each primitive once; one narrow cycle runs at A = capT / 2,
where six windows rotate.

Port-only cases give the contracts of the JAX package's slow
``tests/test_active.py`` at the port's CPU speed: narrow cycles engage,
rows outside the active set stay bit-identical through a narrow cycle,
and a run with almost no free rows discards cleanly and stays conforming
and volume-preserving.
"""
import contextlib
import threading
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parmmg_tpu.ops.analysis  # noqa: F401  (module constants, untraced)
from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.ops import active as JV, adapt as JAd, adjacency as JA
from parmmg_tpu.ops import collapse as JC, edges as JE, smooth as JS
from parmmg_tpu.ops import split as JP, swap as JW
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.core.constants import MG_BDY
from parmmg_tpu_torch.ops import active as TV, adapt as TAd
from parmmg_tpu_torch.ops import adjacency as TA, analysis as TN
from parmmg_tpu_torch.ops import collapse as TC, edges as TE
from parmmg_tpu_torch.ops import smooth as TS, split as TP, swap as TW
from parmmg_tpu_torch.ops.quality import tet_quality
from parmmg_tpu_torch.utils.compilecache import bucket
from parmmg_tpu_torch.utils.fixtures import (analytic_ani_metric,
                                             analytic_iso_metric, cube_mesh)
from torch_parity import jax_ledger_listener_compat  # noqa: F401

HAUSD = 0.01


def _to_jax(tm):
    f = tmesh.mesh_to_numpy(tm)
    return jmesh.Mesh(**{k: jnp.asarray(v) for k, v in f.items()})


def _from_jax(jm):
    return tmesh.mesh_from_numpy(
        {f: np.asarray(getattr(jm, f)) for f in jmesh.MESH_FIELDS})


def _assert_mesh(jm, tm, vert_atol=1e-6, vert_rtol=1e-5):
    got = tmesh.mesh_to_numpy(tm)
    for f in jmesh.MESH_FIELDS:
        a = np.asarray(getattr(jm, f))
        if f == "vert":
            np.testing.assert_allclose(got[f], a, rtol=vert_rtol,
                                       atol=vert_atol)
        else:
            assert np.array_equal(got[f], a), f


def _eq(t, j):
    return np.array_equal(t.numpy(), np.asarray(j))


def _shock(vert, n, capP):
    h = analytic_iso_metric(vert, "shock", h=1.5 / n).astype(np.float32)
    met = np.ones(capP, np.float32)
    met[: len(h)] = h
    return torch.from_numpy(met)


def _setup(n, capmul):
    v, t = cube_mesh(n)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=capmul * len(v),
                                        capT=capmul * len(t))).mesh
    return m, _shock(v, n, m.capP)


@pytest.fixture(scope="module", autouse=True)
def swap23_off_the_face_sort():
    """The JAX package pairs swap23 off the face sort, as on its
    accelerator and as the port does everywhere: a cycle that skips its
    closing rebuild then leaves the same (stale) ``adja`` on both sides."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PARMMG_SWAP_FACESORT", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def state():
    """cube_mesh(4) at capP 16*125, capT 16*384 after 3 port cycles under
    the shock metric (h = 1.5/4), interior vertices moved by N(0, 0.01);
    ``pending``, the worklist, is a ball of live vertices."""
    m, met = _setup(4, 16)
    for c in range(3):
        m, met, _ = TAd.adapt_cycle_impl(m, met, c, do_swap=c == 2,
                                         hausd=HAUSD)
    rng = np.random.default_rng(11)
    inner = (m.vmask & ((m.vtag & MG_BDY) == 0)).numpy()
    vert = m.vert.numpy().copy()
    vert[inner] += (rng.standard_normal((inner.sum(), 3))
                    * 0.01).astype(np.float32)
    jit = tmesh.replace(m, vert=torch.from_numpy(vert))
    # the worklist: the live vertices near a random point
    c = rng.uniform(0.2, 0.8, 3).astype(np.float32)
    near = ((jit.vert - torch.from_numpy(c)) ** 2).sum(dim=1) < 0.35 ** 2
    st = {"mesh": jit, "met": met, "pending": near & jit.vmask}
    with _eager_thread(st) as futs:
        st["eager"] = futs
        yield st


# ---- small functions, exact -----------------------------------------------

@pytest.mark.parametrize("wave,nwin", [(0, 2), (1, 3), (5, 9), (13, 24),
                                       (30, 24)])
def test_morton_window_mask_exact(state, wave, nwin):
    m = state["mesh"]
    fn = jax.jit(JS.morton_window_mask, static_argnums=3)
    j = fn(jnp.asarray(m.vert.numpy()), jnp.asarray(m.vmask.numpy()),
           jnp.asarray(wave, jnp.int32), nwin)
    t = TS.morton_window_mask(m.vert, m.vmask, wave, nwin)
    assert _eq(t, j)
    assert 0 < int((t & m.vmask).sum()) < int(m.vmask.sum())


def test_narrow_rows_and_bucket_exact():
    from parmmg_tpu.utils.compilecache import bucket as jbucket
    for capT in [64, 1000, 8192, 9000, 65536, 73728, 147456, 10 ** 6,
                 3 * 10 ** 6 + 7]:
        assert TV.narrow_rows(capT) == JV.narrow_rows(capT), capT
    for n in [1, 200, 257, 5000, 123457]:
        assert bucket(n, 256) == jbucket(n, 256, "geo")
        assert bucket(n, 256, cap=4000) == jbucket(n, 256, "geo", cap=4000)


def _edit(field, m, k):
    """One change to ``field`` of the mesh fields ``m`` (numpy, copied)
    or of the metric ``k``."""
    m = {f: a.copy() for f, a in m.items()}
    k = k.copy()
    if field == "vert":
        m["vert"][5, 0] += 1e-3
    elif field == "tet":
        m["tet"][0, 3] += 1
    elif field in ("tmask", "vmask"):
        m[field][0] = ~m[field][0]
    elif field in ("ftag", "fref", "etag"):
        m[field][7, 1] ^= 1 << 3
    elif field == "vtag":
        m["vtag"][9] ^= 1 << 3
    else:
        k[11] *= 1.5
    return m, k


@pytest.mark.parametrize("field", ["vert", "tet", "tmask", "ftag", "fref",
                                   "etag", "vtag", "vmask", "met"])
def test_dirty_from_diff_exact(state, field):
    base = tmesh.mesh_to_numpy(state["mesh"])
    k0 = state["met"].numpy()
    m2, k2 = _edit(field, base, k0)
    j = jax.jit(JV.dirty_from_diff)(
        jmesh.Mesh(**{f: jnp.asarray(a) for f, a in base.items()}),
        jmesh.Mesh(**{f: jnp.asarray(a) for f, a in m2.items()}),
        jnp.asarray(k0), jnp.asarray(k2))
    t = TV.dirty_from_diff(tmesh.mesh_from_numpy(base),
                           tmesh.mesh_from_numpy(m2), torch.from_numpy(k0),
                           torch.from_numpy(k2))
    assert _eq(t, j)
    assert 1 <= int(t.sum()) <= 8


def _narrow_inputs(state, A):
    m = state["mesh"]
    d2, active = TV.closure_active(m, state["pending"])
    return m, d2, active, TV.extract_active(m, active, A)


@pytest.mark.parametrize("A", [None, 2048])
def test_closure_and_extract_exact(state, A):
    m, jm = state["mesh"], _to_jax(state["mesh"])
    A = A or TV.narrow_rows(m.capT)
    jd2, jact = jax.jit(JV.closure_active)(
        jm, jnp.asarray(state["pending"].numpy()))
    _, d2, active, (sub, back, n_act, ovf) = _narrow_inputs(state, A)
    assert _eq(d2, jd2) and _eq(active, jact)
    assert 0 < int(active.sum()) < int(m.tmask.sum())
    jsub, jback, jn, jovf = jax.jit(JV.extract_active, static_argnums=2)(
        jm, jact, A)
    _assert_mesh(jsub, sub, vert_atol=0, vert_rtol=0)
    assert _eq(back, jback) and back.dtype == torch.int32
    assert int(n_act) == int(jn) and bool(ovf) == bool(jovf)


def test_build_adjacency_without_bdy_tags_exact(state):
    _, _, _, (sub, _, _, _) = _narrow_inputs(state, TV.narrow_rows(
        state["mesh"].capT))
    ja = jax.jit(JA.build_adjacency, static_argnums=1)(_to_jax(sub), False)
    ta = TA.build_adjacency(sub, set_bdy_tags=False)
    _assert_mesh(ja, ta, vert_atol=0, vert_rtol=0)
    assert _eq(ta.ftag, _to_jax(sub).ftag)       # no tag written
    tagged = TA.build_adjacency(sub)
    assert int(((tagged.ftag & MG_BDY) != 0).sum()) > \
        int(((sub.ftag & MG_BDY) != 0).sum())   # the cut faces


def test_writeback_exact(state):
    """A narrow cycle's sub-mesh written back by both packages."""
    m, met = state["mesh"], state["met"]
    _, d2, _, (sub0, back, n_act, _) = _narrow_inputs(
        state, TV.narrow_rows(m.capT))
    sub, _, counts = TAd.adapt_cycle_impl(
        sub0, met, 4, do_swap=True, hausd=HAUSD, budget_div=2, vact=d2,
        submesh=True, final_rebuild=False)
    assert int(counts[0]) + int(counts[1]) > 0
    j = jax.jit(JV.writeback_active)(_to_jax(m), _to_jax(sub),
                                     jnp.asarray(back.numpy()),
                                     jnp.asarray(n_act.numpy()))
    t = TV.writeback_active(m, sub, back, n_act)
    _assert_mesh(j, t, vert_atol=0, vert_rtol=0)


# ---- waves under vact / wwin ----------------------------------------------

def _masks(state):
    m = state["mesh"]
    d2, _ = TV.closure_active(m, state["pending"])
    wwin = TS.morton_window_mask(m.vert, m.vmask, 0, 2)
    return d2, wwin


def test_split_and_collapse_restricted_exact(state):
    m, met = state["mesh"], state["met"]
    vact, wwin = _masks(state)
    jm, jmet = _to_jax(m), jnp.asarray(met.numpy())
    jv, jw = jnp.asarray(vact.numpy()), jnp.asarray(wwin.numpy())
    jet = jax.jit(lambda x: JE.unique_edges(x, shell_slots=0))(jm)
    jl = jax.jit(JE.edge_lengths)(jm, jet, jmet)
    tet = TE.unique_edges(m, shell_slots=0)
    tl = torch.from_numpy(np.array(jl))
    jr = jax.jit(lambda *a: JP.split_wave(*a[:2], hausd=HAUSD, et=a[2],
                                          lens=a[3], vact=a[4]))(
        jm, jmet, jet, jl, jv)
    tr = TP.split_wave(m, met, hausd=HAUSD, et=tet, lens=tl, vact=vact)
    full = TP.split_wave(m, met, hausd=HAUSD, et=tet, lens=tl)
    assert int(tr.nsplit) == int(jr.nsplit) > 0
    assert int(tr.nsplit) < int(full.nsplit)
    assert bool(tr.deferred) == bool(jr.deferred)
    _assert_mesh(jr.mesh, tr.mesh)
    counts = []
    for kw in (dict(vact=vact), dict(wwin=wwin), dict(vact=vact, wwin=wwin)):
        jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
        jc = jax.jit(lambda mm, kk, e, ll, st, d: JC.collapse_wave(
            mm, kk, hausd=HAUSD, et=e, lens=ll, stale_tets=st, **d))(
            jr.mesh, jr.met, jet, jl, jr.modified, jkw)
        tc = TC.collapse_wave(_from_jax(jr.mesh),
                              torch.from_numpy(np.array(jr.met)),
                              hausd=HAUSD, et=tet, lens=tl,
                              stale_tets=tr.modified, **kw)
        assert int(tc.ncollapse) == int(jc.ncollapse), list(kw)
        counts.append(int(tc.ncollapse))
        assert bool(tc.deferred) == bool(jc.deferred)
        _assert_mesh(jc.mesh, tc.mesh)
    assert counts[0] > 0 and counts[1] > 0 and counts[2] <= min(counts)


@pytest.mark.parametrize("which", ["vact", "wwin", "both"])
def test_swap_edges_restricted_exact(state, which):
    m, met = state["mesh"], state["met"]
    vact, wwin = _masks(state)
    kw = {"vact": dict(vact=vact), "wwin": dict(wwin=wwin),
          "both": dict(vact=vact, wwin=wwin)}[which]
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    jw = jax.jit(lambda mm, kk, d: JW.swap_edges_wave(
        mm, kk, hausd=HAUSD, **d))(_to_jax(m), jnp.asarray(met.numpy()),
                                   jkw)
    tw = TW.swap_edges_wave(m, met, hausd=HAUSD, **kw)
    assert int(tw.nswap) == int(jw.nswap) > 0
    assert bool(tw.deferred) == bool(jw.deferred)
    _assert_mesh(jw.mesh, tw.mesh)


@pytest.mark.parametrize("bdy", [True, False])
def test_swap23_window_exact(state, bdy):
    """swap23 paired off the face sort, window-limited, with and without
    the MG_BDY replay (off on a sub-mesh)."""
    m, met = state["mesh"], state["met"]
    _, wwin = _masks(state)
    _, _, _, (sub, _, _, _) = _narrow_inputs(state, TV.narrow_rows(m.capT))
    src = m if bdy else sub
    jw = jax.jit(lambda mm, kk, w: JW.swap23_wave(
        mm, kk, wwin=w, facesort=True, set_bdy_tags=bdy))(
        _to_jax(src), jnp.asarray(met.numpy()), jnp.asarray(wwin.numpy()))
    tw = TW.swap23_wave(src, met, wwin=wwin, facesort=True,
                        set_bdy_tags=bdy)
    assert int(tw.nswap) == int(jw.nswap) > 0
    assert bool(tw.deferred) == bool(jw.deferred)
    _assert_mesh(jw.mesh, tw.mesh)


@pytest.mark.parametrize("which", ["vact", "wwin"])
def test_smooth_restricted_exact(state, which):
    m, met = state["mesh"], state["met"]
    vact, wwin = _masks(state)
    keep = vact if which == "vact" else wwin
    # eager: the fused XLA program rounds the gain gate differently
    js = JS.smooth_wave(_to_jax(m), jnp.asarray(met.numpy()), wave=3,
                        vact=jnp.asarray(keep.numpy()))
    ts = TS.smooth_wave(m, met, wave=3, vact=keep)
    assert int(ts.nmoved) == int(js.nmoved) > 0
    moved = (ts.mesh.vert != m.vert).any(dim=1)
    assert not bool((moved & ~keep).any())
    _assert_mesh(js.mesh, ts.mesh)


# ---- port-only invariants ---------------------------------------------------

def _run_auto(m, met, blocks, nper=3):
    pend = torch.zeros(m.capP, dtype=torch.bool)
    ok = False
    rows = []
    for b in range(blocks):
        flags = tuple((nper * b + c) % 3 == 2 for c in range(nper))
        m, met, pend, ok, counts = TV.adapt_cycles_auto(
            m, met, pend, ok, nper * b, swap_flags=flags)
        rows.extend(counts.tolist())
    return m, met, np.asarray(rows)


def test_auto_engages_narrow_and_stays_conforming():
    m, met = _setup(5, 6)
    vol0 = _assert_conforming(m)
    m, met, rows = _run_auto(m, met, blocks=5)
    assert rows[:, 7].sum() >= 3, rows
    assert np.isclose(_assert_conforming(m), vol0, rtol=1e-5)


def test_narrow_leaves_untouched_regions_bit_identical():
    m, met = _setup(5, 6)
    m, met, pend, ok, _ = TV.adapt_cycles_auto(
        m, met, torch.zeros(m.capP, dtype=torch.bool), False, 0,
        swap_flags=(False, False, False))
    m2, _, _, _, counts = TV.adapt_cycles_auto(
        m, met, pend, ok, 3, swap_flags=(False,), full_flags=(False,),
        final_rebuild=False)
    assert counts[0, 7] == 1                      # ran narrow
    d2, active = TV.closure_active(m, pend)
    inact = ~active & m.tmask
    for f in ("tet", "tref", "ftag", "fref", "etag"):
        assert torch.equal(getattr(m, f)[inact], getattr(m2, f)[inact]), f
    assert bool(m2.tmask[inact].all())
    far = ~d2 & m.vmask
    assert torch.equal(m.vert[far], m2.vert[far])
    assert torch.equal(m.vtag[far], m2.vtag[far])


def test_narrow_discard_on_tight_capacity():
    """cube_mesh(3) at capT 180 (18 free rows) under h = 0.2: a narrow
    cycle on the ball |x| < 0.45 allocates more rows than the mesh has
    free, so it is discarded whole: the input mesh, metric and worklist
    come back unchanged, the counts row is an empty narrow cycle that
    escalates, and the next cycle runs full width, conforming and
    volume-preserving."""
    v, t = cube_mesh(3)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=8 * len(v),
                                        capT=180)).mesh
    met = torch.full((m.capP,), 0.2)
    vol0 = _assert_conforming(m)
    pend = ((m.vert ** 2).sum(dim=1) < 0.45 ** 2) & m.vmask
    inputs = {f: getattr(m, f).clone() for f in tmesh.MESH_FIELDS}
    A = TV.narrow_rows(m.capT)
    c0 = TV.COUNTS["discarded"]
    m2, met2, pend2, ok2, row = TV.auto_cycle(
        m, met, pend, True, 0, A, False, True, True, None)
    assert TV.COUNTS["discarded"] == c0 + 1
    n_act = int(TV.closure_active(m, pend)[1].sum())
    assert A - A // TV.NARROW_HEADROOM_DIV >= n_act
    assert row.tolist() == [0, 0, 0, 0, 0, int(m.tmask.sum()), 1, 1,
                            n_act, 1]
    for f, a in inputs.items():
        assert torch.equal(getattr(m2, f), a), f
    assert met2 is met and torch.equal(pend2, pend) and not bool(ok2)
    m3, _, _, _, row3 = TV.auto_cycle(m2, met2, pend2, ok2, 1, A, False,
                                      True, True, None)
    assert row3[7] == 0 and row3[0] > 0
    assert np.isclose(_assert_conforming(m3), vol0, rtol=1e-5)


def test_tight_capacity_run_stays_conforming():
    """Auto blocks at twice the input's capacity stay conforming and
    volume-preserving."""
    m, met = _setup(3, 2)
    vol0 = _assert_conforming(m)
    m, met, rows = _run_auto(m, met, blocks=4)
    assert np.isclose(_assert_conforming(m), vol0, rtol=1e-5)
    assert (rows[:, 5] > 0).all() and rows[:, 7].sum() > 0


def test_default_cycle_block():
    assert TAd.default_cycle_block(torch.device("cuda")) == 9
    assert TAd.default_cycle_block("cuda:0") == 9
    assert TAd.default_cycle_block(torch.device("cpu")) == 1


def test_cycle_block_one_is_one_cycle_a_dispatch(monkeypatch):
    """On the CPU adapt_mesh runs one full-width cycle a dispatch and never
    reaches the auto blocks."""
    def boom(*a, **k):
        raise AssertionError("auto block at cycle_block 1")
    monkeypatch.setattr(TV, "adapt_cycles_auto", boom)
    m, met = _setup(2, 8)
    m2, _, st = TAd.adapt_mesh(m, met, max_cycles=4)
    assert st.cycles == 4
    _assert_conforming(m2)


# ---- whole cycles and blocks against eager JAX -----------------------------
#
# Eager JAX compiles each primitive at its first use on each shape (about
# two minutes for the first cycle here), so the eager runs share the state's
# capacities and run in two background threads (``jax.disable_jit`` is
# thread-local) while the module's other tests go on.

AUTO_CASES = {"narrow": (True, None), "full": (False, None),
              "full-windowed": (False, 2), "narrow-windowed": (True, 2)}
CYCLE_KW = dict(do_swap=True, do_smooth=True, do_insert=True, hausd=HAUSD)
FLAGS3 = (False, False, True)
# the eager JAX runs, one list a background thread: the narrow cycle at
# A = capT / 2 sorts and scatters at shapes no other run has
EAGER_PARTS = (("narrow", "block3"), ("full", "full-windowed", "adapt_mesh"),
               ("narrow-windowed",), ("block3-aniso",))


def _ani(state):
    """The shock tensor metric spacing 0.15 (0.2 + 4 |x - 0.5|) across
    x = 0.5 and 0.45 along it at the state's live vertices, the identity
    at its dead rows."""
    m = state["mesh"]
    met = np.tile(np.float32([1, 0, 0, 1, 0, 1]), (m.capP, 1))
    live = m.vmask.numpy()
    met[live] = analytic_ani_metric(m.vert.numpy()[live], "shock", h=0.15,
                                    h_tan=0.45)
    return torch.from_numpy(met)


def _cube3(state):
    """cube_mesh(3) at the state's capacities (so that eager JAX reuses
    the state's compiled primitives) and its shock metric."""
    v, t = cube_mesh(3)
    m = state["mesh"]
    tm = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=m.capP,
                                         capT=m.capT)).mesh
    return tm, _shock(v, 3, tm.capP)


def _eager_jobs(state, names):
    """The JAX side of the whole-cycle comparisons named: the auto_cycle
    cases of AUTO_CASES, a block of 3 from an empty worklist ("block3"),
    and adapt_mesh(cycle_block=3, max_cycles=12) on cube_mesh(3) with
    each auto block's rows ("adapt_mesh")."""
    m, met, pending = state["mesh"], state["met"], state["pending"]
    jm, jmet = _to_jax(m), jnp.asarray(met.numpy())
    jpend = jnp.asarray(pending.numpy())
    A = TV.narrow_rows(m.capT)
    with jax.disable_jit():
        for name in names:
            if name in AUTO_CASES:
                ok, div = AUTO_CASES[name]
                yield name, JV.auto_cycle(
                    jm, jmet, jpend, jnp.asarray(ok),
                    jnp.asarray(5, jnp.int32), A // (div or 1),
                    window=TV.WINDOW, **CYCLE_KW)
            elif name.startswith("block3"):
                aniso = name.endswith("aniso")
                yield name, JV.adapt_cycles_auto_impl(
                    jm, jnp.asarray(_ani(state).numpy()) if aniso else jmet,
                    jnp.zeros(m.capP, bool), jnp.asarray(False),
                    jnp.asarray(6, jnp.int32), swap_flags=FLAGS3,
                    hausd=None if aniso else HAUSD)
            else:
                yield name, _eager_adapt_mesh(state)


def _eager_adapt_mesh(state):
    tm3, met3 = _cube3(state)
    rows = []
    auto = JV.adapt_cycles_auto

    def rec(*a, **k):
        out = auto(*a, **k)
        rows.append(np.asarray(out[4]).tolist())
        return out
    JV.adapt_cycles_auto = rec
    try:
        out = JAd.adapt_mesh(_to_jax(tm3), jnp.asarray(met3.numpy()),
                             max_cycles=12, cycle_block=3)
    finally:
        JV.adapt_cycles_auto = auto
    return out + (rows,)


@contextlib.contextmanager
def _eager_thread(state):
    """Futures of :func:`_eager_jobs`' results by name (call one to wait
    for it), filled by one background thread for each of EAGER_PARTS
    (XLA compiles outside the GIL)."""
    futs = {n: Future() for part in EAGER_PARTS for n in part}

    def run(names):
        try:
            for name, out in _eager_jobs(state, names):
                futs[name].set_result(out)
        except BaseException as e:           # noqa: BLE001 (passed on)
            for f in futs.values():
                if not f.done():
                    f.set_exception(e)
    threads = [threading.Thread(target=run, args=(p,), daemon=True)
               for p in EAGER_PARTS]
    for th in threads:
        th.start()
    yield {n: f.result for n, f in futs.items()}
    for th in threads:
        th.join()


@pytest.fixture(scope="module")
def eager(state):
    return state["eager"]


def _check_cycle(jout, tout, m, inputs):
    jm, jk, jp, jok, jc = jout
    tm, tk, tp, tok, tc = tout
    assert tc.tolist() == np.asarray(jc).tolist()
    _assert_mesh(jm, tm)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6)
    assert _eq(tp, jp) and bool(tok) == bool(jok)
    # the port's inputs are left as they were
    for f, a in inputs.items():
        assert torch.equal(getattr(m, f), a), f


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_auto_cycle_exact(state, eager, case):
    """One narrow cycle (okflag True) and one full cycle (okflag False)
    from the same worklist, at A = capT (one window); and both again at
    A = capT/2, where six morton windows rotate and limit the waves: the
    narrow cycle then runs on a sub-mesh of half the mesh's rows."""
    m, met, pending = state["mesh"], state["met"], state["pending"]
    okflag, div = AUTO_CASES[case]
    A = TV.narrow_rows(m.capT) // (div or 1)
    inputs = {f: getattr(m, f).clone() for f in tmesh.MESH_FIELDS}
    tout = TV.auto_cycle(m, met, pending, okflag, 5, A, **CYCLE_KW)
    _check_cycle(eager[case](), tout, m, inputs)
    row = tout[4].tolist()
    assert row[7] == int(okflag) and row[9] == int(okflag)
    assert row[0] + row[1] + row[2] > 0
    if div:                     # the windowed cycle did less
        full = TV.auto_cycle(m, met, pending, okflag, 5, A * div,
                             **CYCLE_KW)[4].tolist()
        assert row[1] + row[3] < full[1] + full[3]
        assert not torch.equal(tout[2], pending)


@pytest.mark.parametrize("metric", ["iso", "aniso"])
def test_block_of_three_rows_exact(state, eager, metric):
    """A block of 3 through adapt_cycles_auto from an empty worklist: the
    per-cycle counts rows and the final state equal eager JAX's, under
    the iso shock map and under the tensor metric :func:`_ani`."""
    m = state["mesh"]
    aniso = metric == "aniso"
    met = _ani(state) if aniso else state["met"]
    tout = TV.adapt_cycles_auto(m, met, torch.zeros(m.capP,
                                                    dtype=torch.bool),
                                False, 6, swap_flags=FLAGS3,
                                hausd=None if aniso else HAUSD)
    jout = eager["block3-aniso" if aniso else "block3"]()
    rows = tout[4].tolist()
    assert rows == np.asarray(jout[4]).tolist()
    assert [r[7] for r in rows] == [0, 1, 0]      # full, narrow, refresh
    assert _eq(tout[2], jout[2]) and bool(tout[3]) == bool(jout[3])
    if not aniso:
        _assert_mesh(jout[0], tout[0])
        return
    # tensor metric: the smooth's pow / sqrt round in the last ulp apart
    # from XLA's and move a few vertices to other points (ROADMAP queue C)
    got = tmesh.mesh_to_numpy(tout[0])
    for f in jmesh.MESH_FIELDS:
        if f != "vert":
            assert np.array_equal(got[f], np.asarray(getattr(jout[0], f))), f
    jv = np.asarray(jout[0].vert)
    off = ~np.isclose(got["vert"], jv, rtol=1e-5, atol=1e-6).all(axis=1)
    assert off.sum() <= 4 and np.abs(got["vert"] - jv).max() < 1e-2


@pytest.fixture(scope="module")
def blocks3(state, eager):
    """adapt_mesh(cycle_block=3, max_cycles=12) on cube_mesh(3): eager
    JAX's (mesh, met, stats, block rows) and the port's (mesh, met, block
    rows)."""
    tm, met = _cube3(state)
    rows = []
    auto = TV.adapt_cycles_auto

    def rec(*a, **k):
        out = auto(*a, **k)
        rows.append(out[4].tolist())
        return out
    mp = pytest.MonkeyPatch()
    mp.setattr(TV, "adapt_cycles_auto", rec)
    try:
        tm, tk, _ = TAd.adapt_mesh(tm, met, max_cycles=12, cycle_block=3)
    finally:
        mp.undo()
    return eager["adapt_mesh"](), (tm, tk, rows)


def _stats(mesh, met):
    q = tet_quality(mesh, met).numpy()[mesh.tmask.numpy()]
    return len(q), float(q.min()), float(q.mean())


def test_adapt_mesh_block3_first_block_exact(blocks3):
    (_, _, _, jrows), (_, _, trows) = blocks3
    assert len(jrows) >= 2 and len(trows) >= 2
    assert trows[0] == jrows[0]
    assert sum(r[7] for rows in jrows for r in rows) >= 1
    assert sum(r[7] for rows in trows for r in rows) >= 1


def test_adapt_mesh_block3_statistics(blocks3):
    (jm, jk, _, _), (tm, tk, _) = blocks3
    nj, qminj, qmeanj = _stats(_from_jax(jm), torch.from_numpy(
        np.array(jk)))
    nt, qmint, qmeant = _stats(tm, tk)
    assert abs(nt - nj) <= 0.02 * nj
    assert abs(qmint - qminj) <= 0.05 and abs(qmeant - qmeanj) <= 0.02
    assert qmint > 0


def test_adapt_mesh_block3_conforming(blocks3):
    _, (tm, _, _) = blocks3
    _assert_conforming(tm)


def _assert_conforming(m):
    m = TA.build_adjacency(m)
    assert TA.check_adjacency(m) == {"asymmetric": 0, "face_mismatch": 0}
    vols = tmesh.tet_volumes(m)[m.tmask]
    assert bool((vols > 0).all())
    return float(vols.double().sum())
