"""Port ops held against the JAX package on the same numpy inputs.

Exact (bit for bit): every integer / boolean / tag array of unique_edges,
build_adjacency (packed and 3-column face sorts), boundary_edge_tags,
analyze_mesh, the edge helpers, and every integer array and count of each
wave's output mesh.  Float outputs: normals, tangents, metrics and
coordinates to rtol 1e-5 (float32 formulas evaluated in another order).

The waves are fed the SAME float inputs on both sides (the JAX edge table
and lengths for split / collapse), so a threshold decision can only flip
through a last-ulp quality difference.  One such tie is known and
documented (ROADMAP queue C): swapgen_wave evaluates every fan centre of
the ring, and for a 4-ring two centres give the same triangulation with
qualities that differ in the last ulp, so the two sides may write the same
new tets into different slots; swapgen is therefore compared by its
counts, its vertex arrays and the quality distribution of its live tets.
The wave inputs are states of a seeded cube run (mesh
adapted by the port for a few cycles, interior vertices jittered with
numpy's default_rng) so that every wave has work to do.

Every wave also runs on a tensor-metric (anisotropic) state: the same
jittered mesh under the planar shock tensor metric, its dead rows the
identity.  The integer arrays are held exactly there too, on the same
float inputs; the split's unique-edge lengths (K2's plain version against
XLA's einsum) to rtol 3e-5 / atol 3e-6, the JAX package's tolerance for
that kernel.  A port-only case shows that the dead metric rows do not
reach a live result: one whole cycle with garbage in them writes the same
mesh and the same live metric rows.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.ops import adjacency as JA, collapse as JC
from parmmg_tpu.ops import edges as JE
from parmmg_tpu.ops import smooth as JS, split as JP, swap as JW
from parmmg_tpu.ops import swapgen as JG
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.core.constants import MG_BDY
from parmmg_tpu_torch.ops import adapt as TAd, adjacency as TA
from parmmg_tpu_torch.ops import analysis as TN, collapse as TC
from parmmg_tpu_torch.ops import edges as TE
from parmmg_tpu_torch.ops import quality as TQ, smooth as TS, split as TP
from parmmg_tpu_torch.ops import swap as TW, swapgen as TG
from parmmg_tpu_torch.utils.fixtures import (analytic_ani_metric,
                                             analytic_iso_metric, cube_mesh)
from torch_parity import jax_ledger_listener_compat  # noqa: F401

IDENTITY6 = np.array([1, 0, 0, 1, 0, 1], np.float32)


def _jit(fn, **static):
    """The JAX function compiled as one program (eager JAX compiles every
    primitive on its own, which is many times slower here).  XLA's fused
    program may round floats differently from eager JAX; the waves whose
    float gates sit close to their thresholds on these inputs (smooth,
    swapgen) are compared against eager JAX, which the port follows op by
    op."""
    import functools
    return jax.jit(functools.partial(fn, **static))


def _to_jax(tm):
    f = tmesh.mesh_to_numpy(tm)
    return jmesh.Mesh(**{k: jnp.asarray(v) for k, v in f.items()})


def _from_jax(jm):
    return tmesh.mesh_from_numpy(
        {f: np.asarray(getattr(jm, f)) for f in jmesh.MESH_FIELDS})


def _np(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def _assert_mesh(jm, tm, vert_rtol=1e-5):
    got = tmesh.mesh_to_numpy(tm)
    for f in jmesh.MESH_FIELDS:
        a = np.asarray(getattr(jm, f))
        if f == "vert":
            np.testing.assert_allclose(got[f], a, rtol=vert_rtol, atol=1e-6)
        else:
            assert np.array_equal(got[f], a), f


def _cube(n, capP=None, capT=None):
    v, t = cube_mesh(n)
    return tmesh.make_mesh(v, t, capP=capP, capT=capT)


@pytest.fixture(scope="module")
def states():
    """Seeded cube(3) states: ``sized`` after 3 port cycles at h=0.3,
    ``jitter`` the same with interior vertices moved by N(0, 0.06)."""
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
    for amp in (0.02, 0.04, 0.06):      # three draws, the last one kept
        vert = m.vert.numpy().copy()
        vert[inner] += (rng.standard_normal((inner.sum(), 3))
                        * amp).astype(np.float32)
    jit = tmesh.replace(m, vert=torch.from_numpy(vert))
    met6 = analytic_ani_metric(vert.astype(np.float64), "shock", h=0.3,
                               h_tan=0.6).astype(np.float32)
    met6[~m.vmask.numpy()] = IDENTITY6
    return {"sized": m, "jitter": jit, "met": met,
            "met6": torch.from_numpy(met6)}


def _state_met(states, aniso):
    return states["met6"] if aniso else states["met"]


# ---- waves ----------------------------------------------------------------

@pytest.mark.parametrize("case", [(2, 0.25, "uniform"), (3, 0.3, "shock"),
                                  (3, 0.15, "ani-shock")])
def test_split_then_collapse_exact(case):
    n, h, kind = case
    tm = TN.analyze_mesh(_cube(n)).mesh
    jm = _to_jax(tm)
    v64 = tm.vert.numpy().astype(np.float64)
    if kind.startswith("ani-"):
        met = analytic_ani_metric(v64, kind[4:], h, h_tan=0.45)
        met[~tm.vmask.numpy()] = IDENTITY6
        tol = dict(rtol=3e-5, atol=3e-6)
    else:
        met = analytic_iso_metric(v64, kind, h)
        tol = dict(rtol=2e-5, atol=2e-6)
    met = met.astype(np.float32)
    jmet, tmet = jnp.asarray(met), torch.from_numpy(met)
    jet = _jit(JE.unique_edges, shell_slots=0)(jm)
    jl = _jit(JE.edge_lengths)(jm, jet, jmet)
    tet = TE.unique_edges(tm, shell_slots=0)
    tl = torch.from_numpy(np.array(jl))
    live = tet.emask.numpy()
    np.testing.assert_allclose(TE.edge_lengths(tm, tet, tmet).numpy()[live],
                               np.asarray(jl)[live], **tol)
    jr = _jit(JP.split_wave, hausd=0.01)(jm, jmet, et=jet, lens=jl)
    tr = TP.split_wave(tm, tmet, hausd=0.01, et=tet, lens=tl)
    assert int(tr.nsplit) == int(jr.nsplit) > 0
    assert bool(tr.overflow) == bool(jr.overflow)
    assert bool(tr.deferred) == bool(jr.deferred)
    assert np.array_equal(tr.modified.numpy(), np.asarray(jr.modified))
    _assert_mesh(jr.mesh, tr.mesh)
    np.testing.assert_allclose(tr.met.numpy(), np.asarray(jr.met),
                               rtol=1e-6)
    jc = _jit(JC.collapse_wave, hausd=0.01)(jr.mesh, jr.met, et=jet,
                                            lens=jl,
                                            stale_tets=jr.modified)
    tc = TC.collapse_wave(_from_jax(jr.mesh),
                          torch.from_numpy(np.asarray(jr.met)), hausd=0.01,
                          et=tet, lens=tl, stale_tets=tr.modified)
    assert int(tc.ncollapse) == int(jc.ncollapse)
    assert bool(tc.surface_changed) == bool(jc.surface_changed)
    _assert_mesh(jc.mesh, tc.mesh)
    # tensor metric: eager, where the unique-edge lengths round as the
    # port's own do (the fused program's round differently, and the FEM
    # wave's top-K order follows them)
    kw = dict(fem_only=True, budget_div=2)
    jf = JP.split_wave(jm, jmet, **kw) if kind.startswith("ani-") else \
        _jit(JP.split_wave, **kw)(jm, jmet)
    tf = TP.split_wave(tm, tmet, **kw)
    assert int(tf.nsplit) == int(jf.nsplit)
    _assert_mesh(jf.mesh, tf.mesh)


@pytest.mark.parametrize("sliver_q,aniso", [
    pytest.param(None, False, id="None"), pytest.param(0.3, False, id="0.3"),
    pytest.param(None, True, id="None-aniso"),
    pytest.param(0.3, True, id="0.3-aniso")])
def test_collapse_exact(states, sliver_q, aniso):
    tm, met = states["jitter"], _state_met(states, aniso)
    jm, jmet = _to_jax(tm), jnp.asarray(met.numpy())
    # tensor metric: eager, the fused program rounds the ball-quality gate
    # differently
    kw = dict(sliver_q=sliver_q, hausd=0.01, budget_div=2)
    jc = JC.collapse_wave(jm, jmet, **kw) if aniso else \
        _jit(JC.collapse_wave, **kw)(jm, jmet)
    tc = TC.collapse_wave(tm, met, sliver_q=sliver_q, hausd=0.01,
                          budget_div=2)
    assert int(tc.ncollapse) == int(jc.ncollapse) > 0
    assert bool(tc.deferred) == bool(jc.deferred)
    _assert_mesh(jc.mesh, tc.mesh)


def test_swaps_exact(states):
    _check_swaps(states["jitter"], states["met"])


def test_swaps_exact_aniso(states):
    _check_swaps(states["jitter"], states["met6"])


def _check_swaps(tm, met):
    jm, jmet = _to_jax(tm), jnp.asarray(met.numpy())
    jw = _jit(JW.swap_edges_wave, hausd=0.01)(jm, jmet)
    tw = TW.swap_edges_wave(tm, met, hausd=0.01)
    assert int(tw.nswap) == int(jw.nswap) > 0
    _assert_mesh(jw.mesh, tw.mesh)
    ja = _jit(JA.build_adjacency)(jw.mesh)
    ta = TA.build_adjacency(tw.mesh)
    _assert_mesh(ja, ta)
    j23, t23 = _jit(JW.swap23_wave)(ja, jmet), TW.swap23_wave(ta, met)
    assert int(t23.nswap) == int(j23.nswap) > 0
    assert bool(t23.deferred) == bool(j23.deferred)
    _assert_mesh(j23.mesh, t23.mesh)


def test_swapgen_same_result_up_to_fan_ties(states):
    """Counts and sizes exact; the chosen fans may differ where two fans
    of a ring tie to the last ulp (module docstring), so the meshes are
    compared by their quality distribution, not slot by slot."""
    _check_swapgen(states["jitter"], states["met"])


def test_swapgen_same_result_up_to_fan_ties_aniso(states):
    _check_swapgen(states["jitter"], states["met6"])


def _check_swapgen(tm, met):
    jm, jmet = _to_jax(tm), jnp.asarray(met.numpy())
    # eager: the fused XLA program rounds the ring qualities differently
    jg = JG.swapgen_wave(jm, jmet, budget_div=2)
    tg = TG.swapgen_wave(tm, met, budget_div=2)
    assert int(tg.nswap) == int(jg.nswap) > 0
    assert np.array_equal(tg.mesh.vmask.numpy(), np.asarray(jg.mesh.vmask))
    assert np.array_equal(tg.mesh.vert.numpy(), np.asarray(jg.mesh.vert))
    assert int(tg.mesh.tmask.sum()) == int(jnp.sum(jg.mesh.tmask))
    qt = TQ.tet_quality(tg.mesh).numpy()[tg.mesh.tmask.numpy()]
    qj = TQ.tet_quality(_from_jax(jg.mesh)).numpy()[
        np.asarray(jg.mesh.tmask)]
    np.testing.assert_allclose(qt.min(), qj.min(), rtol=1e-5)
    np.testing.assert_allclose(qt.mean(), qj.mean(), rtol=1e-3)
    assert TA.check_adjacency(TA.build_adjacency(tg.mesh)) == \
        {"asymmetric": 0, "face_mismatch": 0}


@pytest.mark.parametrize("wave,opt_q,aniso", [
    pytest.param(3, None, False, id="3-None"),
    pytest.param(7, 0.2, False, id="7-0.2"),
    pytest.param(3, None, True, id="3-None-aniso"),
    pytest.param(7, 0.2, True, id="7-0.2-aniso")])
def test_smooth_exact(states, wave, opt_q, aniso):
    tm, met = states["jitter"], _state_met(states, aniso)
    jm, jmet = _to_jax(tm), jnp.asarray(met.numpy())
    # eager: the fused XLA program rounds the 2% gain gate differently
    js = JS.smooth_wave(jm, jmet, wave=wave, opt_q=opt_q)
    ts = TS.smooth_wave(tm, met, wave=wave, opt_q=opt_q)
    assert int(ts.nmoved) == int(js.nmoved) > 0
    _assert_mesh(js.mesh, ts.mesh)


def test_dead_metric_rows_reach_no_live_result(states):
    """One whole tensor-metric cycle (split, collapse, swaps, smooth) with
    the dead metric rows the identity, then garbage: the same mesh and the
    same live metric rows."""
    tm, met6 = states["jitter"], states["met6"]
    dead = ~tm.vmask
    rng = np.random.default_rng(9)
    junk = met6.clone()
    junk[dead] = torch.from_numpy(
        rng.uniform(-1e4, 1e4, (int(dead.sum()), 6)).astype(np.float32))
    outs = [TAd.adapt_cycle_impl(tm, m, 2, hausd=0.01) for m in (met6, junk)]
    (ma, meta, ca), (mb, metb, cb) = outs
    assert ca.tolist() == cb.tolist() and ca[0] > 0 and ca[2] > 0
    _assert_mesh(_to_jax(ma), mb, vert_rtol=0)
    live = ma.vmask
    assert torch.equal(meta[live], metb[live])
