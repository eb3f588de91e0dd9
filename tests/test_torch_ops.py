"""Port ops other than the waves held against the JAX package on the
same numpy inputs.  Exact (bit for bit): every integer / boolean / tag
array of unique_edges, build_adjacency (packed and 3-column face sorts),
boundary_edge_tags, analyze_mesh and the edge helpers.  Float outputs
(normals, tangents, metrics, qualities): rtol 1e-5 unless stated.  The
waves are in tests/test_torch_waves.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.ops import adjacency as JA, analysis as JN
from parmmg_tpu.ops import edges as JE, metric as JM, quality as JQ
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.core.constants import MG_BDY
from parmmg_tpu_torch.ops import adapt as TAd, adjacency as TA
from parmmg_tpu_torch.ops import analysis as TN
from parmmg_tpu_torch.ops import edges as TE, metric as TM, primitives
from parmmg_tpu_torch.ops import quality as TQ
from parmmg_tpu_torch.utils.fixtures import analytic_iso_metric, cube_mesh
from torch_parity import jax_ledger_listener_compat  # noqa: F401


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
    return {"sized": m, "jitter": jit, "met": met}


# ---- edges, adjacency, analysis ---------------------------------------------

@pytest.mark.parametrize("capP", [None, 50000])     # packed / 2-key sorts
def test_unique_edges_and_adjacency_exact(capP):
    tm = _cube(2, capP=capP)
    tm = tmesh.replace(tm, tmask=tm.tmask.clone().index_fill_(
        0, torch.tensor([3, 17, 40]), False))
    jm = _to_jax(tm)
    for slots in (0, 3, 6):
        je = _jit(JE.unique_edges, shell_slots=slots)(jm)
        te = TE.unique_edges(tm, shell_slots=slots)
        for f in je._fields:
            assert np.array_equal(_np(getattr(je, f)),
                                  getattr(te, f).numpy()), (slots, f)
    for a, b in zip(_jit(JA.face_sort)(jm), TA.face_sort(tm)):
        assert np.array_equal(np.asarray(a), b.numpy())
    ja, ta = _jit(JA.build_adjacency)(jm), TA.build_adjacency(tm)
    _assert_mesh(ja, ta)
    assert JA.check_adjacency(ja) == TA.check_adjacency(ta) == \
        {"asymmetric": 0, "face_mismatch": 0}
    _assert_mesh(_jit(JA.boundary_edge_tags)(ja),
                 TA.boundary_edge_tags(ta))


@pytest.mark.parametrize("angle", [None, -1.1])
def test_analyze_mesh_exact_and_normals(angle):
    v, t = cube_mesh(3)
    v = v.copy()
    v[:, 2] += 0.2 * v[:, 0] ** 2              # a curved top and bottom
    tm = tmesh.make_mesh(v, t)
    jm = _to_jax(tm)
    kw = {} if angle is None else {"angedg": angle}
    jr, tr = JN.analyze_mesh(jm, **kw), TN.analyze_mesh(tm, **kw)
    _assert_mesh(jr.mesh, tr.mesh)
    np.testing.assert_allclose(tr.vnormal.numpy(), np.asarray(jr.vnormal),
                               rtol=1e-5, atol=1e-6)
    jm2, tm2 = jr.mesh, tr.mesh
    np.testing.assert_allclose(TN.boundary_vertex_normals(tm2).numpy(),
                               np.asarray(_jit(JN.boundary_vertex_normals)(
                                   jm2)),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(_jit(JN.ridge_vertex_normals)(jm2),
                    TN.ridge_vertex_normals(tm2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(TN.ridge_vertex_tangents(tm2).numpy(),
                               np.asarray(_jit(JN.ridge_vertex_tangents)(jm2)),
                               rtol=1e-5, atol=1e-6)


def test_edge_helpers_exact():
    rng = np.random.default_rng(3)
    for n, salt in ((1, 0), (1000, 0), (777, 5)):
        assert np.array_equal(TE.tie_hash(n, salt).numpy(),
                              np.asarray(JE.tie_hash(n, salt)))
    assert TE.wave_budget(100000) == JE.wave_budget(100000)
    score = rng.integers(0, 5, 300).astype(np.float32)   # many ties
    mask = rng.random(300) > 0.3
    site = rng.integers(0, 40, 300).astype(np.int32)
    js, jt = JE.claim_channels(jnp.asarray(score), jnp.asarray(mask))
    ts, tt = TE.claim_channels(torch.from_numpy(score),
                               torch.from_numpy(mask))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for a, b in zip(JE.scatter_argmax2(jnp.asarray(site), js, jt,
                                       jnp.asarray(mask), 40),
                    TE.scatter_argmax2(torch.from_numpy(site), ts, tt,
                                       torch.from_numpy(mask), 40)):
        assert np.array_equal(b.numpy(), np.asarray(a))
    shells = [rng.integers(0, 50, 300).astype(np.int32) for _ in range(3)]
    assert np.array_equal(
        TE.claim_shells(torch.from_numpy(score), torch.from_numpy(mask),
                        [torch.from_numpy(s) for s in shells], 50).numpy(),
        np.asarray(JE.claim_shells(jnp.asarray(score), jnp.asarray(mask),
                                   [jnp.asarray(s) for s in shells], 50)))
    for K in (1, 100, 300):
        jv, ji = jax.lax.top_k(jnp.asarray(score), K)
        tv, ti = primitives.topk_lowest_index(torch.from_numpy(score), K)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
    first = rng.random(300) > 0.8
    first[0] = True
    vals = rng.integers(0, 1 << 10, 300).astype(np.int32)
    assert np.array_equal(
        TE.segmented_or(torch.from_numpy(first),
                        torch.from_numpy(vals)).numpy(),
        np.asarray(JE.segmented_or(jnp.asarray(first),
                                   jnp.asarray(vals.view(np.uint32))))
        .view(np.int32))
    assert np.array_equal(
        TE.segmented_max(torch.from_numpy(first),
                         torch.from_numpy(vals)).numpy(),
        np.asarray(JE.segmented_max(jnp.asarray(first), jnp.asarray(vals))))
    a = rng.integers(0, 60, 500).astype(np.int32)
    b = rng.integers(0, 60, 500).astype(np.int32)
    valid = rng.random(500) > 0.2
    for capP in (60, 50000):
        for x, y in zip(JE.sort_pairs(*map(jnp.asarray, (a, b, valid)),
                                      capP),
                        TE.sort_pairs(*map(torch.from_numpy, (a, b, valid)),
                                      capP)):
            assert np.array_equal(y.numpy(), np.asarray(x))
    jr, jn = JE.free_rows(jnp.asarray(mask), 150)
    tr, tn = TE.free_rows(torch.from_numpy(mask), 150)
    assert np.array_equal(tr.numpy(), np.asarray(jr)) and int(tn) == int(jn)
    pts = rng.random((200, 3)).astype(np.float32)
    assert np.array_equal(
        TE.morton_codes(torch.from_numpy(pts), torch.from_numpy(mask[:200]))
        .numpy(),
        np.asarray(JE.morton_codes(jnp.asarray(pts),
                                   jnp.asarray(mask[:200]))))
    c = torch.from_numpy(mask)
    v0, v1, v2 = (torch.from_numpy(rng.random(300).astype(np.float32))
                  for _ in range(3))
    for got, ref in ((TE.topk_prep(c, v0),
                      JE.topk_prep(jnp.asarray(mask), jnp.asarray(v0))),
                     (TE.topk_prep3(c, v0, v1, v2),
                      JE.topk_prep3(*map(jnp.asarray, (mask, v0, v1, v2))))):
        assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
        assert int(got[1]) == int(ref[1])


# ---- quality and metric -----------------------------------------------------

def test_quality_and_metric_match(states):
    tm, met = states["jitter"], states["met"]
    jm, jmet = _to_jax(tm), jnp.asarray(met.numpy())
    np.testing.assert_allclose(TQ.tet_quality(tm, met).numpy(),
                               np.asarray(_jit(JQ.tet_quality)(jm, jmet)),
                               rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(TQ.tet_edge_lengths(tm, met).numpy(),
                               np.asarray(JQ.tet_edge_lengths(jm, jmet)),
                               rtol=2e-5, atol=2e-6)
    q = TQ.tet_quality(tm, met)
    jh = JQ.quality_histogram(jnp.asarray(q.numpy()), jm.tmask)
    th = TQ.quality_histogram(q, tm.tmask)
    assert np.array_equal(th[0].numpy(), np.asarray(jh[0]))
    assert int(th[3]) == int(jh[3])
    np.testing.assert_allclose([float(th[1]), float(th[2])],
                               [float(jh[1]), float(jh[2])], rtol=1e-5)
    jl = _jit(JQ.length_histogram)(jm, jmet)
    tl = TQ.length_histogram(tm, met)
    assert np.array_equal(tl[0].numpy(), np.asarray(jl[0]))
    np.testing.assert_allclose([float(x) for x in tl[1:]],
                               [float(x) for x in jl[1:]], rtol=1e-5)
    np.testing.assert_allclose(TM.metric_optim(tm).numpy(),
                               np.asarray(_jit(JM.metric_optim)(jm)),
                               rtol=1e-5)
    shock = analytic_iso_metric(tm.vert.numpy().astype(np.float64),
                                "shock", 0.3).astype(np.float32)
    tmet = TM.clamp_metric(torch.from_numpy(shock), 0.02, 1.0)
    jmet2 = JM.clamp_metric(jnp.asarray(shock), 0.02, 1.0)
    np.testing.assert_array_equal(tmet.numpy(), np.asarray(jmet2))
    np.testing.assert_allclose(
        TM.hausd_metric_bound(tm, tmet, 0.001, 0.02).numpy(),
        np.asarray(JM.hausd_metric_bound(jm, jmet2, 0.001, 0.02)),
        rtol=1e-5)
    np.testing.assert_allclose(TM.gradation(tm, tmet, 1.3).numpy(),
                               np.asarray(_jit(JM.gradation, hgrad=1.3)(
                                   jm, jmet2)),
                               rtol=1e-5)
    assert np.array_equal(TM.metric_hsiz(tm, 0.25).numpy(),
                          np.asarray(JM.metric_hsiz(jm, 0.25)))
