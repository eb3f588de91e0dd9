"""The tensor-metric (anisotropic) path of the port held against the JAX
package on the same numpy inputs.

Pieces: K2's wrapper (its plain version on the CPU) against
``edge_length_ani_pallas`` in interpret mode, rtol 3e-5 / atol 3e-6 (the
JAX package's own tolerance for this kernel, tests/test_pallas.py: the
CUDA kernel contracts multiply-adds into FMAs and sums the quadratic form
in the Pallas kernel's order, not einsum's), on random ids, on the rows
``unique_edges`` gives it (runs of equal edges, every row of a run with
its head's bits, and an INT32_MAX tail) and on NaN / +-inf rows (NaN
where the Pallas kernel gives NaN); ``edge_length_ani`` and
``tet_edge_lengths`` to rtol 3e-6 (torch's and XLA's einsum sum the
quadratic form in another order: a few ulp), ``iso_to_tensor`` to 1e-6;
the eigenvalue clamp of ``clamp_metric`` and of ``apply_local_params`` to
2e-6 of each tensor's largest entry (float32 eigendecompositions by
another LAPACK path; a repeated eigenvalue leaves the eigenvectors free but
V diag(w) V^T unique up to rounding); the tensor-metric API surface.

The whole slice: the CLI remesh of cube_mesh(3) under the planar shock
tensor metric ``analytic_ani_metric(vert, "shock", h=0.15, h_tan=0.45)``
with ``-niter 1``, through ``parmmg_tpu.cli.main`` (jitted) and
``parmmg_tpu_torch.cli.main(..., "-device", "cpu")``.  The first cycle's
counts row is equal.  Past it the run never meets the convergence test (50
cycles of a few splits and collapses each), and last-ulp rounding alone
moves the final count: measured on this input, the JAX CLI 754 tets /
qmin 0.2074 / qmean 0.6123; the same JAX code eagerly (``jax.disable_jit``)
689 / 0.2296 / 0.6114, its per-cycle counts equal to the port's for the
first nine cycles; the port 607 / 0.2149 / 0.6157, and 680 / 0.1748 /
0.6275 with its tensor quality summed by ``torch.einsum`` and
``torch.linalg.det`` (last-ulp differences only).  So the tet count is
held within 20% of the JAX CLI's (the 607-754 span of these four runs),
qmin within 0.05 and qmean within 0.02; the port's output is conforming
and its ``.sol`` has 6 components per vertex.  On cube_mesh(16) under the
same kind of metric the counts agree to 0.3% (``chip_smoke.py``).
"""
import contextlib
import io
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.ops import pallas_kernels as pk
from parmmg_tpu.ops import quality as JQ
from parmmg_tpu_torch.ops import kernels as K
from parmmg_tpu_torch.ops import quality as TQ
from parmmg_tpu_torch.io.medit import MeditMesh, read_mesh, read_sol, \
    write_mesh, write_sol
from parmmg_tpu_torch.utils.fixtures import analytic_ani_metric, cube_mesh
from torch_parity import jax_ledger_listener_compat  # noqa: F401


def _spd(rng, n, repeated=False):
    """[n, 6] packed random SPD tensors (float32); ``repeated`` gives
    every other tensor a double eigenvalue."""
    a = rng.standard_normal((n, 3, 3))
    q, _ = np.linalg.qr(a)
    w = np.exp(rng.uniform(-4.0, 6.0, (n, 3)))
    if repeated:
        w[::2, 2] = w[::2, 1]
    m = np.einsum("nij,nj,nkj->nik", q, w, q)
    return np.ascontiguousarray(
        m[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]], dtype=np.float32)


def _assert_tensors_close(got, ref, rel=2e-6):
    """Packed tensors equal to ``rel`` of each tensor's largest entry."""
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - ref) <= rel * scale + 1e-30), \
        float((np.abs(got - ref) / scale).max())


# ---- K2 and the quality helpers ---------------------------------------------

@pytest.mark.parametrize("n", [1, 130, 3000])
def test_edge_lengths_ani_matches_pallas(n):
    rng = np.random.default_rng(100 + n)
    P = 500
    vert = rng.random((P, 3)).astype(np.float32)
    met6 = _spd(rng, P, repeated=True)
    ev = rng.integers(-3, P + 3, (n, 2)).astype(np.int32)  # clipped ids
    i0, i1 = np.clip(ev[:, 0], 0, P - 1), np.clip(ev[:, 1], 0, P - 1)
    ref = np.asarray(pk.edge_length_ani_pallas(
        jnp.asarray(vert[i0]), jnp.asarray(vert[i1]), jnp.asarray(met6[i0]),
        jnp.asarray(met6[i1]), interpret=True))
    got = K.edge_lengths_ani(torch.from_numpy(vert), torch.from_numpy(met6),
                             torch.from_numpy(ev)).numpy()
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("dead", [0.0, 0.2, 0.6])
def test_edge_lengths_ani_on_the_edge_table_matches_pallas(dead):
    """K2 on the rows the path gives it: ``unique_edges(mesh,
    shell_slots=0).ev`` of a cube_mesh(3) mesh with a share ``dead`` of its
    tets dead and spare tet slots, so the rows hold runs of equal edges and
    an INT32_MAX tail.  Every row against the Pallas kernel on the same
    clipped endpoints, and every row of a run carries its head's bits: what
    the CUDA kernel's one evaluation a run relies on."""
    from parmmg_tpu_torch.core.constants import INT32_MAX
    from parmmg_tpu_torch.core.mesh import make_mesh
    from parmmg_tpu_torch.ops.edges import unique_edges
    rng = np.random.default_rng(31)
    vert, tet = cube_mesh(3)
    mesh = make_mesh(vert, tet, capT=len(tet) + 40)
    mesh.tmask[:len(tet)][torch.from_numpy(rng.random(len(tet)) < dead)] = \
        False
    capP = mesh.capP
    met6 = _spd(rng, capP)
    ev = unique_edges(mesh, shell_slots=0).ev
    e = ev.numpy()
    assert e.shape == (6 * mesh.capT, 2) and (e[-1] == INT32_MAX).all()
    c = np.clip(e, 0, capP - 1)
    head = np.ones(len(c), bool)
    head[1:] = (c[1:] != c[:-1]).any(axis=1)
    assert head.sum() < len(c) // 2          # runs, and a long tail
    pv = mesh.vert.numpy()
    ref = np.asarray(pk.edge_length_ani_pallas(
        jnp.asarray(pv[c[:, 0]]), jnp.asarray(pv[c[:, 1]]),
        jnp.asarray(met6[c[:, 0]]), jnp.asarray(met6[c[:, 1]]),
        interpret=True))
    got = K.edge_lengths_ani(mesh.vert, torch.from_numpy(met6), ev).numpy()
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-6)
    src = np.maximum.accumulate(np.where(head, np.arange(len(c)), 0))
    bits = got.view(np.int32)
    assert (bits == bits[src]).all()


def test_edge_lengths_ani_keeps_nan_forms_nan_as_pallas():
    """A NaN or +-inf point or tensor row: the port's K2 (plain here, the
    CUDA kernel held to it on the card) gives NaN where the Pallas kernel
    does, since max(q, 0) keeps a NaN form NaN (CUDA's ``fmaxf(NaN, 0)``
    is 0: the kernel before gave such an edge length 0)."""
    rng = np.random.default_rng(5)
    P, n = 60, 400
    vert = rng.random((P, 3)).astype(np.float32)
    met6 = _spd(rng, P)
    vert[3, 0], vert[7, 1], vert[11, 2] = np.nan, np.inf, -np.inf
    met6[5, 0], met6[9, 2], met6[13, 4] = np.nan, np.inf, -np.inf
    ev = rng.integers(0, P, (n, 2)).astype(np.int32)
    ev[:20] = [[3, 4], [4, 3], [5, 6], [6, 5], [7, 8], [9, 10], [11, 12],
               [13, 14], [3, 3], [5, 5], [9, 9], [7, 7], [0, 3], [0, 5],
               [0, 7], [0, 9], [0, 11], [0, 13], [1, 2], [2, 1]]
    ref = np.asarray(pk.edge_length_ani_pallas(
        jnp.asarray(vert[ev[:, 0]]), jnp.asarray(vert[ev[:, 1]]),
        jnp.asarray(met6[ev[:, 0]]), jnp.asarray(met6[ev[:, 1]]),
        interpret=True))
    got = K.edge_lengths_ani(torch.from_numpy(vert), torch.from_numpy(met6),
                             torch.from_numpy(ev)).numpy()
    assert np.isnan(ref[:18]).sum() >= 10
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-6,
                               equal_nan=True)


def test_edge_lengths_iso_keeps_nan_as_pallas():
    """K1 on NaN and +-inf point and size rows: the port's wrapper (plain
    here, the CUDA kernel held to it on the card) gives NaN where the
    Pallas kernel does and its value elsewhere (every clamp keeps NaN, as
    ``jnp.maximum`` does; CUDA's ``fmaxf(NaN, x)`` is x, and the kernel
    before gave a NaN point length 0 and a NaN size a finite length).  A
    -inf size clamps to EPSD before the ratio, as in the Pallas kernel."""
    rng = np.random.default_rng(5)
    P, n = 60, 400
    vert = rng.random((P, 3)).astype(np.float32)
    met = (rng.random(P) + 0.05).astype(np.float32)
    vert[3, 0], vert[7, 1], vert[11, 2] = np.nan, np.inf, -np.inf
    met[5], met[9], met[13] = np.nan, np.inf, -np.inf
    ev = rng.integers(0, P, (n, 2)).astype(np.int32)
    ev[:20] = [[3, 4], [4, 3], [5, 6], [6, 5], [7, 8], [9, 10], [11, 12],
               [13, 14], [3, 3], [5, 5], [9, 9], [7, 7], [0, 3], [0, 5],
               [0, 7], [0, 9], [0, 11], [0, 13], [1, 2], [2, 1]]
    ref = np.asarray(pk.edge_length_iso_pallas(
        jnp.asarray(vert[ev[:, 0]]), jnp.asarray(vert[ev[:, 1]]),
        jnp.asarray(met[ev[:, 0]]), jnp.asarray(met[ev[:, 1]]),
        interpret=True))
    got = K.edge_lengths_iso(torch.from_numpy(vert), torch.from_numpy(met),
                             torch.from_numpy(ev)).numpy()
    assert np.isnan(ref[:20]).sum() >= 10 and np.isinf(ref[:20]).any()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6,
                               equal_nan=True)


def test_edge_length_ani_and_iso_to_tensor_match_jax():
    rng = np.random.default_rng(3)
    n = 400
    p0, p1 = (rng.random((n, 3)).astype(np.float32) for _ in range(2))
    m0, m1 = _spd(rng, n), _spd(rng, n, repeated=True)
    ref = np.asarray(JQ.edge_length_ani(*map(jnp.asarray, (p0, p1, m0, m1))))
    got = TQ.edge_length_ani(*map(torch.from_numpy, (p0, p1, m0, m1)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-6, atol=1e-7)
    h = (0.01 + rng.random(n)).astype(np.float32)
    h[:3] = 0.0                                          # the EPSD guard
    np.testing.assert_allclose(
        TQ.iso_to_tensor(torch.from_numpy(h)).numpy(),
        np.asarray(JQ.iso_to_tensor(jnp.asarray(h))), rtol=1e-6)


def test_quad_form_and_det3_round_as_jax():
    """The tensor quality's quadratic forms and 3x3 determinant give the
    same bits as ``jnp.einsum`` and ``jnp.linalg.det`` on the CPU."""
    rng = np.random.default_rng(5)
    m = rng.standard_normal((4000, 3, 3)).astype(np.float32)
    m = m + np.swapaxes(m, 1, 2)
    e = rng.standard_normal((4000, 6, 3)).astype(np.float32)
    tm, te = torch.from_numpy(m), torch.from_numpy(e)
    ref = np.asarray(jnp.einsum("...ei,...ij,...ej->...e", jnp.asarray(e),
                                jnp.asarray(m), jnp.asarray(e)))
    assert np.array_equal(TQ.quad_form(te, tm[:, None]).numpy(), ref)
    ref1 = np.asarray(jnp.einsum("...i,...ij,...j->...", jnp.asarray(e[:, 0]),
                                 jnp.asarray(m), jnp.asarray(e[:, 0])))
    assert np.array_equal(TQ.quad_form(te[:, 0], tm).numpy(), ref1)
    assert np.array_equal(TQ.det3(tm).numpy(),
                          np.asarray(jnp.linalg.det(jnp.asarray(m))))


def test_iso_tensor_gives_the_iso_length():
    """A constant iso size h and its tensor diag(1/h^2) measure every edge
    alike (the port's side of the JAX identity test)."""
    rng = np.random.default_rng(11)
    n = 200
    p0 = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
    p1 = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
    h = torch.full((n,), 0.2)
    m = TQ.iso_to_tensor(h)
    torch.testing.assert_close(TQ.edge_length_ani(p0, p1, m, m),
                               TQ.edge_length_iso(p0, p1, h, h),
                               rtol=1e-5, atol=1e-6)


def test_tet_edge_lengths_aniso_matches_jax():
    from parmmg_tpu.core import mesh as jmesh
    from parmmg_tpu_torch.core import mesh as tmesh
    v, t = cube_mesh(3)
    tm = tmesh.make_mesh(v, t, capP=80, capT=200)
    rng = np.random.default_rng(4)
    met6 = _spd(rng, tm.capP)
    jm = jmesh.Mesh(**{k: jnp.asarray(a) for k, a in
                       tmesh.mesh_to_numpy(tm).items()})
    ref = np.asarray(JQ.tet_edge_lengths(jm, jnp.asarray(met6)))
    got = TQ.tet_edge_lengths(tm, torch.from_numpy(met6)).numpy()
    live = tm.tmask.numpy()
    np.testing.assert_allclose(got[live], ref[live], rtol=3e-6)


# ---- metric clamps -----------------------------------------------------------

@pytest.mark.parametrize("repeated", [False, True])
def test_clamp_metric_tensor_matches_jax(repeated):
    from parmmg_tpu.ops.metric import clamp_metric as jclamp
    from parmmg_tpu_torch.ops.metric import clamp_metric as tclamp
    rng = np.random.default_rng(21 + repeated)
    met6 = _spd(rng, 2000, repeated)
    ref = np.asarray(jclamp(jnp.asarray(met6), 0.05, 2.0))
    got = tclamp(torch.from_numpy(met6), 0.05, 2.0).numpy()
    _assert_tensors_close(got, ref)
    # the clamp holds: every eigenvalue within [1/hmax^2, 1/hmin^2]
    w = np.linalg.eigvalsh(got[:, [[0, 1, 2], [1, 3, 4], [2, 4, 5]]]
                           .astype(np.float64))
    assert w.min() >= 0.25 * (1 - 1e-4) and w.max() <= 400.0 * (1 + 1e-4)


@pytest.mark.parametrize("tensor", [False, True])
def test_apply_local_params_matches_jax(tensor):
    from types import SimpleNamespace
    from parmmg_tpu import driver as JD
    from parmmg_tpu.core import mesh as jmesh
    from parmmg_tpu_torch import driver as TD
    from parmmg_tpu_torch.core import mesh as tmesh
    v, t = cube_mesh(3)
    tref = np.where(np.arange(len(t)) % 3 == 0, 2, 1).astype(np.int32)
    vref = np.where(v[:, 2] > 0.5, 7, 0).astype(np.int32)
    tm = tmesh.make_mesh(v, t, vref=vref, tref=tref, capP=80, capT=200)
    rng = np.random.default_rng(8)
    met = _spd(rng, tm.capP, repeated=True) if tensor else \
        rng.uniform(0.01, 1.0, tm.capP).astype(np.float32)
    info = SimpleNamespace(local_params=[(2, 2, 0.1, 0.5, 0.01),
                                         (0, 7, 0.3, 0.4, 0.01)])
    jm = jmesh.Mesh(**{k: jnp.asarray(a) for k, a in
                       tmesh.mesh_to_numpy(tm).items()})
    ref = np.asarray(JD.apply_local_params(jm, jnp.asarray(met), info))
    got = TD.apply_local_params(tm, torch.from_numpy(met), info).numpy()
    assert not np.array_equal(ref, met)                  # the clamp bit
    if tensor:
        _assert_tensors_close(got, ref)
    else:
        assert np.array_equal(got, ref)


# ---- the API surface ---------------------------------------------------------

def _parmesh(n=2, met=None, **info):
    from parmmg_tpu_torch.api import ParMesh
    v, t = cube_mesh(n)
    pm = ParMesh(device="cpu")
    pm.set_mesh_size(np_=len(v), ne=len(t))
    pm.set_vertices(v)
    pm.set_tetrahedra(t + 1, np.ones(len(t), np.int32))
    if met is not None:
        pm.set_met_size(3, len(v))
        pm.set_tensor_mets(met)
    for k, val in info.items():
        setattr(pm.info, k, val)
    return pm, v


def test_tensor_metric_round_trip():
    """set_tensor_mets -> run with every operator off -> get_tensor_mets
    gives the tensors back (a clamp that changes nothing, up to the float32
    eigendecomposition's rounding); set_tensor_met sets one row."""
    from parmmg_tpu_torch.core.constants import PMMG_SUCCESS
    v, _ = cube_mesh(2)
    met = analytic_ani_metric(v, "shock", h=0.2, h_tan=0.5)
    pm, _ = _parmesh(2, met, noinsert=True, noswap=True, nomove=True,
                     imprim=-1)
    pm.set_tensor_met(9.0, 0.5, 0.0, 4.0, 0.0, 4.0, pos=1)
    met[0] = (9.0, 0.5, 0.0, 4.0, 0.0, 4.0)
    assert pm.run() == PMMG_SUCCESS
    got = pm.get_tensor_mets()
    assert got.shape == (len(v), 6)
    _assert_tensors_close(got, met.astype(np.float32), rel=3e-6)
    assert pm.get_tensor_met(1) == pytest.approx(tuple(got[0]))


def test_optimles_with_tensor_metric_is_refused():
    import parmmg_tpu.api as japi
    from parmmg_tpu_torch.core.constants import PMMG_STRONGFAILURE
    v, t = cube_mesh(2)
    met = analytic_ani_metric(v, "shock", h=0.2, h_tan=0.5)
    pm, _ = _parmesh(2, met, optimLES=True, imprim=-1)
    assert pm.run() == PMMG_STRONGFAILURE
    jp = japi.ParMesh()
    jp.set_mesh_size(np_=len(v), ne=len(t))
    jp.set_vertices(v)
    jp.set_tetrahedra(t + 1, np.ones(len(t), np.int32))
    jp.set_met_size(3, len(v))
    jp.set_tensor_mets(met)
    jp.info.optimLES = True
    jp.info.imprim = -1
    assert jp.run() == PMMG_STRONGFAILURE


# ---- the whole slice ---------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import parmmg_tpu.cli as jcli
    import parmmg_tpu.ops.adapt as jadapt
    import parmmg_tpu_torch.cli as tcli
    import parmmg_tpu_torch.ops.adapt as tadapt
    d = tmp_path_factory.mktemp("aniso")
    v, t = cube_mesh(3)
    m = MeditMesh()
    m.vert, m.vref = v, np.zeros(len(v), np.int32)
    m.tetra, m.tref = t, np.ones(len(t), np.int32)
    src, sol = str(d / "cube3.mesh"), str(d / "cube3.sol")
    write_mesh(src, m)
    write_sol(sol, analytic_ani_metric(v, "shock", h=0.15, h_tan=0.45), [3])
    args = ["-in", src, "-sol", sol, "-niter", "1", "-v", "0",
            "-bench-json"]
    rows = {"jax": [], "torch": []}
    mp = pytest.MonkeyPatch()
    j_cycle, t_cycle = jadapt.adapt_cycle, tadapt.adapt_cycle_impl

    def j_rec(*a, **k):
        out = j_cycle(*a, **k)
        rows["jax"].append(np.asarray(out[2]).tolist())
        return out

    def t_rec(*a, **k):
        out = t_cycle(*a, **k)
        rows["torch"].append(out[2].tolist())
        return out

    mp.setattr(jadapt, "adapt_cycle", j_rec)
    mp.setattr(tadapt, "adapt_cycle_impl", t_rec)
    recs = {}
    try:
        for name, main in (("jax", jcli.main), ("torch", tcli.main)):
            out = str(d / f"{name}.mesh")
            extra = ["-device", "cpu"] if name == "torch" else []
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(args + ["-out", out] + extra)
            assert rc == 0, buf.getvalue()
            line = [ln for ln in buf.getvalue().splitlines()
                    if ln.startswith("{")][-1]
            recs[name] = dict(json.loads(line), out=out)
    finally:
        mp.undo()
    return recs, rows


def test_aniso_first_cycle_counts_equal(runs):
    _, rows = runs
    assert rows["jax"] and rows["torch"]
    assert rows["torch"][0] == rows["jax"][0]
    assert rows["torch"][0][0] > 0            # the cycle did split


def test_aniso_final_mesh_statistics_agree(runs):
    recs, _ = runs
    j, t = recs["jax"], recs["torch"]
    assert abs(t["ntets"] - j["ntets"]) <= 0.20 * j["ntets"]
    assert abs(t["qmin"] - j["qmin"]) <= 0.05
    assert abs(t["qmean"] - j["qmean"]) <= 0.02
    assert t["qmin"] > 0


def test_aniso_port_output_is_conforming(runs):
    from parmmg_tpu_torch.core.mesh import make_mesh, tet_volumes
    from parmmg_tpu_torch.ops.adjacency import build_adjacency, \
        check_adjacency
    recs, _ = runs
    mo = read_mesh(recs["torch"]["out"])
    assert len(mo.tetra) == recs["torch"]["ntets"]
    mesh = build_adjacency(make_mesh(mo.vert, mo.tetra))
    assert check_adjacency(mesh) == {"asymmetric": 0, "face_mismatch": 0}
    assert int(((tet_volumes(mesh) <= 0) & mesh.tmask).sum()) == 0
    vals, types = read_sol(recs["torch"]["out"][:-5] + ".sol")
    assert list(types) == [3] and vals.reshape(len(mo.vert), -1).shape[1] == 6
    assert np.isfinite(vals).all()
