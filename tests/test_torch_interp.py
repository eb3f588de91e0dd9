"""The port's curved fixtures and ``ops/interp`` against the JAX
package's, on the same seeded numpy inputs (CPU):

- the fixtures are equal arrays;
- ``surface_triangulation`` is bit-equal (its edge pairing runs on the
  port's sort engine, K7 + K8, for both the packed and two-word keys);
- ``locate_points`` / ``locate_points_bdy``: equal ``failed`` and step
  counts, equal ``tet`` wherever the smallest barycentric exceeds 1e-3
  (elsewhere a point on a shared face may land in either tet), ``bary``
  within 1e-5;
- ``interp_p1*`` and ``interp_metric_ani*`` within 1e-5 relative;
- ``interpolate_from_background`` and ``driver.interpolate_fields``
  (the latter on a real remesh with fields) within 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.ops import analysis as JN
from parmmg_tpu.ops import interp as JI
from parmmg_tpu.utils import fixtures as jfix
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.ops import interp as TI
from parmmg_tpu_torch.utils import fixtures as tfix
from torch_parity import jax_ledger_listener_compat  # noqa: F401

RTOL = 1e-5


@pytest.mark.parametrize("name,args", [
    ("sphere_mesh", (4,)), ("sphere_mesh", (16,)), ("torus_mesh", ()),
    ("torus_mesh", (8, 3, 2.0, 0.5)), ("cylinder_mesh", (3,)),
    ("cylinder_mesh", (6, 0.5))])
def test_fixtures_equal(name, args):
    got, want = getattr(tfix, name)(*args), getattr(jfix, name)(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    v, t = tfix.cube_mesh(2)
    assert np.array_equal(tfix._orient_positive(v * [1, -1, 1], t),
                          jfix._orient_positive(v * [1, -1, 1], t))


def _pair(name, capP=None):
    """(JAX mesh, port mesh) of an analysed fixture, at twice its size
    (or ``capP`` vertex slots)."""
    v, t = {"sphere4": lambda: tfix.sphere_mesh(4),
            "cube3": lambda: tfix.cube_mesh(3),
            "cube2": lambda: tfix.cube_mesh(2),
            "torus": lambda: tfix.torus_mesh()}[name]()
    jm = jmesh.make_mesh(v, t, capP=capP or 2 * len(v), capT=2 * len(t))
    jm = JN.analyze_mesh(jm).mesh
    tm = tmesh.mesh_from_numpy({f: np.asarray(getattr(jm, f))
                                for f in jmesh.MESH_FIELDS})
    return jm, tm


def _to_jax(tm):
    f = tmesh.mesh_to_numpy(tm)
    return jmesh.Mesh(**{k: jnp.asarray(v) for k, v in f.items()})


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, err


@pytest.mark.parametrize("name,capP", [("sphere4", None), ("torus", None),
                                       ("cube3", 50000)])
def test_surface_triangulation_bit_equal(name, capP):
    jm, tm = _pair(name, capP)
    for a, b in zip(JI.surface_triangulation(jm),
                    TI.surface_triangulation(tm)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())


def _query(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "box":
        return rng.uniform(-1.15, 1.15, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _check_locate(jl, tl):
    jt, jb, jf, js = (np.asarray(x) for x in jl)
    tt, tb, tf, ts = (x.numpy() for x in tl)
    assert np.array_equal(jf, tf) and np.array_equal(js, ts)
    inside = jb.min(1) > 1e-3
    assert np.array_equal(jt[inside], tt[inside])
    assert np.abs(jb - tb).max() <= 1e-5
    return jf.sum(), inside.sum()


@pytest.mark.parametrize("name,kind", [("sphere4", "box"),
                                       ("sphere4", "surface"),
                                       ("cube3", "cube2")])
def test_locate_points_matches(name, kind):
    jm, tm = _pair(name)
    if kind == "cube2":
        # the cube pair: cube(2)'s vertices (on faces, edges and corners
        # of cube(3)'s tets) and interior points in cube(3)
        pts = np.concatenate([tfix.cube_mesh(2)[0],
                              _query("box", 60, 2) * 0.4 + 0.5])
        pts = pts.astype(np.float32)
    else:
        # a shell just inside the unit sphere, and the box around it
        pts = _query(kind, 300, 1) * (0.92 if kind == "surface" else 1.0)
    start = np.random.default_rng(3).integers(
        0, int(tm.tmask.sum()), len(pts)).astype(np.int32)
    for st in (np.zeros(len(pts), np.int32), start):
        jl = JI.locate_points(jm, jnp.asarray(pts), jnp.asarray(st))
        tl = TI.locate_points(tm, torch.from_numpy(pts), torch.from_numpy(st))
        nfail, ninside = _check_locate(jl, tl)
        assert ninside > len(pts) // 4
        if kind == "box":
            assert nfail > 0                # the fallback ran
    vals = np.asarray(jm.vert, np.float64) @ [1.5, -2.0, 0.5] + 0.25
    _close(TI.interp_p1(torch.from_numpy(vals.astype(np.float32)), tm.tet,
                        tl).numpy(),
           JI.interp_p1(jnp.asarray(vals), jm.tet, jl))
    vec = np.stack([vals, 2 * vals, -vals], 1)
    _close(TI.interp_p1(torch.from_numpy(vec.astype(np.float32)), tm.tet,
                        tl).numpy(),
           JI.interp_p1(jnp.asarray(vec), jm.tet, jl))
    met6 = _tensors(jm.capP, 4)
    _close(TI.interp_metric_ani(torch.from_numpy(met6), tm.tet, tl).numpy(),
           JI.interp_metric_ani(jnp.asarray(met6), jm.tet, jl))


def _tensors(n, seed):
    """Symmetric positive-definite packed tensors of mixed scale."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3))
    m = np.einsum("nij,nkj->nik", a, a) + np.eye(3) * rng.uniform(
        1, 50, (n, 1, 1))
    return m[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].astype(np.float32)


@pytest.mark.parametrize("name", ["sphere4", "torus"])
def test_locate_points_bdy_matches(name):
    jm, tm = _pair(name)
    if name == "torus":
        u, w = np.random.default_rng(4).uniform(0, 2 * np.pi, (2, 200))
        pts = np.stack([(1 + 0.4 * np.cos(w)) * np.cos(u),
                        (1 + 0.4 * np.cos(w)) * np.sin(u),
                        0.4 * np.sin(w)], 1).astype(np.float32)
    else:
        pts = _query("surface", 200, 5)
    jl = JI.locate_points_bdy(jm, jnp.asarray(pts))
    tl = TI.locate_points_bdy(tm, torch.from_numpy(pts))
    jt, jb, jd, jf = (np.asarray(x) for x in jl)
    tt, tb, td, tf = (x.numpy() for x in tl)
    assert np.array_equal(jf, tf)
    inside = jb.min(1) > 1e-3
    assert inside.sum() > len(pts) // 4
    assert np.array_equal(jt[inside], tt[inside])
    assert np.abs(jb - tb).max() <= 1e-5 and np.abs(jd - td).max() <= 1e-5
    vals = np.asarray(jm.vert, np.float64) @ [0.7, -1.1, 0.4]
    _close(TI.interp_p1_tri(torch.from_numpy(vals.astype(np.float32)), tm,
                            tl).numpy(),
           JI.interp_p1_tri(jnp.asarray(vals), jm, jl))
    met6 = _tensors(jm.capP, 6)
    _close(TI.interp_metric_ani_tri(torch.from_numpy(met6), tm, tl).numpy(),
           JI.interp_metric_ani_tri(jnp.asarray(met6), jm, jl))
    st = np.random.default_rng(7).integers(0, 4 * jm.capT, len(pts))
    jl = JI.locate_points_bdy(jm, jnp.asarray(pts), jnp.asarray(st, jnp.int32))
    tl = TI.locate_points_bdy(tm, torch.from_numpy(pts),
                              torch.from_numpy(st.astype(np.int32)))
    assert np.array_equal(np.asarray(jl.failed), tl.failed.numpy())
    assert np.abs(np.asarray(jl.bary) - tl.bary.numpy()).max() <= 1e-5


@pytest.mark.parametrize("aniso", [False, True])
def test_interpolate_from_background_matches(aniso):
    """The cube pair of the JAX package's own test: cube(3) background,
    cube(2) target, every live vertex overwritten; and with ``only_new``
    a subset, the rest keeping its value."""
    jbg, tbg = _pair("cube3")
    jmsh, tmsh = _pair("cube2")
    if aniso:
        bg_met = _tensors(jbg.capP, 8)
        met = np.tile(np.float32([9, 0, 0, 9, 0, 9]), (jmsh.capP, 1))
    else:
        bg_met = np.linspace(0.1, 0.5, jbg.capP).astype(np.float32)
        met = np.full(jmsh.capP, 99.0, np.float32)
    fields = np.stack([np.asarray(jbg.vert)[:, 0] * 3 - 1,
                       np.linspace(-2, 2, jbg.capP)], 1).astype(np.float32)
    only = np.arange(jmsh.capP) % 3 != 0
    for sel in (None, only):
        j = JI.interpolate_from_background(
            jbg, jnp.asarray(bg_met), jmsh, jnp.asarray(met),
            jnp.asarray(fields), None if sel is None else jnp.asarray(sel))
        t = TI.interpolate_from_background(
            tbg, torch.from_numpy(bg_met), tmsh, torch.from_numpy(met),
            torch.from_numpy(fields),
            None if sel is None else torch.from_numpy(sel))
        _close(t[0].numpy(), j[0])
        _close(t[1].numpy(), j[1])
        _check_locate(j[2], t[2])
        vm = tmsh.vmask.numpy()
        keep = ~vm if sel is None else ~(sel & vm)
        assert np.array_equal(t[0].numpy()[keep], met[keep])


def test_interpolate_fields_matches_on_a_remesh():
    """A real remesh with fields through the port's ParMesh (sphere_mesh(3)
    under a coarse ball metric, CPU): the port's field step and the JAX
    package's ``interpolate_fields`` on the same background and output
    meshes agree within 1e-5 at every output vertex but the surface
    ties: a boundary point on (or just past) an edge of the background
    surface lies within the walk's tolerance of both triangles of that
    edge, and at the same distance from both, so which one the walk
    reaches first, or the closest-triangle search keeps, turns on the
    last ulp of a barycentric or a distance.  Each such vertex is checked
    to be that tie (the two landings share an edge and took the same
    path), and there are at most 1% of them.  Linear fields come out exact at the interior vertices
    that did not take the fallback."""
    import parmmg_tpu.driver as jdrv
    from parmmg_tpu_torch import driver as tdrv
    from parmmg_tpu_torch.api import ParMesh
    from parmmg_tpu_torch.core import constants as C
    vert, tet = tfix.sphere_mesh(3)
    temp, vel = tfix.linear_fields(vert)
    pm = ParMesh(device="cpu")
    pm.set_mesh_size(np_=len(vert), ne=len(tet))
    pm.set_vertices(vert)
    pm.set_tetrahedra(tet + 1)
    pm.set_met_size(1, len(vert))
    pm.set_scalar_mets(tfix.ball_shock_metric(vert, 0.8))
    pm.set_sols_at_vertices_size(2, [1, 2])
    pm.set_ith_sol_in_sols_at_vertices(1, temp)
    pm.set_ith_sol_in_sols_at_vertices(2, vel)
    pm.info.niter, pm.info.imprim = 1, -1
    seen = []
    real = tdrv.interpolate_fields

    def spy(bg, fields, new):
        seen.append((bg, [f.copy() for f in fields], new))
        return real(bg, fields, new)
    mp = pytest.MonkeyPatch()
    mp.setattr(tdrv, "interpolate_fields", spy)
    try:
        assert pm.run() == C.PMMG_SUCCESS
    finally:
        mp.undo()
    (bg, fields, new), = seen
    assert np.array_equal(fields[0], temp) and np.array_equal(fields[1], vel)
    out = [pm.get_ith_sol_in_sols_at_vertices(i) for i in (1, 2)]
    want = jdrv.interpolate_fields(_to_jax(bg), fields, _to_jax(new))
    vm = new.vmask.numpy()
    n = int(vm.sum())
    assert len(out[0]) == n == len(pm.get_vertices()[0])
    bad = np.zeros(n, bool)
    for g, w in zip(out, want):
        assert g.dtype == np.float32 == w.dtype and g.shape == w.shape
        err = np.abs(g - w).reshape(n, -1).max(1) / np.abs(w).max()
        bad |= err > RTOL
    bdy = (new.vtag.numpy()[vm] & C.MG_BDY) != 0
    assert not (bad & ~bdy).any()
    assert bad.sum() <= max(2, n // 100), bad.sum()
    pts = new.vert[new.vmask]
    tl = TI.locate_points_bdy(bg, pts[torch.from_numpy(bdy)])
    jl = JI.locate_points_bdy(_to_jax(bg), jnp.asarray(pts.numpy()[bdy]))
    tri = TI.surface_triangulation(bg)[0].numpy()
    for k in np.flatnonzero(bad[bdy]):
        a, b = int(tl.tri[k]), int(jl.tri[k])
        assert a != b and bool(tl.failed[k]) == bool(jl.failed[k])
        assert len(set(tri[a]) & set(tri[b])) == 2
    loc = TI.locate_points(bg, pts, torch.zeros(len(pts), dtype=torch.int32))
    ok = ~loc.failed.numpy() & ~bdy
    assert ok.sum() > 10
    for g, w in zip(out, tfix.linear_fields(pts.numpy().astype(np.float64))):
        assert np.abs(g - w)[ok].max() <= 1e-4 * np.abs(w).max()
