"""The port's ``ParMesh`` against the JAX package's: the same mesh staged
entity by entity through both (one-entity setters, required entities,
corners, ridges, prisms and quadrilaterals, normals, a scalar metric set
point by point, solution fields), the same core mesh built from it, and
every getter equal after the same small run (all three remesh operators
off, so both outputs are the staged mesh: floats within 1e-5, everything
else exactly).  Then the default torus run through both CLIs: tet count
within 5%, qmin within 0.05, qmean within 0.02 (the default sphere run is
in ``test_torch_options.py``; the two JAX compilations sit in two files so
that they run side by side)."""
import contextlib
import io
import json

import numpy as np
import pytest

from parmmg_tpu.api import ParMesh as JParMesh
from parmmg_tpu.core.mesh import MESH_FIELDS
from parmmg_tpu_torch.api import ParMesh as TParMesh
from parmmg_tpu_torch.core import constants as C
from parmmg_tpu_torch.core.mesh import mesh_to_numpy
from parmmg_tpu_torch.io.medit import MeditMesh, write_mesh
from parmmg_tpu_torch.utils.fixtures import cube_mesh, torus_mesh
from torch_parity import jax_cli_records, start_jax_cli
from torch_parity import jax_ledger_listener_compat  # noqa: F401


def _stage(pm):
    """cube_mesh(2) staged one entity at a time, with every kind of
    extra the API takes."""
    vert, tet = cube_mesh(2)
    faces = np.array([t[C.IDIR[f]] for t in tet for f in range(4)
                      if (vert[t[C.IDIR[f]]][:, 2] == 0).all()])
    edges = np.array([[0, 1], [1, 2], [0, 3], [3, 6]])
    prism = np.array([[0, 1, 2, 3, 4, 5]])
    quad = np.array([[18, 19, 22, 21]])
    pm.set_mesh_size(np_=len(vert), ne=len(tet), nprism=1, nt=len(faces),
                     nquad=1, na=len(edges))
    for i, v in enumerate(vert):
        pm.set_vertex(*v, i % 3, i + 1)
    for i, t in enumerate(tet):
        pm.set_tetrahedron(*(t + 1), 1 + i % 2, i + 1)
    for i, f in enumerate(faces):
        pm.set_triangle(*(f + 1), 7 + i % 2, i + 1)
    for i, e in enumerate(edges):
        pm.set_edge(*(e + 1), i, i + 1)
    pm.set_prism(prism[0] + 1, 5, 1)
    pm.set_quadrilateral(quad[0] + 1, 6, 1)
    pm.set_required_tetrahedron(40)
    pm.set_required_triangle(2)
    pm.set_required_edge(3)
    pm.set_ridge(4)
    pm.set_corner(9)
    pm.set_required_vertex(13)
    pm.set_normal_at_vertex(5, 0.0, 0.0, -1.0)
    pm.set_met_size(1, len(vert))
    for i in range(len(vert)):
        pm.set_scalar_met(0.3 + 0.01 * i, i + 1)
    x = vert @ [1.0, -2.0, 0.5]
    pm.set_sols_at_vertices_size(3, [1, 2, 3])
    pm.set_ith_sol_in_sols_at_vertices(1, x)
    pm.set_ith_sol_in_sols_at_vertices(2, np.stack([x, 2 * x, -x], 1))
    pm.set_ith_sol_in_sols_at_vertices(3, np.tile([2.0, 0, 0, 2, 0, 2],
                                                  (len(vert), 1)))
    pm.info.niter, pm.info.imprim = 1, -1
    pm.info.noinsert = pm.info.noswap = pm.info.nomove = True
    return pm


def _eq(a, b, what):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{k}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=what)
    else:
        assert a.shape == b.shape and np.array_equal(a, b), what


@pytest.fixture(scope="module")
def staged():
    return _stage(JParMesh()), _stage(TParMesh(device="cpu"))


def test_staging_and_core_mesh_equal(staged):
    j, t = staged
    assert j.get_mesh_size() == t.get_mesh_size() == (27, 48, 1, 8, 1, 4)
    for i in (1, 2, 3):
        _eq(j.get_ith_sol_in_sols_at_vertices(i),
            t.get_ith_sol_in_sols_at_vertices(i), f"sol {i}")
    _eq(j.get_prisms(), t.get_prisms(), "prisms")
    _eq(j.get_quadrilaterals(), t.get_quadrilaterals(), "quads")
    for f in ("vert", "vref", "vreq", "vcrn", "vnormal", "tetra", "tref",
              "tetra_req", "tria", "triaref", "tria_req", "edge", "edgeref",
              "edge_ridge", "edge_req", "met", "field_types"):
        _eq(getattr(j, f), getattr(t, f), f)
    jm, jmet = j._build_core_mesh()
    tm, tmet = t._build_core_mesh()
    got = mesh_to_numpy(tm)
    for f in MESH_FIELDS:
        _eq(np.asarray(getattr(jm, f)), got[f], f)
    _eq(np.asarray(jmet), tmet.numpy(), "met")
    # the extras reached the core mesh: frozen hybrid vertices, a frozen
    # required tet, a required triangle and edge
    assert (got["vtag"][:6] & C.MG_REQ).all()
    assert (got["ftag"][39] & C.MG_REQ).all()
    assert (got["ftag"] & C.MG_REQ).any() and (got["etag"] & C.MG_REQ).any()


def test_every_getter_equal_after_the_same_run(staged):
    j, t = staged
    assert j.run() == t.run() == C.PMMG_SUCCESS
    assert j.get_mesh_size() == t.get_mesh_size()
    np_, ne, _, nt, _, na = t.get_mesh_size()
    assert (np_, ne) == (27, 48) and nt == t._out_ntria() == j._out_ntria()
    for i in (1, 2, 3):
        a = j.get_ith_sol_in_sols_at_vertices(i)
        b = t.get_ith_sol_in_sols_at_vertices(i)
        assert a.dtype == b.dtype == np.float32
        _eq(a, b, f"sol {i}")
    _eq(j.get_scalar_mets(), t.get_scalar_mets(), "mets")
    _eq(j.get_normals(), t.get_normals(), "normals")
    _eq(j.get_vertices_glonum(), t.get_vertices_glonum(), "glonum")
    _eq(j.get_triangles_glonum(), t.get_triangles_glonum(), "tria glonum")
    _eq(j._input_vertex_remap(), t._input_vertex_remap(), "remap")
    _eq(j.get_prisms(), t.get_prisms(), "prisms")
    _eq(j.get_quadrilaterals(), t.get_quadrilaterals(), "quads")
    _eq(j.get_edges(), t.get_edges(), "edges")
    for pos in range(1, np_ + 1):
        _eq(j.get_vertex(pos), t.get_vertex(pos), f"vertex {pos}")
        _eq(j.get_scalar_met(pos), t.get_scalar_met(pos), f"met {pos}")
        _eq(j.get_normal_at_vertex(pos), t.get_normal_at_vertex(pos),
            f"normal {pos}")
        _eq(j.get_ridge_normals_at_vertex(pos),
            t.get_ridge_normals_at_vertex(pos), f"ridge normals {pos}")
        assert j.get_vertex_glonum(pos) == t.get_vertex_glonum(pos)
    for pos in range(1, ne + 1):
        _eq(j.get_tetrahedron(pos), t.get_tetrahedron(pos), f"tet {pos}")
    assert j.get_tetrahedron(40)[-1] and t.get_tetrahedron(40)[-1]
    for pos in range(1, nt + 1):
        _eq(j.get_triangle(pos), t.get_triangle(pos), f"tria {pos}")
        assert j.get_triangle_glonum(pos) == t.get_triangle_glonum(pos)
    for pos in range(1, na + 1):
        _eq(j.get_edge(pos), t.get_edge(pos), f"edge {pos}")


def _cli(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    assert rc == 0, buf.getvalue()[-2000:]
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("{")][-1])


@pytest.fixture(autouse=True, scope="module")
def jax_torus(tmp_path_factory):
    """The JAX CLI's default torus run, started with the module and read
    by its last test."""
    d = tmp_path_factory.mktemp("jax_torus")
    vert, tet = torus_mesh()
    m = MeditMesh()
    m.vert, m.vref = vert, np.zeros(len(vert), np.int32)
    m.tetra, m.tref = tet, np.ones(len(tet), np.int32)
    write_mesh(d / "torus.mesh", m)
    args = ["-in", str(d / "torus.mesh"), "-v", "0", "-bench-json"]
    proc = start_jax_cli(args + ["-out", str(d / "j.mesh")])
    yield proc, args, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_default_torus_run_against_the_jax_cli(jax_torus):
    from parmmg_tpu_torch import cli as tcli
    proc, args, d = jax_torus
    t = _cli(tcli.main, args + ["-out", str(d / "t.mesh"), "-device",
                                "cpu"])
    j, = jax_cli_records(proc)
    assert abs(t["ntets"] - j["ntets"]) <= 0.05 * j["ntets"]
    assert abs(t["qmin"] - j["qmin"]) <= 0.05 and t["qmin"] > 0
    assert abs(t["qmean"] - j["qmean"]) <= 0.02
