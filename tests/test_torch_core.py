"""Port core: mesh construction / compaction / growth, capacity planning,
Medit I/O and the JAX <-> torch state carry-across, held against the JAX
package exactly; plus the import isolation of the port package."""
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.io import medit as jmedit
from parmmg_tpu.utils.budget import plan_capacities as j_plan
from parmmg_tpu.utils.fixtures import cube_mesh as j_cube
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.io import medit as tmedit
from parmmg_tpu_torch.utils.budget import plan_capacities as t_plan
from parmmg_tpu_torch.utils.fixtures import (analytic_iso_metric,
                                             cube_mesh)
from torch_parity import jax_ledger_listener_compat  # noqa: F401


def _jfields(m):
    return {f: np.asarray(getattr(m, f)) for f in jmesh.MESH_FIELDS}


def _assert_same(jm, tm):
    got = tmesh.mesh_to_numpy(tm)
    for f, a in _jfields(jm).items():
        assert got[f].dtype == a.dtype, f
        assert np.array_equal(got[f], a), f


def _holey(n=2, seed=0):
    """A JAX mesh with dead tet / vertex slots scattered inside."""
    import dataclasses
    v, t = j_cube(n)
    m = jmesh.make_mesh(v, t, capP=3 * len(v), capT=3 * len(t))
    rng = np.random.default_rng(seed)
    tm = np.asarray(m.tmask).copy()
    tm[rng.choice(len(t), len(t) // 5, replace=False)] = False
    adja = np.asarray(m.adja).copy()
    adja[:len(t)] = rng.integers(-1, 4 * len(t), (len(t), 4))
    return dataclasses.replace(m, tmask=jnp.asarray(tm),
                               adja=jnp.asarray(adja.astype(np.int32)))


def test_fixtures_match():
    for n in (1, 3):
        v, t = cube_mesh(n)
        jv, jt = j_cube(n)
        assert np.array_equal(v, jv) and np.array_equal(t, jt)
    v, _ = cube_mesh(4)
    for kind in ("uniform", "shock"):
        assert np.array_equal(analytic_iso_metric(v, kind, 0.2),
                              __import__("parmmg_tpu.utils.fixtures",
                                         fromlist=["x"]).analytic_iso_metric(
                                  v, kind, 0.2))


@pytest.mark.parametrize("caps", [(None, None), (300, 900)])
def test_make_mesh_matches(caps):
    v, t = cube_mesh(3)
    vref = np.arange(len(v), dtype=np.int32) % 3
    tref = np.arange(len(t), dtype=np.int32) % 2
    jm = jmesh.make_mesh(v, t, vref=vref, tref=tref, capP=caps[0],
                         capT=caps[1])
    tm = tmesh.make_mesh(v, t, vref=vref, tref=tref, capP=caps[0],
                         capT=caps[1])
    _assert_same(jm, tm)
    assert tm.np_counts() == jm.np_counts()
    assert np.allclose(tmesh.tet_volumes(tm).numpy(),
                       np.asarray(jmesh.tet_volumes(jm)), rtol=1e-6,
                       atol=1e-9)
    assert np.array_equal(tmesh.tet_face_vertices(tm.tet).numpy(),
                          np.asarray(jmesh.tet_face_vertices(jm.tet)))
    assert np.array_equal(tmesh.tet_edge_vertices(tm.tet).numpy(),
                          np.asarray(jmesh.tet_edge_vertices(jm.tet)))


def test_compact_and_with_capacity_match():
    jm = _holey()
    tm = tmesh.mesh_from_numpy(_jfields(jm))
    _assert_same(jmesh.compact(jm), tmesh.compact(tm))
    _assert_same(jmesh.with_capacity(jm, jm.capP + 10, jm.capT + 20),
                 tmesh.with_capacity(tm, tm.capP + 10, tm.capT + 20))
    for a, b in zip(jmesh.mesh_to_host(jm), tmesh.mesh_to_host(tm)):
        assert np.array_equal(np.asarray(a).view(np.int32)
                              if a.dtype == np.uint32 else a,
                              b.view(np.int32) if b.dtype == np.uint32
                              else b)


@pytest.mark.parametrize("args", [(100, 400, -1), (5000, 24576, -1),
                                  (5000, 24576, 3), (10, 10, 1)])
def test_plan_capacities_match(args):
    assert t_plan(*args) == j_plan(*args)


def test_carry_across_round_trip_is_exact():
    jm = _holey(3, seed=4)
    fields = _jfields(jm)
    tm = tmesh.mesh_from_numpy(fields)
    assert tm.vtag.dtype == torch.int32 and tm.ftag.dtype == torch.int32
    back = tmesh.mesh_to_numpy(tm)
    for f, a in fields.items():
        assert back[f].dtype == a.dtype and np.array_equal(back[f], a), f


def _medit_sample():
    v, t = cube_mesh(2)
    m = tmedit.MeditMesh()
    rng = np.random.default_rng(1)
    m.vert = v + rng.random(v.shape) * 1e-3
    m.vref = (np.arange(len(v)) % 4).astype(np.int32)
    m.tetra = t
    m.tref = (np.arange(len(t)) % 3).astype(np.int32)
    m.tria = t[:5, :3].copy()
    m.triaref = np.arange(5, dtype=np.int32)
    m.edges = t[:4, :2].copy()
    m.edgeref = np.arange(4, dtype=np.int32)
    m.corners = np.array([0, 2], np.int32)
    m.required_vert = np.array([1], np.int32)
    m.ridges = np.array([0, 3], np.int32)
    m.required_tria = np.array([2], np.int32)
    return m


@pytest.mark.parametrize("suffix", [".mesh", ".meshb"])
def test_medit_round_trip_through_jax_reader(tmp_path, suffix):
    m = _medit_sample()
    path = tmp_path / f"x{suffix}"
    tmedit.write_mesh(path, m)
    for r in (jmedit.read_mesh(path), tmedit.read_mesh(path)):
        assert np.allclose(r.vert, m.vert, rtol=0, atol=1e-14)
        for f in ("vref", "tetra", "tref", "tria", "triaref", "edges",
                  "edgeref", "corners", "required_vert", "ridges",
                  "required_tria"):
            assert np.array_equal(getattr(r, f), getattr(m, f)), f
    jpath = tmp_path / f"j{suffix}"
    jmedit.write_mesh(jpath, jmedit.read_mesh(path))
    assert jpath.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("suffix", [".sol", ".solb"])
def test_sol_round_trip(tmp_path, suffix):
    vals = np.random.default_rng(2).random(17)
    path = tmp_path / f"m{suffix}"
    tmedit.write_sol(path, vals, [tmedit.SOL_SCALAR])
    for reader in (jmedit.read_sol, tmedit.read_sol):
        got, types = reader(path)
        # ASCII keeps 15 significant digits, binary is exact
        assert types == [1]
        np.testing.assert_allclose(got[:, 0], vals, rtol=1e-14, atol=0)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib\n"
        "import parmmg_tpu_torch\n"
        "for m in pkgutil.walk_packages(parmmg_tpu_torch.__path__,"
        " 'parmmg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'parmmg_tpu' or k.startswith('parmmg_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
