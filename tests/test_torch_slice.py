"""The whole slice: the single-device CLI remesh of cube_mesh(3) with
``-hsiz 0.3 -niter 1``, once through ``parmmg_tpu.cli.main`` and once
through ``parmmg_tpu_torch.cli.main(..., "-device", "cpu")``.

Held: the first cycle's counts row [nsplit, ncollapse, nswap, nmoved,
overflow, live, deferred, 0] is equal; the final tet count agrees within
2%, qmin within 0.05 and qmean within 0.02; the port's output is
conforming (every interior face paired both ways, no live tet of volume
<= 0).

Past the first cycle the two runs can only be compared statistically: the
JAX CLI runs each cycle as one fused XLA program whose float rounding
differs from eager evaluation, and on this input that alone moves its
result.  Measured on this fixture: JAX CLI 762 tets / qmean 0.66952, the
same JAX code run eagerly (``jax.disable_jit``) 748 tets / qmean 0.68209,
the port 748 tets / qmean 0.68202 (the port follows the eager evaluation;
cycle by cycle from identical states its counts equal the eager JAX
counts).  The qmean bound is therefore 0.02, wider than the 0.0126 by
which the reference disagrees with itself.
"""
import json
import os

import numpy as np
import pytest
import torch

from parmmg_tpu_torch.io.medit import MeditMesh, read_mesh, write_mesh
from parmmg_tpu_torch.utils.fixtures import cube_mesh
from torch_parity import jax_ledger_listener_compat  # noqa: F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import parmmg_tpu.cli as jcli
    import parmmg_tpu.ops.adapt as jadapt
    import parmmg_tpu_torch.cli as tcli
    import parmmg_tpu_torch.ops.adapt as tadapt
    d = tmp_path_factory.mktemp("slice")
    v, t = cube_mesh(3)
    m = MeditMesh()
    m.vert, m.vref = v, np.zeros(len(v), np.int32)
    m.tetra, m.tref = t, np.ones(len(t), np.int32)
    src = str(d / "cube3.mesh")
    write_mesh(src, m)
    args = ["-in", src, "-hsiz", "0.3", "-niter", "1", "-v", "0",
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
        import contextlib
        import io
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


def test_first_cycle_counts_equal(runs):
    _, rows = runs
    assert rows["jax"] and rows["torch"]
    assert rows["torch"][0] == rows["jax"][0]
    assert rows["torch"][0][0] > 0            # the cycle did split


def test_final_mesh_statistics_agree(runs):
    recs, _ = runs
    j, t = recs["jax"], recs["torch"]
    assert abs(t["ntets"] - j["ntets"]) <= 0.02 * j["ntets"]
    assert abs(t["qmin"] - j["qmin"]) <= 0.05
    assert abs(t["qmean"] - j["qmean"]) <= 0.02
    assert t["qmin"] > 0


def test_port_output_is_conforming(runs):
    from parmmg_tpu_torch.core.mesh import make_mesh, tet_volumes
    from parmmg_tpu_torch.ops.adjacency import build_adjacency, \
        check_adjacency
    recs, _ = runs
    mo = read_mesh(recs["torch"]["out"])
    assert len(mo.tetra) == recs["torch"]["ntets"]
    mesh = build_adjacency(make_mesh(mo.vert, mo.tetra))
    assert check_adjacency(mesh) == {"asymmetric": 0, "face_mismatch": 0}
    live = mesh.tmask
    matched = ((mesh.adja >= 0) & live[:, None]).sum()
    bnd = ((mesh.adja < 0) & live[:, None]).sum()
    assert int(matched) + int(bnd) == 4 * int(live.sum())
    # the cube's surface: 6 faces of 3x3 cells -> a closed triangulation
    assert int(bnd) % 2 == 0 and int(bnd) >= 6 * 9 * 2
    assert int(((tet_volumes(mesh) <= 0) & live).sum()) == 0
    assert len(mo.tria) == int(bnd)
