"""The port's VTK and distributed-file I/O against the JAX package's:
files written from the same arrays are byte-equal, each reader reads the
other package's files to the same arrays, and the port's CLI takes every
input and output format of the JAX CLI on one device (``.vtu`` in with
its metric and fields, ``.vtu``/``.pvtu`` out, distributed input and
``-distributed-output``, ``-field``)."""
import contextlib
import io
import json

import numpy as np
import pytest

from parmmg_tpu.io import distributed as jdist
from parmmg_tpu.io import medit as jmedit
from parmmg_tpu.io import vtk as jvtk
from parmmg_tpu_torch.io import distributed as tdist
from parmmg_tpu_torch.io import medit as tmedit
from parmmg_tpu_torch.io import vtk as tvtk
from parmmg_tpu_torch.utils.fixtures import (ball_shock_metric, cube_mesh,
                                             linear_fields, sphere_mesh)
from torch_parity import jax_ledger_listener_compat  # noqa: F401

RNG = np.random.default_rng(11)


def _arrays():
    vert = RNG.normal(size=(40, 3))
    tet = RNG.integers(0, 40, (25, 4))
    pdata = {"metric": RNG.uniform(0.1, 1, 40), "vel": RNG.normal(size=(40, 3))}
    cdata = {"ref": RNG.integers(0, 5, 25).astype(np.float64)}
    return vert, tet, pdata, cdata


def test_vtu_and_pvtu_bytes_equal(tmp_path):
    vert, tet, pdata, cdata = _arrays()
    for name, mod in (("jax", jvtk), ("torch", tvtk)):
        mod.write_vtu(tmp_path / f"{name}.vtu", vert, tet, pdata, cdata)
        mod.write_vtu(tmp_path / f"{name}.bare.vtu", vert, tet)
        mod.write_pvtu(tmp_path / f"{name}.pvtu", ["a.vtu", "b.vtu"],
                       {"metric": 1, "vel": 3}, {"ref": 1})
    for suffix in (".vtu", ".bare.vtu", ".pvtu"):
        assert (tmp_path / f"jax{suffix}").read_bytes() == \
            (tmp_path / f"torch{suffix}").read_bytes(), suffix


_MIXED = """<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1">
  <UnstructuredGrid>
    <Piece NumberOfPoints="5" NumberOfCells="4">
      <Points>
        <DataArray type="Float32" NumberOfComponents="3" format="ascii">
          0 0 0 1 0 0 0 1 0 0 0 1 1 1 1
        </DataArray>
      </Points>
      <Cells>
        <DataArray type="Int64" Name="connectivity" format="ascii">
          0 1 2 3 0 1 2 1 2 3 4 0 4
        </DataArray>
        <DataArray type="Int64" Name="offsets" format="ascii">
          4 7 11 13
        </DataArray>
        <DataArray type="UInt8" Name="types" format="ascii">
          10 5 10 3
        </DataArray>
      </Cells>
      <PointData>
        <DataArray type="Float64" Name="sol" format="ascii">
          0.1 0.2 0.3 0.4 0.5
        </DataArray>
        <DataArray type="Float64" Name="T" format="ascii">
          1 2 3 4 5
        </DataArray>
      </PointData>
      <CellData>
        <DataArray type="Int32" Name="medit:ref" format="ascii">
          7 8 9 10
        </DataArray>
      </CellData>
    </Piece>
  </UnstructuredGrid>
</VTKFile>
"""


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif hasattr(a, "__dict__"):
        _same(vars(a), vars(b), path)
    else:
        assert a == b, path


def test_vtu_readers_read_each_others_files(tmp_path):
    vert, tet, pdata, cdata = _arrays()
    jvtk.write_vtu(tmp_path / "j.vtu", vert, tet, pdata, cdata)
    tvtk.write_vtu(tmp_path / "t.vtu", vert, tet, pdata, cdata)
    (tmp_path / "mixed.vtu").write_text(_MIXED)
    for f in ("j.vtu", "t.vtu", "mixed.vtu"):
        _same(jvtk.read_vtu(tmp_path / f), tvtk.read_vtu(tmp_path / f), f)
        _same(jvtk.read_vtu_medit(tmp_path / f),
              tvtk.read_vtu_medit(tmp_path / f), f)
    got = tvtk.read_vtu(tmp_path / "j.vtu")
    assert np.array_equal(got[0], vert) and np.array_equal(got[1][10], tet)
    assert np.array_equal(got[2]["vel"], pdata["vel"])
    m, met, fields = tvtk.read_vtu_medit(tmp_path / "mixed.vtu")
    assert len(m.tetra) == 2 and len(m.tria) == 1 and len(m.edges) == 1
    assert m.tref.tolist() == [7, 9] and sorted(fields) == ["T"]
    assert np.allclose(met, [0.1, 0.2, 0.3, 0.4, 0.5])


def _shard(mod):
    vert, tet = cube_mesh(2)
    m = mod.MeditMesh()
    m.vert, m.vref = vert, np.arange(len(vert), dtype=np.int32) % 3
    m.tetra, m.tref = tet, np.ones(len(tet), np.int32)
    m.tria = tet[:6, :3].copy()
    m.triaref = np.full(6, 4, np.int32)
    return m


def _comms(mod):
    face = [mod.ShardComm(1, np.arange(1, 4), np.array([9, 4, 7])),
            mod.ShardComm(2, np.arange(4, 6), np.array([11, 12]))]
    node = [mod.ShardComm(1, np.array([3, 1, 2]), np.array([30, 10, 20]))]
    return face, node


@pytest.mark.parametrize("suffix", [".mesh", ".meshb"])
def test_distributed_files_bytes_equal_and_cross_read(tmp_path, suffix):
    outs = {}
    for name, mod, med in (("jax", jdist, jmedit), ("torch", tdist, tmedit)):
        face, node = _comms(mod)
        d = tmp_path / name
        d.mkdir()
        outs[name] = mod.save_distributed_mesh(d / f"part{suffix}", 3,
                                               _shard(med), face, node)
        mod.save_distributed_mesh(d / f"bare{suffix}", 0, _shard(med))
    assert outs["jax"].name == outs["torch"].name == f"part.3{suffix}"
    for stem in (f"part.3{suffix}", f"bare.0{suffix}"):
        assert (tmp_path / "jax" / stem).read_bytes() == \
            (tmp_path / "torch" / stem).read_bytes(), stem
    if suffix == ".meshb":
        assert (tmp_path / "jax" / "part.3.comm").read_bytes() == \
            (tmp_path / "torch" / "part.3.comm").read_bytes()
    for d in ("jax", "torch"):
        base = tmp_path / d / f"part{suffix}"
        assert jdist.probe_distributed(base, 3) == \
            tdist.probe_distributed(base, 3) is True
        assert not tdist.probe_distributed(base, 0)
        jm, jf, jn = jdist.load_distributed_mesh(base, 3)
        tm, tf, tn = tdist.load_distributed_mesh(base, 3)
        _same(vars(jm), vars(tm), d)
        for a, b in zip(jf + jn, tf + tn):
            assert a.color_out == b.color_out
            assert np.array_equal(a.local, b.local)
            assert np.array_equal(a.global_, b.global_)
        assert [c.color_out for c in tf] == [1, 2] and len(tn) == 1
    assert str(tdist.insert_rank_index("a/b.mesh", 7)) == \
        str(jdist.insert_rank_index("a/b.mesh", 7))


def _run_cli(args):
    from parmmg_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args + ["-device", "cpu", "-v", "0", "-bench-json"])
    assert rc == 0, buf.getvalue()
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("{")][-1])


def _conforming(vert, tet):
    from parmmg_tpu_torch.core.mesh import make_mesh, tet_volumes
    from parmmg_tpu_torch.ops.adjacency import build_adjacency, \
        check_adjacency
    mesh = build_adjacency(make_mesh(vert, tet))
    assert check_adjacency(mesh) == {"asymmetric": 0, "face_mismatch": 0}
    assert int(((tet_volumes(mesh) <= 0) & mesh.tmask).sum()) == 0


def test_cli_vtu_in_with_fields_and_vtu_pvtu_out(tmp_path, monkeypatch):
    """A .vtu input: its "metric" point field is the metric and its other
    point fields ride along, P1-interpolated onto the output vertices
    (linear fields exactly, at the interior vertices); .vtu and .pvtu
    outputs are the JAX writer's layout."""
    from parmmg_tpu_torch import driver
    vert, tet = sphere_mesh(3)
    temp, vel = linear_fields(vert)
    src = tmp_path / "s.vtu"
    tvtk.write_vtu(src, vert, tet, {"metric": ball_shock_metric(vert, 0.8),
                                    "temp": temp, "vel": vel})
    seen = []
    real = driver.interpolate_fields

    def spy(bg, fields, new):
        out = real(bg, fields, new)
        seen.append((fields, new, out))
        return out
    monkeypatch.setattr(driver, "interpolate_fields", spy)
    rec = _run_cli(["-in", str(src), "-out", str(tmp_path / "o.pvtu"),
                    "-niter", "1"])
    (fields, new, out), = seen
    assert [f.shape for f in fields] == [temp.shape, vel.shape]
    assert [f.dtype for f in out] == [np.float32, np.float32]
    vm = new.vmask.numpy()
    p = new.vert.numpy()[vm].astype(np.float64)
    interior = (new.vtag.numpy()[vm] & 2) == 0
    for got, want in zip(out, linear_fields(p)):
        assert got.shape == want.shape
        err = np.abs(got - want)[interior].max()
        assert err <= 1e-4 * np.abs(want).max()
    v, cells, _, _ = tvtk.read_vtu(tmp_path / "o.vtu")
    assert len(cells[10]) == rec["ntets"] and len(v) == int(vm.sum())
    _conforming(v, cells[10])
    assert "o.vtu" in (tmp_path / "o.pvtu").read_text()
    jvtk.write_pvtu(tmp_path / "j.pvtu", [tmp_path / "o.vtu"])
    assert (tmp_path / "j.pvtu").read_bytes() == \
        (tmp_path / "o.pvtu").read_bytes()


def test_cli_field_file_distributed_output_and_input(tmp_path):
    """-field F.sol carries the fields; -distributed-output writes
    name.0.mesh (+ the .sol beside the output name); that file set is
    read back as a distributed input, reassembled as the JAX CLI
    reassembles it."""
    import parmmg_tpu.cli as jcli
    from parmmg_tpu_torch import cli as tcli
    vert, tet = cube_mesh(2)
    m = tmedit.MeditMesh()
    m.vert, m.vref = vert, np.zeros(len(vert), np.int32)
    m.tetra, m.tref = tet, np.ones(len(tet), np.int32)
    tmedit.write_mesh(tmp_path / "c.mesh", m)
    temp, vel = linear_fields(vert)
    tmedit.write_sol(tmp_path / "f.sol", np.concatenate(
        [temp[:, None], vel], 1), [tmedit.SOL_SCALAR, tmedit.SOL_VECTOR])
    rec = _run_cli(["-in", str(tmp_path / "c.mesh"), "-field",
                    str(tmp_path / "f.sol"), "-hsiz", "0.4", "-niter", "1",
                    "-out", str(tmp_path / "d.mesh"), "-distributed-output"])
    assert not (tmp_path / "d.mesh").exists()
    assert (tmp_path / "d.0.mesh").exists() and (tmp_path / "d.sol").exists()
    shard, face, node = tdist.load_distributed_mesh(tmp_path / "d.mesh", 0)
    assert len(shard.tetra) == rec["ntets"] and not face and not node
    # two shards of the output, split by tet halves, sharing vertices
    half = len(shard.tetra) // 2
    parts = []
    for k, rows in enumerate((slice(0, half), slice(half, None))):
        used = np.unique(shard.tetra[rows])
        sub = tmedit.MeditMesh()
        sub.vert, sub.vref = shard.vert[used], shard.vref[used]
        sub.tetra = np.searchsorted(used, shard.tetra[rows]).astype(np.int32)
        sub.tref = shard.tref[rows]
        tdist.save_distributed_mesh(tmp_path / "two.mesh", k, sub)
        parts.append(jdist.load_distributed_mesh(tmp_path / "two.mesh",
                                                 k)[0])
    got, want = tcli._concat_shards(parts), jcli._concat_shards(parts)
    for f in ("vert", "vref", "tetra", "tref", "src_part"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert len(got.vert) == len(shard.vert)
    rec2 = _run_cli(["-in", str(tmp_path / "two.mesh"), "-noinsert",
                     "-noswap", "-nomove", "-out", str(tmp_path / "r.mesh")])
    assert rec2["ntets"] == rec["ntets"]
    _conforming(*(lambda r: (r.vert, r.tetra))(
        tmedit.read_mesh(tmp_path / "r.mesh")))


def test_cli_accepts_every_single_device_flag():
    """Every flag of the JAX CLI parses in the port's, with the same
    destinations and defaults; only -device, -group-polish (the
    JAX package's grouped_adapt_pass(polish=), which its CLI has no flag
    for) and -dist-init (a rank's rendezvous when ``-ndev N`` runs across
    cards, the JAX CLI's N devices being one process) are the port's
    own."""
    import parmmg_tpu.cli as jcli
    from parmmg_tpu_torch import cli as tcli

    def opts(parser):
        return {o: (a.dest, a.default) for a in parser._actions
                for o in a.option_strings}
    j, t = opts(jcli.build_parser()), opts(tcli.build_parser())
    assert set(t) - set(j) == {"-device", "-group-polish", "-dist-init"}
    assert set(j) - set(t) == set()
    for o in j:
        assert j[o] == t[o], o
