"""The port's meshkit (``parmmg_tpu_torch/native/``) held against the JAX
package's ``native/``, on the CPU.

Exact (integer arrays and float64 coordinates bit for bit):
``greedy_partition`` with the library on in both packages on
cube_mesh(3, 4, 8) x (2, 4, 7) parts; the numpy BFS against the JAX
package's with the library off in both; ``build_adjacency`` and
``color_components`` against the JAX package's library; ``read_mesh``
through the library against the port's tokenizer and the JAX package's
``read_mesh``, on a file with triangles and references and on one without
triangles, while a file with a Ridges section takes the tokenizer in both
packages; ``dist._partition(partitioner="greedy")`` against the JAX
package's greedy branch of ``distributed_adapt``.  Port-only: a failed
build raises instead of falling back, a file with a section the scanner
does not read raises in the tokenizer instead of coming back cut short,
and without a compiler the numpy paths run and say so once.

Skips, like the JAX package's ``tests/test_native.py``, where there is no
``g++``.
"""
import shutil

import numpy as np
import pytest
import torch

from parmmg_tpu import native as JN
from parmmg_tpu.io import medit as JMe
from parmmg_tpu.parallel import partition as JPa
from parmmg_tpu.utils.fixtures import analytic_iso_metric, cube_mesh
from parmmg_tpu_torch import native as TN
from parmmg_tpu_torch.io import medit as TMe
from parmmg_tpu_torch.parallel import partition as TPa


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: meshkit cannot be built")


_CUBES = {}


def _cube(n):
    if n not in _CUBES:
        vert, tet = cube_mesh(n)
        _CUBES[n] = (vert, tet, vert[tet].mean(axis=1))
    return _CUBES[n]


@pytest.mark.parametrize("nparts", (2, 4, 7))
@pytest.mark.parametrize("n", (3, 4, 8))
def test_greedy_partition_equals_jax_library(n, nparts):
    assert JN.available() and TN.available()
    _, tet, cent = _cube(n)
    got = TPa.greedy_partition(tet, cent, nparts)
    assert got.dtype == np.int32
    assert np.array_equal(got, JPa.greedy_partition(tet, cent, nparts))
    w = 1.0 + np.arange(len(tet)) % 3
    assert np.array_equal(TPa.greedy_partition(tet, cent, nparts, w),
                          JPa.greedy_partition(tet, cent, nparts, w))


@pytest.mark.parametrize("nparts", (2, 4, 7))
def test_numpy_path_equals_jax_fallback(nparts, monkeypatch):
    monkeypatch.setattr(JN, "available", lambda: False)
    monkeypatch.setattr(TN, "available", lambda: False)
    _, tet, cent = _cube(4)
    assert np.array_equal(TPa.greedy_partition(tet, cent, nparts),
                          JPa.greedy_partition(tet, cent, nparts))


@pytest.mark.parametrize("n", (3, 8))
def test_adjacency_and_components_equal_jax(n):
    _, tet, cent = _cube(n)
    adja = TN.build_adjacency(tet)
    assert adja.dtype == np.int32 and adja.shape == (len(tet), 4)
    assert np.array_equal(adja, JN.build_adjacency(tet))
    # a part split in two along the Morton curve: several components
    part = (TPa.morton_partition(cent, 4) % 2).astype(np.int32)
    comp = TN.color_components(adja, part)
    assert np.array_equal(comp, JN.color_components(adja, part))
    assert comp.max() >= 1


def _medit_file(path, tria: bool, ridges: bool = False):
    vert, tet = cube_mesh(4)
    rng = np.random.default_rng(7)
    m = TMe.MeditMesh()
    m.vert = vert + rng.uniform(-1e-3, 1e-3, vert.shape)
    m.vref = rng.integers(0, 5, len(vert)).astype(np.int32)
    m.tetra = tet.astype(np.int32)
    m.tref = rng.integers(1, 9, len(tet)).astype(np.int32)
    if tria:
        m.tria = tet[:40, :3].astype(np.int32)
        m.triaref = rng.integers(1, 4, 40).astype(np.int32)
    if ridges:
        m.edges = tet[:6, :2].astype(np.int32)
        m.edgeref = np.ones(6, np.int32)
        m.ridges = np.arange(3, dtype=np.int32)
    TMe.write_mesh(str(path), m)
    return path


_FIELDS = ("vert", "vref", "tetra", "tref", "tria", "triaref", "edges",
           "ridges")


def _same(a, b):
    for f in _FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


def _count_scans(monkeypatch, mod):
    """Spy on ``mod.scan_medit``: one entry a call, whether it read the
    file."""
    calls = []
    real = mod.scan_medit

    def spy(arg):
        got = real(arg)
        calls.append(got is not None)
        return got
    monkeypatch.setattr(mod, "scan_medit", spy)
    return calls


@pytest.mark.parametrize("tria", (True, False), ids=("tria", "no_tria"))
def test_read_mesh_through_the_library(tmp_path, monkeypatch, tria):
    p = _medit_file(tmp_path / "m.mesh", tria)
    seen = _count_scans(monkeypatch, TN)
    got = TMe.read_mesh(p)
    assert seen == [True]
    _same(got, TMe._read_mesh_ascii(p))
    _same(got, JMe.read_mesh(p))
    assert len(got.tria) == (40 if tria else 0)
    assert got.tria.shape[1:] == (3,) and got.tetra.min() == 0


def test_read_mesh_with_ridges_takes_the_tokenizer(tmp_path, monkeypatch):
    p = _medit_file(tmp_path / "r.mesh", True, ridges=True)
    seen_t = _count_scans(monkeypatch, TN)
    seen_j = _count_scans(monkeypatch, JN)
    got = TMe.read_mesh(p)
    _same(got, JMe.read_mesh(p))
    assert seen_t == [] and seen_j == []
    assert len(got.ridges) == 3 and len(got.edges) == 6


@pytest.mark.parametrize("where", ("before", "after"))
@pytest.mark.parametrize("kw", ("Quadrilaterals", "Prisms"))
def test_read_mesh_with_an_unknown_section_raises(tmp_path, monkeypatch,
                                                  kw, where):
    """A section the scanner does not read makes it decline the file, and
    the tokenizer then raises on it: never a mesh cut short at that
    section."""
    p = _medit_file(tmp_path / "u.mesh", True)
    sec = f"{kw}\n1\n1 2 3 4 {'5 6 ' if kw == 'Prisms' else ''}1\n"
    text = p.read_text()
    at = text.index("Tetrahedra" if where == "before" else "End")
    p.write_text(text[:at] + sec + text[at:])
    seen = _count_scans(monkeypatch, TN)
    with pytest.raises(ValueError, match=f"unsupported Medit keyword: {kw}"):
        TMe.read_mesh(p)
    assert seen == [False]


@pytest.mark.parametrize("n_shards", (2, 4))
def test_dist_greedy_partition_equals_jax(n_shards):
    """``dist._partition(partitioner="greedy")`` against the JAX package's
    greedy branch (``distributed_adapt``, parallel/dist.py:677-689):
    greedy, contiguity, the metric weights and the refinement."""
    from parmmg_tpu_torch.core import mesh as tmesh
    from parmmg_tpu_torch.parallel import dist as TDi
    vert, tet, _ = _cube(4)
    m = tmesh.make_mesh(vert, tet, capP=2 * len(vert), capT=2 * len(tet))
    h = np.ones(m.capP, np.float32)
    h[: len(vert)] = analytic_iso_metric(vert, "shock", h=0.3)
    vert_h, tet_h = tmesh.mesh_to_host(m)[:2]
    got = TDi._partition(m, torch.from_numpy(h), n_shards, "greedy",
                         vert_h, tet_h)
    cent = vert_h[tet_h].mean(axis=1)
    want = JPa.fix_contiguity(tet_h, JPa.greedy_partition(tet_h, cent,
                                                          n_shards))
    wd = JPa.metric_edge_weights(tet_h, vert_h, h[: len(vert)])
    want = JPa.fix_contiguity(tet_h, JPa.refine_partition(
        want, n_shards, wd["pairs"], wd["w"]))
    assert np.array_equal(got, want)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "meshkit.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(TN, "SRC", bad)
    monkeypatch.setattr(TN, "SO", tmp_path / "build" / "libmeshkit.so")
    _, tet, cent = _cube(3)
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        TPa.greedy_partition(tet, cent, 2)
    assert not list((tmp_path / "build").glob("*.so"))


def test_no_compiler_takes_the_numpy_paths(tmp_path, monkeypatch, capsys):
    from parmmg_tpu_torch.obs import trace
    # the process verbosity at its default: an earlier test in the same
    # worker may have lowered it
    monkeypatch.setattr(trace, "_VERBOSITY", [1])
    monkeypatch.setattr(TN, "compiler", lambda: None)
    monkeypatch.setattr(TN, "_SAID", [False])
    monkeypatch.setattr(JN, "available", lambda: False)
    seen = _count_scans(monkeypatch, TN)
    _, tet, cent = _cube(4)
    assert np.array_equal(TPa.greedy_partition(tet, cent, 4),
                          JPa.greedy_partition(tet, cent, 4))
    p = _medit_file(tmp_path / "m.mesh", True)
    _same(TMe.read_mesh(p), TMe._read_mesh_ascii(p))
    assert seen == []
    err = capsys.readouterr().err
    assert err.count("no g++ on the PATH") == 1


def test_build_is_fresh_and_recorded(tmp_path, monkeypatch):
    """A stale library is rebuilt into place from a temporary name and
    the g++ seconds reach the shape ledger; a fresh one is loaded as it
    is."""
    from parmmg_tpu_torch.utils.compilecache import LEDGER
    monkeypatch.setattr(TN, "SO", tmp_path / "libmeshkit.so")
    before = LEDGER.snapshot().get("gxx.meshkit", {}).get("compiles", 0)
    assert TN.build() > 0
    assert TN.build() == 0.0
    assert [q.name for q in tmp_path.iterdir()] == ["libmeshkit.so"]
    assert LEDGER.snapshot()["gxx.meshkit"]["compiles"] == before + 1
