"""The port's knob registry (``parmmg_tpu_torch/api/knobs.py``): the
contract the JAX package's lint rule R4 holds its own registry to, held
here for the port's ``PMTORCH_*`` knobs without touching ``parmmg_tpu/``.

Exact: every environment read in ``parmmg_tpu_torch/`` (``os.environ.get``,
``os.getenv``, ``os.environ[...]``) is inside ``api/knobs.py``; every
``knobs.get("PMTORCH_...")`` names a declared knob and every declared knob
is read somewhere; every knob is in README, which also holds the table
``python -m parmmg_tpu_torch.api.knobs`` prints; README names no
``PARMMG_*`` knob that the JAX registry lacks; the registry's defaults
equal the JAX package's for the knob of the same meaning; ``get`` raises
on an undeclared name.
"""
import ast
import os
import re
import subprocess
import sys

import pytest

from parmmg_tpu.api import knobs as JK
from parmmg_tpu_torch.api import knobs as TK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "parmmg_tpu_torch")


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                with open(p) as fh:
                    yield p, ast.parse(fh.read(), p)


def _is_environ(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


def _env_reads(tree):
    """Line numbers of environment reads: os.environ.get(...),
    os.getenv(...), os.environ[...] loads."""
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            f = n.func
            if f.attr == "get" and _is_environ(f.value):
                out.append(n.lineno)
            elif (f.attr == "getenv" and isinstance(f.value, ast.Name)
                  and f.value.id == "os"):
                out.append(n.lineno)
        elif (isinstance(n, ast.Subscript) and _is_environ(n.value)
              and isinstance(n.ctx, ast.Load)):
            out.append(n.lineno)
    return out


def _knob_reads(tree):
    """Names passed as string literals to ``knobs.get`` or
    ``deadline_knob``."""
    out = set()
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Call) and n.args
                and isinstance(n.args[0], ast.Constant)
                and isinstance(n.args[0].value, str)):
            continue
        f = n.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", "")
        if (name == "get" and isinstance(f, ast.Attribute)
                and getattr(f.value, "id", "") == "knobs") \
                or name == "deadline_knob":
            out.add(n.args[0].value)
    return out


def test_every_environment_read_goes_through_the_registry():
    bad = []
    for path, tree in _sources():
        if path.endswith(os.path.join("api", "knobs.py")):
            continue
        bad += [f"{os.path.relpath(path, ROOT)}:{ln}"
                for ln in _env_reads(tree)]
    assert bad == []


def test_registry_equals_the_knobs_read():
    read = set()
    for _, tree in _sources():
        read |= _knob_reads(tree)
    assert read - set(TK.KNOBS) == set()        # undeclared reads
    assert set(TK.KNOBS) - read == set()        # declared, never read
    assert all(k.startswith(TK.PREFIX) for k in TK.KNOBS)


def test_registry_is_one_dict_literal_read_by_ast():
    with open(os.path.join(PKG, "api", "knobs.py")) as fh:
        tree = ast.parse(fh.read())
    lits = [n.value for n in tree.body if isinstance(n, ast.AnnAssign)
            and getattr(n.target, "id", "") == "KNOBS"]
    assert len(lits) == 1 and isinstance(lits[0], ast.Dict)
    assert sorted(k.value for k in lits[0].keys) == list(TK.registered())


def test_readme_lists_every_knob_and_the_table():
    with open(os.path.join(ROOT, "README.md")) as fh:
        readme = fh.read()
    assert [k for k in TK.registered() if k not in readme] == []
    out = subprocess.run([sys.executable, "-m", "parmmg_tpu_torch.api.knobs"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == TK.knob_table_md()
    assert TK.knob_table_md() in readme
    # R4 reads README for PARMMG_* names: none the JAX registry lacks
    named = set(re.findall(r"\bPARMMG_[A-Z0-9_]+\b", readme))
    assert named - set(JK.KNOBS) == set()


@pytest.mark.parametrize("name", sorted(TK.KNOBS))
def test_defaults_and_types_equal_jax(name):
    j = JK.KNOBS["PARMMG_" + name[len(TK.PREFIX):]]
    assert (TK.KNOBS[name].type, TK.KNOBS[name].default) == (j.type,
                                                              j.default)


def test_get_raises_on_undeclared_and_reads_the_environment(monkeypatch):
    with pytest.raises(KeyError):
        TK.get("PMTORCH_NO_SUCH_KNOB")
    with pytest.raises(KeyError):
        TK.get("PARMMG_RETRY_MAX")
    monkeypatch.delenv("PMTORCH_RETRY_MAX", raising=False)
    assert TK.get("PMTORCH_RETRY_MAX") == "2"
    assert TK.get("PMTORCH_RETRY_MAX", "7") == "7"
    monkeypatch.setenv("PMTORCH_RETRY_MAX", "5")
    monkeypatch.setenv("PMTORCH_UNDECLARED", "x")
    assert TK.get("PMTORCH_RETRY_MAX") == "5"
    env = TK.environment()
    assert env["PMTORCH_RETRY_MAX"] == "5"
    assert env["PMTORCH_UNDECLARED"] == "x"
    assert list(env) == sorted(env)


# ---- the knobs that give an argument's default, set and read back ------------

def _cube_file(tmp_path):
    from parmmg_tpu_torch.io.medit import MeditMesh, write_mesh
    from parmmg_tpu_torch.utils.fixtures import cube_mesh
    import numpy as np
    vert, tet = cube_mesh(3)
    mm = MeditMesh()
    mm.vert, mm.vref = vert, np.zeros(len(vert), np.int32)
    mm.tetra, mm.tref = tet, np.ones(len(tet), np.int32)
    src = str(tmp_path / "c.mesh")
    write_mesh(src, mm)
    return src


def _cli_bytes(src, out, *flags):
    """The port's CLI on the CPU; the output .mesh and .sol bytes."""
    from parmmg_tpu_torch import cli
    rc = cli.main(["-in", src, "-out", out, "-hsiz", "0.3", "-niter", "1",
                   "-device", "cpu", "-v", "-1", *flags])
    assert rc == 0
    with open(out, "rb") as fh:
        mesh = fh.read()
    with open(out[:-5] + ".sol", "rb") as fh:
        return mesh, fh.read()


def _spy(monkeypatch, mod, name, seen, **force):
    """Wrap ``mod.name``: record its keyword arguments, add ``force``."""
    real = getattr(mod, name)

    def call(*a, **k):
        k.update(force)
        seen.append(dict(k))
        return real(*a, **k)
    monkeypatch.setattr(mod, name, call)


def test_cycle_block_knob_equals_the_argument(tmp_path, monkeypatch):
    """``PMTORCH_CYCLE_BLOCK=3`` reaches ``adapt_mesh(cycle_block=3)`` (the
    CPU's default is 1) and writes the bytes of the argument form."""
    from parmmg_tpu_torch import driver
    src = _cube_file(tmp_path)
    monkeypatch.delenv("PMTORCH_CYCLE_BLOCK", raising=False)
    plain = _cli_bytes(src, str(tmp_path / "p.mesh"))
    seen = []
    with monkeypatch.context() as mp:
        _spy(mp, driver, "adapt_mesh", seen, cycle_block=3)
        arg = _cli_bytes(src, str(tmp_path / "a.mesh"))
    assert [k["cycle_block"] for k in seen] == [3]
    seen.clear()
    monkeypatch.setenv("PMTORCH_CYCLE_BLOCK", "3")
    _spy(monkeypatch, driver, "adapt_mesh", seen)
    knob = _cli_bytes(src, str(tmp_path / "k.mesh"))
    assert [k["cycle_block"] for k in seen] == [3]
    assert knob == arg and knob != plain


def test_incr_topo_knob_equals_the_argument(tmp_path, monkeypatch):
    """``PMTORCH_INCR_TOPO=1`` reaches every grouped pass as ``incr=True``,
    runs the band merges, and writes the bytes of the argument form (the
    band merges are exact: the bytes of the default too)."""
    from parmmg_tpu_torch.ops import topo_incr
    from parmmg_tpu_torch.parallel import groups
    src = _cube_file(tmp_path)
    flags = ("-mesh-size", "60")
    monkeypatch.delenv("PMTORCH_INCR_TOPO", raising=False)
    plain = _cli_bytes(src, str(tmp_path / "p.mesh"), *flags)
    seen = []
    with monkeypatch.context() as mp:
        _spy(mp, groups, "grouped_adapt_pass", seen, incr=True)
        arg = _cli_bytes(src, str(tmp_path / "a.mesh"), *flags)
    seen.clear()
    monkeypatch.setenv("PMTORCH_INCR_TOPO", "1")
    _spy(monkeypatch, groups, "grouped_adapt_pass", seen)
    m0 = topo_incr.COUNTS["edge_merges"]
    knob = _cli_bytes(src, str(tmp_path / "k.mesh"), *flags)
    assert seen and all(k.get("incr") is True for k in seen)
    assert topo_incr.COUNTS["edge_merges"] > m0
    assert knob == arg == plain


def test_trace_knobs_size_the_ring_and_name_the_sink(tmp_path, monkeypatch):
    """``PMTORCH_TRACE_RING`` sizes a new tracer's ring and
    ``PMTORCH_TRACE`` names its JSONL sink, opened at the first emit."""
    import json
    from parmmg_tpu_torch.obs import trace
    path = tmp_path / "t.jsonl"
    monkeypatch.setenv("PMTORCH_TRACE_RING", "8")
    monkeypatch.setenv("PMTORCH_TRACE", str(path))
    tr = trace.Tracer()
    assert tr.ring.maxlen == 8 and not path.exists()
    for i in range(10):
        tr.emit({"name": "knob.test", "i": i})
    assert [r["i"] for r in tr.ring] == list(range(2, 10))
    with open(path) as fh:
        assert [json.loads(ln)["i"] for ln in fh] == list(range(10))
    monkeypatch.delenv("PMTORCH_TRACE_RING")
    assert trace.Tracer(path=str(tmp_path / "u.jsonl")).ring.maxlen == 4096


def test_verbose_knob_sets_the_process_verbosity():
    """``PMTORCH_VERBOSE`` is the verbosity before a driver sets one: a
    level-3 line shows under 3 and not under the default 1."""
    code = ("from parmmg_tpu_torch.obs import trace\n"
            "print(trace.verbosity())\n"
            "trace.log(3, 'level three')\n")
    got = {}
    for v in ("3", None):
        env = {k: x for k, x in os.environ.items() if k != "PMTORCH_VERBOSE"}
        if v is not None:
            env["PMTORCH_VERBOSE"] = v
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                           capture_output=True, text=True, check=True)
        got[v] = r.stdout.split()
    assert got["3"] == ["3", "level", "three"]
    assert got[None] == ["1"]
