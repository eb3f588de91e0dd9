"""The port's static linter (``parmmg_tpu_torch/lint``): the name rules
R2, R3, R4, R6 and R7, the engine, the command line and the real tree.

Each rule gets a dirty and a clean fixture in the port's idiom (torch
host reads, ``knobs.get``, ``multihost.pull_host``).  The engine is held
to the JAX package's: the same fixture files, under ``parmmg_tpu/`` for
the JAX linter and under ``parmmg_tpu_torch/`` for the port's, give equal
violation keys (paths mapped) for SUPP, R3, R6 and R9, and equal
``gate()`` and ``baseline_payload()`` results.  The real tree is linted
once for the module: the gate is green against
``parmmg_tpu_torch/lint/baseline.json``, R4 is clean, and
``python -m parmmg_tpu_torch.lint`` exits 0 without importing torch, jax
or ``parmmg_tpu``.

Fixture text that must not read as a suppression of this file itself (a
reasonless or unknown-rule one) is concatenated, since both linters scan
``tests/``.
"""
import json
import os
import subprocess
import sys

import pytest

from parmmg_tpu import lint as JL
from parmmg_tpu_torch import lint as TL
from parmmg_tpu_torch.lint import SourceFile, gate, load_baseline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, J = "parmmg_tpu_torch/", "parmmg_tpu/"


def lint_sources(srcs: dict, rules, readme_text: str = "", pkg=TL):
    """Run a rule subset of ``pkg``'s linter over {relpath: source}."""
    files = {rel: pkg.SourceFile(rel, txt) for rel, txt in srcs.items()}
    return pkg.run_lint(rules=rules, files=files, readme_text=readme_text)


def keys(report):
    return sorted(v.key for v in report.violations)


def details(report):
    return sorted(v.detail for v in report.violations)


@pytest.fixture(scope="module")
def tree():
    """The real tree linted once, every rule."""
    return TL.run_lint(ROOT)


# ---------------------------------------------------------------------------
# R2 host-sync reachability
# ---------------------------------------------------------------------------
R2_DIRTY = '''
import torch

def grouped_adapt_pass(state, counts):            # root
    n = int(counts[0])
    return helper(state) + n

def helper(state):                                # reachable
    torch.cuda.synchronize()
    idx = torch.nonzero(state)
    return state.sum().item() + state.cpu().numpy().size + len(
        state.to("cpu").tolist()) + idx.shape[0]

def cold_path(state):                             # NOT reachable
    return state.item()
'''


def test_r2_flags_every_primitive_on_the_hot_path_only():
    rep = lint_sources({T + "ops/x.py": R2_DIRTY}, ["R2"])
    assert sorted((v.scope, v.detail) for v in rep.violations) == sorted([
        ("grouped_adapt_pass", "int()"),
        ("helper", '.to("cpu")'), ("helper", ".cpu()"),
        ("helper", ".item()"), ("helper", ".numpy()"),
        ("helper", ".tolist()"), ("helper", "torch.cuda.synchronize"),
        ("helper", "torch.nonzero")])
    # the JAX package scans parallel/ only; the port's ops/ run eagerly
    assert keys(lint_sources({T + "io/x.py": R2_DIRTY}, ["R2"])) == []


def test_r2_clean_host_producers_and_def_line_fallback():
    src = ('import time\n'
           'from parmmg_tpu_torch.api import knobs\n'
           'def grouped_adapt_pass(s, pts):\n'
           '    t = float(time.perf_counter())\n'
           '    b = int(knobs.get("PMTORCH_GROUP_CHUNK") or 0)\n'
           '    return fallback(s) + t + b + int(len(pts))\n'
           '# lint: ok(R2) — documented KS-overflow host fallback\n'
           'def fallback(s):\n'
           '    return s.cpu().numpy()\n')
    rep = lint_sources({T + "parallel/x.py": src}, ["R2"])
    assert keys(rep) == []
    assert sorted((v.detail, s.reason) for v, s in rep.suppressed) == [
        (".cpu()", "documented KS-overflow host fallback"),
        (".numpy()", "documented KS-overflow host fallback")]


# ---------------------------------------------------------------------------
# R3 obs-routing
# ---------------------------------------------------------------------------
def test_r3_flags_print_outside_obs_only():
    srcs = {T + "ops/a.py": "def f():\n    print('x')\n",
            T + "obs/b.py": "def g():\n    print('x')\n",
            "tests/test_torch_c.py": "print('a test may print')\n",
            "chip_smoke.py": "print('[build] ...')\n"}
    rep = lint_sources(srcs, ["R3"])
    assert [v.path for v in rep.violations] == [T + "ops/a.py"]
    ok = "def f():\n    print('x')  # lint: ok(R3) — stdout contract\n"
    rep = lint_sources({T + "cli.py": ok}, ["R3"])
    assert keys(rep) == [] and len(rep.suppressed) == 1


# ---------------------------------------------------------------------------
# R4 knob registry
# ---------------------------------------------------------------------------
KNOBS_FIXTURE = '''
class Knob:
    def __init__(self, type, default, doc): pass

KNOBS: dict = {
    "PMTORCH_GOOD": Knob("int", "1", "a used knob"),
    "PMTORCH_DEAD": Knob("int", "0", "nothing reads this"),
}

def get(name, default=None):
    import os
    return os.environ.get(name, default)
'''

R4_READS = '''
import os
from parmmg_tpu_torch.api import knobs
from parmmg_tpu_torch.resilience.watchdog import deadline_knob
a = knobs.get("PMTORCH_GOOD")
b = knobs.get("PMTORCH_ROGUE")
c = deadline_knob("PMTORCH_ALSO_ROGUE")
d = os.environ.get("HOME", "")
e = knobs.get("PMTORCH_" + a)
os.environ["PMTORCH_GOOD"] = "2"      # a write, not a read
'''


def test_r4_rogue_direct_dynamic_dead_and_readme_drift():
    rep = lint_sources(
        {T + "api/knobs.py": KNOBS_FIXTURE, T + "ops/x.py": R4_READS},
        ["R4"], readme_text="only PMTORCH_GOOD, PMTORCH_RETRY_* and "
                            "PMTORCH_GHOST here")
    assert sorted((v.detail, v.path) for v in rep.violations) == [
        ("PMTORCH_ALSO_ROGUE", T + "ops/x.py"),
        ("PMTORCH_DEAD", T + "api/knobs.py"),
        ("PMTORCH_DEAD", T + "api/knobs.py"),
        ("PMTORCH_GHOST", "README.md"),
        ("PMTORCH_ROGUE", T + "ops/x.py"),
        ("direct-env-read", T + "ops/x.py"),
        ("dynamic-env-read", T + "ops/x.py")]
    msgs = [v.message for v in rep.violations if v.detail == "PMTORCH_DEAD"]
    assert any("read nowhere" in m for m in msgs)
    assert any("missing from README" in m for m in msgs)
    # R4 never takes the baseline
    rogue = [v for v in rep.violations if v.detail == "PMTORCH_ROGUE"]
    res = gate(rep, {rogue[0].key: 99})
    assert any(v.detail == "PMTORCH_ROGUE" for v in res.new)


def test_r4_clean_when_registry_readme_and_reads_agree():
    rep = lint_sources(
        {T + "api/knobs.py": KNOBS_FIXTURE.replace(
            '    "PMTORCH_DEAD": Knob("int", "0", "nothing reads this"),\n',
            ""),
         T + "ops/x.py": 'from parmmg_tpu_torch.api import knobs\n'
                         'v = int(knobs.get("PMTORCH_GOOD"))\n',
         # the tests set and read knobs freely: outside R4's scope
         "tests/test_torch_x.py": 'import os\n'
                                  'os.environ.get("PMTORCH_ANY")\n'},
        ["R4"], readme_text="`PMTORCH_GOOD` does things")
    assert keys(rep) == []


# ---------------------------------------------------------------------------
# R6 name schemes
# ---------------------------------------------------------------------------
FAULTS_FIXTURE = 'SITES = {"polish.worker": "exit", "halo.exchange": "xla"}\n'
RECOVER_FIXTURE = 'LADDER = ("retry", "halo_dense", "lowfailure")\n'
R6_SRC = ('from parmmg_tpu_torch.obs.metrics import REGISTRY\n'
          'from parmmg_tpu_torch.obs import trace as otrace\n'
          'from parmmg_tpu_torch.resilience.faults import faultpoint\n'
          'from parmmg_tpu_torch.resilience.recover import ladder_step\n'
          'def f(k, ok):\n'
          '    REGISTRY.counter(f"serve.{k}").inc()\n'
          '    REGISTRY.gauge("Serve.BadCase").set(1)\n'
          '    REGISTRY.counter("serve.ok" if ok else "serve.bad").inc()\n'
          '    otrace.event("serve." + k)\n'
          '    faultpoint("halo.exchange")\n'
          '    faultpoint("made.up_site")\n'
          '    ladder_step("halo_dense", site="halo.exchange")\n'
          '    ladder_step("wishful_step")\n')


def _r6(pkg_prefix, src, pkg=TL):
    return lint_sources(
        {pkg_prefix + "resilience/faults.py": FAULTS_FIXTURE,
         pkg_prefix + "resilience/recover.py": RECOVER_FIXTURE,
         pkg_prefix + "serve/x.py": src}, ["R6"], pkg=pkg)


def test_r6_dynamic_malformed_and_unregistered_names():
    assert details(_r6(T, R6_SRC)) == [
        "event:dynamic", "faultpoint:made.up_site",
        "ladder_step:wishful_step", "metric.counter:dynamic",
        "metric.gauge:Serve.BadCase"]
    clean = "\n".join(ln for ln in R6_SRC.splitlines()
                      if "f\"serve" not in ln and "Bad" not in ln
                      and "made" not in ln and "wishful" not in ln
                      and "+ k" not in ln) + "\n"
    assert keys(_r6(T, clean)) == []


# ---------------------------------------------------------------------------
# R7 hot allgather
# ---------------------------------------------------------------------------
R7_SRC = '''
from parmmg_tpu_torch.parallel import multihost, pod

def distributed_adapt_multi(stacked, glo):          # R7 root
    tables = pod.gather_band(stacked.vmask, what="extend")
    masks = multihost.pull_host(stacked.vmask, what="host_extend")
    recs = multihost.all_gather_json({"n": 1})
    return tables, masks, recs, save(stacked)

# lint: ok(R7) — checkpoint IO under cold_io, on the checkpoint cadence
def save(stacked):
    with multihost.cold_io():
        return multihost.pull_host(stacked.vert, what="ckpt")

def report(x):                                      # not reachable
    return multihost.pull_host(x)
'''


def test_r7_flags_host_gathers_on_the_pod_hot_path():
    rep = lint_sources({T + "parallel/x.py": R7_SRC}, ["R7"])
    assert sorted((v.scope, v.detail) for v in rep.violations) == [
        ("distributed_adapt_multi", "all_gather_json"),
        ("distributed_adapt_multi", "pull_host")]
    assert [v.scope for v, _ in rep.suppressed] == ["save"]


# ---------------------------------------------------------------------------
# suppression grammar
# ---------------------------------------------------------------------------
def test_suppression_grammar():
    bad = "def f():\n    print('x')  # lint: " + "ok(R3)\n"
    rep = lint_sources({T + "ops/a.py": bad}, ["R3"])
    assert len(rep.violations) == 1
    assert [v.rule for v in rep.bad] == ["SUPP"] and not gate(rep, {}).ok
    # R1 and R5 are not rules of the port: naming them is a SUPP finding
    for rid in ("R99", "R1", "R5"):
        src = "x = 1  # lint: " + f"ok({rid}) — sounds official\n"
        rep = lint_sources({T + "ops/a.py": src}, ["R3"])
        assert "unknown rule" in rep.bad[0].message
    wrapped = ("def f():\n"
               "    # lint: ok(R3) — a reason that wraps onto the\n"
               "    # next comment line before the code\n"
               "    print('x')\n")
    rep = lint_sources({T + "ops/a.py": wrapped}, ["R3"])
    assert keys(rep) == [] and len(rep.suppressed) == 1
    with pytest.raises(ValueError, match="unknown lint rule"):
        TL.run_lint(rules=("R1",), files={})


# ---------------------------------------------------------------------------
# the engine against the JAX package's
# ---------------------------------------------------------------------------
PARITY_FILES = {
    "ops/prints.py": "def f():\n    print('a')\n    print('b')\n"
                     "def g():\n    print('c')  # lint: ok(R3) — contract\n",
    "obs/ok.py": "def h():\n    print('obs may print')\n",
    "ops/supp.py": "x = 1  # lint: " + "ok(R3)\n"
                   "y = 2  # lint: " + "ok(R77) — not a rule\n",
    "resilience/faults.py": FAULTS_FIXTURE,
    "resilience/recover.py": RECOVER_FIXTURE,
    "serve/names.py": R6_SRC.replace("parmmg_tpu_torch", "pkg"),
    "serve/daemon.py": '''
import subprocess
import threading

class PoolDaemon:
    def __init__(self):
        self._lock = threading.RLock()
        self._a = threading.Lock()
        self._b = threading.Lock()
        self.flag = False

    def _dispatch(self, op):
        self.flag = True
        with self._lock:
            return spawn()

    def _loop(self):
        while not self.flag:
            with self._a:
                with self._b:
                    pass

    def other(self):
        with self._b:
            with self._a:
                pass

def spawn():
    return subprocess.check_output(["true"])
''',
}


def _both(rules):
    jrep = lint_sources({J + k: v for k, v in PARITY_FILES.items()}, rules,
                        pkg=JL)
    trep = lint_sources({T + k: v for k, v in PARITY_FILES.items()}, rules,
                        pkg=TL)
    return jrep, trep


def _mapped(ks):
    return sorted(k.replace(T, J) for k in ks)


@pytest.mark.parametrize("rule", ("R3", "R6", "R9"))
def test_engine_parity_with_the_jax_linter(rule):
    jrep, trep = _both((rule,))
    assert keys(jrep) and _mapped(keys(trep)) == keys(jrep)
    assert _mapped(v.key for v in trep.bad) == \
        sorted(v.key for v in jrep.bad)
    assert [v.rule for v in trep.bad] == ["SUPP", "SUPP"]
    assert _mapped(v.key for v, _ in trep.suppressed) == \
        sorted(v.key for v, _ in jrep.suppressed)
    jpay, tpay = JL.baseline_payload(jrep), TL.baseline_payload(trep)
    assert tpay["version"] == jpay["version"]
    assert {k.replace(T, J): n for k, n in tpay["grandfathered"].items()} \
        == jpay["grandfathered"]
    # the gate on a baseline that holds all but one finding of each key
    base_j = {k: n - 1 for k, n in jpay["grandfathered"].items()}
    base_t = {k: n - 1 for k, n in tpay["grandfathered"].items()}
    base_j["R3:parmmg_tpu/ops/gone.py:f:print"] = 2
    base_t["R3:parmmg_tpu_torch/ops/gone.py:f:print"] = 2
    jg, tg = JL.gate(jrep, base_j), TL.gate(trep, base_t)
    assert _mapped(v.key for v in tg.new) == sorted(v.key for v in jg.new)
    assert tg.burndown == jg.burndown and tg.ok == jg.ok is False


def test_baseline_pinning_and_payload_roundtrip(tmp_path):
    two = "def f():\n    print('a')\n    print('b')\n"
    rep = lint_sources({T + "ops/a.py": two}, ["R3"])
    key = rep.violations[0].key
    assert gate(rep, {key: 2}).ok
    res = gate(rep, {key: 1})
    assert not res.ok and len(res.new) == 1
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps(TL.baseline_payload(rep)))
    assert gate(rep, load_baseline(str(p))).ok


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------
def test_real_tree_gate_is_green(tree):
    baseline = load_baseline(os.path.join(ROOT, TL.BASELINE_REL))
    result = gate(tree, baseline)
    assert result.ok, TL.format_report(tree, result)
    assert not any(k.startswith("R4:") for k in baseline)
    for _, s in tree.suppressed:
        assert s.reason.strip()
    # the scan covers the package, its tests and the smoke script
    paths = {v.path for v, _ in tree.suppressed} | \
        {v.path for v in tree.violations}
    assert any(p.startswith(T) for p in paths)
    files = TL.collect_files(ROOT)
    assert "chip_smoke.py" in files and "tests/torch_parity.py" in files
    assert "tests/test_torch_lint.py" in files
    assert not any(f.startswith(J) or f == "tests/test_lint.py"
                   for f in files)


def test_real_tree_r4_is_clean(tree):
    assert [v for v in tree.violations if v.rule == "R4"] == []


def test_command_line_is_green_and_imports_nothing_heavy(tmp_path):
    sarif = tmp_path / "lint.sarif"
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from parmmg_tpu_torch.lint.__main__ import main\n"
         f"rc = main(['--sarif', {str(sarif)!r}])\n"
         "bad = [m for m in ('torch', 'jax', 'parmmg_tpu') "
         "if m in sys.modules]\n"
         "print('loaded', bad)\n"
         "sys.exit(rc or (3 if bad else 0))\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "lint: OK" in r.stdout and "loaded []" in r.stdout
    doc = json.loads(sarif.read_text())
    assert doc["version"] == "2.1.0" and doc["runs"][0]["results"]
    r = subprocess.run([sys.executable, "-m", "parmmg_tpu_torch.lint",
                        "--rules", "R1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 2 and "unknown lint rule" in r.stderr
