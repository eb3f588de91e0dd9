"""The port's flow-sensitive lint core (``parmmg_tpu_torch/lint/flow.py``)
and its rules R8, R9 and R10, in the port's idiom.

Each rule gets dirty and clean fixtures: R8 on ``multihost.rank()``,
``torch.distributed.get_rank()`` and ``knobs.launcher("RANK")`` taint
against ``all_reduce`` / ``barrier`` / ``multihost.agree``; R9 on lock
order, RLock re-entry, a collective or subprocess under a held lock and
``PoolDaemon``'s two thread domains; R10 on ``torch.zeros/ones/full/empty``
and ``torch.nn.functional.pad`` sizes against ``bucket()``.  The summary
cache is content-keyed.  The real tree, linted once for the module with
R8-R10, is green against the port's baseline, and the lint package
imports neither torch, jax nor ``parmmg_tpu``.
"""
import ast
import os

import pytest

from parmmg_tpu_torch import lint as TL
from parmmg_tpu_torch.lint import SourceFile, flow, gate, load_baseline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = "parmmg_tpu_torch/"


def lint_sources(srcs: dict, rules):
    files = {rel: SourceFile(rel, txt) for rel, txt in srcs.items()}
    return TL.run_lint(rules=rules, files=files)


def keys(report):
    return sorted(v.key for v in report.violations)


def details(report):
    return sorted(v.detail for v in report.violations)


@pytest.fixture(scope="module")
def flow_tree():
    return TL.run_lint(ROOT, rules=("R8", "R9", "R10"))


# ---------------------------------------------------------------------------
# R8 SPMD collective alignment
# ---------------------------------------------------------------------------
R8_DIRTY = '''
import torch.distributed as dist
from parmmg_tpu_torch.api import knobs
from parmmg_tpu_torch.parallel import multihost

def divergent_collective(x):
    if multihost.rank() == 0:
        dist.all_reduce(x)            # only rank 0 runs it: wedge

def divergent_exit(x):
    if dist.get_rank() > 0:
        return None
    return multihost.agree(x)         # ranks != 0 already left

def divergence_by_data(state, save):
    save(state, write=multihost.rank() == 0)

def rank_gated_side_effect(log):
    rank = int(knobs.launcher("RANK") or 0)
    if rank == 0:
        log("only rank zero prints")

def transitive(x):
    if multihost.rank() == 1:
        helper(x)

def helper(x):
    dist.barrier()
'''

R8_CLEAN = '''
import torch.distributed as dist
from parmmg_tpu_torch.parallel import multihost
from parmmg_tpu_torch.parallel.multihost import mh_uniform

def agreed_then_collective(local, x):
    # passing a rank-LOCAL value to the agreement is the idiom itself;
    # its RESULT is uniform, so the guard is aligned
    flags = multihost.agree(local)
    if max(flags) > 0:
        return multihost.all_gather_rows(x)
    return None

def blessed_write(state, save, multi):
    save(state, write=mh_uniform(
        (not multi) or multihost.rank() == 0,
        "rank-0-writes: payload agreed upstream"))

def uniform_guard_collective(x, n):
    # no rank taint at all: every rank computes the same n
    if n > 3:
        dist.barrier()
    return x
'''


def test_r8_dirty_fixture_flags_all_four_shapes():
    det = details(lint_sources({T + "fx/spmd_dirty.py": R8_DIRTY},
                               ("R8",)))
    assert "divergent-collective:all_reduce" in det
    assert "divergent-collective:helper" in det
    assert any(d.startswith("collective-after-divergent-exit:agree")
               for d in det)
    assert "rank-tainted-arg:save" in det
    assert "rank-gated-call:log" in det


def test_r8_clean_fixture_and_def_line_suppression():
    assert keys(lint_sources({T + "fx/spmd_clean.py": R8_CLEAN},
                             ("R8",))) == []
    src = '''
import torch.distributed as dist

def dec(f):
    return f

# lint: ok(R8) — fixture: the whole function is a blessed rank-scoped
# action (engine def-anchor resolution, decorated def)
@dec
def rank_zero_reporter(x):
    if dist.get_rank() == 0:
        dist.barrier()
'''
    rep = lint_sources({T + "fx/spmd_supp.py": src}, ("R8",))
    assert keys(rep) == [] and len(rep.suppressed) == 1


# ---------------------------------------------------------------------------
# R9 lock discipline
# ---------------------------------------------------------------------------
R9_ORDER_DIRTY = '''
import threading

_A = threading.Lock()
_B = threading.Lock()

def ab():
    with _A:
        with _B:
            return 1

def ba():
    with _B:
        with _A:
            return 2
'''

R9_RLOCK_CLEAN = '''
import threading

class Reentrant:
    def __init__(self):
        self._lock = threading.RLock()

    def outer(self):
        with self._lock:
            return self.inner()

    def inner(self):
        with self._lock:       # RLock re-entry is its contract
            return 1
'''

R9_DISPATCH_DIRTY = '''
import subprocess
import threading
import torch.distributed as dist

_STREAM_LOCK = threading.Lock()

class Holder:
    def __init__(self):
        self._lock = threading.Lock()

    def direct(self):
        with self._lock:
            subprocess.run(["true"])          # a wedge holds the lock

    def transitive(self):
        with self._lock:
            return spawn_helper()

def collective_under_lock(t):
    with _STREAM_LOCK:
        dist.all_reduce(t)

def spawn_helper():
    return subprocess.check_output(["true"])
'''

R9_FIELD = '''
import threading

class PoolDaemon:
    def __init__(self):
        self._lock = threading.RLock()
        self.flag = False

    def handle_rpc(self, method, op):
        return self._dispatch(op)

    def _dispatch(self, op):
        self.flag = True          # handler thread, unguarded

    def _loop(self):
        while True:
            if self.flag:         # loop thread reads it
                break
'''


def test_r9_lock_order_and_self_deadlock():
    rep = lint_sources({T + "fx/locks_cycle.py": R9_ORDER_DIRTY}, ("R9",))
    assert any(d.startswith("lock-order:_") for d in details(rep))
    assert keys(lint_sources({T + "fx/locks_rlock.py": R9_RLOCK_CLEAN},
                             ("R9",))) == []
    dirty = lint_sources({T + "fx/locks_self.py": R9_RLOCK_CLEAN.replace(
        "RLock()", "Lock()")}, ("R9",))
    assert "lock-order:Reentrant._lock->Reentrant._lock" in details(dirty)


def test_r9_dispatch_under_lock_direct_and_transitive():
    det = details(lint_sources({T + "fx/locks_dispatch.py":
                                R9_DISPATCH_DIRTY}, ("R9",)))
    assert "lock-held-dispatch:Holder._lock:run" in det
    assert "lock-held-dispatch:Holder._lock:spawn_helper" in det
    assert "lock-held-dispatch:_STREAM_LOCK:all_reduce" in det


def test_r9_unguarded_cross_thread_field():
    assert "unguarded-field:flag" in details(lint_sources(
        {T + "fx/daemon_field.py": R9_FIELD}, ("R9",)))
    guarded = R9_FIELD.replace(
        "        self.flag = True          # handler thread, unguarded",
        "        with self._lock:\n            self.flag = True")
    assert keys(lint_sources({T + "fx/daemon_ok.py": guarded},
                             ("R9",))) == []


# ---------------------------------------------------------------------------
# R10 shape-ladder escapes
# ---------------------------------------------------------------------------
R10_DIRTY = '''
import torch
import torch.nn.functional as F

def raw_len(pts):
    n = len(pts)
    return torch.zeros(n, 3, dtype=torch.int32)

def raw_measure(counts):
    return torch.ones(int(counts.max()))

def raw_item(counts, dev):
    return torch.empty((3, counts.sum().item()), device=dev)

def raw_full(rows):
    return torch.full((len(rows),), -1)

def raw_pad(x, counts):
    return F.pad(x, (0, int(counts.sum())))

def raw_tolist(counts):
    m = max(counts.tolist())
    return torch.nn.functional.pad(torch.zeros(4), [0, m])
'''

R10_CLEAN = '''
import numpy as np
import torch
from parmmg_tpu_torch.utils.compilecache import bucket

def bucketed(pts):
    cap = bucket(len(pts))
    return torch.zeros(cap, dtype=torch.int32)

def ladder_wrapper(n):
    # its returns ride the ladder: recognized by the summary fixpoint
    return bucket(2 * n)

def via_wrapper(pts):
    return torch.zeros(ladder_wrapper(len(pts)))

def from_existing_shape(t):
    # a tensor built at a bucketed capacity carries its ladder
    return torch.zeros(t.shape[0], 6), torch.empty(t.numel())

def from_parameter(cap):
    # the caller's measurement site is where the check happens
    return torch.full((cap * 6,), -1)

def host_array(pts):
    return np.zeros(len(pts))          # a host array is no sink
'''


def test_r10_dirty_fixture_flags_raw_measurements():
    det = details(lint_sources({T + "fx/shapes_dirty.py": R10_DIRTY},
                               ("R10",)))
    assert det == sorted([
        "raw-shape:zeros:len()", "raw-shape:ones:.max()",
        "raw-shape:empty:.item()", "raw-shape:full:len()",
        "raw-shape:pad:.sum()", "raw-shape:pad:.tolist()"])


def test_r10_clean_fixture_is_quiet():
    assert keys(lint_sources({T + "fx/shapes_clean.py": R10_CLEAN},
                             ("R10",))) == []


# ---------------------------------------------------------------------------
# summary cache: content-keyed invalidation
# ---------------------------------------------------------------------------
def test_file_summary_invalidates_on_content_change():
    flow.summary_cache_clear()
    calls = []

    def compute(sf):
        calls.append(sf.rel)
        return len(sf.text)

    a1 = SourceFile(T + "fx/cache.py", "def a():\n    pass\n")
    assert flow.file_summary(a1, "t", compute) == len(a1.text)
    assert flow.file_summary(a1, "t", compute) == len(a1.text)
    assert len(calls) == 1
    a2 = SourceFile(T + "fx/cache.py", "def a():\n    return 1\n")
    assert flow.file_summary(a2, "t", compute) == len(a2.text)
    assert len(calls) == 2
    a3 = SourceFile(T + "fx/cache.py", a1.text)
    assert flow.file_summary(a3, "t", compute) == len(a1.text)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# the real tree and the package's own imports
# ---------------------------------------------------------------------------
def test_real_tree_flow_rules_are_green(flow_tree):
    baseline = load_baseline(os.path.join(ROOT, TL.BASELINE_REL))
    result = gate(flow_tree, baseline)
    assert result.ok, "\n".join(
        f"{v.rule} {v.path}:{v.line} {v.message}" for v in result.new)
    for _, s in flow_tree.suppressed:
        assert s.reason.strip()
    # the daemon's RLock, found by the detector, is in the picture
    assert any("daemon" in v.detail for v in flow_tree.violations)


def test_lint_package_imports_no_torch_jax_or_parmmg_tpu():
    pkg = os.path.join(ROOT, "parmmg_tpu_torch", "lint")
    mods = set()
    for fn in sorted(os.listdir(pkg)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(pkg, fn)) as fh:
            tree = ast.parse(fh.read())
        for n in ast.walk(tree):
            if isinstance(n, ast.Import):
                mods |= {a.name.split(".")[0] for a in n.names}
            elif isinstance(n, ast.ImportFrom) and n.level == 0:
                mods.add(n.module.split(".")[0])
    assert mods <= {"__future__", "argparse", "ast", "collections",
                    "dataclasses", "hashlib", "json", "os", "re",
                    "subprocess", "sys", "time"}, mods
