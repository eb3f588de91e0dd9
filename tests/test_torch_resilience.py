"""The port's resilience layer held against the JAX package:
``resilience/recover.py``, ``resilience/checkpoint.py``, the rest of
``resilience/faults.py`` and ``resilience/watchdog.py``, and their wiring
into ``parallel/groups.py`` and the driver.

Exact against the JAX package: ``retry_call`` gives the same result or
exception, ``__cause__``, calls, ladder events and counters for the same
scripted failures (``base_s=0``); ``run_fingerprint`` gives the same
digest on the same numpy input; a pass checkpoint written by either
package loads in the other to equal arrays of equal dtypes.  The JAX
package under ``jax.disable_jit()`` (in a background thread while the
port-only tests run) writes pass 0's checkpoint of ``grouped_adapt`` on
cube_mesh(2) at target 16 (3 groups, chunk 2, 2 cycles, as
``scripts/chaos_check.py`` does), then resumes from that file into pass
1; the port resumes from the same file: its pass 1 equals the JAX
package's, integer arrays bit for bit, ``vert`` and the metric within
1e-5 (``tests/test_torch_groups.py``'s tolerances).

Port-only, as in ``tests/test_resilience.py`` and
``tests/test_watchdog.py``: checkpoint cadence, the stale-fingerprint
skip, ``.tmp`` partials never taken, the ``io.checkpoint`` fault absorbed,
the crash-loop counts and escalation, ``PMTORCH_FAULT`` arming the
registry, the forced-fault environment of a subprocess site.  And bit for
bit against the fault-free run (every field and the metric): an nth-1
``dispatch.chunk`` fault (also with the band merges on), the
``dispatch.chunk:hang=3;nth-1`` wedge under a 0.5 s dispatch deadline, a
run resumed from its own pass 0 checkpoint, the subprocess polish worker
on the CPU against the in-process polish, a dead and a hung worker
against the polish-less pass (no staging directory left behind); retry
exhaustion through ``ParMesh.run`` returns ``PMMG_LOWFAILURE`` with a
conforming mesh whose volumes sum to the cube's (1e-5).
"""
import os
import tempfile
import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.obs import metrics as JM
from parmmg_tpu.obs import trace as JT
from parmmg_tpu.parallel import groups as JG
from parmmg_tpu.resilience import checkpoint as JC
from parmmg_tpu.resilience import faults as JF
from parmmg_tpu.resilience import recover as JR
from parmmg_tpu_torch.core import constants as C
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.obs import metrics as TM
from parmmg_tpu_torch.obs import trace as TT
from parmmg_tpu_torch.ops import analysis as TN
from parmmg_tpu_torch.parallel import groups as TG
from parmmg_tpu_torch.resilience import checkpoint as TC
from parmmg_tpu_torch.resilience import faults as TF
from parmmg_tpu_torch.resilience import recover as TR
from parmmg_tpu_torch.utils.fixtures import analytic_iso_metric, cube_mesh
from torch_parity import jax_ledger_listener_compat  # noqa: F401

TARGET, CYCLES, NITER = 16, 2, 2        # cube_mesh(2): 48 tets, 3 groups


def _cube2():
    """cube_mesh(2) at 4x capacity, analysed, met 0.35 (chaos_check's
    case)."""
    v, t = cube_mesh(2)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=4 * len(v),
                                        capT=4 * len(t))).mesh
    return m, torch.full((m.capP,), 0.35, dtype=torch.float32)


def _shock3():
    """cube_mesh(3) at 4x capacity under the shock size map h = 0.3: the
    polish acts on its 4 groups."""
    v, t = cube_mesh(3)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=4 * len(v),
                                        capT=4 * len(t))).mesh
    h = np.ones(m.capP, np.float32)
    h[: len(v)] = analytic_iso_metric(v, "shock", h=0.3)
    return m, torch.from_numpy(h)


def _to_jax(tm):
    f = tmesh.mesh_to_numpy(tm)
    return jmesh.Mesh(**{k: jnp.asarray(v) for k, v in f.items()})


def _bytes(mesh, met):
    return tuple(getattr(mesh, f).cpu().numpy().tobytes()
                 for f in tmesh.MESH_FIELDS) + (met.cpu().numpy().tobytes(),)


def _grouped(**kw):
    m, met = _cube2()
    kw.setdefault("chunk", 2)
    out, met2 = TG.grouped_adapt(m, met, TARGET, niter=NITER, cycles=CYCLES,
                                 **kw)
    return _bytes(out, met2)


def _counter(reg, name):
    return reg.snapshot()["counters"].get(name, 0)


@pytest.fixture()
def knobs(monkeypatch):
    """Set port knobs for one test, the fault registry re-read at entry
    and exit; backoff off."""
    for k in ("PMTORCH_FAULT", "PMTORCH_CKPT_DIR", "PMTORCH_RETRY_MAX",
              "PMTORCH_DEADLINE_DISPATCH_S", "PMTORCH_POLISH_SUBPROC",
              "PMTORCH_POLISH_TIMEOUT_S"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PMTORCH_RETRY_BASE_S", "0")
    TF.FAULTS.reset()

    def set_(**kv):
        for k, v in kv.items():
            monkeypatch.setenv(k, str(v))
        TF.FAULTS.reset()
    yield set_
    TF.FAULTS.reset()


@pytest.fixture(scope="module")
def base_bytes():
    """The fault-free chunked grouped run's bytes."""
    return _grouped()


# ---- JAX-written checkpoint, resumed by both packages ------------------------

_JAX_POLISH = Future()


@pytest.fixture(scope="module", autouse=True)
def jax_resume():
    """In a background thread started with the module (so that the
    port-only tests run meanwhile), eagerly: the JAX package's grouped_adapt
    writes its pass checkpoints (PARMMG_CKPT_DIR, chunk 2), the last one
    is removed (a kill after pass 0), and it resumes from pass 0's file.
    A future of (checkpoint dir, JAX-resumed mesh, metric).  Then the
    same thread sets ``_JAX_POLISH`` to the JAX package's
    ``grouped_adapt_pass(polish=True)`` of ``_shock3``."""
    mp = pytest.MonkeyPatch()
    td = tempfile.mkdtemp(prefix="torch_resume_")
    mp.setenv("PARMMG_CKPT_DIR", td)
    mp.setenv("PARMMG_GROUP_CHUNK", "2")
    mp.setenv("PARMMG_SWAP_FACESORT", "1")
    mp.delenv("PARMMG_FAULT", raising=False)
    m, met = _cube2()
    jm, jmet = _to_jax(m), jnp.asarray(met.numpy())
    fut = Future()

    def run():
        try:
            with jax.disable_jit():
                JG.grouped_adapt(jm, jmet, TARGET, niter=NITER,
                                 cycles=CYCLES, ckpt_tag="jx")
                os.unlink(os.path.join(td, f"jx.pass{NITER - 1}.npz"))
                out, met2 = JG.grouped_adapt(jm, jmet, TARGET, niter=NITER,
                                             cycles=CYCLES, ckpt_tag="jx",
                                             resume=True)
            fut.set_result((td, out, met2))
        except BaseException as e:           # noqa: BLE001 (passed on)
            fut.set_exception(e)
        # then the grouped polish of _shock3 (4 groups, chunk 2: the
        # wave-major polish), eagerly, for test_grouped_polish_matches_jax
        try:
            sm, smet = _shock3()
            with jax.disable_jit():
                _JAX_POLISH.set_result(JG.grouped_adapt_pass(
                    _to_jax(sm), jnp.asarray(smet.numpy()), 4, cycles=2,
                    polish=True))
        except BaseException as e:           # noqa: BLE001 (passed on)
            _JAX_POLISH.set_exception(e)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    yield fut
    th.join()
    mp.undo()


# ---- retry + ladder ----------------------------------------------------------

def _scripted(mod_r, reg, tracer, fails, exc_at=None, **kw):
    """retry_call over a function failing its first ``fails`` calls
    (``exc_at``: the call raising a capacity signal instead).  Returns
    (outcome, cause, calls, ladder events, counter deltas)."""
    calls = []

    def fn():
        calls.append(1)
        n = len(calls)
        if exc_at is not None and n == exc_at[0]:
            raise exc_at[1]("capacity")
        if n <= fails:
            raise RuntimeError(f"fail {n}")
        return f"ok after {n}"
    names = ("resilience.retry", "resilience.retry_exhausted")
    c0 = [_counter(reg, n) for n in names]
    mark = tracer.summary()["events"]
    try:
        out = ("value", mod_r.retry_call(fn, site="t.site", base_s=0, **kw))
        cause = None
    except Exception as e:
        out = ("raise", type(e).__name__, str(e))
        cause = None if e.__cause__ is None else \
            (type(e.__cause__).__name__, str(e.__cause__))
    new = tracer.summary()["events"] - mark
    ring = list(tracer.ring)[-new:] if new else []
    ladder = [(r["step"], r["site"], r["detail"]) for r in ring
              if r.get("name") == "resilience.ladder"]
    return out, cause, len(calls), ladder, \
        [_counter(reg, n) - c for n, c in zip(names, c0)]


@pytest.mark.parametrize("fails,kw", [
    (0, {}),
    (2, {"max_retries": 2}),
    (3, {"max_retries": 2}),
    (5, {"max_retries": 0}),
    (0, {"max_retries": 1, "initial_failure": RuntimeError("first")}),
    (9, {"max_retries": 0, "initial_failure": RuntimeError("first")}),
    (1, {"max_retries": 3, "initial_failure": RuntimeError("first")}),
])
def test_retry_call_equals_jax(fails, kw, monkeypatch):
    monkeypatch.delenv("PMTORCH_RETRY_MAX", raising=False)
    monkeypatch.delenv("PARMMG_RETRY_MAX", raising=False)
    got = _scripted(TR, TM.REGISTRY, TT.TRACER, fails, **kw)
    ref = _scripted(JR, JM.REGISTRY, JT.TRACER, fails, **kw)
    assert got == ref


@pytest.mark.parametrize("exc", [MemoryError, torch.cuda.OutOfMemoryError])
def test_capacity_signals_are_never_retried(exc):
    out, cause, calls, ladder, deltas = _scripted(
        TR, TM.REGISTRY, TT.TRACER, 1, exc_at=(2, exc), max_retries=5)
    assert out == ("raise", exc.__name__, "capacity") and calls == 2
    assert [s for s, _, _ in ladder] == ["retry"] and deltas == [1, 0]
    if exc is MemoryError:
        assert (out, cause, calls, ladder, deltas) == _scripted(
            JR, JM.REGISTRY, JT.TRACER, 1, exc_at=(2, exc), max_retries=5)


def test_ladder_order_env_and_unknown_step(monkeypatch):
    assert TR.LADDER == JR.LADDER
    assert set(JR.NEVER_RETRY) < set(TR.NEVER_RETRY)
    with pytest.raises(ValueError):
        TR.ladder_step("nope")
    monkeypatch.setenv("PMTORCH_RETRY_MAX", "0")
    monkeypatch.setenv("PMTORCH_RETRY_BASE_S", "0.5")
    monkeypatch.setenv("PMTORCH_RETRY_DEADLINE_S", "3")
    assert TR.retry_env() == (0, 0.5, 3.0)
    monkeypatch.setenv("PMTORCH_RETRY_MAX", "")
    assert TR.retry_env()[0] == 2


# ---- faults: the environment arms the registry; subprocess sites -------------

def test_fault_env_arms_at_first_use(knobs):
    knobs(PMTORCH_FAULT="dispatch.chunk:nth-2")
    TF.faultpoint("dispatch.chunk")
    with pytest.raises(RuntimeError, match="injected fault"):
        TF.faultpoint("dispatch.chunk")
    TF.faultpoint("dispatch.chunk")
    # an explicit arm holds until the variable changes
    TF.FAULTS.arm("io.checkpoint")
    with pytest.raises(OSError):
        TF.faultpoint("io.checkpoint")
    TF.faultpoint("dispatch.chunk")
    knobs(PMTORCH_FAULT="")
    assert not TF.FAULTS.armed()


def test_subprocess_fault_env_equals_jax(knobs, monkeypatch):
    for spec in ("polish.worker:nth-2", "polish.worker:hang=2.5;nth-1"):
        knobs(PMTORCH_FAULT=spec)
        monkeypatch.setenv("PARMMG_FAULT", spec)
        JF.FAULTS.reset()
        got = [TF.subprocess_fault_env("polish.worker") for _ in range(3)]
        ref = [JF.subprocess_fault_env("polish.worker") for _ in range(3)]
        assert [{k.replace("PMTORCH", "PARMMG"): v for k, v in g.items()}
                for g in got] == ref
        assert sum(bool(g) for g in got) == 1
    JF.FAULTS.reset()


# ---- checkpoints -------------------------------------------------------------

def test_fingerprint_equals_jax():
    m, met = _cube2()
    args = (TARGET, NITER, CYCLES, False, False, False, None, 2)
    f = tmesh.mesh_to_numpy(m)
    jm = jmesh.Mesh(**{k: np.asarray(v) for k, v in f.items()})
    got = TC.run_fingerprint(m, met, *args)
    assert got == JC.run_fingerprint(jm, met.numpy(), *args)
    assert got == JC.run_fingerprint(_to_jax(m), jnp.asarray(met.numpy()),
                                     *args)
    assert got != TC.run_fingerprint(m, met + 1, *args)
    assert got != TC.run_fingerprint(m, met, TARGET + 1, *args[1:])


def test_checkpoints_load_across_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("PMTORCH_CKPT_DIR", str(tmp_path / "t"))
    monkeypatch.setenv("PARMMG_CKPT_DIR", str(tmp_path / "j"))
    m, met = _cube2()
    part = np.arange(int(m.tmask.sum()), dtype=np.int32) % 3
    pt = TC.save_pass_checkpoint("x", 0, m, met, part, fingerprint="fp")
    pj = JC.save_pass_checkpoint("x", 0, _to_jax(m), jnp.asarray(
        met.numpy()), part, fingerprint="fp")
    with np.load(pt) as zt, np.load(pj) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
            assert np.array_equal(zt[k], zj[k]), k
    # each package loads the other's file
    jm, jmet, jpart, jit = JC.load_pass_checkpoint(pt)
    tm, tmet, tpart, tit = TC.load_pass_checkpoint(pj)
    assert jit == tit == 0
    assert np.array_equal(jpart, part) and np.array_equal(tpart, part)
    assert np.array_equal(np.asarray(jmet), met.numpy())
    assert torch.equal(tmet, met)
    got = tmesh.mesh_to_numpy(tm)
    for f in jmesh.MESH_FIELDS:
        a = np.asarray(getattr(jm, f))
        assert a.dtype == got[f].dtype and np.array_equal(a, got[f]), f


def test_checkpoint_roundtrip_latest_and_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("PMTORCH_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("PMTORCH_CKPT_EVERY", "1")
    m, met = _cube2()
    for it in (0, 1):
        assert TC.save_pass_checkpoint("t", it, m, met, None)
    # a kill mid-write leaves only a .tmp partial: never resumed from
    (tmp_path / "t.pass5.npz.tmp").write_bytes(b"partial")
    (tmp_path / "t.pass4.npz").write_bytes(b"not an npz")
    path, it = TC.latest_pass_checkpoint("t")
    assert it == 1 and path.endswith("t.pass1.npz")
    m2, met2, part2, it2 = TC.load_pass_checkpoint(path)
    assert it2 == 1 and part2 is None and torch.equal(met2, met)
    assert _bytes(m2, met2) == _bytes(m, met)


def test_checkpoint_cadence_and_disabled(tmp_path, monkeypatch):
    monkeypatch.delenv("PMTORCH_CKPT_DIR", raising=False)
    assert TC.save_pass_checkpoint("t", 0, None, None, None) is None
    assert TC.latest_pass_checkpoint("t") is None
    assert TC.snapshot_stacked("t", 0, None, 1) == []
    monkeypatch.setenv("PMTORCH_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("PMTORCH_CKPT_EVERY", "2")
    assert not TC.ckpt_due(0) and TC.ckpt_due(1) and not TC.ckpt_due(2)


def test_checkpoint_fault_is_absorbed(tmp_path, monkeypatch, knobs):
    monkeypatch.setenv("PMTORCH_CKPT_DIR", str(tmp_path))
    knobs(PMTORCH_FAULT="io.checkpoint")
    before = _counter(TM.REGISTRY, "resilience.checkpoint_failures")
    m, met = _cube2()
    assert TC.save_pass_checkpoint("t", 0, m, met, None) is None
    assert _counter(TM.REGISTRY, "resilience.checkpoint_failures") == \
        before + 1
    assert list(tmp_path.iterdir()) == []


def test_checkpoint_fingerprint_guards_stale_resume(tmp_path, monkeypatch):
    monkeypatch.setenv("PMTORCH_CKPT_DIR", str(tmp_path))
    m, met = _cube2()
    fp_a = TC.run_fingerprint(m, met, 16, 2)
    fp_b = TC.run_fingerprint(m, met + 1, 16, 2)
    assert fp_a != fp_b
    assert TC.save_pass_checkpoint("t", 0, m, met, None, fingerprint=fp_a)
    assert TC.latest_pass_checkpoint("t", fingerprint=fp_a) is not None
    assert TC.latest_pass_checkpoint("t", fingerprint=fp_b) is None
    assert TC.save_pass_checkpoint("u", 0, m, met, None)
    assert TC.latest_pass_checkpoint("u", fingerprint=fp_a) is None
    assert TC.latest_pass_checkpoint("u") is not None


def test_crash_loop_breaker_threshold(tmp_path, monkeypatch):
    monkeypatch.setenv("PMTORCH_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("PMTORCH_RESUME_MAX", "2")
    before = _counter(TM.REGISTRY, "resilience.crash_loops")
    assert TC.crash_loop("t15", "fp", 1) == (1, False)
    assert TC.crash_loop("t15", "fp", 1) == (2, False)
    assert TC.crash_loop("t15", "fp", 1) == (3, True)
    assert _counter(TM.REGISTRY, "resilience.crash_loops") == before + 1
    assert TC.crash_loop("t15", "fp", 2) == (1, False)
    assert TC.crash_loop("t15", "other", 1) == (1, False)
    assert TC.crash_loop("t15", "fp", 1, write=False) == (4, True)
    assert TC.crash_loop("t15", "fp", 1, write=False) == (4, True)
    monkeypatch.delenv("PMTORCH_CKPT_DIR")
    for _ in range(3):
        assert TC.crash_loop("t15", "fp", 1) == (1, False)


def test_crash_loop_escalates_to_the_checkpointed_state(tmp_path, knobs,
                                                        monkeypatch):
    """Resumed into the same pass past PMTORCH_RESUME_MAX, grouped_adapt
    returns the checkpointed state (ladder rung lowfailure)."""
    knobs(PMTORCH_CKPT_DIR=tmp_path, PMTORCH_RESUME_MAX=1)
    _grouped(ckpt_tag="cl")
    os.unlink(tmp_path / f"cl.pass{NITER - 1}.npz")
    ck_m, ck_met, _, _ = TC.load_pass_checkpoint(str(tmp_path /
                                                     "cl.pass0.npz"))
    _grouped(ckpt_tag="cl", resume=True)          # attempt 1: resumes
    # ... and "crashes" in pass 1 again: its checkpoint never lands
    os.unlink(tmp_path / f"cl.pass{NITER - 1}.npz")
    before = _counter(TM.REGISTRY, "resilience.lowfailure")
    assert _grouped(ckpt_tag="cl", resume=True) == _bytes(ck_m, ck_met)
    assert _counter(TM.REGISTRY, "resilience.lowfailure") == before + 1


# ---- the grouped path, bit for bit against the fault-free run ----------------

@pytest.mark.parametrize("incr", [False, True])
def test_dispatch_fault_recovers_bitwise(base_bytes, knobs, incr):
    knobs(PMTORCH_FAULT="dispatch.chunk:nth-1")
    c0 = _counter(TM.REGISTRY, "resilience.retry")
    f0 = _counter(TM.REGISTRY, "resilience.faults_injected")
    assert _grouped(incr=incr) == base_bytes
    assert _counter(TM.REGISTRY, "resilience.retry") == c0 + 1
    assert _counter(TM.REGISTRY, "resilience.faults_injected") == f0 + 1


def test_dispatch_hang_under_deadline_recovers_bitwise(base_bytes, knobs):
    knobs(PMTORCH_FAULT="dispatch.chunk:hang=3;nth-1",
          PMTORCH_DEADLINE_DISPATCH_S=0.5, PMTORCH_DEADLINE_GRACE_S=0)
    w0 = _counter(TM.REGISTRY, "resilience.watchdog_timeouts")
    assert _grouped() == base_bytes
    assert _counter(TM.REGISTRY, "resilience.watchdog_timeouts") == w0 + 1
    # the abandoned attempt wakes, computes on and writes nothing
    for t in threading.enumerate():
        if t.name.startswith("parmmg-watchdog-dispatch"):
            t.join(timeout=60)
    assert _grouped() == base_bytes


def test_resume_writes_the_uninterrupted_bytes(tmp_path, base_bytes, knobs):
    knobs(PMTORCH_CKPT_DIR=tmp_path)
    full = _grouped(ckpt_tag="ck")
    assert full == base_bytes
    names = sorted(os.listdir(tmp_path))
    assert [n for n in names if n.endswith(".npz")] == [
        "ck.pass0.npz", "ck.pass1.npz"]
    assert sum(n.startswith("ck.pass0.") and n.endswith(".mesh")
               for n in names) == 3
    os.unlink(tmp_path / f"ck.pass{NITER - 1}.npz")
    r0 = _counter(TM.REGISTRY, "resilience.resumes")
    assert _grouped(ckpt_tag="ck", resume=True) == full
    assert _counter(TM.REGISTRY, "resilience.resumes") == r0 + 1
    # a resume with no checkpoint left runs from scratch
    for n in os.listdir(tmp_path):
        os.unlink(tmp_path / n)
    assert _grouped(ckpt_tag="ck", resume=True) == full


def test_checkpoint_io_fault_is_bit_neutral(tmp_path, base_bytes, knobs):
    knobs(PMTORCH_CKPT_DIR=tmp_path, PMTORCH_FAULT="io.checkpoint")
    assert _grouped(ckpt_tag="ckf") == base_bytes
    assert os.listdir(tmp_path) == []


def test_retry_exhaustion_saves_a_conforming_lowfailure(knobs):
    from parmmg_tpu_torch.api import ParMesh
    knobs(PMTORCH_FAULT="dispatch.chunk", PMTORCH_RETRY_MAX=1,
          PMTORCH_GROUP_CHUNK=2)
    vert, tet = cube_mesh(2)
    pm = ParMesh(device="cpu")
    pm.set_mesh_size(np_=len(vert), ne=len(tet))
    pm.set_vertices(vert, np.zeros(len(vert), np.int32))
    pm.set_tetrahedra(tet + 1, np.ones(len(tet), np.int32))
    pm.info.hsiz = 0.35
    pm.info.niter = 1
    pm.info.imprim = -1
    pm.info.target_mesh_size = TARGET
    # the fault fires before any cycle: the no-op switches keep the
    # degrade tail (repair, fem) off, as scripts/chaos_check.py does
    pm.info.noinsert = pm.info.noswap = pm.info.nomove = True
    e0 = _counter(TM.REGISTRY, "resilience.retry_exhausted")
    l0 = _counter(TM.REGISTRY, "resilience.lowfailure")
    assert pm.run() == C.PMMG_LOWFAILURE
    assert _counter(TM.REGISTRY, "resilience.retry_exhausted") == e0 + 1
    assert _counter(TM.REGISTRY, "resilience.lowfailure") == l0 + 1
    v, _ = pm.get_vertices()
    t, _ = pm.get_tetrahedra()
    p = v[t - 1]
    vol = np.einsum("ti,ti->t", p[:, 1] - p[:, 0],
                    np.cross(p[:, 2] - p[:, 0], p[:, 3] - p[:, 0])) / 6
    assert len(vol) > 0 and (vol > 0).all()
    assert np.isclose(vol.sum(), 1.0, rtol=1e-5)


def _polished(polish):
    m, met = _shock3()
    out, met2, _ = TG.grouped_adapt_pass(m, met, 4, cycles=2, chunk=2,
                                         polish=polish)
    return _bytes(out, met2)


@pytest.fixture(scope="module")
def polish_refs():
    return _polished(False), _polished(True)


def _polish_dirs():
    return {d for d in os.listdir(tempfile.gettempdir())
            if d.startswith("parmmg_polish_")}


def test_subprocess_worker_equals_in_process_polish(polish_refs, knobs):
    plain, inproc = polish_refs
    assert inproc != plain                      # the polish acted
    knobs(PMTORCH_POLISH_SUBPROC=1)
    st = __import__("parmmg_tpu_torch.ops.adapt",
                    fromlist=["AdaptStats"]).AdaptStats()
    m, met = _shock3()
    out, met2, _ = TG.grouped_adapt_pass(m, met, 4, cycles=2, chunk=2,
                                         polish=True, stats=st)
    assert _bytes(out, met2) == inproc
    assert len(st.sched_extra["polish_worker_cold_s"]) == 1


@pytest.mark.parametrize("spec,extra", [
    ("polish.worker", {"PMTORCH_RETRY_MAX": 1}),
    ("polish.worker:hang=30", {"PMTORCH_RETRY_MAX": 0,
                               "PMTORCH_POLISH_TIMEOUT_S": 3}),
])
def test_dead_or_hung_worker_equals_the_polish_less_pass(polish_refs, knobs,
                                                         spec, extra):
    plain, _ = polish_refs
    before = _polish_dirs()
    knobs(PMTORCH_POLISH_SUBPROC=1, PMTORCH_FAULT=spec, **extra)
    f0 = _counter(TM.REGISTRY, "resilience.polish_worker_failures")
    t0 = time.perf_counter()
    assert _polished(True) == plain
    assert time.perf_counter() - t0 < 25
    assert _counter(TM.REGISTRY, "resilience.polish_worker_failures") == \
        f0 + 1
    assert _polish_dirs() - before == set()


# ---- the JAX-written checkpoint ----------------------------------------------

def test_port_resumes_a_jax_checkpoint_as_jax_does(jax_resume, monkeypatch):
    td, jout, jmet = jax_resume.result(timeout=1200)
    assert os.listdir(td) and f"jx.pass{NITER - 1}.npz" in os.listdir(td)
    # the JAX resume rewrote the last pass's file: drop it again so the
    # port resumes from the JAX package's pass 0 checkpoint too
    os.unlink(os.path.join(td, f"jx.pass{NITER - 1}.npz"))
    monkeypatch.setenv("PMTORCH_CKPT_DIR", td)
    m, met = _cube2()
    r0 = _counter(TM.REGISTRY, "resilience.resumes")
    out, met2 = TG.grouped_adapt(m, met, TARGET, niter=NITER, cycles=CYCLES,
                                 ckpt_tag="jx", resume=True)
    assert _counter(TM.REGISTRY, "resilience.resumes") == r0 + 1
    got = tmesh.mesh_to_numpy(out)
    for f in jmesh.MESH_FIELDS:
        a = np.asarray(getattr(jout, f))
        if f == "vert":
            np.testing.assert_allclose(got[f], a, rtol=0, atol=1e-5)
        else:
            assert got[f].shape == a.shape and np.array_equal(got[f], a), f
    np.testing.assert_allclose(met2.numpy(), np.asarray(jmet), rtol=0,
                               atol=1e-5)


def test_grouped_polish_matches_jax(jax_resume):
    """The port's grouped polish (4 groups of cube_mesh(3) under the shock
    map, chunk 2: the wave-major polish) against the JAX package's, both
    in-process: the pass's counts, masks, tags, refs and partition bit for
    bit, ``vert`` and the metric within 1e-5; the live tets as a set.  The
    rows of one 4-shell's generalized swap differ: its fans c and c + 2
    write the same four tets, and the port's qualities of the two tie
    where the JAX package's differ in the last bit, so the two packages
    write them in other rows (ROADMAP queue C, swapgen fan ties)."""
    jout, jmet, jpart = _JAX_POLISH.result(timeout=1200)
    m, met = _shock3()
    out, met2, part = TG.grouped_adapt_pass(m, met, 4, cycles=2, chunk=2,
                                            polish=True)
    got = tmesh.mesh_to_numpy(out)
    for f in jmesh.MESH_FIELDS:
        a = np.asarray(getattr(jout, f))
        if f == "vert":
            np.testing.assert_allclose(got[f], a, rtol=0, atol=1e-5)
        elif f == "tet":
            live = got["tmask"]
            assert np.array_equal(np.sort(got[f][live], 1)[np.lexsort(
                np.sort(got[f][live], 1).T)], np.sort(a[live], 1)[
                np.lexsort(np.sort(a[live], 1).T)])
        elif f != "adja":                       # adja follows the rows
            assert got[f].shape == a.shape and np.array_equal(got[f], a), f
    np.testing.assert_allclose(met2.numpy(), np.asarray(jmet), rtol=0,
                               atol=1e-5)
    assert np.array_equal(part, np.asarray(jpart))
    plain = _polished(False)
    assert _bytes(out, met2) != plain           # the polish acted


def _shock3_files(tmp_path):
    from parmmg_tpu_torch.io.medit import MeditMesh, write_mesh, write_sol
    v, t = cube_mesh(3)
    mm = MeditMesh()
    mm.vert, mm.vref = v, np.zeros(len(v), np.int32)
    mm.tetra, mm.tref = t, np.ones(len(t), np.int32)
    src = str(tmp_path / "s.mesh")
    write_mesh(src, mm)
    write_sol(str(tmp_path / "s.sol"),
              analytic_iso_metric(v, "shock", h=0.3)[:, None], types=[1])
    return src


def test_cli_group_polish_reaches_the_worker(tmp_path, knobs, monkeypatch):
    """``-group-polish`` polishes the groups of every grouped pass: the
    output differs from the run without it; with ``PMTORCH_POLISH_SUBPROC``
    on a chunked pass the CLI's polish runs in the worker process and
    writes the in-process polish's .mesh and .sol bytes."""
    from parmmg_tpu_torch import cli
    src = _shock3_files(tmp_path)
    knobs(PMTORCH_GROUP_CHUNK=2)

    def run(name, *flags):
        out = str(tmp_path / f"{name}.mesh")
        assert cli.main(["-in", src, "-sol", str(tmp_path / "s.sol"),
                         "-out", out, "-mesh-size", "41", "-niter", "1",
                         "-device", "cpu", "-v", "-1", *flags]) == 0
        return tuple(open(out[:-5] + e, "rb").read()
                     for e in (".mesh", ".sol"))
    workers = []
    real = TG._polish_in_worker
    monkeypatch.setattr(TG, "_polish_in_worker",
                        lambda *a, **k: workers.append(1) or real(*a, **k))
    plain = run("plain")
    inproc = run("inproc", "-group-polish")
    assert inproc != plain and workers == []
    knobs(PMTORCH_POLISH_SUBPROC=1)
    assert run("worker", "-group-polish") == inproc and workers == [1]


def test_side_streams_are_reused_unless_held(monkeypatch):
    """A guarded dispatch attempt takes the device's first side stream no
    live attempt holds; a new stream only while every other is held (by
    an abandoned attempt still running)."""
    made = []

    class FakeStream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + len(made)
            made.append(self)
    monkeypatch.setattr(TG.torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(TG, "_SIDE_STREAMS", {})
    monkeypatch.setattr(TG, "_BUSY_STREAMS", set())
    a = TG._claim_stream("cuda:0")
    TG._release_stream(a)
    assert TG._claim_stream("cuda:0") is a           # reused
    b = TG._claim_stream("cuda:0")                   # a is held
    assert b is not a and len(made) == 2
    TG._release_stream(a)
    TG._release_stream(b)
    assert TG._claim_stream("cuda:0") is a and len(made) == 2
    assert TG._claim_stream("cuda:1") is not a       # a pool a device
