"""The port's serving pool (``parmmg_tpu_torch/serve/``) held against the
JAX package and against its own standalone grouped pass.

Host state machines, exactly as the JAX package's on the same call
sequences: the pool's ``home_caps`` / ``admit`` (ok, full, oversize) /
``release`` / ``resize_bucket`` / ``occupancy``,
``sched.recommend_group_chunk`` on the trajectories of
``tests/test_serve.py``, the autoscale policy (``decide``,
``read_inputs``, ``latency_quantile``, ``AutoscaleController.evaluate``
over a sequence of snapshots) and the ``try_submit`` backpressure latch.

The serving contract, port only, exact: three tenants on cube_mesh(2)
(sizes 0.55 / 0.42 / 0.55, ``cycles=3``, two slots, two tenants a
dispatch) each equal, in every ``MESH_FIELDS`` array and the metric, to
their standalone ``grouped_adapt_pass(ngroups=1)``; streaming admission
and admission between steps give the same bytes; a tenant promoted by a
forced regrow (``cap_mult=1.2``) equals its standalone regrow; a fault
armed on one tenant's ``serve.slot_step`` quarantines that tenant only,
and its cohort-mates keep their bytes; ``write_distributed`` writes the
bytes of the JAX package's ``stacked_to_distributed_files`` on the same
slot state.

End to end against the JAX package: the same three tenants through the
JAX ``ServeDriver`` under ``jax.disable_jit()`` (its pool is host numpy,
its block runs eagerly, op by op), in a background thread while the
other tests run: every tenant's per-cycle counts rows are equal, every
integer and boolean array of its merged mesh is equal, ``vert`` and the
metric agree within 1e-5 (the tolerance of ``tests/test_torch_groups.py``).
"""
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from parmmg_tpu.parallel import sched as JSc
from parmmg_tpu.serve import autoscale as JA
from parmmg_tpu.serve import pool as JP
from parmmg_tpu_torch.core.mesh import MESH_FIELDS, mesh_to_numpy
from parmmg_tpu_torch.parallel import sched as TSc
from parmmg_tpu_torch.parallel.groups import grouped_adapt_pass
from parmmg_tpu_torch.serve import autoscale as TA
from parmmg_tpu_torch.serve import pool as TP
from parmmg_tpu_torch.serve.admission import stage_arrays
from parmmg_tpu_torch.serve.driver import ServeDriver
from parmmg_tpu_torch.utils.fixtures import cube_mesh
from torch_parity import jax_ledger_listener_compat  # noqa: F401

CASES = {"ta": 0.55, "tb": 0.42, "tc": 0.55}
CYCLES = 3


def _arrays(h):
    vert, tet = cube_mesh(2)
    return vert, tet, np.full(len(vert), h)


def _tenant(h):
    vert, tet, met = _arrays(h)
    return stage_arrays(vert, tet, met=met, device="cpu")


def _standalone(h, cap_mult=3.0):
    m, met = _tenant(h)
    out, kout, _ = grouped_adapt_pass(m, met, 1, cycles=CYCLES,
                                      cap_mult=cap_mult)
    return out, kout


def _same(mesh, met, ref, kref, what):
    for f in MESH_FIELDS:
        assert torch.equal(getattr(mesh, f), getattr(ref, f)), (what, f)
    assert torch.equal(met, kref), (what, "met")


def _serve(cases=CASES, **kw):
    kw.setdefault("device", "cpu")
    drv = ServeDriver(cycles=CYCLES, **kw)
    for tid, h in cases.items():
        m, met = _tenant(h)
        drv.submit(mesh=m, met=met, tenant=tid)
    return drv, drv.run()


@pytest.fixture(scope="module")
def refs():
    return {tid: _standalone(h) for tid, h in CASES.items()}


@pytest.fixture(scope="module")
def eager_serve():
    """The JAX package's ServeDriver over the three tenants under
    ``jax.disable_jit()`` in a background thread (swap23 off the face
    sort, as the port pairs it): a future of ({tenant: (merged mesh,
    met)}, {tenant: counts rows}, report)."""
    import jax
    mp = pytest.MonkeyPatch()
    mp.setenv("PARMMG_SWAP_FACESORT", "1")
    for k in ("PARMMG_CYCLE_BLOCK", "PARMMG_SERVE_SLOTS",
              "PARMMG_SERVE_CHUNK", "PARMMG_SERVE_STREAM",
              "PARMMG_SERVE_AUTOSCALE", "PARMMG_SERVE_MAX_QUEUE",
              "PARMMG_FAULT", "PARMMG_INCR_TOPO"):
        mp.delenv(k, raising=False)
    from parmmg_tpu.serve.admission import stage_arrays as jstage
    from parmmg_tpu.serve.driver import ServeDriver as JDriver
    rows = {}
    orig = JP.SlotPool._dispatch_cohort

    def recorded(self, b, fn, wave, ids, done):
        out = orig(self, b, fn, wave, ids, done)
        for i, crow in out:
            rows.setdefault(b.slots[i].tenant, []).append(
                np.asarray(crow).copy())
        return out
    mp.setattr(JP.SlotPool, "_dispatch_cohort", recorded)
    fut = Future()

    def run():
        try:
            with jax.disable_jit():
                drv = JDriver(slots_per_bucket=2, chunk=2, cycles=CYCLES)
                for tid, h in CASES.items():
                    m, met = jstage(*_arrays(h)[:2], met=_arrays(h)[2])
                    drv.submit(mesh=m, met=met, tenant=tid)
                rep = drv.run()
                out = {tid: drv.fetch(tid) for tid in CASES}
            fut.set_result((out, rows, rep))
        except BaseException as e:           # noqa: BLE001 (passed on)
            fut.set_exception(e)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    yield fut
    th.join()
    mp.undo()


# ---- host state machines -------------------------------------------------------

def _pool_trace(pool):
    """One admission / recycling / resize history; returns every result."""
    out = [pool.home_caps(27, 48), pool.home_caps(1000, 5000)]
    out.append(pool.admit("a", 27, 48))
    out.append(pool.admit("b", 27, 48, met_width=6))
    out.append(pool.admit("c", 27, 48))
    out.append(pool.admit("d", 27, 48))            # full
    out.append(pool.admit("big", 400, 4000))       # oversize
    out.append(pool.admit("e", 64, 162))
    out.append(pool.occupancy())
    pool.release("a")
    out.append(pool.admit("d", 27, 48))            # recycled slot
    key = pool._where["d"][0]
    out.append(pool.resize_bucket(key, 4))
    out.append(pool.resize_bucket(key, 1))         # tenants block it
    pool.release("c")
    out.append(pool.resize_bucket(key, 1))
    out.append(pool.resize_bucket(key, 0))
    out.append((pool.occupancy(), pool.labels(),
                sorted(pool.active_tenants())))
    with pytest.raises(ValueError, match="already admitted"):
        pool.admit("d", 27, 48)
    return out


def test_pool_state_machine_equals_jax(eager_serve, monkeypatch):
    for k in ("PARMMG_SERVE_SLOTS", "PARMMG_SERVE_MAX_CAPP",
              "PARMMG_SERVE_MAX_CAPT"):
        monkeypatch.delenv(k, raising=False)
    kw = dict(slots_per_bucket=2, max_capP=500, max_capT=1000)
    got = _pool_trace(TP.SlotPool(device="cpu", **kw))
    want = _pool_trace(JP.SlotPool(**kw))
    assert got == want
    assert got[4] == ("ok", got[3][1][:2] + (0,), 1)


def test_pool_defaults_and_quarantine_threshold(monkeypatch):
    for k in ("PARMMG_SERVE_SLOTS", "PARMMG_SERVE_CHUNK",
              "PARMMG_SERVE_MAX_RETRIES", "PARMMG_SERVE_MAX_CAPP",
              "PARMMG_SERVE_MAX_CAPT"):
        monkeypatch.delenv(k, raising=False)
    t, j = TP.SlotPool(device="cpu"), JP.SlotPool()
    for a in ("slots_per_bucket", "chunk", "max_capP", "max_capT",
              "max_slot_retries", "cycles", "cap_mult"):
        assert getattr(t, a) == getattr(j, a), a
    t.admit("a", 27, 48)
    s = t.slot_of("a")
    assert t._note_slot_fault(s, RuntimeError("boom")) is False
    assert s.faults == 1 and not s.failed
    assert t._note_slot_fault(s, RuntimeError("boom")) is True
    assert "quarantined after 2" in s.failed and t.quarantined == ["a"]
    # admitted but never loaded: not active, and a step dispatches nothing
    t.admit("b", 27, 48)
    assert t.active_tenants() == [] and t.step() == []
    assert t.dispatches == 0
    if not torch.cuda.is_available():
        # the default device is the card: no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="is_available"):
            TP.SlotPool()


@pytest.mark.parametrize("traj,g,kw", [
    ([8, 8, 1, 1, 1, 1], 8, {}),
    ([8] * 6, 8, {"dispatch_overhead": 8.0}),
    ([], 8, {}), ([0, 0], 8, {}), ([4, 4], 1, {}),
    ([3, 2, 2, 1], 4, {}), ([5, 7, 1, 0, 2], 6, {"dispatch_overhead": 0.5}),
])
def test_recommend_group_chunk_equals_jax(traj, g, kw):
    assert TSc.recommend_group_chunk(traj, g, **kw) == \
        JSc.recommend_group_chunk(traj, g, **kw)


def _inputs(**kw):
    base = {"queue_depth": 0, "occupancy": {}, "slots": {},
            "blocked": {}, "p99_s": 0.0, "slo_violations": 0,
            "deferring": False}
    base.update(kw)
    return base


DECIDE = [
    (_inputs(queue_depth=3, occupancy={"64x192": 2}, slots={"64x192": 2},
             blocked={"64x192": 3}), {"max_slots": 4}),
    (_inputs(queue_depth=1, occupancy={"64x192": 4}, slots={"64x192": 4},
             blocked={"64x192": 1}), {"max_slots": 4}),
    (_inputs(queue_depth=1, occupancy={"64x192": 1}, slots={"64x192": 2},
             blocked={"64x192": 1}), {"max_slots": 4}),
    (_inputs(occupancy={"64x192": 0}, slots={"64x192": 3}),
     {"idle_evals": {"64x192": 2}, "shrink_after": 3}),
    (_inputs(occupancy={"64x192": 0}, slots={"64x192": 3}),
     {"idle_evals": {"64x192": 3}, "shrink_after": 3}),
    (_inputs(occupancy={"64x192": 0}, slots={"64x192": 1}),
     {"idle_evals": {"64x192": 9}}),
    (_inputs(queue_depth=4), {"max_queue": 4}),
    (_inputs(queue_depth=3, deferring=True), {"max_queue": 4}),
    (_inputs(queue_depth=2, deferring=True), {"max_queue": 4}),
    (_inputs(queue_depth=1, p99_s=2.0, slo_violations=3.0),
     {"target_p99_s": 1.0}),
    (_inputs(queue_depth=1, p99_s=2.0, deferring=True),
     {"max_queue": 4, "target_p99_s": 1.0}),
    (_inputs(queue_depth=0, p99_s=2.0), {"target_p99_s": 1.0}),
]


def _dec(d):
    return (d.grow, d.shrink, d.defer, d.reasons)


@pytest.mark.parametrize("case", range(len(DECIDE)))
def test_decide_equals_jax(case):
    inputs, kw = DECIDE[case]
    assert _dec(TA.decide(inputs, **kw)) == _dec(JA.decide(inputs, **kw))


def test_latency_quantile_and_read_inputs_equal_jax():
    hist = {"buckets": {"0.25": 4, "0.5": 9, "1.0": 10, "inf": 10},
            "count": 10}
    for q in (0.0, 0.4, 0.5, 0.9, 0.99, 1.0):
        assert TA.latency_quantile(hist, q) == JA.latency_quantile(hist, q)
    assert TA.latency_quantile({"buckets": {}, "count": 0}, 0.99) == 0.0
    snap = {"gauges": {"serve.queue_depth": 2.0,
                       "serve.occupancy.64x192": 1.0,
                       "serve.slots.64x192": 2.0,
                       "serve.admit_blocked.64x192": 1.0,
                       "serve.occupancy.64x192m6": 0.0},
            "counters": {"tenant:a/serve.slo_violation": 2.0,
                         "serve.slo_violation": 1.0},
            "histograms": {"serve.latency_s": hist}}
    for deferring in (False, True):
        assert TA.read_inputs(snap, deferring) == \
            JA.read_inputs(snap, deferring)


def test_autoscale_evaluate_sequence_equals_jax():
    hist = {"buckets": {"256.0": 5, "inf": 5}, "count": 5}
    snaps = [
        {"gauges": {"serve.queue_depth": 1.0}, "counters": {},
         "histograms": {"serve.latency_s": hist}},
        {"gauges": {"serve.queue_depth": 0.0, "serve.slots.64x192": 3.0,
                    "serve.occupancy.64x192": 0.0}, "counters": {},
         "histograms": {"serve.latency_s": dict(hist)}},
        {"gauges": {"serve.queue_depth": 0.0, "serve.slots.64x192": 3.0,
                    "serve.occupancy.64x192": 0.0}, "counters": {},
         "histograms": {}},
        {"gauges": {"serve.queue_depth": 1.0, "serve.slots.64x192": 2.0,
                    "serve.occupancy.64x192": 2.0,
                    "serve.admit_blocked.64x192": 1.0}, "counters": {},
         "histograms": {"serve.latency_s": {
             "buckets": {"0.25": 3, "256.0": 8, "inf": 8}, "count": 8}}},
    ]
    kw = dict(max_slots=4, max_queue=2, target_p99_s=1.0, shrink_after=1)
    t, j = TA.AutoscaleController(**kw), JA.AutoscaleController(**kw)
    for snap in snaps:
        dt, dj = t.evaluate(snap), j.evaluate(snap)
        assert _dec(dt) == _dec(dj)
        t.deferring, j.deferring = dt.defer, dj.defer
        assert t._idle == j._idle
    assert t.summary() == j.summary()


def test_autoscale_tick_actuates_on_a_real_pool():
    from parmmg_tpu_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    pool = TP.SlotPool(slots_per_bucket=1, device="cpu")
    pool.admit("a", 27, 48)
    key = pool._where["a"][0]
    label = pool.bucket_label(key)
    reg.gauge("serve.queue_depth").set(1)
    reg.gauge(f"serve.admit_blocked.{label}").set(1)
    ctl = TA.AutoscaleController(max_slots=4, shrink_after=2)
    assert ctl.tick(pool, registry=reg).grow == {label: 2}
    assert pool.buckets[key].nslots == 2 and ctl.grows == 1
    pool.release("a")
    reg.gauge("serve.queue_depth").set(0)
    reg.gauge(f"serve.admit_blocked.{label}").set(0)
    assert ctl.tick(pool, registry=reg).shrink == {}
    assert ctl.tick(pool, registry=reg).shrink == {}
    assert ctl.tick(pool, registry=reg).shrink == {label: 1}
    assert pool.buckets[key].nslots == 1 and ctl.shrinks == 1


def test_try_submit_latch_equals_jax(monkeypatch):
    from parmmg_tpu.serve.driver import ServeDriver as JDriver
    monkeypatch.delenv("PARMMG_SERVE_MAX_QUEUE", raising=False)
    vert, tet, met = _arrays(0.5)
    got = []
    for drv in (ServeDriver(pool=TP.SlotPool(slots_per_bucket=1,
                                             device="cpu"),
                            autoscale=False, max_queue=1),
                JDriver(pool=JP.SlotPool(slots_per_bucket=1),
                        autoscale=False, max_queue=1)):
        seq = []
        for t in ("q1", "q2"):
            tid, reason = drv.try_submit(mesh={"vert": vert, "tet": tet},
                                         met=met, tenant=t)
            seq.append((tid, reason is None,
                        reason and reason.split(" (")[0]))
        drv.queue = []
        drv.admission.deferring = True
        tid, reason = drv.try_submit(mesh={"vert": vert, "tet": tet},
                                     met=met, tenant="q3")
        seq.append((tid, reason))
        seq.append((drv.admission.deferred, sorted(drv.requests)))
        got.append(seq)
    assert got[0] == got[1]
    assert got[0][1] == (None, False, "queue full")


# ---- the serving contract (port only) -------------------------------------------

def test_served_tenants_equal_standalone(refs):
    drv, rep = _serve(slots_per_bucket=2, chunk=2)
    assert rep["served"] == 3 and rep["failed"] == 0
    for tid in CASES:
        _same(*drv.fetch(tid), *refs[tid], tid)
    assert rep["tenants"]["ta"]["ops"] != rep["tenants"]["tb"]["ops"]
    assert rep["pool"]["dispatches"] > 0 and rep["pool"]["device"] == "cpu"
    # every slot recycled on retirement
    assert all(used == 0 for used, _ in drv.pool.occupancy().values())
    seg = rep["pool"]["pipeline_s"]
    assert set(seg) == {"upload", "compute", "download", "writeback"}


def test_streaming_admission_bytes(refs):
    outs = {}
    for stream in (False, True):
        drv, rep = _serve(slots_per_bucket=1, chunk=1, stream=stream,
                          autoscale=False)
        assert rep["served"] == 3 and rep["failed"] == 0
        if stream:
            assert rep["admission"]["stream_admissions"] >= 1
            assert drv.pool.steps < outs[False][1]
        outs[stream] = ({tid: drv.fetch(tid) for tid in CASES},
                        drv.pool.steps)
    for tid in CASES:
        _same(*outs[True][0][tid], *outs[False][0][tid], tid)
        _same(*outs[True][0][tid], *refs[tid], tid)


def test_promoted_tenant_equals_standalone_regrow():
    cases = {"ra": 0.42, "rb": 0.3}
    drv, rep = _serve(cases, slots_per_bucket=2, chunk=2, cap_mult=1.2)
    assert rep["served"] == 2 and rep["failed"] == 0
    assert rep["pool"]["regrows"] >= 2
    for tid, h in cases.items():
        assert drv.requests[tid].stats.regrows >= 1
        _same(*drv.fetch(tid), *_standalone(h, cap_mult=1.2), tid)


def test_slot_fault_quarantines_one_tenant(refs):
    from parmmg_tpu_torch.resilience.faults import FAULTS
    try:
        FAULTS.arm("serve.slot_step:key=tb")
        drv, rep = _serve(slots_per_bucket=2, chunk=2, autoscale=False)
    finally:
        FAULTS.reset()
    assert rep["tenants"]["tb"]["state"] == "failed"
    assert "quarantined after 2" in rep["tenants"]["tb"]["reason"]
    assert rep["pool"]["quarantined"] == ["tb"]
    assert rep["served"] == 2
    for tid in ("ta", "tc"):
        _same(*drv.fetch(tid), *refs[tid], tid)
    assert all(used == 0 for used, _ in drv.pool.occupancy().values())


def test_committed_plan_keeps_its_result(refs, monkeypatch):
    """A packed dispatch that fails after its first plan's writeback: that
    plan's slot keeps its result (it is not run twice), the rest of the
    cohort is retried slot by slot, and every tenant keeps its bytes."""
    from parmmg_tpu_torch.parallel import groups
    real = groups._pipeline_chunks
    fired = []

    def flaky(fn, stacked, met_s, wave, plans, tim, device, incr, topo,
              done=None):
        if len(plans) > 1 and not fired:
            fired.append(True)
            real(fn, stacked, met_s, wave, plans[:1], tim, device, incr,
                 topo, done=done)
            raise RuntimeError("launch failed after the first plan")
        return real(fn, stacked, met_s, wave, plans, tim, device, incr,
                    topo, done=done)
    monkeypatch.setattr(groups, "_pipeline_chunks", flaky)
    drv, rep = _serve(slots_per_bucket=3, chunk=1, autoscale=False)
    assert fired and rep["served"] == 3 and rep["failed"] == 0
    for tid in CASES:
        _same(*drv.fetch(tid), *refs[tid], tid)


def test_write_distributed_equals_jax_writer(tmp_path):
    import jax.numpy as jnp
    from parmmg_tpu.core.mesh import Mesh as JMesh
    from parmmg_tpu.io import distributed as JD
    from parmmg_tpu_torch.io import distributed as TD
    pool = TP.SlotPool(slots_per_bucket=3, cycles=CYCLES, device="cpu")
    for tid, h in CASES.items():
        m, met = _tenant(h)
        pool.admit(tid, 27, 48)
        pool.load(tid, m, met)
    pool.step()
    drv = ServeDriver(pool=pool, autoscale=False)
    b, _ = pool.slot_state("tb")
    jst = JMesh(**{f: jnp.asarray(getattr(b.stacked, f).numpy().view(
        np.uint32) if f in ("vtag", "ftag", "etag")
        else getattr(b.stacked, f).numpy()) for f in MESH_FIELDS})
    tabs = TD.writer_tables(b.stacked.vmask, b.stacked.tmask, b.stacked.tet)
    jtabs = JD.writer_tables()(jst.vmask, jst.tmask, jst.tet)
    for a, j in zip(tabs, jtabs):
        assert np.array_equal(a.numpy(), np.asarray(j))
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    for tid in ("ta", "tb"):
        got = drv.write_distributed(tid, tmp_path / "port" / f"{tid}.mesh")
        want = JD.stacked_to_distributed_files(
            tmp_path / "jax" / f"{tid}.mesh", jst, None, None, b.nslots,
            shards=[pool.slot_state(tid)[1]])
        assert [p.name for p in got] == [p.name for p in want]
        for p, q in zip(got, want):
            assert p.read_bytes() == q.read_bytes(), tid


def test_run_front_end_writes_outputs(tmp_path, capsys):
    import json
    from parmmg_tpu_torch.io.distributed import load_distributed_mesh
    from parmmg_tpu_torch.io.medit import MeditMesh, write_mesh, write_sol
    from parmmg_tpu_torch.obs.trace import TRACER, replay_totals
    from parmmg_tpu_torch.serve import run
    vert, tet, met = _arrays(0.42)
    mm = MeditMesh()
    mm.vert, mm.vref = vert, np.zeros(len(vert), np.int32)
    mm.tetra, mm.tref = tet, np.ones(len(tet), np.int32)
    write_mesh(tmp_path / "cube.mesh", mm)
    write_sol(tmp_path / "cube.sol", met, [1])
    out = tmp_path / "out"
    trace = tmp_path / "trace.jsonl"
    try:
        rc = run.main([str(tmp_path / "cube.mesh"), "--out", str(out),
                       "--cycles", str(CYCLES), "--device", "cpu",
                       "--trace", str(trace)])
    finally:
        TRACER.configure(None)
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["served"] == 1
    t = rep["tenants"]["cube"]
    back, _, _ = load_distributed_mesh(out / "cube.mesh", 0)
    assert len(back.tetra) == t["quality"]["ntets"] > len(tet)
    assert t["out_files"] == [str(out / "cube.0.mesh")]
    # --trace: the pipeline spans in the file add up to the report's
    tot, _ = replay_totals(str(trace))
    for seg, sec in rep["pool"]["pipeline_s"].items():
        assert abs(tot[seg] - sec) <= 1e-3, seg


# ---- against the JAX package, end to end -----------------------------------------

def test_served_tenants_match_eager_jax(eager_serve, monkeypatch):
    rows = {}
    orig = TP.SlotPool._dispatch_cohort

    def recorded(self, b, fn, wave, ids, done):
        out = orig(self, b, fn, wave, ids, done)
        for i, crow in out:
            rows.setdefault(b.slots[i].tenant, []).append(crow.copy())
        return out
    monkeypatch.setattr(TP.SlotPool, "_dispatch_cohort", recorded)
    drv, rep = _serve(slots_per_bucket=2, chunk=2)
    jout, jrows, jrep = eager_serve.result(timeout=1200)
    assert jrep["served"] == rep["served"] == 3
    for tid in CASES:
        assert len(rows[tid]) == len(jrows[tid]), tid
        for a, b in zip(rows[tid], jrows[tid]):
            assert np.array_equal(a, b), (tid, a, b)
        assert rep["tenants"][tid]["ops"] == jrep["tenants"][tid]["ops"]
        assert rep["tenants"][tid]["cycles"] == \
            jrep["tenants"][tid]["cycles"]
        mesh, met = drv.fetch(tid)
        jmesh, jmet = jout[tid]
        got = mesh_to_numpy(mesh)
        for f in MESH_FIELDS:
            a = np.asarray(getattr(jmesh, f))
            assert got[f].shape == a.shape, (tid, f)
            if f == "vert":
                np.testing.assert_allclose(got[f], a, rtol=0, atol=1e-5)
            else:
                assert np.array_equal(got[f], a), (tid, f)
        np.testing.assert_allclose(met.numpy(), np.asarray(jmet), rtol=0,
                                   atol=1e-5)
        for k in ("qmin", "qmean"):
            assert rep["tenants"][tid]["quality"][k] == pytest.approx(
                jrep["tenants"][tid]["quality"][k], abs=1e-5)
