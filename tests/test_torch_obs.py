"""The port's telemetry and resilience pieces held against the JAX
package: ``obs/metrics.py``, ``obs/trace.py`` (with the ``utils.timers``
bridge), ``resilience/faults.py`` and ``resilience/watchdog.py``.

Exact: after the same sequence of counter, gauge and histogram
operations both registries give the same snapshot and the same
Prometheus text, byte for byte, and ``parse_prometheus`` reads both back
alike; ``publish_stats`` of equal ``AdaptStats`` lands the same series;
the fault grammar gives equal rules and equal errors on the cases of
``tests/test_resilience.py`` and ``tests/test_watchdog.py``, and the
triggers fire on the same hits; a ``Timers`` run under one fake clock
gives the JAX ``Timers``' totals, and its trace replays to them.
Port-only, mirroring ``tests/test_obs.py`` and
``tests/test_watchdog.py``: span nesting and the run context, ``log``
gating, the JSONL sink, the ring bound, ``Deadline`` and
``run_with_deadline`` (with progress beats re-arming it).

The run artifact and the shape ledger (``obs/artifact.py``,
``utils/compilecache.py``), exact against the JAX package on every
checked-in ``BENCH_r*`` / ``SERVE_r*`` / ``SCALE_r03`` / ``MULTICHIP_r*``
/ ``MULTIHOST2P_r*`` / ``SOAK_r01`` artifact: ``upgrade_artifact``,
``validate_artifact``, ``extract_artifact_ledger``, and ``artifact_diff``
and ``ledger_diff`` against the artifact before it.  The debug dumps
(``utils/debug.py``): ``dump_mesh`` (with its metric) and ``dump_tags``
write the JAX package's bytes for cube_mesh(3), and
``check_mesh_consistency`` returns its dict.  The profiler window: inert
unarmed; armed on the CPU for pass 0 of a grouped run it writes one
Chrome trace.
"""
import contextlib
import dataclasses
import itertools
import json
import os
import time

import pytest
import torch

from parmmg_tpu.obs import artifact as JA
from parmmg_tpu.obs import metrics as JM
from parmmg_tpu.utils import compilecache as JCC
from parmmg_tpu.resilience import faults as JF
from parmmg_tpu.utils import timers as JT
from parmmg_tpu_torch.obs import artifact as TA
from parmmg_tpu_torch.obs import metrics as TM
from parmmg_tpu_torch.utils import compilecache as TCC
from parmmg_tpu_torch.obs import trace as otrace
from parmmg_tpu_torch.resilience import faults as TF
from parmmg_tpu_torch.resilience import watchdog as wd
from parmmg_tpu_torch.resilience.watchdog import (Deadline, WatchdogTimeout,
                                                  run_with_deadline)
from parmmg_tpu_torch.utils.timers import Timers
from torch_parity import jax_ledger_listener_compat  # noqa: F401


@pytest.fixture()
def fresh_tracer():
    """The port's global tracer (Timers emits into it) at a clean ring,
    no file sink."""
    otrace.TRACER.configure(path=None)
    otrace.TRACER.reset()
    yield otrace.TRACER
    otrace.TRACER.configure(path=None)
    otrace.TRACER.reset()


def _spans(tracer, **match):
    return [r for r in list(tracer.ring) if r.get("kind") == "span"
            and all(r.get(k) == v for k, v in match.items())]


# ---- metrics -----------------------------------------------------------------

def _drive_registry(reg):
    """One fixed sequence of metric operations (tenant series, float
    counters, gauges, a default-ladder and a custom-bucket histogram)."""
    reg.counter("serve.admit_ok").inc()
    reg.counter("serve.admit_ok").inc(2)
    reg.counter("serve.slo_ok", tenant="t0").inc()
    reg.counter("serve.slo_violation", tenant='we"ird\\t').inc()
    reg.counter("sched.grp_upload_s").inc(0.125)
    reg.gauge("serve.queue_depth").set(3)
    reg.gauge("serve.occupancy.97x146").set(2)
    reg.gauge("serve.occupancy.97x146m6").set(1.5)
    h = reg.histogram("serve.latency_s")
    for v in (0.0001, 0.5, 0.5, 2.0, 300.0, 1e-9):
        h.observe(v)
    reg.histogram("serve.latency_s", tenant="t0",
                  bounds=(0.1, 1.0, 10.0)).observe(0.7)
    return reg


def test_registry_snapshot_and_text_equal_jax():
    t = _drive_registry(TM.MetricsRegistry())
    j = _drive_registry(JM.MetricsRegistry())
    assert t.snapshot() == j.snapshot()
    assert json.dumps(t.snapshot(), sort_keys=True) == \
        json.dumps(j.snapshot(), sort_keys=True)
    assert t.to_prometheus() == j.to_prometheus()
    assert t.to_prometheus(prefix="pm") == j.to_prometheus(prefix="pm")
    assert TM.DEFAULT_BUCKETS == JM.DEFAULT_BUCKETS


def test_prometheus_roundtrip():
    reg = _drive_registry(TM.MetricsRegistry())
    text = reg.to_prometheus()
    got = TM.parse_prometheus(text)
    assert got == JM.parse_prometheus(text)
    snap = reg.snapshot()
    assert got[("parmmg_serve_admit_ok_total", frozenset())] == \
        snap["counters"]["serve.admit_ok"] == 3.0
    assert got[("parmmg_serve_slo_violation_total",
                frozenset({("tenant", 'we"ird\\t')}))] == 1.0
    assert got[("parmmg_serve_latency_s_bucket",
                frozenset({("le", "+Inf")}))] == 6.0
    assert got[("parmmg_serve_latency_s_count", frozenset())] == 6.0
    with pytest.raises(ValueError, match="unparseable"):
        TM.parse_prometheus("not a metric line at all")


def test_histogram_bucket_edges_and_kinds():
    reg = TM.MetricsRegistry()
    h = reg.histogram("lat", bounds=(0.1, 1.0, 10.0))
    for v in (0.1, 0.100001, 1.0, 10.0, 11.0):
        h.observe(v)
    assert h.counts == [1, 2, 1, 1]
    cum = dict(h.cumulative())
    assert cum[0.1] == 1 and cum[1.0] == 3 and cum[float("inf")] == 5
    with pytest.raises(TypeError, match="already registered"):
        reg.counter("lat")
    with pytest.raises(ValueError, match=">= 0"):
        reg.counter("c").inc(-1)
    with pytest.raises(ValueError, match="increasing"):
        TM.Histogram(bounds=(1.0, 1.0))


def test_publish_stats_and_adaptstats_tenants_equal_jax():
    from parmmg_tpu.ops.adapt import AdaptStats as JS
    from parmmg_tpu_torch.ops.adapt import AdaptStats as TS
    out = []
    for S, M in ((TS, TM), (JS, JM)):
        a = S(tenant="a", nsplit=3, cycles=2)
        a.sched_extra["ops_per_block"] = [4, 0]
        a.sched_extra["grp_upload_s"] = 0.5
        b = S(tenant="b", nswap=5, regrows=1)
        b.sched_extra["ops_per_block"] = [7]
        with pytest.raises(ValueError, match="across tenants"):
            a += b
        assert a.nsplit == 3 and a.nswap == 0
        agg = S()
        agg += a
        agg += b
        t = S(tenant="a")
        t += S(tenant="a", nswap=2)
        reg = M.MetricsRegistry()
        for st in (a, b, agg):
            M.publish_stats(st, reg)
        out.append((agg.sched_extra, agg.nsplit, agg.nswap, t.nswap,
                    t.sched_extra, reg.snapshot(), reg.to_prometheus()))
    assert out[0] == out[1]
    assert out[0][0] == {"tenant:a/ops_per_block": [4, 0],
                         "tenant:a/grp_upload_s": 0.5,
                         "tenant:b/ops_per_block": [7]}


# ---- trace -------------------------------------------------------------------

def test_span_nesting_and_context(fresh_tracer):
    rid = otrace.new_run("cpu")
    with otrace.context(**{"pass": 2, "tenant": "t0"}):
        with otrace.span("outer"):
            with otrace.context(block=3):
                with otrace.span("inner"):
                    pass
    recs = _spans(fresh_tracer)
    assert [r["name"] for r in recs] == ["inner", "outer"]
    inner, outer = recs
    for r in (inner, outer):
        assert r["run"] == rid and r["backend"] == "cpu"
        assert r["pass"] == 2 and r["tenant"] == "t0"
    assert inner["block"] == 3 and "block" not in outer
    otrace.event("after")
    after = [r for r in fresh_tracer.ring if r.get("name") == "after"][0]
    assert "pass" not in after and "block" not in after
    otrace.new_run()
    assert "backend" not in otrace.current_context()


def _fake_clock(monkeypatch):
    """time.perf_counter as a clock that moves 0.125 s a read."""
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 0.125)


def _timer_run(tim):
    with tim("a"):
        with tim("b"):
            tim.add("seg", 0.25)
    with tim("a"):
        pass
    tim.add("c", 0.5, count=3)
    return tim


def test_timers_replay_equals_jax_timers(fresh_tracer, monkeypatch):
    from parmmg_tpu.obs import trace as jtrace
    jtrace.TRACER.configure(path=None)
    jtrace.TRACER.reset()
    _fake_clock(monkeypatch)
    tim = _timer_run(Timers())
    _fake_clock(monkeypatch)
    jtim = _timer_run(JT.Timers())
    assert tim.acc == jtim.acc and tim.count == jtim.count
    assert tim.external == jtim.external == {"c"}
    assert tim.report() == jtim.report()
    tot, cnt = otrace.replay_totals(list(fresh_tracer.ring),
                                    tim=tim.trace_id)
    jtot, jcnt = jtrace.replay_totals(list(jtrace.TRACER.ring),
                                      tim=jtim.trace_id)
    assert tot == jtot == tim.acc and cnt == jcnt == tim.count
    # another instance's spans never bleed into the replay
    with Timers()("a"):
        pass
    assert otrace.replay_totals(list(fresh_tracer.ring),
                                tim=tim.trace_id)[0] == tim.acc
    assert _spans(fresh_tracer, name="c")[0]["ext"] is True
    assert not _spans(fresh_tracer, name="a/b/seg")[0].get("ext")
    jtrace.TRACER.reset()


def test_log_gates_but_always_traces(fresh_tracer, capsys):
    assert otrace.log(2, "visible", verbose=3) is True
    assert otrace.log(3, "hidden", verbose=2) is False
    assert otrace.log(1, "to stderr", verbose=1, err=True) is True
    cap = capsys.readouterr()
    assert "visible" in cap.out and "hidden" not in cap.out
    assert "to stderr" in cap.err and "to stderr" not in cap.out
    logs = [r for r in fresh_tracer.ring if r.get("kind") == "log"]
    assert [r["msg"] for r in logs] == ["visible", "hidden", "to stderr"]
    assert [r["shown"] for r in logs] == [True, False, True]
    # the process verbosity gates when no local one is given
    v = otrace.verbosity()
    try:
        otrace.set_verbosity(0)
        assert otrace.log(1, "quiet") is False
    finally:
        otrace.set_verbosity(v)


def test_jsonl_sink_and_file_replay(tmp_path, fresh_tracer):
    path = str(tmp_path / "trace.jsonl")
    otrace.TRACER.configure(path=path)
    tim = Timers()
    with tim("x"):
        with tim("y"):
            pass
    otrace.event("marker", foo=1)
    otrace.TRACER.configure(path=None)
    with open(path, "a") as f:
        f.write('{"kind": "span", "name": "x", "du')   # truncated line
    recs = []
    with open(path) as f:
        for ln in f:
            try:
                recs.append(json.loads(ln))
            except ValueError:
                pass
    assert all("ts" in r for r in recs)
    assert any(r.get("name") == "marker" and r.get("foo") == 1
               for r in recs)
    tot, cnt = otrace.replay_totals(path, tim=tim.trace_id)
    assert set(tot) == {"x", "x/y"}
    assert tot["x"] == pytest.approx(tim.acc["x"], rel=1e-12)
    assert cnt["x/y"] == 1
    assert os.path.getsize(path) > 0


def test_tracer_ring_bound_and_summary():
    t = otrace.Tracer(ring=4)
    for i in range(10):
        t.emit({"kind": "span", "name": f"s{i % 2}", "dur": 0.1})
    s = t.summary()
    assert s["events"] == 10 and s["ring"] == 4 and s["dropped"] == 6
    assert set(s["top_spans_s"]) <= {"s0", "s1"} and s["sink"] == ""


# ---- faults ------------------------------------------------------------------

def _rule_fields(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


GRAMMAR = [
    "dispatch.chunk:nth-3,polish.worker,io.checkpoint:every-2,"
    "serve.slot_step:key=t7;p=0.5;seed=9",
    "dispatch.chunk:2",
    "polish.worker:hang=2.5;nth-2",
    " serve.slot_step:key=tenant-a , serve.daemon_rpc:every-3;hang=0.1",
    "",
    "no.such.site",
    "dispatch.chunk:sometimes",
    "dispatch.chunk:nth-0",
    "dispatch.chunk:every-0",
    "dispatch.chunk:hang=0",
    "dispatch.chunk:frob=1",
]


@pytest.mark.parametrize("spec", GRAMMAR)
def test_fault_grammar_equals_jax(spec):
    try:
        want = {k: _rule_fields(v)
                for k, v in JF.parse_fault_spec(spec).items()}
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            TF.parse_fault_spec(spec)
        assert str(ei.value) == str(e)
        return
    got = {k: _rule_fields(v) for k, v in TF.parse_fault_spec(spec).items()}
    assert got == want
    assert TF.SITES == JF.SITES


@pytest.mark.parametrize("kw,keys", [
    ({"nth": 3}, [None] * 6),
    ({"every": 2}, [None] * 6),
    ({"p": 0.5, "seed": 4}, [None] * 32),
    ({"p": 0.3, "every": 2, "seed": 1}, [None] * 32),
    ({"nth": 1, "key": "t1"}, ["t0", "t1", "t1", "t0"]),
])
def test_fault_triggers_fire_as_jax(kw, keys):
    t = TF.FaultRule("serve.slot_step", **kw)
    j = JF.FaultRule("serve.slot_step", **kw)
    assert [t.fires(k) for k in keys] == [j.fires(k) for k in keys]


def test_faultpoint_and_trigger_fire_as_armed():
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    try:
        TF.faultpoint("serve.slot_step")        # unarmed: free
        assert TF.fault_trigger("analysis.ks_overflow") is False
        assert not TF.FAULTS.armed()
        TF.FAULTS.arm("serve.slot_step:key=ta;nth-2,io.checkpoint,"
                      "analysis.ks_overflow:every-2")
        assert TF.FAULTS.armed()
        before = REGISTRY.counter("resilience.faults_injected").value
        TF.faultpoint("serve.slot_step", key="tb")      # other tenant
        TF.faultpoint("serve.slot_step", key="ta")      # hit 1
        with pytest.raises(RuntimeError, match="injected fault at "
                           r"serve.slot_step \(key=ta\)") as ei:
            TF.faultpoint("serve.slot_step", key="ta")  # hit 2 fires
        assert str(ei.value).startswith("INTERNAL")
        TF.faultpoint("serve.slot_step", key="ta")      # nth-2 only
        with pytest.raises(OSError, match="injected fault"):
            TF.faultpoint("io.checkpoint")
        assert [TF.fault_trigger("analysis.ks_overflow")
                for _ in range(4)] == [False, True, False, True]
        assert REGISTRY.counter("resilience.faults_injected").value \
            == before + 4
        # arming again restarts the counters
        TF.FAULTS.arm("serve.slot_step:nth-1")
        with pytest.raises(RuntimeError):
            TF.faultpoint("serve.slot_step", key="tz")
        with pytest.raises(ValueError, match="unknown fault site"):
            TF.FAULTS.arm("nope")
    finally:
        TF.FAULTS.reset()
    assert not TF.FAULTS.armed()


def test_fault_hang_sleeps_and_returns():
    try:
        TF.FAULTS.arm("dispatch.chunk:hang=0.1,analysis.ks_overflow:"
                      "hang=0.05")
        t0 = time.monotonic()
        TF.faultpoint("dispatch.chunk")         # the wedge: no raise
        assert time.monotonic() - t0 >= 0.09
        t0 = time.monotonic()
        assert TF.fault_trigger("analysis.ks_overflow") is False
        assert time.monotonic() - t0 >= 0.04
    finally:
        TF.FAULTS.reset()


# ---- watchdog ----------------------------------------------------------------

def _counter(name):
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    return REGISTRY.counter(name).value


def _site(prefix):
    """A fresh site a call: the first-use grace is process-wide."""
    return f"{prefix}.{os.urandom(4).hex()}"


def test_deadline_polled_expiry_disarmed_and_nested():
    before = _counter("resilience.watchdog_timeouts")
    with Deadline(0.05, site="t.polled") as dl:
        assert not dl.expired
        dl.check()
        assert dl.remaining() is not None
        time.sleep(0.08)
        assert dl.expired
        with pytest.raises(WatchdogTimeout) as ei:
            dl.check()
        assert ei.value.site == "t.polled"
        assert ei.value.seconds == pytest.approx(0.05)
    assert isinstance(ei.value, RuntimeError)
    assert _counter("resilience.watchdog_timeouts") == before + 1
    with Deadline(0, site="t.off") as off:
        assert off.remaining() is None
        time.sleep(0.02)
        off.check()
    with Deadline(0.05, site="t.outer"):
        with Deadline(60, site="t.inner") as inner:
            time.sleep(0.08)
            with pytest.raises(WatchdogTimeout) as ei:
                inner.check()
            assert ei.value.site == "t.outer"
    Deadline(0, site="t.clean").check()


def test_run_with_deadline_inline_value_exception_timeout():
    assert run_with_deadline(lambda: 41 + 1, 0, _site("t.inline")) == 42
    assert run_with_deadline(lambda: {"v": 7}, 5, _site("t.value"),
                             grace_s=0) == {"v": 7}

    def boom():
        raise KeyError("relayed")
    with pytest.raises(KeyError, match="relayed"):
        run_with_deadline(boom, 5, _site("t.exc"), grace_s=0)
    before = _counter("resilience.watchdog_timeouts")
    site = _site("t.hang")
    with pytest.raises(WatchdogTimeout) as ei:
        run_with_deadline(lambda: time.sleep(0.5), 0.05, site, grace_s=0)
    assert ei.value.site == site
    assert ei.value.thread is not None and ei.value.thread.daemon
    assert _counter("resilience.watchdog_timeouts") == before + 1
    ei.value.thread.join(timeout=2)
    assert not ei.value.thread.is_alive()


def test_first_use_grace_covers_the_first_call_only():
    site = _site("t.grace")
    assert wd.first_use_grace(site, 0.4) == pytest.approx(0.4)
    assert wd.first_use_grace(site) == wd.GRACE_S == 300.0
    slow = lambda: (time.sleep(0.15), "done")[1]  # noqa: E731
    assert run_with_deadline(slow, 0.05, site, grace_s=0.4) == "done"
    assert wd.first_use_grace(site, 0.4) == 0.0
    with pytest.raises(WatchdogTimeout) as ei:
        run_with_deadline(slow, 0.05, site, grace_s=0.4)
    ei.value.thread.join(timeout=2)


def test_progress_re_arms_a_guarded_call():
    """A guarded call reporting progress (beats=True) outlives its
    deadline as long as no gap between two reports does; abandoned, it
    stops at its next report.  Without beats, reports change nothing."""
    def beating(n=8):
        for _ in range(n):
            time.sleep(0.04)
            wd.progress()
        return "done"
    assert run_with_deadline(beating, 0.2, _site("t.beat"), grace_s=0,
                             beats=True) == "done"
    with pytest.raises(WatchdogTimeout) as ei:
        run_with_deadline(beating, 0.2, _site("t.nobeat"), grace_s=0)
    ei.value.thread.join(timeout=2)
    wd.progress()                       # free outside a guarded call
    seen = []

    def stalls():
        time.sleep(0.05)
        wd.progress()
        time.sleep(0.5)
        try:
            wd.progress()
        except wd.Abandoned:
            seen.append("stopped")
            raise
        seen.append("ran on")
    with pytest.raises(WatchdogTimeout) as ei:
        run_with_deadline(stalls, 0.2, _site("t.beat2"), grace_s=0,
                          beats=True)
    ei.value.thread.join(timeout=2)
    assert seen == ["stopped"]


def test_deadline_knob(monkeypatch):
    monkeypatch.delenv("PMTORCH_DEADLINE_DISPATCH_S", raising=False)
    assert wd.deadline_knob("PMTORCH_DEADLINE_DISPATCH_S") == 0.0
    for v, want in (("0.5", 0.5), ("-3", 0.0), ("junk", 0.0), ("", 0.0)):
        monkeypatch.setenv("PMTORCH_DEADLINE_DISPATCH_S", v)
        assert wd.deadline_knob("PMTORCH_DEADLINE_DISPATCH_S") == want
    monkeypatch.setenv("PMTORCH_DEADLINE_GRACE_S", "7")
    assert wd.first_use_grace(_site("t.knobgrace")) == 7.0


# ---- the run artifact and the shape ledger -----------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = sorted(
    f for f in os.listdir(ROOT) if f.endswith(".json") and f.split("_")[0]
    in ("BENCH", "SERVE", "SCALE", "MULTICHIP", "MULTIHOST2P", "SOAK"))


def _doc(name):
    with open(os.path.join(ROOT, name)) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", ARTIFACTS)
def test_artifact_upgrade_validate_diff_equal_jax(name):
    doc = _doc(name)
    up = TA.upgrade_artifact(doc)
    assert up == JA.upgrade_artifact(doc)
    assert TA.validate_artifact(up) == JA.validate_artifact(up)
    assert TA.validate_artifact(doc) == JA.validate_artifact(doc)
    assert TCC.extract_artifact_ledger(doc) == \
        JCC.extract_artifact_ledger(doc)
    i = ARTIFACTS.index(name)
    prev = _doc(ARTIFACTS[i - 1])
    for a, b in ((prev, doc), (doc, prev), (doc, doc)):
        assert TA.artifact_diff(a, b) == JA.artifact_diff(a, b)
        la, lb = (TCC.extract_artifact_ledger(x) for x in (a, b))
        assert TCC.ledger_diff(la, lb) == JCC.ledger_diff(la, lb)
    pattern = name.split("_")[0] + "_r*.json"
    led = TCC.extract_artifact_ledger(doc)
    assert TCC.regressions_vs_latest_artifact(ROOT, pattern, led) == \
        JCC.regressions_vs_latest_artifact(ROOT, pattern, led)
    assert len(ARTIFACTS) == 15


def test_make_artifact_validates_and_reports_the_port(monkeypatch):
    monkeypatch.setenv("PMTORCH_CKPT_EVERY", "3")
    doc = TA.make_artifact("BENCH", "tets_per_s", 1.5, "tets/s",
                           extra={"qmin": 0.3})
    assert TA.validate_artifact(doc) == []
    assert JA.validate_artifact(doc) == []
    env = doc["env"]
    assert env["backend"] == ("cuda" if torch.cuda.is_available()
                              else "cpu")
    assert env["torch"] == torch.__version__
    assert env["knobs"]["PMTORCH_CKPT_EVERY"] == "3"
    assert "compile_ledger" in doc["extra"]
    with pytest.raises(ValueError):
        TA.make_artifact("NOPE", "m", 1.0, "s")


def test_ledger_rows_builds_and_budgets():
    led = TCC.CompileLedger()
    led.register("t.entry", budget=1)
    for n in (4, 4, 6):
        led.note_call("t.entry", TCC.static_key(
            (torch.zeros(n), 3, True), {"hausd": None}))
    led.note_build("nvcc.k", 2.5)
    snap = led.snapshot()
    assert snap["t.entry"]["calls"] == 3
    assert snap["t.entry"]["variants"] == snap["t.entry"]["shapes_seen"] == 2
    assert snap["nvcc.k"]["compiles"] == 1
    assert snap["nvcc.k"]["compile_s"] == 2.5
    assert led.violations() == ["t.entry: 2 compiled variants > budget 1"]
    assert "nvcc.k" in led.format() and "t.entry" in led.format()
    # a wave number is dynamic (an int), a flag static
    k = TCC.static_key
    assert k((torch.zeros(3), 5), {}) == k((torch.zeros(3), 9), {})
    assert k((torch.zeros(3), True), {}) != k((torch.zeros(3), False), {})
    led.reset()
    assert led.snapshot()["t.entry"]["calls"] == 0


def test_governed_entry_points_count_a_grouped_pass():
    """The governed entry points of a whole-mesh run and of a polished
    grouped pass land in the process ledger under the JAX names."""
    from parmmg_tpu_torch.core import mesh as tmesh
    from parmmg_tpu_torch.ops import adapt as TAd
    from parmmg_tpu_torch.ops import analysis as TN
    from parmmg_tpu_torch.ops.repair import repair_mesh
    from parmmg_tpu_torch.parallel import groups as TG
    from parmmg_tpu_torch.utils.fixtures import cube_mesh
    v, t = cube_mesh(2)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=4 * len(v),
                                        capT=4 * len(t))).mesh
    met = torch.full((m.capP,), 0.35)
    before = TCC.ledger_snapshot()
    out, met2, _ = TAd.adapt_mesh(m, met, max_cycles=3)
    repair_mesh(out, met2)
    TG.grouped_adapt_pass(m, met, 3, cycles=2, polish=True)
    after = TCC.ledger_snapshot()
    for name in ("adapt.cycle", "adapt.sliver_polish", "groups.polish_block",
                 "repair.quality_probe"):
        assert after[name]["calls"] > before.get(name, {}).get("calls", 0)
        assert after[name]["variants"] >= 1
    # the front door for callers outside a cycle: the wave's own result
    from parmmg_tpu_torch.ops import swapgen
    calls = after["ops.swapgen_wave"]["calls"]
    a = swapgen.swapgen_wave_j(out, met2, budget_div=2)
    b = swapgen.swapgen_wave(out, met2, budget_div=2)
    assert int(a.nswap) == int(b.nswap)
    for f in tmesh.MESH_FIELDS:
        assert torch.equal(getattr(a.mesh, f), getattr(b.mesh, f)), f
    assert TCC.ledger_snapshot()["ops.swapgen_wave"]["calls"] == calls + 1


# ---- debug dumps -------------------------------------------------------------

def _debug_meshes():
    import jax.numpy as jnp
    from parmmg_tpu.core import mesh as jmesh
    from parmmg_tpu_torch.core import mesh as tmesh
    from parmmg_tpu_torch.ops import analysis as TN
    from parmmg_tpu_torch.utils.fixtures import cube_mesh
    v, t = cube_mesh(3)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=2 * len(v),
                                        capT=2 * len(t))).mesh
    f = tmesh.mesh_to_numpy(m)
    jm = jmesh.Mesh(**{k: jnp.asarray(a) for k, a in f.items()})
    met = torch.linspace(0.1, 0.9, m.capP)
    return m, jm, met


def test_debug_dumps_equal_jax(tmp_path):
    import jax.numpy as jnp
    from parmmg_tpu.utils import debug as JD
    from parmmg_tpu_torch.utils import debug as TD
    m, jm, met = _debug_meshes()
    TD.dump_mesh(m, tmp_path / "t.mesh", met=met)
    JD.dump_mesh(jm, tmp_path / "j.mesh", met=jnp.asarray(met.numpy()))
    for ext in (".mesh", ".sol"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    assert b"Triangles" in (tmp_path / "t.mesh").read_bytes()
    TD.dump_tags(m, tmp_path / "t.tags")
    JD.dump_tags(jm, tmp_path / "j.tags")
    assert (tmp_path / "t.tags").read_bytes() == \
        (tmp_path / "j.tags").read_bytes()
    got = TD.check_mesh_consistency(m)
    assert got == JD.check_mesh_consistency(jm)
    assert got["nonpositive_vols"] == got["dangling_vertex_refs"] == 0


# ---- the profiler window -----------------------------------------------------

def test_profiler_unarmed_is_inert(monkeypatch, tmp_path):
    monkeypatch.delenv("PMTORCH_PROFILE_DIR", raising=False)
    assert not otrace.profile_pass_begin(0)
    assert not otrace.profiling_active()
    assert not otrace.profile_pass_end(0) and not otrace.profile_abort()
    assert isinstance(otrace.annotate("x"), contextlib.nullcontext)
    # armed, but out of the window
    monkeypatch.setenv("PMTORCH_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("PMTORCH_PROFILE_PASS", "1:2")
    assert not otrace.profile_pass_begin(0)
    assert list(tmp_path.iterdir()) == []


def test_profiler_window_writes_one_trace_for_pass0(monkeypatch, tmp_path):
    from parmmg_tpu_torch.core import mesh as tmesh
    from parmmg_tpu_torch.ops import analysis as TN
    from parmmg_tpu_torch.parallel import groups as TG
    from parmmg_tpu_torch.utils.fixtures import cube_mesh
    monkeypatch.setenv("PMTORCH_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("PMTORCH_PROFILE_PASS", "0")
    v, t = cube_mesh(2)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=4 * len(v),
                                        capT=4 * len(t))).mesh
    TG.grouped_adapt(m, torch.full((m.capP,), 0.35), 16, niter=2, cycles=2,
                     chunk=2)
    assert not otrace.profiling_active()
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    stops = [r for r in otrace.TRACER.ring
             if r.get("name") == "profile_stop"]
    assert stops[-1]["path"] == str(files[0])
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "grp_dispatch_chunk0" in names
    assert any(str(n).startswith("aten::") for n in names)
    # an exception unwinding the loop leaves no capture open
    monkeypatch.setattr(TG, "grouped_adapt_pass",
                        lambda *a, **k: (_ for _ in ()).throw(
                            MemoryError("x")))
    with pytest.raises(MemoryError):
        TG.grouped_adapt(m, torch.full((m.capP,), 0.35), 16, niter=2)
    assert not otrace.profiling_active()
    assert len(list(tmp_path.iterdir())) == 1
