"""The port's serve daemon (``parmmg_tpu_torch/serve/daemon.py``) on
``port=0`` and ``device="cpu"``, driven by the port's client over
localhost, mirroring ``tests/test_serve_daemon.py`` and the daemon case
of ``tests/test_watchdog.py``: the lifecycle round trip (a stub pool, and
the real pool, whose fetched mesh equals the standalone
``grouped_adapt_pass(ngroups=1)`` byte for byte), a malformed submit is
500 and not 404, backpressure answers 429, an RPC fault quarantines the
tenant mid-flight, the loop survives errors in an iteration, terminal
requests are evicted, a timed-out request's slot is scrubbed and
recycled, the real ``SlotPool.step`` re-rents a freed slot
mid-step, a wedged step flips ``/healthz`` through ``step_deadline_s``,
and ``python -m parmmg_tpu_torch.serve.daemon`` serves and shuts down.

The npz wire format is the JAX daemon's: a payload encoded by the port's
``encode_npz`` decodes through the JAX package's ``decode_npz`` into the
same arrays and the other way round, and ``mesh_arrays`` of equal meshes
gives equal arrays (tags as uint32) in both packages.
"""
import base64
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from parmmg_tpu_torch.core.mesh import MESH_FIELDS
from parmmg_tpu_torch.obs.metrics import REGISTRY, parse_prometheus
from parmmg_tpu_torch.resilience.faults import FAULTS
from parmmg_tpu_torch.serve.client import (BackpressureDeferred, ServeClient,
                                           ServeDaemonError)
from parmmg_tpu_torch.serve.daemon import (PoolDaemon, decode_npz,
                                           encode_npz, mesh_arrays)
from parmmg_tpu_torch.serve.driver import ServeDriver
from parmmg_tpu_torch.serve.pool import SlotPool
from torch_parity import ROOT, jax_ledger_listener_compat  # noqa: F401


# ---- host-only stubs: real admission and bookkeeping, no mesh work -------------

class HostPool(SlotPool):
    """Real SlotPool admission and slot bookkeeping on the CPU; load and
    merge stash the payload on the slot instead of splitting/merging."""

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)

    def load(self, tenant, mesh, met):
        key, i = self._where[tenant]
        s = self.buckets[key].slots[i]
        s.loaded = True
        s.payload = (mesh, met)

    def merge(self, tenant):
        return self.slot_of(tenant).payload


class InstantPool(HostPool):
    """Serves each loaded tenant after ``steps_to_converge`` advances,
    honoring the streaming ``on_retire`` contract; no dispatch."""

    def __init__(self, steps_to_converge=1, **kw):
        super().__init__(**kw)
        self.steps_to_converge = steps_to_converge

    def step(self, verbose=0, on_retire=None):
        self.steps += 1
        done = []
        while True:
            progressed = False
            for key in sorted(self.buckets):
                for s in self.buckets[key].slots:
                    if s.tenant and s.loaded and not s.converged \
                            and not s.failed \
                            and getattr(s, "stepped", 0) < self.steps:
                        s.stepped = self.steps
                        s.c += 1
                        progressed = True
                        if s.c >= self.steps_to_converge:
                            s.converged = True
                            done.append(s.tenant)
                            if on_retire is not None:
                                on_retire([s.tenant])
            if on_retire is None or not progressed:
                break
        return done


class StubDriver(ServeDriver):
    """Host-only driver: quality, retention and RPC staging stubbed
    (dict meshes)."""

    def _quality(self, mesh, met):
        return {"qmin": 1.0, "qmean": 1.0, "nbad": 0,
                "ntets": int(len(np.asarray(mesh["tet"])))}

    def _retain(self, mesh, met):
        return mesh, met

    def stage_payload(self, arrays):
        return {"vert": arrays["vert"], "tet": arrays["tet"]}, \
            arrays.get("met")


def _stub_mesh():
    vert = np.arange(12, dtype=np.float64).reshape(4, 3)
    tet = np.array([[0, 1, 2, 3], [1, 2, 3, 0]], np.int32)
    return vert, tet, np.ones(4)


def _daemon(steps=1, **drv_kw):
    pool = InstantPool(steps_to_converge=steps, slots_per_bucket=2)
    drv = StubDriver(pool=pool, autoscale=False, **drv_kw)
    return PoolDaemon(driver=drv, port=0, start_paused=True,
                      idle_sleep_s=0.005).start()


# ---- the daemon over localhost ------------------------------------------------

def test_daemon_lifecycle_roundtrip_stub_pool():
    d = _daemon()
    try:
        cl = ServeClient(port=d.port, timeout_s=10)
        h = cl.health()
        assert h["ok"] is True and h["paused"] is True
        vert, tet, met = _stub_mesh()
        tid = cl.submit(vert=vert, tet=tet, met=met, tenant="stub-a")
        assert tid == "stub-a"
        assert cl.poll(tid)["state"] == "queued"
        with pytest.raises(ServeDaemonError) as ei:
            cl.fetch(tid)                       # not done yet
        assert ei.value.status == 409
        assert cl.step()["state"] == "active"
        got = cl.wait(tid, timeout_s=5)
        assert got["state"] == "done" and got["quality"]["qmin"] == 1.0
        arrays = cl.fetch(tid)
        assert (arrays["vert"] == vert).all()
        assert (arrays["tet"] == tet).all()
        assert (arrays["met"] == met).all()
        cl.resume()
        tid2 = cl.submit(vert=vert, tet=tet, met=met)
        assert cl.wait(tid2, timeout_s=5)["state"] == "done"
        cl.pause()
        series = parse_prometheus(cl.metrics_text())
        assert any(n == "parmmg_serve_admit_ok_total" for n, _ in series)
        with pytest.raises(ServeDaemonError) as ei:
            cl.poll("no-such-request")
        assert ei.value.status == 404
        rep = cl.report()
        assert rep["served"] == 2 and rep["failed"] == 0
    finally:
        d.shutdown()
    assert not d.alive()


def test_daemon_serves_the_real_pool_on_the_cpu():
    """The real pool behind the daemon: a tenant submitted as arrays comes
    back equal, field for field, to the standalone grouped pass of the
    same input staged by the same rule."""
    from parmmg_tpu_torch.parallel.groups import grouped_adapt_pass
    from parmmg_tpu_torch.serve.admission import stage_arrays
    from parmmg_tpu_torch.utils.fixtures import analytic_iso_metric, \
        cube_mesh
    vert, tet = cube_mesh(2)
    met = analytic_iso_metric(vert, "shock", h=0.5)
    m, k = stage_arrays(vert, tet, met=met, device="cpu")
    ref, kref, _ = grouped_adapt_pass(m, k, 1, cycles=3)
    d = PoolDaemon(port=0, device="cpu", cycles=3, slots_per_bucket=2,
                   idle_sleep_s=0.005).start()
    try:
        cl = ServeClient(port=d.port, timeout_s=30)
        tid = cl.submit(vert=vert, tet=tet, met=met, tenant="real")
        got = cl.wait(tid, timeout_s=120)
        assert got["state"] == "done", got
        arrays = cl.fetch(tid)
        from parmmg_tpu_torch.core.mesh import mesh_to_numpy
        want = mesh_to_numpy(ref)
        for f in MESH_FIELDS:
            assert arrays[f].dtype == want[f].dtype, f
            assert np.array_equal(arrays[f], want[f]), f
        assert np.array_equal(arrays["met"], kref.numpy())
        assert got["quality"]["ntets"] == int(ref.tmask.sum())
        h = cl.health()
        assert h["ok"] and h["steps"] >= 1 and h["active"] == 0
    finally:
        d.shutdown()


def test_daemon_rpc_fault_quarantines_midflight():
    d = _daemon(steps=2)
    try:
        cl = ServeClient(port=d.port, timeout_s=10)
        vert, tet, met = _stub_mesh()
        for t in ("fa", "fb"):
            cl.submit(vert=vert, tet=tet, met=met, tenant=t)
        cl.step()
        assert cl.poll("fa")["state"] == "running"
        FAULTS.arm("serve.daemon_rpc:key=fa")
        try:
            with pytest.raises(ServeDaemonError) as ei:
                cl.poll("fa")
        finally:
            FAULTS.reset()
        assert ei.value.status == 500
        assert ei.value.body["quarantined"] is True
        assert cl.health()["ok"] is True
        assert cl.poll("fa")["state"] == "failed"
        cl.step()
        assert cl.wait("fb", timeout_s=5)["state"] == "done"
        rep = cl.report()
        assert "fa" in rep["pool"]["quarantined"]
        assert "daemon rpc fault" in rep["tenants"]["fa"]["reason"]
        assert all(used == 0 for used, _ in rep["pool"]["buckets"].values())
    finally:
        FAULTS.reset()
        d.shutdown()


def test_trace_rpc_and_dropped_staged_copy():
    """/trace serves the ring's summary and its newest records; a request
    the pool has loaded no longer holds its staged copy (the pool holds
    its rows), and a DONE one holds its result."""
    d = _daemon(steps=2)
    try:
        cl = ServeClient(port=d.port, timeout_s=10)
        vert, tet, met = _stub_mesh()
        cl.submit(vert=vert, tet=tet, met=met, tenant="tr")
        assert d.driver.requests["tr"].mesh is not None
        cl.step()
        assert cl.poll("tr")["state"] == "running"
        assert d.driver.requests["tr"].mesh is None
        assert d.driver.requests["tr"].met is None
        cl.step()
        assert cl.wait("tr", timeout_s=5)["state"] == "done"
        assert (cl.fetch("tr")["vert"] == vert).all()
        got = cl.trace(last=3)
        assert got["summary"]["ring"] >= len(got["records"]) == 3
        assert got["summary"]["events"] >= got["summary"]["ring"]
        assert got["records"][-1]["name"] == "serve.rpc"
        assert got["records"][-1]["op"] == "trace"
        assert cl.trace(last=0)["records"] == []
    finally:
        d.shutdown()


def test_terminal_request_eviction_bounds_the_table():
    vert, tet, met = _stub_mesh()
    drv = StubDriver(pool=InstantPool(slots_per_bucket=2),
                     autoscale=False, retain_done=2)
    for t in ("e0", "e1", "e2", "e3"):
        drv.submit(mesh={"vert": vert, "tet": tet}, met=met, tenant=t)
    rep = drv.run()
    assert set(drv.requests) == {"e2", "e3"}
    assert rep["served"] == 2
    assert all(used == 0 for used, _ in drv.pool.occupancy().values())
    assert drv.fetch("e3") is not None
    with pytest.raises(KeyError):
        drv.poll("e0")


def test_timeout_scrubs_and_recycles_the_slot():
    """A RUNNING request past ``timeout_s`` retires TIMEOUT with its slot
    row zeroed back to a dead mesh and the slot free for the next tenant
    (``tests/test_serve.py``'s regression, on the port's real slot
    state); a QUEUED request quarantined at the RPC edge leaves the
    queue."""
    from parmmg_tpu_torch.serve.admission import stage_arrays
    from parmmg_tpu_torch.serve.driver import TIMEOUT, ServeRequest
    from parmmg_tpu_torch.utils.fixtures import cube_mesh
    vert, tet = cube_mesh(2)
    pool = SlotPool(slots_per_bucket=1, device="cpu")
    drv = ServeDriver(pool=pool, timeout_s=0.001, autoscale=False)
    st, key, i = pool.admit("a", 27, 48)
    assert st == "ok"
    pool.load("a", *stage_arrays(vert, tet, met=np.full(27, 0.4),
                                 device="cpu"))
    b = pool.buckets[key]
    assert bool(b.stacked.tmask[i].any()) and b.met[i].abs().sum() > 0
    drv.requests["a"] = ServeRequest(tid="a", state="running",
                                     t_submit=time.perf_counter() - 10.0)
    drv._expire_timeouts()
    r = drv.requests["a"]
    assert r.state == TIMEOUT and "exceeded" in r.reason
    for f in MESH_FIELDS:
        assert not getattr(b.stacked, f)[i].any(), f
    assert not b.met[i].any()
    assert "a" not in pool._where and b.free_slot() == i
    assert pool.admit("b", 27, 48) == ("ok", key, i)
    vq, tq, mq = _stub_mesh()
    tid = drv.submit(mesh={"vert": vq, "tet": tq}, met=mq, tenant="q")
    assert drv.quarantine(tid, "dropped by a test") is True
    assert drv.requests[tid].state == "failed" and tid not in drv.queue
    assert tid in pool.quarantined
    assert drv.quarantine(tid, "again") is False


class FlakyDriver(StubDriver):
    """service_once raises a few times before recovering."""

    boom = 2

    def service_once(self):
        if self.boom and self.queue:
            self.boom -= 1
            raise RuntimeError("injected loop iteration failure")
        return super().service_once()


def test_daemon_loop_survives_iteration_errors():
    pool = InstantPool(steps_to_converge=1, slots_per_bucket=2)
    drv = FlakyDriver(pool=pool, autoscale=False)
    d = PoolDaemon(driver=drv, port=0, idle_sleep_s=0.005).start()
    try:
        c0 = REGISTRY.counter("serve.loop_errors").value
        cl = ServeClient(port=d.port, timeout_s=10)
        vert, tet, met = _stub_mesh()
        tid = cl.submit(vert=vert, tet=tet, met=met, tenant="flaky")
        assert cl.wait(tid, timeout_s=5)["state"] == "done"
        assert REGISTRY.counter("serve.loop_errors").value - c0 == 2
        h = cl.health()
        assert h["ok"] is True and h["loop_alive"] is True
    finally:
        d.shutdown()


def test_daemon_malformed_submit_is_500_not_404():
    d = _daemon()
    try:
        cl = ServeClient(port=d.port, timeout_s=10)
        buf = io.BytesIO()
        np.savez_compressed(buf, tet=np.zeros((1, 4), np.int32))
        before = REGISTRY.counter("serve.rpc_errors").value
        with pytest.raises(ServeDaemonError) as ei:
            cl._rpc("POST", "/submit", {
                "npz_b64": base64.b64encode(buf.getvalue())
                .decode("ascii")})
        assert ei.value.status == 500
        assert "vert" in str(ei.value.body)
        assert REGISTRY.counter("serve.rpc_errors").value == before + 1
        with pytest.raises(ServeDaemonError) as ei:
            cl._rpc("GET", "/no-such-op")
        assert ei.value.status == 404
    finally:
        d.shutdown()


def test_daemon_backpressure_429():
    d = _daemon(max_queue=1)
    try:
        cl = ServeClient(port=d.port, timeout_s=10)
        vert, tet, met = _stub_mesh()
        cl.submit(vert=vert, tet=tet, met=met, tenant="bp1")
        with pytest.raises(BackpressureDeferred) as ei:
            cl.submit(vert=vert, tet=tet, met=met, tenant="bp2")
        assert ei.value.status == 429
        assert ei.value.body["deferred"] is True
        with pytest.raises(ServeDaemonError):
            cl.poll("bp2")
        cl.step()
        assert cl.wait("bp1", timeout_s=5)["state"] == "done"
        assert cl.submit(vert=vert, tet=tet, met=met,
                         tenant="bp2") == "bp2"
    finally:
        d.shutdown()


def test_stream_midstep_rerent(monkeypatch):
    """The real SlotPool.step streaming worklist: a slot freed by a
    cohort's retirement is re-rented to a queued tenant and dispatched at
    its own cycle 0 within the same pool step (the dispatch is stubbed)."""
    calls = []

    def fake_dispatch(self, b, fn, wave, ids, done):
        calls.append([b.slots[i].tenant for i in ids])
        self.dispatches += len(ids)
        return [(i, np.zeros((1, 9), np.int64)) for i in ids]

    monkeypatch.setattr(SlotPool, "_dispatch_cohort", fake_dispatch)
    vert, tet, met = _stub_mesh()
    drv = StubDriver(pool=HostPool(slots_per_bucket=1, cycles=1),
                     autoscale=False, stream=True)
    for t in ("ra", "rb", "rc"):
        drv.submit(mesh={"vert": vert, "tet": tet}, met=met, tenant=t)
    rep = drv.run()
    assert rep["served"] == 3 and rep["failed"] == 0
    assert drv.pool.steps == 1
    assert calls == [["ra"], ["rb"], ["rc"]]
    assert rep["admission"]["stream_admissions"] == 2
    drv2 = StubDriver(pool=HostPool(slots_per_bucket=1, cycles=1),
                      autoscale=False, stream=False)
    for t in ("sa", "sb", "sc"):
        drv2.submit(mesh={"vert": vert, "tet": tet}, met=met, tenant=t)
    rep2 = drv2.run()
    assert rep2["served"] == 3 and drv2.pool.steps == 3
    assert rep2["admission"]["stream_admissions"] == 0


class _WedgePool:
    steps = 0
    quarantined = ()

    def active_tenants(self):
        return []


class _WedgedDriver:
    """service_once sleeps past the step deadline every call."""

    def __init__(self, sleep_s):
        self.pool = _WedgePool()
        self.queue = []
        self.requests = {}
        self.sleep_s = sleep_s

    def service_once(self):
        time.sleep(self.sleep_s)
        return "idle"


def test_daemon_wedge_flips_healthz():
    before = REGISTRY.counter("serve.step_timeouts").value
    d = PoolDaemon(driver=_WedgedDriver(0.6), port=0, idle_sleep_s=0.01,
                   step_deadline_s=0.05, step_grace_s=0).start()
    try:
        cl = ServeClient(port=d.port, timeout_s=10)
        h = None
        for _ in range(150):
            h = cl.health()             # lock-free even while wedged
            if h["wedged"]:
                break
            time.sleep(0.02)
        assert h is not None and h["wedged"] is True
        assert h["ok"] is False and h["loop_alive"] is True
        assert REGISTRY.counter("serve.step_timeouts").value >= before + 1
        # once the stuck step returns, the daemon is healthy again
        for _ in range(150):
            h = cl.health()
            if not h["wedged"]:
                break
            time.sleep(0.02)
        assert h["wedged"] is False
    finally:
        d.shutdown()
    assert not d.alive()


def test_daemon_front_end_serves_and_shuts_down(tmp_path):
    trace = tmp_path / "trace.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "parmmg_tpu_torch.serve.daemon", "--port",
         "0", "--device", "cpu", "--paused", "--trace", str(trace)],
        cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        port = None
        t0 = time.monotonic()
        while port is None and time.monotonic() - t0 < 120:
            line = proc.stderr.readline()
            if not line:
                break
            if "listening on http://" in line:
                port = int(line.rsplit(":", 1)[1])
        assert port, "the daemon never said where it listens"
        cl = ServeClient(port=port, timeout_s=10)
        assert cl.health()["paused"] is True
        assert cl.shutdown() == {"ok": True}
        assert proc.wait(timeout=30) == 0
        # --trace: the daemon's records went to the file
        recs = [json.loads(line) for line in trace.read_text().splitlines()]
        names = {r.get("name") for r in recs if r.get("kind") == "event"}
        assert {"serve.daemon_start", "serve.rpc",
                "serve.daemon_stop"} <= names
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


# ---- the wire format ----------------------------------------------------------

def test_npz_wire_format_equals_jax():
    from parmmg_tpu.serve import daemon as JDm
    rng = np.random.default_rng(3)
    arrays = {"vert": rng.random((7, 3)),
              "tet": rng.integers(0, 7, (5, 4)).astype(np.int32),
              "vtag": rng.integers(0, 2**31, 7).astype(np.uint32),
              "vmask": rng.random(7) < 0.5,
              "met": rng.random((7, 6)).astype(np.float32)}
    for enc, dec in ((encode_npz, JDm.decode_npz),
                     (JDm.encode_npz, decode_npz)):
        back = dec(enc(arrays))
        assert set(back) == set(arrays)
        for k, v in arrays.items():
            assert back[k].dtype == v.dtype and np.array_equal(back[k], v)
    assert decode_npz(JDm.encode_npz(arrays)).keys() == \
        JDm.decode_npz(encode_npz(arrays)).keys()


def test_mesh_arrays_equal_jax():
    import jax.numpy as jnp
    from parmmg_tpu.core.mesh import Mesh as JMesh
    from parmmg_tpu.serve import daemon as JDm
    from parmmg_tpu_torch.core.mesh import mesh_to_numpy
    from parmmg_tpu_torch.serve.admission import stage_arrays
    from parmmg_tpu_torch.utils.fixtures import cube_mesh
    vert, tet = cube_mesh(2)
    m, met = stage_arrays(vert, tet, met=np.full(len(vert), 0.4),
                          device="cpu")
    jm = JMesh(**{k: jnp.asarray(v) for k, v in mesh_to_numpy(m).items()})
    got = mesh_arrays(m, met)
    want = JDm.mesh_arrays(jm, jnp.asarray(met.numpy()))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert decode_npz(encode_npz(got)).keys() == got.keys()
    assert torch.equal(torch.from_numpy(got["met"]), met)
