"""Request lifecycle + queue driver for the serving pool (port of
``serve/driver.py``).

A submit/poll/fetch front end over :class:`serve.pool.SlotPool`:

- this driver: the request state machine (queued / running / done /
  rejected / failed / timeout), retirement (per-request tenant-tagged
  ``AdaptStats`` + qmin/qmean quality SLO, slot recycling, merge-free
  ``write_distributed`` output) and the serving loop
  (:meth:`ServeDriver.service_once`, one admit + step + retire +
  autoscale iteration, shared by the batch :meth:`run` loop and the
  daemon's loop thread);
- :mod:`serve.admission` — staging, queue pump, backpressure and the
  streaming mid-step slot re-rent;
- :mod:`serve.autoscale` — bucket resizing and admission deferral.

``submit`` enqueues unconditionally (library callers own their queue);
``try_submit`` is the backpressure-aware edge the daemon maps to HTTP
429.  ``quarantine`` is the RPC-edge isolation hook (the
``serve.daemon_rpc`` faultpoint): a request killed mid-flight retires
FAILED with its slot scrubbed and recycled while its cohort-mates keep
their bytes.

Knobs (the JAX package's ``PARMMG_SERVE_*`` variables become arguments
with their defaults): ``timeout_s`` (TIMEOUT_S, wall clock a request, 0 =
off), ``max_queue`` (MAX_QUEUE), ``stream`` (STREAM), ``autoscale``
(AUTOSCALE: None builds the default controller, False turns it off) and
the pool's (``**pool_kwargs``: SLOTS, CHUNK, MAX_CAPP, MAX_CAPT,
MAX_RETRIES, ``cycles``, ``device``).  MAX_INFLIGHT and SLO_QMIN, which no
caller sets, keep their defaults with no argument: no bound on the
tenants in flight, and a quality floor of 0.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

from ..core.mesh import MESH_FIELDS, Mesh
from .admission import (DONE, FAILED, QUEUED, REJECTED, RUNNING,  # noqa: F401
                        TERMINAL, TIMEOUT, AdmissionController)
from .pool import SlotPool

SLO_QMIN = 0.0      # the per-tenant quality floor of the SLO verdict


@dataclasses.dataclass
class ServeRequest:
    """One tenant request riding the pool."""
    tid: str
    mesh: object = None          # staged core Mesh until loaded; the
    met: object = None           # result, on the host, once DONE
    path: str | None = None      # input file (Medit/.vtu), staged lazily
    sol: str | None = None
    state: str = QUEUED
    reason: str = ""
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    quality: dict | None = None  # {"qmin", "qmean", "nbad", "ntets"}
    slo: dict | None = None      # {"qmin_floor", "ok"} verdict
    stats: object = None         # tenant-tagged AdaptStats
    out_files: list = dataclasses.field(default_factory=list)

    @property
    def latency_s(self) -> float:
        return max(0.0, self.t_done - self.t_submit)


class ServeDriver:
    """FIFO queue + admission + retirement around a SlotPool."""

    def __init__(self, pool: SlotPool | None = None,
                 out_dir: str | None = None, timeout_s: float = 0.0,
                 verbose: int = 0, stream: bool = True, max_queue: int = 0,
                 autoscale=None, retain_done: int = 4096, **pool_kwargs):
        self.pool = pool if pool is not None else SlotPool(**pool_kwargs)
        self.out_dir = out_dir
        self.timeout_s = float(timeout_s)
        self.verbose = verbose
        self.requests: dict[str, ServeRequest] = {}
        self.queue: list[str] = []
        self._seq = 0
        self.admission = AdmissionController(self, max_queue=max_queue,
                                             stream=stream)
        # autoscale: None = the default controller (on), False = off, or
        # a ready AutoscaleController; one max_queue for both
        if autoscale is None:
            from .autoscale import AutoscaleController
            autoscale = AutoscaleController(max_queue=max_queue)
        self.autoscale = autoscale or None
        # bounded occupancy trajectory (a daemon serves indefinitely)
        self._occupancy_traj: deque = deque(maxlen=4096)
        # a daemon retains at most this many finished requests (each holds
        # its merged mesh and metric, on the host, until evicted)
        self.retain_done = int(retain_done)

    # ---- API --------------------------------------------------------------
    def submit(self, mesh=None, met=None, path=None, sol=None,
               tenant: str | None = None) -> str:
        """Enqueue a request; returns the request/tenant id."""
        if tenant is None:
            tenant = f"t{self._seq:04d}"
        self._seq += 1
        if tenant in self.requests:
            raise ValueError(f"duplicate tenant id {tenant!r}")
        req = ServeRequest(tid=tenant, mesh=mesh, met=met, path=path,
                           sol=sol, t_submit=time.perf_counter())
        self.requests[tenant] = req
        self.queue.append(tenant)
        return tenant

    def try_submit(self, mesh=None, met=None, path=None, sol=None,
                   tenant: str | None = None):
        """Backpressure-aware submit: ``(tid, None)`` when accepted,
        ``(None, reason)`` when deferred (the daemon's HTTP 429)."""
        from ..obs import trace as otrace
        from ..obs.metrics import REGISTRY
        reason = self.admission.backpressure()
        if reason:
            self.admission.deferred += 1
            REGISTRY.counter("serve.deferred").inc()
            otrace.event("serve.deferred",
                         **({"tenant": tenant} if tenant else {}))
            otrace.log(2, f"serve: deferred submit ({reason})",
                       verbose=self.verbose, err=True)
            return None, reason
        return self.submit(mesh=mesh, met=met, path=path, sol=sol,
                           tenant=tenant), None

    def poll(self, tid: str) -> dict:
        r = self.requests[tid]
        out = {"tid": tid, "state": r.state, "reason": r.reason}
        if r.state == DONE:
            out["latency_s"] = round(r.latency_s, 3)
            out["quality"] = r.quality
        return out

    def fetch(self, tid: str):
        """Merged (Mesh, met) of a DONE request."""
        r = self.requests[tid]
        if r.state != DONE:
            raise RuntimeError(f"request {tid} is {r.state}, not done")
        return r.mesh, r.met

    def write_distributed(self, tid: str, path) -> list:
        """Merge-free output of a tenant's slot straight from the pool's
        stacked state."""
        from ..io.distributed import stacked_to_distributed_files
        b, i = self.pool.slot_state(tid)
        return stacked_to_distributed_files(path, b.stacked, b.nslots,
                                            shards=[i])

    def stage_payload(self, arrays: dict):
        """npz-style array payload -> staged (mesh, met) on the pool's
        device: the daemon's RPC staging edge, one rule with
        ``admission.stage_arrays``."""
        from .admission import stage_arrays
        return stage_arrays(
            arrays["vert"], arrays["tet"],
            vref=arrays.get("vref"), tref=arrays.get("tref"),
            met=arrays.get("met"), device=self.pool.device)

    def quarantine(self, tid: str, reason: str) -> bool:
        """RPC-edge quarantine: a request killed mid-flight retires
        FAILED — a RUNNING tenant's slot is scrubbed and recycled through
        the normal retirement path, a QUEUED one is dropped from the
        queue — and cohort-mates are untouched.  Returns False for
        unknown or already-terminal requests."""
        from ..obs import trace as otrace
        from ..obs.metrics import REGISTRY
        r = self.requests.get(tid)
        if r is None or r.state in TERMINAL:
            return False
        self.pool.quarantined.append(tid)
        REGISTRY.counter("serve.quarantined").inc()
        otrace.event("serve.quarantine", tenant=tid, detail=reason[:300])
        if r.state == RUNNING:
            self.pool.slot_of(tid).failed = reason
            self._retire(tid)
        else:
            self.queue = [t for t in self.queue if t != tid]
            REGISTRY.gauge("serve.queue_depth").set(len(self.queue))
            r.mesh = r.met = None
            r.state = FAILED
            r.reason = reason
            r.t_done = time.perf_counter()
        otrace.log(1, f"serve: QUARANTINED {tid} at the RPC edge "
                      f"({reason})", verbose=self.verbose, err=True)
        return True

    # ---- retirement -------------------------------------------------------
    def _quality(self, mesh, met) -> dict:
        """Merged tenant state -> the quality/SLO fields (K6 on the
        card)."""
        from ..ops.quality import quality_histogram, tet_quality
        q = tet_quality(mesh, met)
        _, qmin, qmean, nbad = quality_histogram(q, mesh.tmask)
        return {"qmin": round(float(qmin), 6),
                "qmean": round(float(qmean), 6),
                "nbad": int(nbad),
                "ntets": int(mesh.tmask.sum())}

    def _retain(self, mesh, met):
        """The merged result as a DONE request keeps it: on the host, as
        a daemon retains up to ``retain_done`` of them and the card's
        memory is the pool's."""
        return (Mesh(**{f: getattr(mesh, f).cpu() for f in MESH_FIELDS}),
                met.cpu())

    def _retire(self, tid: str) -> None:
        from ..obs.metrics import REGISTRY
        from ..obs.trace import log as _olog
        r = self.requests[tid]
        slot = self.pool.slot_of(tid)
        r.stats = slot.stats
        if slot.failed:
            r.state = FAILED
            r.reason = slot.failed
        else:
            if self.out_dir is not None:
                from pathlib import Path
                out = Path(self.out_dir) / f"{tid}.mesh"
                r.out_files = [str(p) for p in
                               self.write_distributed(tid, out)]
            mesh, met = self.pool.merge(tid)
            r.quality = self._quality(mesh, met)
            r.mesh, r.met = self._retain(mesh, met)
            r.state = DONE
            ok = r.quality["qmin"] >= SLO_QMIN
            r.slo = {"qmin_floor": SLO_QMIN, "ok": ok}
            REGISTRY.counter(
                "serve.slo_ok" if ok else "serve.slo_violation",
                tenant=tid).inc()
        r.t_done = time.perf_counter()
        if r.state == DONE:
            REGISTRY.histogram("serve.latency_s").observe(r.latency_s)
        if r.stats is not None:
            r.stats.publish()
        self.pool.release(tid)
        _olog(1, f"serve: retired {tid} ({r.state}"
                 + (f", qmin {r.quality['qmin']}" if r.quality else "")
                 + f", {r.latency_s:.2f}s)",
              verbose=self.verbose, err=True)

    def _expire_timeouts(self) -> None:
        """Expire requests past ``timeout_s``.  A RUNNING tenant's slot
        is scrubbed back to the dead-mesh state and returned to the
        bucket's free list (``pool.release``), so a timed-out tenant
        never strands capacity."""
        if not self.timeout_s:
            return
        now = time.perf_counter()
        for tid, r in self.requests.items():
            if r.state == RUNNING and now - r.t_submit > self.timeout_s:
                slot = self.pool.slot_of(tid)
                r.stats = slot.stats
                r.state = TIMEOUT
                r.reason = f"exceeded {self.timeout_s}s"
                r.t_done = now
                self.pool.release(tid)
            elif r.state == QUEUED and now - r.t_submit > self.timeout_s:
                r.state = TIMEOUT
                r.reason = f"queued past {self.timeout_s}s"
                r.t_done = now
                r.mesh = r.met = None
                self.queue = [t for t in self.queue if t != tid]

    # ---- the serving loop --------------------------------------------------
    def service_once(self) -> str:
        """One serving-loop iteration: expire timeouts, pump the
        admission queue, run the autoscale controller, advance the pool
        one step (with streaming mid-step re-rent when enabled) and
        retire finished tenants.  Returns the loop state:

        - ``"active"`` — tenants advanced (call again immediately);
        - ``"idle"``   — nothing queued, nothing running;
        - ``"stalled"``— queued work the pool could not admit with every
          slot free (:meth:`run` rejects it, a daemon keeps waiting)."""
        self._expire_timeouts()
        admitted = self.admission.pump()
        if self.autoscale is not None:
            d = self.autoscale.tick(self.pool, self.admission)
            if d.grow and self.queue:
                # a grown bucket can admit at once
                admitted += self.admission.pump()
        if not self.pool.active_tenants():
            if self.queue and not admitted:
                return "stalled"
            if not self.queue and not admitted:
                return "idle"
            return "active"
        self._occupancy_traj.append(self.pool.occupancy())
        on_retire = self.admission.mid_step if self.admission.stream \
            else None
        for tid in self.pool.step(verbose=self.verbose,
                                  on_retire=on_retire):
            # streaming mode already retired mid-step; retire the rest
            if self.requests[tid].state == RUNNING:
                self._retire(tid)
        self._evict_terminal()
        return "active"

    def _evict_terminal(self) -> None:
        """Beyond ``retain_done`` requests, evict the oldest terminal
        ones; an evicted id polls and fetches as unknown, and
        :meth:`report` covers retained requests only."""
        excess = len(self.requests) - self.retain_done
        if excess <= 0:
            return
        terminal = sorted(
            (r.t_done, tid) for tid, r in self.requests.items()
            if r.state in TERMINAL)
        for _t, tid in terminal[:excess]:
            del self.requests[tid]

    def _reject_stalled(self) -> None:
        """A capacity deadlock (no slot ever frees): reject
        everything still queued rather than spin."""
        for tid in self.queue:
            r = self.requests[tid]
            r.state = REJECTED
            r.reason = "pool cannot admit (no slot ever)"
            r.t_done = time.perf_counter()
            r.mesh = r.met = None
        self.queue = []

    def run(self, max_steps: int = 10000) -> dict:
        """Drive the loop until every request reaches a terminal state.
        Returns the serving report."""
        self._occupancy_traj.clear()
        for _ in range(max_steps):
            st = self.service_once()
            if st == "idle":
                break
            if st == "stalled":
                self._reject_stalled()
                break
        return self.report(list(self._occupancy_traj))

    # ---- reporting ----------------------------------------------------------
    def report(self, occupancy_traj=None) -> dict:
        from ..ops.adapt import AdaptStats
        agg = AdaptStats()
        tenants = {}
        for tid, r in sorted(self.requests.items()):
            if r.stats is not None:
                agg += r.stats          # namespaced per tenant
            tenants[tid] = {
                "state": r.state,
                "reason": r.reason,
                "latency_s": round(r.latency_s, 3),
                "quality": r.quality,
                "slo": r.slo,
                "cycles": r.stats.cycles if r.stats else 0,
                "ops": ([r.stats.nsplit, r.stats.ncollapse,
                         r.stats.nswap, r.stats.nmoved]
                        if r.stats else [0, 0, 0, 0]),
                "out_files": r.out_files,
            }
        lat = sorted(t["latency_s"] for t in tenants.values()
                     if t["state"] == DONE)

        def pct(p):
            # nearest-rank percentile, rank(p) = ceil(p * n)
            if not lat:
                return 0.0
            rank = (int(p * 100) * len(lat) + 99) // 100
            return round(lat[min(len(lat), max(rank, 1)) - 1], 3)

        return {
            "tenants": tenants,
            "served": sum(1 for t in tenants.values()
                          if t["state"] == DONE),
            "rejected": sum(1 for t in tenants.values()
                            if t["state"] == REJECTED),
            "failed": sum(1 for t in tenants.values()
                          if t["state"] in (FAILED, TIMEOUT)),
            "latency_p50_s": pct(0.50),
            "latency_p90_s": pct(0.90),
            "latency_p99_s": pct(0.99),
            "latency_max_s": lat[-1] if lat else 0.0,
            "admission": self.admission.summary(),
            "autoscale": (self.autoscale.summary()
                          if self.autoscale is not None else None),
            "pool": {
                "device": str(self.pool.device),
                "steps": self.pool.steps,
                "dispatches": self.pool.dispatches,
                "regrows": self.pool.regrows,
                "chunk": self.pool.chunk,
                "slots_per_bucket": self.pool.slots_per_bucket,
                "quarantined": list(self.pool.quarantined),
                "max_slot_retries": self.pool.max_slot_retries,
                "buckets": self.pool.occupancy(),
                "active_per_step": list(self.pool.active_per_step),
                "chunk_recommendation": self.pool.chunk_recommendation(),
                "pipeline_s": {k: round(v, 3)
                               for k, v in self.pool.timers.acc.items()},
            },
            "occupancy_traj": occupancy_traj or [],
            "agg_sched_extra": {k: v for k, v in agg.sched_extra.items()},
        }
