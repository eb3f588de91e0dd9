"""SLO-driven autoscaling + admission backpressure (port of
``serve/autoscale.py``).

The metrics the pool and the admission pump publish —
``serve.queue_depth``, ``serve.occupancy.<bucket>`` /
``serve.slots.<bucket>``, the ``serve.latency_s`` histogram, the
``serve.slo_violation`` counters and ``serve.admit_blocked.<bucket>`` —
are the control signal:

- :func:`decide` is the controller as a pure function of a metrics
  snapshot: bucket resize targets (grow a bucket whose fullness blocks
  admissions, shrink an idle one) and the backpressure verdict (defer
  when the queue reaches ``max_queue`` or the observed p99 latency passes
  ``target_p99_s`` with work queued; the latch releases at half the queue
  bound, so it cannot flap);
- :class:`AutoscaleController` holds the state a pure policy cannot
  (per-bucket idle streaks for the shrink debounce, the defer latch, the
  latency window) and actuates: ``SlotPool.resize_bucket`` and the
  admission controller's ``deferring`` latch.  Every decision is a
  ``serve.autoscale`` trace event and a ``serve.autoscale.*`` counter.

A quarantined tenant's slot is scrubbed and recycled by the pool, which
this controller observes as freed occupancy.  ``ServeDriver(autoscale=
False)`` turns the loop off (the JAX package's PARMMG_SERVE_AUTOSCALE=0).
"""
from __future__ import annotations

import dataclasses

__all__ = ["AutoscaleController", "Decision", "decide",
           "latency_quantile", "read_inputs"]

# the floor a shrink stops at: every bucket keeps one slot
MIN_SLOTS = 1


@dataclasses.dataclass(frozen=True)
class Decision:
    """One controller evaluation: bucket-label -> target slot count
    maps plus the admission backpressure verdict."""
    grow: dict
    shrink: dict
    defer: bool
    reasons: tuple = ()


def latency_quantile(hist: dict, q: float) -> float:
    """Approximate quantile from a snapshot histogram block
    (``{"buckets": {repr(le): cumulative}, "count": n}`` — the
    ``MetricsRegistry.snapshot()`` shape): the smallest bucket edge
    whose cumulative count covers ``q`` (the Prometheus
    histogram_quantile upper-edge convention; conservative, never
    under-reports)."""
    n = int(hist.get("count", 0) or 0)
    if n == 0:
        return 0.0
    target = q * n
    edges = sorted((float(le), int(c))
                   for le, c in (hist.get("buckets") or {}).items())
    for le, c in edges:
        if c >= target:
            return le
    return edges[-1][0] if edges else 0.0


def read_inputs(snapshot: dict, deferring: bool = False) -> dict:
    """Metrics snapshot (``MetricsRegistry.snapshot()``) -> controller
    inputs: queue depth, per-bucket occupancy/slots/blocked-admission
    pressure, observed p99 latency, and the aggregate SLO-violation
    count (summed across tenant-namespaced series)."""
    g = snapshot.get("gauges") or {}
    c = snapshot.get("counters") or {}
    h = snapshot.get("histograms") or {}
    occ: dict = {}
    slots: dict = {}
    blocked: dict = {}
    for k, v in g.items():
        if k.startswith("serve.occupancy."):
            occ[k[len("serve.occupancy."):]] = int(v)
        elif k.startswith("serve.slots."):
            slots[k[len("serve.slots."):]] = int(v)
        elif k.startswith("serve.admit_blocked."):
            blocked[k[len("serve.admit_blocked."):]] = int(v)
    return {
        "queue_depth": int(g.get("serve.queue_depth", 0)),
        "occupancy": occ, "slots": slots, "blocked": blocked,
        "p99_s": latency_quantile(h.get("serve.latency_s", {}), 0.99),
        "slo_violations": sum(
            v for k, v in c.items()
            if k.endswith("serve.slo_violation")),
        "deferring": bool(deferring),
    }


def decide(inputs: dict, *, max_slots: int = 16,
           max_queue: int = 0, target_p99_s: float = 0.0,
           idle_evals: dict | None = None,
           shrink_after: int = 3) -> Decision:
    """The pure policy.  ``inputs`` is :func:`read_inputs` output;
    ``idle_evals`` the per-bucket consecutive-idle-evaluation streaks
    the stateful controller tracks (shrink debounce).

    Rules:
    - GROW a bucket by one slot (up to ``max_slots``) when its fullness
      blocked at least one admission this pump and every slot is rented
      — targeted by the actual queued demand, not a guess;
    - SHRINK an idle bucket by one slot (down to ``MIN_SLOTS``) only
      when the queue is empty and the bucket sat idle for
      ``shrink_after`` consecutive evaluations;
    - DEFER new admissions when the queue passes ``max_queue`` or
      observed p99 passes ``target_p99_s`` with work still queued;
      release the latch once the queue drains to half the bound
      (hysteresis — the latch cannot flap on one retirement)."""
    grow: dict = {}
    shrink: dict = {}
    reasons: list[str] = []
    qd = int(inputs.get("queue_depth", 0))
    slots = inputs.get("slots") or {}
    occ = inputs.get("occupancy") or {}
    for label, nblk in sorted((inputs.get("blocked") or {}).items()):
        if nblk <= 0:
            continue
        n = int(slots.get(label, 0))
        used = int(occ.get(label, 0))
        if n and used >= n and n < max_slots:
            grow[label] = n + 1
            reasons.append(f"grow {label} -> {n + 1}: {nblk} blocked "
                           f"admission(s) at {used}/{n}")
    idle_evals = idle_evals or {}
    if qd == 0:
        for label, n in sorted(slots.items()):
            if label in grow:
                continue
            if int(occ.get(label, 0)) == 0 and n > MIN_SLOTS \
                    and idle_evals.get(label, 0) >= shrink_after:
                shrink[label] = n - 1
                reasons.append(
                    f"shrink {label} -> {n - 1}: idle for "
                    f"{idle_evals[label]} evaluations")
    defer = bool(inputs.get("deferring"))
    p99 = float(inputs.get("p99_s", 0.0))
    hot = (max_queue and qd >= max_queue) or \
        (target_p99_s and p99 > target_p99_s and qd > 0)
    if hot and not defer:
        defer = True
        why = [f"queue_depth {qd}"]
        if target_p99_s and p99 > target_p99_s:
            why.append(f"p99 {p99:.3g}s > target {target_p99_s:g}s")
        viol = inputs.get("slo_violations", 0)
        if viol:
            # quality-SLO context on the shed decision (quarantine owns
            # per-tenant isolation; backpressure owns load)
            why.append(f"{viol:g} slo violation(s) recorded")
        reasons.append("defer admissions: " + ", ".join(why))
    elif defer and not hot and qd <= (max_queue // 2):
        # release only once NOTHING is hot (a still-breached p99 must
        # not flap the latch every evaluation) AND the queue drained
        # past half the bound
        defer = False
        reasons.append(f"resume admissions: queue_depth {qd}")
    return Decision(grow=grow, shrink=shrink, defer=defer,
                    reasons=tuple(reasons))


class AutoscaleController:
    """Stateful wrapper + actuator around :func:`decide`.

    Knobs (the JAX package's ``PARMMG_SERVE_*`` variables, with their
    defaults): ``max_slots`` (MAX_SLOTS, 16, the per-bucket growth
    ceiling), ``max_queue`` (MAX_QUEUE, 0; shared with admission),
    ``target_p99_s`` (TARGET_P99_S, 0 = latency SLO off)."""

    def __init__(self, max_slots: int = 16,
                 max_queue: int = 0, target_p99_s: float = 0.0,
                 shrink_after: int = 3):
        self.max_slots = int(max_slots)
        self.max_queue = int(max_queue)
        self.target_p99_s = float(target_p99_s)
        self.shrink_after = int(shrink_after)
        self._idle: dict = {}           # bucket label -> idle streak
        self._last_hist: dict | None = None   # p99 windowing state
        self.deferring = False
        self.grows = 0
        self.shrinks = 0
        self.defers = 0
        self.evals = 0

    def _window_hist(self, hist: dict | None) -> dict:
        """Latency histogram DELTA since the previous evaluation: the
        registry histogram is lifetime-cumulative, and a p99 computed
        over the whole lifetime would let cold-start latencies
        pin the backpressure signal above target forever.  Cumulative
        bucket counts subtract bucket-wise (delta of cumulative ==
        cumulative of delta); an evaluation window with no new
        observations yields count 0 -> p99 0 (no recent latency
        evidence, no latency-driven deferral)."""
        cur = {"buckets": dict((hist or {}).get("buckets") or {}),
               "count": int((hist or {}).get("count", 0) or 0)}
        prev, self._last_hist = self._last_hist, cur
        if prev is None:
            return cur
        return {"buckets": {le: c - prev["buckets"].get(le, 0)
                            for le, c in cur["buckets"].items()},
                "count": cur["count"] - prev["count"]}

    def evaluate(self, snapshot: dict) -> Decision:
        """One evaluation of a metrics snapshot (no actuation): decide
        over the windowed latency signal, then advance the idle streaks
        the NEXT decision debounces on."""
        snapshot = dict(snapshot)
        hists = dict(snapshot.get("histograms") or {})
        hists["serve.latency_s"] = self._window_hist(
            hists.get("serve.latency_s"))
        snapshot["histograms"] = hists
        inputs = read_inputs(snapshot, self.deferring)
        d = decide(inputs, max_slots=self.max_slots,
                   max_queue=self.max_queue,
                   target_p99_s=self.target_p99_s,
                   idle_evals=dict(self._idle),
                   shrink_after=self.shrink_after)
        for label, n in inputs["slots"].items():
            if inputs["occupancy"].get(label, 0) == 0 \
                    and inputs["queue_depth"] == 0:
                self._idle[label] = self._idle.get(label, 0) + 1
            else:
                self._idle[label] = 0
        for label in d.shrink:          # a shrink restarts its streak
            self._idle[label] = 0
        return d

    def tick(self, pool, admission=None, registry=None) -> Decision:
        """Evaluate the live registry and ACTUATE: resize pool buckets,
        flip the admission defer latch, account + trace everything."""
        from ..obs import trace as otrace
        from ..obs.metrics import REGISTRY
        reg = registry if registry is not None else REGISTRY
        self.evals += 1
        reg.counter("serve.autoscale.evals").inc()
        # refresh occupancy/slots gauges from the POOL (authoritative)
        # before snapshotting: step() only publishes them while tenants
        # are active, and an idle pool's frozen gauges would otherwise
        # pin shrink at (last-gauged nslots - 1) forever
        for label, (used, n) in pool.occupancy().items():
            reg.gauge(f"serve.occupancy.{label}").set(used)
            reg.gauge(f"serve.slots.{label}").set(n)
        d = self.evaluate(reg.snapshot())
        labels = pool.labels()
        for action, targets in (("grow", d.grow), ("shrink", d.shrink)):
            for label, n in sorted(targets.items()):
                key = labels.get(label)
                if key is None:
                    continue
                before = pool.buckets[key].nslots
                after = pool.resize_bucket(key, n)
                if after == before:
                    continue            # e.g. trailing slot still rented
                if action == "grow":
                    self.grows += 1
                    reg.counter("serve.autoscale.grow").inc()
                else:
                    self.shrinks += 1
                    reg.counter("serve.autoscale.shrink").inc()
                otrace.event("serve.autoscale", action=action,
                             bucket=label, nslots=after)
                otrace.log(2, f"serve autoscale: {action} {label} "
                              f"{before} -> {after} slots", err=True)
        if d.defer != self.deferring:
            self.deferring = d.defer
            if d.defer:
                self.defers += 1
                reg.counter("serve.autoscale.defer").inc()
            otrace.event("serve.autoscale",
                         action="defer" if d.defer else "resume")
            otrace.log(1, "serve autoscale: "
                          + ("DEFERRING admissions"
                             if d.defer else "resuming admissions")
                          + (" — " + "; ".join(d.reasons)
                             if d.reasons else ""), err=True)
        if admission is not None:
            admission.deferring = self.deferring
        return d

    def summary(self) -> dict:
        return {"evals": self.evals, "grows": self.grows,
                "shrinks": self.shrinks, "defers": self.defers,
                "deferring": self.deferring,
                "max_slots": self.max_slots,
                "max_queue": self.max_queue,
                "target_p99_s": self.target_p99_s}
