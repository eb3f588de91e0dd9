"""Typed metrics registry: counters, gauges, log-bucket histograms (the
port's copy of ``obs/metrics.py``; pure host bookkeeping).

The serving layers publish into the process registry (:data:`REGISTRY`):
the pool and driver their queue and occupancy gauges, admission and
autoscale counters and the latency histogram, ``AdaptStats`` through
:func:`publish_stats`.  :meth:`MetricsRegistry.to_prometheus` is the text
exposition the serve daemon answers on ``/metrics``;
:func:`parse_prometheus` closes the round trip.

Tenant namespacing mirrors ``AdaptStats``: a series created with
``tenant="a"`` snapshots under ``tenant:a/<name>`` and exposes with a
``{tenant="a"}`` label; ``AdaptStats.__iadd__`` refuses cross-tenant
merges before anything reaches the registry.

Histograms use fixed log buckets (powers of two from ~61 us to 256 s), so
bucket edges never depend on the data seen.
"""
from __future__ import annotations

import bisect
import re
import threading

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "REGISTRY", "parse_prometheus", "publish_stats",
]

# fixed log ladder: 2^-14 s (~61 us) .. 2^8 s (256 s); +Inf implicit
DEFAULT_BUCKETS = tuple(2.0 ** e for e in range(-14, 9))


class Counter:
    """Monotone accumulator (float increments allowed — segment
    seconds accumulate here too)."""
    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bound histogram; ``le`` bounds are INCLUSIVE upper edges
    (the Prometheus convention), with an implicit +Inf bucket."""
    kind = "histogram"
    __slots__ = ("bounds", "counts", "sum", "n")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if any(b2 <= b1 for b1, b2 in zip(self.bounds, self.bounds[1:])):
            raise ValueError("histogram bounds must be increasing")
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.n += 1
        # first bound >= v -> v lands in that (inclusive-upper) bucket
        self.counts[bisect.bisect_left(self.bounds, v)] += 1

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le, cumulative count)] including the +Inf bucket."""
        out = []
        run = 0
        for b, c in zip(self.bounds, self.counts):
            run += c
            out.append((b, run))
        out.append((float("inf"), run + self.counts[-1]))
        return out


class MetricsRegistry:
    """(name, tenant) -> metric.  Names are dotted (``serve.latency_s``);
    the tenant tag is optional and keeps per-tenant series separate."""

    def __init__(self):
        self._m: dict[tuple[str, str | None], object] = {}
        self._lock = threading.Lock()

    def _get(self, kind, name: str, tenant, factory):
        key = (str(name), None if tenant is None else str(tenant))
        with self._lock:
            m = self._m.get(key)
            if m is None:
                m = self._m[key] = factory()
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r} (tenant={tenant!r}) already "
                    f"registered as {m.kind}, requested {kind}")
            return m

    def counter(self, name: str, tenant: str | None = None) -> Counter:
        return self._get("counter", name, tenant, Counter)

    def gauge(self, name: str, tenant: str | None = None) -> Gauge:
        return self._get("gauge", name, tenant, Gauge)

    def histogram(self, name: str, tenant: str | None = None,
                  bounds=None) -> Histogram:
        return self._get("histogram", name, tenant,
                         lambda: Histogram(bounds or DEFAULT_BUCKETS))

    def reset(self) -> None:
        with self._lock:
            self._m.clear()

    # ---- reporting --------------------------------------------------------
    @staticmethod
    def _series_key(name: str, tenant: str | None) -> str:
        # the AdaptStats sched_extra namespacing convention
        return name if tenant is None else f"tenant:{tenant}/{name}"

    def snapshot(self) -> dict:
        """JSON-serializable {"counters": {...}, "gauges": {...},
        "histograms": {...}} keyed by the (tenant-namespaced) series
        name — the artifact's ``metrics`` block."""
        with self._lock:
            items = sorted(self._m.items(),
                           key=lambda kv: (kv[0][0], kv[0][1] or ""))
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, tenant), m in items:
            k = self._series_key(name, tenant)
            if m.kind == "counter":
                out["counters"][k] = m.value
            elif m.kind == "gauge":
                out["gauges"][k] = m.value
            else:
                out["histograms"][k] = {
                    "buckets": {repr(le): c
                                for le, c in m.cumulative()},
                    "sum": m.sum, "count": m.n}
        return out

    def to_prometheus(self, prefix: str = "parmmg") -> str:
        """Prometheus text exposition (one HELP-less block per metric;
        tenant as a label; counters suffixed ``_total``)."""
        with self._lock:
            items = sorted(self._m.items(),
                           key=lambda kv: (kv[0][0], kv[0][1] or ""))
        lines = []
        typed: set[str] = set()
        for (name, tenant), m in items:
            base = _prom_name(name, prefix)
            suffix = "_total" if m.kind == "counter" else ""
            full = base + suffix
            if full not in typed:
                typed.add(full)
                lines.append(f"# TYPE {full} {m.kind}")
            lbl = "" if tenant is None else \
                '{tenant="' + _prom_escape(tenant) + '"}'
            if m.kind in ("counter", "gauge"):
                lines.append(f"{full}{lbl} {_prom_num(m.value)}")
            else:
                for le, c in m.cumulative():
                    ll = f'le="{_prom_num(le)}"'
                    if tenant is not None:
                        ll = f'tenant="{_prom_escape(tenant)}",' + ll
                    lines.append(f"{full}_bucket{{{ll}}} {c}")
                lines.append(f"{full}_sum{lbl} {_prom_num(m.sum)}")
                lines.append(f"{full}_count{lbl} {m.n}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str, prefix: str) -> str:
    return prefix + "_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _prom_num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


_LINE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<val>\S+)$')
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Exposition text -> {(series name, frozenset(label items)):
    value} — the round-trip half the exposition test closes."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = frozenset(
            (k, v.replace('\\"', '"').replace("\\\\", "\\"))
            for k, v in _LABEL_RE.findall(m.group("labels") or ""))
        v = m.group("val")
        out[(m.group("name"), labels)] = \
            float("inf") if v == "+Inf" else float(v)
    return out


REGISTRY = MetricsRegistry()


def publish_stats(stats, registry: MetricsRegistry | None = None) -> None:
    """AdaptStats -> metrics bridge.  Series are tenant-tagged from
    ``stats.tenant``; the cross-tenant isolation contract lives in
    ``AdaptStats.__iadd__`` (still raises), so by the time stats reach
    here they are either single-tenant or a legitimately namespaced
    aggregate."""
    reg = registry if registry is not None else REGISTRY
    t = getattr(stats, "tenant", None)
    for name, v in (("adapt.nsplit", stats.nsplit),
                    ("adapt.ncollapse", stats.ncollapse),
                    ("adapt.nswap", stats.nswap),
                    ("adapt.nmoved", stats.nmoved),
                    ("adapt.cycles", stats.cycles),
                    ("adapt.regrows", stats.regrows),
                    ("sched.group_dispatches", stats.group_dispatches),
                    ("sched.group_dispatches_saved",
                     stats.group_dispatches_saved),
                    ("sched.groups_skipped", stats.groups_skipped)):
        if v:
            reg.counter(name, tenant=t).inc(v)
    reg.gauge("adapt.status", tenant=t).set(float(stats.status))
    for k, v in stats.sched_extra.items():
        # already-tenant-namespaced keys (an aggregate's absorbed
        # per-tenant trajectories) keep their AdaptStats spelling
        if k.startswith("tenant:") or not k.endswith("_s") \
                or not isinstance(v, (int, float)):
            continue
        reg.counter(f"sched.{k}", tenant=t).inc(float(v))
