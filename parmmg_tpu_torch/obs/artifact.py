"""Canonical schema-versioned run artifact and cross-artifact differ (the
port's copy of ``obs/artifact.py``).

The canonical schema (v1) keeps every legacy top-level key (``metric`` /
``value`` / ``unit`` / ``vs_baseline`` / ``extra``) and adds:

- ``schema_version`` + ``kind`` — self-identifying artifacts;
- ``env`` — the run's provenance: python, platform, torch and CUDA
  versions, the card's name, and the ``PMTORCH_*`` knobs set;
- ``metrics`` — the obs registry snapshot (counters/gauges/histograms);
- ``trace`` — the tracer digest (event counts, sink, top span totals).

The shape ledger stays at ``extra.compile_ledger``, where every artifact
of the JAX package keeps its compile ledger.

:func:`upgrade_artifact` adapts any legacy artifact (the round wrapper
``{"parsed": {...}}``, the bare multihost result dict) to the canonical
shape, so :func:`validate_artifact` and :func:`artifact_diff` treat the
repository's history and a new run alike; on the same documents they
give the JAX package's upgrades, problems and diffs.
"""
from __future__ import annotations

__all__ = ["SCHEMA_VERSION", "KINDS", "artifact_diff", "env_block",
           "make_artifact", "upgrade_artifact", "validate_artifact"]

SCHEMA_VERSION = 1
KINDS = ("BENCH", "SCALE", "SERVE", "MULTIHOST", "SOAK")


def env_block() -> dict:
    """Runtime provenance: python, platform, torch and its CUDA, the
    backend (``cuda`` where a card is present, else ``cpu``), the cards
    and the first one's name, and the ``PMTORCH_*`` knobs set."""
    import platform

    import torch

    from ..api import knobs
    out = {"python": platform.python_version(),
           "platform": platform.platform(),
           "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if torch.cuda.is_available():
        out["backend"] = "cuda"
        out["device_count"] = torch.cuda.device_count()
        out["device"] = torch.cuda.get_device_name(0)
    else:
        out["backend"] = "cpu"
        out["device_count"] = 0
    out["knobs"] = knobs.environment()
    return out


def make_artifact(kind: str, metric: str, value: float, unit: str,
                  extra: dict | None = None,
                  vs_baseline: float | None = None,
                  registry=None, tracer=None) -> dict:
    """Build a canonical artifact document (JSON-serializable)."""
    from .metrics import REGISTRY
    from .trace import TRACER
    if kind not in KINDS:
        raise ValueError(f"unknown artifact kind {kind!r}")
    extra = dict(extra or {})
    if "compile_ledger" not in extra:
        from ..utils.compilecache import ledger_snapshot
        extra["compile_ledger"] = ledger_snapshot()
    doc = {"schema_version": SCHEMA_VERSION, "kind": kind,
           "metric": metric, "value": value, "unit": unit,
           "env": env_block(),
           "metrics": (registry if registry is not None
                       else REGISTRY).snapshot(),
           "trace": (tracer if tracer is not None
                     else TRACER).summary(),
           "extra": extra}
    if vs_baseline is not None:
        doc["vs_baseline"] = vs_baseline
    return doc


def upgrade_artifact(doc: dict) -> dict:
    """Adapt any artifact shape the repository holds to canonical v1: the
    round wrapper (``{"parsed": {...}}``), the bench/scale/serve
    one-liners, the bare multihost result dict; canonical documents pass
    through untouched."""
    if not isinstance(doc, dict):
        raise ValueError("artifact is not a JSON object")
    if isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    if doc.get("schema_version") == SCHEMA_VERSION:
        return doc
    metric = str(doc.get("metric", ""))
    if "serve" in metric:
        kind = "SERVE"
    elif "scale" in metric:
        kind = "SCALE"
    elif metric:
        kind = "BENCH"
    else:
        # the bare multihost result dict has no metric/value keys
        kind = "MULTIHOST"
    extra = dict(doc.get("extra") or {})
    if kind == "MULTIHOST" and not extra:
        extra = {k: v for k, v in doc.items()
                 if k not in ("metric", "value", "unit", "vs_baseline")}
    extra.setdefault("compile_ledger", {})
    up = {"schema_version": SCHEMA_VERSION, "kind": kind,
          "metric": metric or "multihost_adapt",
          "value": float(doc.get("value", doc.get("seconds", 0.0))
                         or 0.0),
          "unit": str(doc.get("unit", "s" if "seconds" in doc else "")),
          "env": {"backend": str(extra.get("device",
                                           doc.get("device", "?"))),
                  "upgraded_from_legacy": True},
          "metrics": {"counters": {}, "gauges": {}, "histograms": {}},
          "trace": {"events": 0, "ring": 0, "dropped": 0, "sink": "",
                    "top_spans_s": {}},
          "extra": extra}
    if "vs_baseline" in doc:
        up["vs_baseline"] = doc["vs_baseline"]
    return up


def validate_artifact(doc: dict) -> list[str]:
    """Canonical-schema check.  Returns the list of problems (empty ==
    valid); legacy artifacts validate through
    ``validate_artifact(upgrade_artifact(doc))``."""
    if not isinstance(doc, dict):
        return ["artifact is not a JSON object"]
    probs = []
    for k, typ in (("schema_version", int), ("kind", str),
                   ("metric", str), ("unit", str), ("env", dict),
                   ("metrics", dict), ("trace", dict), ("extra", dict)):
        if k not in doc:
            probs.append(f"missing key {k!r}")
        elif not isinstance(doc[k], typ):
            probs.append(f"{k} is not a {typ.__name__}")
    if not isinstance(doc.get("value"), (int, float)) \
            or isinstance(doc.get("value"), bool):
        probs.append("value missing or not numeric")
    if isinstance(doc.get("schema_version"), int) \
            and doc["schema_version"] != SCHEMA_VERSION:
        probs.append(f"schema_version {doc['schema_version']} != "
                     f"{SCHEMA_VERSION}")
    if isinstance(doc.get("kind"), str) and doc["kind"] not in KINDS:
        probs.append(f"unknown kind {doc['kind']!r}")
    if isinstance(doc.get("env"), dict) and "backend" not in doc["env"]:
        probs.append("env.backend missing")
    if isinstance(doc.get("metrics"), dict):
        for sub in ("counters", "gauges", "histograms"):
            if not isinstance(doc["metrics"].get(sub), dict):
                probs.append(f"metrics.{sub} missing or not an object")
    if isinstance(doc.get("extra"), dict) \
            and not isinstance(doc["extra"].get("compile_ledger", {}),
                               dict):
        probs.append("extra.compile_ledger is not an object")
    return probs


def artifact_diff(old: dict, new: dict, tol: float = 0.10) -> dict:
    """Cross-artifact regression differ (both sides upgraded first).

    Returns {"ledger": [...], "value": [...], "quality": [...],
    "notes": [...]}: ``ledger`` = shape-variant growth on shared entry
    points; ``value`` = the headline metric getting worse by more than
    ``tol`` on a same-kind/same-metric pair (a seconds-valued headline
    regresses up, every other unit down); ``quality`` = qmin/qmean
    dropping by more than ``tol``; ``notes`` = soft signals (scheduler
    savings shrinking, metric counters disappearing)."""
    from ..utils.compilecache import extract_artifact_ledger, ledger_diff
    o, n = upgrade_artifact(old), upgrade_artifact(new)
    out = {"ledger": [], "value": [], "quality": [], "notes": []}
    # the ledger comes from the original documents: extract_artifact_
    # ledger also accepts a plain ledger snapshot, which the upgrade would
    # bury under extra
    out["ledger"] = ledger_diff(extract_artifact_ledger(old),
                                extract_artifact_ledger(new))
    comparable = (o.get("kind") == n.get("kind")
                  and o.get("metric") == n.get("metric"))
    if comparable:
        vo = float(o.get("value") or 0.0)
        vn = float(n.get("value") or 0.0)
        unit = str(n.get("unit", o.get("unit", ""))).strip().lower()
        lower_is_better = unit == "s" or unit.startswith("second") \
            or unit.endswith("seconds")
        if vo > 0 and (vn > vo * (1 + tol) if lower_is_better
                       else vn < vo * (1 - tol)):
            pct = (vn / vo - 1) * 100
            out["value"].append(
                f"{o['metric']}: {vo} -> {vn} ({pct:+.1f}%)")
        for q in ("qmin", "qmean"):
            a = o["extra"].get(q)
            b = n["extra"].get(q)
            if isinstance(a, (int, float)) and a > 0 \
                    and isinstance(b, (int, float)) \
                    and b < a * (1 - tol):
                out["quality"].append(f"{q}: {a} -> {b}")
        sa = o["extra"].get("saved_dispatches")
        sb = n["extra"].get("saved_dispatches")
        if isinstance(sa, (int, float)) and sa > 0 \
                and isinstance(sb, (int, float)) \
                and sb < sa * (1 - tol):
            out["notes"].append(
                f"saved_dispatches: {sa} -> {sb} (scheduler win shrank)")
    mo = (o.get("metrics") or {}).get("counters") or {}
    mn = (n.get("metrics") or {}).get("counters") or {}
    for k in sorted(set(mo) - set(mn)):
        out["notes"].append(f"metric counter disappeared: {k}")
    return out
