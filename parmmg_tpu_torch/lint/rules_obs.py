"""R3 obs-routing + R6 name-schemes: the telemetry contracts, statically,
on the port's tree (the port's copy of the JAX package's
``lint/rules_obs.py``).

R3 — no bare ``print(`` in ``parmmg_tpu_torch/`` outside ``obs/``:
``obs.trace.log(level, msg, verbose=...)`` is the ONE verbosity-gated
print path, and it emits a trace record whether or not the line shows,
so quiet runs still reach the trace ring.  The few legitimate stdout
contracts inside the package (the CLI's machine-readable lines, the
polish worker's relay, the lint report) carry reasoned suppressions.

R6 — metric / trace-event / faultpoint names must be STATIC
dotted-lowercase literals: series names are the cross-artifact join
key and every dynamic name is a potential unbounded-cardinality series.
Checked call surfaces: ``REGISTRY.counter/gauge/histogram``,
``otrace.event`` / ``event`` (obs.trace), ``faultpoint`` /
``fault_trigger`` (site must exist in the port's
``resilience.faults.SITES``), ``ladder_step`` (step must exist in its
``recover.LADDER``).  A conditional expression over literals is fine; an
f-string or concatenation needs a suppression arguing the cardinality
bound.
"""
from __future__ import annotations

import ast
import re

from .engine import (FAULTS_REL, PKG, RECOVER_REL, Violation, dotted, rule,
                     str_const, walk_scoped)

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)*$")

_R3_SCOPE = (PKG,)
_R3_EXCLUDE = (PKG + "obs/",)

_R6_SCOPE = (PKG,)
# the spine itself (generic emitters take the name as a parameter) and
# the registries' home modules are exempt by construction
_R6_EXCLUDE = (PKG + "obs/", FAULTS_REL, RECOVER_REL)

_METRIC_METHODS = ("counter", "gauge", "histogram")


@rule("R3")
def check_r3(ctx) -> list:
    out = []
    for sf in ctx.iter(_R3_SCOPE, exclude=_R3_EXCLUDE):
        if sf.tree is None:
            continue
        for node, qn, _funcs in walk_scoped(sf.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                out.append(Violation(
                    "R3", sf.rel, node.lineno, qn, "print",
                    "bare print() outside obs/ — route through "
                    "obs.trace.log so the trace ring sees it"))
    return out


def _literal_names(node):
    """All string literals a name argument can evaluate to, or None if
    any branch is dynamic.  Handles plain constants and (nested)
    conditional expressions over constants."""
    s = str_const(node)
    if s is not None:
        return [s]
    if isinstance(node, ast.IfExp):
        a = _literal_names(node.body)
        b = _literal_names(node.orelse)
        if a is not None and b is not None:
            return a + b
    return None


@rule("R6")
def check_r6(ctx) -> list:
    sites = ctx.fault_sites()
    ladder = ctx.ladder_steps()
    out = []
    for sf in ctx.iter(_R6_SCOPE, exclude=_R6_EXCLUDE):
        if sf.tree is None:
            continue
        for node, qn, _funcs in walk_scoped(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _call_kind(node)
            if kind is None or not node.args:
                continue
            names = _literal_names(node.args[0])
            if names is None:
                out.append(Violation(
                    "R6", sf.rel, node.lineno, qn, f"{kind}:dynamic",
                    f"dynamic {kind} name — series names must be "
                    "static literals (suppress with the cardinality "
                    "bound if the dynamic part is finite)"))
                continue
            for s in names:
                if not _NAME_RE.match(s):
                    out.append(Violation(
                        "R6", sf.rel, node.lineno, qn, f"{kind}:{s}",
                        f"{kind} name {s!r} is not dotted-lowercase "
                        "([a-z0-9_] segments joined by '.')"))
                elif kind == "faultpoint" and sites and s not in sites:
                    out.append(Violation(
                        "R6", sf.rel, node.lineno, qn, f"{kind}:{s}",
                        f"faultpoint site {s!r} not in "
                        "resilience.faults.SITES"))
                elif kind == "ladder_step" and ladder and \
                        s not in ladder:
                    out.append(Violation(
                        "R6", sf.rel, node.lineno, qn, f"{kind}:{s}",
                        f"ladder step {s!r} not in recover.LADDER"))
    return out


def _call_kind(node) -> str | None:
    """Classify a call as a named-series emitter, or None."""
    f = node.func
    if isinstance(f, ast.Attribute):
        base = dotted(f.value)
        if f.attr in _METRIC_METHODS and base.endswith("REGISTRY"):
            return f"metric.{f.attr}"
        if f.attr == "event" and base in ("otrace", "trace", "obs.trace"):
            return "event"
    if isinstance(f, ast.Name):
        if f.id in ("faultpoint", "fault_trigger"):
            return "faultpoint"
        if f.id == "ladder_step":
            return "ladder_step"
        if f.id == "event":
            return "event"
    return None
