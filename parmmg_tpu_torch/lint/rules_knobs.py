"""R4 knob-registry: every ``PMTORCH_*`` knob declared exactly once.

``parmmg_tpu_torch/api/knobs.py`` is the registry (type + default + one-line
doc per knob), and the port reads its environment only through
``knobs.get`` (``resilience.watchdog.deadline_knob`` for the deadline
knobs).  R4 holds the registry to the package and README in both
directions, with NO baseline — the rule ``tests/test_torch_knobs.py``
holds at run time, statically:

- an environment read outside ``api/knobs.py`` (``os.environ.get``,
  ``os.getenv``, an ``os.environ[...]`` load) is flagged outright:
  the registry is the one reader;
- every ``knobs.get`` / ``deadline_knob`` read of a ``PMTORCH_*`` name
  must name a registered knob; a read through a non-literal name that
  visibly builds a ``PMTORCH_`` key is flagged (unauditable);
- every registered knob must be read somewhere in the package —
  otherwise it is dead and fails;
- every registered knob must appear in README.md, and every
  ``PMTORCH_*`` token README mentions must be registered (a token ending
  in ``_`` is a prefix, as in ``PMTORCH_RETRY_*``, not a knob).

The scope is the package: the tests set knobs with ``monkeypatch`` and
read undeclared names on purpose.  The JAX package's own R4 reads the
same README for ``PARMMG_*`` names, against its registry.
"""
from __future__ import annotations

import ast
import re

from . import flow
from .engine import (KNOBS_REL, PKG, Violation, dotted, rule, str_const,
                     walk_scoped)

_KNOB_RE = re.compile(r"^PMTORCH_[A-Z0-9_]+$")
_KNOB_TOKEN_RE = re.compile(r"PMTORCH_[A-Z0-9_]+")

_SCOPE = (PKG,)

#: the registry's readers: ``knobs.get(name)`` and the watchdog's
#: ``deadline_knob(name)``
_READERS = ("deadline_knob",)


def _env_access(node) -> bool:
    """A direct read of the process environment."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        base = dotted(node.func.value)
        if node.func.attr == "get" and base.endswith("environ"):
            return True
        if node.func.attr == "getenv" and base == "os":
            return True
    return (isinstance(node, ast.Subscript)
            and dotted(node.value).endswith("environ")
            and isinstance(node.ctx, ast.Load))


def _knob_read_name(call):
    """The name-argument node of a registry read, or None."""
    f = call.func
    if not call.args:
        return None
    if isinstance(f, ast.Attribute) and f.attr == "get" \
            and dotted(f.value).split(".")[-1] == "knobs":
        return call.args[0]
    if flow.leaf_name(f) in _READERS:
        return call.args[0]
    return None


@rule("R4")
def check_r4(ctx) -> list:
    registry = ctx.knob_registry()
    out: list[Violation] = []
    read: set = set()

    for sf in ctx.iter(_SCOPE, exclude=(KNOBS_REL,)):
        if sf.tree is None:
            continue
        for node, qn, _funcs in walk_scoped(sf.tree):
            if _env_access(node):
                out.append(Violation(
                    "R4", sf.rel, node.lineno, qn, "direct-env-read",
                    "environment read outside api/knobs.py — read a "
                    "declared knob through knobs.get"))
            if not isinstance(node, ast.Call):
                continue
            nm = _knob_read_name(node)
            if nm is None:
                continue
            s = str_const(nm)
            if s is None:
                if any("PMTORCH_" in c.value
                       for c in ast.walk(nm)
                       if isinstance(c, ast.Constant)
                       and isinstance(c.value, str)):
                    out.append(Violation(
                        "R4", sf.rel, node.lineno, qn, "dynamic-env-read",
                        "PMTORCH_* knob read through a non-literal name "
                        "— unauditable"))
                continue
            if not _KNOB_RE.match(s):
                continue
            read.add(s)
            if s not in registry:
                out.append(Violation(
                    "R4", sf.rel, node.lineno, qn, s,
                    f"read of unregistered knob {s} — declare it in "
                    "parmmg_tpu_torch/api/knobs.py"))

    # dead registered knobs
    for name, info in sorted(registry.items()):
        if name not in read:
            out.append(Violation(
                "R4", KNOBS_REL, info.get("line", 0), "KNOBS", name,
                f"registered knob {name} is read nowhere in the package "
                "— dead; delete it or wire it"))

    # README two-way check
    readme = ctx.readme_text or ""
    readme_knobs = {t for t in _KNOB_TOKEN_RE.findall(readme)
                    if not t.endswith("_")}
    for name, info in sorted(registry.items()):
        if name not in readme_knobs:
            out.append(Violation(
                "R4", KNOBS_REL, info.get("line", 0), "KNOBS", name,
                f"registered knob {name} missing from README.md — "
                "regenerate the knob table "
                "(python -m parmmg_tpu_torch.api.knobs)"))
    for name in sorted(readme_knobs - set(registry)):
        out.append(Violation(
            "R4", "README.md", 0, "<doc>", name,
            f"README mentions unregistered knob {name} — register it "
            "or fix the doc"))
    return out
