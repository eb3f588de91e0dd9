"""R8 SPMD collective alignment: no collective control-dependent on a
rank-divergent value (the port's copy of the JAX package's
``lint/rules_spmd.py``).

A collective (``all_reduce``, ``all_gather``, ``all_to_all_single``,
``barrier``, ``pod.gather_band``, ``multihost.agree``...) that one rank
reaches and another does not wedges every rank until the heartbeat lease
kills the pack (``resilience/watchdog.py`` — R8 is the static half of
that ladder).  The rule taints the rank — ``multihost.rank()``,
``torch.distributed.get_rank()``, a ``RANK`` / ``LOCAL_RANK`` read
(``knobs.launcher`` or the environment) — propagates it through
assignments (flow.taint_names), and flags four shapes:

- **divergent-collective** — a collective call (or a call into any
  function whose summary says it transitively performs one) that is
  control-dependent on rank-tainted state: unless every rank computes
  the same truth value, the ranks disagree on how many collectives
  they run;
- **collective-after-divergent-exit** — a rank-tainted guard around a
  ``return``/``raise``/``break``/``continue`` with a collective later
  in the same function: the exiting rank skips it, the rest block;
- **rank-tainted-arg** — a rank-divergent value escaping as an
  argument into an ordinary call (divergence by data instead of control
  flow);
- **rank-gated-call** — any effectful call under a rank-tainted guard
  (per-rank side effects that must be an explicitly blessed rank-scoped
  action, not an accident).

Blessed idioms the rule recognizes (no suppression needed):

- ``multihost.mh_uniform(value, why)`` — the runtime-identity marker
  asserting a rank-derived value is agreed (or deliberately rank-scoped
  with the agreement described in ``why``); its result is untainted.
- the collectives themselves: PASSING a rank-local value to
  ``all_gather_rows`` (etc.) is exactly how ranks agree, and the
  *result* of a collective is uniform by construction, so it launders
  taint.

Anything else carries a reasoned ``# lint: ok(R8)`` — a def-line
suppression exempts the whole function (engine-resolved anchors).
"""
from __future__ import annotations

import ast

from . import flow
from .engine import PKG, Violation, dotted, rule, str_const

_SCOPE = (PKG,)
_EXCLUDE = (PKG + "lint/",)

#: taint sources: calls whose leaf name is a rank query, and reads of the
#: launcher's rank variables
_SOURCE_LEAFS = frozenset({"rank", "get_rank"})
_RANK_VARS = frozenset({"RANK", "LOCAL_RANK"})

#: launderers: their RESULT is uniform across ranks
_BLESSED = frozenset({"mh_uniform"}) | flow.COLLECTIVE_PRIMITIVES

#: effect-free builtins a tainted guard may call without divergence
_PURE = frozenset({"bool", "int", "float", "str", "repr", "format",
                   "abs", "len", "round", "min", "max", "isinstance",
                   "getattr", "hasattr", "type", "tuple", "list"})


def _is_source(node) -> bool:
    if isinstance(node, ast.Call):
        leaf = flow.leaf_name(node.func)
        if leaf in _SOURCE_LEAFS:
            return True
        # knobs.launcher("RANK"), os.environ.get("RANK"), os.getenv(...)
        return leaf in ("launcher", "get", "getenv") and bool(node.args) \
            and str_const(node.args[0]) in _RANK_VARS \
            and (leaf != "get" or dotted(node.func).endswith("environ.get"))
    return isinstance(node, ast.Subscript) \
        and dotted(node.value).endswith("environ") \
        and str_const(node.slice) in _RANK_VARS


def _stmt_exprs(stmt):
    """Expression roots evaluated AT this statement's nesting level
    (compound bodies are walked separately by walk_guarded)."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    return [stmt]


def _calls_in(root, skip):
    for n in ast.walk(root):
        if id(n) in skip:
            continue
        if isinstance(n, ast.Call):
            yield n


@rule("R8")
def check_r8(ctx) -> list:
    graph = flow.CallGraph(ctx, _SCOPE, _EXCLUDE)
    may_collect = graph.fixpoint(
        lambda fi: fi.call_leafs & flow.COLLECTIVE_PRIMITIVES)
    out = []
    for fi in graph.infos:
        tainted = flow.taint_names(fi.node, fi.nested_skip,
                                   _is_source, _BLESSED)
        if not tainted and not any(
                _is_source(n) for n in ast.walk(fi.node)
                if id(n) not in fi.nested_skip):
            continue

        def dirty(expr):
            return flow.expr_tainted(expr, tainted, _is_source,
                                     _BLESSED)

        flagged: set = set()
        div_exit_line: int | None = None
        collective_sites = []   # (line, leaf, node) in source order
        for stmt, guards in flow.walk_guarded(fi.node.body,
                                              fi.nested_skip):
            tainted_guards = [g for g in guards if dirty(g)]
            if isinstance(stmt, (ast.Return, ast.Raise, ast.Break,
                                 ast.Continue)) and tainted_guards:
                if div_exit_line is None \
                        or stmt.lineno < div_exit_line:
                    div_exit_line = stmt.lineno
            for root in _stmt_exprs(stmt):
                for call in _calls_in(root, fi.nested_skip):
                    leaf = flow.leaf_name(call.func)
                    if not leaf:
                        continue
                    eguards = flow.expr_guards(root, call)
                    all_tainted = tainted_guards \
                        + [g for g in eguards if dirty(g)]
                    collective = (
                        leaf in flow.COLLECTIVE_PRIMITIVES
                        or leaf in may_collect)
                    if collective:
                        collective_sites.append((call.lineno, leaf,
                                                 call))
                        if all_tainted:
                            flagged.add(id(call))
                            out.append(Violation(
                                "R8", fi.sf.rel, call.lineno,
                                fi.qualname,
                                f"divergent-collective:{leaf}",
                                f"collective {leaf}() is control-"
                                "dependent on rank-divergent state "
                                "(rank taint) — ranks disagreeing on "
                                "this branch wedge the pod; agree first "
                                "(multihost.agree / all_reduce) or "
                                "bless via mh_uniform()"))
                            continue
                        if leaf in flow.COLLECTIVE_PRIMITIVES:
                            # the agreement idiom: a rank-LOCAL value
                            # passed to the primitive is the payload
                            # being agreed.  Transitively-collective
                            # callees get no such pass — fall through
                            # to the tainted-arg check (the checkpoint
                            # write= shape).
                            continue
                    if leaf in _PURE or leaf in _BLESSED:
                        continue
                    if all_tainted:
                        flagged.add(id(call))
                        out.append(Violation(
                            "R8", fi.sf.rel, call.lineno, fi.qualname,
                            f"rank-gated-call:{leaf}",
                            f"call {leaf}() under a rank-divergent "
                            "guard — a per-rank side effect must ride "
                            "an agreed decision or an mh_uniform()-"
                            "blessed rank-scoped action"))
                        continue
                    if any(dirty(a) for a in call.args) or any(
                            dirty(kw.value) for kw in call.keywords):
                        out.append(Violation(
                            "R8", fi.sf.rel, call.lineno, fi.qualname,
                            f"rank-tainted-arg:{leaf}",
                            f"rank-divergent value passed into "
                            f"{leaf}() — divergence by data: wrap the "
                            "value in mh_uniform(value, why) citing "
                            "the agreement, or agree it via "
                            "multihost.agree first"))
        if div_exit_line is not None:
            for line, leaf, call in collective_sites:
                if line > div_exit_line and id(call) not in flagged:
                    out.append(Violation(
                        "R8", fi.sf.rel, line, fi.qualname,
                        f"collective-after-divergent-exit:{leaf}",
                        f"collective {leaf}() reachable after a rank-"
                        f"divergent early exit (line {div_exit_line})"
                        " — the exiting rank skips it and the rest "
                        "block forever"))
    return out
