"""R10 shape-ladder escapes: every measured int that becomes a device
tensor's shape must pass through the ladder (the port's copy of the JAX
package's ``lint/rules_shapes.py``).

In the JAX package a shape is a compile family per distinct value.  The
port compiles nothing per shape, but its shapes key the same decisions:
the bucketed capacities and comm-table widths are what make a run's
buffers, kernel grids and allocator blocks repeat from call to call, and
what the JAX package's byte-for-byte runs are held to.  The sinks are the
size arguments of ``torch.zeros/ones/full/empty`` and the widths of
``torch.nn.functional.pad``.  The rule resolves each size expression
backwards through the function's assignments (in source order —
flow-sensitive reaching definitions) and fails when a **measurement**
feeds the shape raw:

- ``len(...)``, and data-dependent reductions called as methods or
  via a module (``x.max()``, ``x.sum()``, ``counts.item()``,
  ``.tolist()``...)

unless the value passes through a **ladder producer** first:
``compilecache.bucket()``, ``comms.pad_comm_tables()``, or any function
whose returns are themselves ladder-derived (summarized to a fixed
point).

Trusted by construction (the check happens where the measurement is):

- parameters and attribute reads — a caller passing a raw measured
  size is flagged at ITS measurement site;
- ``.shape``/``.numel()``/``.size(0)`` of an existing tensor — a tensor
  built at a bucketed capacity carries its ladder;
- constants and arithmetic over trusted values (``capT * 6`` stays in
  the family of ``capT``).

Legitimately un-laddered shapes (one-shot ingest of a host mesh, the
cold boundary where the input defines the size) carry a reasoned
``# lint: ok(R10)`` or stand in the baseline.
"""
from __future__ import annotations

import ast

from . import flow
from .engine import PKG, Violation, dotted, rule

_SCOPE = (PKG,)
_EXCLUDE = (PKG + "lint/",)

#: base ladder producers; extended each run by the returns-ladder
#: summary fixpoint
_LADDER_BASE = frozenset({"bucket", "pad_comm_tables"})

#: constructors whose positional arguments are all sizes
#: (``torch.zeros(n, 3)``), and ``full``, whose first one is
_SIZED = ("zeros", "ones", "empty")
_FULL = "full"

#: reductions that measure data when called as an attribute
#: (``x.max()``, ``np.sum(...)``); builtins stay transparent
_MEASURE_ATTRS = frozenset({"max", "min", "sum", "prod", "item",
                            "count_nonzero", "argmax", "argmin",
                            "nonzero", "searchsorted", "tolist"})

#: transparent numeric wrappers — recurse into their arguments
_TRANSPARENT = frozenset({"int", "float", "bool", "abs", "round",
                          "max", "min", "sum", "divmod"})


def _size_args(call) -> list:
    """The size expressions of a device constructor or pad call, or []."""
    d = dotted(call.func)
    leaf = flow.leaf_name(call.func)
    kw = {k.arg: k.value for k in call.keywords}
    if d.startswith("torch.") and leaf in _SIZED:
        return list(call.args) or [kw[k] for k in ("size",) if k in kw]
    if d.startswith("torch.") and leaf == _FULL:
        return call.args[:1] or [kw[k] for k in ("size",) if k in kw]
    if leaf == "pad" and (d.endswith("functional.pad") or d == "F.pad"):
        return call.args[1:2] or [kw[k] for k in ("pad",) if k in kw]
    return []


def _ladder_names(graph) -> set:
    """Function names whose returns are ladder-derived: a return value
    containing a call to a known ladder producer, to a fixed point."""
    names = set(_LADDER_BASE)
    changed = True
    while changed:
        changed = False
        for fi in graph.infos:
            if fi.name in names:
                continue
            for n in ast.walk(fi.node):
                if id(n) in fi.nested_skip \
                        or not isinstance(n, ast.Return) \
                        or n.value is None:
                    continue
                if any(isinstance(c, ast.Call)
                       and flow.leaf_name(c.func) in names
                       for c in ast.walk(n.value)):
                    names.add(fi.name)
                    changed = True
                    break
    return names


def _first_raw(expr, env, ladder, seen=()):
    """Tag of the first raw measurement in a (resolved) shape
    expression, or None when every leaf is ladder/trusted."""
    if isinstance(expr, ast.Call):
        # a method of a call's result (``x.sum().item()``) has no dotted
        # name: its attribute is the leaf
        leaf = flow.leaf_name(expr.func) or getattr(expr.func, "attr", "")
        if leaf in ladder:
            return None          # laundered: the ladder bounds it
        if leaf == "len":
            return "len()"
        if isinstance(expr.func, ast.Attribute) \
                and leaf in _MEASURE_ATTRS:
            return f".{leaf}()"
        if isinstance(expr.func, ast.Name) and leaf in _TRANSPARENT:
            for a in expr.args:
                got = _first_raw(a, env, ladder, seen)
                if got:
                    return got
            return None
        # unknown callee: its own returns are checked at ITS sinks
        return None
    if isinstance(expr, ast.Name):
        if expr.id in seen:
            return None
        bound = env.get(expr.id)
        if bound is None:
            return None          # parameter / outer scope: trusted
        return _first_raw(bound, env, ladder, seen + (expr.id,))
    if isinstance(expr, ast.Attribute):
        return None              # .shape/.size/self.cap: inherits
    if isinstance(expr, (ast.Constant,)):
        return None
    for child in ast.iter_child_nodes(expr):
        got = _first_raw(child, env, ladder, seen)
        if got:
            return got
    return None


def _scan_function(fi, ladder, out):
    """Walk the direct body in source order, tracking simple Name
    bindings (reaching definitions), checking each constructor sink
    against the bindings live at that point."""
    env: dict[str, object] = {}

    def check_expr(root):
        for n in ast.walk(root):
            if id(n) in fi.nested_skip or not isinstance(n, ast.Call):
                continue
            leaf = flow.leaf_name(n.func)
            for size in _size_args(n):
                raw = _first_raw(size, env, ladder)
                if raw:
                    out.append(Violation(
                        "R10", fi.sf.rel, n.lineno, fi.qualname,
                        f"raw-shape:{leaf}:{raw}",
                        f"torch.{leaf}() shape fed by raw measurement "
                        f"{raw} — every distinct value is a new shape "
                        "family; route it through bucket()/"
                        "pad_comm_tables() (or suppress at a one-shot "
                        "ingest boundary with the reason)"))
                    break

    def walk(body):
        for stmt in body:
            if id(stmt) in fi.nested_skip or isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
                continue
            # sinks first: an assignment's RHS sees the env BEFORE it
            for root in _stmt_roots(stmt):
                check_expr(root)
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.expr):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        env[t.id] = stmt.value
            elif isinstance(stmt, ast.AnnAssign) \
                    and stmt.value is not None \
                    and isinstance(stmt.target, ast.Name):
                env[stmt.target.id] = stmt.value
            if isinstance(stmt, ast.If):
                walk(stmt.body)
                walk(stmt.orelse)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                walk(stmt.body)
                walk(stmt.orelse)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                walk(stmt.body)
            elif isinstance(stmt, ast.Try):
                walk(stmt.body)
                for h in stmt.handlers:
                    walk(h.body)
                walk(stmt.orelse)
                walk(stmt.finalbody)

    def _stmt_roots(stmt):
        if isinstance(stmt, (ast.If, ast.While)):
            return [stmt.test]
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return [stmt.iter]
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return [i.context_expr for i in stmt.items]
        if isinstance(stmt, ast.Try):
            return []
        return [stmt]

    walk(fi.node.body)


@rule("R10")
def check_r10(ctx) -> list:
    graph = flow.CallGraph(ctx, _SCOPE, _EXCLUDE)
    ladder = _ladder_names(graph)
    out: list = []
    for fi in graph.infos:
        _scan_function(fi, ladder, out)
    return out
