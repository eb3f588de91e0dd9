"""Flow-sensitive interprocedural analysis core (R8/R9/R10 substrate).

The port's copy of the JAX package's ``lint/flow.py``.  The name rules
(R2-R7) match call names; the rules this module powers prove *dataflow*
facts: "no collective is control-dependent on a rank-divergent value"
(R8), "no collective/subprocess call runs while a lock is held, and the
lock-order graph is acyclic" (R9), "every int that reaches a device
tensor's shape passed through the ``bucket()`` ladder" (R10).  Pure stdlib
``ast``; the moving parts are:

- :class:`CallGraph` — a function index over a file subset: every
  ``def`` (nested included) with its qualname, enclosing class chain,
  direct-body node set, and simple-name call edges (over-approximate: a
  missed edge is a silent wedge, an extra edge costs one reasoned
  suppression).
- per-function **summaries** via :meth:`CallGraph.fixpoint` — "may
  transitively call a collective / acquire lock X / spawn a
  subprocess" propagated over the call edges to a fixed point.
- a content-keyed **summary cache** (:func:`file_summary`) so the
  per-file local facts are computed once per file *content*.
- **taint** (:func:`taint_names` / :func:`expr_tainted`) — forward
  propagation of a source predicate through a function's assignments
  to a fixed point, with a blessing set (``mh_uniform`` and the
  collectives launder rank-taint: their *result* is uniform by
  construction).
- **control dependence** (:func:`walk_guarded`) — every direct-body
  statement with the stack of enclosing If/While/IfExp/BoolOp tests
  that decide whether it executes.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib

from .engine import SourceFile, dotted

#: collective primitives every rank must reach the same number of
#: times (the SPMD alignment contract R8 proves, and the "never while
#: holding a lock" resources R9 tracks).  Simple (leaf) callee names:
#: ``torch.distributed``'s collectives and the port's own collective
#: entry points (``multihost.py``'s agreement and exchange helpers, the
#: pod band exchange).
COLLECTIVE_PRIMITIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_object", "all_to_all",
    "all_to_all_single", "broadcast", "broadcast_object_list", "barrier",
    "gather_band", "pull_host", "all_gather_rows", "all_to_all_rows",
    "agree", "all_gather_json", "send_recv",
})

#: subprocess spawn primitives (R9's "never while holding the daemon
#: lock" second class; ``subprocess.run`` is matched by dotted prefix
#: so a bare ``run()`` method elsewhere never aliases it).
SUBPROCESS_LEAFS = frozenset({"Popen", "check_call", "check_output"})
SUBPROCESS_PREFIXES = ("subprocess.", "os.system", "os.popen",
                       "os.spawn")

#: leaf names too generic to carry summary facts across the name-based
#: edges: ``d.get(...)`` would alias any scoped ``def get`` and weld
#: the whole tree into one summary blob.  Excluded from the *property
#: fixpoints* only — R2/R7 reachability keeps every edge (there a
#: false edge costs a suppression, a dropped one hides a pull).
GENERIC_LEAFS = frozenset({
    "get", "set", "setdefault", "add", "append", "extend", "insert",
    "update", "pop", "popleft", "remove", "discard", "clear", "copy",
    "keys", "values", "items", "join", "split", "strip", "format",
    "encode", "decode", "open", "read", "write", "close", "flush",
    "seek", "run", "start", "stop", "wait", "acquire", "release",
    "send", "recv", "put", "sort", "sorted", "index", "count", "inc",
    "result", "mkdir", "exists", "touch", "main", "next", "replace",
})

#: module roots whose attribute calls never resolve back into this
#: repo: ``np.load(...)`` must not alias a scoped ``def load``.
#: torch / dist are deliberately NOT here — the collective primitives
#: are matched through exactly those dotted calls.
HOST_MODULE_ROOTS = frozenset({
    "np", "numpy", "os", "sys", "json", "base64", "pickle", "io",
    "pathlib", "time", "math", "re", "struct", "zlib", "gzip",
    "hashlib", "logging", "itertools", "functools", "collections",
    "socket", "shutil", "tempfile", "threading", "queue", "ast",
    "textwrap", "traceback", "warnings", "ctypes", "dataclasses",
})


def leaf_name(func) -> str:
    """Simple (rightmost) name of a call target; "" when dynamic."""
    d = dotted(func)
    return d.rsplit(".", 1)[-1] if d else ""


@dataclasses.dataclass
class FuncInfo:
    """One ``def`` in the analyzed subset."""
    sf: SourceFile
    qualname: str          # Class.method / outer.<locals-style> chain
    name: str              # simple name
    node: object           # ast.FunctionDef | ast.AsyncFunctionDef
    cls: str | None        # innermost enclosing class name
    def_lines: tuple       # def line + decorator lines (suppression
    #                        anchors, engine-resolved for every rule)
    nested_skip: frozenset  # id()s of nodes inside nested defs
    calls: frozenset       # simple callee names + bare Name loads
    call_leafs: frozenset  # simple callee names of actual Call nodes


def _index_file(sf: SourceFile) -> list:
    """Every function in one module as plain FuncInfo records — the
    cached per-file "local summary" the interprocedural passes stitch
    together (cache key: file content, see :func:`file_summary`)."""
    infos: list[FuncInfo] = []
    if sf.tree is None:
        return infos

    def visit(node, names, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = ".".join(names + [child.name])
                skip = set()
                for nf in ast.walk(child):
                    if isinstance(nf, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)) \
                            and nf is not child:
                        skip.update(id(x) for x in ast.walk(nf))
                calls, call_leafs = set(), set()
                for n in ast.walk(child):
                    if isinstance(n, ast.Call):
                        ln = leaf_name(n.func)
                        if ln:
                            # ``calls`` keeps every edge (R2/R7
                            # reachability, baseline-stable);
                            # ``call_leafs`` — the summary edges —
                            # drops host-module attribute calls so
                            # ``np.load`` never aliases a scoped
                            # ``def load``
                            calls.add(ln)
                            d = dotted(n.func)
                            if "." in d and d.split(".", 1)[0] \
                                    in HOST_MODULE_ROOTS:
                                continue
                            call_leafs.add(ln)
                    elif isinstance(n, ast.Name) \
                            and isinstance(n.ctx, ast.Load):
                        calls.add(n.id)
                infos.append(FuncInfo(
                    sf, qn, child.name, child, cls,
                    (child.lineno,) + tuple(
                        d.lineno for d in child.decorator_list),
                    frozenset(skip), frozenset(calls),
                    frozenset(call_leafs)))
                visit(child, names + [child.name], cls)
            elif isinstance(child, ast.ClassDef):
                visit(child, names + [child.name], child.name)
            else:
                visit(child, names, cls)

    visit(sf.tree, [], None)
    return infos


# ---------------------------------------------------------------------------
# content-keyed summary cache
# ---------------------------------------------------------------------------
_SUMMARY_CACHE: dict[tuple, object] = {}
_CACHE_CAP = 4096


def file_summary(sf: SourceFile, tag: str, compute):
    """``compute(sf)`` memoized on (tag, path, content-hash): a file
    edit changes the hash and recomputes exactly that file's entry;
    unrelated files keep their cached summaries."""
    key = (tag, sf.rel,
           hashlib.sha1(sf.text.encode("utf-8")).hexdigest())
    if key not in _SUMMARY_CACHE:
        if len(_SUMMARY_CACHE) >= _CACHE_CAP:
            _SUMMARY_CACHE.clear()
        _SUMMARY_CACHE[key] = compute(sf)
    return _SUMMARY_CACHE[key]


def summary_cache_clear() -> None:
    _SUMMARY_CACHE.clear()


class CallGraph:
    """Function index + name-edge call graph over a file subset."""

    def __init__(self, ctx, prefixes: tuple, exclude: tuple = ()):
        self.infos: list[FuncInfo] = []
        for sf in ctx.iter(prefixes, exclude):
            self.infos.extend(file_summary(sf, "callgraph", _index_file))
        self.by_name: dict[str, list[FuncInfo]] = {}
        for fi in self.infos:
            self.by_name.setdefault(fi.name, []).append(fi)

    def reachable(self, roots) -> list:
        """FuncInfos reachable from the named roots via simple-name
        edges (R2's worklist, shared)."""
        seen: dict[int, FuncInfo] = {}
        work = []
        for r in roots:
            for fi in self.by_name.get(r, ()):
                if id(fi.node) not in seen:
                    seen[id(fi.node)] = fi
                    work.append(fi)
        while work:
            fi = work.pop()
            for name in fi.calls:
                for cal in self.by_name.get(name, ()):
                    if id(cal.node) not in seen:
                        seen[id(cal.node)] = cal
                        work.append(cal)
        return list(seen.values())

    def fixpoint(self, seed) -> set:
        """Transitive may-property as a set of function *names*:
        ``seed(info)`` truthy marks a function; any function calling a
        marked name is marked, to a fixed point.  Name-level on
        purpose — same over-approximation as the edges themselves —
        but GENERIC_LEAFS neither carry the mark nor propagate it
        (``d.get(...)`` must not inherit some scoped ``get``'s
        summary)."""
        marked = {fi.name for fi in self.infos
                  if fi.name not in GENERIC_LEAFS and seed(fi)}
        changed = True
        while changed:
            changed = False
            for fi in self.infos:
                if fi.name in marked or fi.name in GENERIC_LEAFS:
                    continue
                if (fi.call_leafs - GENERIC_LEAFS) & marked:
                    marked.add(fi.name)
                    changed = True
        return marked

    def fixpoint_sets(self, seed) -> dict:
        """Like :meth:`fixpoint` but each function name maps to a SET
        it accumulates (e.g. lock resources it may acquire):
        ``seed(info)`` returns the direct set; callers' sets absorb
        their callees' to a fixed point (GENERIC_LEAFS edges dropped,
        as in :meth:`fixpoint`)."""
        acc: dict[str, set] = {}
        for fi in self.infos:
            if fi.name in GENERIC_LEAFS:
                continue
            acc.setdefault(fi.name, set()).update(seed(fi) or ())
        changed = True
        while changed:
            changed = False
            for fi in self.infos:
                mine = acc.get(fi.name)
                if mine is None:
                    continue
                before = len(mine)
                for cal in fi.call_leafs - GENERIC_LEAFS:
                    got = acc.get(cal)
                    if got:
                        mine |= got
                if len(mine) != before:
                    changed = True
        return acc


# ---------------------------------------------------------------------------
# control dependence
# ---------------------------------------------------------------------------
def walk_guarded(body, skip, guards=()):
    """Yield ``(stmt, guards)`` for every direct-body statement, where
    ``guards`` is the tuple of enclosing If/While test expressions that
    decide whether the statement runs.  Loop/try/with bodies pass
    through; nested defs (``skip``) are their own graph nodes."""
    for stmt in body:
        if id(stmt) in skip:
            continue
        yield stmt, guards
        if isinstance(stmt, ast.If):
            yield from walk_guarded(stmt.body, skip,
                                    guards + (stmt.test,))
            yield from walk_guarded(stmt.orelse, skip,
                                    guards + (stmt.test,))
        elif isinstance(stmt, ast.While):
            yield from walk_guarded(stmt.body, skip,
                                    guards + (stmt.test,))
            yield from walk_guarded(stmt.orelse, skip, guards)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            yield from walk_guarded(stmt.body, skip, guards)
            yield from walk_guarded(stmt.orelse, skip, guards)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            yield from walk_guarded(stmt.body, skip, guards)
        elif isinstance(stmt, ast.Try):
            for b in (stmt.body, stmt.orelse, stmt.finalbody):
                yield from walk_guarded(b, skip, guards)
            for h in stmt.handlers:
                yield from walk_guarded(h.body, skip, guards)


def expr_guards(root, target) -> tuple:
    """Expression-level tests deciding whether ``target`` (a node
    inside ``root``) evaluates: IfExp tests and the earlier operands of
    enclosing BoolOps (short-circuit guards)."""
    found = []

    def visit(node, guards):
        if node is target:
            found.append(guards)
            return
        if isinstance(node, ast.IfExp):
            visit(node.test, guards)
            visit(node.body, guards + (node.test,))
            visit(node.orelse, guards + (node.test,))
            return
        if isinstance(node, ast.BoolOp):
            for i, v in enumerate(node.values):
                visit(v, guards + tuple(node.values[:i]))
            return
        for child in ast.iter_child_nodes(node):
            visit(child, guards)

    visit(root, ())
    return found[0] if found else ()


# ---------------------------------------------------------------------------
# taint
# ---------------------------------------------------------------------------
def expr_tainted(expr, tainted: set, is_source, blessed=()) -> bool:
    """Does ``expr`` carry taint?  True when any sub-node satisfies
    ``is_source`` or reads a Name in ``tainted`` — except inside a
    call to a ``blessed`` laundering function (``mh_uniform``, the
    agreement collectives), whose *result* is uniform."""
    def visit(node) -> bool:
        if isinstance(node, ast.Call) and leaf_name(node.func) in blessed:
            return False
        if is_source(node):
            return True
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in tainted:
            return True
        return any(visit(c) for c in ast.iter_child_nodes(node))
    return visit(expr)


def taint_names(fn_node, skip, is_source, blessed=()) -> set:
    """Local variable names that (transitively, through direct-body
    assignments) carry a source value — forward fixpoint, flow-
    insensitive within the function (an over-approximation: a name once
    tainted stays tainted)."""
    tainted: set = set()

    def targets_of(stmt):
        if isinstance(stmt, ast.Assign):
            return stmt.targets
        if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            return [stmt.target]
        return []

    def name_leaves(t):
        if isinstance(t, ast.Name):
            yield t.id
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                yield from name_leaves(e)

    changed = True
    while changed:
        changed = False
        for n in ast.walk(fn_node):
            if id(n) in skip:
                continue
            value = None
            tgts = []
            if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = n.value
                tgts = targets_of(n)
            elif isinstance(n, ast.NamedExpr):
                value = n.value
                tgts = [n.target]
            elif isinstance(n, (ast.For, ast.AsyncFor)):
                value = n.iter
                tgts = [n.target]
            if value is None:
                continue
            if expr_tainted(value, tainted, is_source, blessed):
                for t in tgts:
                    for nm in name_leaves(t):
                        if nm not in tainted:
                            tainted.add(nm)
                            changed = True
    return tainted
