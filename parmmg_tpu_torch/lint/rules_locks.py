"""R9 lock discipline: order cycles, dispatch under a held lock,
unguarded cross-thread fields (the port's copy of the JAX package's
``lint/rules_locks.py``).

The port's ``threading.Lock``/``RLock`` instances (the daemon's RLock, the
trace, metrics, faults and compilecache locks, ``groups._STREAM_LOCK``,
the watchdog's first-use lock, meshkit's load lock — plus any future
class- or module-level lock, detected automatically) are modeled as
abstract resources.  From with/acquire summaries the rule builds a
lock-order graph and fails on:

- **lock-order** — a cycle in the acquired-while-holding graph
  (self-edges allowed only on RLocks: re-entry is their contract;
  a plain Lock re-acquired on the same thread deadlocks);
- **lock-held-dispatch** — a call made while holding a lock whose
  transitive summary reaches a collective or a subprocess spawn (the
  serving-loop wedge shape: the daemon RLock held across
  ``service_once`` -> grouped pass -> polish worker).  Where the runtime
  watchdog ladder (the daemon's step deadline, PMTORCH_POLISH_TIMEOUT_S)
  makes the hold survivable by design, the site carries a reasoned
  suppression naming that watchdog;
- **unguarded-field** — a field of a two-thread class
  (``serve/daemon.PoolDaemon``: the HTTP handler side vs the serving
  loop) written outside the class lock in one thread domain and touched
  in the other.  GIL-atomic probe flags are the documented suppression
  pattern, with the atomicity argument in the reason.
"""
from __future__ import annotations

import ast

from . import flow
from .engine import PKG, Violation, dotted, rule

_SCOPE = (PKG,)
_EXCLUDE = (PKG + "lint/",)

#: friendly resource names for the five contract locks; any other
#: detected lock is named Class.attr (or the module-level var name)
_FRIENDLY = {"PoolDaemon": "daemon", "Tracer": "trace",
             "MetricsRegistry": "metrics", "FaultRegistry": "faults",
             "CompileLedger": "compilecache"}

#: two-thread classes: {class: (domain-A root methods, domain-B root
#: methods)} — A is the request/handler side, B the long-lived loop
_DOMAINS = {"PoolDaemon": (("handle_rpc", "_dispatch"), ("_loop",))}


def _lock_decls(ctx):
    """Detected lock resources:
    ``{(cls, attr): (resource, kind)}`` for ``self.attr = threading
    .Lock()`` in a class, ``{(rel, var): (resource, kind)}`` for
    module-level locks."""
    attrs: dict[tuple, tuple] = {}
    mods: dict[tuple, tuple] = {}

    def scan(body, cls, rel):
        for node in body:
            if isinstance(node, ast.ClassDef):
                scan(node.body, node.name, rel)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                scan(node.body, cls, rel)
            elif isinstance(node, (ast.If, ast.Try, ast.With,
                                   ast.For, ast.While)):
                scan(list(ast.iter_child_nodes(node)), cls, rel)
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                d = dotted(node.value.func)
                if d not in ("threading.Lock", "threading.RLock"):
                    continue
                kind = "RLock" if d.endswith("RLock") else "Lock"
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self" and cls:
                        res = _FRIENDLY.get(cls, f"{cls}.{t.attr}")
                        attrs[(cls, t.attr)] = (res, kind)
                    elif isinstance(t, ast.Name) and cls is None:
                        mods[(rel, t.id)] = (t.id, kind)

    for sf in ctx.iter(_SCOPE, _EXCLUDE):
        if sf.tree is not None:
            scan(sf.tree.body, None, sf.rel)
    return attrs, mods


def _resource_of(expr, fi, attrs, mods):
    """Lock resource acquired by a with-item / ``.acquire()`` target
    expression, or None."""
    if isinstance(expr, ast.Attribute) \
            and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self" and fi.cls:
        got = attrs.get((fi.cls, expr.attr))
        return got[0] if got else None
    if isinstance(expr, ast.Name):
        got = mods.get((fi.sf.rel, expr.id))
        return got[0] if got else None
    return None


def _held_regions(fi, attrs, mods):
    """(resource, with-node) for every lock-holding with-block in the
    function's direct body.  Bare ``.acquire()`` holds are not region-
    modeled; they still contribute order edges when they happen inside
    another lock's with-block."""
    for n in ast.walk(fi.node):
        if id(n) in fi.nested_skip:
            continue
        if isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                res = _resource_of(item.context_expr, fi, attrs, mods)
                if res is not None:
                    yield res, n


def _is_subprocess_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = dotted(node.func)
    leaf = flow.leaf_name(node.func)
    return leaf in flow.SUBPROCESS_LEAFS \
        or any(d.startswith(p) for p in flow.SUBPROCESS_PREFIXES)


@rule("R9")
def check_r9(ctx) -> list:
    graph = flow.CallGraph(ctx, _SCOPE, _EXCLUDE)
    attrs, mods = _lock_decls(ctx)
    kinds = {res: kind for res, kind in attrs.values()}
    kinds.update({res: kind for res, kind in mods.values()})

    def direct_acquires(fi):
        return {res for res, _n in _held_regions(fi, attrs, mods)}

    may_acquire = graph.fixpoint_sets(direct_acquires)
    may_collect = graph.fixpoint(
        lambda fi: fi.call_leafs & flow.COLLECTIVE_PRIMITIVES)
    may_sub = graph.fixpoint(
        lambda fi: any(_is_subprocess_call(n)
                       for n in ast.walk(fi.node)
                       if id(n) not in fi.nested_skip))

    out = []
    edges: dict[tuple, tuple] = {}   # (A, B) -> (sf, line, qualname)
    for fi in graph.infos:
        for res, wnode in _held_regions(fi, attrs, mods):
            inner_skip = set(fi.nested_skip)
            for n in ast.walk(wnode):
                if id(n) in inner_skip or n is wnode:
                    continue
                if isinstance(n, (ast.With, ast.AsyncWith)):
                    for item in n.items:
                        r2 = _resource_of(item.context_expr, fi,
                                          attrs, mods)
                        if r2 is not None:
                            edges.setdefault(
                                (res, r2),
                                (fi.sf, n.lineno, fi.qualname))
                elif isinstance(n, ast.Call):
                    leaf = flow.leaf_name(n.func)
                    if leaf == "acquire":
                        r2 = _resource_of(
                            getattr(n.func, "value", None), fi,
                            attrs, mods)
                        if r2 is not None:
                            edges.setdefault(
                                (res, r2),
                                (fi.sf, n.lineno, fi.qualname))
                        continue
                    if not leaf:
                        continue
                    for r2 in sorted(may_acquire.get(leaf, ())):
                        edges.setdefault(
                            (res, r2), (fi.sf, n.lineno, fi.qualname))
                    wedge = []
                    if leaf in may_collect \
                            or leaf in flow.COLLECTIVE_PRIMITIVES:
                        wedge.append("a collective")
                    if leaf in may_sub or _is_subprocess_call(n):
                        wedge.append("a subprocess spawn")
                    if wedge:
                        out.append(Violation(
                            "R9", fi.sf.rel, n.lineno, fi.qualname,
                            f"lock-held-dispatch:{res}:{leaf}",
                            f"{leaf}() may transitively reach "
                            f"{' and '.join(wedge)} while the "
                            f"{res} lock is held — a wedge there "
                            "holds the lock forever; release first, "
                            "or suppress naming the watchdog that "
                            "bounds the hold"))

    # ---- order cycles over the acquired-while-holding graph --------------
    adj: dict[str, set] = {}
    for (a, b), _site in edges.items():
        if a == b:
            if kinds.get(a) != "RLock":
                sf, line, qn = edges[(a, b)]
                out.append(Violation(
                    "R9", sf.rel, line, qn, f"lock-order:{a}->{b}",
                    f"non-reentrant Lock {a!r} re-acquired while "
                    "already held — self-deadlock (use RLock or "
                    "restructure)"))
            continue
        adj.setdefault(a, set()).add(b)

    state: dict[str, int] = {}

    def cyclic(v, stack):
        state[v] = 1
        for w in sorted(adj.get(v, ())):
            if state.get(w, 0) == 1:
                return stack[stack.index(w):] + [w] \
                    if w in stack else [v, w]
            if state.get(w, 0) == 0 and (c := cyclic(w, stack + [w])):
                return c
        state[v] = 2
        return None

    for v in sorted(adj):
        if state.get(v, 0) == 0:
            cyc = cyclic(v, [v])
            if cyc:
                for a, b in zip(cyc, cyc[1:]):
                    sf, line, qn = edges[(a, b)]
                    out.append(Violation(
                        "R9", sf.rel, line, qn,
                        f"lock-order:{a}->{b}",
                        f"lock-order cycle {' -> '.join(cyc)}: "
                        f"{b!r} acquired while holding {a!r} here, "
                        "and the reverse order exists elsewhere — "
                        "two threads interleaving these deadlock"))
                break

    # ---- cross-thread field discipline -----------------------------------
    for cls, (dom_a, dom_b) in _DOMAINS.items():
        members = [fi for fi in graph.infos if fi.cls == cls]
        names = {fi.name for fi in members}

        def domain(roots):
            seen = set(r for r in roots if r in names)
            work = list(seen)
            while work:
                m = work.pop()
                for fi in members:
                    if fi.name != m:
                        continue
                    # calls includes bare Name loads: the loop passes
                    # its step() closure into run_with_deadline
                    for cal in fi.calls & names:
                        if cal not in seen:
                            seen.add(cal)
                            work.append(cal)
            return seen

        da, db = domain(dom_a), domain(dom_b)
        lock_attrs = {attr for (c, attr) in attrs if c == cls}

        def field_uses(fi):
            """(attr, node, is_write, guarded) self-field accesses."""
            guarded_ids: set = set()
            for n in ast.walk(fi.node):
                if isinstance(n, (ast.With, ast.AsyncWith)) \
                        and any(isinstance(i.context_expr,
                                           ast.Attribute)
                                and isinstance(
                                    i.context_expr.value, ast.Name)
                                and i.context_expr.value.id == "self"
                                and i.context_expr.attr in lock_attrs
                                for i in n.items):
                    guarded_ids.update(id(x) for x in ast.walk(n))
            for n in ast.walk(fi.node):
                if id(n) in fi.nested_skip:
                    continue     # nested defs are their own members
                if isinstance(n, ast.Attribute) \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id == "self":
                    yield (n.attr, n,
                           isinstance(n.ctx, (ast.Store, ast.Del)),
                           id(n) in guarded_ids)

        touched_a: dict[str, bool] = {}
        touched_b: dict[str, bool] = {}
        writes = []   # (fi, attr, node, in_a)
        for fi in members:
            in_a, in_b = fi.name in da, fi.name in db
            if not (in_a or in_b):
                continue
            for attr, node, is_write, guarded in field_uses(fi):
                if attr in lock_attrs:
                    continue
                if in_a:
                    touched_a[attr] = True
                if in_b:
                    touched_b[attr] = True
                if is_write and not guarded:
                    writes.append((fi, attr, node, in_a))
        for fi, attr, node, in_a in writes:
            other = touched_b if in_a else touched_a
            if other.get(attr):
                out.append(Violation(
                    "R9", fi.sf.rel, node.lineno, fi.qualname,
                    f"unguarded-field:{attr}",
                    f"self.{attr} written outside the {cls} lock in "
                    f"the {'handler' if in_a else 'loop'} thread and "
                    "touched from the other thread — guard the write "
                    "or suppress with the atomicity argument"))
    return out
