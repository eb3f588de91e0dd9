"""R2 host-sync and R7 hot allgather: the "no host read on the hot path"
contracts, statically, on the port's idiom.

R2 — a call-graph reachability pass over ``parallel/`` and ``ops/``: from
the hot-path roots (the grouped pass and its chunk pipeline, the device
analysis refresh and its program body, the per-pass distributed cycle
loop) follow simple-name call edges between functions defined there and
flag every host-synchronising primitive in a reachable function:

- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``;
- ``torch.cuda.synchronize`` and ``.synchronize()``;
- ``torch.nonzero`` / ``.nonzero()``, whose output size waits for the
  device (``ops.primitives.nonzero_pad`` too: it pads after the read);
- ``int(x)`` / ``float(x)`` / ``bool(x)`` where ``x`` is a subscript or a
  call result (the scalar read idiom ``int(counts[g])``), except of the
  host-only producers in ``_HOST_FUNCS``.

The JAX package scans ``parallel/`` only: its ``ops/`` run traced, where a
host read cannot hide.  The port's ``ops/`` run eagerly, so they are in
scope.  Operations whose output shape depends on the data (boolean
indexing, ``torch.unique``) and a tensor's truth in an ``if`` also wait
for the device and are not matched.  A finding is a call SITE: a helper
such as ``nonzero_pad`` is one site and many reads a cycle, which the sync
debug mode of ``chip_smoke.py`` counts at run time.

The graph is name-based and over-approximate on purpose: a false
positive costs one reasoned suppression or a baseline entry; a false
negative is a silent host read multiplying under the chip runs.  A
suppression on the ``def`` line exempts a whole documented fallback
function (the KS-overflow ladder) with its reason attached.

R7 — the same reachability from R2's roots plus the band migration
pipeline and the several-pass distributed driver, flagging the host
gathers that replicate state across ranks: ``pull_host``,
``all_gather_object`` and ``all_gather_json``.  It is the static twin of
``multihost.pull_host``'s ``mh.hot_allgather_bytes`` counter (0 on the
card); band tables ride ``pod.gather_band``.
"""
from __future__ import annotations

import ast

from . import flow
from .engine import Violation, dotted, rule

#: reachability roots — the grouped and distributed hot paths
#: (``shard_analysis_body`` is the program of the device refresh, where
#: the JAX package has ``dist_analysis_grouped``)
ROOTS = (
    "grouped_adapt_pass",
    "_pipeline_chunks",
    "refresh_shard_analysis_device",
    "shard_analysis_body",
    "run_adapt_cycles",
)

_SYNC_CALLS = {"torch.cuda.synchronize": "torch.cuda.synchronize",
               "cuda.synchronize": "torch.cuda.synchronize",
               "torch.nonzero": "torch.nonzero"}
_SYNC_METHODS = {"item": ".item()", "tolist": ".tolist()",
                 "cpu": ".cpu()", "numpy": ".numpy()",
                 "synchronize": ".synchronize()",
                 "nonzero": ".nonzero()"}
_CAST_FNS = ("float", "int", "bool")

_SCOPE = ("parmmg_tpu_torch/parallel/", "parmmg_tpu_torch/ops/")

# float()/int()/bool() args that can never be a device read: environment
# reads (the port's through knobs.get) and other host producers
_HOST_FUNCS = ("environ.get", "os.getenv", "getenv", "knobs.get", "len",
               "round", "time.perf_counter", "time.time")


def _host_only_arg(arg) -> bool:
    if isinstance(arg, ast.Call):
        d = dotted(arg.func)
        return any(d == h or d.endswith("." + h) for h in _HOST_FUNCS)
    return False


def _to_cpu(call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    args = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


def _sync_tag(n) -> str | None:
    d = dotted(n.func)
    if d in _SYNC_CALLS:
        return _SYNC_CALLS[d]
    if isinstance(n.func, ast.Attribute) and n.func.attr in _SYNC_METHODS:
        return _SYNC_METHODS[n.func.attr]
    if _to_cpu(n):
        return '.to("cpu")'
    if isinstance(n.func, ast.Name) and n.func.id in _CAST_FNS \
            and len(n.args) == 1 \
            and isinstance(n.args[0], (ast.Subscript, ast.Call)) \
            and not _host_only_arg(n.args[0]):
        return f"{n.func.id}()"
    return None


#: R7 reachability roots — R2's plus the band-migration pipeline and the
#: several-pass distributed driver (the pod hot path, parallel/pod.py):
#: the functions whose steady state must never replicate state through a
#: host gather
R7_ROOTS = ROOTS + (
    "distributed_adapt_multi",
    "band_migrate_iteration",
    "band_weld",
    "repair_flood_labels",
    "graph_repartition_labels_band",
)

#: the host-gather primitives R7 flags (callee simple names)
_R7_CALLS = ("pull_host", "all_gather_object", "all_gather_json")


@rule("R7")
def check_r7(ctx) -> list:
    """The runtime tripwire's static mirror: ``pull_host`` counts
    ``mh.hot_allgather_bytes`` when reached inside a ``hot_path``
    section; this rule flags the CALL SITES so a stray host gather on the
    pod hot path fails in seconds at lint time.  Legitimate escape hatches
    (budget-overflow fallbacks, checkpoint IO under ``cold_io``, the
    final-output gather) carry reasoned suppressions."""
    graph = flow.CallGraph(ctx, _SCOPE)
    out = []
    for fi in graph.reachable(R7_ROOTS):
        for n in ast.walk(fi.node):
            if id(n) in fi.nested_skip or not isinstance(n, ast.Call):
                continue
            leaf = flow.leaf_name(n.func)
            if leaf not in _R7_CALLS:
                continue
            out.append(Violation(
                "R7", fi.sf.rel, n.lineno, fi.qualname, leaf,
                f"host gather {leaf}() reachable from the pod hot path "
                f"(roots: {', '.join(R7_ROOTS)}) — band tables ride "
                "pod.gather_band",
                anchor_lines=fi.def_lines))
    return out


@rule("R2")
def check_r2(ctx) -> list:
    graph = flow.CallGraph(ctx, _SCOPE)
    out = []
    for fi in graph.reachable(ROOTS):
        # direct body only (nested defs are separate graph nodes); the
        # def/decorator lines anchor whole-function fallback suppressions
        for n in ast.walk(fi.node):
            if id(n) in fi.nested_skip or not isinstance(n, ast.Call):
                continue
            tag = _sync_tag(n)
            if tag is None:
                continue
            out.append(Violation(
                "R2", fi.sf.rel, n.lineno, fi.qualname, tag,
                f"host-sync {tag} reachable from the grouped/dist hot "
                f"path (roots: {', '.join(ROOTS)})",
                anchor_lines=fi.def_lines))
    return out
