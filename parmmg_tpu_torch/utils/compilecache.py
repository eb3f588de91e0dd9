"""Shape bucketing and the shape ledger (the port's copy of the JAX
package's ``utils/compilecache.py``).

- :func:`bucket` — the geometric 1.5x ladder the narrow-cycle row budget
  (``ops/active.narrow_rows``) rounds through, so the sub-mesh widths
  follow the JAX package's;
- the **ledger** (:data:`LEDGER`, :func:`governed`): the port compiles no
  XLA program, so a row counts what stands in for one.  For each
  governed entry point, under the JAX package's names (``adapt.cycle``,
  ``active.adapt_cycles_auto``, ``adapt.sliver_polish``,
  ``groups.polish_block``, ``ops.swapgen_wave``,
  ``repair.quality_probe``): ``calls``, and ``variants`` =
  ``shapes_seen``, the distinct static shapes it ran at (each tensor
  argument's shape and dtype, every flag's value; a Python int such as a
  wave number is dynamic, as the JAX package traces it).  These are the
  shapes a CUDA-graph capture of the entry point would capture once each.
  Its ``compiles`` and ``compile_s`` stay 0.  For each ``nvcc`` build of
  ``ops/cuda_build.py``, a row ``nvcc.<source>`` with ``compiles`` = the
  builds and ``compile_s`` their seconds.  ``build/`` is the port's
  persistent cache: a source compiles only when its library is stale.

The JAX package's ``jax.monitoring`` listener and its persistent-cache
wiring have no counterpart.  :func:`ledger_diff`,
:func:`extract_artifact_ledger` and :func:`regressions_vs_latest_artifact`
read the JAX package's artifacts and the port's alike.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading

__all__ = [
    "CompileLedger", "EntryStats", "LEDGER", "bucket",
    "extract_artifact_ledger", "format_ledger", "governed", "ledger_diff",
    "ledger_snapshot", "ledger_violations", "record_build",
    "regressions_vs_latest_artifact", "reset_ledger", "static_key",
    "track", "variants_by_prefix",
]


def bucket(n: int, floor: int = 256, cap: int | None = None,
           scheme: str = "geo") -> int:
    """Round ``n`` up a ladder from ``floor``: the geometric 1.5x ladder
    (``b -> 3b//2 + 1``, ``scheme="geo"``) or powers of two times
    ``floor`` (``scheme="pow2"``, the JAX package's default for index
    tables and compaction budgets).  ``cap`` clamps the result, which may
    then be smaller than ``n``."""
    n = max(int(n), 1)
    b = max(int(floor), 1)
    if scheme not in ("geo", "pow2"):
        raise ValueError(f"unknown bucket scheme {scheme!r}")
    while b < n:
        b = b * 2 if scheme == "pow2" else b * 3 // 2 + 1
    if cap is not None:
        b = min(b, int(cap))
    return b


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EntryStats:
    """Per-entry accounting (mutated under the ledger lock)."""
    budget: int | None = None      # max allowed variants (None = untracked)
    calls: int = 0
    compiles: int = 0              # nvcc builds (0 for an entry point)
    compile_secs: float = 0.0
    keys_seen: set = dataclasses.field(default_factory=set)
    last_key: tuple = ()

    @property
    def variants(self) -> int:
        """Distinct static-shape keys the entry ran at."""
        return len(self.keys_seen)


class CompileLedger:
    """Process-wide registry: entry point -> EntryStats."""

    def __init__(self):
        self._entries: dict[str, EntryStats] = {}
        self._lock = threading.Lock()

    def register(self, name: str, budget: int | None = None) -> None:
        with self._lock:
            e = self._entries.setdefault(name, EntryStats())
            if budget is not None:
                e.budget = budget

    def note_call(self, name: str, key: tuple) -> None:
        with self._lock:
            e = self._entries.setdefault(name, EntryStats())
            e.calls += 1
            e.keys_seen.add(key)
            e.last_key = key

    def note_build(self, name: str, seconds: float) -> None:
        with self._lock:
            e = self._entries.setdefault(name, EntryStats())
            e.compiles += 1
            e.compile_secs += float(seconds)

    def snapshot(self) -> dict:
        """{entry: {calls, variants, shapes_seen, compiles, compile_s,
        last_shapes, budget}}: JSON-serializable, the JAX package's
        row."""
        with self._lock:
            out = {}
            for name, e in sorted(self._entries.items()):
                out[name] = {
                    "calls": e.calls,
                    "variants": e.variants,
                    "shapes_seen": len(e.keys_seen),
                    "compiles": e.compiles,
                    "compile_s": round(e.compile_secs, 3),
                    "last_shapes": repr(e.last_key) if e.last_key else "",
                    "budget": e.budget,
                }
            return out

    def violations(self) -> list[str]:
        """Entries whose variant count exceeds their budget."""
        bad = []
        with self._lock:
            for name, e in sorted(self._entries.items()):
                if e.budget is not None and e.variants > e.budget:
                    bad.append(f"{name}: {e.variants} compiled variants "
                               f"> budget {e.budget}")
        return bad

    def format(self, min_compiles: int = 0) -> str:
        rows = [f"{'entry point':36s} {'calls':>6s} {'vars':>5s} "
                f"{'compiles':>8s} {'secs':>8s}"]
        for name, rec in self.snapshot().items():
            # hide rows that were only registered, never called or built
            if rec["calls"] == 0 and rec["compiles"] < max(min_compiles, 1):
                continue
            rows.append(f"{name:36s} {rec['calls']:6d} "
                        f"{rec['variants']:5d} {rec['compiles']:8d} "
                        f"{rec['compile_s']:8.2f}")
        return "\n".join(rows)

    def reset(self) -> None:
        with self._lock:
            for e in self._entries.values():
                e.calls = 0
                e.compiles = 0
                e.compile_secs = 0.0
                e.keys_seen.clear()
                e.last_key = ()


LEDGER = CompileLedger()


def _leaf_key(x):
    import torch
    if torch.is_tensor(x):
        return (tuple(x.shape), str(x.dtype))
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, bool) or x is None or isinstance(x, (float, str)):
        return x
    if isinstance(x, int):
        return "int"
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple(_leaf_key(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_leaf_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _leaf_key(v)) for k, v in sorted(x.items()))
    try:
        hash(x)
        return x
    except TypeError:
        return type(x).__name__


def static_key(args, kwargs) -> tuple:
    """Hashable static-shape key of a call (module docstring)."""
    return (_leaf_key(tuple(args)), _leaf_key(dict(kwargs)))


def track(name: str, fn, *args, **kwargs):
    """Call ``fn(*args, **kwargs)`` as governed entry ``name`` (the form
    for a call site whose callee is looked up at call time)."""
    LEDGER.note_call(name, static_key(args, kwargs))
    return fn(*args, **kwargs)


def governed(name: str, budget: int | None = None, key_fn=None):
    """Register an entry point with the ledger: every call records its
    static-shape key; ``budget`` declares the allowed number of variants
    (:func:`ledger_violations`); ``key_fn(*args, **kwargs)`` overrides the
    default key."""
    def deco(fn):
        LEDGER.register(name, budget)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            key = key_fn(*args, **kwargs) if key_fn is not None \
                else static_key(args, kwargs)
            LEDGER.note_call(name, key)
            return fn(*args, **kwargs)

        wrapper.__wrapped__ = fn
        return wrapper
    return deco


def record_build(source: str, seconds: float, tool: str = "nvcc") -> None:
    """One build of a native source: ``nvcc`` of ``csrc/<source>.cu``, or
    ``gxx`` of ``native/meshkit.cpp``."""
    LEDGER.note_build(f"{tool}.{source}", seconds)


def ledger_diff(old: dict, new: dict) -> list[str]:
    """Ledger regression check between two snapshots: entry points present
    in both whose variant count grew.  Accepts a flat snapshot ({entry:
    {variants, ...}}) or a nested per-worker one ({"pass0": {entry: ...},
    ...}), flattened with a "<worker>/" prefix.  Entries only in ``new``
    are not regressions."""
    def flatten(d: dict, prefix: str = "") -> dict:
        out = {}
        for k, v in (d or {}).items():
            if isinstance(v, dict) and "variants" not in v:
                out.update(flatten(v, prefix + str(k) + "/"))
            elif isinstance(v, dict):
                out[prefix + str(k)] = v
        return out

    fo, fn_ = flatten(old), flatten(new)
    bad = []
    for name in sorted(set(fo) & set(fn_)):
        vo = int(fo[name].get("variants", 0))
        vn = int(fn_[name].get("variants", 0))
        if vn > vo:
            bad.append(f"{name}: {vo} -> {vn} compiled variants")
    return bad


def extract_artifact_ledger(doc) -> dict:
    """The ledger dict of any artifact shape: a plain snapshot, bench JSON
    ({extra: {compile_ledger}}), or the round wrapper ({parsed: {extra:
    {compile_ledger}}})."""
    if not isinstance(doc, dict):
        return {}
    for path in (("parsed", "extra", "compile_ledger"),
                 ("extra", "compile_ledger"),
                 ("compile_ledger",)):
        d = doc
        for k in path:
            d = d.get(k) if isinstance(d, dict) else None
            if d is None:
                break
        if isinstance(d, dict):
            return d
    return doc


def regressions_vs_latest_artifact(root: str, pattern: str,
                                   ledger: dict) -> list[str]:
    """Diff ``ledger`` against the newest round artifact matching
    ``pattern`` (e.g. "BENCH_r*.json") under ``root``; artifacts without a
    ledger compare clean."""
    import glob
    import json
    import re

    def rnum(p: str) -> int:
        m = re.search(r"r(\d+)\.json$", p)
        return int(m.group(1)) if m else -1

    def has_rows(d: dict) -> bool:
        return any(isinstance(v, dict) and
                   ("variants" in v or has_rows(v)) for v in d.values())

    for path in sorted(glob.glob(os.path.join(root, pattern)),
                       key=rnum, reverse=True):
        try:
            with open(path) as f:
                doc = json.load(f)
        except Exception:
            continue
        prev = extract_artifact_ledger(doc)
        if prev and has_rows(prev):
            return ledger_diff(prev, ledger)
    return []


def ledger_snapshot() -> dict:
    return LEDGER.snapshot()


def variants_by_prefix(prefix: str) -> dict:
    """{entry: variant count} for ledger entries under a name prefix."""
    return {k: r["variants"] for k, r in LEDGER.snapshot().items()
            if k.startswith(prefix)}


def format_ledger(min_compiles: int = 0) -> str:
    return LEDGER.format(min_compiles)


def reset_ledger() -> None:
    LEDGER.reset()


def ledger_violations() -> list[str]:
    return LEDGER.violations()
