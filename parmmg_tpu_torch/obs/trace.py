"""Structured trace emitter, run context and profiler window (the port's
copy of ``obs/trace.py``).

One record per completed span (not begin/end pairs): replay is a plain
per-name sum, and a crashed run loses at most the spans still open.
Records are dicts; the run context (:func:`set_context` for process-wide
keys like the run id and device, :func:`context` for scoped overlays like
pass/block/chunk/tenant) is folded into every record at emit time.

Sinks: an always-on ring buffer (``PMTORCH_TRACE_RING`` records, default
4096) and, when ``PMTORCH_TRACE`` names a path or
:meth:`Tracer.configure` does, a JSONL file appended line by line.
``utils.timers.Timers`` feeds spans directly: every ``with tim(...)``
scope is a trace span carrying the instance's ``trace_id``, so
:func:`replay_totals` reconstructs exactly one registry's totals from the
stream.

:func:`log` is the one verbosity-gated print path (the reference's
``imprim`` levels, ``PMTORCH_VERBOSE`` before a driver sets it): gated
output and an always-emitted trace record, so ``-v`` output and the
trace stream cannot drift.

Profiler window: ``PMTORCH_PROFILE_DIR`` arms a ``torch.profiler``
capture (CPU activities, and CUDA ones where a card is present) over the
outer-pass window ``PMTORCH_PROFILE_PASS=start[:stop]`` of the grouped
loop (:func:`profile_pass_begin` / :func:`profile_pass_end`), written as
one Chrome trace into that directory.  :func:`annotate` marks a host
range on the capture (``record_function``, only while one runs) and
:func:`scope` an NVTX range on the card.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext

from ..api import knobs

__all__ = [
    "TRACER", "Tracer", "annotate", "context", "current_context",
    "emit_span", "event", "log", "new_run", "profile_abort",
    "profile_guard", "profile_pass_begin", "profile_pass_end",
    "profiling_active", "replay_totals", "scope",
    "set_context", "set_verbosity", "span", "verbosity",
]


# ---------------------------------------------------------------------------
# run context
# ---------------------------------------------------------------------------
_BASE: dict = {}
_TLS = threading.local()


def set_context(**kv) -> None:
    """Merge process-wide context keys (run id, backend, tenant...).
    ``None`` deletes a key."""
    for k, v in kv.items():
        if v is None:
            _BASE.pop(k, None)
        else:
            _BASE[k] = v


def new_run(device=None) -> str:
    """Start a fresh run context: a new run id, and the ``backend`` tag
    from ``device`` (a torch device or its name: "cuda", "cpu"), where
    the JAX package reads its backend off an imported jax."""
    import uuid
    backend = None
    if device is not None:
        import torch
        backend = torch.device(device).type
    _BASE.clear()
    rid = uuid.uuid4().hex[:12]
    set_context(run=rid, backend=backend)
    return rid


@contextmanager
def context(**kv):
    """Thread-local scoped context overlay (pass/cycle/block/chunk/
    tenant...) folded into every record emitted inside the scope."""
    stk = getattr(_TLS, "stack", None)
    if stk is None:
        stk = _TLS.stack = []
    stk.append({k: v for k, v in kv.items() if v is not None})
    try:
        yield
    finally:
        stk.pop()


def current_context() -> dict:
    out = dict(_BASE)
    for d in getattr(_TLS, "stack", ()) or ():
        out.update(d)
    return out


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------
class Tracer:
    """Ring buffer + optional JSONL sink.  Thread-safe; the sink of
    ``PMTORCH_TRACE`` is resolved at the first emit, so importing this
    module never opens a file."""

    def __init__(self, ring: int | None = None, path: str | None = None):
        if ring is None:
            ring = int(knobs.get("PMTORCH_TRACE_RING") or 4096)
        self.ring: deque = deque(maxlen=max(1, ring))
        self._lock = threading.Lock()
        self._emitted = 0
        self._path = path
        self._fh = None
        self._env_checked = path is not None

    def _sink(self):
        if not self._env_checked:
            self._env_checked = True
            self._path = knobs.get("PMTORCH_TRACE") or None
        if self._path and self._fh is None:
            try:
                self._fh = open(self._path, "a", buffering=1)
            except OSError:
                self._path = None
        return self._fh

    def configure(self, path: str | None = None) -> None:
        """Re-point the JSONL sink (None = ring only); ``PMTORCH_TRACE`` is
        no longer consulted."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            self._path = path
            self._env_checked = True

    def reset(self) -> None:
        with self._lock:
            self.ring.clear()
            self._emitted = 0

    def emit(self, rec: dict) -> None:
        rec.setdefault("ts", round(time.time(), 6))
        for k, v in current_context().items():
            rec.setdefault(k, v)
        with self._lock:
            self._emitted += 1
            self.ring.append(rec)
            fh = self._sink()
            if fh is not None:
                try:
                    fh.write(json.dumps(rec) + "\n")
                except (OSError, TypeError, ValueError):
                    pass

    def summary(self, top: int = 8) -> dict:
        """Compact trace digest: emit/drop counts, sink, and the top span
        totals seen in the ring."""
        with self._lock:
            recs = list(self.ring)
            emitted = self._emitted
        tot: dict[str, float] = {}
        for r in recs:
            if r.get("kind") == "span":
                tot[r["name"]] = tot.get(r["name"], 0.0) \
                    + float(r.get("dur", 0.0))
        tops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return {"events": emitted, "ring": len(recs),
                "dropped": max(0, emitted - len(recs)),
                "sink": self._path or "",
                "top_spans_s": {k: round(v, 4) for k, v in tops}}


TRACER = Tracer()


def emit_span(name: str, dur: float, count: int = 1,
              tim: int | None = None, ext: bool = False) -> None:
    """One completed span.  ``tim``: emitting Timers instance id (the
    replay filter); ``ext``: segment absorbed from another component's
    measurement (Timers.add outside any scope)."""
    rec = {"kind": "span", "name": name, "dur": round(float(dur), 9),
           "count": int(count)}
    if tim is not None:
        rec["tim"] = tim
    if ext:
        rec["ext"] = True
    TRACER.emit(rec)


@contextmanager
def span(name: str, **fields):
    """Measure-and-emit convenience for code without a Timers."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        rec = {"kind": "span", "name": name,
               "dur": round(time.perf_counter() - t0, 9), "count": 1}
        rec.update(fields)
        TRACER.emit(rec)


def event(name: str, **fields) -> None:
    rec = {"kind": "event", "name": name}
    rec.update(fields)
    TRACER.emit(rec)


def replay_totals(source, tim: int | None = None
                  ) -> tuple[dict, dict]:
    """Reconstruct per-phase (total seconds, counts) from a trace — a
    JSONL path or an iterable of records.  ``tim`` filters to one Timers
    instance, so the result compares with that instance's
    ``acc``/``count``.  Unparseable lines are skipped (a crashed writer
    may truncate the last one)."""
    if isinstance(source, (str, os.PathLike)):
        recs = []
        with open(source) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    recs.append(json.loads(line))
                except ValueError:
                    continue
    else:
        recs = list(source)
    tot: dict[str, float] = {}
    cnt: dict[str, int] = {}
    for r in recs:
        if r.get("kind") != "span":
            continue
        if tim is not None and r.get("tim") != tim:
            continue
        n = r["name"]
        tot[n] = tot.get(n, 0.0) + float(r.get("dur", 0.0))
        cnt[n] = cnt.get(n, 0) + int(r.get("count", 1))
    return tot, cnt


# ---------------------------------------------------------------------------
# verbosity-gated logging (imprim analogue)
# ---------------------------------------------------------------------------
_VERBOSITY = [int(knobs.get("PMTORCH_VERBOSE") or 1)]


def set_verbosity(v: int) -> None:
    """Set the process verbosity (the reference's ``imprim``)."""
    _VERBOSITY[0] = int(v)


def verbosity() -> int:
    return _VERBOSITY[0]


def log(level: int, msg: str, verbose: int | None = None,
        err: bool = False) -> bool:
    """Verbosity-gated print + unconditional trace record.

    ``level``: the imprim threshold.  ``verbose``: optional local
    verbosity on the same scale, which overrides the process value.  The
    record is emitted whether or not the line printed (``shown`` flags
    it).  Returns whether the line printed."""
    gate = _VERBOSITY[0] if verbose is None else int(verbose)
    shown = gate >= level
    TRACER.emit({"kind": "log", "lvl": int(level), "msg": str(msg),
                 "shown": bool(shown)})
    if shown:
        import sys
        print(msg, file=sys.stderr if err else sys.stdout)
    return shown


# ---------------------------------------------------------------------------
# torch.profiler capture window + timeline annotations
# ---------------------------------------------------------------------------
_PROFILE = {"active": False, "dir": "", "window": (0, 0), "prof": None}


def _profile_conf():
    d = knobs.get("PMTORCH_PROFILE_DIR")
    if not d:
        return None
    w = knobs.get("PMTORCH_PROFILE_PASS")
    if ":" in w:
        a, b = w.split(":", 1)
        win = (int(a or 0), int(b or a or 0))
    else:
        win = (int(w or 0), int(w or 0))
    return d, win


def profile_pass_begin(it: int) -> bool:
    """Start a ``torch.profiler`` capture when outer pass ``it`` enters
    the requested window (``PMTORCH_PROFILE_DIR`` +
    ``PMTORCH_PROFILE_PASS``).  No-op (False) when unarmed, already
    capturing, or out of window."""
    conf = _profile_conf()
    if conf is None or _PROFILE["active"]:
        return False
    d, (a, b) = conf
    if not (a <= it <= b):
        return False
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(d, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
    except Exception as e:
        log(0, f"obs: profiler capture failed to arm ({e!r})", err=True)
        return False
    _PROFILE.update(active=True, dir=d, window=(a, b), prof=prof)
    event("profile_start", dir=d)
    return True


def _profile_stop():
    prof = _PROFILE["prof"]
    _PROFILE.update(active=False, prof=None)
    try:
        prof.stop()
    except Exception:
        pass
    return prof


def profile_pass_end(it: int) -> bool:
    """Stop the capture once the window's last pass completed and write
    it as a Chrome trace, ``trace.<run>.pass<a>-<b>.json`` in the
    directory (the path lands in the ``profile_stop`` event)."""
    if not _PROFILE["active"]:
        return False
    a, b = _PROFILE["window"]
    if it < b:
        return False
    prof = _profile_stop()
    run = current_context().get("run") or f"pid{os.getpid()}"
    path = os.path.join(_PROFILE["dir"], f"trace.{run}.pass{a}-{b}.json")
    try:
        prof.export_chrome_trace(path)
    except Exception as e:
        log(0, f"obs: profiler trace export failed ({e!r})", err=True)
        path = ""
    event("profile_stop", dir=_PROFILE["dir"], path=path)
    # stderr: stdout carries the driver's own output
    log(1, f"obs: profiler trace written to {path}", err=True)
    return True


def profile_abort() -> bool:
    """Stop an active capture without writing it: the exception-unwind
    path of the pass loop (a capture left open would make every later
    :func:`profile_pass_begin` refuse to arm)."""
    if not _PROFILE["active"]:
        return False
    _profile_stop()
    event("profile_abort", dir=_PROFILE["dir"])
    return True


def profiling_active() -> bool:
    return _PROFILE["active"]


def profile_guard(clear_pass: bool = False):
    """Decorator for outer pass loops that arm capture windows: an
    exception unwinding the loop must not leave a capture open; only a
    capture the wrapped call itself armed is aborted.  ``clear_pass`` also
    drops a process-global ``pass`` context key the loop set."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            profiling_before = profiling_active()
            try:
                return fn(*args, **kwargs)
            finally:
                if clear_pass:
                    set_context(**{"pass": None})
                if not profiling_before:
                    profile_abort()
        return wrapper
    return deco


def annotate(name: str):
    """A named host range on the capture (``torch.profiler.
    record_function``), active only while a capture runs; a free
    nullcontext otherwise (the chunk loop wraps every dispatch in it)."""
    if not _PROFILE["active"]:
        return nullcontext()
    import torch
    return torch.profiler.record_function(name)


def scope(name: str):
    """An NVTX range on the card's timeline (``torch.cuda.nvtx.range``),
    seen by any CUDA profiler; a nullcontext without a card."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return nullcontext()
    return torch.cuda.nvtx.range(name)
