"""Hierarchical wall-clock timers (port of ``utils/timers.py``).

The reference tracks per-phase times in ``PMMG_ctim[TIMEMAX]`` slots with
verbosity-gated prints (parmmg.c:35,91; libparmmg1.c:636-948).  Here a
small nestable timer registry with the same reporting role: the grouped
pipeline (``parallel/groups._pipeline_chunks``) times its upload /
compute / download / writeback segments on one.

Every completed scope also emits a trace span (``obs/trace.py``)
carrying the instance's ``trace_id``, so ``obs.trace.replay_totals(records,
tim=timers.trace_id)`` reconstructs exactly this registry's totals, as in
the JAX package.  (Its compile ledger, which the JAX module re-exports
here, is not ported.)  A scope can also synchronise the card before it
stops the clock: ``tim(name, sync=device)`` with a CUDA device waits for
the work queued inside the scope, so a segment that ends in device work
counts that work and not only its launches.
"""
from __future__ import annotations

import itertools
import time
from contextlib import contextmanager

import torch

from ..obs.trace import emit_span


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timers:
    _IDS = itertools.count(1)

    def __init__(self):
        self.acc: dict[str, float] = {}
        self.count: dict[str, int] = {}
        self._stack: list[tuple[str, float]] = []
        # paths absorbed via add() OUTSIDE any active scope: externally
        # measured segments, rendered distinctly by report()
        self.external: set[str] = set()
        # stable id stamped on every emitted span (the replay filter)
        self.trace_id: int = next(Timers._IDS)

    @contextmanager
    def __call__(self, name: str, sync=None):
        """Time the scope under ``name`` (nested below the open scopes).
        ``sync``: a device whose queued work the scope waits for before
        it stops the clock (None, or a CPU device: no wait)."""
        path = "/".join([p for p, _ in self._stack] + [name])
        t0 = time.perf_counter()
        self._stack.append((name, t0))
        try:
            yield
        finally:
            try:
                _sync(sync)
            finally:
                self._stack.pop()
                dt = round(time.perf_counter() - t0, 9)
                self.acc[path] = self.acc.get(path, 0.0) + dt
                self.count[path] = self.count.get(path, 0) + 1
                emit_span(path, dt, tim=self.trace_id)

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        """Fold an externally measured duration into the registry at the
        current nesting path (the grouped pipeline's segments, measured
        on a local Timers, land in the driver's this way).  Called
        outside any open scope, the segment is tagged *external* and
        ``report()`` marks it ``[absorbed]``."""
        ext = not self._stack
        path = "/".join([p for p, _ in self._stack] + [name])
        if ext:
            self.external.add(path)
        seconds = round(float(seconds), 9)
        self.acc[path] = self.acc.get(path, 0.0) + seconds
        self.count[path] = self.count.get(path, 0) + int(count)
        emit_span(path, seconds, count=int(count), tim=self.trace_id,
                  ext=ext)

    def report(self, min_s: float = 0.0) -> str:
        lines = []
        for k in sorted(self.acc):
            if self.acc[k] < min_s:
                continue
            depth = k.count("/")
            mark = "  [absorbed]" if k in self.external else ""
            lines.append(f"{'  ' * depth}{k.split('/')[-1]:28s} "
                         f"{self.acc[k]:9.3f}s  x{self.count[k]}{mark}")
        return "\n".join(lines)
