"""Deadline watchdogs: make the wedge an exception (the port's copy of
``resilience/watchdog.py`` without its heartbeat leases and crash-loop
breaker, which serve the multi-host supervisor).

- :class:`Deadline` — a nestable, polled deadline for code that can
  check cooperatively (``dl.check()`` raises :class:`WatchdogTimeout` once
  any enclosing deadline of the calling thread expired; the
  earliest-armed expired deadline wins);
- :func:`run_with_deadline` — the monitor-thread form for code that
  cannot poll (a blocked device wait): the guarded call runs in a worker
  thread and the caller raises ``WatchdogTimeout`` when it overruns.  The
  abandoned worker rides on the exception so a caller that serializes on
  shared state (the serve daemon's driver lock) can wait it out;
- **first-use grace**: a site's first guarded call gets ``grace_s`` extra
  seconds (300 unless the caller says otherwise), so a cold first step (on
  the card: the first launch of every kernel and the allocator's first
  growth) is told apart from a wedged warm one.

Every expiry bumps ``resilience.watchdog_timeouts`` and emits a
``watchdog.timeout`` trace event.  Deadlines are off unless a caller
arms one (``seconds > 0``).
"""
from __future__ import annotations

import threading
import time

__all__ = [
    "GRACE_S", "Deadline", "WatchdogTimeout", "first_use_grace",
    "record_timeout", "run_with_deadline",
]

# a site's first guarded call waits this much longer (the JAX package's
# PARMMG_DEADLINE_GRACE_S default)
GRACE_S = 300.0


class WatchdogTimeout(RuntimeError):
    """A watchdog deadline expired at ``site`` after ``seconds``; a plain
    ``RuntimeError``, so retry paths treat it like any other failure."""

    def __init__(self, site: str, seconds: float):
        super().__init__(f"watchdog deadline expired at {site} after "
                         f"{seconds:g}s")
        self.site = site
        self.seconds = float(seconds)


def record_timeout(site: str, seconds: float) -> None:
    """Account one watchdog expiry (counter + trace event + log line)."""
    from ..obs import trace as otrace
    from ..obs.metrics import REGISTRY
    REGISTRY.counter("resilience.watchdog_timeouts").inc()
    otrace.event("watchdog.timeout", site=site, seconds=float(seconds))
    otrace.log(1, f"  ## resilience: watchdog deadline expired at "
                  f"{site} after {seconds:g}s", err=True)


# ---------------------------------------------------------------------------
# polled deadlines (cooperative form)
# ---------------------------------------------------------------------------
_LOCAL = threading.local()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class Deadline:
    """Nestable polled deadline for the calling thread.

    ``check()`` raises :class:`WatchdogTimeout` when any deadline on the
    thread's enter-ordered stack has expired — the outermost
    (earliest-armed) expired one wins, so a tight inner deadline can never
    mask an exhausted outer budget.  ``seconds <= 0`` disarms this level
    (it still nests)."""

    def __init__(self, seconds: float, site: str = "deadline"):
        self.seconds = float(seconds)
        self.site = site
        self._expires_at: float | None = None

    def __enter__(self) -> "Deadline":
        self._expires_at = (time.monotonic() + self.seconds
                            if self.seconds > 0 else None)
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        st = _stack()
        if self in st:
            st.remove(self)
        return False

    @property
    def expired(self) -> bool:
        return (self._expires_at is not None
                and time.monotonic() >= self._expires_at)

    def remaining(self) -> float | None:
        """Seconds left on this level (None when disarmed)."""
        if self._expires_at is None:
            return None
        return max(0.0, self._expires_at - time.monotonic())

    def check(self) -> None:
        """Raise for the first expired deadline enclosing this thread
        (enter order: the outer budget outranks the inner one)."""
        for d in _stack():
            if d.expired:
                record_timeout(d.site, d.seconds)
                raise WatchdogTimeout(d.site, d.seconds)


# ---------------------------------------------------------------------------
# monitor-thread deadlines (for calls that cannot poll)
# ---------------------------------------------------------------------------
# sites that completed at least one guarded call: their first-use grace is
# consumed (a failed first call consumes it too)
_FIRST_DONE: set[str] = set()
_FIRST_LOCK = threading.Lock()


def first_use_grace(site: str, grace_s: float = GRACE_S) -> float:
    """Extra seconds granted to ``site``'s first guarded call."""
    with _FIRST_LOCK:
        if site in _FIRST_DONE:
            return 0.0
    return max(0.0, float(grace_s))


def run_with_deadline(fn, seconds: float, site: str,
                      grace_s: float = GRACE_S):
    """Run ``fn()`` bounded by a wall-clock deadline.

    ``seconds <= 0`` calls inline (watchdog off, the default).  Otherwise
    ``fn`` runs in a daemon worker thread and the caller waits ``seconds +
    first_use_grace(site, grace_s)``; an overrun raises
    :class:`WatchdogTimeout` here while the worker is abandoned (its late
    result is discarded).  The abandoned thread rides on the exception as
    ``.thread``."""
    s = float(seconds)
    if s <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def _target():
        try:
            box["value"] = fn()
        except BaseException as e:            # noqa: BLE001 — relayed
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_target, daemon=True,
                         name=f"parmmg-watchdog-{site}")
    eff = s + first_use_grace(site, grace_s)
    t.start()
    if not done.wait(eff):
        record_timeout(site, eff)
        exc = WatchdogTimeout(site, eff)
        exc.thread = t
        raise exc
    with _FIRST_LOCK:
        _FIRST_DONE.add(site)
    if "error" in box:
        raise box["error"]
    return box.get("value")
