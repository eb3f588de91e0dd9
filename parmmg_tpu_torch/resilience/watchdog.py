"""Deadline watchdogs: make the wedge an exception (the port's copy of
``resilience/watchdog.py``; its heartbeat leases serve the multi-host
supervisor, which the port does not have yet).

- :class:`Deadline` — a nestable, polled deadline for code that can
  check cooperatively (``dl.check()`` raises :class:`WatchdogTimeout` once
  any enclosing deadline of the calling thread expired; the
  earliest-armed expired deadline wins);
- :func:`run_with_deadline` — the monitor-thread form for code that
  cannot poll (a blocked device wait): the guarded call runs in a worker
  thread and the caller raises ``WatchdogTimeout`` when it overruns.  The
  abandoned worker rides on the exception so a caller that serializes on
  shared state (the serve daemon's driver lock) can wait it out.  A
  guarded call that reports its progress (``beats=True`` and
  :func:`progress`, once per cycle on the grouped path) re-arms the
  deadline each time: in the port a chunk's cycles are launched from the
  host one op at a time, so a dispatch lasts as long as its work, and what
  the deadline bounds is the time between two steps of progress.  Such a
  call, once abandoned, stops at its next report;
- **first-use grace**: a site's first guarded call gets
  ``PMTORCH_DEADLINE_GRACE_S`` extra seconds (300 unless set), so a cold
  first step (on the card: the first launch of every kernel and the
  allocator's first growth) is told apart from a wedged warm one.

Every expiry bumps ``resilience.watchdog_timeouts`` and emits a
``watchdog.timeout`` trace event.  Deadlines are off unless armed: a
``PMTORCH_DEADLINE_*`` knob unset or 0, ``seconds <= 0``, means off.
"""
from __future__ import annotations

import threading
import time

from ..api import knobs

# the first-use grace when PMTORCH_DEADLINE_GRACE_S is unset (the serve
# daemon's step_grace_s default)
GRACE_S = 300.0

__all__ = [
    "Abandoned", "GRACE_S", "Deadline", "WatchdogTimeout", "deadline_knob",
    "first_use_grace", "progress", "record_timeout", "run_with_deadline",
]


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


def deadline_knob(name: str) -> float:
    """A ``PMTORCH_DEADLINE_*`` / timeout knob in seconds; unset, empty,
    unparseable or 0 means the watchdog is off."""
    try:
        return max(0.0, float(knobs.get(name) or 0))
    except ValueError:
        return 0.0


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


def first_use_grace(site: str, grace_s: float | None = None) -> float:
    """Extra seconds granted to ``site``'s first guarded call
    (``grace_s``, or ``PMTORCH_DEADLINE_GRACE_S``)."""
    with _FIRST_LOCK:
        if site in _FIRST_DONE:
            return 0.0
    if grace_s is None:
        try:
            grace_s = float(knobs.get("PMTORCH_DEADLINE_GRACE_S")
                            or GRACE_S)
        except ValueError:
            grace_s = GRACE_S
    return max(0.0, float(grace_s))


# the progress box of the guarded call (beats=True) running on this
# thread, if any
_GUARD = threading.local()


class Abandoned(RuntimeError):
    """Raised by :func:`progress` inside a guarded call whose deadline
    expired: the caller has moved on, and the call stops at its next
    progress report instead of competing with the retry."""


def progress() -> None:
    """Report a step of progress of the guarded call running on this
    thread (``run_with_deadline(beats=True)``): its deadline starts again
    from now.  Raises :class:`Abandoned` when the deadline already
    expired.  Free outside such a call."""
    box = getattr(_GUARD, "box", None)
    if box is not None:
        if box.get("abandoned"):
            raise Abandoned(f"abandoned at {box['site']}")
        box["beat"] = time.monotonic()


def run_with_deadline(fn, seconds: float, site: str,
                      grace_s: float | None = None, beats: bool = False):
    """Run ``fn()`` bounded by a wall-clock deadline.

    ``seconds <= 0`` calls inline (watchdog off, the default).  Otherwise
    ``fn`` runs in a daemon worker thread and the caller waits ``seconds +
    first_use_grace(site, grace_s)``; an overrun raises
    :class:`WatchdogTimeout` here while the worker is abandoned (its late
    result is discarded).  The abandoned thread rides on the exception as
    ``.thread``.  ``beats``: ``fn`` reports :func:`progress`, each report
    restarts the wait, and once abandoned the call stops at its next
    report."""
    s = float(seconds)
    if s <= 0:
        return fn()
    box: dict = {"beat": time.monotonic(), "site": site}
    done = threading.Event()

    def _target():
        if beats:
            _GUARD.box = box
        try:
            box["value"] = fn()
        except BaseException as e:            # noqa: BLE001 — relayed
            box["error"] = e
        finally:
            _GUARD.box = None
            done.set()

    t = threading.Thread(target=_target, daemon=True,
                         name=f"parmmg-watchdog-{site}")
    eff = s + first_use_grace(site, grace_s)
    t.start()
    while not done.wait(max(0.0, box["beat"] + eff - time.monotonic())):
        if time.monotonic() >= box["beat"] + eff:
            box["abandoned"] = True
            record_timeout(site, eff)
            exc = WatchdogTimeout(site, eff)
            exc.thread = t
            raise exc
    with _FIRST_LOCK:
        _FIRST_DONE.add(site)
    if "error" in box:
        raise box["error"]
    return box.get("value")
