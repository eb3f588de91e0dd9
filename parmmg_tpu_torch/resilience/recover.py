"""Retry/backoff wrapper and the ordered escalation ladder (the port's
copy of ``resilience/recover.py``).

- :func:`retry_call` — bounded retries with exponential backoff and an
  optional wall-clock deadline, knobs ``PMTORCH_RETRY_MAX`` (default 2
  retries after the first failure), ``PMTORCH_RETRY_BASE_S`` (default 0.05
  s, doubled per attempt) and ``PMTORCH_RETRY_DEADLINE_S`` (0 = off).
  Exhaustion raises :class:`RetryBudgetExhausted` (the last failure
  chained as ``__cause__``), the signal the driver turns into a
  ``PMMG_LOWFAILURE`` conforming save;
- :data:`LADDER` + :func:`ladder_step` — the escalation order every
  degrade path reports through: each step taken emits a
  ``resilience.ladder`` trace event and bumps a ``resilience.<step>``
  counter.

Ladder order (least to most degraded; each step keeps the mesh
conforming):

    retry          re-run the failed unit (chunk dispatch / worker)
    mh_allgather   pod band-exchange collective failed (multi-device)
    halo_dense     packed halo exchange failed (multi-device)
    host_analysis  device analysis refresh failed (multi-device)
    merged_polish  grouped polish worker gone -> skip, the caller's
                   merged-mesh polish + repair tail covers quality
    lowfailure     restore the last conforming state, return
                   PMMG_LOWFAILURE (failed_handling,
                   libparmmg1.c:974-1011)

The multi-device rungs are named here so that one ladder reads the same in
both packages; nothing in the port takes them yet.  A retry re-runs work
in the same process: it recovers an injected fault or a wedge, not a
sticky CUDA error, which poisons the process's context (only the
subprocess polish worker, with a fresh context, survives one).
"""
from __future__ import annotations

import time

import torch

from ..api import knobs

__all__ = [
    "LADDER", "NEVER_RETRY", "RetryBudgetExhausted", "WorkerExitError",
    "ladder_step", "retry_call", "retry_env",
]

LADDER = ("retry", "mh_allgather", "halo_dense", "host_analysis",
          "merged_polish", "lowfailure")

# deterministic capacity signals are not retried: re-running the same
# program reproduces the same overflow (the card's out-of-memory error is
# the port's MemoryError)
NEVER_RETRY = (MemoryError, torch.cuda.OutOfMemoryError)


class RetryBudgetExhausted(RuntimeError):
    """All retries for ``site`` failed; ``__cause__`` is the last failure.
    Callers translate this into the next ladder step (``lowfailure`` at
    the driver)."""

    def __init__(self, site: str, attempts: int):
        super().__init__(
            f"retry budget exhausted at {site} after {attempts} "
            "attempt(s)")
        self.site = site
        self.attempts = attempts


class WorkerExitError(RuntimeError):
    """A subprocess worker exited non-zero."""

    def __init__(self, site: str, returncode: int, stderr: str = ""):
        tail = stderr[-2000:] if stderr else ""
        super().__init__(f"{site} worker exited rc={returncode}"
                         + (f"\n{tail}" if tail else ""))
        self.site = site
        self.returncode = returncode
        self.stderr = stderr


def retry_env() -> tuple[int, float, float]:
    """(max_retries, backoff base seconds, deadline seconds)."""
    mx = int(knobs.get("PMTORCH_RETRY_MAX") or 2)
    base = float(knobs.get("PMTORCH_RETRY_BASE_S") or 0.05)
    dl = float(knobs.get("PMTORCH_RETRY_DEADLINE_S") or 0)
    return max(0, mx), max(0.0, base), max(0.0, dl)


def ladder_step(step: str, site: str = "", detail: str = "") -> None:
    """Record one escalation-ladder step: trace event + counter + a
    verbosity-gated warning line."""
    from ..obs import trace as otrace
    from ..obs.metrics import REGISTRY
    if step not in LADDER:
        raise ValueError(f"unknown ladder step {step!r} "
                         f"(ladder: {LADDER})")
    REGISTRY.counter(f"resilience.{step}").inc()
    otrace.event("resilience.ladder", step=step, site=site,
                 detail=detail[:500])
    otrace.log(1, f"  ## resilience: {step}"
                  + (f" at {site}" if site else "")
                  + (f" ({detail[:200]})" if detail else ""), err=True)


def retry_call(fn, site: str, max_retries: int | None = None,
               base_s: float | None = None,
               deadline_s: float | None = None,
               initial_failure: BaseException | None = None):
    """Call ``fn()`` with up to ``max_retries`` re-attempts after a
    failure, exponential backoff between attempts, and an optional
    wall-clock deadline that stops retrying early.

    ``initial_failure``: the caller already made (and lost) attempt 0
    inline, so only the retry budget remains; with
    ``PMTORCH_RETRY_MAX=0`` that exhausts at once.  ``NEVER_RETRY``
    failures pass straight through."""
    env_mx, env_base, env_dl = retry_env()
    mx = env_mx if max_retries is None else max(0, int(max_retries))
    base = env_base if base_s is None else max(0.0, float(base_s))
    dl = env_dl if deadline_s is None else max(0.0, float(deadline_s))
    t0 = time.monotonic()
    last: BaseException | None = initial_failure
    attempts = 1 if initial_failure is not None else 0
    retries_left = mx
    while True:
        if last is not None:
            if isinstance(last, NEVER_RETRY):
                raise last
            if retries_left <= 0 or (dl and time.monotonic() - t0 >= dl):
                from ..obs.metrics import REGISTRY
                REGISTRY.counter("resilience.retry_exhausted").inc()
                raise RetryBudgetExhausted(site, attempts) from last
            # backoff then re-attempt (attempt k sleeps base * 2^(k-1))
            ladder_step("retry", site=site, detail=repr(last))
            if base > 0:
                time.sleep(min(base * (2 ** (attempts - 1)), 30.0))
            retries_left -= 1
        try:
            return fn()
        except NEVER_RETRY:
            raise
        except Exception as e:
            last = e
            attempts += 1
