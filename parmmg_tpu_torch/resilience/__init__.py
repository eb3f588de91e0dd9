"""Fault injection and self-healing recovery (port of ``resilience/``).

The reference's graded-failure contract (``failed_handling``,
libparmmg1.c:974-1011) is that the library never dies holding user data:
it degrades to ``PMMG_LOWFAILURE`` and hands back a conforming mesh.

- :mod:`~parmmg_tpu_torch.resilience.faults` — the named-faultpoint
  registry, armed by ``PMTORCH_FAULT=site[:trigger]`` or
  ``FAULTS.arm(spec)``; each site raises its failure shape (a
  ``RuntimeError`` for a device dispatch, a non-zero subprocess exit for
  the polish worker, an ``OSError`` for checkpoint IO);
- :mod:`~parmmg_tpu_torch.resilience.recover` — the retry + backoff
  wrapper (``PMTORCH_RETRY_*``) and the escalation ladder the degrade
  paths report through, each step a trace event and a ``resilience.*``
  counter;
- :mod:`~parmmg_tpu_torch.resilience.checkpoint` — pass checkpoints and
  resume of the grouped loop (``PMTORCH_CKPT_DIR`` / ``_EVERY``) with the
  crash-loop breaker (``PMTORCH_RESUME_MAX``);
- :mod:`~parmmg_tpu_torch.resilience.watchdog` — ``Deadline`` and
  ``run_with_deadline`` (``PMTORCH_DEADLINE_*``): a wedged dispatch, serve
  step or worker becomes a ``WatchdogTimeout`` that enters the retry
  ladder like a fault.

A retry re-runs work in the same process: it recovers an injected fault
or a wedge, but a sticky CUDA error (an illegal address) poisons the
process's CUDA context, and every later launch in it fails; only the
subprocess polish worker, with a fresh context, survives one.  Nothing
here catches and hides a CUDA error: it rides the ladder to
``PMMG_LOWFAILURE`` or raises.
"""
from .faults import FAULTS, fault_trigger, faultpoint        # noqa: F401
from .recover import (LADDER, RetryBudgetExhausted,          # noqa: F401
                      ladder_step, retry_call)
from .watchdog import (Deadline, WatchdogTimeout,            # noqa: F401
                       run_with_deadline)
