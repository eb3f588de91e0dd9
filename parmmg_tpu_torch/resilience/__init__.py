"""Fault injection and deadline watchdogs (port of the parts of
``resilience/`` the serving path uses).

- :mod:`~parmmg_tpu_torch.resilience.faults` — the named-faultpoint
  registry, armed by ``FAULTS.arm(spec)``; the serve pool's
  ``serve.slot_step`` and the daemon's ``serve.daemon_rpc`` sites;
- :mod:`~parmmg_tpu_torch.resilience.watchdog` — ``Deadline`` and
  ``run_with_deadline``, which bound the serve daemon's steps.

The retry ladder, checkpoints and resume, heartbeat leases and the
crash-loop breaker are not ported.
"""
from .faults import FAULTS, fault_trigger, faultpoint        # noqa: F401
from .watchdog import (Deadline, WatchdogTimeout,            # noqa: F401
                       run_with_deadline)
