"""Named-faultpoint registry: provoke the real failure paths on demand
(the port's copy of ``resilience/faults.py``).

A spec in the JAX package's ``PARMMG_FAULT`` grammar arms the registry,
from the ``PMTORCH_FAULT`` knob at the first hit after it changes, or by a
call, ``FAULTS.arm(spec)``:

    site[:trigger][,site[:trigger]...]

``site`` is one of :data:`SITES`.  ``trigger`` is ``;``-separated rules
(all must pass for the site to fire):

- *(none)*      — fire on every hit;
- ``nth-N``     — fire on the Nth hit only (1-based; ``N`` alone works);
- ``every-K``   — fire on every Kth hit;
- ``p=0.x``     — fire with probability x per hit (``seed=N`` makes the
  sequence reproducible; default seed 0);
- ``key=S``     — fire only on hits whose ``key`` argument equals S
  (e.g. one serve tenant); non-matching hits do not advance the site's
  hit counter;
- ``hang=S``    — action: when the rule fires, the site sleeps S seconds
  and then returns instead of raising (the wedge that deadline watchdogs
  exist for, ``resilience/watchdog.py``).

:func:`faultpoint` raises the site's failure shape: ``OSError`` for IO
sites, ``RuntimeError`` for device dispatches (what a failed CUDA launch
raises in PyTorch; the JAX package raises XLA's runtime error there).
Flag sites use :func:`fault_trigger` and return a bool.  The polish
worker's failure is a non-zero subprocess exit: the parent decides the
firing (:func:`subprocess_fault_env`, so nth/every counting lives in one
process) and the worker exits 3 before importing torch when it finds
``PMTORCH_FAULT_FORCE`` naming it.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time

from ..api import knobs

__all__ = [
    "FAULTS", "FORCE_ENV", "FaultRegistry", "FaultRule", "SITES",
    "fault_trigger", "faultpoint", "parse_fault_spec",
    "subprocess_fault_env",
]

# the injectable sites and the exception shape each raises (xla = device
# dispatch failure, os = IO failure, flag = non-exception trigger consumed
# by the caller, exit = non-zero subprocess exit).  The JAX package's
# registry, site for site, so that one spec arms both packages alike.
SITES = {
    "polish.worker": "exit",
    "dispatch.chunk": "xla",
    "halo.exchange": "xla",
    "multihost.exchange": "xla",
    "analysis.ks_overflow": "flag",
    "serve.slot_step": "xla",
    "serve.daemon_rpc": "os",
    "io.checkpoint": "os",
}

FORCE_ENV = "PMTORCH_FAULT_FORCE"


@dataclasses.dataclass
class FaultRule:
    """One armed site's trigger: all set conditions must pass."""
    site: str
    nth: int | None = None       # fire on the Nth matching hit only
    every: int | None = None     # fire on every Kth matching hit
    p: float | None = None       # fire with probability p per hit
    seed: int = 0
    key: str | None = None       # fire only when the hit key matches
    hang: float | None = None    # action: sleep S then return, no raise

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._hits = 0

    def fires(self, key: str | None) -> bool:
        if self.key is not None and key != self.key:
            return False
        self._hits += 1
        # all set conditions must pass; the probability draw happens on
        # every matching hit so the seeded sequence is independent of the
        # other conditions
        ok = True
        if self.p is not None:
            ok = self._rng.random() < self.p
        if self.nth is not None:
            ok = ok and self._hits == self.nth
        if self.every is not None:
            ok = ok and self._hits % self.every == 0
        return ok


def parse_fault_spec(spec: str) -> dict:
    """Spec grammar -> {site: FaultRule}.  Raises ValueError on unknown
    sites or malformed triggers (a typo'd drill must fail loudly, not
    silently inject nothing)."""
    rules: dict[str, FaultRule] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        site, _, trig = part.partition(":")
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} (known: {sorted(SITES)})")
        kw: dict = {}
        for tok in filter(None, (t.strip() for t in trig.split(";"))):
            if tok.startswith("nth-"):
                kw["nth"] = int(tok[4:])
            elif tok.isdigit():
                kw["nth"] = int(tok)
            elif tok.startswith("every-"):
                kw["every"] = int(tok[6:])
            elif tok.startswith("p="):
                kw["p"] = float(tok[2:])
            elif tok.startswith("seed="):
                kw["seed"] = int(tok[5:])
            elif tok.startswith("key="):
                kw["key"] = tok[4:]
            elif tok.startswith("hang="):
                kw["hang"] = float(tok[5:])
            else:
                raise ValueError(
                    f"unparseable fault trigger {tok!r} in {part!r}")
        for f in ("nth", "every"):
            if kw.get(f) is not None and kw[f] < 1:
                raise ValueError(f"{f} must be >= 1 in {part!r}")
        if kw.get("hang") is not None and kw["hang"] <= 0:
            raise ValueError(f"hang must be > 0 seconds in {part!r}")
        rules[site] = FaultRule(site=site, **kw)
    return rules


class FaultRegistry:
    """The armed rules; hit counters live as long as one armed spec.

    ``PMTORCH_FAULT`` is read at every hit (one dict lookup) and re-armed
    when its value differs from the one seen last; an explicit
    :meth:`arm` holds until the variable changes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: dict[str, FaultRule] = {}
        self._env: str | None = None

    def arm(self, spec: str) -> None:
        """Parse ``spec`` and arm its rules (replacing any armed before,
        with fresh hit counters); an empty spec disarms."""
        rules = parse_fault_spec(spec) if spec else {}
        with self._lock:
            self._rules = rules
            self._env = knobs.get("PMTORCH_FAULT")

    def reset(self) -> None:
        """Disarm every site; the next hit reads ``PMTORCH_FAULT``
        again."""
        with self._lock:
            self._rules = {}
            self._env = None

    def _resolve(self) -> dict:
        raw = knobs.get("PMTORCH_FAULT")
        if raw != self._env:
            self._env = raw
            self._rules = parse_fault_spec(raw) if raw else {}
        return self._rules

    def armed(self) -> bool:
        with self._lock:
            return bool(self._resolve())

    def fired_rule(self, site: str,
                   key: str | None = None) -> FaultRule | None:
        """The armed rule for ``site`` when it fires on this hit, else
        None."""
        with self._lock:
            rule = self._resolve().get(site)
            if rule is None:
                return None
            if rule.fires(None if key is None else str(key)):
                return rule
            return None


FAULTS = FaultRegistry()


def _site_exception(site: str, key: str | None):
    msg = (f"INTERNAL: injected fault at {site}"
           + (f" (key={key})" if key is not None else "")
           + " [PARMMG_FAULT]")
    if SITES.get(site, "xla") == "os":
        return OSError(msg)
    return RuntimeError(msg)


def _record(site: str, key: str | None,
            hang: float | None = None) -> None:
    from ..obs import trace as otrace
    from ..obs.metrics import REGISTRY
    REGISTRY.counter("resilience.faults_injected").inc()
    otrace.event("fault.injected", site=site,
                 **({} if key is None else {"key": str(key)}),
                 **({} if hang is None else {"hang_s": float(hang)}))


def faultpoint(site: str, key: str | None = None) -> None:
    """Raise the site's exception when armed and firing (one dict lookup
    when nothing is armed).  A firing rule with ``hang=S`` sleeps S
    seconds and returns instead: the wedge, not the crash."""
    rule = FAULTS.fired_rule(site, key)
    if rule is None:
        return
    if rule.hang is not None:
        _record(site, key, hang=rule.hang)
        time.sleep(rule.hang)
        return
    _record(site, key)
    raise _site_exception(site, key)


def fault_trigger(site: str, key: str | None = None) -> bool:
    """Flag-style sites (the failure is a condition, not an exception):
    True when the armed fault fires, so the caller takes its degraded
    branch.  A ``hang=S`` rule sleeps and returns False."""
    rule = FAULTS.fired_rule(site, key)
    if rule is None:
        return False
    if rule.hang is not None:
        _record(site, key, hang=rule.hang)
        time.sleep(rule.hang)
        return False
    _record(site, key)
    return True


def subprocess_fault_env(site: str) -> dict:
    """Firing decision for a subprocess site, taken in the parent (so
    nth/every counting survives across worker invocations): the overlay
    to merge into the worker's environment.  The worker exits non-zero
    when ``PMTORCH_FAULT_FORCE`` names it, or sleeps before importing
    torch on the ``site:hang=S`` form (the wedged-worker drill: the
    parent's subprocess timeout is what must catch it)."""
    rule = FAULTS.fired_rule(site)
    if rule is None:
        return {}
    _record(site, None, hang=rule.hang)
    if rule.hang is not None:
        return {FORCE_ENV: f"{site}:hang={rule.hang:g}"}
    return {FORCE_ENV: site}
