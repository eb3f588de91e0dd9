"""Static invariant linter of the port (rules R2-R4, R6-R10).

The port's counterpart of the JAX package's ``lint/``: pure-stdlib ``ast``
checks of the contracts the port's runtime gates can only catch by
running — no host read on the hot paths (R2), no stray host gather on the
pod hot path (R7), obs routing (R3), the ``PMTORCH_*`` knob registry
(R4), static telemetry names (R6) — plus the flow-sensitive provers built
on ``flow``'s interprocedural core: SPMD collective alignment (R8), lock
discipline (R9) and shape-ladder hygiene (R10).

R1 (jit hygiene) and R5 (the jax version shim) have no subject here: the
port has no ``jit`` and imports no jax.

``python -m parmmg_tpu_torch.lint`` is the command line
(``-v``, ``--rules``, ``--changed-only``, ``--sarif``,
``--baseline-update``); ``baseline.json`` beside this file holds the
violations of the day the linter came, to burn down.  The scan covers
``parmmg_tpu_torch/``, ``tests/test_torch_*.py``, ``tests/torch_parity.py``
and ``chip_smoke.py``.  Importing this package imports neither ``torch``,
``jax`` nor ``parmmg_tpu``.
"""
from . import (rules_hostsync, rules_knobs, rules_locks,  # noqa: F401
               rules_obs, rules_shapes, rules_spmd)
from .engine import (BASELINE_REL, RULES, RULE_TITLES,  # noqa: F401
                     GateResult, LintReport, SourceFile, Violation,
                     baseline_payload, collect_files, format_report, gate,
                     load_baseline, run_lint)
