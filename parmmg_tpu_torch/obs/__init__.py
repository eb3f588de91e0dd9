"""Telemetry (port of ``obs/``): the structured trace and the metrics
registry the serving path publishes into.

- :mod:`~parmmg_tpu_torch.obs.trace` — span/event/log emitter with a run
  context, a ring buffer and an optional JSONL sink;
- :mod:`~parmmg_tpu_torch.obs.metrics` — counter/gauge/histogram registry
  with Prometheus text exposition and a JSON snapshot.

Host-side bookkeeping only.  The JAX package's artifact schema and its
``jax.profiler`` capture window are not ported.
"""
from . import metrics, trace                               # noqa: F401
from .metrics import REGISTRY                              # noqa: F401
from .trace import TRACER, log, set_verbosity              # noqa: F401
