"""The band exchange of a distributed run (port of ``parallel/pod.py``'s
``gather_band``).

In the JAX package every hot-path host stage of a distributed pass
routes its band-sized device tables through ``gather_band``, one
compiled ``all_gather`` a table family across processes.  The port runs
one process with every logical shard stacked on one device, so the
exchange is a copy of the tables off the device, their bytes counted on
``mh.band_exchange_bytes``.  The retry ladder, deadline and heartbeat
of a cross-process exchange, and the group handoff between devices
(``maybe_handoff`` / ``plan_handoff``, which need more than one device:
``plan_handoff`` returns None at one device and ``maybe_handoff`` its
input without a ``PodContext``), come with the slices that place shards
on several cards.
"""
from __future__ import annotations

from ..obs.metrics import REGISTRY


def gather_band(*arrays, what: str = ""):
    """Band-sized device tables as host numpy arrays (a single array for
    a single input), their bytes counted on ``mh.band_exchange_bytes``
    and, with ``what``, on ``mh.band_exchange_bytes.<what>``."""
    host = tuple(x.cpu().numpy() for x in arrays)
    nbytes = float(sum(h.nbytes for h in host))
    REGISTRY.counter("mh.band_exchange_bytes").inc(nbytes)
    if what:
        REGISTRY.counter(f"mh.band_exchange_bytes.{what}").inc(nbytes)
    return host[0] if len(host) == 1 else host
