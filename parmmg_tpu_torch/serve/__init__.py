"""Remeshing-as-a-service: multi-tenant mesh serving on the group axis
(port of ``serve/``).

N independent tenant meshes ride bucketed ``[G, ...]`` slot states
through the grouped path's cycle block (``parallel/groups._group_block``)
on the card:

- :mod:`pool` — slot pool + admission: bucketed group slots (capacity
  ladders from ``utils.compilecache.bucket``), chunk-compacted dispatch,
  per-tenant convergence, capacity promotion and slot recycling;
- :mod:`driver` — request lifecycle: submit/poll/fetch over a work
  queue, per-request AdaptStats and quality SLO, timeouts;
- :mod:`admission` — staging, queue pump, backpressure and streaming
  mid-step slot re-rent;
- :mod:`autoscale` — bucket resizing and admission deferral as a pure
  function of the metrics snapshot;
- :mod:`daemon` / :mod:`client` — the persistent pool service behind a
  stdlib HTTP/JSON RPC layer, and its torch-free client.

Front ends: ``python -m parmmg_tpu_torch.serve.daemon`` (the service) and
``python -m parmmg_tpu_torch.serve.run`` (files in, distributed files
out).  The package imports none of its modules itself, so the client
stays light and the front ends run as ``-m`` modules.
"""
