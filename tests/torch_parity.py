"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Import the fixture into a test module to apply it there::

    from torch_parity import jax_ledger_listener_compat  # noqa: F401
"""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wrap_ledger_listener():
    """The JAX package's compile-ledger listener takes (event, duration)
    while jax >= 0.9 also passes keyword metadata (``fun_name``), which
    makes every compile raise once the listener is installed.  Install
    it, then wrap it to drop the keywords.  Returns the listeners as they
    were."""
    import parmmg_tpu.ops.adapt  # noqa: F401  (installs the listener)
    from jax._src import monitoring
    from parmmg_tpu.utils.compilecache import CompileLedger
    saved = list(monitoring._event_duration_secs_listeners)

    def tolerant(cb):
        if getattr(cb, "__func__", None) is CompileLedger._on_event:
            return lambda event, duration, **_kw: cb(event, duration)
        return cb
    monitoring._event_duration_secs_listeners[:] = [tolerant(c)
                                                    for c in saved]
    return saved


@pytest.fixture(autouse=True, scope="module")
def jax_ledger_listener_compat():
    """The listener wrapped (see :func:`wrap_ledger_listener`) for the
    importing module's tests.

    The module's torch work runs on one CPU thread: under xdist the
    worker processes share the machine's cores, and one thread pool the
    size of the machine in each of them oversubscribes it many times
    over (the port's small meshes gain nothing from threads anyway)."""
    from jax._src import monitoring
    saved = wrap_ledger_listener()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    monitoring._event_duration_secs_listeners[:] = saved


_JAX_CLI = ("import json, sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_parity\n"
            "torch_parity.wrap_ledger_listener()\n"
            "from parmmg_tpu import cli\n"
            "for args in json.loads(sys.argv[1]):\n"
            "    if cli.main(args):\n"
            "        sys.exit(1)\n")


def start_jax_cli(*runs):
    """The JAX package's CLI on each argument list of ``runs`` in turn,
    in a subprocess, so that the module's other tests run while it
    compiles (about two minutes on the CPU); :func:`jax_cli_records`
    waits for it."""
    return subprocess.Popen([sys.executable, "-c", _JAX_CLI,
                             json.dumps([list(r) for r in runs])],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def jax_cli_records(proc, timeout=1200):
    """The ``-bench-json`` records of a :func:`start_jax_cli` subprocess,
    one a run."""
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (out + err)[-2000:]
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
