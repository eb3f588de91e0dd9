"""Registry of every ``PMTORCH_*`` environment knob the port reads (the
port's counterpart of the JAX package's ``api/knobs.py``).

Every environment read of ``parmmg_tpu_torch`` goes through :func:`get`,
which raises ``KeyError`` on an undeclared name, so no knob reaches the
code without an entry here.  ``tests/test_torch_knobs.py`` walks the
package with ``ast`` and holds the registry to the code both ways (every
``PMTORCH_*`` read is declared, every declared knob is read) and to
README (every knob is listed there).  The prefix is the port's own: the
JAX package's ``PARMMG_*`` names belong to its registry, and one
environment may drive both packages differently.

Each knob keeps the JAX package's default and meaning.  What the JAX
package reads as a knob but the port takes as an argument (the serve
daemon's settings, the scheduler and cadence switches) is listed in
ROADMAP.md.

Stdlib only: the polish worker reads its forced fault through this module
before it imports torch.  ``KNOBS`` stays one dict literal of ``"NAME":
Knob(type, default, doc)`` entries, so the test can read it with ``ast``.

``python -m parmmg_tpu_torch.api.knobs`` prints the markdown table of
README's knob section.
"""
from __future__ import annotations

import dataclasses
import os

__all__ = ["KNOBS", "Knob", "LAUNCHER_VARS", "PREFIX", "environment",
           "get", "knob_table_md", "launcher", "registered"]

PREFIX = "PMTORCH_"

# the variables a process launcher (``torchrun``, the pod runner) sets for
# each rank of a several-process run: torch.distributed's own names and
# CUDA's card list, read through :func:`launcher`, never a knob
LAUNCHER_VARS = ("CUDA_VISIBLE_DEVICES", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class Knob:
    """One knob: coarse value type ("int" | "float" | "str" | "flag" |
    "path" | "spec"), the default the reader applies when the variable is
    unset (as the string the environment would carry; "" = off/auto), and
    a one-line doc."""
    type: str
    default: str
    doc: str


KNOBS: dict[str, Knob] = {
    "PMTORCH_CKPT_DIR": Knob(
        "path", "",
        "pass-checkpoint directory (resilience/checkpoint.py); unset = "
        "checkpointing off"),
    "PMTORCH_CKPT_EVERY": Knob(
        "int", "1", "checkpoint every Nth outer pass"),
    "PMTORCH_CYCLE_BLOCK": Knob(
        "int", "",
        "cycles a dispatch of adapt_mesh (its cycle_block argument, read "
        "once at the driver's entry); empty = the device's default, 9 on "
        "the card and 1 on the CPU"),
    "PMTORCH_DEADLINE_DISPATCH_S": Knob(
        "float", "0",
        "watchdog deadline on each grouped chunk dispatch/drain "
        "(resilience/watchdog.py; 0 = off), re-armed by every cycle the "
        "dispatch completes; expiry enters the retry ladder as "
        "WatchdogTimeout"),
    "PMTORCH_DEADLINE_GRACE_S": Knob(
        "float", "300",
        "extra seconds granted to a site's first guarded call, so a cold "
        "first step is not misread as a wedged warm one"),
    "PMTORCH_FAULT": Knob(
        "spec", "",
        "arm fault-injection sites at first use: site[:trigger][,site...] "
        "(resilience/faults.py grammar)"),
    "PMTORCH_FAULT_FORCE": Knob(
        "str", "",
        "internal parent->subprocess forcing of one fault site (the polish "
        "worker exits before importing torch on it); never set by hand"),
    "PMTORCH_GROUP_CHUNK": Knob(
        "int", "",
        "groups per dispatch on the grouped path (grouped_adapt_pass's "
        "chunk argument, read once at the driver's entry; 0 = every group "
        "in one dispatch; empty = the memory rule of groups.group_chunk)"),
    "PMTORCH_HEARTBEAT_S": Knob(
        "float", "2",
        "least seconds between two touches of a rank's heartbeat file "
        "(resilience/watchdog.beat)"),
    "PMTORCH_INCR_TOPO": Knob(
        "flag", "",
        "incremental topology maintenance on the grouped path "
        "(grouped_adapt_pass's incr argument, read once at the driver's "
        "entry; ops/topo_incr.py); 0/unset = full rebuilds"),
    "PMTORCH_MH_HANDOFF": Knob(
        "flag", "",
        "1 = the group handoff between passes: whole shards move between "
        "ranks when the ranks' loads skew (parallel/pod.maybe_handoff)"),
    "PMTORCH_MH_HEARTBEAT_DIR": Knob(
        "path", "",
        "per-rank heartbeat directory (hb.N files), set by the pod runner "
        "for its workers under --lease; never set by hand"),
    "PMTORCH_MH_IMBALANCE": Knob(
        "float", "0.25",
        "rank load skew (max / mean - 1) above which the group handoff "
        "plans a new placement"),
    "PMTORCH_MH_STRICT": Knob(
        "flag", "",
        "1 = raise on a metered pull_host allgather inside a hot path "
        "instead of only counting it on mh.hot_allgather_bytes"),
    "PMTORCH_POLISH_SUBPROC": Knob(
        "flag", "",
        "grouped polish (-group-polish) of a chunked pass in a "
        "subprocess worker (parallel/_polish_worker.py); empty/0 = in "
        "this process"),
    "PMTORCH_POLISH_TIMEOUT_S": Knob(
        "float", "0",
        "wall-clock timeout on the grouped polish subprocess worker (0 = "
        "off): expiry kills the worker, unlinks its partial output and "
        "degrades to merged_polish like a worker crash"),
    "PMTORCH_PROFILE_DIR": Knob(
        "path", "",
        "arm a torch.profiler capture (CPU + CUDA activities) writing a "
        "Chrome trace into this directory"),
    "PMTORCH_PROFILE_PASS": Knob(
        "spec", "0",
        "outer-pass capture window start[:stop] for PMTORCH_PROFILE_DIR"),
    "PMTORCH_RESUME_MAX": Knob(
        "int", "3",
        "crash-loop breaker: resume attempts into the same pass of the same "
        "run fingerprint before escalating to lowfailure instead of "
        "resuming again (resilience/checkpoint.crash_loop)"),
    "PMTORCH_RETRY_BASE_S": Knob(
        "float", "0.05", "retry backoff base seconds, doubled per attempt"),
    "PMTORCH_RETRY_DEADLINE_S": Knob(
        "float", "0", "wall-clock cap on retrying (0 = no deadline)"),
    "PMTORCH_RETRY_MAX": Knob(
        "int", "2",
        "retries after the first failure on retry_call sites (0 = fail "
        "fast)"),
    "PMTORCH_TRACE": Knob(
        "path", "",
        "append structured trace records (JSONL) to this file; unset = "
        "ring buffer only"),
    "PMTORCH_TRACE_RING": Knob(
        "int", "4096", "trace ring-buffer capacity in records"),
    "PMTORCH_VERBOSE": Knob(
        "int", "1",
        "process verbosity (the reference's imprim scale) gating "
        "obs.trace.log output"),
}


def registered() -> tuple[str, ...]:
    """All declared knob names, sorted."""
    return tuple(sorted(KNOBS))


def get(name: str, default: str | None = None) -> str:
    """Registry-checked ``os.environ.get``: raises ``KeyError`` on an
    undeclared knob; falls back to the declared default unless the caller
    gives another."""
    if name not in KNOBS:
        raise KeyError(f"undeclared PMTORCH knob {name!r}: declare it in "
                       "parmmg_tpu_torch/api/knobs.py")
    return os.environ.get(
        name, KNOBS[name].default if default is None else default)


def launcher(name: str) -> str:
    """One of :data:`LAUNCHER_VARS` from the environment ("" when unset);
    raises ``KeyError`` on any other name."""
    if name not in LAUNCHER_VARS:
        raise KeyError(f"{name!r} is not a launcher variable "
                       f"{LAUNCHER_VARS}")
    return os.environ.get(name, "")


def environment() -> dict:
    """Every ``PMTORCH_*`` variable set in the environment, declared or
    not, sorted (the run artifact's reproducibility block)."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(PREFIX)}


def knob_table_md() -> str:
    """The markdown knob table (README's knob section)."""
    rows = ["| knob | type | default | purpose |",
            "|---|---|---|---|"]
    for name in registered():
        k = KNOBS[name]
        rows.append(f"| `{name}` | {k.type} | "
                    f"{('`' + k.default + '`') if k.default else 'unset'}"
                    f" | {k.doc} |")
    return "\n".join(rows)


if __name__ == "__main__":
    # lint: ok(R3) — the table dump is this module's stdout contract
    print(knob_table_md())
