"""Pass-level checkpoint/resume for the grouped outer loop (the port's copy
of ``resilience/checkpoint.py``, its single-device half).

- after each completed outer pass the loop saves the merged state (mesh
  fields + metric + the displaced partition + the pass index) as one
  ``<tag>.pass<k>.npz`` under ``PMTORCH_CKPT_DIR``: the exact-resume
  payload.  The keys and dtypes are the JAX package's (tags as uint32),
  so a checkpoint written by either package loads in the other;
- the pre-merge stacked state of a checkpointed pass is also written as
  per-group Medit shard files (``io.distributed.stacked_to_distributed_
  files``, the reference's ``-distributed-output`` role), so a checkpoint
  can be read by any Medit consumer;
- ``PMTORCH_CKPT_EVERY`` (default 1) thins the cadence;
- resume (``cli.py -resume`` / ``grouped_adapt(resume=True)``) loads the
  newest complete pass checkpoint whose run fingerprint matches and
  re-enters the loop at the next pass.  Passes are deterministic
  functions of their input state, so a resumed run finishes with the
  bytes of an uninterrupted one.  The fingerprint hashes the same bytes
  in both packages (``vert`` float32, ``tet`` int32, ``tmask`` bool, the
  metric float32, then the loop's arguments), so each resumes the
  other's checkpoints.

Checkpoint IO never kills the run it protects: every write is atomic
(tmp + ``os.replace``, so a kill mid-write leaves only a ``.tmp`` that is
never taken for a checkpoint) and every failure, the injected
``io.checkpoint`` OSError included, is counted
(``resilience.checkpoint_failures``) and traced; the run continues
unprotected.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from ..api import knobs
from .faults import faultpoint

__all__ = [
    "ckpt_config", "ckpt_due", "crash_loop", "latest_pass_checkpoint",
    "load_pass_checkpoint", "resume_max", "run_fingerprint",
    "save_pass_checkpoint", "snapshot_stacked",
]

_CKPT_RE = re.compile(r"\.pass(\d+)\.npz$")


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def ckpt_config() -> tuple[str, int]:
    """(checkpoint dir, pass cadence); dir == "" disables."""
    d = knobs.get("PMTORCH_CKPT_DIR")
    every = int(knobs.get("PMTORCH_CKPT_EVERY") or 1)
    return d, max(1, every)


def ckpt_due(it: int) -> bool:
    """Whether outer pass ``it`` (0-based) should checkpoint."""
    d, every = ckpt_config()
    return bool(d) and (it + 1) % every == 0


def _ckpt_path(d: str, tag: str, it: int) -> str:
    return os.path.join(d, f"{tag}.pass{it}.npz")


# ---------------------------------------------------------------------------
# crash-loop breaker
# ---------------------------------------------------------------------------
def resume_max() -> int:
    """Resume attempts into the same (fingerprint, pass) before the
    breaker escalates past the failing pass (``PMTORCH_RESUME_MAX``)."""
    try:
        return max(1, int(knobs.get("PMTORCH_RESUME_MAX") or 3))
    except ValueError:
        return 3


def crash_loop(tag: str, fingerprint: str | None, it: int,
               write: bool = True) -> tuple[int, bool]:
    """The crash-loop breaker decision, taken at resume time.

    A pass that reliably kills its run resumes into the same state and
    kills it again; this records a per-(fingerprint, pass) resume count
    in ``<tag>.resume.json`` next to the checkpoints and returns
    ``(attempts, escalate)``: ``escalate`` turns True on the attempt
    after ``resume_max()`` is reached, the caller's signal to skip past
    the failing pass (the last conforming checkpointed state is the
    bounded-time answer).  Escalation emits a ``resilience.crash_loop``
    event and bumps ``resilience.crash_loops``.  ``write=False`` computes
    the decision without persisting the count.  IO failure here is
    absorbed, never raised."""
    d, _ = ckpt_config()
    key = f"{fingerprint or ''}:{int(it)}"
    counts: dict = {}
    path = os.path.join(d, f"{tag}.resume.json") if d else ""
    if path:
        try:
            with open(path) as fh:
                counts = dict(json.load(fh))
        except Exception:
            counts = {}
    n = int(counts.get(key, 0)) + 1
    if path and write:
        counts[key] = n
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(counts, fh)
            os.replace(tmp, path)
        except OSError:
            pass
    mx = resume_max()
    esc = n > mx
    if esc:
        from ..obs import trace as otrace
        from ..obs.metrics import REGISTRY
        REGISTRY.counter("resilience.crash_loops").inc()
        otrace.event("resilience.crash_loop", tag=tag, it=int(it),
                     attempts=n, max=mx)
        otrace.log(1, f"  ## resilience: crash loop — pass {it} "
                      f"resumed {n}x (PMTORCH_RESUME_MAX={mx}); "
                      "escalating past the failing pass: the last "
                      "conforming checkpointed state is the "
                      "bounded-time answer.", err=True)
    return n, esc


def run_fingerprint(mesh, met, *args) -> str:
    """Run-identity digest of a loop's original input (mesh bytes +
    metric + the loop's arguments), stored in every pass checkpoint and
    matched at resume, so a reused checkpoint directory never resumes a
    checkpoint of a different input.  Torch tensors hash as their host
    arrays; the bytes equal the JAX package's on the same input."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for a in (mesh.vert, mesh.tet, mesh.tmask, met):
        h.update(np.ascontiguousarray(_host(a)).tobytes())
    h.update(repr(args).encode())
    return h.hexdigest()


def save_pass_checkpoint(tag: str, it: int, mesh, met, part,
                         fingerprint: str | None = None) -> str | None:
    """Atomically write pass ``it``'s resume payload.  Returns the path,
    or None when disabled / not due / the write failed (counted and
    traced, never raised)."""
    from ..core.mesh import MESH_FIELDS, mesh_to_numpy
    from ..obs import trace as otrace
    from ..obs.metrics import REGISTRY
    if not ckpt_due(it):
        return None
    d, _ = ckpt_config()
    path = _ckpt_path(d, tag, it)
    try:
        faultpoint("io.checkpoint")
        os.makedirs(d, exist_ok=True)
        fields = mesh_to_numpy(mesh)
        tmp = path + ".tmp"
        # a file handle, not a path: np.savez would append ".npz" to the
        # tmp name and break the atomic-replace pairing
        with open(tmp, "wb") as fh:
            np.savez(fh, it=np.asarray(it, np.int64),
                     fp=np.asarray(fingerprint or ""),
                     met=_host(met),
                     part=np.asarray(part if part is not None else []),
                     **{f: fields[f] for f in MESH_FIELDS})
        os.replace(tmp, path)
    except Exception as e:
        # drop the partial .tmp: on a full disk every pass would otherwise
        # leave another mesh-sized partial behind
        try:
            os.unlink(path + ".tmp")
        except OSError:
            pass
        REGISTRY.counter("resilience.checkpoint_failures").inc()
        otrace.event("ckpt.failed", tag=tag, it=it, detail=repr(e)[:300])
        otrace.log(1, f"  ## Warning: pass checkpoint failed ({e!r}); "
                      "run continues unprotected.", err=True)
        return None
    REGISTRY.counter("resilience.checkpoints").inc()
    otrace.event("ckpt.saved", tag=tag, it=it, path=path)
    return path


def snapshot_stacked(tag: str, it: int, stacked, n_groups: int) -> list:
    """Merge-free shard snapshot of a checkpointed pass's stacked state
    (``<tag>.pass<k>.<group>.mesh``, no communicator sections: group seams
    are frozen, not parallel interfaces).  Best-effort like the npz write:
    failures are counted, never raised."""
    from ..obs import trace as otrace
    from ..obs.metrics import REGISTRY
    if not ckpt_due(it):
        return []
    d, _ = ckpt_config()
    try:
        faultpoint("io.checkpoint")
        from ..io.distributed import stacked_to_distributed_files
        os.makedirs(d, exist_ok=True)
        outs = stacked_to_distributed_files(
            os.path.join(d, f"{tag}.pass{it}.mesh"), stacked, n_groups,
            shards=range(n_groups))
    except Exception as e:
        REGISTRY.counter("resilience.checkpoint_failures").inc()
        otrace.event("ckpt.snapshot_failed", tag=tag, it=it,
                     detail=repr(e)[:300])
        return []
    REGISTRY.counter("resilience.checkpoint_shards").inc(len(outs))
    return outs


def latest_pass_checkpoint(tag: str, fingerprint: str | None = None
                           ) -> tuple[str, int] | None:
    """Newest complete (path, pass index) for ``tag`` under the checkpoint
    directory, or None.  ``.tmp`` partials from a kill mid-write are
    ignored, unloadable files skipped; with ``fingerprint`` set, a
    checkpoint whose stored run identity differs is skipped with a
    warning."""
    from ..obs import trace as otrace
    d, _ = ckpt_config()
    if not d or not os.path.isdir(d):
        return None
    found = []
    for name in os.listdir(d):
        if not name.startswith(tag + ".pass"):
            continue
        m = _CKPT_RE.search(name)
        if m:
            found.append((int(m.group(1)), os.path.join(d, name)))
    for it, path in sorted(found, reverse=True):
        try:
            with np.load(path) as z:
                if "vert" not in z.files or int(z["it"]) != it:
                    continue
                if fingerprint is not None:
                    stored = str(z["fp"]) if "fp" in z.files else ""
                    if stored != fingerprint:
                        otrace.log(1, f"  ## Warning: checkpoint "
                                      f"{path} belongs to a different "
                                      "run (input fingerprint "
                                      "mismatch); skipped.", err=True)
                        continue
                return path, it
        except Exception:
            continue
    return None


def load_pass_checkpoint(path: str, device="cpu"):
    """Checkpoint -> (Mesh on ``device``, met tensor, part (numpy or
    None), pass index)."""
    from ..core.mesh import MESH_FIELDS, mesh_from_numpy
    with np.load(path) as z:
        mesh = mesh_from_numpy({f: z[f] for f in MESH_FIELDS}, device)
        met = torch.from_numpy(np.array(z["met"])).to(device)
        part = z["part"]
        it = int(z["it"])
    return mesh, met, (part if part.size else None), it
