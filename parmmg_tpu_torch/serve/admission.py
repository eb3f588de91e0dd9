"""Admission control: staging, queue pump, backpressure and streaming
slot re-rent for the serving driver (port of ``serve/admission.py``).

- **streaming admission** (``stream``, default on): the pool's step loop
  reports each cohort's retirements as they commit
  (``SlotPool.step(on_retire=...)``) and :meth:`AdmissionController.
  mid_step` retires them and re-rents the freed slots to queued tenants
  while the step is still in flight; a re-rented slot rides the step's
  re-scan at its own cycle 0.  Admission timing never changes a tenant's
  bytes: its block sequence is a function of its own cycle index alone
  and slots run independently;
- **backpressure** (``max_queue`` + the autoscale controller's defer
  latch): :meth:`AdmissionController.backpressure` gives
  ``ServeDriver.try_submit`` a 429-style deferral reason instead of
  letting the queue grow without bound.

Staging (file -> Mesh, raw arrays -> Mesh) lives here too: the daemon's
RPC edge and the queue pump share one staging rule, which is what makes
daemon-served results byte-equal to standalone runs of the same input.
"""
from __future__ import annotations

import numpy as np
import torch

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
REJECTED = "rejected"
FAILED = "failed"
TIMEOUT = "timeout"

TERMINAL = (DONE, REJECTED, FAILED, TIMEOUT)


# ---------------------------------------------------------------------------
# staging: one rule for files, raw arrays and the daemon's RPC edge
# ---------------------------------------------------------------------------
def _pad_met(mesh, vals) -> torch.Tensor:
    """Metric values (scalar or tensor, any length <= capP) -> the staged
    full-capP metric with unit pads (every component 1), in the mesh's
    dtype on its device.  The one padding rule both staging paths share."""
    vals = np.asarray(vals)
    full = np.ones((mesh.capP,) + vals.shape[1:], np.float64)
    full[: len(vals)] = vals
    if full.ndim == 2 and full.shape[1] == 1:
        full = full[:, 0]
    return torch.as_tensor(full, dtype=mesh.vert.dtype, device=mesh.device)


def stage_file(path: str, sol: str | None, device="cuda"):
    """File -> (core Mesh, met) on ``device``: Medit or VTK in, analysis
    tags on, metric from the .sol (scalar or tensor), from the .vtu's
    metric field, or the -optim default."""
    from ..core.mesh import make_mesh
    from ..io.medit import read_mesh, read_sol
    from ..ops.analysis import analyze_mesh
    from ..ops.metric import metric_optim

    vtu_met = None
    if str(path).endswith(".vtu"):
        from ..io.vtk import read_vtu_medit
        mm, vtu_met, _fields = read_vtu_medit(path)
    else:
        mm = read_mesh(path)
    mesh = make_mesh(mm.vert, mm.tetra, vref=mm.vref, tref=mm.tref,
                     device=device)
    mesh = analyze_mesh(mesh).mesh
    vals = None
    if sol:
        vals, _types = read_sol(sol)
    elif vtu_met is not None:
        vals = np.asarray(vtu_met)
    if vals is not None:
        return mesh, _pad_met(mesh, vals)
    return mesh, metric_optim(mesh)


def stage_arrays(vert, tet, vref=None, tref=None, met=None, device="cuda"):
    """Raw arrays -> staged (core Mesh, met) on ``device``: the daemon's
    RPC staging rule, shared with the standalone reference runs so that
    daemon-served results equal them byte for byte.  Caps are 4x the input
    (``make_mesh(capP=4*nvert, capT=4*ntet)``), analysis tags are
    computed, and the metric (scalar or tensor, any length <= capP) is
    padded to capP with unit entries; without a metric, ``metric_optim``
    as on the file path."""
    from ..core.mesh import make_mesh
    from ..ops.analysis import analyze_mesh
    from ..ops.metric import metric_optim

    vert = np.asarray(vert, np.float64)
    tet = np.asarray(tet, np.int32)
    mesh = make_mesh(vert, tet, vref=vref, tref=tref,
                     capP=4 * len(vert), capT=4 * len(tet), device=device)
    mesh = analyze_mesh(mesh).mesh
    if met is None:
        return mesh, metric_optim(mesh)
    return mesh, _pad_met(mesh, met)


def mesh_size(mesh) -> tuple[int, int]:
    """(tet-referenced vertex count, live tet count): the admission
    sizing rule (``split_to_shards`` sizes capP from tet-referenced
    vertices, not vmask).  Accepts a staged core Mesh or a plain dict of
    arrays (the stub pools of the host-only tests)."""
    if isinstance(mesh, dict):
        tet = np.asarray(mesh["tet"])
        return len(np.unique(tet)), len(tet)
    tm = mesh.tmask.cpu().numpy()
    nv = len(np.unique(mesh.tet.cpu().numpy()[tm]))
    return nv, int(tm.sum())


def met_width(met) -> int:
    """Metric trailing width (0 = scalar): the bucket-key component."""
    if met is None:
        return 0
    shape = tuple(met.shape)
    return 0 if len(shape) == 1 else int(shape[-1])


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------
class AdmissionController:
    """Queue pump + backpressure + the streaming mid-step hook.

    Owns no queue: the queue and request table stay on the driver.  This
    object owns the policy: streaming on or off (``stream``, the JAX
    package's PARMMG_SERVE_STREAM, default on), the submit-time queue
    bound (``max_queue``, PARMMG_SERVE_MAX_QUEUE, 0 = unbounded) and the
    autoscale controller's defer latch (``deferring``)."""

    def __init__(self, driver, max_queue: int = 0, stream: bool = True):
        self.driver = driver
        self.max_queue = int(max_queue)
        self.stream = bool(stream)
        self.deferring = False          # autoscale backpressure latch
        self.stream_admissions = 0
        self.deferred = 0

    # ---- backpressure (429-style deferral) -------------------------------
    def backpressure(self) -> str | None:
        """Deferral reason for a new submit, or None to accept.  Never
        affects requests already queued."""
        if self.deferring:
            return "autoscale backpressure (deferring admissions)"
        if self.max_queue and len(self.driver.queue) >= self.max_queue:
            return (f"queue full ({len(self.driver.queue)} >= "
                    f"max_queue {self.max_queue})")
        return None

    # ---- the queue pump ---------------------------------------------------
    def pump(self) -> list[str]:
        """Admit queued requests into free slots (between steps, or, via
        :meth:`mid_step`, while a step is in flight).  Staging failures
        and oversize requests retire one request at a time; "full"
        requests stay queued and publish the per-bucket blocked-admission
        gauge the autoscale controller grows on.  Returns the newly
        admitted tenant ids."""
        import time

        from ..obs import trace as otrace
        from ..obs.metrics import REGISTRY
        d = self.driver
        pool = d.pool
        admitted: list[str] = []
        remaining: list[str] = []
        blocked: dict[str, int] = {}
        for tid in d.queue:
            r = d.requests[tid]
            try:
                if r.mesh is None and r.path is not None:
                    r.mesh, r.met = stage_file(r.path, r.sol,
                                               device=pool.device)
                nv, nt = mesh_size(r.mesh)
                mw = met_width(r.met)
            except Exception as e:
                # per-request fault isolation: a corrupt input must not
                # take down the loop or the other tenants
                r.state = FAILED
                r.reason = f"staging failed: {e}"
                r.t_done = time.perf_counter()
                r.mesh = r.met = None
                continue
            got = pool.admit(tid, nv, nt, met_width=mw)
            if got[0] == "oversize":
                r.state = REJECTED
                r.reason = (f"needs caps {got[1][0]}x{got[1][1]} > pool "
                            f"max {pool.max_capP}x{pool.max_capT}")
                r.t_done = time.perf_counter()
                r.mesh = r.met = None
                continue
            if got[0] == "full":
                remaining.append(tid)       # waits for a recycled slot
                label = pool.bucket_label(got[1])
                blocked[label] = blocked.get(label, 0) + 1
                continue
            try:
                pool.load(tid, r.mesh, r.met)
            except Exception as e:
                pool.release(tid)           # fault isolation (as above)
                r.state = FAILED
                r.reason = f"load failed: {e}"
                r.t_done = time.perf_counter()
                r.mesh = r.met = None
                continue
            # the pool holds the tenant's rows on the host from here: the
            # staged device copy goes
            r.mesh = r.met = None
            r.state = RUNNING
            r.t_admit = time.perf_counter()
            admitted.append(tid)
            otrace.log(1, f"serve: admitted {tid} -> bucket "
                          f"{got[1][0]}x{got[1][1]} slot {got[2]}",
                       verbose=d.verbose, err=True)
        d.queue = remaining
        REGISTRY.gauge("serve.queue_depth").set(len(d.queue))
        # full-bucket admission pressure: the autoscale grow signal,
        # cleared for buckets that stopped blocking this pump
        for label in pool.labels():
            REGISTRY.gauge(f"serve.admit_blocked.{label}").set(
                blocked.get(label, 0))
        return admitted

    # ---- streaming admission (the SlotPool.step on_retire hook) ----------
    def mid_step(self, retired: list[str]) -> None:
        """Retire a cohort's finished tenants now and re-rent their freed
        slots from the queue, while the pool step is still in flight."""
        d = self.driver
        for tid in retired:
            if d.requests[tid].state == RUNNING:
                d._retire(tid)
        if not d.queue:
            return
        got = self.pump()
        if got:
            from ..obs import trace as otrace
            from ..obs.metrics import REGISTRY
            self.stream_admissions += len(got)
            REGISTRY.counter("serve.stream_admissions").inc(len(got))
            otrace.event("serve.stream_admit", tenants=len(got))

    def summary(self) -> dict:
        return {"stream": self.stream, "max_queue": self.max_queue,
                "deferring": self.deferring,
                "stream_admissions": self.stream_admissions,
                "deferred": self.deferred}
