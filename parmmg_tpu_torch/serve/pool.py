"""Slot pool + admission: bucketed group slots for multi-tenant serving
(port of ``serve/pool.py``).

A *slot* is one group position of a host-resident stacked mesh state,
the unit ``parallel.groups.grouped_adapt_pass`` dispatches in chunk mode,
except that the slots of one bucket hold independent tenant meshes
instead of slices of one mesh.  Buckets are rungs of the capacity ladder
``utils.compilecache.bucket(cap_mult * n, floor=64)``, the formula
``parallel.distribute.split_to_shards`` uses for group capacities, so a
tenant in its home bucket runs at the shapes of the standalone
``grouped_adapt_pass(ngroups=1)``: the same ``_group_block``, the same
wave budgets, the same bytes.

Scheduling: each step, the active (admitted, unconverged) slots of a
bucket are cohorted by cycle index — slots of one cohort share ``(flags,
pres, wave)`` — and compacted into ``[chunk, ...]`` dispatches with
``parallel.sched.chunk_plans``, through ``groups._pipeline_chunks``: each
plan's rows go up to the device, run their cycle block, come back and are
written into the bucket's host state.  A tenant retires at its own fixed
point (``groups.block_converged``) and frees its slot for the next queued
request.  Free slots hold all-zero dead meshes and are never dispatched.

Capacity overflow mirrors the batch regrow: the overflowed state is
padded as ``distribute.grow_shards`` pads it into a ``(2*capP, 2*capT)``
bucket and the same block reruns the next step.

A dispatch that fails on the card is a slot fault: the slot is retried
the next step and quarantined after ``max_slot_retries`` faults.  Nothing
reruns a tenant on the CPU or through the plain kernels.

The admission state machine (admit / full / oversize, slot recycling) is
host bookkeeping; the bucket's arrays are allocated at the first
``load``.  The JAX pool's remesh options that no caller sets (``noinsert``,
``noswap``, ``nomove``, ``hausd``) are left out: every tenant runs the
defaults.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..api.parmesh import resolve_device
from ..core.mesh import MESH_FIELDS
from ..ops.topo_incr import TopoState
from ..utils.compilecache import bucket

BUCKET_FLOOR = 64          # split_to_shards' geo-ladder floor
MAX_REGROWS = 6            # the grouped pass's regrow limit


@dataclasses.dataclass
class Slot:
    """One bucketed group slot: bookkeeping for the tenant renting it."""
    tenant: str | None = None
    c: int = 0                 # cycle index (block boundary)
    converged: bool = False
    failed: str = ""           # non-empty = terminal failure reason
    regrows: int = 0
    loaded: bool = False
    stats: object = None       # AdaptStats(tenant=...)
    faults: int = 0            # dispatch faults (quarantine ladder)


class Bucket:
    """One capacity rung: ``nslots`` group slots at (capP, capT).

    ``stacked`` (``core.mesh.MeshStack``), ``met`` and ``topo``
    (``ops/topo_incr.TopoState``) are CPU tensors [nslots, ...] in the
    chunk-mode layout of grouped_adapt_pass, allocated at the first load
    (``topo`` at the first dispatch); free slots stay all-zero dead
    meshes."""

    def __init__(self, capP: int, capT: int, nslots: int):
        self.capP = capP
        self.capT = capT
        self.nslots = nslots
        self.slots = [Slot() for _ in range(nslots)]
        self.stacked = None
        self.met = None
        self.topo = None

    def free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s.tenant is None:
                return i
        return None

    def occupancy(self) -> tuple[int, int]:
        return (sum(1 for s in self.slots if s.tenant is not None),
                self.nslots)

    def map_state(self, fn) -> None:
        """Replace every state tensor ``a`` by ``fn(a)``."""
        if self.stacked is not None:
            self.stacked = self.stacked.map(fn)
            self.met = fn(self.met)
        if self.topo is not None:
            self.topo = TopoState(*[fn(a) for a in self.topo])

    def zero_row(self, i: int) -> None:
        """Reset slot row ``i`` to the dead-mesh state (all zeros, the
        ``_pad_groups`` convention)."""
        def z(a):
            a[i] = 0
            return a
        self.map_state(z)


def _zeros_like_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype)


class SlotPool:
    """Bucketed slot pool: admission + chunked multi-tenant dispatch.

    Knobs (the JAX pool's ``PARMMG_SERVE_*`` variables, with their
    defaults): ``slots_per_bucket`` (SLOTS, 4), ``chunk`` groups a
    dispatch (CHUNK, 1), the admission ceilings ``max_capP`` /
    ``max_capT`` (MAX_CAPP / MAX_CAPT, 1<<22), ``max_slot_retries``
    (MAX_RETRIES, 2); ``cap_mult`` growth headroom (3.0, the
    split_to_shards default), ``cycles`` a tenant (6).  ``device``: where
    the cycle blocks run (``"cuda"`` unless the caller asks for the CPU;
    raises without a card)."""

    def __init__(self, slots_per_bucket: int = 4, chunk: int = 1,
                 cap_mult: float = 3.0, max_capP: int = 1 << 22,
                 max_capT: int = 1 << 22, cycles: int = 6,
                 max_slot_retries: int = 2, device="cuda"):
        from ..utils.timers import Timers
        self.device = resolve_device(device)
        self.slots_per_bucket = int(slots_per_bucket)
        # fault isolation: a tenant whose slot dispatch faults this many
        # times is quarantined (retired FAILED, slot scrubbed and
        # recycled), never aborting cohort-mates sharing the chunk
        self.max_slot_retries = max(1, int(max_slot_retries))
        self.quarantined: list[str] = []
        self.chunk = max(1, int(chunk))
        self.cap_mult = float(cap_mult)
        self.max_capP = int(max_capP)
        self.max_capT = int(max_capT)
        self.cycles = int(cycles)
        self.buckets: dict[tuple, Bucket] = {}
        self._where: dict[str, tuple] = {}      # tenant -> (key, slot)
        self.dispatches = 0
        self.regrows = 0
        self.steps = 0
        # active slots a (step, bucket): the serving form of the grouped
        # pass's active_groups_per_block, fed to the chunk cost model;
        # bounded, as a daemon serves indefinitely
        self.active_per_step: deque = deque(maxlen=4096)
        # pipeline segment seconds (upload / compute / download /
        # writeback) over every dispatch of the pool's lifetime
        self.timers = Timers()

    # ---- admission state machine (host bookkeeping) ----------------------
    def home_caps(self, n_vert: int, n_tet: int) -> tuple[int, int]:
        """Smallest ladder rung fitting a tenant of ``n_tet`` live tets
        referencing ``n_vert`` vertices: the capacities split_to_shards
        computes for a one-part split (its maxP counts tet-referenced
        vertices, not vmask: callers pass that, or load() rejects the
        mismatch)."""
        return (bucket(int(self.cap_mult * n_vert), floor=BUCKET_FLOOR),
                bucket(int(self.cap_mult * n_tet), floor=BUCKET_FLOOR))

    def admit(self, tenant: str, n_vert: int, n_tet: int,
              met_width: int = 0):
        """Try to admit a tenant: ("ok", key, slot) | ("full", key) |
        ("oversize", caps).  "full" tenants stay queued at the caller
        (the driver) until a retiring tenant recycles its slot."""
        from ..obs.metrics import REGISTRY
        from ..ops.adapt import AdaptStats
        if tenant in self._where:
            raise ValueError(f"tenant {tenant!r} already admitted")
        capP, capT = self.home_caps(n_vert, n_tet)
        if capP > self.max_capP or capT > self.max_capT:
            REGISTRY.counter("serve.admit_oversize").inc()
            return ("oversize", (capP, capT))
        key = (capP, capT, int(met_width))
        b = self.buckets.get(key)
        if b is None:
            b = self.buckets[key] = Bucket(capP, capT,
                                           self.slots_per_bucket)
        i = b.free_slot()
        if i is None:
            REGISTRY.counter("serve.admit_full").inc()
            return ("full", key)
        b.slots[i] = Slot(tenant=tenant, stats=AdaptStats(tenant=tenant))
        self._where[tenant] = (key, i)
        REGISTRY.counter("serve.admit_ok").inc()
        return ("ok", key, i)

    def release(self, tenant: str) -> None:
        """Free a tenant's slot (slot recycling): the row is zeroed back
        to a dead mesh for the next renter."""
        key, i = self._where.pop(tenant)
        b = self.buckets[key]
        if b.slots[i].loaded:
            b.zero_row(i)
        b.slots[i] = Slot()

    @staticmethod
    def bucket_label(key: tuple) -> str:
        """Report/metric spelling of a bucket key: ``capPxcapT`` plus a
        metric-width suffix, so scalar- and tensor-metric buckets of
        equal caps never share a report or gauge key."""
        return f"{key[0]}x{key[1]}" + (f"m{key[2]}" if key[2] else "")

    def labels(self) -> dict:
        """{report label: bucket key}: the autoscale actuator's map from
        metric-series bucket names back to pool buckets."""
        return {self.bucket_label(k): k for k in self.buckets}

    def occupancy(self) -> dict:
        return {self.bucket_label(k): b.occupancy()
                for k, b in sorted(self.buckets.items())}

    def resize_bucket(self, key: tuple, nslots: int) -> int:
        """Autoscale actuator: grow or shrink one bucket's slot count.

        Growth appends dead all-zero rows; shrink drops trailing free
        slots only (never evicts or renumbers a tenant: ``_where`` holds
        live slot indices), so the result may stay larger than asked.
        Dispatches gather [chunk, ...] row slices, never the whole array,
        so a resize changes no dispatch shape.  Returns the new slot
        count."""
        b = self.buckets[key]
        want = max(1, int(nslots))
        if want > b.nslots:
            add = want - b.nslots
            b.slots.extend(Slot() for _ in range(add))
            b.map_state(lambda a: torch.cat([a, _zeros_like_rows(a, add)]))
            b.nslots = want
        elif want < b.nslots:
            keep = b.nslots
            while keep > want and b.slots[keep - 1].tenant is None:
                keep -= 1
            if keep < b.nslots:
                b.slots = b.slots[:keep]
                b.map_state(lambda a: a[:keep].clone())
                b.nslots = keep
        return b.nslots

    def active_tenants(self) -> list[str]:
        return [t for t, (k, i) in self._where.items()
                if self.buckets[k].slots[i].loaded
                and not self.buckets[k].slots[i].converged
                and not self.buckets[k].slots[i].failed]

    def slot_of(self, tenant: str) -> Slot:
        key, i = self._where[tenant]
        return self.buckets[key].slots[i]

    # ---- mesh attach / detach --------------------------------------------
    def load(self, tenant: str, mesh, met) -> None:
        """Split the tenant mesh into its slot (a one-part
        ``split_to_shards`` on the mesh's device, as the standalone pass
        splits) and write the row into the bucket's host state."""
        from ..parallel.distribute import split_to_shards

        key, i = self._where[tenant]
        b = self.buckets[key]
        ntet = int(mesh.tmask.sum())
        stacked1, met1 = split_to_shards(mesh, met,
                                         np.zeros(ntet, np.int32), 1,
                                         cap_mult=self.cap_mult)
        if stacked1.capP != b.capP or stacked1.capT != b.capT:
            raise ValueError(
                f"tenant {tenant!r} split caps "
                f"{stacked1.capP}x{stacked1.capT} != "
                f"admitted bucket {b.capP}x{b.capT}")
        stacked1 = stacked1.map(lambda a: a.cpu())
        met1 = met1.cpu()
        if b.stacked is None:
            # the bucket's host state, from the first tenant's split as a
            # template; free rows all-zero dead meshes
            b.stacked = stacked1.map(lambda a: _zeros_like_rows(a,
                                                                b.nslots))
            b.met = _zeros_like_rows(met1, b.nslots)
        for f in MESH_FIELDS:
            getattr(b.stacked, f)[i] = getattr(stacked1, f)[0]
        b.met[i] = met1[0]
        if b.topo is not None:
            # no retained table may leak across tenants: zero = ok False
            # = a full rebuild at the first derivation
            for a in b.topo:
                a[i] = 0
        b.slots[i].loaded = True

    def slot_state(self, tenant: str):
        """(bucket, slot index): the raw stacked row, for the merge-free
        writer (``driver.write_distributed``)."""
        key, i = self._where[tenant]
        return self.buckets[key], i

    def merge(self, tenant: str):
        """The tenant's slot merged back to one Mesh + met on the pool's
        device (the ``merge_shards`` call grouped_adapt_pass makes)."""
        from ..parallel.distribute import merge_shards
        b, i = self.slot_state(tenant)
        return merge_shards(b.stacked.map(lambda a: a[i:i + 1]),
                            b.met[i:i + 1], device=self.device)

    # ---- fault isolation ---------------------------------------------------
    def _note_slot_fault(self, s: Slot, exc) -> bool:
        """Account one slot-dispatch fault.  Returns True when the tenant
        just reached ``max_slot_retries`` and is quarantined (terminal
        FAILED).  Below that the slot stays at its cycle index and is
        dispatched again next step; its rows are untouched (the pipeline
        writes back only after a plan ran), so the retry is exact."""
        from ..obs import trace as otrace
        from ..obs.metrics import REGISTRY
        s.faults += 1
        REGISTRY.counter("serve.slot_faults").inc()
        if s.tenant is not None:
            REGISTRY.counter("serve.slot_faults", tenant=s.tenant).inc()
        if s.faults >= self.max_slot_retries:
            s.failed = (f"quarantined after {s.faults} slot fault(s): "
                        + repr(exc)[:200])
            self.quarantined.append(s.tenant)
            REGISTRY.counter("serve.quarantined").inc()
            otrace.event("serve.quarantine", tenant=s.tenant,
                         faults=s.faults, detail=repr(exc)[:300])
            otrace.log(1, f"serve: QUARANTINED {s.tenant} after "
                          f"{s.faults} slot fault(s)", err=True)
            return True
        otrace.event("serve.slot_fault", tenant=s.tenant,
                     faults=s.faults, detail=repr(exc)[:300])
        return False

    def _count_dispatches(self, n: int) -> None:
        from ..obs.metrics import REGISTRY
        self.dispatches += n
        REGISTRY.counter("serve.dispatches").inc(n)

    def _pipeline(self, b: Bucket, fn, wave: int, plans, done=None):
        from ..parallel.groups import _pipeline_chunks
        parts = _pipeline_chunks(fn, b.stacked, b.met, wave, plans,
                                 self.timers, self.device, False, b.topo,
                                 done=done)
        self._count_dispatches(len(plans))
        return parts

    def _dispatch_cohort(self, b: Bucket, fn, wave: int, ids,
                         done) -> list:
        """Dispatch one cohort with per-tenant fault isolation.

        Fast path: the compacted multi-slot dispatches.  If one faults
        (a failed launch, or ``serve.slot_step`` armed with a tenant's
        key), the cohort falls back to one dispatch a slot, so the
        faulting tenant never aborts its mates: a one-slot plan pads to
        the same [chunk, ...] dispatch (``chunk_plans``) and slots are run
        one after another, so the mates' results are the bytes of the
        packed dispatch.  Plans whose writeback already ran in the fast
        path (``_pipeline_chunks``' ``done``) keep their results: their
        slots advanced, and running them again would apply the block
        twice.  Returns [(slot index, counts [nblk, 9])] for the slots
        that ran; a faulting slot is accounted by
        :meth:`_note_slot_fault` (retried next step, or quarantined into
        ``done``)."""
        from ..obs import trace as otrace
        from ..obs.metrics import REGISTRY
        from ..ops.topo_incr import topo_init
        from ..parallel.sched import chunk_plans
        from ..resilience.faults import FAULTS, faultpoint
        plans = chunk_plans(np.asarray(ids), self.chunk)
        if b.topo is None:
            b.topo = topo_init(b.capT, stack=b.nslots)
        committed: dict = {}
        try:
            if FAULTS.armed():
                for i in ids:
                    faultpoint("serve.slot_step", key=b.slots[i].tenant)
            parts = self._pipeline(b, fn, wave, plans, done=committed)
            return list(zip(ids, np.concatenate(parts)))
        except Exception as e:
            REGISTRY.counter("resilience.serve_cohort_faults").inc()
            otrace.event("serve.cohort_fault", detail=repr(e)[:300])
        out = []
        for pi, (idx, nreal) in enumerate(plans):
            rows = [int(v) for v in idx[:nreal]]
            if pi in committed:
                self._count_dispatches(1)
                out.extend(zip(rows, committed[pi]))
                continue
            for i in rows:
                s = b.slots[i]
                try:
                    faultpoint("serve.slot_step", key=s.tenant)
                    parts1 = self._pipeline(
                        b, fn, wave, chunk_plans(np.asarray([i]),
                                                 self.chunk))
                    out.append((i, np.concatenate(parts1)[0]))
                except Exception as e:
                    if self._note_slot_fault(s, e):
                        done.append(s.tenant)
        return out

    # ---- the serving step -------------------------------------------------
    def _grow_tenant(self, tenant: str) -> None:
        """Promote an overflowed tenant to the (2*capP, 2*capT) bucket,
        padded as ``distribute.grow_shards`` pads (slot ids kept, adja -1
        on the new rows), and re-rent a slot there.  Raises MemoryError
        past the regrow limit: the caller fails the tenant, not the
        pool."""
        from ..parallel.distribute import grow_shards
        key, i = self._where[tenant]
        b = self.buckets[key]
        s = b.slots[i]
        if s.regrows >= MAX_REGROWS:
            raise MemoryError(f"tenant {tenant!r}: slot capacity "
                              f"exhausted after {MAX_REGROWS} regrows")
        row, met_row = grow_shards(b.stacked.map(lambda a: a[i:i + 1]),
                                   b.met[i:i + 1], 2 * b.capP, 2 * b.capT)
        nkey = (2 * b.capP, 2 * b.capT, key[2])
        nb = self.buckets.get(nkey)
        if nb is None:
            nb = self.buckets[nkey] = Bucket(2 * b.capP, 2 * b.capT,
                                             self.slots_per_bucket)
        j = nb.free_slot()
        if j is None:
            # a full promotion bucket grows by one slot rather than
            # deadlocking the overflowed tenant (it already paid its
            # block; queueing it cannot make progress)
            self.resize_bucket(nkey, nb.nslots + 1)
            j = nb.nslots - 1
        if nb.stacked is None:
            nb.stacked = row.map(lambda a: _zeros_like_rows(a, nb.nslots))
            nb.met = _zeros_like_rows(met_row, nb.nslots)
        for f in MESH_FIELDS:
            getattr(nb.stacked, f)[j] = getattr(row, f)[0]
        nb.met[j] = met_row[0]
        if nb.topo is not None:
            # retained tables do not carry across capacity rungs
            for a in nb.topo:
                a[j] = 0
        # hand the slot over: bookkeeping moves, the old slot recycles
        nb.slots[j] = dataclasses.replace(s, regrows=s.regrows + 1)
        b.zero_row(i)
        b.slots[i] = Slot()
        self._where[tenant] = (nkey, j)
        self.regrows += 1
        if s.stats is not None:
            s.stats.regrows += 1

    def step(self, verbose: int = 0, on_retire=None) -> list[str]:
        """Advance every active tenant by one cycle block.  Returns the
        tenants that reached a terminal state (converged/failed) this
        step.

        Slots of one bucket at the same cycle index share (flags, pres,
        wave) and ride compacted [chunk, ...] dispatches of the grouped
        path's block.

        ``on_retire`` (streaming admission, serve/admission.py): called
        with each cohort's newly retired tenants as they retire, while
        the step is in flight.  It may release slots and admit and load
        queued tenants into them; the step then re-scans for tenants it
        has not dispatched yet and picks the re-rented slots up at their
        own cycle 0.  Each tenant dispatches at most once a step (a
        promoted tenant reruns its block next step).  When a tenant is
        admitted never changes what it computes: its block sequence is a
        function of its own cycle index alone (``groups.block_schedule``)
        and slots run independently."""
        from ..obs import trace as otrace
        from ..obs.metrics import REGISTRY
        from ..ops.adapt import default_cycle_block
        from ..parallel.groups import (_group_block, block_converged,
                                       block_schedule)

        self.steps += 1
        done: list[str] = []
        block = default_cycle_block(self.device)
        stepped: set[str] = set()       # tenants dispatched this step
        while True:
            progressed = False
            # sorted() snapshots the key list: a regrow or a streaming
            # re-rent may add buckets mid-scan (picked up on re-scan)
            for key in sorted(self.buckets):
                b = self.buckets[key]
                occ, nslots = b.occupancy()
                label = self.bucket_label(key)
                REGISTRY.gauge(f"serve.occupancy.{label}").set(occ)
                REGISTRY.gauge(f"serve.slots.{label}").set(nslots)
                act = [(i, s) for i, s in enumerate(b.slots)
                       if s.tenant is not None and s.loaded
                       and not s.converged and not s.failed
                       and s.tenant not in stepped]
                if not act:
                    continue
                self.active_per_step.append(len(act))
                cohorts: dict[int, list[int]] = {}
                for i, s in act:
                    cohorts.setdefault(s.c, []).append(i)
                for c in sorted(cohorts):
                    ids = cohorts[c]
                    n_done0 = len(done)
                    nblk = min(block, self.cycles - c)
                    flags, pres = block_schedule(c, nblk, self.cycles,
                                                 False)
                    fn = _group_block(flags, pres, False, False, None)
                    stepped.update(b.slots[i].tenant for i in ids)
                    progressed = True
                    rows = self._dispatch_cohort(b, fn, c, ids, done)
                    for i, crow in rows:
                        s = b.slots[i]
                        cs = crow.astype(np.int64)           # [nblk, 9]
                        st = s.stats
                        for ib in range(nblk):
                            st.nsplit += int(cs[ib][0])
                            st.ncollapse += int(cs[ib][1])
                            st.nswap += int(cs[ib][2])
                            st.nmoved += int(cs[ib][3])
                            st.cycles += 1
                        st.group_dispatches += 1
                        st.sched_extra.setdefault(
                            "ops_per_block", []).append(
                            int(cs[:, :4].sum()))
                        if int(cs[:, 4].max()) != 0:
                            # batch regrow semantics: promote the
                            # post-run state, rerun the same block next
                            # step
                            try:
                                self._grow_tenant(s.tenant)
                            except MemoryError as e:
                                s.failed = str(e)
                                done.append(s.tenant)
                            continue
                        s.c = c + nblk
                        if block_converged(cs, flags, False) \
                                or s.c >= self.cycles:
                            s.converged = True
                            done.append(s.tenant)
                    otrace.log(2, f"  serve step {self.steps} bucket "
                                  f"{key[0]}x{key[1]} c{c}: {len(ids)} "
                                  f"tenants, {len(rows)} dispatched",
                               verbose=verbose, err=True)
                    if on_retire is not None and len(done) > n_done0:
                        # mid-step retirement hook: slots freed by this
                        # cohort may be re-rented before the step ends
                        on_retire(done[n_done0:])
            if on_retire is None or not progressed:
                break
        return done

    def run_to_completion(self, max_steps: int = 1000) -> list[str]:
        """Drive step() until no tenant is active (pool-only loop; the
        request-queue front end is serve/driver.py)."""
        out = []
        for _ in range(max_steps):
            if not self.active_tenants():
                break
            out.extend(self.step())
        return out

    def chunk_recommendation(self) -> int:
        """The chunk the grouped path's cost model
        (``sched.recommend_group_chunk``) recommends for this pool's
        active-slot trajectory."""
        from ..parallel.sched import recommend_group_chunk
        return recommend_group_chunk(self.active_per_step,
                                     self.slots_per_bucket)
