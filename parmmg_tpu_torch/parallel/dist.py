"""Distributed adaptation on shard stacks (port of ``parallel/dist.py``).

ParMmg runs one MPI rank per subdomain with frozen interfaces, Sendrecv
exchanges and ``MPI_Allreduce`` phase agreement (libparmmg1.c:812-912);
the JAX package runs one shard a device under ``shard_map``, or ``G``
logical shards a device serialised by ``lax.map``, with the agreement as
a ``psum`` / ``pmax`` over the shard axis, and several
``jax.distributed`` processes over the devices of a pod.  The port runs
``-ndev N`` logical shards over the P ranks of a ``torch.distributed``
group (``parallel/multihost.py``; P = 1 without one): each rank holds its
G = N / P consecutive shards as one
:class:`~parmmg_tpu_torch.core.mesh.MeshStack` on its own device and runs
the block's cycles shard after shard.  Each collective becomes an
operation on the stack's leading axis and, across ranks, one collective
of ``multihost``: the ``psum`` / ``pmax`` of the block counters a sum /
max over the rank's shards (one host read a block) and one gather of the
ranks' sums, the ``all_to_all`` of the halo exchange the ranks' packed
send rows gathered (``comms.py``), the band tables of every host stage
one ``pod.gather_band``.  Every host decision is taken on every rank from
tables every rank holds whole (the comm tables, the numbering mirror, the
agreed counters), so the ranks run the same sequence of collectives and a
P-rank run writes the bytes of the one-process run.

During shard-local adaptation the interfaces are frozen (MG_PARBDY tags
set by ``distribute.split_to_shards``), so no exchange is needed inside
the cycles.  A run: split along a metric-weighted partition, build the
communicators and check them by a coordinate + metric echo, then a pass
an iteration: the adapt cycles in blocks (:func:`run_adapt_cycles`: the
swap cadence, the quiet levels a shard, the slot-stable regrow), the
global numbering extended for the new vertices, the cross-shard analysis
refresh on the device (``analysis_dev.py``; the host ``analysis_par``
path on a budget overflow), and between two passes the repartitioning:
flood labels (or graph labels) -> band migration -> weld -> adjacency
rebuild -> echo (``migrate.py`` / ``migrate_dev.py``, with the full-view
path as the fallback of a blown band budget), then, with
``PMTORCH_MH_HANDOFF=1``, the group handoff between ranks (``pod.py``);
a pass checkpoint after each pass with a checkpoint tag
(``resilience/checkpoint.save_dist_checkpoint``; ``resume`` re-enters
after the newest); then one merge.  ``-nobalance`` runs the passes on the
resident shards with no repartitioning between them.  The paths that
need every shard's whole state on one host (the host analysis, the
full-region weld, the full-view migration) raise on a several-process
run (``multihost.require_single_process``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.mesh import MeshStack
from ..obs import trace as otrace
from ..utils.compilecache import bucket, governed

MAX_SHARD_REGROWS = 6

# sched.py's quiet ladder: a shard at or above a block's skip level sits
# the block out (LEVEL_PRE = 1 proven under a prescreened block,
# LEVEL_FULL = 2 once a cycle ran with the prescreen off)
_LEVEL_PRE, _LEVEL_FULL = 1, 2


class ShardOverflowError(RuntimeError):
    """Shard capacity exhausted after MAX_SHARD_REGROWS doublings.

    Carries the last CONFORMING merged state so the caller can degrade
    to PMMG_LOWFAILURE and still save a valid mesh — the reference's
    failed_handling contract (libparmmg1.c:974-1011)."""

    def __init__(self, mesh, met, part):
        super().__init__("shard capacity overflow")
        self.mesh = mesh
        self.met = met
        self.part = part


def dist_adapt_block(swap_flags: tuple, do_smooth: bool = True,
                     do_insert: bool = True, hausd: float | None = None,
                     pre_flags: tuple | None = None,
                     swap_inclusive: bool | None = None):
    """The fused cycle block of the distributed pass: ``len(swap_flags)``
    adapt cycles on every shard of the stack, shard after shard (the JAX
    package's ``lax.map`` over the logical shards of a device; its ``G``
    layout argument has no role on one device), each
    cycle ``adapt_cycle_impl`` with two smoothing waves, wave index
    ``wave0 + c``, the closing adjacency only on the block's last cycle.

    Returns fn(stacked, met_s, wave0, quiet_lvl [L] int8 numpy) ->
      (stacked, met_s, counts [n][4] (summed over the shards),
       active [n] (shards posting split+collapse+swap > 0 a cycle),
       overflow (max over the shards), quiet_lvl').

    The quiet levels: a shard whose level is at or above this block's
    skip level (1 under an all-prescreened block, 2 once a prescreen-off
    cycle ran) sits the block out — its cycles return their input with
    zero counts — and a swap-inclusive block (``any(flags) or noswap``
    from a ``-noswap`` caller) posting zero split + collapse + swap +
    move + overflow for a shard raises its level to the skip level (the
    frozen-seam + deterministic-wave fixed-point argument of
    ``sched.py``).  The counters of every shard come off the device in
    one read a block; the levels are derived from them on the host."""
    from ..ops.adapt import adapt_cycle_impl
    from ..resilience.watchdog import progress
    if pre_flags is None:
        pre_flags = (True,) * len(swap_flags)
    if swap_inclusive is None:
        swap_inclusive = any(swap_flags)
    skip_lvl = _LEVEL_PRE if all(pre_flags) else _LEVEL_FULL
    nblk = len(swap_flags)

    @governed("dist.adapt_block")
    def run(stacked: MeshStack, met_s, wave0: int, lvl):
        act_in = np.asarray(lvl) < skip_lvl
        meshes, mets, rows = [], [], []
        for g in range(stacked.ngroups):
            m, k = stacked.slot(g), met_s[g]
            cs = []
            for c, dosw in enumerate(swap_flags):
                with otrace.scope(f"dist_cycle{c}"):
                    m, k, cnt = adapt_cycle_impl(
                        m, k, wave0 + c, do_swap=dosw, do_smooth=do_smooth,
                        do_insert=do_insert, smooth_waves=2, hausd=hausd,
                        final_rebuild=(c == nblk - 1),
                        prescreen=pre_flags[c], active=bool(act_in[g]))
                progress()
                cs.append(cnt)
            meshes.append(m)
            mets.append(k)
            rows.append(torch.stack(cs))
        # the one host read of the block: every shard's counters
        cs_g = np.asarray(torch.stack(rows).tolist(), np.int64)  # [L,n,8]
        lvl = np.asarray(lvl, np.int8).copy()
        if swap_inclusive:
            blk_zero = cs_g[:, :, :5].reshape(len(cs_g), -1).sum(1) == 0
            lvl = np.maximum(lvl, np.where(blk_zero, skip_lvl, 0)
                             ).astype(np.int8)
        counts, nact, ovf = _agree_block(cs_g)
        return (MeshStack.stack(meshes), torch.stack(mets), counts, nact,
                ovf, lvl)

    return run


def _agree_block(cs_g):
    """The block's agreed counters from this rank's [L, n, 8] shard
    counters: (counts [n][4] summed over every shard of the run, active
    shards [n], overflow (max)) — one gather of the ranks' sums."""
    from .multihost import all_gather_rows
    n = cs_g.shape[1]
    mine = np.concatenate([cs_g[:, :, :4].sum(axis=0).reshape(-1),
                           (cs_g[:, :, :3].sum(axis=2) > 0).sum(axis=0),
                           [cs_g[:, :, 4].max(initial=0)]])
    (allv,) = all_gather_rows(torch.as_tensor(mine[None], dtype=torch.int64))
    allv = allv.numpy()
    counts = allv[:, :4 * n].sum(axis=0).reshape(n, 4).tolist()
    nact = allv[:, 4 * n:5 * n].sum(axis=0).tolist()
    return counts, nact, int(allv[:, -1].max())


class DistSteps:
    """Per-driver-invocation cache of the block programs keyed by the
    (swap, prescreen, swap-inclusive) flag tuples."""

    def __init__(self, do_smooth: bool = True, do_insert: bool = True,
                 hausd: float | None = None):
        self.kw = dict(do_smooth=do_smooth, do_insert=do_insert,
                       hausd=hausd)
        self._cache: dict = {}

    def get(self, flags: tuple, pre_flags: tuple | None = None,
            swap_inclusive: bool | None = None):
        flags = tuple(bool(f) for f in flags)
        if pre_flags is None:
            pre_flags = (True,) * len(flags)
        pre_flags = tuple(bool(f) for f in pre_flags)
        if swap_inclusive is None:
            swap_inclusive = any(flags)
        key = (flags, pre_flags, bool(swap_inclusive))
        if key not in self._cache:
            self._cache[key] = dist_adapt_block(
                flags, pre_flags=pre_flags, swap_inclusive=swap_inclusive,
                **self.kw)
        return self._cache[key]


def dist_interface_check():
    """The interface echo (PMMG_check_extNodeComm): every shard sends its
    interface vertices' coordinates + metric through the halo exchange
    and compares them with its own copy; the mismatch count over every
    shard must be zero.

    Returns fn(stacked, met_s, node_idx [S,K,I], nbr [S,K], tol) ->
    mismatch count of this rank's shards (0-d tensor)."""
    from . import pod
    from .comms import halo_exchange

    def fn(stacked, met_s, node_idx, nbr, tol):
        met_g = met_s[..., None] if met_s.dim() == 2 else met_s
        vals = torch.cat([stacked.vert, met_g.to(stacked.vert.dtype)],
                         dim=-1)                          # [L, capP, 3+m]
        recv = halo_exchange(vals, node_idx, nbr)
        L = vals.shape[0]
        capP = stacked.capP
        node_idx = node_idx[pod.row0():pod.row0() + L]
        lix = torch.arange(L, device=vals.device).view(L, 1, 1).expand_as(
            node_idx)
        mine = vals[lix, node_idx.clamp(0, capP - 1).long()]
        valid = (node_idx >= 0)[..., None]
        bad = valid & ((recv - torch.where(valid, mine, 0.0)).abs() > tol)
        return bad.sum(dtype=torch.int32)
    return fn


def _on(device, a):
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def check_interface_echo(stacked, met_s, comms, vert_h):
    """The interface coordinate + metric echo of the comm tables (the
    chkcomm guard, chkcomm_pmmg.c:815 role) at tolerance 1e-6 x the input
    bounding-box diagonal; raises on an ordering-contract violation.
    Returns the mismatch count over every shard (0)."""
    from .multihost import all_reduce
    chk = governed("dist.interface_check", budget=2)(dist_interface_check())
    diag = float(np.linalg.norm(vert_h.max(0) - vert_h.min(0))) \
        if len(vert_h) else 1.0
    dev = stacked.device
    nbad = int(all_reduce(chk(
        stacked, met_s, _on(dev, comms.node_idx), _on(dev, comms.nbr),
        torch.tensor(1e-6 * diag, dtype=stacked.vert.dtype, device=dev))))
    if nbad:
        raise RuntimeError(
            f"interface comm echo mismatch: {nbad} items "
            "(ordering contract violated)")
    return nbad


def refresh_shard_analysis_device(stacked, comms, n_shards: int,
                                  angedg: float, glo,
                                  cache: dict | None = None):
    """The device analysis refresh (``analysis_dev.py``), keyed by the
    persistent global numbering ``glo``.

    Returns the updated stacked mesh, or None when the shared-record
    budget overflowed on some shard, the int32 id range is exhausted or
    the ``analysis.ks_overflow`` fault fires (the caller then takes the
    host path) — never a silent truncation.  Any error raised inside the
    program (a kernel's, CUDA's) propagates."""
    from ..resilience.faults import fault_trigger
    if fault_trigger("analysis.ks_overflow"):
        return None
    from . import pod
    from .analysis_dev import dist_analysis
    from .multihost import all_reduce
    if max(int(np.asarray(g).max(initial=-1)) for g in glo) >= \
            np.iinfo(np.int32).max:
        return None                      # int32 id budget exhausted
    glo_np = np.stack([np.asarray(g) for g in pod.local(glo)])
    capT = stacked.capT
    # bucketed shared-record budget (the JAX package's compile governor
    # keys; the same budget here gives the same overflow decisions)
    KS = bucket(max(1024, 4 * comms.node_idx[0].size), floor=1024,
                cap=12 * capT, scheme="pow2")
    key = (angedg, KS)
    fn = cache.get(key) if cache is not None else None
    if fn is None:
        fn = governed("dist.analysis", budget=2)(dist_analysis(angedg, KS))
        if cache is not None:
            cache[key] = fn
    dev = stacked.device
    vt, et, ovf = fn(stacked, _on(dev, glo_np.astype(np.int32)),
                     _on(dev, comms.node_idx), _on(dev, comms.nbr))
    if bool(all_reduce(ovf, "max")):
        return None
    return dataclasses.replace(stacked, vtag=vt, etag=et)


def refresh_shard_analysis(stacked, comms, n_shards: int, angedg: float,
                           glo=None, views=None):
    """The host analysis refresh (the PMMG_update_analys analogue,
    analys_pmmg.c:1571): ridge / corner / reference classification
    recomputed with cross-interface dihedrals by
    ``analysis_par.analyze_shards`` on host copies of the shards, then
    written back into the stacked shard tags.  The fallback of the device
    refresh.  Interface slots are stable under adaptation (frozen
    entities are never collapsed and slots are not compacted in-cycle),
    so the split-time comm tables remain valid."""
    from ..core.constants import IARE, MG_BDY, MG_PARBDY
    from .analysis_dev import CLS
    from .analysis_par import analyze_shards, extend_numbering
    from .migrate import pull_views

    if views is None:
        views = pull_views(stacked, stacked.vert.new_zeros(
            stacked.vert.shape[:2]))
    capP = stacked.capP
    u32 = np.uint32
    verts, tets, ftags, frefs, tms = [], [], [], [], []
    for s in range(n_shards):
        tm = views.tmask[s]
        verts.append(views.vert[s])
        tets.append(views.tet[s][tm].astype(np.int64))
        ftags.append(views.ftag[s][tm].view(u32))
        frefs.append(views.fref[s][tm])
        tms.append(tm)
    if glo is None:
        glo = extend_numbering(comms, [capP] * n_shards)
    vtag_add, special_edges, _ = analyze_shards(
        verts, tets, ftags, frefs, comms, angedg, glo=glo)
    cls = u32(CLS)
    new_vtag, new_etag = [], []
    for s in range(n_shards):
        vt = views.vtag[s].view(u32).copy()
        add = vtag_add[s].astype(u32)
        # re-derive the classification bits; never drop freeze/user bits
        vt = (vt & ~cls) | (add & cls) | (add & u32(MG_BDY))
        new_vtag.append(vt)
        et = views.etag[s].view(u32).copy()
        tm = tms[s]
        tth = views.tet[s].astype(np.int64)
        evl = np.sort(tth[:, IARE], axis=2)[tm]            # [nt,6,2]
        live_rows = np.where(tm)[0]
        plain_bdy = ((et[tm] & MG_BDY) != 0) & ((et[tm] & MG_PARBDY) == 0)
        cleared = et[tm] & ~np.where(plain_bdy, cls, u32(0))
        rows = special_edges[s]
        if len(rows):
            ka = np.minimum(rows[:, 0], rows[:, 1]).astype(np.int64)
            kb = np.maximum(rows[:, 0], rows[:, 1]).astype(np.int64)
            skey = ka * capP + kb
            o = np.argsort(skey, kind="stable")
            sk, sb = skey[o], rows[:, 2][o].astype(u32)
            heads = np.concatenate([[True], sk[1:] != sk[:-1]])
            uk = sk[heads]
            ub = np.bitwise_or.reduceat(sb, np.where(heads)[0])
            ekey = evl[..., 0] * capP + evl[..., 1]        # [nt,6]
            loc = np.clip(np.searchsorted(uk, ekey), 0, len(uk) - 1)
            hit = uk[loc] == ekey
            cleared |= np.where(hit, ub[loc], 0).astype(u32)
        et[live_rows] = cleared
        new_etag.append(et)
    for s in range(n_shards):
        views.vtag[s] = new_vtag[s].view(np.int32)
        views.etag[s] = new_etag[s].view(np.int32)
    dev = stacked.device
    return dataclasses.replace(
        stacked, vtag=_on(dev, np.stack(new_vtag).view(np.int32)),
        etag=_on(dev, np.stack(new_etag).view(np.int32)))


def dist_quality():
    """The global quality histogram across shards (PMMG_qualhisto,
    quality_pmmg.c:156 — the custom MPI_Op reduction becomes a sum / min
    over the stack, then over the ranks).  Returns fn(stacked, met_s) ->
    (counts [5], qmin, qmean, nbad, ntot); the float sum of qmean adds
    the ranks' partial sums, so it may differ from one process's in the
    last bits."""
    from ..ops.quality import quality_histogram, tet_quality
    from .multihost import all_reduce

    @governed("dist.quality", budget=2)
    def fn(stacked, met_s):
        counts, qmins, qsum, nbad, ntot = [], [], 0.0, 0, 0
        for g in range(stacked.ngroups):
            m = stacked.slot(g)
            q = tet_quality(m, met_s[g])
            c, qmin, qmean, nb = quality_histogram(q, m.tmask)
            n = m.tmask.sum(dtype=torch.int32)
            counts.append(c)
            qmins.append(qmin)
            qsum = qsum + qmean * n
            nbad = nbad + nb
            ntot = ntot + n
        counts = all_reduce(torch.stack(counts).sum(0))
        qmin = all_reduce(torch.stack(qmins).min(), "min")
        qsum = all_reduce(torch.as_tensor(qsum), "sum")
        nbad = all_reduce(torch.as_tensor(nbad), "sum")
        ntot = all_reduce(torch.as_tensor(ntot), "sum")
        return counts, qmin, qsum / torch.clamp(ntot, min=1), nbad, ntot
    return fn


def run_adapt_cycles(stacked, met_s, steps: DistSteps, cycles, stats=None,
                     verbose=0, on_grow=None, regrow_state=None,
                     label="dist", noswap=False, block=None):
    """The cycle loop of a pass: swaps every 3rd cycle and on the final
    two (which also run with the split's prescreen off), the blocks'
    summed counters into ``stats``, the quiet levels a shard carried
    from block to block, and the in-place overflow regrow
    (zaldy_pmmg.c:140-254 analogue — slot ids preserved so the comm
    tables stay valid).  Past MAX_SHARD_REGROWS doublings it raises a
    ShardOverflowError carrying the merged conforming state
    (failed_handling, libparmmg1.c:974-1011).  A swap-inclusive (or
    noswap) cycle on which no shard posted a topological op ends the
    pass.

    Cycles run in blocks of ``block`` (default
    ``ops.adapt.default_cycle_block``: 9 on the card, 1 on the CPU).
    ``on_grow(old_capP)`` grows the caller's side tables (the global
    numbering) in lockstep; ``regrow_state`` is a 1-element list carried
    across passes so they share the regrow budget."""
    from ..ops.adapt import default_cycle_block
    from ..resilience.watchdog import beat
    from . import pod
    from .distribute import grow_shards
    if regrow_state is None:
        regrow_state = [0]
    if block is None:
        block = default_cycle_block(stacked.device)
    n_logical = stacked.ngroups
    lvl = np.zeros(n_logical, np.int8)
    c = 0
    while c < cycles:
        nblk = min(block, cycles - c)
        flags = tuple((cc % 3 == 2 or cc >= cycles - 2) and not noswap
                      for cc in range(c, c + nblk))
        pres = tuple(cc < cycles - 2 for cc in range(c, c + nblk))
        step = steps.get(flags, pres, swap_inclusive=any(flags) or noswap)
        beat()                  # the pod runner's lease: a block is alive
        stacked, met_s, ca, na, ovf, lvl = step(stacked, met_s, c, lvl)
        for i in range(nblk):
            cs = ca[i]
            if stats is not None:
                stats.nsplit += cs[0]
                stats.ncollapse += cs[1]
                stats.nswap += cs[2]
                stats.nmoved += cs[3]
                stats.cycles += 1
                stats.sched_extra.setdefault(
                    "active_shards_per_cycle", []).append(na[i])
            otrace.log(3, f"  {label} cycle {c + i}: split {cs[0]} "
                          f"collapse {cs[1]} swap {cs[2]} move {cs[3]} "
                          f"active {na[i]}/{pod.n_global(n_logical)} grp",
                       verbose=verbose)
        if ovf:
            if regrow_state[0] >= MAX_SHARD_REGROWS:
                m_, k_, p_ = merge_all(stacked, met_s)
                raise ShardOverflowError(m_, k_, p_)
            capP, capT = stacked.capP, stacked.capT
            stacked, met_s = grow_shards(stacked, met_s, 2 * capP, 2 * capT)
            if on_grow is not None:
                on_grow(capP)
            regrow_state[0] += 1
            # every quiet proof is stale at the new capacity
            lvl = np.zeros(n_logical, np.int8)
            continue        # re-run the block: truncated winners rerun
        c += nblk
        if any((flags[i] or noswap) and na[i] == 0 for i in range(nblk)):
            break
    return stacked, met_s


def _partition(mesh, met, n_shards: int, partitioner: str, vert_h, tet_h):
    """The metric-weighted, boundary-refined partition of the input."""
    from .partition import (fix_contiguity, greedy_partition,
                            metric_edge_weights, morton_partition,
                            refine_partition)
    cent = vert_h[tet_h].mean(axis=1)
    if partitioner == "morton":
        part = morton_partition(cent, n_shards)
    else:
        part = greedy_partition(tet_h, cent, n_shards)
    part = fix_contiguity(tet_h, part)
    # metric-aware cut refinement (PMMG_computeWgt role, metis_pmmg.c:280)
    methost = met.cpu().numpy()[mesh.vmask.cpu().numpy()]
    wd = metric_edge_weights(tet_h, vert_h, methost)
    return fix_contiguity(tet_h, refine_partition(
        part, n_shards, wd["pairs"], wd["w"]))


def _split_with_comms(mesh, met, part, n_shards: int, nvert: int, tet_h):
    """Split along ``part`` (this rank's shards only, ``pod.current``) and
    build the communicators of every shard: (stacked, met_s, l2g of every
    shard, comms)."""
    from . import pod
    from .comms import build_interface_comms
    from .distribute import split_to_shards
    ctx = pod.current()
    rows = None if ctx is None or not ctx.multi() else ctx.rows()
    stacked, met_s, l2g = split_to_shards(mesh, met, part, n_shards,
                                          cap_mult=3.0, return_l2g=True,
                                          rows=rows)
    g2l = []
    for s_ in range(n_shards):
        mmap = np.full(nvert, -1, np.int64)
        mmap[l2g[s_]] = np.arange(len(l2g[s_]))
        g2l.append(mmap)
    comms = build_interface_comms(tet_h, part, n_shards, l2g, g2l)
    return stacked, met_s, l2g, comms


def _refresh(stacked, comms, n_shards: int, ang: float, glo, cache=None):
    """The device refresh, or the host path (ladder rung
    ``host_analysis``) when it reports an overflow; on a several-process
    run the host path raises instead."""
    st2 = refresh_shard_analysis_device(stacked, comms, n_shards, ang, glo,
                                        cache=cache)
    if st2 is not None:
        return st2
    from ..resilience.recover import ladder_step
    from .multihost import require_single_process
    require_single_process("the host analysis refresh (a shared-record "
                           "budget overflow)")
    ladder_step("host_analysis", site="analysis.ks_overflow")
    return refresh_shard_analysis(stacked, comms, n_shards, ang, glo=glo)


def merge_all(stacked, met_s):
    """The merged mesh of every shard, on every rank: (mesh, met,
    part_of_merged).  Across processes the ranks' shards are gathered
    first (``multihost.pull_host`` under ``cold_io``: the one designed
    whole-state replication of a run, counted on ``mh.allgather_bytes``,
    never on the hot counter)."""
    from ..core.mesh import MESH_FIELDS
    from .distribute import merge_shards
    from .multihost import cold_io, is_multiprocess, pull_host
    if not is_multiprocess():
        return merge_shards(stacked, met_s, return_part=True)
    with cold_io():
        full = MeshStack(**{f: torch.from_numpy(pull_host(
            getattr(stacked, f), what="merge")) for f in MESH_FIELDS})
        met_full = torch.from_numpy(pull_host(met_s, what="merge"))
    return merge_shards(full, met_full, return_part=True,
                        device=stacked.device)


def distributed_adapt(mesh, met, n_shards: int, cycles: int = 10,
                      partitioner: str = "morton", verbose: int = 0,
                      part: np.ndarray | None = None, stats=None,
                      noinsert: bool = False, noswap: bool = False,
                      nomove: bool = False, angedg: float | None = None,
                      hausd: float | None = None,
                      block: int | None = None):
    """One outer remesh pass on ``n_shards`` shards: partition (or the
    caller's ``part``) -> freeze interfaces -> interface echo -> adapt
    cycles -> analysis refresh (numbering from the split-time comm
    tables) -> merge.  Returns (merged mesh, met, part_of_merged): the
    source shard of every merged tet.  Single-process, as in the JAX
    package (:func:`distributed_adapt_multi` runs several)."""
    from ..core.constants import ANGEDG
    from ..core.mesh import mesh_to_host
    from .analysis_par import extend_numbering
    from .distribute import merge_shards
    from .multihost import require_single_process
    require_single_process("distributed_adapt (one pass)")
    vert_h, tet_h, _, _, _ = mesh_to_host(mesh)
    if part is None:
        part = _partition(mesh, met, n_shards, partitioner, vert_h, tet_h)
    stacked, met_s, _, comms = _split_with_comms(mesh, met, part, n_shards,
                                                 len(vert_h), tet_h)
    check_interface_echo(stacked, met_s, comms, vert_h)
    steps = DistSteps(do_smooth=not nomove, do_insert=not noinsert,
                      hausd=hausd)
    stacked, met_s = run_adapt_cycles(stacked, met_s, steps, cycles,
                                      stats=stats, verbose=verbose,
                                      noswap=noswap, block=block)
    ang = ANGEDG if angedg is None else angedg
    glo = extend_numbering(comms, [stacked.capP] * n_shards)
    stacked = _refresh(stacked, comms, n_shards, ang, glo)
    return merge_shards(stacked, met_s, return_part=True)


@otrace.profile_guard(clear_pass=True)
def distributed_adapt_multi(mesh, met, n_shards: int, niter: int = 3,
                            cycles: int = 10, partitioner: str = "morton",
                            verbose: int = 0, stats=None,
                            noinsert: bool = False, noswap: bool = False,
                            nomove: bool = False,
                            angedg: float | None = None,
                            hausd: float | None = None,
                            ifc_layers: int = 2, nobalancing: bool = False,
                            part: np.ndarray | None = None,
                            mode: str = "ifc", n_devices: int | None = None,
                            block: int | None = None,
                            ckpt_tag: str | None = None,
                            resume: bool = False):
    """Shard-resident multi-pass adaptation (host driver): ONE split,
    then a pass per iteration

        adapt cycles (device) -> numbering extended (device, band-sized
        tables to the host mirror) -> analysis refresh (device) ->
        [between passes, unless ``nobalancing``] flood labels (``mode``
        "ifc", ``ifc_layers`` waves) or graph labels (``mode`` "graph")
        -> band migration -> weld -> adjacency rebuild -> echo
        [-> the group handoff, ``PMTORCH_MH_HANDOFF=1``]

    and ONE merge at the end (no whole-mesh merge between passes).
    Returns (merged mesh, met, part_of_merged), on every rank.

    The shards are spread over the ranks of the process group
    (``n_devices``: None or the rank count P; ``n_shards % P`` must be
    0), G = N / P a rank on the rank's device, the mesh's; every rank
    calls this with the same input.  A blown band budget first grows the
    shards (slot-stable, up to three times, the numbering, labels and
    depths grown in lockstep), then falls back to the full-view path,
    which logs itself and counts on ``dist.full_view_migrations``
    (single-process only).  ``block`` sets the cycles a block (default:
    the device's).  ``ckpt_tag`` checkpoints every pass under
    ``PMTORCH_CKPT_DIR`` (rank 0 writes); ``resume`` re-enters after the
    newest checkpoint of the same run, agreed across the ranks."""
    from ..core.constants import ANGEDG
    from ..core.mesh import mesh_to_host
    from ..obs.metrics import REGISTRY
    from . import multihost, pod
    from .distribute import grow_shards
    from .migrate import (apply_fresh_ids, enforce_ne_min,
                          extend_global_ids_from_vmask, flood_labels,
                          graph_repartition_labels, kill_glo_rows,
                          migrate_shards, pull_views, rebuild_shards,
                          weld_shard_bands)
    from .migrate_dev import (band_migrate_iteration, band_weld,
                              dead_glo_rows, extend_ids_device,
                              graph_repartition_labels_band,
                              repair_flood_labels, session_ids_fit)

    nproc = multihost.world_size()
    if n_devices is not None and n_devices != nproc:
        raise ValueError(
            f"n_devices={n_devices}: a distributed run spreads its shards "
            f"over the {nproc} rank(s) of the process group, one device a "
            "rank")
    if mode not in ("ifc", "graph"):
        raise ValueError(f"unknown repartitioning mode {mode!r}")
    dev = mesh.device
    ang = ANGEDG if angedg is None else angedg

    with pod.activate(n_shards):
        vert_h, tet_h, _, _, _ = mesh_to_host(mesh)
        if part is None:
            part = _partition(mesh, met, n_shards, partitioner, vert_h,
                              tet_h)
        stacked, met_s, l2g, comms = _split_with_comms(
            mesh, met, part, n_shards, len(vert_h), tet_h)
        capP0 = stacked.capP
        # persistent global vertex numbering of every shard, on every
        # rank: split-time ids, extended with fresh ids for adapt-created
        # vertices each pass (the PMMG_Compute_verticesGloNum role,
        # libparmmg.c:923)
        glo = [np.full(capP0, -1, np.int64) for _ in range(n_shards)]
        for s_ in range(n_shards):
            glo[s_][: len(l2g[s_])] = l2g[s_]
        top = len(vert_h)
        it0, ckpt_fp, restored = _resume_point(
            mesh, met, ckpt_tag, resume, n_shards, nproc, niter, cycles,
            mode, ifc_layers, noswap, noinsert, nomove, nobalancing,
            verbose, dev)
        regrow0, shared0 = 0, None
        if restored is not None:
            (stacked, met_s, glo, top, comms, regrow0,
             shared0) = restored

        check_interface_echo(stacked, met_s, comms, vert_h)
        steps = DistSteps(do_smooth=not nomove, do_insert=not noinsert,
                          hausd=hausd)

        def grow_glo(old_capP):
            # keep the numbering tables in lockstep with a regrow
            for s_ in range(n_shards):
                glo[s_] = np.concatenate(
                    [glo[s_], np.full(old_capP, -1, np.int64)])

        def device_glo():
            return torch.as_tensor(
                np.stack(pod.local(glo)).astype(np.int32), device=dev)

        use_band = True
        glo_d = device_glo()
        # initially-shared gids: the interface vertices of the initial
        # comms (a resumed run restores the set its checkpoint carried)
        shared_prev = shared0 if shared0 is not None else \
            _shared_gids(comms, glo, n_shards)
        regrow_state = [regrow0]
        ana_cache: dict = {}
        with multihost.hot_path():
            for it in range(it0, max(1, niter)):
                otrace.profile_pass_begin(it)
                otrace.set_context(**{"pass": it})
                capP_before = stacked.capP
                t_seg = time.perf_counter()
                stacked, met_s = run_adapt_cycles(
                    stacked, met_s, steps, cycles, stats=stats,
                    verbose=verbose, on_grow=grow_glo,
                    regrow_state=regrow_state, label=f"dist it {it}",
                    noswap=noswap, block=block)
                otrace.emit_span("dist.adapt", time.perf_counter() - t_seg)
                t_seg = time.perf_counter()
                # the session numbering: fresh ids for the new vertices
                # and the newly-dead rows, assigned on the device,
                # band-sized tables to the host mirror; the host path
                # from the liveness masks when a budget misses
                oke = False
                if use_band:
                    if stacked.capP != capP_before:
                        glo_d = device_glo()    # regrown: rebuild the copy
                    KN = max(256, stacked.capP // 2)
                    if session_ids_fit(top, n_shards, KN):
                        d_rows, d_cnt, d_ok = dead_glo_rows(
                            glo_d, stacked.vmask, KD=KN)
                        glo_d2, top_d, f_rows, f_gids, oke = \
                            extend_ids_device(glo_d, stacked.vmask, top,
                                              KN=KN)
                        oke = bool(oke) and bool(d_ok)
                if oke:
                    glo_d = glo_d2
                    top = int(top_d)
                    f_rows, f_gids, d_rows, d_cnt = pod.gather_band(
                        f_rows, f_gids, d_rows, d_cnt, what="extend")
                    apply_fresh_ids(glo, f_rows, f_gids)
                    kill_glo_rows(glo, d_rows, d_cnt)
                else:
                    # the metered escape hatch: the liveness masks of
                    # every shard (counted hot across processes)
                    vmask_h = multihost.pull_host(stacked.vmask,
                                                  what="host_extend")
                    top = extend_global_ids_from_vmask(glo, vmask_h, top)
                    if use_band:
                        if top >= 2 ** 31:
                            # the int32 device copy can no longer hold
                            # the ids: the host mirror (int64) carries
                            # them on
                            use_band = False
                            glo_d = None
                        else:
                            glo_d = device_glo()
                stacked = _refresh(stacked, comms, n_shards, ang, glo,
                                   cache=ana_cache)
                otrace.emit_span("dist.refresh",
                                 time.perf_counter() - t_seg)
                t_seg = time.perf_counter()
                if it + 1 < max(1, niter) and not nobalancing:
                    nmoved = 0
                    band_done = False
                    if use_band:
                        if mode == "graph":
                            # the cluster-graph rebalance from device
                            # tables; depth 0 everywhere (the donor floor
                            # still bounds the departures, and cluster
                            # moves have no order)
                            labels_d = graph_repartition_labels_band(
                                stacked, comms, n_shards, verbose=verbose)
                            depth_d = torch.zeros_like(stacked.tet[..., 0])
                            if labels_d is None:
                                labels_d = pod.shard_ids(
                                    stacked.ngroups, dev)[:, None].expand(
                                        stacked.tmask.shape).contiguous()
                        else:
                            (sizes,) = multihost.all_gather_rows(
                                stacked.tmask.sum(dim=1, dtype=torch.int32))
                            labels_d, depth_d = flood_labels(
                                stacked, comms.node_idx, comms.nbr, sizes,
                                n_shards, nlayers=ifc_layers)
                            # contiguity / reachability repair of the
                            # displaced partition
                            # (moveinterfaces_pmmg.c:475-720)
                            labels_d, _ = repair_flood_labels(
                                stacked, labels_d, depth_d, n_shards,
                                verbose=verbose)
                        res = band_migrate_iteration(
                            stacked, met_s, glo_d, glo, labels_d, depth_d,
                            shared_prev, n_shards, verbose=verbose)
                        # a blown budget: the slot-stable grow raises the
                        # free slots AND the capacity-scaled band budgets;
                        # bounded retries before the full-view fallback
                        for _retry in range(3):
                            if res is not None:
                                break
                            capP_o, capT_o = stacked.capP, stacked.capT
                            stacked, met_s = grow_shards(
                                stacked, met_s, 2 * capP_o, 2 * capT_o)
                            grow_glo(capP_o)
                            glo_d = device_glo()
                            me_col = pod.shard_ids(
                                stacked.ngroups, dev)[:, None].to(
                                    labels_d.dtype)
                            labels_d = torch.cat(
                                [labels_d, me_col.expand(stacked.ngroups,
                                                         capT_o)], dim=1)
                            depth_d = torch.cat(
                                [depth_d, torch.zeros_like(depth_d)], dim=1)
                            res = band_migrate_iteration(
                                stacked, met_s, glo_d, glo, labels_d,
                                depth_d, shared_prev, n_shards,
                                verbose=verbose)
                        if res is not None:
                            (stacked, met_s, glo_d, comms2, shared_prev,
                             nmoved, arr_slots) = res
                            band_done = True
                            if nmoved:
                                comms = comms2
                                # weld the arrival neighbourhoods
                                stacked, glo_d, nweld = band_weld(
                                    stacked, met_s, glo_d, glo, arr_slots,
                                    n_shards, verbose=verbose)
                                if nweld < 0:   # region budget blown
                                    multihost.require_single_process(
                                        "the full-region weld fallback")
                                    views_w = pull_views(stacked, met_s)
                                    stacked, _ = weld_shard_bands(
                                        stacked, views_w, glo, n_shards,
                                        verbose=verbose)
                                    # the full weld freed host rows; the
                                    # device copy drops them too
                                    glo_d = device_glo()
                                stacked = rebuild_shards(stacked)
                                check_interface_echo(stacked, met_s, comms,
                                                     vert_h)
                        else:
                            otrace.log(1, f"  it {it}: band budgets "
                                          "exceeded — falling back to the "
                                          "full-view path", verbose=verbose)
                    if not band_done:
                        multihost.require_single_process(
                            "the full-view migration fallback")
                        REGISTRY.counter("dist.full_view_migrations").inc()
                        otrace.event("dist.full_view_migration", it=it,
                                     band_path=use_band)
                        views = pull_views(stacked, met_s)
                        if mode == "graph":
                            labels = graph_repartition_labels(views, glo,
                                                              n_shards)
                            labels = enforce_ne_min(labels, views.tmask,
                                                    n_shards)
                        else:
                            sizes = torch.as_tensor(
                                views.tmask.sum(axis=1).astype(np.int32),
                                device=dev)
                            labels_d, depth_d = flood_labels(
                                stacked, comms.node_idx, comms.nbr, sizes,
                                n_shards, nlayers=ifc_layers)
                            labels_d, _ = repair_flood_labels(
                                stacked, labels_d, depth_d, n_shards,
                                verbose=verbose)
                            labels = enforce_ne_min(
                                labels_d.cpu().numpy(), views.tmask,
                                n_shards, depth=depth_d.cpu().numpy())
                        touched = sorted({int(r) for s_ in range(n_shards)
                                          for r in np.unique(
                                              labels[s_][views.tmask[s_]])
                                          if int(r) != s_})
                        stacked, met_s, comms2, nmoved = migrate_shards(
                            stacked, met_s, views, glo, labels, n_shards,
                            verbose=verbose)
                        if nmoved:
                            comms = comms2
                            stacked, _ = weld_shard_bands(
                                stacked, views, glo, n_shards,
                                touched=touched, verbose=verbose)
                            stacked = rebuild_shards(stacked)
                            check_interface_echo(stacked, met_s, comms,
                                                 vert_h)
                        if use_band:    # resync the device numbering copy
                            glo_d = device_glo()
                            shared_prev = _shared_gids(comms, glo, n_shards)
                    if nmoved:
                        otrace.log(2, f"  it {it}: migrated {nmoved} "
                                      "interface-band tets",
                                   verbose=verbose)
                    # the group handoff between ranks (off by default):
                    # whole shards move, the comm tables and the
                    # numbering mirror remapped in lockstep; gids are
                    # unchanged, so shared_prev is too
                    if pod.handoff_enabled() and use_band and \
                            glo_d is not None:
                        (stacked, met_s, glo_d, glo, comms,
                         nmv_h) = pod.maybe_handoff(stacked, met_s, glo_d,
                                                    glo, comms,
                                                    verbose=verbose)
                        if nmv_h:
                            check_interface_echo(stacked, met_s, comms,
                                                 vert_h)
                otrace.emit_span("dist.migrate",
                                 time.perf_counter() - t_seg)
                if ckpt_tag is not None:
                    _save_pass(ckpt_tag, it, stacked, met_s, glo, top,
                               comms, shared_prev, regrow_state[0],
                               ckpt_fp)
                otrace.profile_pass_end(it)
        otrace.set_context(**{"pass": None})
        t_seg = time.perf_counter()
        merged, met_m, part_new = merge_all(stacked, met_s)
        otrace.emit_span("dist.merge", time.perf_counter() - t_seg)
    return merged, met_m, part_new


def _resume_point(mesh, met, ckpt_tag, resume, n_shards, nproc, niter,
                  cycles, mode, ifc_layers, noswap, noinsert, nomove,
                  nobalancing, verbose, dev):
    """The loop's entry state: (first pass, run fingerprint, restored
    state or None).  The restored state is (this rank's stacked shards,
    their metric, glo, top, comms, regrow count, shared gids) of the
    newest dist checkpoint of this run.  Across processes the
    resume point and the crash-loop verdict are agreed: ranks that would
    re-enter at different passes raise (``PMTORCH_CKPT_DIR`` must be
    storage every rank sees), and only rank 0 writes the attempt count."""
    from ..core.mesh import MESH_FIELDS
    from . import multihost, pod
    if ckpt_tag is None:
        return 0, None, None
    from ..resilience.checkpoint import run_fingerprint
    fp = run_fingerprint(mesh, met, "dist", n_shards, nproc, niter, cycles,
                         mode, ifc_layers, bool(noswap), bool(noinsert),
                         bool(nomove), bool(nobalancing))
    if not resume:
        return 0, fp, None
    from ..obs.metrics import REGISTRY
    from ..resilience.checkpoint import (crash_loop, latest_dist_checkpoint,
                                         load_dist_checkpoint)
    found = latest_dist_checkpoint(ckpt_tag, fp)
    seen = multihost.agree(-1 if found is None else found[1])
    if min(seen) != max(seen):
        raise RuntimeError(
            f"dist resume diverges across ranks (newest checkpointed pass "
            f"a rank: {seen}): PMTORCH_CKPT_DIR must be storage every rank "
            "sees")
    if found is None:
        return 0, fp, None
    pl = load_dist_checkpoint(found[0])
    stacked = MeshStack(**{f: torch.as_tensor(pod.local(pl["stacked"][f]))
                           .to(dev) for f in MESH_FIELDS})
    met_s = torch.as_tensor(pod.local(pl["met"])).to(dev)
    it0 = pl["it"] + 1
    REGISTRY.counter("resilience.resumes").inc()
    otrace.log(1, f"  resuming dist loop at pass {it0} (checkpoint "
                  f"{found[0]})", verbose=verbose)
    # crash-loop breaker: a pass that kills its run every time is not
    # resumed forever; rank 0 writes the count, the verdict is agreed
    _, esc = crash_loop(ckpt_tag, fp, it0, write=multihost.mh_uniform(
        multihost.rank() == 0,
        "rank 0 writes the attempt file on shared storage; the verdict "
        "is agreed right after (max over the ranks)"))
    esc = max(multihost.agree(1 if esc else 0)) > 0
    if esc:
        from ..resilience.recover import ladder_step
        ladder_step("lowfailure", site="ckpt.resume",
                    detail=f"dist crash loop at pass {it0}: returning the "
                           "last conforming checkpointed state")
        # skip the loop: the restored state is the answer
        it0 = max(1, niter)
    return it0, fp, (stacked, met_s, pl["glo"], pl["top"], pl["comms"],
                     pl["regrow"], pl["shared_prev"])


def _save_pass(tag, it, stacked, met_s, glo, top, comms, shared_prev,
               regrow, fp):
    """Pass ``it``'s dist checkpoint: every rank takes part in the
    replication of the shards (``pull_host`` under ``cold_io``), rank 0
    writes."""
    from ..core.mesh import MESH_FIELDS
    from ..resilience.checkpoint import ckpt_due, save_dist_checkpoint
    from . import multihost
    if not ckpt_due(it):
        return
    with multihost.cold_io():
        sh_host = {f: multihost.pull_host(getattr(stacked, f), what="ckpt")
                   for f in MESH_FIELDS}
        met_host = multihost.pull_host(met_s, what="ckpt")
    save_dist_checkpoint(
        tag, it, sh_host, met_host, glo, top, comms,
        shared_prev if shared_prev is not None else np.zeros(0, np.int64),
        regrow, fingerprint=fp, write=multihost.mh_uniform(
            multihost.rank() == 0,
            "rank 0 writes: every rank holds the same payload (the "
            "cold_io replication above)"))


def _shared_gids(comms, glo, n_shards: int) -> np.ndarray:
    """Interface-vertex gids from the comm tables (the band path's
    shared-vertex candidate seed)."""
    sh0 = []
    for s_ in range(n_shards):
        rows = np.unique(comms.node_idx[s_][comms.node_idx[s_] >= 0])
        sh0.append(glo[s_][rows])
    return np.unique(np.concatenate(sh0)) if sh0 else \
        np.zeros(0, np.int64)
