"""Whole-mesh adaptation driver (port of ``ops/adapt.py``).

Each cycle applies one independent set of splits, collapses, swaps (every
third cycle and near convergence) and smoothing moves, with adjacency
rebuilt at the cycle's end; the host loop reads the per-cycle counts to
decide convergence and to grow capacity.  This is the configuration the
JAX package runs on the TPU (sort engine on, swap23 paired off the face
sort, which gives the same bits as its off-TPU pairing off ``adja``), and
on the card so is its dispatch: ``adapt_mesh`` runs blocks of
``default_cycle_block`` = 9 self-width-selecting cycles
(``ops/active.adapt_cycles_auto``: a worklist of dirty vertices, narrow
cycles on an [A]-row sub-mesh of the active tets, and collapses, swaps
and smoothing limited to a rotating morton window).  On the CPU it runs
one full-width cycle per dispatch, as the JAX package does off the TPU.
The collapse donor band is on.  The grouped path
(``parallel/groups.py``) runs ``adapt_cycle_impl`` per group slot with
the quiet mask (``active``), the smoothing cadence (``smooth_idle``) and
the incremental topology engine (``topo`` / ``incr``, ``ops/topo_incr``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..core.constants import ANGEDG
from ..core.mesh import Mesh, with_capacity
from ..utils.compilecache import governed, track
from .adjacency import boundary_edge_tags, build_adjacency
from .analysis import analyze_mesh, ridge_vertex_tangents
from .collapse import collapse_wave
from .edges import edge_lengths, unique_edges
from .smooth import smooth_wave
from .split import split_wave
from .swap import swap23_wave, swap_edges_wave
from .swapgen import swapgen_wave


@dataclass
class AdaptStats:
    nsplit: int = 0
    ncollapse: int = 0
    nswap: int = 0
    nmoved: int = 0
    cycles: int = 0
    regrows: int = 0
    status: int = 0
    # quiet-group scheduler instrumentation of the grouped path
    # (parallel/sched.py): group-block dispatches run / saved, group
    # blocks skipped, and the extra dict (active groups per block,
    # pipeline segment seconds, dirty-band occupancy per cycle)
    group_dispatches: int = 0
    group_dispatches_saved: int = 0
    groups_skipped: int = 0
    sched_extra: dict = field(default_factory=dict)
    # serving-mode tenant isolation (serve/): stats of different tenants
    # refuse to merge, and merging a tenant's stats into an untagged
    # aggregate namespaces its sched_extra keys under "tenant:<id>/"
    tenant: str | None = None

    def __iadd__(self, other):
        if (self.tenant is not None and other.tenant is not None
                and self.tenant != other.tenant):
            raise ValueError(
                f"refusing to merge AdaptStats across tenants "
                f"({self.tenant!r} += {other.tenant!r}); aggregate into "
                "an untagged AdaptStats instead")
        self.nsplit += other.nsplit
        self.ncollapse += other.ncollapse
        self.nswap += other.nswap
        self.nmoved += other.nmoved
        self.cycles += other.cycles
        self.regrows += other.regrows
        self.status = max(self.status, other.status)
        self.group_dispatches += other.group_dispatches
        self.group_dispatches_saved += other.group_dispatches_saved
        self.groups_skipped += other.groups_skipped
        pre = f"tenant:{other.tenant}/" \
            if self.tenant is None and other.tenant is not None else ""
        for k, v in other.sched_extra.items():
            kk = k if k.startswith("tenant:") else pre + k
            if isinstance(v, list):
                self.sched_extra.setdefault(kk, []).extend(v)
            else:
                self.sched_extra[kk] = self.sched_extra.get(kk, 0.0) + v
        return self

    def publish(self, registry=None) -> None:
        """Publish the counters into the metrics registry
        (``obs/metrics.py``): a tenant's stats land as tenant-namespaced
        series."""
        from ..obs.metrics import publish_stats
        publish_stats(self, registry)


def adapt_cycle_impl(mesh: Mesh, met: torch.Tensor, wave: int,
                     do_swap: bool = True, do_smooth: bool = True,
                     do_insert: bool = True, hausd: float | None = None,
                     budget_div: int = 8, wide: bool = False,
                     vact: torch.Tensor | None = None,
                     submesh: bool = False,
                     wwin: torch.Tensor | None = None,
                     final_rebuild: bool = True, prescreen: bool = True,
                     active: bool | None = None,
                     smooth_idle: bool | None = None, topo=None,
                     incr: bool = False, smooth_waves: int = 1):
    """One cycle: split -> collapse -> [swap] -> [smooth] -> [adjacency].

    ``vact`` [capP] bool: the narrow cycle's active vertices (candidates
    of every wave need their endpoints active); ``submesh``: ``mesh`` is
    an active sub-mesh, so no adjacency rebuild tags its cut faces
    MG_BDY; ``wwin`` [capP] bool: the morton window that limits
    collapses, swaps and smoothing (``ops/active.py``).
    ``final_rebuild=False`` skips the closing ``build_adjacency`` (a
    fused block rebuilds once at its end).  ``smooth_waves`` smoothing
    waves run a cycle, wave ``w`` at index ``wave * smooth_waves + w``
    (the distributed block runs 2).  ``prescreen=False`` (or
    ``wide``) turns off the split's approximate nomination prescreen.

    The grouped path's hooks (``parallel/groups.py``), host branches
    here where the JAX package has ``lax.cond``s:

    - ``active`` False: the quiet mask of the group slot is off — the
      cycle returns its input unchanged with a counts row of zeros but
      [5] (live tets) and, with ``topo``, [8] (the dirty tets pending);
    - ``smooth_idle`` True: the previous cycle was a full no-op (zero
      topology ops and zero moves); the smoothing wave is skipped when
      this cycle's split + collapse + swap is 0 too (one host read of
      that sum), as an exact identity (the JAX package's smoothing
      cadence).  Full-width cycles only (no ``vact`` / ``wwin``);
    - ``topo`` (``ops/topo_incr.TopoState``): the edge table and the
      closing adjacency come from ``incr_unique_edges`` /
      ``incr_build_adjacency`` (band-merged when ``incr``, else the full
      sorts: the same bits), ``mark_dirty`` follows every wave, the
      counts row gains [8] = the dirty tets at the cycle's start, and
      the return is (mesh, met, counts, topo).

    Returns (mesh, met, counts) with ``counts`` the int32 row
    [nsplit, ncollapse, nswap, nmoved, overflow, live_tets, deferred, 0]
    (deferred: bit 0 insertion waves, bit 1 swap waves)."""
    dev = mesh.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if topo is not None:
        from .topo_incr import (incr_build_adjacency, incr_unique_edges,
                                mark_dirty)
    if active is not None and not active:
        row = [zero] * 5 + [mesh.tmask.sum(dtype=torch.int32)] + [zero] * 2
        if topo is None:
            return mesh, met, torch.stack(row)
        return mesh, met, torch.stack(
            row + [topo.edirty.sum(dtype=torch.int32)]), topo
    nd0 = None if topo is None else topo.edirty.sum(dtype=torch.int32)
    defer = torch.zeros((), dtype=torch.bool, device=dev)
    defer_sw = torch.zeros((), dtype=torch.bool, device=dev)
    if do_insert:
        if topo is not None:
            et0, topo = incr_unique_edges(mesh, topo, incr, shell_slots=0)
        else:
            et0 = unique_edges(mesh, shell_slots=0)
        lens0 = edge_lengths(mesh, et0, met)
        vtan0 = None
        if hausd is not None:
            vtan0 = ridge_vertex_tangents(mesh, et=et0)
        res = split_wave(mesh, met, hausd=hausd, budget_div=budget_div,
                         et=et0, lens=lens0, vtan=vtan0,
                         prescreen=prescreen and not wide, vact=vact)
        if topo is not None:
            topo = mark_dirty(topo, mesh.tet, mesh.tmask, res.mesh)
        mesh, met = res.mesh, res.met
        nsplit, overflow = res.nsplit, res.overflow
        defer = defer | res.deferred
        col = collapse_wave(mesh, met, hausd=hausd, budget_div=budget_div,
                            et=et0, lens=lens0, stale_tets=res.modified,
                            vtan=vtan0, vact=vact, wwin=wwin)
        if topo is not None:
            topo = mark_dirty(topo, mesh.tet, mesh.tmask, col.mesh)
        defer = defer | col.deferred
        mesh = boundary_edge_tags(col.mesh) if bool(col.surface_changed) \
            else col.mesh
        ncol = col.ncollapse
    else:
        nsplit = ncol = zero
        overflow = torch.zeros((), dtype=torch.bool, device=dev)

    nswap = zero
    if do_swap:
        sew = swap_edges_wave(mesh, met, hausd=hausd, budget_div=budget_div,
                              vact=vact, wwin=wwin)
        if topo is not None:
            topo = mark_dirty(topo, mesh.tet, mesh.tmask, sew.mesh)
        s23 = swap23_wave(sew.mesh, met, budget_div=budget_div, wwin=wwin,
                          facesort=True, set_bdy_tags=not submesh)
        if topo is not None:
            topo = mark_dirty(topo, sew.mesh.tet, sew.mesh.tmask, s23.mesh)
        mesh = s23.mesh
        nswap = sew.nswap + s23.nswap
        defer_sw = defer_sw | sew.deferred | s23.deferred

    nmoved = zero
    if do_smooth:
        sv = vact if vact is not None else wwin
        skip = False
        if smooth_idle and sv is None:
            skip = int(nsplit + ncol + nswap) == 0
        if not skip:
            for w in range(smooth_waves):
                sm = smooth_wave(mesh, met, wave=wave * smooth_waves + w,
                                 vact=sv)
                mesh = sm.mesh
                nmoved = nmoved + sm.nmoved

    if final_rebuild:
        if topo is not None:
            mesh, topo = incr_build_adjacency(mesh, topo, incr,
                                              set_bdy_tags=not submesh)
        else:
            mesh = build_adjacency(mesh, set_bdy_tags=not submesh)
    row = [nsplit, ncol, nswap, nmoved, overflow.to(torch.int32),
           mesh.tmask.sum(dtype=torch.int32),
           defer.to(torch.int32) + 2 * defer_sw.to(torch.int32), zero]
    counts = torch.stack([r.to(torch.int32) for r in row])
    if topo is None:
        return mesh, met, counts
    return mesh, met, torch.cat([counts, nd0.reshape(1)]), topo


def fem_pass(mesh: Mesh, met: torch.Tensor):
    """One FEM-conformity wave: split interior edges joining two boundary
    points.  Returns (mesh, met, counts[2] = [nsplit, overflow])."""
    res = split_wave(mesh, met, fem_only=True, budget_div=2)
    mesh = build_adjacency(boundary_edge_tags(res.mesh))
    return mesh, res.met, torch.stack([res.nsplit,
                                       res.overflow.to(torch.int32)])


def sliver_polish_impl(mesh: Mesh, met: torch.Tensor, wave: int,
                       sliver_q: float = 0.2, do_collapse: bool = True,
                       do_swap: bool = True, do_smooth: bool = True,
                       hausd: float | None = None):
    """Bad-element pass: quality-targeted collapses, edge / generalized /
    face swaps and an optimal-position smoothing wave.  Returns
    (mesh, counts[4] = [ncollapse, nswap, nmoved, live_tets]).
    :func:`sliver_polish` is its ledger entry point (``utils/
    compilecache.py``); the grouped polish calls it per slot, as the JAX
    package's ``groups.polish_block`` does."""
    dev = mesh.device
    ncol = nswap = nmoved = torch.zeros((), dtype=torch.int32, device=dev)
    if do_collapse:
        col = collapse_wave(mesh, met, sliver_q=sliver_q, hausd=hausd,
                            budget_div=2)
        mesh = boundary_edge_tags(col.mesh) if bool(col.surface_changed) \
            else col.mesh
        ncol = col.ncollapse
    if do_swap:
        sew = swap_edges_wave(mesh, met, hausd=hausd, budget_div=2)
        sgn = swapgen_wave(sew.mesh, met, budget_div=2)
        s23 = swap23_wave(sgn.mesh, met, budget_div=2, facesort=True)
        mesh = s23.mesh
        nswap = sew.nswap + sgn.nswap + s23.nswap
    if do_smooth:
        sm = smooth_wave(mesh, met, wave=wave, opt_q=sliver_q)
        mesh = sm.mesh
        nmoved = sm.nmoved
    mesh = build_adjacency(mesh)
    return mesh, torch.stack([ncol, nswap, nmoved,
                              mesh.tmask.sum(dtype=torch.int32)])


sliver_polish = governed("adapt.sliver_polish")(sliver_polish_impl)


def grow_mesh_met(mesh: Mesh, met: torch.Tensor, newP: int, newT: int):
    """Grow capacities, carrying the metric through compact()'s
    permutation."""
    vperm = torch.sort((~mesh.vmask).to(torch.uint8), stable=True).indices
    meth = torch.zeros((newP,) + tuple(met.shape[1:]), dtype=met.dtype,
                       device=met.device)
    meth[: mesh.capP] = met[vperm]
    return with_capacity(mesh, newP, newT), meth


def default_cycle_block(device) -> int:
    """Cycles a dispatch of ``adapt_mesh`` runs: 9 on the card (the JAX
    package's 9 on its accelerator), 1 on the CPU."""
    return 9 if torch.device(device).type == "cuda" else 1


def adapt_mesh(mesh: Mesh, met: torch.Tensor, max_cycles: int = 50,
               verbose: int = 0, headroom: float = 0.85,
               swap_every: int = 3, noinsert: bool = False,
               noswap: bool = False, nomove: bool = False,
               angedg: float | None = None,
               hausd: float | None = None,
               cycle_block: int | None = None) -> tuple:
    """Host driver: cycles until no topological change (with a wide-budget
    verification cycle), capacity managed by regrowth; then the sliver
    polish.  ``met`` is an iso size map [capP] or a packed tensor map
    [capP, 6].

    Cycles run in blocks of ``cycle_block`` (default
    :func:`default_cycle_block` of the mesh's device) through
    ``ops/active.adapt_cycles_auto``, which thread a worklist across
    blocks; a single full-width cycle runs instead (and drops the
    worklist) at block 1, for the wide verification cycle and while the
    mesh is near convergence.  Returns (mesh, met, AdaptStats)."""
    stats = AdaptStats()
    mesh = analyze_mesh(mesh, ANGEDG if angedg is None else angedg).mesh
    if cycle_block is None:
        cycle_block = default_cycle_block(mesh.device)
    quiet = 0
    wide_check = False
    converged = False
    cycle = 0
    dirty = None                # the worklist; None: none yet
    okflag = False
    while cycle < max_cycles and not converged:
        n_p, n_t = mesh.np_counts()
        if n_p > headroom * mesh.capP or n_t > headroom * mesh.capT:
            mesh, met = grow_mesh_met(mesh, met,
                                      max(mesh.capP, int(2 * n_p)),
                                      max(mesh.capT, int(2 * n_t)))
            stats.regrows += 1
            dirty = None        # the regrow renumbered the vertices
            okflag = False
        was_wide = wide_check
        if wide_check or cycle_block == 1 or quiet > 0:
            do_swap = ((cycle % swap_every == swap_every - 1)
                       or quiet > 0) and not noswap
            mesh, met, counts = track(
                "adapt.cycle", adapt_cycle_impl, mesh, met, cycle,
                do_swap=do_swap, do_smooth=not nomove,
                do_insert=not noinsert, hausd=hausd,
                budget_div=2 if wide_check else 8, wide=wide_check)
            rows = [(do_swap, counts[:5].tolist())]
            dirty = None
            okflag = False
        else:
            from .active import adapt_cycles_auto
            nblk = min(cycle_block, max_cycles - cycle)
            flags = tuple(((cycle + c) % swap_every == swap_every - 1)
                          and not noswap for c in range(nblk))
            if dirty is None:
                dirty = torch.zeros(mesh.capP, dtype=torch.bool,
                                    device=mesh.device)
                okflag = False
            mesh, met, dirty, okflag, counts_all = track(
                "active.adapt_cycles_auto", adapt_cycles_auto, mesh, met,
                dirty, okflag, cycle, swap_flags=flags, hausd=hausd,
                do_smooth=not nomove, do_insert=not noinsert)
            ca = counts_all.tolist()
            rows = [(flags[c], ca[c][:5]) for c in range(nblk)]

        ovf_any = False
        for do_swap, (ns, nc, nw, nm, ovf) in rows:
            stats.nsplit += ns
            stats.ncollapse += nc
            stats.nswap += nw
            stats.nmoved += nm
            stats.cycles += 1
            if verbose >= 3:
                print(f"  cycle {cycle:3d}: split {ns:6d} collapse {nc:6d} "
                      f"swap {nw:6d} move {nm:6d}")
            cycle += 1
            if ovf:
                # a capacity-cut cycle cannot witness convergence
                ovf_any = True
                quiet = 0
                wide_check = False
                converged = False
                continue
            if converged:
                continue        # rows after convergence: stats only
            if ns == 0 and nc == 0 and (noswap or (nw == 0 and do_swap)):
                quiet += 1
                if quiet >= 2 or nm == 0 or nomove:
                    if was_wide or (noinsert and noswap):
                        converged = True
                        continue
                    wide_check = True
                    quiet = 1
            elif ns == 0 and nc == 0 and not do_swap and not noswap:
                quiet = max(quiet, 1)
            else:
                quiet = 0
                wide_check = False
        if ovf_any:
            mesh, met = grow_mesh_met(mesh, met, 2 * mesh.capP,
                                      2 * mesh.capT)
            stats.regrows += 1
            okflag = False
            dirty = None

    if noinsert and noswap and nomove:
        return mesh, met, stats
    for w in range(4):
        mesh, counts = sliver_polish(mesh, met, 1000 + w,
                                     do_collapse=not noinsert,
                                     do_swap=not noswap,
                                     do_smooth=not nomove, hausd=hausd)
        nc, nw, nm, _ = (int(v) for v in counts.tolist())
        stats.ncollapse += nc
        stats.nswap += nw
        stats.nmoved += nm
        if verbose >= 3:
            print(f"  polish {w}: collapse {nc:5d} swap {nw:5d} "
                  f"move {nm:5d}")
        if nc == 0 and nw == 0:
            break
    return mesh, met, stats
