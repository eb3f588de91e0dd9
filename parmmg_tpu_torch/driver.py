"""The adaptation loop driver (port of ``driver.py``).  Metric synthesis,
a background copy of the mesh when the run carries user fields, then
either ``niter`` calls of the whole-mesh adaptation operator or, when
``-mesh-size`` splits the mesh into two groups or more, the grouped outer
loop (``parallel/groups.grouped_adapt``: group split, frozen-seam remesh,
seam displacement, ``niter`` passes) and a polish of the merged mesh, or,
with ``-ndev N`` (``info.n_devices`` > 1), the distributed pass
(``parallel/dist.distributed_adapt_multi``: N shards stacked on the
device, communicators, frozen-interface adapt blocks, the cross-shard
analysis refresh, one merge) and the same polish; then the run tail
(sequential repair, FEM conformity, P1 interpolation of the user fields
from the background, quality report).  A run starts a fresh trace
context and takes the process verbosity from ``imprim``; its stages are
timed under the JAX driver's names, its counters published to the
metrics registry, and at ``PMMG_VERB_STEPS`` the stage times and the
shape ledger printed.  A run that cannot finish (a capacity overflow,
the card's memory, a grouped dispatch whose retries ran out) restores
the conforming input with status ``PMMG_LOWFAILURE`` (ladder rung
``lowfailure``).  ``PMTORCH_CYCLE_BLOCK``,
``PMTORCH_GROUP_CHUNK`` and ``PMTORCH_INCR_TOPO`` are read once here, as
the defaults of ``adapt_mesh(cycle_block=)`` and
``grouped_adapt_pass(chunk=, incr=)`` (``PMTORCH_CYCLE_BLOCK`` also sets
the distributed pass's block).  A distributed run repartitions between
its passes unless ``-nobalance`` is set; a shard capacity that keeps
overflowing degrades it to the merged conforming state with
``PMMG_LOWFAILURE``."""
from __future__ import annotations

import time

import numpy as np
import torch

from .api import knobs
from .core import constants as C
from .core.mesh import MESH_FIELDS, Mesh, replace
from .obs import trace as otrace
from .ops.adapt import AdaptStats, adapt_mesh
from .ops.metric import clamp_metric, gradation, metric_hsiz, metric_optim


def _log(level: int, msg: str, imprim: int) -> None:
    otrace.log(level, msg, verbose=imprim)


def knob_defaults() -> tuple[dict, dict]:
    """(adapt_mesh kwargs, grouped_adapt_pass kwargs) from
    ``PMTORCH_CYCLE_BLOCK``, ``PMTORCH_GROUP_CHUNK`` and
    ``PMTORCH_INCR_TOPO``; an unset knob gives no argument (the callee's
    default)."""
    adapt_kw, pass_kw = {}, {}
    v = knobs.get("PMTORCH_CYCLE_BLOCK")
    if v:
        adapt_kw["cycle_block"] = max(1, int(v))
    v = knobs.get("PMTORCH_GROUP_CHUNK")
    if v:
        pass_kw["chunk"] = max(0, int(v))
    v = knobs.get("PMTORCH_INCR_TOPO")
    if v and v != "0":
        pass_kw["incr"] = True
    return adapt_kw, pass_kw


def _auto_hmin_hmax(vert: np.ndarray, info) -> tuple[float, float]:
    lo, hi = vert.min(axis=0), vert.max(axis=0)
    diag = float(np.linalg.norm(hi - lo))
    hmin = info.hmin if info.hmin > 0 else 1e-3 * diag
    hmax = info.hmax if info.hmax > 0 else 2.0 * diag
    return hmin, hmax


def build_metric(mesh: Mesh, met, info):
    """Metric synthesis: -hsiz / -optim / user metric, clamped, hausd
    bound, local parameters, gradation (iso metrics only)."""
    vert = mesh.vert.cpu().numpy()[mesh.vmask.cpu().numpy()]
    hmin, hmax = _auto_hmin_hmax(vert, info)
    if info.hsiz > 0:
        met = metric_hsiz(mesh, info.hsiz)
    elif met is None or info.optim or info.optimLES:
        met = metric_optim(mesh)
    met = clamp_metric(met, hmin, hmax)
    if info.hausd > 0 and info.angle_detection:
        from .ops.metric import hausd_metric_bound
        met = hausd_metric_bound(mesh, met, info.hausd, hmin)
    if info.local_params:
        met = apply_local_params(mesh, met, info)
    if info.hgrad > 0 and met.dim() == 1:
        met = gradation(mesh, met, hgrad=info.hgrad)
        if info.local_params:
            met = apply_local_params(mesh, met, info)
    return met


def apply_local_params(mesh: Mesh, met, info):
    """Per-reference size clamps: kind 1 triangles (surface ref patch),
    2 tetrahedra (sub-domain), 3 user edges, 0 vertices (point ref); the
    clamp is ``clamp_metric``'s (sizes, or a tensor's eigenvalues), on the
    host."""
    ftag = mesh.ftag.cpu().numpy()
    fref = mesh.fref.cpu().numpy()
    tet = mesh.tet.cpu().numpy()
    tmask = mesh.tmask.cpu().numpy()
    tref = mesh.tref.cpu().numpy()
    meth = met.cpu().numpy().copy()
    empty = np.zeros(0, np.int64)
    for typ, ref, lhmin, lhmax, _hausd in info.local_params:
        if typ == 1:
            sel_f = ((ftag & C.MG_BDY) != 0) & (fref == ref) & tmask[:, None]
            vids = np.unique(np.concatenate(
                [tet[sel_f[:, f]][:, C.IDIR[f]].reshape(-1)
                 for f in range(4)])) if sel_f.any() else empty
        elif typ == 2:
            sel_t = tmask & (tref == ref)
            vids = np.unique(tet[sel_t].reshape(-1)) if sel_t.any() \
                else empty
        elif typ == 3:
            ue, uref = getattr(info, "_user_edges", (None, None))
            if ue is None:
                continue
            sel_e = uref == ref
            vids = np.unique(ue[sel_e].reshape(-1)) if sel_e.any() \
                else empty
        elif typ == 0:
            vm = mesh.vmask.cpu().numpy()
            vids = np.where(vm & (mesh.vref.cpu().numpy() == ref))[0]
        else:
            continue
        if len(vids):
            meth[vids] = clamp_metric(torch.from_numpy(meth[vids]), lhmin,
                                      lhmax).numpy()
    return torch.from_numpy(meth).to(met.device)


def _group_target(info, ne0: int):
    """The group target size when ``-mesh-size`` splits a mesh of ``ne0``
    tets into two groups or more, else None."""
    from .api.params import resolve_target_mesh_size
    from .parallel.groups import how_many_groups
    target = resolve_target_mesh_size(info, ne0, 1)
    return target if how_many_groups(ne0, target) >= 2 else None


def parmmg_run(pm) -> tuple:
    """Run the adaptation staged in ``pm``; returns (Mesh, metric,
    AdaptStats)."""
    from .api.params import check_input_data
    from .resilience.recover import ladder_step
    from .utils.timers import Timers
    info = pm.info
    check_input_data(info, met_is_aniso=(
        pm.met is not None and getattr(pm.met, "ndim", 1) == 2))
    otrace.new_run(pm.device)
    otrace.set_verbosity(info.imprim)
    adapt_kw, pass_kw = knob_defaults()
    tim = Timers()
    t0 = time.perf_counter()
    with tim("analysis"):
        mesh, met = pm._build_core_mesh()
    if info.nosurf:
        bdy = C.MG_BDY
        mesh = replace(
            mesh,
            ftag=torch.where((mesh.ftag & bdy) != 0, mesh.ftag | C.MG_REQ,
                             mesh.ftag),
            etag=torch.where((mesh.etag & bdy) != 0, mesh.etag | C.MG_REQ,
                             mesh.etag),
            vtag=torch.where((mesh.vtag & bdy) != 0, mesh.vtag | C.MG_REQ,
                             mesh.vtag))
    with tim("metric"):
        met = build_metric(mesh, met, info)

    # background copy for the field interpolation, on the device
    bg_fields = [np.array(f, copy=True) for f in pm.fields]
    bg_mesh = Mesh(**{f: getattr(mesh, f).clone() for f in MESH_FIELDS}) \
        if bg_fields else None

    stats = AdaptStats()
    hausd = info.hausd
    for _typ, _ref, _hm, _hx, _hd in info.local_params:
        if _hd and _hd > 0:
            hausd = min(hausd, _hd)
    if not info.angle_detection:
        hausd = None
    if info.n_devices > 1:
        mesh, met = _distributed_run(pm, mesh, met, stats, info, hausd, tim,
                                     adapt_kw)
        _log(C.PMMG_VERB_STEPS,
             f"  -- adaptation {time.perf_counter() - t0:.3f} s",
             info.imprim)
        return _finish_run(pm, mesh, met, stats, info, bg_mesh, bg_fields,
                           tim)
    target = _group_target(info, int(mesh.tmask.sum()))
    if target is not None:
        mesh, met = _grouped_run(mesh, met, target, stats, info, hausd,
                                 tim, pass_kw)
        _log(C.PMMG_VERB_STEPS,
             f"  -- adaptation {time.perf_counter() - t0:.3f} s",
             info.imprim)
        return _finish_run(pm, mesh, met, stats, info, bg_mesh, bg_fields,
                           tim)
    for _ in range(max(1, info.niter)):
        backup = (replace(mesh), met.clone())
        try:
            with tim("adaptation"):
                mesh, met, st = adapt_mesh(
                    mesh, met,
                    verbose=3 if info.imprim >= C.PMMG_VERB_ITWAVES else 0,
                    noinsert=info.noinsert, noswap=info.noswap,
                    nomove=info.nomove, angedg=info.angedg(), hausd=hausd,
                    **adapt_kw)
        except (MemoryError, torch.cuda.OutOfMemoryError) as e:
            mesh, met = backup
            stats.status = C.PMMG_LOWFAILURE
            ladder_step("lowfailure", site=_oom_site(e, "adapt.capacity"),
                        detail=str(e)[:200])
            break
        stats += st
    _log(C.PMMG_VERB_STEPS,
         f"  -- adaptation {time.perf_counter() - t0:.3f} s", info.imprim)
    return _finish_run(pm, mesh, met, stats, info, bg_mesh, bg_fields, tim)


def _oom_site(e, capacity_site: str) -> str:
    """The ladder site of a capacity failure: the card's memory, or a
    mesh capacity that kept overflowing."""
    return "device.oom" if isinstance(e, torch.cuda.OutOfMemoryError) \
        else capacity_site


def _grouped_run(mesh, met, target: int, stats, info, hausd, tim,
                 pass_kw):
    """The grouped branch: ``grouped_adapt`` (``-niter`` passes,
    ``-nlayers`` displacement layers, ``-resume`` from the pass
    checkpoints of ``PMTORCH_CKPT_DIR``, ``-group-polish``: the groups
    polished before each merge); the conforming input restored
    with status LOWFAILURE when a group's capacity or the card's memory
    runs out or a chunk dispatch's retries do; else 8 waves of
    ``sliver_polish`` on the merged mesh (group seams breed slivers).
    Returns (mesh, met)."""
    from .ops.adapt import sliver_polish
    from .parallel.groups import grouped_adapt
    from .resilience.recover import RetryBudgetExhausted, ladder_step
    backup = (replace(mesh), met.clone())
    try:
        with tim("adaptation"):
            mesh, met = grouped_adapt(
                mesh, met, target, niter=max(1, info.niter),
                verbose=3 if info.imprim >= C.PMMG_VERB_ITWAVES else 0,
                stats=stats, noinsert=info.noinsert, noswap=info.noswap,
                nomove=info.nomove, hausd=hausd, ifc_layers=info.ifc_layers,
                timers=tim, resume=bool(info.resume),
                polish=bool(info.group_polish), **pass_kw)
    except (MemoryError, torch.cuda.OutOfMemoryError) as e:
        stats.status = C.PMMG_LOWFAILURE
        ladder_step("lowfailure", site=_oom_site(e, "groups.capacity"),
                    detail=str(e)[:200])
        return backup
    except RetryBudgetExhausted as e:
        # the retry rung is spent (a chunk dispatch kept failing): the
        # conforming backup is the answer
        stats.status = C.PMMG_LOWFAILURE
        ladder_step("lowfailure", site=e.site,
                    detail=str(e.__cause__ or e))
        return backup
    if info.noinsert and info.noswap and info.nomove:
        return mesh, met
    with tim("bad-element polish"):
        for w in range(8):
            mesh, counts = sliver_polish(
                mesh, met, 1000 + w, do_collapse=not info.noinsert,
                do_swap=not info.noswap, do_smooth=not info.nomove,
                hausd=hausd)
            nc, nw, nm, _ = counts.tolist()
            stats.ncollapse += nc
            stats.nswap += nw
            stats.nmoved += nm
            if nc == 0 and nw == 0:
                break
    return mesh, met


def _distributed_run(pm, mesh, met, stats, info, hausd, tim, adapt_kw):
    """The distributed branch: ``distributed_adapt_multi`` on
    ``info.n_devices`` shards (the caller's decomposition adopted when a
    distributed input matches the shard count), degrading to the merged
    conforming state with status LOWFAILURE on a ShardOverflowError
    (ladder rung ``lowfailure``); then 8 waves of ``sliver_polish`` on the
    merged mesh.  Leaves the shard of every output tet in
    ``pm._out_part`` (None once the polish changed the tet set).
    Returns (mesh, met)."""
    from .ops.adapt import sliver_polish
    from .parallel.dist import ShardOverflowError, distributed_adapt_multi
    from .resilience.recover import ladder_step
    mode = "ifc" if info.repartitioning == C.REPART_IFC_DISPLACEMENT \
        else "graph"
    # distributed input stays distributed: adopt the caller's partition
    # when it matches the shard count (libparmmg.c:206-329)
    in_part = getattr(pm, "_in_part", None)
    n_t0 = int(mesh.tmask.sum())
    if in_part is not None and (
            len(in_part) != n_t0
            or int(in_part.max()) + 1 != info.n_devices):
        in_part = None
    try:
        with tim("adaptation"):
            mesh, met, part = distributed_adapt_multi(
                mesh, met, info.n_devices, niter=max(1, info.niter),
                verbose=3 if info.imprim >= C.PMMG_VERB_ITWAVES else 0,
                stats=stats, noinsert=info.noinsert, noswap=info.noswap,
                nomove=info.nomove, angedg=info.angedg(), hausd=hausd,
                ifc_layers=info.ifc_layers, nobalancing=info.nobalancing,
                part=in_part, mode=mode,
                block=adapt_kw.get("cycle_block"))
    except ShardOverflowError as e:
        mesh, met, part = e.mesh, e.met, e.part
        stats.status = C.PMMG_LOWFAILURE
        ladder_step("lowfailure", site="shard.overflow")
        otrace.log(C.PMMG_VERB_VERSION,
                   "  ## Warning: shard capacity exhausted; saving the "
                   "last conforming mesh (LOWFAILURE).",
                   verbose=info.imprim, err=True)
    if not (info.noinsert and info.noswap and info.nomove):
        with tim("bad-element polish"):
            for w in range(8):
                mesh, counts = sliver_polish(
                    mesh, met, 1000 + w, do_collapse=not info.noinsert,
                    do_swap=not info.noswap, do_smooth=not info.nomove,
                    hausd=hausd)
                nc, nw, nm, _ = counts.tolist()
                stats.ncollapse += nc
                stats.nswap += nw
                stats.nmoved += nm
                if nc + nw > 0:
                    part = None      # tet set changed: labels are stale
                if nc == 0 and nw == 0:
                    break
    pm._out_part = part
    return mesh, met


def _finish_run(pm, mesh, met, stats, info, bg_mesh, bg_fields, tim):
    """Run tail: sequential sliver repair, FEM conformity, user-field
    interpolation, the registry's counters, reports."""
    if not (info.noinsert and info.noswap and info.nomove):
        from .ops.repair import repair_mesh
        with tim("sequential repair"):
            mesh, nrep = repair_mesh(mesh, met,
                                     allow_collapse=not info.noinsert,
                                     allow_swap=not info.noswap,
                                     allow_move=not info.nomove)
        if nrep:
            _log(C.PMMG_VERB_STEPS, f"  sequential repair: {nrep} cluster "
                 "ops", info.imprim)
    if info.fem and not info.noinsert:
        with tim("fem conformity"):
            mesh, met, nf = _fem_conformity(mesh, met, stats)
        if nf:
            _log(C.PMMG_VERB_VERSION,
                 "  ## Warning: fem conformity pass did not converge "
                 f"({nf} edges remain).", info.imprim)
    if bg_fields:
        with tim("metric and fields interpolation"):
            pm.fields = interpolate_fields(bg_mesh, bg_fields, mesh)
    stats.publish()
    if info.imprim >= C.PMMG_VERB_QUAL:
        print_quality_report(mesh, met, info)
    _log(C.PMMG_VERB_STEPS, tim.report(), info.imprim)
    from .utils.compilecache import format_ledger, ledger_snapshot
    if any(r["calls"] or r["compiles"]
           for r in ledger_snapshot().values()):
        _log(C.PMMG_VERB_STEPS, "  -- SHAPE LEDGER (governed entry points "
             "and nvcc builds)\n" + format_ledger(), info.imprim)
    return mesh, met, stats


def _fem_conformity(mesh, met, stats):
    """Up to 8 FEM-conformity waves (regrowing on overflow); returns
    (mesh, met, edges left)."""
    from .ops.adapt import fem_pass, grow_mesh_met
    nf = 0
    for _ in range(8):
        mesh, met, fc = fem_pass(mesh, met)
        nf, ovf = (int(v) for v in fc.tolist())
        stats.nsplit += nf
        if ovf:
            mesh, met = grow_mesh_met(mesh, met, 2 * mesh.capP,
                                      2 * mesh.capT)
            stats.regrows += 1
            continue
        if nf == 0:
            break
    return mesh, met, nf


def print_quality_report(mesh: Mesh, met, info) -> None:
    """Quality and edge-length histograms (PMMG_qualhisto / prilen)."""
    from .ops.quality import length_histogram, quality_histogram, \
        tet_quality
    q = tet_quality(mesh, met)
    counts, qmin, qmean, nbad = quality_histogram(q, mesh.tmask)
    lines = [f"  -- MESH QUALITY   {int(mesh.tmask.sum())} tets ; "
             f"worst {float(qmin):.6f} ; mean {float(qmean):.6f} ; "
             f"bad {int(nbad)}"]
    c = counts.cpu().numpy()
    for i, n in enumerate(c):
        lines.append(f"     {i / len(c):.1f} < Q < {(i + 1) / len(c):.1f}"
                     f"   {int(n)}")
    if met is not None:
        _, lmin, lmax, lmean = length_histogram(mesh, met)
        lines.append(f"  -- EDGE LENGTHS   min {float(lmin):.4f} ; "
                     f"max {float(lmax):.4f} ; mean {float(lmean):.4f}")
    _log(C.PMMG_VERB_QUAL, "\n".join(lines), info.imprim)


def interpolate_fields(bg: Mesh, fields: list, new: Mesh) -> list:
    """P1 interpolation of user fields (float64 [np_bg, ...] numpy arrays)
    from the background mesh onto the live vertices of ``new``, computed
    in float32 on ``bg``'s device as the JAX package computes them.
    Boundary vertices take the surface location
    (``ops.interp.locate_points_bdy``), run on the boundary subset only.
    Returns float32 numpy arrays [np_new, ...]."""
    from .ops.interp import (interp_p1, interp_p1_tri, locate_points,
                             locate_points_bdy)
    pts = new.vert[new.vmask]
    on_bdy = (new.vtag[new.vmask] & C.MG_BDY) != 0
    loc = locate_points(bg, pts, torch.zeros(pts.shape[0], dtype=torch.int32,
                                             device=pts.device))
    bidx = on_bdy.nonzero().squeeze(1)
    sloc = locate_points_bdy(bg, pts[bidx]) if bidx.numel() else None
    out = []
    for f in fields:
        full = np.zeros((bg.capP,) + f.shape[1:], f.dtype)
        full[: len(f)] = f
        full = torch.from_numpy(full).to(bg.device, torch.float32)
        vals = interp_p1(full, bg.tet, loc)
        if sloc is not None:
            vals[bidx] = interp_p1_tri(full, bg, sloc)
        out.append(vals.cpu().numpy())
    return out
