"""Two-level decomposition: sub-device remesh groups (port of
``parallel/groups.py``).

The reference splits each rank's mesh into ``-mesh-size``-element groups
and remeshes them one at a time (``PMMG_splitPart_grps`` /
``howManyGroups``, grpsplit_pmmg.c:47,1551-1614, capped at
``PMMG_REMESHER_NGRPS_MAX``); the group is the unit that bounds the
remesher's working set.  Group interfaces are frozen exactly like rank
interfaces (MG_PARBDY — the ``split_to_shards`` freeze contract,
tag_pmmg.c:39-124) and displaced between outer iterations
(``partition.move_interfaces``), so previously frozen seams get remeshed
by a later pass: the two-level loop of the reference.

The JAX package keeps the groups as slots of a stacked pytree and runs
one compiled cycle program per slot with ``lax.map``.  The port keeps the
same stacked layout (:class:`~parmmg_tpu_torch.core.mesh.MeshStack`, a
leading group axis) and runs the same body slot after slot in a Python
loop; nothing is batched across groups, so the device holds one group's
working set at a time, as under ``lax.map``.  The quiet mask and the
smoothing cadence, ``lax.cond``s there, are host branches here.

Chunked dispatch (``group_chunk``) keeps the pass state on the host
between dispatches and uploads the active groups of each chunk plan
(``parallel/sched.py``).  The port chunks only when the stacked state
would not fit the card beside a group's working set; chunked and
unchunked runs write the same bytes.  The smoothing cadence and the
quiet-group scheduler with its per-slot mask are always on (the JAX
package's defaults).

Left for later (the JAX package's resilience layer): the subprocess
polish worker, dispatch retries and deadlines, pass checkpoints and
``resume``, and the pass's metrics; a failing chunk raises (the serve pool
isolates such a failure to its tenant, ``_pipeline_chunks(done=)``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.mesh import MESH_FIELDS, MeshStack
from ..ops.topo_incr import TopoState, topo_init


def _log(level: int, msg: str, verbose: int) -> None:
    if verbose >= level:
        print(msg)


def how_many_groups(ne: int, target: int) -> int:
    """Group count with the reference's clamps (grpsplit_pmmg.c:47)."""
    if target <= 0:
        return 1
    return max(1, min((ne + target - 1) // target, C.REMESHER_NGRPS_MAX))


# the stacked state may take this share of the card's memory before the
# pass chunks it: the rest holds one group's cycle working set (sorts and
# candidate tables several times a group's state) and the allocator's cache
STACK_SHARE = 0.25


def group_chunk(ngroups: int, group_bytes: int, device_bytes: int | None,
                chunk: int | None = None) -> int:
    """Groups per dispatch (0 = all groups in one dispatch, the state
    resident on the device).

    ``device_bytes`` is the device's memory (None on the CPU, which never
    chunks).  The pass chunks only when ``ngroups`` slots of
    ``group_bytes`` take more than ``STACK_SHARE`` of it, and then takes
    as many groups a dispatch as fit in that share (at least one).  The
    JAX package's fixed 8 on its accelerator is a rule of the TPU's HBM;
    on the card a grouped run at the reference CI's sizes is a few hundred
    MB.  ``chunk`` overrides the rule.  Returns 0 when the chunk would
    cover every group anyway."""
    if chunk is not None:
        c = max(0, int(chunk))
    elif device_bytes is None or ngroups * group_bytes <= \
            STACK_SHARE * device_bytes:
        c = 0
    else:
        c = max(1, int(STACK_SHARE * device_bytes) // max(1, group_bytes))
    return 0 if c >= ngroups else c


def block_schedule(c0: int, nblk: int, cycles: int, noswap: bool):
    """(flags, pres) for the cycle block starting at global cycle ``c0``:
    swap every 3rd cycle plus the final two cycles, which also run with
    the split's prescreen off (exact veto).  Shared with the serving pool
    of the JAX package."""
    flags = tuple((cc % 3 == 2 or cc >= cycles - 2) and not noswap
                  for cc in range(c0, c0 + nblk))
    pres = tuple(cc < cycles - 2 for cc in range(c0, c0 + nblk))
    return flags, pres


def block_converged(cs: np.ndarray, flags: tuple, noswap: bool) -> bool:
    """The grouped loop's early-exit rule on a block's summed counts
    ``cs`` [nblk, >=3] (host numpy): any swap-inclusive cycle posting
    zero split+collapse+swap ends the sizing loop."""
    return any((flags[i] or noswap) and
               int(cs[i][0]) + int(cs[i][1]) + int(cs[i][2]) == 0
               for i in range(len(flags)))


def _topo_map(fn, topo: TopoState) -> TopoState:
    return TopoState(*[fn(x) for x in topo])


def _group_block(flags: tuple, pres: tuple, nomove: bool, noinsert: bool,
                 hausd):
    """The fused cycle block over the group axis: ``run(stacked, met_s,
    wave, active, incr, topo)`` runs ``len(flags)`` cycles of
    ``adapt_cycle_impl`` on each slot of the MeshStack, one slot after
    another, and returns (stacked, met_s, counts [n, nblk, 9], topo).

    ``active`` [n] bool host mask (``parallel/sched.py``): a masked slot
    (quiet group of an unchunked dispatch, repeat-padded tail row of a
    chunk plan) returns its state unchanged with zero counts.
    The smoothing cadence: a cycle following a full no-op cycle of its
    slot skips smoothing when its own topology counts are
    zero (``adapt_cycle_impl(smooth_idle=)``); the idle carry is read
    from each cycle's counts (one host read a cycle but the block's
    last).  ``incr`` / ``topo``: the incremental topology engine's
    switch and per-slot state (``ops/topo_incr``), threaded whether or
    not ``incr`` is on."""
    from ..ops.adapt import adapt_cycle_impl
    nblk = len(flags)

    def run(stacked: MeshStack, met_s, wave: int, active, incr: bool,
            topo: TopoState):
        meshes, mets, tps, counts = [], [], [], []
        for g in range(stacked.ngroups):
            m, k = stacked.slot(g), met_s[g]
            tp = _topo_map(lambda x: x[g], topo)
            act = bool(active[g])
            rows = []
            idle = False
            for cc, dosw in enumerate(flags):
                m, k, cnt, tp = adapt_cycle_impl(
                    m, k, wave + cc, do_swap=dosw, do_smooth=not nomove,
                    do_insert=not noinsert, hausd=hausd,
                    final_rebuild=(cc == nblk - 1), prescreen=pres[cc],
                    active=act, smooth_idle=idle, topo=tp,
                    incr=incr)
                rows.append(cnt)
                if act and cc + 1 < nblk:
                    s, c, w, mv = cnt[:4].tolist()
                    idle = s + c + w == 0 and mv == 0
            meshes.append(m)
            mets.append(k)
            tps.append(tp)
            counts.append(torch.stack(rows))
        out_topo = TopoState(*[torch.stack(xs) for xs in zip(*tps)])
        return (MeshStack.stack(meshes), torch.stack(mets),
                torch.stack(counts), out_topo)

    return run


def _pad_groups(x, g_new: int):
    """Pad a stacked state's (MeshStack, TopoState or tensor) leading
    group axis to ``g_new`` with dead groups (all zeros: masks False,
    counts 0 — every wave is a no-op on a fully dead mesh)."""
    def pad(a):
        g = a.shape[0]
        if g >= g_new:
            return a
        return torch.cat([a, torch.zeros((g_new - g,) + tuple(a.shape[1:]),
                                         dtype=a.dtype, device=a.device)])
    if isinstance(x, MeshStack):
        return x.map(pad)
    if isinstance(x, TopoState):
        return _topo_map(pad, x)
    return pad(x)


def _pipeline_chunks(fn, stacked: MeshStack, met_s, wave: int, plans, tim,
                     device, incr: bool, topo: TopoState,
                     done: dict | None = None):
    """Chunked dispatch over gathered group-index slices of the
    host-resident state.

    ``plans``: [(idx_exec [chunk], nreal)] from the quiet-group scheduler
    (``parallel/sched.py``).  Each plan's rows of the mesh, metric and
    topology state are gathered on the host and uploaded to ``device``
    (``upload``), run through ``fn`` there (``compute``: the call, then a
    wait for the card), downloaded (``download``) and written back to the
    host state (``writeback``): only the first ``nreal`` rows, the
    repeat-padded tail rows being masked off by ``pad_mask`` and never
    written.  Each chunk is written back before the next one is gathered,
    so the device holds one chunk at a time.  ``tim``
    (``utils.timers.Timers``) records the four segments.  Returns the
    per-plan host count arrays (trimmed to nreal), in plan order.

    The host state changes only in a plan's writeback, its last step, so
    a plan that raises leaves its rows as they were.  ``done`` (a dict)
    records each plan's counts under its index once its writeback ran:
    a caller catching a failure can tell which plans already advanced
    their rows and which never did (the serve pool's fault isolation
    retries only the latter)."""
    from .sched import pad_mask
    out = []
    for pi, (idx, nreal) in enumerate(plans):
        ix = torch.from_numpy(np.asarray(idx, np.int64))
        with tim("upload", sync=device):
            sl = stacked.map(lambda a: a[ix].to(device))
            kl = met_s[ix].to(device)
            tl = _topo_map(lambda a: a[ix].to(device), topo)
        with tim("compute", sync=device):
            m, k, cnt, tp = fn(sl, kl, wave, pad_mask(len(idx), nreal),
                               incr, tl)
        with tim("download"):
            mh = m.map(lambda s: s[:nreal].cpu())
            kh = k[:nreal].cpu()
            th = _topo_map(lambda s: s[:nreal].cpu(), tp)
            out.append(cnt[:nreal].cpu().numpy())
        with tim("writeback"):
            rows = ix[:nreal]
            for f in MESH_FIELDS:
                getattr(stacked, f)[rows] = getattr(mh, f)
            met_s[rows] = kh
            for d, s in zip(topo, th):
                d[rows] = s
        if done is not None:
            done[pi] = out[-1]
    return out


def grouped_adapt_pass(mesh, met, ngroups: int, cycles: int = 12,
                       part: np.ndarray | None = None,
                       verbose: int = 0, stats=None,
                       noinsert: bool = False, noswap: bool = False,
                       nomove: bool = False, hausd: float | None = None,
                       cap_mult: float = 3.0, timers=None,
                       chunk: int | None = None, incr: bool = False):
    """One outer pass: split into groups, run adapt cycle blocks over the
    group axis, merge.  Returns (mesh, met, part_of_merged).

    The per-group program is the SAME ``adapt_cycle_impl`` as the
    whole-mesh path (frozen MG_PARBDY group seams make it correct).
    Cycles run in blocks of ``default_cycle_block`` of the mesh's device
    (9 on the card, 1 on the CPU); a block whose counts report a capacity
    overflow grows every group (``grow_shards``), re-initialises the
    topology state and reruns; a swap-inclusive cycle with zero
    split+collapse+swap over all groups ends the loop.

    Quiet-group scheduler (``parallel/sched.py``): per-group counts mark
    groups quiet once a swap-inclusive block is a no-op for them; chunked
    dispatches then gather only the active groups, and the per-slot mask
    skips quiet slots of an unchunked dispatch and the padded tail rows
    of chunk plans.  Skipping is exact (sched module docstring).
    ``chunk`` overrides :func:`group_chunk`'s memory rule (the JAX
    package's PARMMG_GROUP_CHUNK); ``incr`` (default off, as in the JAX
    package's PARMMG_INCR_TOPO) turns on the band merges of the
    incremental topology engine.

    The pipeline's segment seconds land in ``timers`` as "grp <segment>"
    and, with the scheduler's counters and trajectories, in
    ``stats.sched_extra``."""
    from ..core.mesh import mesh_to_host
    from ..ops.adapt import default_cycle_block
    from ..utils.timers import Timers
    from .distribute import grow_shards, merge_shards, split_to_shards
    from .partition import fix_contiguity, morton_partition
    from .sched import QuietGroupScheduler

    dev = mesh.device
    vert_h, tet_h, _, _, _ = mesh_to_host(mesh)
    if part is None:
        cent = vert_h[tet_h].mean(axis=1)
        part = fix_contiguity(tet_h, morton_partition(cent, ngroups))

    stacked, met_s = split_to_shards(mesh, met, part, ngroups,
                                     cap_mult=cap_mult)
    group_bytes = (met_s[0].nbytes + sum(getattr(stacked, f)[0].nbytes
                                         for f in MESH_FIELDS))
    dev_bytes = torch.cuda.get_device_properties(dev).total_memory \
        if dev.type == "cuda" else None
    chunk = group_chunk(ngroups, group_bytes, dev_bytes, chunk)
    # chunked dispatch: pad the group axis to whole chunks, and keep the
    # stacked state on the host between dispatches (only the chunk in
    # flight occupies the device)
    if chunk:
        g_exec = -(-ngroups // chunk) * chunk
        stacked = _pad_groups(stacked, g_exec).map(lambda a: a.cpu())
        met_s = _pad_groups(met_s, g_exec).cpu()
    else:
        g_exec = ngroups
    state_dev = torch.device("cpu") if chunk else dev

    sched = QuietGroupScheduler(ngroups, g_exec, chunk)
    topo_s = topo_init(stacked.capT, stack=g_exec, device=state_dev)
    # pipeline segment timers on a LOCAL registry: folded into
    # stats.sched_extra and (prefixed) into the caller's Timers at the end
    ltim = Timers()
    block = default_cycle_block(dev)
    c = 0
    regrows = 0
    dirty_traj: list[int] = []
    while c < cycles:
        nblk = min(block, cycles - c)
        flags, pres = block_schedule(c, nblk, cycles, noswap)
        step = _group_block(flags, pres, nomove, noinsert, hausd)
        swap_inc = any(flags) or noswap
        pres_all_on = all(pres)
        act, plans = sched.plan_block(pres_all_on)
        if chunk:
            parts = _pipeline_chunks(step, stacked, met_s, c, plans, ltim,
                                     dev, incr, topo_s)
            sched.note_plan_pads(plans)
            counts_act = np.concatenate(parts) if parts else \
                np.zeros((0, nblk, 9), np.int32)
            _log(2, f"  grp block {c}..{c + nblk - 1}: active "
                    f"{len(act)}/{g_exec} groups, {len(plans)} "
                    "dispatches", verbose)
        else:
            # unchunked: compaction cannot change the dispatch, so the
            # quiet mask is what skips converged groups
            stacked, met_s, counts, topo_s = step(
                stacked, met_s, c, sched.block_mask(pres_all_on), incr,
                topo_s)
            counts_act = counts.cpu().numpy()           # [g_exec, nblk, 9]
        sched.record_block(act, counts_act, swap_inc, pres_all_on)
        # quiet groups contribute exact zeros (that is what marked them)
        cs = counts_act.sum(axis=0, dtype=np.int64)     # [nblk, 9]
        cs_l = cs.tolist()
        for i in range(nblk):
            tot = cs_l[i]
            # counts[8]: dirty tets pending at each cycle start, summed
            # over groups — the band-occupancy trajectory
            dirty_traj.append(tot[8])
            if stats is not None:
                stats.nsplit += tot[0]
                stats.ncollapse += tot[1]
                stats.nswap += tot[2]
                stats.nmoved += tot[3]
                stats.cycles += 1
            _log(3, f"  grp cycle {c + i}: split {tot[0]} collapse "
                    f"{tot[1]} swap {tot[2]} move {tot[3]} over {ngroups} "
                    "groups", verbose)
        if any(row[4] != 0 for row in cs_l):
            if regrows >= 6:
                raise MemoryError("group capacity exhausted")
            stacked, met_s = grow_shards(stacked, met_s, 2 * stacked.capP,
                                         2 * stacked.capT)
            # the regrow changes capT: the retained sorts are stale —
            # re-init (ok False: the next derivation is a full rebuild)
            topo_s = topo_init(stacked.capT, stack=g_exec, device=state_dev)
            regrows += 1
            # the wave top-K budgets scale with capT: every quiet proof is
            # stale at the new capacity — reactivate the full set
            sched.on_regrow()
            continue        # re-run the block: truncated winners rerun
        c += nblk
        if block_converged(cs, flags, noswap):
            break
    if stats is not None:
        stats.group_dispatches += sched.dispatches
        stats.group_dispatches_saved += sched.saved_dispatches
        stats.groups_skipped += sched.skipped_group_blocks
        se = stats.sched_extra
        se["cond_skipped_rows"] = se.get("cond_skipped_rows", 0) + \
            sched.cond_skipped
        se.setdefault("group_chunk", []).append(chunk)
        se.setdefault("active_groups_per_block", []).extend(
            sched.active_per_block)
        se.setdefault("groups_per_pass", []).append(ngroups)
        if dirty_traj:
            se.setdefault("incr_dirty_per_cycle", []).extend(dirty_traj)
        for k, v in ltim.acc.items():
            se[f"grp_{k}_s"] = se.get(f"grp_{k}_s", 0.0) + v
    if timers is not None:
        for k, v in ltim.acc.items():
            timers.add(f"grp {k}", v, ltim.count[k])
    return merge_shards(stacked, met_s, return_part=True, device=dev)


def grouped_adapt(mesh, met, target_size: int, niter: int = 3,
                  cycles: int = 12, verbose: int = 0, stats=None,
                  noinsert: bool = False, noswap: bool = False,
                  nomove: bool = False, hausd: float | None = None,
                  ifc_layers: int = 2, timers=None, **pass_kw):
    """The two-level outer loop on one device: grouped passes with
    interface displacement between them (the rank-level loop of
    libparmmg1.c:636-948 collapsed onto one device, groups as the only
    level).  Engaged by the driver when ``-mesh-size`` yields >= 2
    groups.  ``pass_kw`` goes to every :func:`grouped_adapt_pass`
    (``chunk``, ``incr``, ``cap_mult``)."""
    from ..core.mesh import mesh_to_host
    from .partition import move_interfaces

    part = None
    for it in range(max(1, niter)):
        ne = int(mesh.tmask.sum())
        # a displaced partition fixes the group count (its labels index
        # the previous split); fresh iterations re-derive it
        ngroups = (int(part.max()) + 1) if part is not None \
            else how_many_groups(ne, target_size)
        if ngroups < 2:
            from ..ops.adapt import adapt_mesh
            mesh, met, st = adapt_mesh(mesh, met, verbose=verbose,
                                       noinsert=noinsert, noswap=noswap,
                                       nomove=nomove, hausd=hausd)
            if stats is not None:
                stats += st
            part = None
            continue
        _log(2, f"  grouped pass {it}: {ngroups} groups of {ne} tets",
             verbose)
        mesh, met, part_m = grouped_adapt_pass(
            mesh, met, ngroups, cycles=cycles, part=part, verbose=verbose,
            stats=stats, noinsert=noinsert, noswap=noswap, nomove=nomove,
            hausd=hausd, timers=timers, **pass_kw)
        if it + 1 < max(1, niter):
            _, tet_h, _, _, _ = mesh_to_host(mesh)
            part = move_interfaces(tet_h, part_m, ngroups,
                                   nlayers=ifc_layers)
    return mesh, met
