"""Active-scoped narrow adaptation (port of ``ops/active.py``): the
worklist cycles and the fused cycle blocks the JAX package runs on its
accelerator.

- ``pending`` [capP] bool is the worklist: the vertices whose
  neighbourhood changed since they were last examined, found by diffing
  the mesh arrays before and after a cycle (:func:`dirty_from_diff`).
- Each cycle examines the pending vertices of one rotating,
  equal-population morton window (``smooth.morton_window_mask``); its
  collapses, swaps and smoothing are limited to that window too.
- One full-width pass closes the worklist over one vertex ring and finds
  the active tets, those holding a vertex of the closure
  (:func:`closure_active`).  When the previous cycle allows it
  (``okflag``) and the active tets fit, the cycle runs on an [A]-row
  sub-mesh of them (:func:`extract_active`, A = :func:`narrow_rows`)
  with every wave's candidates limited to the closure, and scatters the
  rows back (:func:`writeback_active`); otherwise it runs full width.
  Vertex-axis arrays and the metric stay at full width on the sub-mesh.

Every candidate of a narrow cycle has its whole stencil inside the
sub-mesh, so its gates are exact; a narrow cycle whose allocations
outrun the full mesh's free rows is discarded whole.  Each fused block
ends with a full-width cycle (the periodic refresh) and one adjacency
rebuild.

The two data-dependent branches of the JAX package's cycle (narrow or
full, apply or discard) are host decisions here: one scalar read each.
"""
from __future__ import annotations

import torch

from ..core.mesh import Mesh, replace
from ..utils.compilecache import bucket
from .adapt import adapt_cycle_impl
from .adjacency import build_adjacency
from .edges import free_rows
from .primitives import nonzero_pad
from .smooth import morton_window_mask

# A = max(NARROW_MIN, capT // NARROW_DIV), on the geo bucket ladder
NARROW_DIV = 8
NARROW_MIN = 8192
# a quarter of A is kept for the rows a narrow cycle allocates
NARROW_HEADROOM_DIV = 4
# the waves' budget divisor on a narrow cycle (a full cycle's is 8)
NARROW_BUDGET_DIV = 2
# the most morton windows an auto block rotates through
WINDOW = 24

# narrow attempts discarded since the process started (a discarded
# attempt's counts row reads like an empty narrow cycle that escalates)
COUNTS = {"discarded": 0}


def narrow_rows(capT: int) -> int:
    """Rows of the narrow sub-mesh: capT // 8, at least NARROW_MIN, on the
    1.5x bucket ladder and at most capT."""
    return bucket(max(NARROW_MIN, capT // NARROW_DIV), floor=NARROW_MIN,
                  cap=capT)


def _any_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ne = a != b
    return ne.any(dim=1) if ne.dim() > 1 else ne


def dirty_from_diff(pre: Mesh, post: Mesh, pre_met=None, post_met=None):
    """[capP] bool: vertices whose neighbourhood changed between two mesh
    states: the vertices (before and after) of every tet row whose
    vertices, liveness, face or edge tags or face refs changed, the moved
    vertices, those whose tag or liveness changed, and with the metrics
    given, those whose metric changed."""
    capP = pre.capP
    row = _any_rows(pre.tet, post.tet) | (pre.tmask != post.tmask)
    row = row | _any_rows(pre.ftag, post.ftag) | \
        _any_rows(pre.fref, post.fref) | _any_rows(pre.etag, post.etag)
    sent = torch.full_like(pre.tet, capP)
    idx = torch.cat([torch.where(row[:, None], pre.tet, sent).reshape(-1),
                     torch.where(row[:, None], post.tet, sent).reshape(-1)])
    dirty = torch.zeros(capP + 1, dtype=torch.bool, device=pre.device)
    dirty[idx.long()] = True
    dirty = dirty[:capP] | _any_rows(pre.vert, post.vert)
    dirty = dirty | (pre.vtag != post.vtag) | (pre.vmask != post.vmask)
    if pre_met is not None:
        dirty = dirty | _any_rows(pre_met, post_met)
    return dirty


def closure_active(mesh: Mesh, dirty: torch.Tensor):
    """(dirty2, active): the one-ring closure of ``dirty`` and the live
    tets holding a vertex of it."""
    capP = mesh.capP
    tl = mesh.tet.long()
    touched = dirty[tl].any(dim=1) & mesh.tmask
    idx = torch.where(touched[:, None], mesh.tet,
                      torch.full_like(mesh.tet, capP)).reshape(-1)
    d2 = torch.zeros(capP + 1, dtype=torch.bool, device=mesh.device)
    d2[idx.long()] = True
    d2 = d2[:capP] | dirty
    active = d2[tl].any(dim=1) & mesh.tmask
    return d2, active


def extract_active(mesh: Mesh, active: torch.Tensor, A: int):
    """The active tets compacted into an [A]-row sub-mesh.

    Returns (sub, back, n_act, ovf): ``back[r]`` int32 is the full-mesh
    row that sub row ``r`` writes back to (an active row its own; a row
    past ``n_act`` the full mesh's free rows in pool order, then the
    ``capT`` sentinel); ``ovf``: the active set does not fit the rows a
    narrow cycle may fill."""
    capT = mesh.capT
    dev = mesh.device
    n_act = active.sum(dtype=torch.int32)
    ovf = n_act > (A - A // NARROW_HEADROOM_DIV)
    ids = nonzero_pad(active, A, capT)
    ffree, _ = free_rows(mesh.tmask, A)
    r = torch.arange(A, device=dev)
    pad = r >= n_act
    back = torch.where(pad, ffree[(r - n_act).clamp(0, A - 1)], ids)
    src = ids.clamp(0, capT - 1)

    def take(a):
        v = a[src]
        return torch.where(pad.view((-1,) + (1,) * (v.dim() - 1)),
                           torch.zeros_like(v), v)
    sub = replace(
        mesh, tet=take(mesh.tet), tmask=take(mesh.tmask),
        tref=take(mesh.tref), ftag=take(mesh.ftag), fref=take(mesh.fref),
        etag=take(mesh.etag),
        adja=torch.full((A, 4), -1, dtype=torch.int32, device=dev),
        nelem=n_act)
    return sub, back.to(torch.int32), n_act, ovf


def writeback_active(mesh: Mesh, sub: Mesh, back: torch.Tensor,
                     n_act: torch.Tensor):
    """The sub-mesh's tet rows scattered back to their ``back`` rows (a
    row whose target is the ``capT`` sentinel drops; targets are unique),
    and its vertex-axis arrays adopted."""
    capT = mesh.capT
    keep = back < capT
    tgt = back[keep].long()

    def put(full, part):
        out = full.clone()
        out[tgt] = part[keep]
        return out
    tmask2 = put(mesh.tmask, sub.tmask)
    rows = torch.arange(1, capT + 1, dtype=torch.int32, device=mesh.device)
    nelem2 = torch.where(tmask2, rows, torch.zeros_like(rows)).max()
    return replace(
        mesh, tet=put(mesh.tet, sub.tet), tmask=tmask2,
        tref=put(mesh.tref, sub.tref), ftag=put(mesh.ftag, sub.ftag),
        fref=put(mesh.fref, sub.fref), etag=put(mesh.etag, sub.etag),
        vert=sub.vert, vmask=sub.vmask, vtag=sub.vtag, vref=sub.vref,
        npoin=sub.npoin, nelem=nelem2)


def _row10(counts8, n_act, okflag):
    return torch.cat([counts8, n_act.view(1).to(torch.int32),
                      okflag.view(1).to(torch.int32)])


def auto_cycle(mesh: Mesh, met, pending, okflag, wave: int, A: int,
               do_swap: bool, do_smooth: bool, do_insert: bool, hausd):
    """One cycle that picks its own width.

    ``pending`` [capP] bool is the worklist and ``okflag`` (0-d bool)
    whether the previous cycle lets this one run narrow.  Below A = capT
    the cycle examines the pending vertices of morton window
    ``wave % nwin`` only (nwin = min(WINDOW, max(2, 3 capT // A))), and
    its collapses, swaps and smoothing stay in that window; the rest of
    the worklist is carried.

    Returns (mesh, met, pending_next, ok_next, counts[10]): the cycle's
    8 counts (column 7 is 1 when the narrow branch ran), then the active
    tet count and ``okflag``."""
    capT = mesh.capT
    okflag = torch.as_tensor(okflag, dtype=torch.bool, device=mesh.device)
    if A >= capT:
        nwin = 1
    else:
        nwin = min(WINDOW, max(2, (3 * capT) // max(1, A)))
    if nwin > 1:
        wmask = morton_window_mask(mesh.vert, mesh.vmask, wave, nwin)
        dirty_proc = pending & wmask
    else:
        wmask = None
        dirty_proc = pending
    d2, active = closure_active(mesh, dirty_proc)
    n_act = active.sum(dtype=torch.int32)
    fits_rows = n_act <= (A - A // NARROW_HEADROOM_DIV)

    def pending_next(dn):
        return dn if wmask is None else (pending & ~wmask) | dn

    if not bool(okflag & fits_rows):            # host read
        mesh2, met2, counts = adapt_cycle_impl(
            mesh, met, wave, do_swap=do_swap, do_smooth=do_smooth,
            do_insert=do_insert, hausd=hausd, wwin=wmask,
            final_rebuild=False)
        dn = dirty_from_diff(mesh, mesh2)
        topo = counts[0] + counts[1] + counts[2]
        ok = (counts[4] == 0) & (topo < 512)
        return (mesh2, met2, pending_next(dn), ok,
                _row10(counts, n_act, okflag))

    sub0, back, n_act2, _ovf = extract_active(mesh, active, A)
    sub, met2, counts = adapt_cycle_impl(
        sub0, met, wave, do_swap=do_swap, do_smooth=do_smooth,
        do_insert=do_insert, hausd=hausd, budget_div=NARROW_BUDGET_DIV,
        vact=d2, submesh=True, final_rebuild=False)
    # a live sub row whose target is the capT sentinel: the full mesh's
    # free rows ran out, and writing back would drop a tet
    if bool((sub.tmask & (back >= capT)).any()):  # host read
        COUNTS["discarded"] += 1
        counts2 = torch.zeros(8, dtype=torch.int32, device=mesh.device)
        counts2[5] = mesh.tmask.sum(dtype=torch.int32)
        counts2[6] = 1
        counts2[7] = 1
        return (mesh, met, pending, torch.zeros_like(okflag),
                _row10(counts2, n_act, okflag))
    dn = dirty_from_diff(sub0, sub)
    mesh2 = writeback_active(mesh, sub, back, n_act2)
    # a capacity overflow inside the sub-mesh (col 4) or an insertion
    # wave cut at its top-K (col 6 bit 0) sends the next cycle full width
    bad = (counts[4] > 0) | (counts[6] % 2 > 0)
    counts2 = counts.clone()
    counts2[4] = 0
    counts2[5] = mesh2.tmask.sum(dtype=torch.int32)
    counts2[6] = bad.to(torch.int32)
    counts2[7] = 1
    return (mesh2, met2, pending_next(dn), ~bad,
            _row10(counts2, n_act, okflag))


def adapt_cycles_auto(mesh: Mesh, met, pending, okflag, wave0: int,
                      swap_flags: tuple, full_flags: tuple | None = None,
                      hausd=None, do_smooth: bool = True,
                      do_insert: bool = True, final_rebuild: bool = True):
    """A fused block of ``len(swap_flags)`` self-width-selecting cycles.

    ``pending`` [capP] bool and ``okflag`` are threaded across blocks (a
    session starts with zeros / False, so its first cycles run full
    width).  ``full_flags`` forces the marked cycles full width; by
    default the block's last.  The block ends with ``build_adjacency``
    unless ``final_rebuild`` is False.  Returns (mesh, met, pending,
    okflag, counts [nblk, 10])."""
    A = narrow_rows(mesh.capT)
    if full_flags is None:
        full_flags = tuple(c == len(swap_flags) - 1
                           for c in range(len(swap_flags)))
    okflag = torch.as_tensor(okflag, dtype=torch.bool, device=mesh.device)
    rows = []
    for c, dosw in enumerate(swap_flags):
        okc = okflag & (not full_flags[c])
        mesh, met, pending, okflag, counts = auto_cycle(
            mesh, met, pending, okc, wave0 + c, A, dosw, do_smooth,
            do_insert, hausd)
        rows.append(counts)
    if final_rebuild:
        mesh = build_adjacency(mesh)
    return mesh, met, pending, okflag, torch.stack(rows)
