"""Quiet-group scheduler: convergence-aware active-set compaction (the
port's copy of ``parallel/sched.py``, host numpy).

The grouped adapt pass (``parallel/groups.grouped_adapt_pass``) would
otherwise re-run every group through every cycle block, even groups that
posted zero ops blocks ago.  Per-group counts mark groups *quiet*, and
from then on the active group indices are compacted into dense chunks
(the same ``[chunk, ...]`` stacked state, run on fewer rows).

Exactness contract (why skipping is bit-for-bit, not approximate):

- group seams are frozen (MG_PARBDY — the split_to_shards freeze
  contract), so a group that posts zero ops cannot be re-dirtied by its
  neighbors within a pass; the reference's rank-level loop
  (libparmmg1.c:636-948) has the same convergence structure;
- every wave is a deterministic function of (mesh, met) alone — the
  smoothing wave's hash rotation only permutes priorities among vertices
  that already pass the improvement gate, and the gate is geometry-only —
  so a block that posts zero split+collapse+swap+move leaves the group
  state a *fixed point*: re-running any weaker-or-equal block on it is
  byte-identity;
- "weaker-or-equal" is tracked as two quiet levels, because the cycle
  scheduler emits two block classes: prescreen-ON sizing blocks and the
  final prescreen-OFF polish blocks whose exact split veto re-evaluates
  candidates the approximate prescreen over-vetoed (ops/split.py).  Zero
  under a swap-inclusive prescreen-on block only proves the group inert
  for further prescreen-on blocks (``LEVEL_PRE``); zero under a
  swap-inclusive block containing a prescreen-off cycle proves it inert
  for everything (``LEVEL_FULL``);
- a capacity regrow invalidates every proof: the top-K wave budgets
  scale with capT, so ``on_regrow`` reactivates the full set;
- dead pad groups (the chunk-alignment padding of grouped_adapt_pass)
  are fixed points by construction (all masks False) and are never
  dispatched.

**Quiet masks.**  Host compaction makes quiet groups cost no dispatch;
the per-slot mask makes them cost nothing inside a dispatch too: every
grouped block takes a per-slot bool mask, and an inactive slot returns
its state unchanged with zero counts (``ops/adapt.py`` ``active=``).  In
the JAX package that is a ``lax.cond`` on the device; in the port the
mask is host numpy already, so a masked slot is skipped by a host branch
and costs no device read.  The same two proof levels hold:
:meth:`QuietGroupScheduler.block_mask` masks ``level >= LEVEL_PRE``
slots only under prescreen-ON blocks and ``level >= LEVEL_FULL`` slots
under any block.  Two mask sources:

- **unchunked dispatches** (``chunk == 0``, where compaction cannot
  change the dispatch): ``block_mask``, the only skip mechanism there;
- **padded tail rows** of compacted chunk plans (:func:`pad_mask` via
  ``groups._pipeline_chunks``): the repeat-padded duplicate rows are
  skipped instead of computed and discarded.

The JAX package's switches for both (``PARMMG_GROUP_SCHED``,
``PARMMG_DEVICE_MASK``) default on; the port keeps them on and has no
switch.
"""
from __future__ import annotations

import numpy as np

LEVEL_ACTIVE = 0   # must dispatch
LEVEL_PRE = 1      # proven zero under a swap-inclusive prescreen-ON block
LEVEL_FULL = 2     # proven zero under a swap-inclusive prescreen-OFF block


def pad_mask(chunk: int, nreal: int) -> np.ndarray:
    """[chunk] bool mask for a compacted chunk plan: the first ``nreal``
    rows are real, the repeat-padded tail rows are masked off (their
    compute would be discarded at writeback — chunk_plans)."""
    m = np.zeros(chunk, bool)
    m[:nreal] = True
    return m


def quiet_rows(counts: np.ndarray) -> np.ndarray:
    """Per-row fixed-point witness from a dispatched block's counts.

    ``counts``: [n, nblk, >=5] — reads ONLY columns 0..4, so the
    9-wide rows of the topo-threaded block (col 8 = dirty-tet count,
    ops/topo_incr) satisfy the contract unchanged.  Row ``i`` is quiet
    when the WHOLE block was a no-op for it — zero
    split+collapse+swap+move AND zero overflow (a truncated winner set
    witnesses nothing).  Shared by
    :meth:`QuietGroupScheduler.record_block` (group granularity) and
    the serving pool (serve/pool.py, tenant granularity): one rule, one
    exactness argument (module docstring)."""
    # host-by-contract: the drain already pulled the block counters to
    # numpy ([n, nblk, >=5]) — no conversion, no possible device sync
    n = counts.shape[0]
    return counts[..., :5].reshape(n, -1).sum(axis=1,
                                              dtype=np.int64) == 0


def chunk_plans(act: np.ndarray, chunk: int) -> list:
    """Compact active group indices (an ndarray) into dense
    [chunk]-sized plans.

    Returns [(idx_exec [chunk], nreal)]: a short tail plan is padded by
    repeating its last real index so every dispatch keeps the compiled
    [chunk, ...] shape; the duplicate rows are masked off on device
    (:func:`pad_mask`) and only the first ``nreal`` rows are written
    back."""
    plans = []
    for i in range(0, len(act), chunk):
        idx = act[i:i + chunk]
        nreal = len(idx)
        if nreal < chunk:
            idx = np.concatenate(
                [idx, np.repeat(idx[-1:], chunk - nreal)])
        plans.append((idx, nreal))
    return plans


class QuietGroupScheduler:
    """Active-set bookkeeping for one grouped adapt pass.

    ``g_exec`` >= ``ngroups``: the pad-aligned executable group count
    (pad groups are born quiet).  ``chunk`` = groups per dispatch
    (0 = one unchunked dispatch; compaction then cannot change the
    dispatch shape and the scheduler only records the trajectory)."""

    def __init__(self, ngroups: int, g_exec: int, chunk: int):
        self.ngroups = int(ngroups)
        self.g_exec = int(g_exec)
        self.chunk = int(chunk)
        # compaction needs per-chunk dispatches to have fewer of them; the
        # per-slot mask works at any chunking (unchunked, it is the only
        # skip mechanism — module docstring)
        self.enabled = self.chunk > 0
        self.level = np.zeros(self.g_exec, np.int8)
        self.level[self.ngroups:] = LEVEL_FULL     # dead pad groups
        self.dispatches = 0
        self.saved_dispatches = 0
        self.skipped_group_blocks = 0
        # group-slot executions skipped ON DEVICE by the lax.cond mask
        # (unchunked quiet slots + padded tail rows of chunk plans)
        self.cond_skipped = 0
        self.active_per_block: list[int] = []

    # ---- block planning --------------------------------------------------
    def _skip_level(self, pres_all_on: bool) -> int:
        return LEVEL_PRE if pres_all_on else LEVEL_FULL

    def plan_block(self, pres_all_on: bool):
        """Plan one cycle block: returns (act, plans).

        ``act``: group indices to dispatch, in plan order.  ``plans``:
        [(idx_exec, nreal)] chunk plans (empty when every group is
        quiet).  Dispatch/saved counters and the active-group trajectory
        are accounted here; the always-dispatch baseline is
        ceil(g_exec / chunk) dispatches per block."""
        skip = self._skip_level(pres_all_on)
        if self.enabled:
            act = np.where(self.level < skip)[0]
        else:
            act = np.arange(self.g_exec)
        # level is host scheduler state (np.int8): count, then int() a
        # bound host scalar — nothing here can sync a device value
        n_active = np.count_nonzero(self.level[:self.ngroups] < skip)
        self.active_per_block.append(int(n_active))
        if self.chunk:
            base = -(-self.g_exec // self.chunk)
            plans = chunk_plans(act, self.chunk) if len(act) else []
        else:
            base = 1
            plans = [(act, len(act))] if len(act) else []
        self.dispatches += len(plans)
        # saved vs the always-dispatch baseline, which ships the dead
        # pad groups too — skipping those IS a real dispatch saving
        self.saved_dispatches += base - len(plans)
        # ...but the skipped-GROUP counter reports convergence, so it
        # counts REAL groups only (pads are dead at birth, not wins)
        n_real = np.count_nonzero(act < self.ngroups)
        self.skipped_group_blocks += self.ngroups - int(n_real)
        return act, plans

    def block_mask(self, pres_all_on: bool) -> np.ndarray:
        """[g_exec] bool device-mask for an UNCHUNKED dispatch: quiet
        slots at or above this block's skip level are cond-skipped on
        device (the only skip mechanism when compaction cannot change
        the dispatch shape).  Accounts the skipped slots in
        ``cond_skipped``."""
        m = self.level < self._skip_level(pres_all_on)
        # lint: ok(R2) — m is the host scheduler state (numpy bool);
        # counting the masked slots syncs nothing
        self.cond_skipped += int(np.sum(~m))
        return m

    def note_plan_pads(self, plans: list) -> None:
        """Account the repeat-padded tail rows of compacted chunk plans
        that the device mask skipped (``pad_mask`` — one entry per
        padded row per dispatch)."""
        for idx, nreal in plans:
            self.cond_skipped += len(idx) - nreal

    # ---- quiet marking ---------------------------------------------------
    def record_block(self, act: np.ndarray, counts: np.ndarray,
                     swap_inclusive: bool, pres_all_on: bool) -> None:
        """Mark groups quiet from a dispatched block's per-group counts.

        ``counts``: [n_act, nblk, >=5] (split, collapse, swap, moved,
        overflow, ...).  A group is quiet only when the WHOLE block was
        a no-op for it — including moves (the fixed-point requirement)
        and overflow (a truncated winner set witnesses nothing) — and
        the block was swap-inclusive (``swap_inclusive`` = any swap
        cycle, or -noswap, mirroring the global convergence rule).

        The ``deferred`` column (6) is deliberately NOT part of the
        proof: deferred marks top-K budget cuts, and the budgets are
        constant across blocks (budget_div=8; only a capacity regrow
        changes them, which reactivates everything).  Split, collapse
        and swap take no wave input, so on an unchanged state they
        re-select the identical (possibly empty) winner set every
        block — a deferred-but-zero-op state is still a fixed point.
        The only wave-rotated kernel is smoothing, and moved == 0
        proves its geometry-only improvement gate rejects every
        vertex, which no later wave's priority rotation can change."""
        if not swap_inclusive or len(act) == 0:
            return
        zero = quiet_rows(counts)
        lvl = LEVEL_PRE if pres_all_on else LEVEL_FULL
        # act comes from plan_block (np.where/arange): already host
        sel = act[zero]
        self.level[sel] = np.maximum(self.level[sel], lvl)

    def on_regrow(self) -> None:
        """Capacity regrow: every proof is stale (the top-K budgets
        scale with capT — budget-truncated winners must rerun).  Pad
        groups stay quiet (dead at any capacity)."""
        self.level[:self.ngroups] = LEVEL_ACTIVE


def recommend_group_chunk(traj, g_exec: int,
                          dispatch_overhead: float = 1.0) -> int:
    """Recommend a chunk (groups a dispatch) from an active-group
    trajectory (``active_groups_per_block``, or the serve pool's active
    slots a step).

    Cost model per block with ``a`` active groups at chunk ``c``:
    ``ceil(a/c) * (c + dispatch_overhead)`` in group-compute units — every
    dispatch ships a full [c, ...] slice (short tails are padded by
    repeating rows), plus a per-dispatch overhead in units of one
    group-block of work.  Candidates are the powers of two up to
    ``g_exec``, then ``g_exec``; ties prefer the larger chunk.  Returns 0
    (unchunked) for an empty trajectory or when the winner covers every
    group anyway."""
    a = [int(v) for v in (traj or []) if int(v) > 0]
    if not a or g_exec <= 1:
        return 0
    cands = []
    c = 1
    while c < g_exec:
        cands.append(c)
        c *= 2
    cands.append(g_exec)

    def cost(c: int) -> float:
        return sum(-(-ab // c) * (c + dispatch_overhead) for ab in a)

    best = max((c for c in cands
                if cost(c) == min(cost(x) for x in cands)))
    return 0 if best >= g_exec else best
