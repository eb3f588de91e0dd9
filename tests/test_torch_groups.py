"""The port's grouped ``-mesh-size`` path held against the JAX package:
``parallel/partition.py``, ``parallel/sched.py``,
``parallel/distribute.py`` (split, weld, grow, merge) and
``parallel/groups.py``.

Exact (integer, boolean and float32 arrays bit for bit): every partition
function on the centroids of cube_mesh(4) (``greedy_partition``'s numpy
path against the JAX package's, meshkit off in both), the scheduler's
state machine and chunk planning on the cases of the fast tests of
``tests/test_group_sched.py``, the split of cube_mesh(3) into 4 groups
under a Morton partition, its growth and its merge (the JAX functions
dispatch eagerly, op by op), the weld of a near-coincident pair, and the
grouped rules (group counts, the block schedule, the early exit).

One grouped pass of cube_mesh(3) under the shock size map h = 0.3 (0.2 +
4 |x - 0.5|), 4 groups, ``cycles=2``, is held against the JAX package's
under ``jax.disable_jit()`` (the port follows eager JAX op by op; under it
``lax.map`` runs its body once a slot and ``lax.cond`` only the branch it
takes): the per-group counts rows of every block and every integer array
of the merged mesh equal, ``vert`` and the metric within 1e-5.  The eager
run compiles each primitive once (about a minute and a half), in a
background thread while the other tests run.

Port-only: the same pass chunked by 3 (padded to 6 groups, the state on
the host between dispatches) and with the band merges of the incremental
topology engine on write the same bytes as the unchunked pass;
``grouped_adapt(niter=2)`` is conforming, volume-preserving (1e-4) with
qmin > 0.02; ``ParMesh`` with ``IParam.meshSize`` and the CLI with
``-mesh-size`` take the grouped path, and with ``PMTORCH_CKPT_DIR`` set a
run resumed after its pass checkpoints (``-resume``) writes the
uninterrupted run's output.
"""
import contextlib
import io
import json
import os
import threading
from pathlib import Path
from concurrent.futures import Future

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.core import constants as JC
from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.parallel import distribute as JD, groups as JG
from parmmg_tpu.parallel import partition as JPa, sched as JS
from parmmg_tpu_torch.core import constants as C
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.ops import adapt as TAd, analysis as TN
from parmmg_tpu_torch.ops import topo_incr as TT
from parmmg_tpu_torch.ops.adjacency import build_adjacency, check_adjacency
from parmmg_tpu_torch.ops.quality import tet_quality
from parmmg_tpu_torch.parallel import distribute as TD, groups as TG
from parmmg_tpu_torch.parallel import partition as TPa, sched as TS
from parmmg_tpu_torch.utils.fixtures import analytic_iso_metric, cube_mesh
from torch_parity import jax_ledger_listener_compat  # noqa: F401

NGROUPS = 4


def _cube(n=4):
    vert, tet = cube_mesh(n)
    return vert, tet, vert[tet].mean(axis=1)


def _shock_state():
    """cube_mesh(3) at 4x capacity, analysed, and the shock size map
    h = 0.3 (0.2 + 4 |x - 0.5|) (1 on the spare rows)."""
    v, t = cube_mesh(3)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=4 * len(v),
                                        capT=4 * len(t))).mesh
    h = np.ones(m.capP, np.float32)
    h[: len(v)] = analytic_iso_metric(v, "shock", h=0.3)
    return m, torch.from_numpy(h)


def _to_jax(tm):
    f = tmesh.mesh_to_numpy(tm)
    return jmesh.Mesh(**{k: jnp.asarray(v) for k, v in f.items()})


def _stack_to_jax(ts):
    f = {k: getattr(ts, k).numpy() for k in jmesh.MESH_FIELDS}
    for k in ("vtag", "ftag", "etag"):
        f[k] = f[k].view(np.uint32)
    return jmesh.Mesh(**{k: jnp.asarray(v) for k, v in f.items()})


def _same_stack(ts, js):
    for f in jmesh.MESH_FIELDS:
        a = np.asarray(getattr(js, f))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        b = getattr(ts, f).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), f


def _same_mesh(tm, jm, vert_atol=0.0):
    got = tmesh.mesh_to_numpy(tm)
    for f in jmesh.MESH_FIELDS:
        a = np.asarray(getattr(jm, f))
        if f == "vert" and vert_atol:
            np.testing.assert_allclose(got[f], a, rtol=0, atol=vert_atol)
        else:
            assert got[f].shape == a.shape and np.array_equal(got[f], a), f


def _record_blocks(mod, rows):
    """Wrap ``mod._group_block`` so that every block's per-group counts
    rows land in ``rows``; returns the original."""
    orig = mod._group_block

    def block(*a, **k):
        run = orig(*a, **k)

        def recorded(*args):
            out = run(*args)
            c = out[2]
            rows.append(c.numpy().copy() if torch.is_tensor(c)
                        else np.asarray(c).copy())
            return out
        return recorded
    mod._group_block = block
    return orig


@pytest.fixture(scope="module")
def eager_pass():
    """The JAX package's grouped pass under ``jax.disable_jit()`` in a
    background thread (swap23 off the face sort, as the port pairs it):
    a future of (merged mesh, metric, partition, counts rows a block)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PARMMG_SWAP_FACESORT", "1")
    mp.delenv("PARMMG_GROUP_CHUNK", raising=False)
    m, met = _shock_state()
    jm, jmet = _to_jax(m), jnp.asarray(met.numpy())
    fut = Future()
    rows = []

    def run():
        try:
            with jax.disable_jit():
                out = JG.grouped_adapt_pass(jm, jmet, NGROUPS, cycles=2)
            fut.set_result(out + (rows,))
        except BaseException as e:           # noqa: BLE001 (passed on)
            fut.set_exception(e)
    orig = _record_blocks(JG, rows)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    yield fut
    th.join()
    JG._group_block = orig
    mp.undo()


# ---- partition ---------------------------------------------------------------

def test_partition_functions_exact(eager_pass, monkeypatch):
    """Every partitioner and helper on cube_mesh(4) equals the JAX
    package's (greedy_partition: both numpy paths, meshkit off in both;
    the library paths are held together in tests/test_torch_native.py)."""
    from parmmg_tpu import native
    from parmmg_tpu_torch import native as TNat
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(TNat, "available", lambda: False)
    vert, tet, cent = _cube(4)
    for nparts in (2, 4, 8):
        pm = TPa.morton_partition(cent, nparts)
        assert np.array_equal(pm, JPa.morton_partition(cent, nparts))
        pf = TPa.fix_contiguity(tet, pm)
        assert np.array_equal(pf, JPa.fix_contiguity(tet, pm))
        met = TPa.partition_metrics(tet, pf, nparts)
        assert met == JPa.partition_metrics(tet, pf, nparts)
        assert min(met["counts"]) > 0 and met["imbalance"] < 1.7
        assert np.array_equal(TPa.fix_contiguity(tet, pf), pf)
        pg = TPa.greedy_partition(tet, cent, nparts)
        assert np.array_equal(pg, JPa.greedy_partition(tet, cent, nparts))
        mv = TPa.move_interfaces(tet, pf, nparts, nlayers=2)
        assert np.array_equal(mv, JPa.move_interfaces(tet, pf, nparts,
                                                      nlayers=2))
        assert (np.bincount(mv, minlength=nparts) > 0).all()
        assert not np.array_equal(mv, pf)
    for a, b in zip(TPa.build_dual_graph(tet), JPa.build_dual_graph(tet)):
        assert np.array_equal(a, b)
    met = np.full(len(vert), 0.05)
    w = TPa.metric_edge_weights(tet, vert, met, ifc_pairs=(np.arange(10),
                                                           None))
    jw = JPa.metric_edge_weights(tet, vert, met, ifc_pairs=(np.arange(10),
                                                            None))
    assert all(np.array_equal(a, b) for a, b in zip(w["pairs"],
                                                    jw["pairs"]))
    assert np.array_equal(w["w"], jw["w"])
    p4 = TPa.morton_partition(cent, 4)
    r = TPa.refine_partition(p4, 4, w["pairs"], w["w"])
    assert np.array_equal(r, JPa.refine_partition(p4, 4, jw["pairs"],
                                                  jw["w"]))
    zero = np.zeros(len(tet), np.int32)
    ce = TPa.correct_empty_parts(zero, 4, tet)
    assert np.array_equal(ce, JPa.correct_empty_parts(zero, 4, tet))
    assert (np.bincount(ce, minlength=4) > 0).all()


# ---- scheduler ---------------------------------------------------------------

def _counts(n_act, nblk=1, at=None):
    c = np.zeros((n_act, nblk, 9), np.int32)
    for (g, i, col), v in (at or {}).items():
        c[g, i, col] = v
    return c


def _sched_trace(mod, *a, **k):
    """One scripted scheduler history (tests/test_group_sched.py's
    marks-skips-and-compacts case, then a regrow); returns what every step
    returned and the counters."""
    s = mod.QuietGroupScheduler(*a, **k)
    out = []
    act, plans = s.plan_block(pres_all_on=True)
    out.append((act.tolist(), [(i.tolist(), n) for i, n in plans]))
    s.record_block(act, _counts(len(act), 2, {(0, 0, 0): 5, (2, 1, 2): 1}),
                   swap_inclusive=True, pres_all_on=True)
    for pres in (True, False):
        act, plans = s.plan_block(pres)
        out.append((act.tolist(), [(i.tolist(), n) for i, n in plans]))
        out.append(s.block_mask(pres).tolist())
    s.record_block(act, _counts(len(act)), True, False)
    s.record_block(act, _counts(len(act), at={(0, 0, 4): 1}), True, True)
    s.note_plan_pads(mod.chunk_plans(np.array([0, 2, 3]), 2))
    act, plans = s.plan_block(False)
    out.append((act.tolist(), [(i.tolist(), n) for i, n in plans]))
    s.on_regrow()
    out.append(s.plan_block(False)[0].tolist())
    out.append((s.level.tolist(), s.dispatches, s.saved_dispatches,
                s.skipped_group_blocks, s.cond_skipped,
                s.active_per_block))
    return out


@pytest.mark.parametrize("chunk", [2, 0, 1])
def test_scheduler_exact(monkeypatch, chunk):
    """The port's scheduler (always on, its mask too) walks the same
    history as the JAX package's at its defaults."""
    monkeypatch.setenv("PARMMG_GROUP_SCHED", "1")
    monkeypatch.setenv("PARMMG_DEVICE_MASK", "1")
    g_exec = 6 if chunk == 2 else 4
    j = _sched_trace(JS, 4, g_exec, chunk)
    t = _sched_trace(TS, 4, g_exec, chunk)
    assert t == j
    for nreal in (1, 2, 4):
        assert TS.pad_mask(4, nreal).tolist() == \
            JS.pad_mask(4, nreal).tolist()


def test_scheduler_contracts():
    """The fast cases of tests/test_group_sched.py on the port."""
    s = TS.QuietGroupScheduler(ngroups=4, g_exec=6, chunk=2)
    act, plans = s.plan_block(pres_all_on=True)
    assert [(list(i), n) for i, n in plans] == [([0, 1], 2), ([2, 3], 2)]
    assert s.dispatches == 2 and s.saved_dispatches == 1
    s.record_block(act, _counts(4, 2, {(0, 0, 0): 5, (2, 1, 2): 1}),
                   swap_inclusive=True, pres_all_on=True)
    assert list(s.level[:4]) == [0, TS.LEVEL_PRE, 0, TS.LEVEL_PRE]
    assert list(s.plan_block(True)[0]) == [0, 2]
    act3, _ = s.plan_block(False)
    assert list(act3) == [0, 1, 2, 3]
    s.record_block(act3, _counts(4), True, False)
    assert s.plan_block(False)[1] == []
    assert s.skipped_group_blocks == 6
    q = TS.QuietGroupScheduler(2, 2, 1)
    a, _ = q.plan_block(True)
    q.record_block(a, _counts(2), swap_inclusive=False, pres_all_on=True)
    assert (q.level[:2] == 0).all()
    q.record_block(a, _counts(2, at={(0, 0, 4): 1}), True, True)
    assert q.level[0] == 0 and q.level[1] == TS.LEVEL_PRE
    p = TS.chunk_plans(np.array([1, 4, 6]), 2)
    assert [(list(i), n) for i, n in p] == [([1, 4], 2), ([6, 6], 1)]
    assert TS.pad_mask(4, 2).tolist() == [True, True, False, False]
    assert TS.quiet_rows(_counts(3, 2, {(1, 1, 3): 2})).tolist() == \
        [True, False, True]


def test_timers_match_the_jax_package():
    """Nested paths, absorbed segments and the report's layout equal the
    JAX package's Timers (the scope's own duration aside)."""
    from parmmg_tpu.utils.timers import Timers as JTimers
    from parmmg_tpu_torch.utils.timers import Timers
    reports = []
    for cls in (JTimers, Timers):
        t = cls()
        t.add("grp upload", 1.5, 2)
        with t("adaptation"):
            t.add("inner", 0.25)
        t.add("grp upload", 0.5)
        reports.append((t.count, {k: v for k, v in t.acc.items()
                                  if k != "adaptation"}, t.external,
                        [ln for ln in t.report().splitlines()
                         if not ln.startswith("adaptation")]))
    assert reports[0] == reports[1]
    assert reports[1][0] == {"grp upload": 3, "adaptation/inner": 1,
                             "adaptation": 1}


# ---- grouped rules -------------------------------------------------------------

def test_group_rules_exact(monkeypatch):
    for ne, target in ((100, 0), (100, 1000), (1000, 100), (10 ** 9, 10),
                       (196608, 16384)):
        assert TG.how_many_groups(ne, target) == \
            JG.how_many_groups(ne, target)
    assert TG.how_many_groups(196608, 16384) == 12
    assert C.REMESHER_NGRPS_MAX == JC.REMESHER_NGRPS_MAX
    # off the accelerator both packages put every group in one dispatch;
    # the port's override is the JAX package's PARMMG_GROUP_CHUNK
    monkeypatch.delenv("PARMMG_GROUP_CHUNK", raising=False)
    assert TG.group_chunk(12, 1 << 20, None) == JG.group_chunk(12) == 0
    monkeypatch.setenv("PARMMG_GROUP_CHUNK", "3")
    assert TG.group_chunk(12, 1 << 20, None, 3) == JG.group_chunk(12) == 3
    for c0, nblk, cycles, noswap in ((0, 9, 12, False), (9, 3, 12, False),
                                     (0, 1, 2, True), (3, 9, 50, False)):
        assert TG.block_schedule(c0, nblk, cycles, noswap) == \
            JG.block_schedule(c0, nblk, cycles, noswap)
    flags = (False, False, True)
    for cs in (np.zeros((3, 9), np.int64), np.ones((3, 9), np.int64),
               np.array([[0] * 9, [0] * 9, [0, 0, 1] + [0] * 6])):
        for noswap in (False, True):
            assert TG.block_converged(cs, flags, noswap) == \
                JG.block_converged(cs, flags, noswap)


GB = 10 ** 9


@pytest.mark.parametrize("ngroups,group_bytes,device_bytes,chunk,want", [
    (12, 30 * 10 ** 6, 80 * GB, None, 0),    # cube32 at the CI's flags
    (12, GB, 16 * GB, None, 4),              # 4 groups fill the share
    (12, 10 * GB, 16 * GB, None, 1),         # one group beyond the share
    (12, 1, None, None, 0),                  # the CPU never chunks
    (12, 1, None, 3, 3),                     # the override
    (8, 10 * GB, 16 * GB, 8, 0),             # a chunk of every group
], ids=["fits", "share", "one-at-a-time", "cpu", "override", "covers"])
def test_group_chunk_fits_the_device(ngroups, group_bytes, device_bytes,
                                     chunk, want):
    """Groups a dispatch from the stacked state's bytes against the
    device's memory: unchunked while the stack takes at most
    ``STACK_SHARE`` of it, else as many groups as fit in that share."""
    assert TG.group_chunk(ngroups, group_bytes, device_bytes, chunk) == want


# ---- split / grow / merge / weld ---------------------------------------------------

@pytest.fixture(scope="module")
def split_pair():
    m, met = _shock_state()
    vert, tet, _, _, _ = tmesh.mesh_to_host(m)
    part = TPa.fix_contiguity(tet, TPa.morton_partition(
        vert[tet].mean(axis=1), NGROUPS))
    ts, tk = TD.split_to_shards(m, met, part, NGROUPS)
    js, jk = JD.split_to_shards(_to_jax(m), jnp.asarray(met.numpy()),
                                part, NGROUPS)
    return ts, tk, js, jk


def test_split_to_shards_exact(split_pair):
    ts, tk, js, jk = split_pair
    _same_stack(ts, js)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert ts.ngroups == NGROUPS and ts.capT == js.tet.shape[1]
    frozen = (ts.vtag & C.MG_PARBDY) != 0
    assert bool(frozen.any()) and bool((ts.vtag[frozen] & C.MG_REQ).all())


def test_grow_and_merge_exact(split_pair):
    ts, tk, js, jk = split_pair
    tg, tgk = TD.grow_shards(ts, tk, 2 * ts.capP, 3 * ts.capT)
    jg, jgk = JD.grow_shards(js, jk, 2 * ts.capP, 3 * ts.capT)
    _same_stack(tg, jg)
    assert np.array_equal(tgk.numpy(), np.asarray(jgk))
    tm, tmet, tpart = TD.merge_shards(tg, tgk, return_part=True)
    jm, jmet, jpart = JD.merge_shards(_stack_to_jax(tg),
                                      jnp.asarray(tgk.numpy()),
                                      return_part=True)
    _same_mesh(tm, jm)
    assert np.array_equal(tmet.numpy(), np.asarray(jmet))
    assert np.array_equal(tpart, jpart)
    # the merge undoes the split: the input's 64 vertices and 162 tets
    assert tm.np_counts() == (64, 162)
    assert int(((tm.vtag & C.MG_PARBDY) != 0).sum()) == 0


def test_weld_close_pairs_exact():
    """An interior vertex of cube_mesh(3) split in two 1e-3 apart (the
    tets on its +x side take the copy): both packages weld it back."""
    vert, tet = cube_mesh(3)
    i = int(np.where((np.abs(vert - 0.5) < 0.2).all(axis=1))[0][0])
    vert = np.concatenate([vert, vert[i:i + 1] + [1e-3, 0, 0]])
    tet = tet.copy()
    side = (tet == i).any(axis=1) & (vert[tet].mean(axis=1)[:, 0] >
                                     vert[i, 0])
    tet[side] = np.where(tet[side] == i, len(vert) - 1, tet[side])
    z4 = np.zeros((len(tet), 4), np.uint32)
    args = (vert, tet, np.zeros(len(vert), np.uint32),
            np.full(len(vert), 0.3), np.zeros(len(tet), np.int32), z4,
            np.zeros((len(tet), 6), np.uint32))
    got = TD._weld_close_pairs(*args)
    ref = JD._weld_close_pairs(*args)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert (~got[1]).sum() == 1


# ---- the grouped pass ------------------------------------------------------------

def _port_pass(**kw):
    m, met = _shock_state()
    rows = []
    orig = _record_blocks(TG, rows)
    try:
        st = TAd.AdaptStats()
        out = TG.grouped_adapt_pass(m, met, NGROUPS, cycles=2, stats=st,
                                    **kw)
    finally:
        TG._group_block = orig
    return out + (rows, st)


@pytest.fixture(scope="module")
def port_pass():
    return _port_pass()


def test_chunked_pass_writes_the_same_bytes(port_pass):
    """Chunk 3 on 4 groups (padded to 6, the state on the host between
    dispatches; the repeat-padded rows masked) equals the unchunked pass:
    merged mesh, metric, partition and per-group counts rows."""
    from parmmg_tpu_torch.utils.timers import Timers
    mesh0, met0, part0, rows0, st0 = port_pass
    tim = Timers()
    mesh3, met3, part3, rows3, st3 = _port_pass(chunk=3, timers=tim)
    for f in tmesh.MESH_FIELDS:
        assert torch.equal(getattr(mesh0, f), getattr(mesh3, f)), f
    assert torch.equal(met0, met3) and np.array_equal(part0, part3)
    # the first block dispatches all 4 groups as plans [0 1 2], [3 3 3]
    assert np.concatenate([rows3[0], rows3[1][:1]]).tolist() == \
        rows0[0].tolist()
    assert rows3[1][1:, :, [0, 1, 2, 3, 4]].sum() == 0    # masked pads
    assert st3.sched_extra["cond_skipped_rows"] >= 2
    assert st0.group_dispatches == 2 and st3.group_dispatches >= 3
    assert st0.sched_extra["group_chunk"] == [0]
    assert st3.sched_extra["group_chunk"] == [3]
    # the pipeline's four segments, one count a dispatch, absorbed into the
    # caller's timers and folded into the stats
    for seg in ("upload", "compute", "download", "writeback"):
        assert tim.count[f"grp {seg}"] == st3.group_dispatches
        assert f"grp {seg}" in tim.external
        assert st3.sched_extra[f"grp_{seg}_s"] == pytest.approx(
            tim.acc[f"grp {seg}"], abs=1e-8)
    assert (st3.nsplit, st3.ncollapse, st3.nswap, st3.nmoved) == \
        (st0.nsplit, st0.ncollapse, st0.nswap, st0.nmoved)


def test_incr_pass_writes_the_same_bytes(port_pass):
    """The band merges of the incremental topology engine on: the same
    bytes and counts as the pass with them off, and they merged."""
    mesh0, met0, part0, rows0, _ = port_pass
    TT.reset_counts()
    mesh1, met1, part1, rows1, _ = _port_pass(incr=True)
    for f in tmesh.MESH_FIELDS:
        assert torch.equal(getattr(mesh0, f), getattr(mesh1, f)), f
    assert torch.equal(met0, met1) and np.array_equal(part0, part1)
    assert [r.tolist() for r in rows0] == [r.tolist() for r in rows1]
    assert TT.COUNTS["edge_merges"] + TT.COUNTS["face_merges"] > 0


def test_regrow_writes_the_same_bytes(monkeypatch):
    """At one times the largest group (``cap_mult=1``) under h = 0.2 (0.2
    + 4 |x - 0.5|) the groups overflow and grow twice: chunked by 3 (the
    host arrays padded) and with the band merges on (the topology state
    re-initialised at the new capacity), the pass writes the unchunked
    pass's bytes."""
    grows = []
    real = TD.grow_shards

    def grow(*a):
        grows.append(a[2:])
        return real(*a)
    monkeypatch.setattr(TD, "grow_shards", grow)
    outs = []
    for kw in (dict(chunk=0), dict(chunk=3), dict(chunk=0, incr=True)):
        m, _ = _shock_state()
        v = m.vert[m.vmask].numpy()
        h = np.ones(m.capP, np.float32)
        h[: len(v)] = analytic_iso_metric(v, "shock", h=0.2)
        outs.append(TG.grouped_adapt_pass(m, torch.from_numpy(h), NGROUPS,
                                          cycles=3, cap_mult=1.0, **kw))
    assert len(grows) == 6
    for mesh, met, part in outs[1:]:
        for f in tmesh.MESH_FIELDS:
            assert torch.equal(getattr(mesh, f), getattr(outs[0][0], f)), f
        assert torch.equal(met, outs[0][1])
        assert np.array_equal(part, outs[0][2])


def test_grouped_adapt_conforming():
    """Two passes with interface displacement: conforming, volume 1 within
    1e-4, qmin > 0.02 (tests/test_groups.py's contract)."""
    m, met = _shock_state()
    st = TAd.AdaptStats()
    out, met2 = TG.grouped_adapt(m, met, target_size=41,
                                 niter=2, cycles=3, stats=st)
    out = build_adjacency(out)
    assert check_adjacency(out) == {"asymmetric": 0, "face_mismatch": 0}
    vols = tmesh.tet_volumes(out)[out.tmask]
    assert bool((vols > 0).all())
    assert np.isclose(float(vols.double().sum()), 1.0, rtol=1e-4)
    assert float(tet_quality(out, met2)[out.tmask].min()) > 0.02
    assert st.sched_extra["groups_per_pass"] == [NGROUPS, NGROUPS]
    assert st.cycles >= 4 and st.nsplit > 0


def _parmesh(resume=False, h=0.4):
    from parmmg_tpu_torch.api import IParam, ParMesh
    vert, tet = cube_mesh(2)
    pm = ParMesh(device="cpu")
    pm.set_mesh_size(np_=len(vert), ne=len(tet))
    pm.set_vertices(vert)
    pm.set_tetrahedra(tet + 1)
    pm.set_met_size(1, len(vert))
    pm.set_scalar_mets(np.full(len(vert), h))
    pm.set_iparameter(IParam.niter, 1)
    pm.set_iparameter(IParam.meshSize, len(tet) // 3)
    pm.info.resume = resume
    pm.info.imprim = -1
    return pm


def test_mesh_size_engages_groups_and_resume_is_refused(monkeypatch,
                                                        tmp_path):
    """``IParam.meshSize`` below the tet count takes the grouped path: a
    conforming, volume-preserving output.  With ``PMTORCH_CKPT_DIR`` set,
    a run resumed after the checkpoint of its one pass gives the
    uninterrupted run's output; ``resume`` refuses the checkpoint of
    another input (its run fingerprint differs): that run starts from
    scratch, counts no resume, and gives the output of a run without
    checkpoints."""
    from parmmg_tpu_torch.obs.metrics import REGISTRY

    def resumes():
        return REGISTRY.snapshot()["counters"].get("resilience.resumes", 0)
    called = {"n": 0}
    orig = TG.grouped_adapt

    def counting(*a, **k):
        called["n"] += 1
        return orig(*a, **k)
    monkeypatch.setattr(TG, "grouped_adapt", counting)
    pm = _parmesh()
    assert pm.run() == C.PMMG_SUCCESS and called["n"] == 1
    v, _ = pm.get_vertices()
    t, _ = pm.get_tetrahedra()
    p = v[t - 1]
    vol = np.einsum("ti,ti->t", p[:, 1] - p[:, 0],
                    np.cross(p[:, 2] - p[:, 0], p[:, 3] - p[:, 0])) / 6
    assert (vol > 0).all() and np.isclose(vol.sum(), 1.0, rtol=1e-4)
    monkeypatch.setenv("PMTORCH_CKPT_DIR", str(tmp_path))
    full = _parmesh()
    assert full.run() == C.PMMG_SUCCESS
    assert sorted(os.listdir(tmp_path)) == [
        "grouped.pass0.0.mesh", "grouped.pass0.1.mesh",
        "grouped.pass0.2.mesh", "grouped.pass0.npz"]
    r0 = resumes()
    pm = _parmesh(resume=True)
    assert pm.run() == C.PMMG_SUCCESS and called["n"] == 3
    assert resumes() == r0 + 1
    for get in ("get_vertices", "get_tetrahedra"):
        for a, b in zip(getattr(pm, get)(), getattr(full, get)()):
            assert np.array_equal(a, b)
    other = _parmesh(resume=True, h=0.45)
    assert other.run() == C.PMMG_SUCCESS and called["n"] == 4
    assert resumes() == r0 + 1
    monkeypatch.delenv("PMTORCH_CKPT_DIR")
    fresh = _parmesh(h=0.45)
    assert fresh.run() == C.PMMG_SUCCESS
    for get in ("get_vertices", "get_tetrahedra"):
        for a, b in zip(getattr(other, get)(), getattr(fresh, get)()):
            assert np.array_equal(a, b)


def test_cli_mesh_size_runs_grouped(tmp_path, monkeypatch):
    """``-device cpu -mesh-size N -niter 2`` with N below the tet count:
    the grouped path, a conforming output mesh.  With ``PMTORCH_CKPT_DIR``
    set, a run killed after pass 0 (its pass 1 checkpoint removed) and
    run again with ``-resume`` writes the uninterrupted run's .mesh and
    .sol bytes."""
    from parmmg_tpu_torch import cli
    from parmmg_tpu_torch.io.medit import MeditMesh, read_mesh, write_mesh
    vert, tet = cube_mesh(3)
    mm = MeditMesh()
    mm.vert, mm.vref = vert, np.zeros(len(vert), np.int32)
    mm.tetra, mm.tref = tet, np.ones(len(tet), np.int32)
    src, out = str(tmp_path / "c.mesh"), str(tmp_path / "o.mesh")
    write_mesh(src, mm)
    called = {"n": 0}
    orig = TG.grouped_adapt_pass

    def counting(*a, **k):
        called["n"] += 1
        return orig(*a, **k)
    TG.grouped_adapt_pass = counting
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-in", src, "-out", out, "-hsiz", "0.3",
                           "-mesh-size", "60", "-niter", "2", "-device",
                           "cpu", "-v", "0", "-bench-json"])
        assert rc == 0, buf.getvalue()
    finally:
        TG.grouped_adapt_pass = orig
    assert called["n"] == 2
    rec = json.loads([ln for ln in buf.getvalue().splitlines()
                      if ln.startswith("{")][-1])
    o = read_mesh(out)
    assert rec["ntets"] == len(o.tetra) and rec["qmin"] > 0
    mesh = build_adjacency(tmesh.make_mesh(o.vert, o.tetra))
    assert check_adjacency(mesh) == {"asymmetric": 0, "face_mismatch": 0}
    assert int(((tmesh.tet_volumes(mesh) <= 0) & mesh.tmask).sum()) == 0
    ck = tmp_path / "ck"
    monkeypatch.setenv("PMTORCH_CKPT_DIR", str(ck))
    flags = ["-in", src, "-hsiz", "0.3", "-mesh-size", "60", "-niter", "2",
             "-device", "cpu", "-v", "-1"]
    out1, out2 = str(tmp_path / "full.mesh"), str(tmp_path / "res.mesh")
    assert cli.main(flags + ["-out", out1]) == 0
    os.unlink(ck / "grouped.pass1.npz")
    assert cli.main(flags + ["-out", out2, "-resume"]) == 0
    for ext in (".mesh", ".sol"):
        a, b = (Path(o).with_suffix(ext).read_bytes() for o in (out1, out2))
        assert a == b, ext


def test_grouped_pass_matches_eager_jax(eager_pass, port_pass):
    """The per-group counts rows of both blocks and the merged mesh of the
    port's pass equal the JAX package's eager pass: integer arrays bit for
    bit, vert and the metric within 1e-5 (they agree bit for bit here)."""
    jm, jmet, jpart, jrows = eager_pass.result(timeout=900)
    tm, tmet, tpart, trows, st = port_pass
    assert len(trows) == len(jrows) == 2
    for t, j in zip(trows, jrows):
        assert t.tolist() == np.asarray(j).tolist()
    assert sum(r[..., 0].sum() for r in trows) > 0          # splits
    assert sum(r[..., 1].sum() for r in trows) > 0          # collapses
    _same_mesh(tm, jm, vert_atol=1e-5)
    np.testing.assert_allclose(tmet.numpy(), np.asarray(jmet), rtol=0,
                               atol=1e-5)
    assert np.array_equal(tpart, np.asarray(jpart))
