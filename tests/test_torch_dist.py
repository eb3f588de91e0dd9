"""The port's distributed pass held against the JAX package:
``parallel/analysis_par.py``, ``parallel/analysis_dev.py``,
``parallel/migrate.py`` and ``parallel/migrate_dev.py`` (the numbering),
``parallel/dist.py`` (one pass, ``-nobalance`` passes, the two-pass
rules), and the surfaces: the CLI's ``-ndev`` (``-ndev 2 -niter 2``
against the JAX CLI; the repartitioning itself is held to the JAX package
in ``tests/test_torch_migrate.py``), ``-distributed-output`` of a
distributed run, ``io/distributed.py``'s writers, ``ParMesh``'s
communicator API.

Exact: ``analyze_shards`` / ``extend_numbering`` on the cases of
``tests/test_analysis_par.py`` (cube_mesh(3) in 4 Morton parts,
cube_mesh(2) in 2 slabs); the device analysis refresh, pads included,
on ``tests/test_grouped_analysis.py``'s inputs (cube_mesh(4) with two
material refs, 4 shards: Morton parts against the JAX package's
compiled refresh at G = 2 on 2 devices, whose exchange is dense; x slabs
against it at G = 4 on one device, whose exchange is packed), and
against both host refreshes; the numbering functions on seeded tables.

The whole pass: ``distributed_adapt_multi(niter=1, cycles=2)`` of
cube_mesh(3) under the shock size map h = 0.3 (0.2 + 4 |x - 0.5|) on 2
and 4 shards against the JAX package's with ``n_devices=1`` (G = the
shard count, as the port stacks them), compiled (about 30 s a run, in a
background thread; eager JAX's ``shard_map`` takes over 20 minutes for
it on the CPU).  The cycles' op counts, the live tet and vertex counts
and the merged tets' shard labels are exact; on 2 shards the live tets
are equal as a set (within 1e-6).  On 4 shards compiled XLA's smooth
places two vertices of shard 1's second cycle 0.03 away from where eager
JAX and the port put them (ROADMAP C1, jit against eager rounding): the
tets that touch neither (284 of 300) are equal as a set, qmin is held
within rtol 1e-5 and qmean within rtol 1e-3 (the measured gap is 5.3e-4).
So the pass's cycles are also held against eager JAX, shard by shard:
every field of every shard after the 4-shard pass's two blocks (eager
``adapt_cycle_impl`` on the port's split, in a second background
thread, about 2 minutes), exact but for one-ulp ``vert`` rows.
"""
import contextlib
import dataclasses
import io
import json
import sys
import threading
from concurrent.futures import Future

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.core import constants as JCc
from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.ops.analysis import analyze_mesh as janalyze
from parmmg_tpu.parallel import analysis_par as JAP, dist as JDi
from parmmg_tpu.parallel import comms as JCo, distribute as JDs
from parmmg_tpu.parallel import migrate as JM, migrate_dev as JMD
from parmmg_tpu_torch.core import constants as C
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.ops import analysis as TN
from parmmg_tpu_torch.ops.adapt import AdaptStats
from parmmg_tpu_torch.ops.adjacency import build_adjacency, check_adjacency
from parmmg_tpu_torch.ops.quality import tet_quality
from parmmg_tpu_torch.parallel import analysis_par as TAP, dist as TDi
from parmmg_tpu_torch.parallel import comms as TCo
from parmmg_tpu_torch.parallel import migrate as TM, migrate_dev as TMD
from parmmg_tpu_torch.parallel.partition import (fix_contiguity,
                                                 morton_partition)
from parmmg_tpu_torch.utils.fixtures import analytic_iso_metric, cube_mesh
from torch_parity import jax_ledger_listener_compat  # noqa: F401


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


def _stack_from_jax(js):
    f = {k: np.asarray(getattr(js, k)) for k in jmesh.MESH_FIELDS}
    for k in ("vtag", "ftag", "etag"):
        f[k] = f[k].view(np.int32)
    return tmesh.MeshStack(**{k: torch.from_numpy(np.array(v))
                              for k, v in f.items()})


def _i32(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.fixture(scope="module")
def jax_passes():
    """The JAX package's compiled distributed pass on 2 and 4 shards (one
    device, G = the shard count) in a background thread: a future of
    {n: (merged mesh, met, part, AdaptStats)}."""
    from parmmg_tpu.ops.adapt import AdaptStats as JStats
    mp = pytest.MonkeyPatch()
    mp.setenv("PARMMG_SWAP_FACESORT", "1")
    m, met = _shock_state()
    jm, jmet = _to_jax(m), jnp.asarray(met.numpy())
    fut = Future()

    def run():
        try:
            out = {}
            for n in (2, 4):
                st = JStats()
                r = JDi.distributed_adapt_multi(jm, jmet, n, niter=1,
                                                cycles=2, n_devices=1,
                                                stats=st)
                out[n] = r + (st,)
            fut.set_result(out)
        except BaseException as e:           # noqa: BLE001 (passed on)
            fut.set_exception(e)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    yield fut
    th.join()
    mp.undo()


@pytest.fixture(scope="module")
def jax_eager_shards():
    """Eager JAX's cycles of the 4-shard pass, shard by shard on the
    port's split, in a background thread (``jax.disable_jit`` is
    thread-local): a future of {"shards": [(mesh, met, counts a cycle)],
    "counts": summed [4] a cycle, "nact": active shards a cycle, "lvl":
    the quiet levels after the two blocks}."""
    from parmmg_tpu.ops.adapt import adapt_cycle_impl
    import jax
    mp = pytest.MonkeyPatch()
    mp.setenv("PARMMG_SWAP_FACESORT", "1")
    stacked, met_s = _split4()
    ins = [(_to_jax(stacked.slot(g)), jnp.asarray(met_s[g].numpy()))
           for g in range(4)]
    fut = Future()

    def run():
        try:
            shards, lvl = [], [0] * 4
            with jax.disable_jit():
                for g, (jm_, jk) in enumerate(ins):
                    rows = []
                    for c in range(2):
                        jm_, jk, cnt = adapt_cycle_impl(
                            jm_, jk, c, do_swap=True, do_smooth=True,
                            do_insert=True, smooth_waves=2, hausd=None,
                            final_rebuild=True, prescreen=False,
                            active=jnp.asarray(lvl[g] < 2))
                        rows.append(np.asarray(cnt).tolist())
                        if sum(rows[-1][:5]) == 0:
                            lvl[g] = 2
                    shards.append((jm_, jk, rows))
            cs = np.asarray([r for _, _, r in shards])        # [4, 2, 8]
            fut.set_result({
                "shards": shards,
                "counts": cs[:, :, :4].sum(axis=0).tolist(),
                "nact": (cs[:, :, :3].sum(axis=2) > 0).sum(axis=0).tolist(),
                "lvl": lvl})
        except BaseException as e:           # noqa: BLE001 (passed on)
            fut.set_exception(e)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    yield fut
    th.join()
    mp.undo()


# ---- the host analysis ------------------------------------------------------

def _shard_arrays(vert, tet, part, nparts):
    """Per-shard host arrays, ftags with MG_BDY / MG_PARBDY set
    (tests/test_analysis_par.py's construction)."""
    n = len(tet)
    faces = np.sort(tet[:, C.IDIR].reshape(n * 4, 3), axis=1)
    key = (faces[:, 0].astype(np.int64) << 42) | \
        (faces[:, 1].astype(np.int64) << 21) | faces[:, 2].astype(np.int64)
    uniq, cnts = np.unique(key, return_counts=True)
    bdy = set(uniq[cnts == 1].tolist())
    verts, tets, ftags, frefs, l2g, g2l = [], [], [], [], [], []
    for s in range(nparts):
        sel = part == s
        gids = np.unique(tet[sel])
        m = np.full(len(vert), -1, np.int64)
        m[gids] = np.arange(len(gids))
        lt = m[tet[sel]]
        lf = np.sort(lt[:, C.IDIR].reshape(-1, 3), axis=1)
        lkey = (gids[lf[:, 0]] << 42) | (gids[lf[:, 1]] << 21) | \
            gids[lf[:, 2]]
        lu, lc = np.unique(lkey, return_counts=True)
        once = dict(zip(lu.tolist(), lc.tolist()))
        ft = np.zeros((len(lt), 4), np.uint32)
        for i, k in enumerate(lkey.tolist()):
            if once[k] == 1:
                ft[i // 4, i % 4] = C.MG_BDY if k in bdy else \
                    C.MG_BDY | C.MG_PARBDY
        verts.append(vert[gids])
        tets.append(lt.astype(np.int64))
        ftags.append(ft)
        frefs.append((np.arange(len(lt) * 4) % 3).reshape(-1, 4)
                     .astype(np.int32))
        l2g.append(gids)
        g2l.append(m)
    return verts, tets, ftags, frefs, l2g, g2l


@pytest.mark.parametrize("case", ["morton", "slabs"])
def test_analyze_shards_exact(jax_passes, jax_eager_shards,
                              jax_cli_two_passes, case):
    """(``jax_passes``, ``jax_eager_shards`` and ``jax_cli_two_passes``
    start the JAX package's runs here, so that they go on while the
    module's other tests run.)"""
    if case == "morton":
        vert, tet = cube_mesh(3)
        part = fix_contiguity(tet, morton_partition(vert[tet].mean(axis=1),
                                                    4))
    else:
        vert, tet = cube_mesh(2)
        part = (vert[tet].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    nparts = int(part.max()) + 1
    verts, tets, ftags, frefs, l2g, g2l = _shard_arrays(vert, tet, part,
                                                        nparts)
    comms = TCo.build_interface_comms(tet, part, nparts, l2g, g2l)
    got = TAP.analyze_shards(verts, tets, ftags, frefs, comms)
    want = JAP.analyze_shards(verts, tets, ftags, frefs, comms)
    for a_l, b_l in zip(got, want):
        for a, b in zip(a_l, b_l):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert any(((v & C.MG_GEO) != 0).any() for v in got[0])
    npo = [len(x) + 3 for x in l2g]
    for a, b in zip(TAP.extend_numbering(comms, npo),
                    JAP.extend_numbering(comms, npo)):
        assert np.array_equal(a, b)
    glo = TAP.extend_numbering(comms, [len(x) for x in l2g])
    got_g = TAP.analyze_shards(verts, tets, ftags, frefs, comms,
                               angedg=0.5, glo=glo)
    want_g = JAP.analyze_shards(verts, tets, ftags, frefs, comms,
                                angedg=0.5, glo=glo)
    for a_l, b_l in zip(got_g, want_g):
        assert all(np.array_equal(a, b) for a, b in zip(a_l, b_l))


# ---- the device analysis refresh --------------------------------------------

def _setup(part_kind, n=4, nparts=4):
    """tests/test_grouped_analysis.py's input: cube_mesh(n) with two
    material refs (the surface refs follow them), analysed, split into
    ``nparts`` (Morton parts or x slabs) by the JAX package."""
    vert, tet = cube_mesh(n)
    m = jmesh.make_mesh(vert, tet, capP=2 * len(vert), capT=2 * len(tet))
    tref = 1 + (vert[tet].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    trf = np.zeros(m.capT, np.int32)
    trf[: len(tet)] = tref
    m = dataclasses.replace(m, tref=jnp.asarray(trf))
    m = janalyze(m).mesh
    is_b = (np.asarray(m.ftag) & C.MG_BDY) != 0
    frf = np.where(is_b, trf[:, None], np.asarray(m.fref))
    m = dataclasses.replace(m, fref=jnp.asarray(frf.astype(np.int32)))
    met = jnp.full(m.capP, 0.4, m.vert.dtype)
    vert_h, tet_h, _, _, _ = jmesh.mesh_to_host(m)
    cent = vert_h[tet_h].mean(axis=1)
    if part_kind == "morton":
        part = fix_contiguity(tet_h, morton_partition(cent, nparts))
    else:
        part = np.clip((cent[:, 0] * nparts).astype(np.int32), 0,
                       nparts - 1)
    s, _, l2g = JDs.split_to_shards(m, met, part, nparts, return_l2g=True)
    g2l = []
    for s_ in range(nparts):
        mm = np.full(len(vert_h), -1, np.int64)
        mm[l2g[s_]] = np.arange(len(l2g[s_]))
        g2l.append(mm)
    comms = TCo.build_interface_comms(tet_h, part, nparts, l2g, g2l)
    return s, comms


@pytest.mark.parametrize("part_kind,n_dev", [("morton", 2), ("slabs", 1)])
def test_device_refresh_exact(part_kind, n_dev):
    """The port's device refresh equals the JAX package's compiled one at
    G = 4 // n_dev, every row (pads included), and both host refreshes;
    the JAX package lays its exchange out dense for the Morton parts at
    G = 2 and packed for the slabs at G = 4."""
    js, comms = _setup(part_kind)
    S = 4
    G = S // n_dev
    assert (JCo.packed_halo_rows(comms.nbr, G) is None) == \
        (part_kind == "morton")
    ts = _stack_from_jax(js)
    capP = ts.capP
    glo = TAP.extend_numbering(comms, [capP] * S)
    dmesh = JDi.make_device_mesh(n_dev)
    want = JDi.refresh_shard_analysis_device(
        JDi.shard_stacked(js, dmesh), comms, S, JCc.ANGEDG, glo, dmesh)
    got = TDi.refresh_shard_analysis_device(ts, comms, S, C.ANGEDG, glo)
    assert want is not None and got is not None
    for f in ("vtag", "etag"):
        assert np.array_equal(getattr(got, f).numpy(),
                              _i32(getattr(want, f))), f
    # the classification changed something, and the host paths agree
    assert not torch.equal(got.etag, ts.etag)
    host_t = TDi.refresh_shard_analysis(ts, comms, S, C.ANGEDG,
                                        glo=[g.copy() for g in glo])
    host_j = JDi.refresh_shard_analysis(js, comms, S, JCc.ANGEDG,
                                        glo=[g.copy() for g in glo])
    vm, tm = ts.vmask.numpy(), ts.tmask.numpy()
    for f in ("vtag", "etag"):
        h = getattr(host_t, f).numpy()
        assert np.array_equal(h, _i32(getattr(host_j, f))), f
    assert np.array_equal(host_t.vtag.numpy()[vm], got.vtag.numpy()[vm])
    assert np.array_equal(host_t.etag.numpy()[tm], got.etag.numpy()[tm])


def test_dist_quality_matches_jax():
    """The quality histogram of a shard stack (a sum / min over its
    shards) against the JAX package's ``shard_map`` reduction on 4
    devices: counts, bad and live tets exact, qmin and qmean within
    rtol 1e-6."""
    js, _ = _setup("morton")
    ts = _stack_from_jax(js)
    met = np.full((4, ts.capP), 0.4, np.float32)
    dmesh = JDi.make_device_mesh(4)
    want = JDi.dist_quality(dmesh)(JDi.shard_stacked(js, dmesh),
                                   JDi.shard_stacked(jnp.asarray(met),
                                                     dmesh))
    got = TDi.dist_quality()(ts, torch.from_numpy(met))
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    assert [int(x) for x in got[3:]] == [int(x) for x in want[3:]]
    assert int(got[4]) == int(ts.tmask.sum()) > 0


def test_device_refresh_fallbacks():
    """An ``analysis.ks_overflow`` fault returns None (the host path's
    cue), and the pass then takes the host refresh (rung
    ``host_analysis``) with the device refresh's tags."""
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    from parmmg_tpu_torch.resilience.faults import FAULTS
    js, comms = _setup("slabs")
    ts = _stack_from_jax(js)
    glo = TAP.extend_numbering(comms, [ts.capP] * 4)
    ok = TDi.refresh_shard_analysis_device(ts, comms, 4, C.ANGEDG, glo)
    r0 = REGISTRY.counter("resilience.host_analysis").value
    FAULTS.arm("analysis.ks_overflow")
    try:
        assert TDi.refresh_shard_analysis_device(ts, comms, 4, C.ANGEDG,
                                                 glo) is None
        host = TDi._refresh(ts, comms, 4, C.ANGEDG,
                            [g.copy() for g in glo])
    finally:
        FAULTS.reset()
    assert REGISTRY.counter("resilience.host_analysis").value == r0 + 1
    vm, tm = ts.vmask.numpy(), ts.tmask.numpy()
    assert np.array_equal(host.vtag.numpy()[vm], ok.vtag.numpy()[vm])
    assert np.array_equal(host.etag.numpy()[tm], ok.etag.numpy()[tm])


def test_device_refresh_failure_is_not_retried(monkeypatch):
    """An error raised inside the refresh program (here a kernel's, from
    the sort) propagates out of the pass's refresh: no retry, no host
    fallback, no ladder step."""
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    from parmmg_tpu_torch.parallel import analysis_dev as TAD
    from parmmg_tpu_torch.resilience.recover import LADDER
    js, comms = _setup("slabs")
    ts = _stack_from_jax(js)
    glo = TAP.extend_numbering(comms, [ts.capP] * 4)
    calls = []

    def failing_sort(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(TAD, "_sort2", failing_sort)
    before = {r: REGISTRY.counter(f"resilience.{r}").value for r in LADDER}
    with pytest.raises(RuntimeError, match="illegal memory access"):
        TDi._refresh(ts, comms, 4, C.ANGEDG, glo)
    assert len(calls) == 1
    assert {r: REGISTRY.counter(f"resilience.{r}").value
            for r in LADDER} == before


# ---- the numbering ----------------------------------------------------------

def _numbering_state(seed=3):
    rng = np.random.default_rng(seed)
    S, capP = 3, 40
    glo = np.where(rng.random((S, capP)) < 0.6,
                   rng.integers(0, 500, (S, capP)), -1).astype(np.int32)
    vmask = rng.random((S, capP)) < 0.7
    return glo, vmask


@pytest.mark.parametrize("K", [4, 32])
def test_numbering_device_exact(K):
    glo, vmask = _numbering_state()
    top = 777
    got = TMD.extend_ids_device(torch.from_numpy(glo),
                                torch.from_numpy(vmask), top, KN=K)
    want = JMD.extend_ids_device(jnp.asarray(glo), jnp.asarray(vmask),
                                 jnp.asarray(top, jnp.int32), KN=K)
    for a, b in zip(got, want):
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        assert np.array_equal(a, np.asarray(b))
    got = TMD.dead_glo_rows(torch.from_numpy(glo), torch.from_numpy(vmask),
                            KD=K)
    want = JMD.dead_glo_rows(jnp.asarray(glo), jnp.asarray(vmask), KD=K)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for top_, n, k in ((0, 4, 256), (2 ** 31 - 1025, 4, 256),
                       (2 ** 31 - 1024, 4, 256)):
        assert TMD.session_ids_fit(top_, n, k) == \
            JMD.session_ids_fit(top_, n, k)


def test_numbering_host_mirror_exact():
    glo, vmask = _numbering_state(4)
    ext = TMD.extend_ids_device(torch.from_numpy(glo),
                                torch.from_numpy(vmask), 900, KN=40)
    rows, gids = ext[2].numpy(), ext[3].numpy()
    d_rows, d_cnt, _ = (x.numpy() for x in TMD.dead_glo_rows(
        torch.from_numpy(glo), torch.from_numpy(vmask), KD=40))
    mirrors = []
    for mod in (TM, JM):
        g = [r.astype(np.int64).copy() for r in glo]
        mod.apply_fresh_ids(g, rows, gids)
        mod.kill_glo_rows(g, d_rows, d_cnt)
        h = [r.astype(np.int64).copy() for r in glo]
        top = mod.extend_global_ids_from_vmask(h, vmask, 900)
        mirrors.append((g, h, top))
    for a, b in zip(mirrors[0][0] + mirrors[0][1],
                    mirrors[1][0] + mirrors[1][1]):
        assert np.array_equal(a, b)
    assert mirrors[0][2] == mirrors[1][2]
    # the device path and the host path give the same numbering
    assert all(np.array_equal(a, b) for a, b in zip(mirrors[0][0],
                                                    mirrors[0][1]))


def test_pull_views_matches_the_stack():
    m, met = _shock_state()
    vert, tet, _, _, _ = tmesh.mesh_to_host(m)
    part = fix_contiguity(tet, morton_partition(vert[tet].mean(axis=1), 2))
    from parmmg_tpu_torch.parallel.distribute import split_to_shards
    ts, tk, l2g = split_to_shards(m, met, part, 2, return_l2g=True)
    v = TM.pull_views(ts, tk)
    for f in tmesh.MESH_FIELDS:
        if f != "adja":
            assert np.array_equal(getattr(v, f), getattr(ts, f).numpy())
    assert np.array_equal(v.met, tk.numpy()) and v.vert.flags.writeable
    assert [len(x) for x in l2g] == ts.vmask.sum(1).tolist()


# ---- the whole pass ---------------------------------------------------------

def _split4():
    """The port's 4-shard split of the whole-pass input."""
    m, met = _shock_state()
    vert_h, tet_h = tmesh.mesh_to_host(m)[:2]
    part = TDi._partition(m, met, 4, "morton", vert_h, tet_h)
    stacked, met_s, _, _ = TDi._split_with_comms(m, met, part, 4,
                                                 len(vert_h), tet_h)
    return stacked, met_s


def test_dist_block_matches_eager_jax(jax_eager_shards):
    """The two blocks of the 4-shard pass (cycles=2 on the CPU: one cycle
    a block, both swapping, prescreen off, the quiet levels carried)
    through ``dist_adapt_block`` equal eager JAX's ``adapt_cycle_impl``
    run shard by shard on the same split with the JAX block's arguments
    and quiet rule: every integer field of every shard, the metric, the
    summed counts, the active shards and the levels exact; ``vert``
    within 1e-6 (3 rows of shard 2 differ by one float32 ulp, at most
    6e-8, after its second cycle's smooth, where eager and compiled JAX
    agree with each other)."""
    stacked, met_s = _split4()
    lvl = np.zeros(4, np.int8)
    counts, nact = [], []
    for c in range(2):
        step = TDi.dist_adapt_block((True,), pre_flags=(False,))
        stacked, met_s, ca, na, ovf, lvl = step(stacked, met_s, c, lvl)
        counts += ca
        nact += na
        assert ovf == 0
    want = jax_eager_shards.result(timeout=1500)
    for g, (jm_, jk, _) in enumerate(want["shards"]):
        got = stacked.slot(g)
        for f in jmesh.MESH_FIELDS:
            if f == "vert":
                np.testing.assert_allclose(got.vert.numpy(),
                                           np.asarray(jm_.vert), rtol=0,
                                           atol=1e-6)
            else:
                assert np.array_equal(getattr(got, f).numpy(),
                                      _i32(getattr(jm_, f))), (g, f)
        assert np.array_equal(met_s[g].numpy(), np.asarray(jk)), g
    assert counts == want["counts"] and nact == want["nact"]
    assert lvl.tolist() == want["lvl"]
    assert sum(map(sum, counts)) > 0 and min(nact) > 0

@pytest.mark.parametrize("n", [2, 4])
def test_distributed_pass_matches_jax(jax_passes, n):
    m, met = _shock_state()
    st = AdaptStats()
    mesh, met_o, part = TDi.distributed_adapt_multi(m, met, n, niter=1,
                                                    cycles=2, stats=st)
    jmesh_o, jmet_o, jpart, jst = jax_passes.result(timeout=1500)[n]
    assert (st.cycles, st.nsplit, st.ncollapse, st.nswap, st.nmoved) == \
        (jst.cycles, jst.nsplit, jst.ncollapse, jst.nswap, jst.nmoved)
    assert st.sched_extra["active_shards_per_cycle"] == \
        jst.sched_extra["active_shards_per_cycle"]
    tm = mesh.tmask.numpy()
    assert int(tm.sum()) == int(np.asarray(jmesh_o.tmask).sum())
    assert int(mesh.vmask.sum()) == int(np.asarray(jmesh_o.vmask).sum())
    assert np.array_equal(part, jpart)
    q = tet_quality(mesh, met_o).numpy()[tm]
    jq = np.asarray(JDi.tet_quality(jmesh_o, jmet_o))[
        np.asarray(jmesh_o.tmask)]
    np.testing.assert_allclose(q.min(), jq.min(), rtol=1e-5)
    np.testing.assert_allclose(q.mean(), jq.mean(), rtol=1e-3)
    # the live tets as a set: each port vertex named by the JAX vertex
    # within 1e-6 of it, each tet by its sorted names.  On 2 shards every
    # tet is shared; on 4, compiled XLA's smooth places two vertices of
    # shard 1's second cycle 0.03 away (the port there equals eager JAX,
    # test_dist_block_matches_eager_jax), and every tet away from them is
    # shared
    vh, th = tmesh.mesh_to_host(mesh)[:2]
    jv, jt = jmesh.mesh_to_host(jmesh_o)[:2]
    dist = np.abs(vh[:, None, :] - jv[None, :, :]).max(axis=2)
    name = np.where(dist.min(axis=1) <= 1e-6, dist.argmin(axis=1), -1)
    moved_j = dist.min(axis=0) > 1e-6
    assert int((name < 0).sum()) == int(moved_j.sum()) <= \
        (0 if n == 2 else 2)
    assert len(np.unique(name[name >= 0])) == int((name >= 0).sum())
    keep_t = (name[th] >= 0).all(axis=1)
    keep_j = ~moved_j[jt].any(axis=1)
    assert keep_t.sum() == keep_j.sum() >= len(th) - (0 if n == 2 else 16)
    got_set = np.unique(np.sort(name[th[keep_t]], axis=1), axis=0)
    want_set = np.unique(np.sort(jt[keep_j], axis=1), axis=0)
    assert len(got_set) == keep_t.sum() and np.array_equal(got_set, want_set)
    bad = check_adjacency(build_adjacency(mesh))
    assert not bad["asymmetric"] and not bad["face_mismatch"]
    assert q.min() > 0
    assert int(((mesh.vtag & C.MG_PARBDY) != 0).sum()) == 0


def test_distributed_pass_rules():
    """Port-only: one outer pass (``distributed_adapt``) writes the
    resident loop's mesh; ``-nobalance`` passes run on the resident
    shards; two passes repartition between them (tets move on the band
    path, one merge); asking for 2 ranks (``n_devices=2``) outside a
    process group of 2 refuses before any work; a shard capacity that keeps overflowing raises
    ShardOverflowError with the merged conforming state."""
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    from parmmg_tpu_torch.parallel import distribute as TDs
    m, met = _shock_state()
    a = TDi.distributed_adapt_multi(m, met, 2, niter=1, cycles=2)
    b = TDi.distributed_adapt(m, met, 2, cycles=2)
    for f in tmesh.MESH_FIELDS:
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    assert torch.equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    st = AdaptStats()
    two = TDi.distributed_adapt_multi(m, met, 2, niter=2, cycles=2,
                                      nobalancing=True, stats=st)
    assert st.cycles == 4 and int(two[0].tmask.sum()) > 0
    merges = []
    real_merge = TDs.merge_shards

    def counting(*a, **k):
        merges.append(1)
        return real_merge(*a, **k)
    moved = REGISTRY.counter("mh.band_exchange_bytes.migrate_glo").value
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TDs, "merge_shards", counting)
        st2 = AdaptStats()
        rep = TDi.distributed_adapt_multi(m, met, 2, niter=2, cycles=2,
                                          stats=st2)
    assert len(merges) == 1 and st2.cycles > 2
    assert REGISTRY.counter("mh.band_exchange_bytes.migrate_glo").value > \
        moved
    bad = check_adjacency(build_adjacency(rep[0]))
    assert not bad["asymmetric"] and not bad["face_mismatch"]
    assert not torch.equal(rep[0].tmask, two[0].tmask) or \
        not torch.equal(rep[0].tet, two[0].tet)
    with pytest.raises(ValueError, match="rank"):
        TDi.distributed_adapt_multi(m, met, 2, niter=1, n_devices=2)
    real = TDi.dist_adapt_block

    def always_overflowing(*a, **k):
        run = real(*a, **k)

        def step(*args):
            out = run(*args)
            return out[:4] + (1,) + out[5:]
        return step
    mp = pytest.MonkeyPatch()
    mp.setattr(TDi, "dist_adapt_block", always_overflowing)
    mp.setattr(TDi, "MAX_SHARD_REGROWS", 1)
    try:
        with pytest.raises(TDi.ShardOverflowError) as e:
            TDi.distributed_adapt_multi(m, met, 2, niter=1, cycles=2)
    finally:
        mp.undo()
    bad = check_adjacency(build_adjacency(e.value.mesh))
    assert not bad["asymmetric"] and len(e.value.part) == \
        int(e.value.mesh.tmask.sum())


# ---- the surfaces -----------------------------------------------------------

@pytest.fixture(scope="module")
def cube_file(tmp_path_factory):
    from parmmg_tpu_torch.io.medit import MeditMesh, write_mesh
    d = tmp_path_factory.mktemp("dist")
    v, t = cube_mesh(3)
    mm = MeditMesh()
    mm.vert, mm.vref = v.astype(np.float64), np.zeros(len(v), np.int32)
    mm.tetra, mm.tref = t.astype(np.int32), np.ones(len(t), np.int32)
    write_mesh(d / "cube.mesh", mm)
    return d


def _cli(args):
    from parmmg_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(args) + ["-device", "cpu", "-v", "1"])
    return rc, out.getvalue(), err.getvalue()


def _conforming(path):
    from parmmg_tpu_torch.io.medit import read_mesh
    mo = read_mesh(path)
    mesh = build_adjacency(tmesh.make_mesh(mo.vert, mo.tetra))
    bad = check_adjacency(mesh)
    vol = tmesh.tet_volumes(mesh)[mesh.tmask]
    return (not bad["asymmetric"] and not bad["face_mismatch"]
            and bool((vol > 0).all())), len(mo.tetra)


def test_cli_ndev(cube_file):
    d = cube_file
    base = ["-in", str(d / "cube.mesh"), "-hsiz", "0.3", "-ndev", "2"]
    rc, out, err = _cli(base + ["-niter", "1", "-out", str(d / "o.mesh")])
    assert rc == 0, err
    ok, nt = _conforming(d / "o.mesh")
    assert ok and nt > 384
    rc, _, err = _cli(base + ["-niter", "2", "-nobalance", "-out",
                              str(d / "nb.mesh")])
    assert rc == 0, err
    assert _conforming(d / "nb.mesh")[0]
    rc, _, err = _cli(base + ["-niter", "2", "-out", str(d / "x.mesh")])
    assert rc == 0, err
    assert "not yet ported" not in err and _conforming(d / "x.mesh")[0]


_TWO_PASSES = ["-hsiz", "0.3", "-ndev", "2", "-niter", "2"]


@pytest.fixture(scope="module")
def jax_cli_two_passes(cube_file):
    """The JAX CLI at ``-ndev 2 -niter 2`` on ``cube_file``, in a
    subprocess started with the module's first test."""
    from torch_parity import start_jax_cli
    proc = start_jax_cli(["-in", str(cube_file / "cube.mesh")] + _TWO_PASSES
                         + ["-out", str(cube_file / "j2.mesh"), "-v", "0",
                            "-bench-json"])
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def test_cli_ndev_two_passes_matches_jax_cli(cube_file, jax_cli_two_passes):
    """``-ndev 2 -niter 2`` (the repartitioning between the passes) on
    cube_mesh(3) at -hsiz 0.3 through the port's CLI and the JAX CLI (in
    a subprocess; the JAX CLI runs its 2 shards on 2 forced host devices,
    the port stacks them on one): both conforming, the tet counts within
    10% and qmean within 0.03 of each other (ROADMAP C1: the two compile
    the pass differently and part ways after pass 0)."""
    from torch_parity import jax_cli_records
    d = cube_file
    args = ["-in", str(d / "cube.mesh")] + _TWO_PASSES
    rc, out, err = _cli(args + ["-out", str(d / "t2.mesh"), "-bench-json"])
    assert rc == 0, err
    ok, nt = _conforming(d / "t2.mesh")
    tre = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    (rec,) = jax_cli_records(jax_cli_two_passes)
    jok, jnt = _conforming(d / "j2.mesh")
    assert ok and jok and jnt == rec["ntets"] and nt == tre[0]["ntets"]
    assert abs(nt - jnt) <= 0.1 * jnt, (nt, jnt)
    assert abs(tre[0]["qmean"] - rec["qmean"]) <= 0.03, (tre, rec)


def test_cli_distributed_output(cube_file):
    """``-ndev 2 -distributed-output``: 2 rank files whose communicator
    sections, read back, pass both echo oracles; read back as a
    distributed input, the shards are adopted as the partition."""
    from parmmg_tpu_torch.io.distributed import (interface_comms_of,
                                                 load_distributed_mesh,
                                                 probe_distributed)
    d = cube_file
    out = d / "do.mesh"
    rc, _, err = _cli(["-in", str(d / "cube.mesh"), "-hsiz", "0.3",
                       "-ndev", "2", "-niter", "1", "-distributed-output",
                       "-out", str(out)])
    assert rc == 0, err
    assert probe_distributed(out, 1) and not probe_distributed(out, 2)
    parts = [load_distributed_mesh(out, r) for r in range(2)]
    comms = interface_comms_of(parts)
    verts = [p[0].vert for p in parts]
    tets = [np.asarray(p[0].tetra, np.int64) for p in parts]
    cn = TCo.check_node_comms(comms, verts)
    cf = TCo.check_face_comms(comms, tets, verts)
    assert cn == JCo.check_node_comms(comms, verts)
    assert cn["mismatch"] == 0 and cn["items_checked"] > 0
    assert cf["mismatch"] == 0 and cf["items_checked"] > 0
    # the rank files as a distributed input of a 2-shard run
    rc, _, err = _cli(["-in", str(out), "-hsiz", "0.3", "-ndev", "2",
                       "-niter", "1", "-out", str(d / "again.mesh")])
    assert rc == 0, err
    assert _conforming(d / "again.mesh")[0]


# ---- the CLI across ranks ---------------------------------------------------

def _files(d):
    return {f.name: f.read_bytes() for f in sorted(d.iterdir())
            if f.is_file()}


@pytest.fixture(scope="module")
def one_process_cli(cube_file):
    """The port's CLI in this process (one torch thread), once a flag
    set: {flags: (directory of its outputs, rc, stdout)}."""
    runs = {}

    def run(flags):
        if flags not in runs:
            d = cube_file / f"one{len(runs)}"
            d.mkdir()
            rc, out, err = _cli(["-in", str(cube_file / "cube.mesh"),
                                 *flags, "-out", str(d / "o.mesh")])
            assert rc == 0, err
            runs[flags] = (d, out)
        return runs[flags]
    return run


def _cli_ranks(cube_file, flags, d, nproc=2, env1=None):
    """The port's CLI ``-device cpu`` as ``nproc`` ranks over gloo,
    started as an external launcher starts them (``WORLD_SIZE`` / ``RANK``
    / ``LOCAL_RANK``, ``-dist-init`` on a file store under ``d``, one
    torch thread a rank) and supervised by the pod runner's loop (the
    first failing rank kills the pack); ``env1`` adds to rank 1's
    environment.  The outputs go to ``d / "out"``.  Returns (rc, each
    rank's log)."""
    from parmmg_tpu_torch.parallel.multihost_run import (rank_env,
                                                         start_ranks,
                                                         supervise)
    (d / "out").mkdir()
    cmd = [sys.executable, "-m", "parmmg_tpu_torch.cli", "-in",
           str(cube_file / "cube.mesh"), *flags, "-out",
           str(d / "out" / "o.mesh"), "-device", "cpu", "-v", "1",
           "-dist-init", f"file://{d}/store"]
    envs = [dict(rank_env(nproc, r), OMP_NUM_THREADS="1")
            for r in range(nproc)]
    envs[1].update(env1 or {})
    logs = [str(d / f"r{r}.log") for r in range(nproc)]
    rc, _ = supervise(start_ranks([cmd] * nproc, envs, logs), timeout=240)
    return rc, [open(f).read() for f in logs]


_RANK_CASES = {"ndev2": ("-ndev", "2"),
               "ndev2_distout": ("-ndev", "2", "-distributed-output"),
               "ndev4": ("-ndev", "4")}


@pytest.mark.parametrize("case", sorted(_RANK_CASES))
def test_cli_ranks_write_the_one_process_bytes(cube_file, jax_cli_two_passes,
                                               one_process_cli, tmp_path,
                                               case):
    """``-ndev N -niter 2`` through the port's CLI as 2 ranks over gloo
    (G = N / 2 shards a rank; rank 0 polishes, runs the tail and writes,
    rank 1 leaves after the merge and prints nothing) writes the bytes of
    the one-process CLI run of the same flags: the ``.mesh`` and ``.sol``,
    with ``-distributed-output`` the 2 rank files.  Rank 0's record
    carries both ranks' (gloo, no nvcc build).  At ``-ndev 2`` it is held
    to the JAX CLI's ``-ndev 2 -niter 2`` run as that test holds the one
    process: tets within 10%, qmean within 0.03 (ROADMAP C1)."""
    from torch_parity import jax_cli_records
    flags = ("-hsiz", "0.3", "-niter", "2", "-bench-json") + \
        _RANK_CASES[case]
    ref_dir, ref_out = one_process_cli(flags)
    rc, logs = _cli_ranks(cube_file, flags, tmp_path)
    assert rc == 0, logs
    got = _files(tmp_path / "out")
    want = _files(ref_dir)
    assert sorted(got) == sorted(want) and len(got) >= 2
    for name in want:
        assert got[name] == want[name], name
    if case == "ndev2_distout":
        assert "o.1.mesh" in got and "o.2.mesh" not in got
    recs = [json.loads(ln) for ln in logs[0].splitlines()
            if ln.startswith("{")]
    (ref,) = [json.loads(ln) for ln in ref_out.splitlines()
              if ln.startswith("{")]
    assert len(recs) == 1 and "{" not in logs[1] and \
        "MESH QUALITY" not in logs[1]
    rec = recs[0]
    assert [r["rank"] for r in rec["ranks"]] == [0, 1]
    assert all(r["backend"] == "gloo" and not r["nvcc_builds"]
               for r in rec["ranks"])
    assert "ranks" not in ref
    for k in ("ntets", "qmin", "qmean", "nsplit", "ncollapse", "nswap",
              "cycles"):
        assert rec[k] == ref[k], k
    if case == "ndev2":
        (jrec,) = jax_cli_records(jax_cli_two_passes)
        assert abs(rec["ntets"] - jrec["ntets"]) <= 0.1 * jrec["ntets"]
        assert abs(rec["qmean"] - jrec["qmean"]) <= 0.03, (rec, jrec)


def test_cli_self_launch_writes_the_one_process_bytes(cube_file,
                                                      one_process_cli,
                                                      tmp_path, capfd,
                                                      monkeypatch):
    """``cli.launch_ranks``, the self-launch that ``-ndev N`` takes with
    several visible cards, run here with ``-device cpu`` at 2 ranks:
    the CLI started twice as the ranks of one gloo group over a file
    store of its own, rank 0's output on this process's; ``-ndev 4``
    (G = 2) writes the one-process bytes and returns 0."""
    from parmmg_tpu_torch import cli
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    flags = ("-hsiz", "0.3", "-niter", "2", "-ndev", "4", "-bench-json")
    ref_dir, _ = one_process_cli(flags)
    (tmp_path / "out").mkdir()
    argv = ["-in", str(cube_file / "cube.mesh"), *flags, "-out",
            str(tmp_path / "out" / "o.mesh"), "-device", "cpu", "-v", "1"]
    capfd.readouterr()
    assert cli.launch_ranks(argv, 2, "cpu") == 0
    out = capfd.readouterr().out
    (rec,) = [json.loads(ln) for ln in out.splitlines()
              if ln.startswith("{")]
    assert [r["rank"] for r in rec["ranks"]] == [0, 1]
    assert _files(tmp_path / "out") == _files(ref_dir)


@pytest.mark.parametrize("n,cards,want", [(4, 1, 1), (4, 4, 4), (8, 4, 4),
                                          (6, 4, 3), (4, 3, 2), (1, 4, 1),
                                          (4, 0, 1)])
def test_ranks_for(n, cards, want):
    """P of ``-ndev N`` on C visible cards: the largest divisor of N not
    above C; under a launcher, its rank count, which must divide N."""
    from parmmg_tpu_torch.parallel.multihost import ranks_for
    assert ranks_for(n, cards) == want
    assert ranks_for(n, cards, launched=1) == want
    assert ranks_for(8, 1, launched=4) == 4
    with pytest.raises(ValueError, match="does not split"):
        ranks_for(4, 4, launched=3)
    with pytest.raises(ValueError, match="does not split"):
        ranks_for(1, 1, launched=2)


def test_cli_rank_fault_fails_the_run(cube_file, tmp_path):
    """Rank 1 armed with the multihost crash drill's fault (it fails at
    its pass-1 extend exchange, no retry): the run exits non-zero and
    writes nothing."""
    rc, logs = _cli_ranks(
        cube_file, ("-hsiz", "0.3", "-ndev", "2", "-niter", "2"), tmp_path,
        env1={"PMTORCH_FAULT": "multihost.exchange:key=extend;nth-2",
              "PMTORCH_RETRY_MAX": "0"})
    assert rc != 0
    assert "multihost.exchange" in logs[1]
    assert not list((tmp_path / "out").iterdir())


def test_stacked_writer_with_comms_matches_jax(tmp_path):
    """``stacked_to_distributed_files`` with a distributed run's comm
    tables and numbering writes the JAX package's bytes."""
    from parmmg_tpu.io.distributed import \
        stacked_to_distributed_files as jwrite
    from parmmg_tpu_torch.io.distributed import stacked_to_distributed_files
    js, comms = _setup("morton", n=3)
    ts = _stack_from_jax(js)
    glo = TAP.extend_numbering(comms, [ts.capP] * 4)
    a = stacked_to_distributed_files(tmp_path / "t.mesh", ts, 4,
                                     comms=comms, glo=glo)
    b = jwrite(tmp_path / "j.mesh", js, comms, glo, 4)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert x.read_bytes() == y.read_bytes()
    assert "ParallelVertexCommunicators" in a[0].read_text()


def _comm_session(cls, **kw):
    pm = cls(nprocs=3, myrank=1, **kw)
    pm.set_mesh_size(np_=8, ne=6, nt=4)
    pm.set_number_of_node_communicators(2)
    pm.set_ith_node_communicator_size(0, color_out=0, nitem=3)
    pm.set_ith_node_communicator_nodes(0, [3, 1, 4], [30, 10, 40],
                                       is_not_ordered=True)
    pm.set_ith_node_communicator_size(1, color_out=2, nitem=2)
    pm.set_ith_node_communicator_nodes(1, [2, 5], [21, 50],
                                       is_not_ordered=False)
    pm.set_number_of_face_communicators(2)
    pm.set_ith_face_communicator_size(0, color_out=0, nitem=2)
    pm.set_ith_face_communicator_faces(0, [2, 1], [20, 10])
    pm.set_ith_face_communicator_size(1, color_out=2, nitem=1)
    pm.set_ith_face_communicator_faces(1, [3], [30], is_not_ordered=False)
    out = [pm.get_number_of_node_communicators(),
           pm.get_number_of_face_communicators()]
    for i in range(2):
        out += [pm.get_ith_node_communicator_size(i),
                pm.get_ith_node_communicator_nodes(i).tolist(),
                pm.get_ith_face_communicator_size(i),
                pm.get_ith_face_communicator_faces(i).tolist()]
    out += [pm.check_set_node_communicators(),
            pm.check_set_face_communicators()]
    for q in (pm.get_node_communicator_owners(),
              pm.get_face_communicator_owners()):
        out += [[o.tolist() for o in q[0]], [g.tolist() for g in q[1]],
                q[2], q[3]]
    pm.set_ith_face_communicator_faces(1, [99], [30], is_not_ordered=False)
    pm.set_ith_node_communicator_nodes(1, [0, 2], [21, 50])
    out += [pm.check_set_face_communicators(),
            pm.check_set_node_communicators()]
    return pm, out


def test_parmesh_communicators_match_jax(tmp_path):
    from parmmg_tpu.api.parmesh import ParMesh as JParMesh
    from parmmg_tpu_torch.api.parmesh import ParMesh
    pt, got = _comm_session(ParMesh, device="cpu")
    pj, want = _comm_session(JParMesh)
    assert got == want
    assert got[2] == (0, 3) and got[3] == [1, 3, 4]
    pt.print_communicator(str(tmp_path / "t.txt"))
    pj.print_communicator(str(tmp_path / "j.txt"))
    txt = (tmp_path / "t.txt").read_text()
    assert txt == (tmp_path / "j.txt").read_text()
    assert "rank 1 / 3" in txt and "color_out 2" in txt


def test_parmesh_runs_the_distributed_pass():
    from parmmg_tpu_torch.api.parmesh import ParMesh
    v, t = cube_mesh(3)
    pm = ParMesh(device="cpu")
    pm.set_mesh_size(np_=len(v), ne=len(t))
    pm.set_vertices(v)
    pm.set_tetrahedra(t + 1)
    pm.info.hsiz = 0.3
    pm.info.niter = 1
    pm.info.n_devices = 2
    pm.info.imprim = 0
    assert pm.run() == C.PMMG_SUCCESS
    assert pm.stats.cycles > 0 and len(pm.get_tetrahedra()[0]) > len(t)
    assert pm._out_part is None or len(pm._out_part) == \
        len(pm.get_tetrahedra()[0])
