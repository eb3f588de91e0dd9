"""The port's repartitioning between distributed passes held against the
JAX package: ``parallel/migrate.py`` (flood labels, the full-view
migration, the welds, ``rebuild_shards``, graph labels) and
``parallel/migrate_dev.py`` (the band migration, the retag, the weld
probe, the flood repair, graph labels from device tables), and the
two-pass ``distributed_adapt_multi``.

Exact (integers and topology bit for bit, the float fields too, since
they are copies): ``flood_labels`` on ``tests/test_migrate.py``'s equal
halves of cube_mesh(6), on ``tests/test_flood_repair.py``'s unequal
halves of cube_mesh(4) and on 4 Morton parts; ``repair_flood_labels`` on
``tests/test_flood_repair.py``'s three manufactured cases and its healthy
flood; ``rebuild_shards``; ``band_migrate_iteration`` + ``band_weld`` +
``rebuild_shards`` on ``tests/test_band_path.py``'s two shards of
cube_mesh(2) (a hand-picked band and a flood band) and on 4 Morton parts
of cube_mesh(3): every ``MeshStack`` field, the metric, ``glo_d``, the
host ``glo``, the comm tables and ``shared_now``, but for the JAX
package's cross-shard liveness (ROADMAP C2), pinned row by row; the
full-view ``migrate_shards`` + ``weld_shard_bands``
on the same inputs, which agree with the band path as
``tests/test_band_path.py`` requires (tet sets, frozen faces and
interface size); a forced band overflow (tiny budgets), after which the
inputs are unmodified and the full-view fallback matches JAX's;
``enforce_ne_min``; both graph-mode label functions.

The whole loop: ``distributed_adapt_multi(niter=2, cycles=2)`` on
cube_mesh(3) under the shock size map h = 0.3 on 2 and 4 shards, and in
graph mode on 4 shards from the end slabs of cube_mesh(6), against the
JAX package's compiled loop with ``n_devices=1`` (G = the shard count, as
the port stacks them) in a subprocess each: pass 0's op counts and tets
(ROADMAP C1's 2 vertices on 4 shards aside) and the migration step, run
on the port's own state through both packages, exact; the end state,
where pass 1 parts ways on slot order, by C1 rules.  The port's
``steady_state_migration_scenario`` (cube_mesh(2), 2 shards, 4 passes)
against JAX's by the one-pass test's rule.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.ops.analysis import analyze_mesh as janalyze
from parmmg_tpu.parallel import comms as JCo, dist as JDi
from parmmg_tpu.parallel import distribute as JDs
from parmmg_tpu.parallel import migrate as JM, migrate_dev as JMD
from parmmg_tpu_torch.core import constants as C
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.ops import analysis as TN
from parmmg_tpu_torch.ops.adapt import AdaptStats
from parmmg_tpu_torch.ops.adjacency import build_adjacency, check_adjacency
from parmmg_tpu_torch.ops.quality import tet_quality
from parmmg_tpu_torch.parallel import dist as TDi
from parmmg_tpu_torch.parallel import migrate as TM, migrate_dev as TMD
from parmmg_tpu_torch.parallel.partition import (fix_contiguity,
                                                 morton_partition)
from parmmg_tpu_torch.utils.fixtures import (analytic_iso_metric, cube_mesh,
                                             end_slabs_partition)
from torch_parity import jax_ledger_listener_compat  # noqa: F401


# ---- shared inputs ---------------------------------------------------------

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


def _i32(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _stack(js):
    """The port's MeshStack of a JAX stacked mesh (tags as int32)."""
    return tmesh.MeshStack(**{k: torch.from_numpy(np.array(_i32(
        getattr(js, k)))) for k in jmesh.MESH_FIELDS})


def _same_stack(ts, js, what=""):
    for f in jmesh.MESH_FIELDS:
        assert np.array_equal(getattr(ts, f).numpy(),
                              _i32(getattr(js, f))), (what, f)


def _same_comms(a, b):
    for f in ("nbr", "node_idx", "node_cnt", "face_idx", "face_cnt"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert all(np.array_equal(x, y) for x, y in zip(a.owner, b.owner))


def _jstate(n=2, capmul=4, h=0.5, part_kind="x>0.5", nparts=2,
            cap_mult=3.0):
    """A JAX split (stacked shards, metric, host numbering, comms) of
    cube_mesh(n) at ``capmul`` x capacity under the uniform size ``h``:
    x slabs at the cut of ``part_kind`` or ``nparts`` Morton parts."""
    vert, tet = cube_mesh(n)
    m = jmesh.make_mesh(vert, tet, capP=capmul * len(vert),
                        capT=capmul * len(tet))
    m = janalyze(m).mesh
    met = jnp.full(m.capP, h, m.vert.dtype)
    vert_h, tet_h = jmesh.mesh_to_host(m)[:2]
    cent = vert_h[tet_h].mean(axis=1)
    if part_kind == "morton":
        part = fix_contiguity(tet_h, morton_partition(cent, nparts))
    else:
        part = (cent[:, 0] > float(part_kind[2:])).astype(np.int32)
    s, ms, l2g = JDs.split_to_shards(m, met, part, nparts,
                                     cap_mult=cap_mult, return_l2g=True)
    g2l = []
    for s_ in range(nparts):
        mm = np.full(len(vert_h), -1, np.int64)
        mm[l2g[s_]] = np.arange(len(l2g[s_]))
        g2l.append(mm)
    comms = JCo.build_interface_comms(tet_h, part, nparts, l2g, g2l)
    capP = s.vert.shape[1]
    glo = [np.full(capP, -1, np.int64) for _ in range(nparts)]
    for s_ in range(nparts):
        glo[s_][: len(l2g[s_])] = l2g[s_]
    return s, ms, glo, comms


def _shared_prev(glo, comms, S):
    return np.unique(np.concatenate(
        [glo[s][np.unique(comms.node_idx[s][comms.node_idx[s] >= 0])]
         for s in range(S)]))


# ---- the JAX package's loops, in subprocesses -----------------------------

# one JAX run a subprocess, its result pickled to argv[2]: the compiled loop
# (n_devices=1) on the pickled input of argv[1] (mesh fields, metric,
# shards, mode, initial split), or (argv[1] == "scenario") JAX's
# steady_state_migration_scenario.  The first band migration's inputs are
# caught on the way: pass 0's op counts and the stacked state it starts from
_JAX_LOOP = """
import pickle, sys
sys.path.insert(0, 'tests')
import torch_parity
torch_parity.wrap_ledger_listener()
import numpy as np
import jax.numpy as jnp
from parmmg_tpu.core import mesh as jmesh
from parmmg_tpu.ops.adapt import AdaptStats
from parmmg_tpu.parallel import dist, migrate_dev
from parmmg_tpu.utils.fixtures import steady_state_migration_scenario
src, dst = sys.argv[1:3]
st = AdaptStats()
pre = {}
real = migrate_dev.band_migrate_iteration


def first_migration(stacked, met_s, *a, **kw):
    if not pre:
        pre['ops'] = (st.cycles, st.nsplit, st.ncollapse, st.nswap,
                      st.nmoved)
        pre['act'] = list(st.sched_extra.get('active_shards_per_cycle', []))
        pre['state'] = {k: np.asarray(getattr(stacked, k))
                        for k in jmesh.MESH_FIELDS}
        pre['met'] = np.asarray(met_s)
    return real(stacked, met_s, *a, **kw)


migrate_dev.band_migrate_iteration = first_migration
if src == 'scenario':
    out = steady_state_migration_scenario(n_devices=1, return_all=True)
else:
    with open(src, 'rb') as f:
        fields, met, n, mode, part = pickle.load(f)
    m = jmesh.Mesh(**{k: jnp.asarray(v) for k, v in fields.items()})
    out = dist.distributed_adapt_multi(m, jnp.asarray(met), n, niter=2,
                                       cycles=2, n_devices=1, stats=st,
                                       mode=mode, part=part)
mesh, met_o, part = out
res = ({k: np.asarray(getattr(mesh, k)) for k in jmesh.MESH_FIELDS},
       np.asarray(met_o), np.asarray(part),
       (st.cycles, st.nsplit, st.ncollapse, st.nswap, st.nmoved),
       st.sched_extra.get('active_shards_per_cycle', []), pre)
with open(dst, 'wb') as f:
    pickle.dump(res, f)
"""

# the whole-loop inputs: (cube_mesh n, shock h, shards, mode, the core of
# end_slabs_partition or None for the loop's own Morton split).  Graph mode
# starts from the end slabs of cube_mesh(6), where clusters move; from the
# loop's own split no cluster has a positive cut gain
_LOOPS = {2: (3, 0.3, 2, "ifc", None), 4: (3, 0.3, 4, "ifc", None),
          "graph4": (6, 0.3, 4, "graph", 0.1)}


def _loop_input(key):
    """(mesh, met, shards, mode, initial split) of a whole-loop case."""
    n, h, S, mode, core = _LOOPS[key]
    v, t = cube_mesh(n)
    m = TN.analyze_mesh(tmesh.make_mesh(v, t, capP=4 * len(v),
                                        capT=4 * len(t))).mesh
    met = np.ones(m.capP, np.float32)
    met[: len(v)] = analytic_iso_metric(v, "shock", h=h)
    part = None if core is None else end_slabs_partition(v, t, core=core)
    return m, torch.from_numpy(met), S, mode, part


@pytest.fixture(scope="module")
def jax_loops(tmp_path_factory):
    """The JAX package's compiled two-pass loops of ``_LOOPS`` (one
    device, G = the shard count) and its steady_state_migration_scenario
    (2 shards on one device), each in a subprocess started here, so that
    they compile while the module's other tests run (each takes about a
    minute on the CPU): a function of the key (one of ``_LOOPS`` or
    "scenario") that waits for its run and returns (mesh, met, part, op
    counts, active shards a cycle, {"ops", "act", "state", "met"} at the
    first band migration)."""
    import os
    import pickle
    import subprocess
    import sys
    from torch_parity import ROOT
    d = tmp_path_factory.mktemp("jax_loops")
    srcs = {"scenario": "scenario"}
    for key in _LOOPS:
        m, met, S, mode, part = _loop_input(key)
        srcs[key] = str(d / f"{key}.in.pkl")
        with open(srcs[key], "wb") as f:
            pickle.dump((tmesh.mesh_to_numpy(m), met.numpy(), S, mode, part),
                        f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PARMMG_SWAP_FACESORT="1")
    procs = {k: subprocess.Popen(
        [sys.executable, "-c", _JAX_LOOP, src, str(d / f"{k}.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for k, src in srcs.items()}
    done = {}

    def result(key):
        if key not in done:
            out, err = procs[key].communicate(timeout=1200)
            assert procs[key].returncode == 0, (out + err)[-3000:]
            with open(d / f"{key}.pkl", "rb") as f:
                fields, met_o, part, counts, act, pre = pickle.load(f)
            done[key] = (jmesh.Mesh(**{k: jnp.asarray(v)
                                       for k, v in fields.items()}),
                         jnp.asarray(met_o), part, counts, act, pre)
        return done[key]
    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


# ---- flood labels and their repair -----------------------------------------

_FLOOD_CASES = {"halves6": dict(n=6, capmul=4, h=0.3, part_kind="x>0.5"),
                "unequal4": dict(n=4, capmul=4, h=0.3, part_kind="x>0.4"),
                "morton4": dict(n=4, capmul=4, h=0.3, part_kind="morton",
                                nparts=4)}


@pytest.mark.parametrize("case,nlayers", [("halves6", 2), ("unequal4", 2),
                                          ("morton4", 2), ("morton4", 3)])
def test_flood_labels_exact(jax_loops, case, nlayers):
    """(``jax_loops`` starts the JAX package's loops here, so that they
    go on while the module's other tests run.)"""
    kw = _FLOOD_CASES[case]
    S = kw.get("nparts", 2)
    js, _, _, comms = _jstate(**dict(kw, cap_mult=3.0))
    sizes = np.asarray(js.tmask).sum(axis=1).astype(np.int32)
    jl, jd = JM.flood_labels(js, jnp.asarray(comms.node_idx),
                             jnp.asarray(comms.nbr), jnp.asarray(sizes), S,
                             nlayers=nlayers)
    tl, td = TM.flood_labels(_stack(js), comms.node_idx, comms.nbr,
                             torch.from_numpy(sizes), S, nlayers=nlayers)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    tm = np.asarray(js.tmask)
    moved = tm & (tl.numpy() != np.arange(S)[:, None])
    assert 0 < moved.sum() < tm.sum()
    assert set(np.unique(td.numpy()[moved])) <= set(range(1, nlayers + 1))


def _repair_case(kind):
    """tests/test_flood_repair.py's inputs: (stacked with adjacency,
    labels, depth) on the halves of cube_mesh(4)."""
    if kind == "healthy":
        js, _, _, comms = _jstate(n=4, capmul=4, h=0.3, part_kind="x>0.4",
                                  cap_mult=3.0)
        js = JM.rebuild_shards(js)
        sizes = jnp.asarray(np.asarray(js.tmask).sum(axis=1)
                            .astype(np.int32))
        lab, dep = JM.flood_labels(js, jnp.asarray(comms.node_idx),
                                   jnp.asarray(comms.nbr), sizes, 2,
                                   nlayers=2)
        return js, np.asarray(lab), np.asarray(dep)
    js, _, _, _ = _jstate(n=4, capmul=4, h=0.3, part_kind="x>0.5",
                          cap_mult=3.0)
    js = JM.rebuild_shards(js)
    capT = js.tet.shape[1]
    tm0 = np.asarray(js.tmask[0])
    tet0 = np.asarray(js.tet[0])
    vtag = np.asarray(js.vtag[0])
    on_ifc = (vtag & C.MG_PARBDY) != 0
    ifc = tm0 & on_ifc[np.clip(tet0, 0, len(vtag) - 1)].any(axis=1)
    labels = np.zeros((2, capT), np.int32)
    labels[1, :] = 1
    depth = np.zeros((2, capT), np.int32)
    if kind == "orphan":
        orphan = int(np.where(tm0 & ~ifc)[0][0])
        labels[0, orphan], depth[0, orphan] = 1, 2
    elif kind == "front":
        mover = int(np.where(ifc)[0][0])
        labels[0, mover], depth[0, mover] = 1, 1
    else:                                   # an enclosed pocket
        interior = np.where(tm0 & ~ifc)[0]
        pocket = int(interior[len(interior) // 2])
        pv = set(tet0[pocket].tolist())
        live = np.where(tm0)[0]
        ring = [i for i in live if i != pocket and pv & set(tet0[i])]
        rv = set(tet0[ring].reshape(-1).tolist())
        ring2 = [i for i in live if i != pocket and rv & set(tet0[i])]
        movers = np.unique(np.asarray(ring + ring2))
        labels[0, movers], depth[0, movers] = 1, 1
    return js, labels, depth


@pytest.mark.parametrize("kind", ["orphan", "front", "pocket", "healthy"])
def test_repair_flood_labels_exact(kind):
    js, labels, depth = _repair_case(kind)
    jl, jn = JMD.repair_flood_labels(js, jnp.asarray(labels),
                                     jnp.asarray(depth), 2)
    tl, tn = TMD.repair_flood_labels(_stack(js), torch.from_numpy(labels),
                                     torch.from_numpy(depth), 2)
    assert tn == jn and np.array_equal(tl.numpy(), np.asarray(jl))
    if kind in ("orphan", "pocket"):
        assert tn >= 1
    elif kind == "front":
        assert tn == 0


def test_rebuild_shards_exact():
    js, _, _, _ = _jstate(n=3, capmul=4, h=0.3, part_kind="morton",
                          nparts=4)
    _same_stack(TM.rebuild_shards(_stack(js)), JM.rebuild_shards(js))


# ---- the band path, the full-view path and the welds -----------------------

def _band_labels(kind, js, comms):
    S, capT = js.tet.shape[:2]
    tm = np.asarray(js.tmask)
    labels = np.tile(np.arange(S, dtype=np.int32)[:, None], (1, capT))
    depth = np.zeros((S, capT), np.int32)
    if kind == "hand":                 # tests/test_band_path.py's band
        labels[0, np.where(tm[0])[0][:3]] = 1
    else:
        sizes = jnp.asarray(tm.sum(axis=1).astype(np.int32))
        lab, dep = JM.flood_labels(js, jnp.asarray(comms.node_idx),
                                   jnp.asarray(comms.nbr), sizes, S)
        labels, depth = np.array(lab), np.array(dep)
    return labels, depth


def _band_run(mods, js, jms, glo, labels, depth, shared_prev):
    """band_migrate_iteration + band_weld + rebuild_shards through one
    package (``mods`` its migrate, migrate_dev and the array maker)."""
    M, MD, arr = mods
    S = len(glo)
    glo_h = [g.copy() for g in glo]
    glo_d = arr(np.stack(glo).astype(np.int32))
    res = MD.band_migrate_iteration(js, jms, glo_d, glo_h, arr(labels),
                                    arr(depth), shared_prev, S)
    assert res is not None, "the band budgets hold on this input"
    st, met, gd, comms2, shared_now, nmoved, arr_slots = res
    st, gd, nweld = MD.band_weld(st, met, gd, glo_h, arr_slots, S)
    return (M.rebuild_shards(st), met, gd, glo_h, comms2, shared_now,
            nmoved, arr_slots, nweld)


def _full_run(M, js, jms, glo, labels):
    """migrate_shards + weld_shard_bands + rebuild_shards."""
    S = len(glo)
    glo_h = [g.copy() for g in glo]
    views = M.pull_views(js, jms)
    tm = views.tmask.copy()
    touched = sorted({int(r) for s in range(S)
                      for r in np.unique(labels[s][tm[s]]) if int(r) != s})
    st, met, comms2, nmoved = M.migrate_shards(js, jms, views, glo_h,
                                               labels, S)
    st, nweld = M.weld_shard_bands(st, views, glo_h, S, touched=touched)
    return M.rebuild_shards(st), met, glo_h, comms2, nmoved, nweld


def _tet_keys(stacked, glo):
    tm = np.asarray(stacked.tmask)
    tet = np.asarray(stacked.tet)
    return [{tuple(k) for k in np.sort(glo[s][tet[s][tm[s]]], axis=1)}
            for s in range(len(glo))]


def _frozen_faces(stacked, glo):
    tm = np.asarray(stacked.tmask)
    ftag = np.asarray(stacked.ftag)
    tet = np.asarray(stacked.tet)
    out = set()
    for s in range(len(glo)):
        r, c = np.where(((ftag[s] & C.MG_PARBDY) != 0) & tm[s][:, None])
        tri = np.sort(glo[s][tet[s][r]][np.arange(len(r))[:, None],
                                        C.IDIR[c]], axis=1)
        out |= {tuple(k) for k in tri}
    return out


_JAX = (JM, JMD, jnp.asarray)
_TORCH = (TM, TMD, torch.from_numpy)


def _own_rows(st):
    """[S, capP] bool: the vertex rows the live tets of each shard
    reference (the liveness of a shard)."""
    tet, tm = np.asarray(st.tet), np.asarray(st.tmask)
    S, capP = np.asarray(st.vmask).shape
    ref = np.zeros((S, capP), bool)
    for s in range(S):
        ref[s, tet[s][tm[s]].reshape(-1)] = True
    return ref


def _node_items(comms, drop):
    """{(a, b): [(row in a, row in b)]} of the node comm tables, items
    with a row in ``drop`` [S, capP] left out."""
    out = {}
    for a in range(comms.nbr.shape[0]):
        for k, b in enumerate(comms.nbr[a]):
            if b < 0 or b < a:
                continue
            kb = int(np.where(comms.nbr[b] == a)[0][0])
            n = int(comms.node_cnt[a, k])
            ra, rb = comms.node_idx[a, k, :n], comms.node_idx[b, kb, :n]
            keep = ~(drop[a][ra] | drop[int(b)][rb])
            out[(a, int(b))] = list(zip(ra[keep].tolist(),
                                        rb[keep].tolist()))
    return out


def _face_items(comms):
    """{(a, b): [(slot in a, slot in b)]} of the face comm tables."""
    out = {}
    for a in range(comms.nbr.shape[0]):
        for k, b in enumerate(comms.nbr[a]):
            if b < 0 or b < a:
                continue
            kb = int(np.where(comms.nbr[b] == a)[0][0])
            n = int(comms.face_cnt[a, k])
            out[(a, int(b))] = list(zip(
                comms.face_idx[a, k, :n].tolist(),
                comms.face_idx[b, kb, :n].tolist()))
    return out


def _same_band_result(tb, jb):
    """The band path's results (``_band_run``) of the port (``tb``) and
    the JAX package (``jb``) on the same input.  Exact: every tet field,
    vert, vref, the metric, adjacency, face and edge tags, the face comm
    tables, the moved and welded counts, the arrival slots.  The JAX
    package's ``device_migrate`` marks a vertex row live in a shard when
    ANY shard's live tets use that row index (its ``.at[sidx[..., None],
    tid.reshape(S, -1)]`` broadcasts the shard axis against every
    shard's ids; ROADMAP C2): the rows a departing band leaves behind stay
    live, unreferenced, with their old ids.  The port marks the shard's
    own rows.  So: the port's liveness is each shard's referenced rows;
    JAX's is that plus those zombie rows, each referenced in another
    shard; the numbering (device and host), the shared gids, the node
    comm tables, the owners and the vertex tags are JAX's with the zombie
    rows, and the gids they alone made shared, taken out, and so are the
    neighbour pairs those rows alone join; a shared gid's owner is its
    highest holder, JAX's counting the zombie holders.  Returns the zombie
    rows [S, capP]."""
    S = len(tb[3])
    for f in ("vert", "vref", "tet", "tref", "tmask", "adja", "ftag",
              "fref", "etag", "nelem"):
        assert np.array_equal(getattr(tb[0], f).cpu().numpy(),
                              _i32(getattr(jb[0], f))), f
    assert np.array_equal(tb[1].cpu().numpy(), np.asarray(jb[1]))
    assert tb[6] == jb[6] > 0 and tb[8] == jb[8]
    assert np.array_equal(tb[7], jb[7])
    # liveness: the port's is each shard's own; JAX's adds zombie rows
    # referenced in another shard
    own = _own_rows(tb[0].map(lambda x: x.cpu()))
    vm, jvm = tb[0].vmask.cpu().numpy(), np.asarray(jb[0].vmask)
    assert np.array_equal(vm, own)
    zom = jvm & ~own
    assert not (vm & ~jvm).any()
    for s in range(S):
        assert (zom[s] <= np.delete(own, s, axis=0).any(axis=0)).all()
    assert tb[0].npoin.tolist() == [int(np.nonzero(v)[0].max()) + 1
                                    for v in vm]
    # the numbering: JAX's without the zombie rows, in lockstep
    jg = np.asarray(jb[2])
    tg = tb[2].cpu().numpy()
    assert np.array_equal(tg, np.where(zom, -1, jg))
    for s in range(S):
        assert np.array_equal(tb[3][s], np.where(zom[s], -1, jb[3][s]))
        assert (tg[s][vm[s]] == tb[3][s][vm[s]]).all()
        assert (tb[3][s][~vm[s]] == -1).all()
    # shared gids: JAX's counted over live non-zombie rows
    live_g = [set(tb[3][s][vm[s]].tolist()) for s in range(S)]
    want_sh = [g for g in jb[5].tolist()
               if sum(g in live_g[s] for s in range(S)) >= 2]
    assert tb[5].tolist() == want_sh
    gone = set(jb[5].tolist()) - set(want_sh)
    # rows of the gids only zombies made shared, in any shard
    odd = zom.copy()
    for s in range(S):
        odd[s] |= np.isin(tb[3][s], list(gone)) & vm[s]
    # the comm tables pair by pair: a pair of shards that only zombie
    # rows join (no face, every node item odd) is JAX's alone
    tf, jf = _face_items(tb[4]), _face_items(jb[4])
    tn, jn = _node_items(tb[4], odd), _node_items(jb[4], odd)
    only_j = set(jf) - set(tf)
    assert set(tf) <= set(jf) and all(not jf[k] and not jn[k]
                                      for k in only_j)
    assert tf == {k: v for k, v in jf.items() if k not in only_j}
    assert tn == {k: v for k, v in jn.items() if k not in only_j}
    assert tn == _node_items(tb[4], zom & False)
    # owners: the highest shard holding a shared gid, zombie holders
    # counted in JAX's; vertex tags equal off the odd rows
    jlive_g = [set(jb[3][s][jvm[s]].tolist()) for s in range(S)]
    shared = set(want_sh)
    vtag, jvtag = tb[0].vtag.cpu().numpy(), _i32(jb[0].vtag)
    for s in range(S):
        ok = vm[s] & ~odd[s]
        gids = tb[3][s][ok].tolist()
        assert tb[4].owner[s][ok].tolist() == [
            max(r for r in range(S) if g in live_g[r]) if g in shared
            else s for g in gids]
        assert jb[4].owner[s][ok].tolist() == [
            max(r for r in range(S) if g in jlive_g[r]) if g in shared
            else s for g in gids]
        assert np.array_equal(vtag[s][ok], jvtag[s][ok])
    return zom


# (labels, cube_mesh n, split, shards)
_BAND_CASES = {"hand": ("hand", 2, "x>0.5", 2),
               "flood": ("flood", 2, "x>0.5", 2),
               "flood-morton4": ("flood", 3, "morton", 4)}


@pytest.mark.parametrize("case", list(_BAND_CASES))
def test_band_and_full_view_paths_exact(case):
    """The band path through both packages on the same input, by
    :func:`_same_band_result` (``tests/test_band_path.py``'s two shards of
    cube_mesh(2), and 4 Morton parts of cube_mesh(3): three and more
    holders a node, multiway faces); the full-view path exact against
    JAX's, and the two paths agreeing as ``tests/test_band_path.py``
    requires."""
    kind, n, split, S = _BAND_CASES[case]
    js, jms, glo, comms = _jstate(n=n, part_kind=split, nparts=S)
    labels, depth = _band_labels(kind, js, comms)
    ts, tms = _stack(js), torch.from_numpy(np.asarray(jms))
    snap = [x.clone() for x in (ts.vert, ts.tet, ts.tmask, ts.vtag, tms)]
    sp = _shared_prev(glo, comms, S)
    jb = _band_run(_JAX, js, jms, glo, labels, depth, sp)
    tb = _band_run(_TORCH, ts, tms, glo, labels, depth, sp)
    # no write into the inputs
    assert all(torch.equal(a, b) for a, b in zip(
        snap, (ts.vert, ts.tet, ts.tmask, ts.vtag, tms)))
    zom = _same_band_result(tb, jb)
    assert zom.any()
    assert tb[6] == 3 or kind == "flood"
    if S > 2:                          # nodes of three and more shards
        own = _own_rows(js)
        assert np.bincount(np.concatenate(
            [glo[s][own[s]] for s in range(S)])).max() >= 3
    # the full-view path, exact against JAX's, on the labels the band
    # path's donor floor left (it reverts the deepest layer's first
    # slots, enforce_ne_min its last ones)
    gd = np.stack(glo).astype(np.int32)
    kb, kv = max(256, ts.capT // 2), max(256, ts.capP // 2)
    lab_f = TMD.device_migrate(ts, tms, torch.from_numpy(gd),
                               torch.from_numpy(labels),
                               torch.from_numpy(depth), KB=kb,
                               KV=kv)[3]["labels"].numpy()
    assert np.array_equal(lab_f, np.asarray(JMD.device_migrate(
        js, jms, jnp.asarray(gd), jnp.asarray(labels), jnp.asarray(depth),
        KB=kb, KV=kv)[3]["labels"]))
    jf = _full_run(JM, js, jms, glo, lab_f)
    tf = _full_run(TM, ts, tms, glo, lab_f)
    _same_stack(tf[0], jf[0], "full")
    assert np.array_equal(tf[1].numpy(), np.asarray(jf[1]))
    assert all(np.array_equal(a, b) for a, b in zip(tf[2], jf[2]))
    _same_comms(tf[3], jf[3])
    assert tf[4:] == jf[4:]
    # the two paths agree (tests/test_band_path.py's rule), and the
    # band path's liveness is the full-view path's
    assert _tet_keys(tb[0], tb[3]) == _tet_keys(tf[0], tf[2])
    assert _frozen_faces(tb[0], tb[3]) == _frozen_faces(tf[0], tf[2])
    assert int((tb[4].face_idx >= 0).sum()) == \
        int((tf[3].face_idx >= 0).sum())
    assert tb[0].vmask.sum().item() == int(tf[0].vmask.sum())
    for s in range(S):
        bad = check_adjacency(build_adjacency(tb[0].slot(s)))
        assert not bad["asymmetric"] and not bad["face_mismatch"]


def test_enforce_ne_min_exact():
    rng = np.random.default_rng(7)
    S, capT = 3, 60
    tmask = rng.random((S, capT)) < 0.8
    labels = rng.integers(0, S, (S, capT)).astype(np.int32)
    depth = rng.integers(0, 3, (S, capT)).astype(np.int32)
    tmask[2, 10:] = False          # a shard of 10 live tets donates most
    for kw in ({}, {"depth": depth}, {"ne_min": 30},
               {"ne_min": 30, "depth": depth}):
        got = TM.enforce_ne_min(labels, tmask, S, **kw)
        want = JM.enforce_ne_min(labels, tmask, S, **kw)
        assert np.array_equal(got, want), kw
    assert not np.array_equal(TM.enforce_ne_min(labels, tmask, S), labels)


def test_graph_labels_exact():
    """Both graph-mode label functions on 3 Morton parts of cube_mesh(3)
    with adjacency (17 and 13 tets change shard; on slabs and on equal
    Morton parts no cluster moves)."""
    js, jms, glo, comms = _jstate(n=3, capmul=4, h=0.3, part_kind="morton",
                                  nparts=3)
    js = JM.rebuild_shards(js)
    ts = _stack(js)
    want = JM.graph_repartition_labels(JM.pull_views(js, jms), glo, 3)
    got = TM.graph_repartition_labels(TM.pull_views(ts, torch.from_numpy(
        np.asarray(jms))), glo, 3)
    assert np.array_equal(got, want)
    jb = JMD.graph_repartition_labels_band(js, comms, 3)
    tb = TMD.graph_repartition_labels_band(ts, comms, 3)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    tm = ts.tmask.numpy()
    me = np.arange(3)[:, None]
    assert (tm & (got != me)).sum() > 0 and (tm & (tb.numpy() != me)).sum()


# ---- the whole loop --------------------------------------------------------

def _loop_rule(mesh, met_o, jm_o, jmet_o, what):
    """The end-state rule against the compiled JAX loop (ROADMAP C1:
    after pass 0 compiled XLA holds the same tets and vertices in other
    slots, the migration fills other free rows, and pass 1's waves,
    whose ties break by slot, part ways): live tets within 5%, vertices
    (JAX's referenced ones: its zombie rows, ROADMAP C2, stay live in
    the merge) within 5%, qmin > 0 and within 35% of JAX's, qmean within
    0.03; the port's mesh conforming, of volume 1, with no interface tag
    left and no unreferenced vertex."""
    tm = mesh.tmask.numpy()
    nt, jnt = int(tm.sum()), int(np.asarray(jm_o.tmask).sum())
    own = _own_rows(tmesh.MeshStack(**{k: getattr(mesh, k)[None] for k in
                                       tmesh.MESH_FIELDS}))[0]
    jown = _own_rows(jmesh.Mesh(**{k: np.asarray(getattr(jm_o, k))[None]
                                   for k in jmesh.MESH_FIELDS}))[0]
    nv, jnv = int(mesh.vmask.sum()), int(jown.sum())
    q = tet_quality(mesh, met_o).numpy()[tm]
    jq = np.asarray(JDi.tet_quality(jm_o, jmet_o))[np.asarray(jm_o.tmask)]
    msg = (what, nt, jnt, nv, jnv, q.min(), jq.min(), q.mean(), jq.mean())
    assert abs(nt - jnt) <= 0.05 * jnt and abs(nv - jnv) <= 0.05 * jnv, msg
    assert q.min() > 0 and abs(q.min() - jq.min()) <= 0.35 * jq.min(), msg
    assert abs(q.mean() - jq.mean()) <= 0.03, msg
    assert np.array_equal(mesh.vmask.numpy(), own)
    bad = check_adjacency(build_adjacency(mesh))
    assert not bad["asymmetric"] and not bad["face_mismatch"]
    vols = tmesh.tet_volumes(mesh)[mesh.tmask].numpy()
    assert (vols > 0).all() and np.isclose(vols.sum(), 1.0, rtol=1e-4)
    assert int(((mesh.vtag & C.MG_PARBDY) != 0).sum()) == 0
    return msg


def _port_loop(monkeypatch, key):
    """The port's two-pass loop of ``_LOOPS[key]``, the band migration's
    inputs caught on the way (pass 0's op counts; for the first try and
    each grow retry the stacked state, metric, numbering, labels, depth,
    shared gids and its moved tets, None when a budget was blown; the
    arguments of the labels' function): (mesh, met, part, stats,
    caught)."""
    m, met, S, mode, part = _loop_input(key)
    st = AdaptStats()
    cap = {}
    real = TMD.band_migrate_iteration

    def first_migration(stacked, met_s, glo_d, glo, labels_d, depth_d,
                        shared_prev, n_shards, **kw):
        if "ops" not in cap:
            cap.update(
                ops=(st.cycles, st.nsplit, st.ncollapse, st.nswap,
                     st.nmoved),
                act=list(st.sched_extra.get("active_shards_per_cycle",
                                            [])), calls=[])
        if len(cap["calls"]) < 4:           # the first try, the retries
            call = dict(state=stacked.map(torch.clone), met=met_s.clone(),
                        glo_d=glo_d.clone(), glo=[g.copy() for g in glo],
                        labels=labels_d.clone(), depth=depth_d.clone(),
                        shared_prev=np.array(shared_prev))
            cap["calls"].append(call)
        res = real(stacked, met_s, glo_d, glo, labels_d, depth_d,
                   shared_prev, n_shards, **kw)
        if len(cap["calls"]) <= 4:
            call["nmoved"] = None if res is None else res[5]
        return res
    monkeypatch.setattr(TMD, "band_migrate_iteration", first_migration)
    for mod, name in ((TM, "flood_labels"),
                      (TMD, "graph_repartition_labels_band")):
        def keep(*a, _fn=getattr(mod, name), _name=name, **kw):
            cap.setdefault(_name, (a[1:], kw))
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, keep)
    mesh, met_o, part_o = TDi.distributed_adapt_multi(
        m, met, S, niter=2, cycles=2, stats=st, mode=mode, part=part)
    monkeypatch.undo()
    return mesh, met_o, part_o, st, cap


def _named_tets(f, s, jf, tol=1e-6):
    """Shard ``s``'s live tets of the state ``f`` (numpy fields), each
    vertex named by the row of ``jf``'s shard ``s`` within ``tol`` of it
    (-1 if none): (tets [n, 4] of names, unmatched vertices of ``f``,
    unmatched vertices of ``jf``, jf's live tets [m, 4] of rows)."""
    tet = f["tet"][s][f["tmask"][s]]
    jt = jf["tet"][s][jf["tmask"][s]]
    rows = np.unique(tet)
    jrows = np.unique(jt)
    d = np.abs(f["vert"][s][rows][:, None, :] -
               jf["vert"][s][jrows][None, :, :]).max(axis=2)
    name = np.full(f["vert"].shape[1], -1, np.int64)
    hit = d.min(axis=1) <= tol
    name[rows[hit]] = jrows[d.argmin(axis=1)[hit]]
    moved_j = np.zeros(jf["vert"].shape[1], bool)
    moved_j[jrows[d.min(axis=0) > tol]] = True
    return name[tet], int((~hit).sum()), moved_j, jt


def _pass0_rule(cap, jpre, S, max_moved, max_diff):
    """Pass 0 of the port's loop against the compiled JAX loop's, at the
    first band migration: op counts and active shards a cycle exact;
    each shard's live tets equal as a set (vertices named by the JAX
    vertex within 1e-6) but for those touching the at most ``max_moved``
    vertices a shard that compiled XLA's smooth places elsewhere (ROADMAP
    C1), at most ``max_diff`` tets in all; qmin within rtol 1e-5 and
    qmean within rtol 1e-3 (the rule of ``tests/test_torch_dist.py``'s
    one-pass test)."""
    assert cap["ops"] == tuple(jpre["ops"]) and cap["act"] == jpre["act"]
    first = cap["calls"][0]
    f = tmesh.mesh_to_numpy(first["state"])
    jf = jpre["state"]
    ndiff = 0
    for s in range(S):
        tn, nmiss, moved_j, jt = _named_tets(f, s, jf)
        assert nmiss == int(moved_j.sum()) <= max_moved, (s, nmiss)
        keep_t = (tn >= 0).all(axis=1)
        keep_j = ~moved_j[jt].any(axis=1)
        assert keep_t.sum() == keep_j.sum()
        ndiff += len(tn) - int(keep_t.sum())
        got = np.unique(np.sort(tn[keep_t], axis=1), axis=0)
        want = np.unique(np.sort(jt[keep_j], axis=1), axis=0)
        assert len(got) == keep_t.sum() and np.array_equal(got, want), s
    assert ndiff <= max_diff, ndiff
    jstate = tmesh.MeshStack(**{k: torch.from_numpy(np.array(_i32(v)))
                                for k, v in jf.items()})
    q, jq = [np.concatenate([
        tet_quality(st_.slot(s), torch.as_tensor(met[s])).numpy()[
            st_.tmask[s].numpy()] for s in range(S)])
        for st_, met in ((first["state"], first["met"].numpy()),
                         (jstate, jpre["met"]))]
    np.testing.assert_allclose(q.min(), jq.min(), rtol=1e-5)
    np.testing.assert_allclose(q.mean(), jq.mean(), rtol=1e-3)


def _migration_witness(cap, S, mode):
    """The port's states at its loop's band migration through both
    packages: the labels (flood + repair, or graph labels) on the first
    try's state exact against the ones the loop used; then, for the
    first try and each grow retry, band_migrate_iteration + band_weld +
    rebuild_shards: both None where the loop's budget was blown, else by
    :func:`_same_band_result`."""
    calls = cap["calls"]
    ts = calls[0]["state"]
    js = jmesh.Mesh(**{k: jnp.asarray(v) for k, v in
                       tmesh.mesh_to_numpy(ts).items()})
    if mode == "ifc":
        (node_idx, nbr, sizes, _), kw = cap["flood_labels"]
        jl, jd = JM.flood_labels(js, jnp.asarray(node_idx),
                                 jnp.asarray(nbr), jnp.asarray(sizes.numpy()),
                                 S, **kw)
        jl, _ = JMD.repair_flood_labels(js, jl, jd, S)
    else:
        (comms, _), _ = cap["graph_repartition_labels_band"]
        jl = JMD.graph_repartition_labels_band(js, comms, S)
        jd = np.zeros(ts.tmask.shape, np.int32)
    assert np.array_equal(calls[0]["labels"].numpy(), np.asarray(jl))
    assert np.array_equal(calls[0]["depth"].numpy(), np.asarray(jd))
    assert calls[-1]["nmoved"] and all(c["nmoved"] is None
                                       for c in calls[:-1])
    for c in calls:
        assert np.array_equal(c["glo_d"].numpy(),
                              np.stack(c["glo"]).astype(np.int32))
        labels, depth = c["labels"].numpy(), c["depth"].numpy()
        js = jmesh.Mesh(**{k: jnp.asarray(v) for k, v in
                           tmesh.mesh_to_numpy(c["state"]).items()})
        args = (labels, depth, c["shared_prev"])
        if c["nmoved"] is None:
            for M, MD, arr in (_JAX, _TORCH):
                st_ = js if M is JM else c["state"]
                met = arr(c["met"].numpy())
                assert MD.band_migrate_iteration(
                    st_, met, arr(c["glo_d"].numpy()),
                    [g.copy() for g in c["glo"]], arr(labels), arr(depth),
                    c["shared_prev"], S) is None
            continue
        jb = _band_run(_JAX, js, jnp.asarray(c["met"].numpy()), c["glo"],
                       *args)
        tb = _band_run(_TORCH, c["state"], c["met"], c["glo"], *args)
        assert tb[6] == c["nmoved"]
        _same_band_result(tb, jb)


@pytest.mark.parametrize("n", [2, 4])
def test_two_pass_loop_matches_jax(jax_loops, monkeypatch, n):
    """``distributed_adapt_multi(niter=2, cycles=2)`` against the JAX
    package's compiled loop (n_devices=1): pass 0 by :func:`_pass0_rule`
    (every tet equal on 2 shards; on 4, 2 vertices and the 16 tets about
    them, the one-pass test's C1 gap); the migration step exact on the
    port's own state through both packages (:func:`_migration_witness`);
    the band path taken (no full-view fallback) and tets moved; the end
    state by :func:`_loop_rule`."""
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    c = REGISTRY.counter
    b0 = c("mh.band_exchange_bytes.migrate_glo").value
    f0 = c("dist.full_view_migrations").value
    mesh, met_o, part, st, cap = _port_loop(monkeypatch, n)
    assert c("mh.band_exchange_bytes.migrate_glo").value > b0
    assert c("dist.full_view_migrations").value == f0
    jm_o, jmet_o, jpart, jcounts, jact, jpre = jax_loops(n)
    _pass0_rule(cap, jpre, n, 0 if n == 2 else 2, 0 if n == 2 else 16)
    _migration_witness(cap, n, "ifc")
    assert st.cycles == jcounts[0]
    assert len(part) == int(mesh.tmask.sum()) and part.max() == n - 1
    _loop_rule(mesh, met_o, jm_o, jmet_o, f"loop {n}")


def test_two_pass_graph_loop_matches_jax(jax_loops, monkeypatch):
    """Graph mode (``mode="graph"``) on 4 shards from the end slabs of
    cube_mesh(6) (``end_slabs_partition``, where clusters move) against
    the JAX package's compiled loop on the same split: pass 0 by
    :func:`_pass0_rule` (every tet equal), the graph labels and the
    migration step exact on the port's own state through both packages,
    the band path taken, tets moved; the end state by
    :func:`_loop_rule`."""
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    f0 = REGISTRY.counter("dist.full_view_migrations").value
    mesh, met_o, part, st, cap = _port_loop(monkeypatch, "graph4")
    assert REGISTRY.counter("dist.full_view_migrations").value == f0
    jm_o, jmet_o, jpart, jcounts, jact, jpre = jax_loops("graph4")
    _pass0_rule(cap, jpre, 4, 0, 0)
    _migration_witness(cap, 4, "graph")
    assert st.cycles == jcounts[0]
    _loop_rule(mesh, met_o, jm_o, jmet_o, "graph loop 4")


def test_steady_state_scenario_matches_jax(jax_loops):
    """The port's ``steady_state_migration_scenario()`` (cube_mesh(2), 2
    shards, 4 passes, 3 migrations) against JAX's with one device: live
    tets and referenced vertices exact, qmin within rtol 1e-5 and qmean
    within rtol 1e-3 (the one-pass test's rule; ROADMAP C1), and
    :func:`_loop_rule`."""
    from parmmg_tpu_torch.utils.fixtures import \
        steady_state_migration_scenario
    mesh, met_o, part = steady_state_migration_scenario(device="cpu",
                                                        return_all=True)
    jm_o, jmet_o, jpart = jax_loops("scenario")[:3]
    what, nt, jnt, nv, jnv, qmin, jqmin, qmean, jqmean = _loop_rule(
        mesh, met_o, jm_o, jmet_o, "scenario")
    assert (nt, nv) == (jnt, jnv)
    np.testing.assert_allclose(qmin, jqmin, rtol=1e-5)
    np.testing.assert_allclose(qmean, jqmean, rtol=1e-3)


def test_forced_band_overflow_falls_back(monkeypatch):
    """Tiny band budgets (KB = KV = 2): ``band_migrate_iteration`` returns
    None in both packages and leaves every input as it was (stack,
    metric, device numbering, host mirror); the full-view fallback on
    those inputs matches JAX's.  Then the port's two-pass loop under the
    same budgets takes the fallback, counts it and writes a conforming
    mesh."""
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    js, jms, glo, comms = _jstate()
    labels, depth = _band_labels("flood", js, comms)
    ts, tms = _stack(js), torch.from_numpy(np.asarray(jms))
    before = {f: getattr(ts, f).clone() for f in tmesh.MESH_FIELDS}
    met0 = tms.clone()
    for M, MD, arr in (_JAX, _TORCH):
        real = MD.device_migrate
        monkeypatch.setattr(MD, "device_migrate",
                            lambda *a, KB, KV, _r=real: _r(*a, KB=2, KV=2))
    glo_h = [g.copy() for g in glo]
    glo_d = torch.from_numpy(np.stack(glo).astype(np.int32))
    glo_d0 = glo_d.clone()
    sp = _shared_prev(glo, comms, 2)
    assert TMD.band_migrate_iteration(ts, tms, glo_d, glo_h,
                                      torch.from_numpy(labels),
                                      torch.from_numpy(depth), sp, 2) is None
    assert JMD.band_migrate_iteration(
        js, jms, jnp.asarray(np.stack(glo).astype(np.int32)),
        [g.copy() for g in glo], jnp.asarray(labels), jnp.asarray(depth),
        sp, 2) is None
    for f, t in before.items():
        assert torch.equal(getattr(ts, f), t), f
    assert torch.equal(tms, met0) and torch.equal(glo_d, glo_d0)
    assert all(np.array_equal(a, b) for a, b in zip(glo_h, glo))
    lab = TM.enforce_ne_min(labels, ts.tmask.numpy(), 2, depth=depth)
    jf = _full_run(JM, js, jms, glo, lab)
    tf = _full_run(TM, ts, tms, glo, lab)
    _same_stack(tf[0], jf[0], "fallback")
    assert all(np.array_equal(a, b) for a, b in zip(tf[2], jf[2]))
    _same_comms(tf[3], jf[3])
    assert tf[4:] == jf[4:] and tf[4] > 0
    # the loop: three grow retries, then the counted full-view fallback
    m, met = _shock_state()
    n0 = REGISTRY.counter("dist.full_view_migrations").value
    mesh, met_o, _ = TDi.distributed_adapt_multi(m, met, 2, niter=2,
                                                 cycles=2)
    assert REGISTRY.counter("dist.full_view_migrations").value == n0 + 1
    bad = check_adjacency(build_adjacency(mesh))
    assert not bad["asymmetric"] and not bad["face_mismatch"]
    assert float(tet_quality(mesh, met_o)[mesh.tmask].min()) > 0
