"""The port's communicator layer held against the JAX package:
``parallel/comms.py`` (both halves), ``parallel/pod.py``'s band
exchange and ``utils/debug.dump_comms``.

Exact throughout.  The host half on the fixtures of
``tests/test_comms.py`` (cube_mesh(3) in 4 Morton parts, cube_mesh(4) in
8): both table builders, the owner rule, the node numbering, the
coordinate and face-barycenter echo oracles (a corrupted shard
detected), the face-slot mapping and the padding.  The device half: the
port's exchange runs on a shard stack (every logical shard on one
device, the ``all_to_all`` one gather of each neighbour's send row), the
JAX package's under ``shard_map`` on the forced host devices; seeded
random values through the comm tables of cube_mesh(3) and through the
hand-built 4-shard table of ``tests/test_grouped_analysis.py`` (a
same-device pair, a cross-device pair, pad items, an idle slot): the
one exchange against ``halo_exchange`` on 4 devices and against the
dense and packed grouped exchanges at G = 2 on 2 devices and G = 4 on
one; the several-process arm of ``halo_exchange`` (the JAX package's
all_to_all layouts: the [P, I] matrix, the dense tile, the packed rows)
for P ranks in one process, the all_to_all a transpose of the stacked
send tables, against the JAX exchange of each layout and the one direct
gather; ``packed_halo_rows`` and its hysteresis; the ``halo_dense``
rung; ``merge_owner_max``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as DeviceMesh, PartitionSpec as P

from parmmg_tpu.parallel import comms as JC
from parmmg_tpu.utils.jaxcompat import shard_map
from parmmg_tpu_torch.parallel import comms as TC
from parmmg_tpu_torch.parallel.partition import (fix_contiguity,
                                                 morton_partition)
from parmmg_tpu_torch.utils.fixtures import cube_mesh
from torch_parity import jax_ledger_listener_compat  # noqa: F401


def _partitioned(n=3, nparts=4):
    vert, tet = cube_mesh(n)
    cent = vert[tet].mean(axis=1)
    part = fix_contiguity(tet, morton_partition(cent, nparts))
    l2g, g2l = [], []
    for s in range(nparts):
        used = np.zeros(len(vert), bool)
        used[tet[part == s].reshape(-1)] = True
        gids = np.where(used)[0]
        m = np.full(len(vert), -1, np.int64)
        m[gids] = np.arange(len(gids))
        l2g.append(gids)
        g2l.append(m)
    return vert, tet, part, l2g, g2l


def _same_comms(a, b):
    for f in ("nbr", "node_idx", "node_cnt", "face_idx", "face_cnt"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert len(a.owner) == len(b.owner)
    for oa, ob in zip(a.owner, b.owner):
        assert np.array_equal(oa, ob)


# ---- the host half ----------------------------------------------------------

@pytest.mark.parametrize("n,nparts", [(3, 4), (4, 8), (2, 2)])
def test_builders_exact(n, nparts):
    """Both builders equal the JAX package's, and each other."""
    vert, tet, part, l2g, g2l = _partitioned(n, nparts)
    got = TC.build_interface_comms(tet, part, nparts, l2g, g2l)
    _same_comms(got, JC.build_interface_comms(tet, part, nparts, l2g, g2l))
    ref = TC.build_interface_comms_ref(tet, part, nparts, l2g, g2l)
    _same_comms(ref, JC.build_interface_comms_ref(tet, part, nparts, l2g,
                                                  g2l))
    _same_comms(got, ref)
    # the owner rule: max shard touching the vertex
    for s in range(nparts):
        for li, g in enumerate(l2g[s]):
            assert got.owner[s][li] == max(r for r in range(nparts)
                                           if g2l[r][g] >= 0)


def test_numberings_and_face_slots_exact():
    vert, tet, part, l2g, g2l = _partitioned()
    comms = TC.build_interface_comms(tet, part, 4, l2g, g2l)
    npoin = [len(x) for x in l2g]
    got = TC.global_node_numbering(comms, npoin)
    want = JC.global_node_numbering(comms, npoin)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    # every vertex numbered, copies agree, dense 1..nvert
    seen = {}
    for s in range(4):
        for li, g in enumerate(l2g[s]):
            assert seen.setdefault(g, got[s][li]) == got[s][li]
    assert sorted(seen.values()) == list(range(1, len(vert) + 1))
    owned = [3, 0, 7, 2]
    assert np.array_equal(TC.global_triangle_numbering(comms, owned),
                          JC.global_triangle_numbering(comms, owned))
    gface = np.flatnonzero(part == 2)[:5] * 4 + np.array([0, 1, 2, 3, 1])
    assert np.array_equal(TC._global_face_to_local(gface, part, 2),
                          JC._global_face_to_local(gface, part, 2))
    lists = [[[1, 2], [], [3]], [[0], [], []], [[5, 6, 7], [], []]]
    flists = [[[], [4], []], [[], [], [9]], [[], [], []]]
    owner = [np.arange(3, dtype=np.int32)] * 3
    _same_comms(TC.pad_comm_tables(lists, flists, owner, 3),
                JC.pad_comm_tables(lists, flists, owner, 3))


def test_echo_oracles_exact_and_detect_breakage():
    vert, tet, part, l2g, g2l = _partitioned()
    comms = TC.build_interface_comms(tet, part, 4, l2g, g2l)
    verts = [vert[l2g[s]] for s in range(4)]
    tets = [g2l[s][tet[part == s]].astype(np.int64) for s in range(4)]
    chk = TC.check_node_comms(comms, verts)
    assert chk == JC.check_node_comms(comms, verts)
    assert chk["mismatch"] == 0 and chk["items_checked"] > 0
    chkf = TC.check_face_comms(comms, tets, verts)
    assert chkf == JC.check_face_comms(comms, tets, verts)
    assert chkf["mismatch"] == 0 and chkf["items_checked"] > 0
    verts[1] = verts[1] + 0.5                   # corrupt one shard
    bad = TC.check_node_comms(comms, verts)
    assert bad == JC.check_node_comms(comms, verts)
    assert bad["mismatch"] > 0
    badf = TC.check_face_comms(comms, tets, verts)
    assert badf == JC.check_face_comms(comms, tets, verts)
    assert badf["mismatch"] > 0


def test_dump_comms_same_text(tmp_path):
    from parmmg_tpu.utils.debug import dump_comms as jdump
    from parmmg_tpu_torch.utils.debug import dump_comms
    vert, tet, part, l2g, g2l = _partitioned()
    comms = TC.build_interface_comms(tet, part, 4, l2g, g2l)
    a = dump_comms(comms, tmp_path / "t.txt").read_text()
    b = jdump(comms, tmp_path / "j.txt").read_text()
    assert a == b and "shard 0 <-> " in a


# ---- the device half --------------------------------------------------------

def _jax_stacked(fn, S, *arrays):
    """``fn`` (one device's body) under ``shard_map`` on S forced host
    devices over the stacked ``arrays``; the stacked result."""
    dmesh = DeviceMesh(np.array(jax.devices()[:S]), ("shard",))
    spec = P("shard")
    prog = jax.jit(shard_map(fn, mesh=dmesh, in_specs=(spec,) * len(arrays),
                             out_specs=spec, check_vma=False))
    return np.asarray(prog(*(jnp.asarray(a) for a in arrays)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mesh_tables(n=3, nparts=4, width=3, seed=0):
    vert, tet, part, l2g, g2l = _partitioned(n, nparts)
    comms = TC.build_interface_comms(tet, part, nparts, l2g, g2l)
    maxP = max(len(x) for x in l2g)
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(nparts, maxP, width)).astype(np.float32)
    return vals, comms.node_idx, comms.nbr


def _hand_tables(seed=7):
    """tests/test_grouped_analysis.py's table: 4 logical shards, pairs
    (0,1) and (2,3) on one device at G = 2, (1,2) across, pad items and
    an idle neighbor slot."""
    nbr = np.array([[1, -1], [0, 2], [3, 1], [2, -1]], np.int32)
    rng = np.random.default_rng(seed)
    send_idx = rng.integers(0, 8, size=(4, 2, 4)).astype(np.int32)
    send_idx[0, 1] = -1
    send_idx[3, 1] = -1
    send_idx[1, 0, 2:] = -1
    send_idx[0, 0, 2:] = -1
    vals = rng.normal(size=(4, 8, 3)).astype(np.float32)
    return vals, send_idx, nbr


def test_halo_exchange_exact():
    vals, sidx, nbr = _mesh_tables()
    want = _jax_stacked(lambda v, s, b: JC.halo_exchange(v[0], s[0],
                                                         b[0])[None],
                        4, vals, sidx, nbr)
    got = TC.halo_exchange(_t(vals), _t(sidx), _t(nbr)).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    # the echo: each received coordinate equals the receiver's own copy
    vert, tet, part, l2g, _ = _partitioned()
    coords = np.zeros((4, vals.shape[1], 3), np.float32)
    for s in range(4):
        coords[s, : len(l2g[s])] = vert[l2g[s]]
    recv = TC.halo_exchange(_t(coords), _t(sidx), _t(nbr)).numpy()
    ok = sidx >= 0
    own = coords[np.arange(4)[:, None, None], np.clip(sidx, 0, None)]
    assert np.array_equal(recv[ok], own[ok]) and (recv[~ok] == 0).all()


@pytest.mark.parametrize("tables", ["mesh", "hand"])
@pytest.mark.parametrize("G", [2, 4])
def test_grouped_exchanges_exact(tables, G):
    """The port's one exchange equals the JAX package's dense and packed
    grouped exchanges under shard_map (S = 4 // G devices)."""
    vals, sidx, nbr = _mesh_tables() if tables == "mesh" else \
        _hand_tables()
    S = 4 // G
    dense_j = _jax_stacked(
        lambda v, s, b: JC.halo_exchange_grouped(v, s, b, G), S,
        vals, sidx, nbr)
    got = TC.halo_exchange(_t(vals), _t(sidx), _t(nbr)).numpy()
    assert np.array_equal(got, dense_j)
    M = G * nbr.shape[1]          # a row budget that drops no entry
    packed_j = _jax_stacked(
        lambda v, s, b: JC.halo_exchange_grouped_packed(v, s, b, G, M), S,
        vals, sidx, nbr)
    assert np.array_equal(got, packed_j)
    if tables == "hand" and G == 2:
        assert (got[0, 1] == 0).all() and (got[0, 0] != 0).any()


@pytest.mark.parametrize("tables", ["mesh", "hand"])
def test_halo_exchange_pack_path_exact(tables, monkeypatch):
    """The several-process arm of ``halo_exchange`` (each rank lays its
    send rows out, one all_to_all, each rank routes what it received)
    delivers the one direct gather's values, here with every shard on one
    rank and the all_to_all the identity: the dense [1, G, G, I] tile and
    the packed rows."""
    from parmmg_tpu_torch.parallel import multihost
    vals, sidx, nbr = _mesh_tables() if tables == "mesh" else \
        _hand_tables()
    want = TC.halo_exchange(_t(vals), _t(sidx), _t(nbr)).numpy()
    sent = []

    def a2a(*ts, kind):
        sent.append((kind, [tuple(t.shape) for t in ts]))
        return ts
    monkeypatch.setattr(multihost, "is_multiprocess", lambda: True)
    monkeypatch.setattr(multihost, "world_size", lambda: 1)
    monkeypatch.setattr(multihost, "all_to_all_rows", a2a)
    S, K, I = sidx.shape
    tail = tuple(vals.shape[2:])
    for M in (None, S * K):
        got = TC.halo_exchange(_t(vals), _t(sidx), _t(nbr),
                               packed_M=M).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sent == [("halo", [(1, S, S, I) + tail]),
                    ("halo", [(1, S * K, I) + tail, (1, S * K, 2)])]


# ---- the halo layouts across processes -----------------------------------

def _chain_tables(S=8, K=2, I=5, seed=3):
    """A sparse table: logical shard l neighbours l - 1 and l + 1 (a
    chain), so that G = 2 on 4 ranks fills at most half of a G x G
    tile and picks the packed rows."""
    nbr = np.full((S, K), -1, np.int32)
    for l in range(S):
        nb = [b for b in (l - 1, l + 1) if 0 <= b < S]
        nbr[l, :len(nb)] = nb
    rng = np.random.default_rng(seed)
    send_idx = rng.integers(0, 9, size=(S, K, I)).astype(np.int32)
    send_idx[nbr < 0] = -1
    send_idx[:, :, I - 1] = -1
    vals = rng.normal(size=(S, 9, 2)).astype(np.float32)
    return vals, send_idx, nbr


def _ranks_exchange(vals, sidx, nbr, P, M):
    """The several-process exchange of P ranks in one process: each
    rank's ``halo_pack`` of its G shards, the all_to_all as the transpose
    of the stacked send tables (row j of rank i's table becomes row i of
    rank j's), each rank's ``halo_unpack``; the ranks' results stacked."""
    G = len(nbr) // P
    sl = [slice(r * G, (r + 1) * G) for r in range(P)]
    sends = [TC.halo_pack(_t(vals[q]), _t(sidx[q]), _t(nbr[q]), P, M)
             for q in sl]
    for parts in sends:
        assert all(t.shape[0] == P for t in parts)
    out = []
    for r in range(P):
        recv = tuple(torch.stack([sends[i][j][r] for i in range(P)])
                     for j in range(len(sends[0])))
        out.append(TC.halo_unpack(recv, _t(nbr[sl[r]]), P, M))
    return torch.cat(out).numpy()


_LAYOUT_CASES = [(4, 1, "mesh"), (4, 1, "hand"), (2, 2, "mesh"),
                 (2, 2, "hand"), (4, 2, "mesh8"), (4, 2, "chain")]


@pytest.mark.parametrize("P,G,tables", _LAYOUT_CASES)
def test_halo_layouts_exact(P, G, tables):
    """Each layout's pack, all_to_all and unpack for P ranks of G shards,
    bit for bit against the JAX package's exchange of that layout under
    shard_map on P host devices (``halo_exchange`` at G = 1,
    ``halo_exchange_grouped`` and ``halo_exchange_grouped_packed`` at
    G > 1, with ``packed_halo_rows``' M where it picks packed) and
    against the port's one direct gather."""
    vals, sidx, nbr = {"mesh": _mesh_tables, "hand": _hand_tables,
                       "mesh8": lambda: _mesh_tables(4, 8),
                       "chain": _chain_tables}[tables]()
    assert len(nbr) == P * G
    direct = TC.halo_exchange(_t(vals), _t(sidx), _t(nbr)).numpy()
    dense = _ranks_exchange(vals, sidx, nbr, P, None)
    if G == 1:
        want = _jax_stacked(lambda v, s, b: JC.halo_exchange(
            v[0], s[0], b[0])[None], P, vals, sidx, nbr)
        assert np.array_equal(dense, want)
        assert TC.packed_halo_rows(nbr, G) is None
    else:
        want = _jax_stacked(lambda v, s, b: JC.halo_exchange_grouped(
            v, s, b, G), P, vals, sidx, nbr)
        assert np.array_equal(dense, want)
        M = TC.packed_halo_rows(nbr, G)
        assert M == JC.packed_halo_rows(nbr, G)
        assert M is not None or tables.startswith("mesh")
        for Mp in {M or G * nbr.shape[1], G * nbr.shape[1]}:
            packed = _ranks_exchange(vals, sidx, nbr, P, Mp)
            want_p = _jax_stacked(
                lambda v, s, b: JC.halo_exchange_grouped_packed(
                    v, s, b, G, Mp), P, vals, sidx, nbr)
            assert np.array_equal(packed, want_p)
            assert np.array_equal(packed, direct)
    assert dense.dtype == direct.dtype and np.array_equal(dense, direct)


def _occupancy_table(m, G=8, K=8):
    """[2G, K]: m entries from rank 0's shards to rank 1's (occupancy
    m / G^2 of that rank pair), none back."""
    nbr = np.full((2 * G, K), -1, np.int32)
    for i in range(m):
        nbr[i % G, i // G] = G + i // G
    return nbr


def test_packed_halo_rows_hysteresis_equals_jax(monkeypatch):
    """A sequence of tables that crosses the 0.75 threshold both ways
    (G = 8: occupancies 0.5, 0.78, 0.875, 0.72, 0.69, then no traffic):
    the port's budgets and sticky state equal the JAX package's, with
    and without the state dict, and the hysteresis keeps packed at 0.78
    and dense at 0.72."""
    from parmmg_tpu.obs.metrics import REGISTRY as JREG
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    monkeypatch.delenv("PARMMG_HALO_PACK_OCC", raising=False)
    monkeypatch.delenv("PARMMG_HALO_PACK_HYST", raising=False)
    assert (TC.HALO_PACK_OCC, TC.HALO_PACK_HYST) == (0.75, 0.05)
    st_t, st_j = {}, {}
    f0 = REGISTRY.counter("halo.layout_flips").value
    j0 = JREG.counter("halo.layout_flips").value
    seen = []
    for m in (32, 50, 56, 46, 44, 0):
        nbr = _occupancy_table(m)
        got = TC.packed_halo_rows(nbr, 8, state=st_t)
        assert got == JC.packed_halo_rows(nbr, 8, state=st_j)
        assert st_t == st_j
        assert TC.packed_halo_rows(nbr, 8) == JC.packed_halo_rows(nbr, 8)
        seen.append(got)
    assert seen == [40, 61, None, None, 61, None]
    assert TC.packed_halo_rows(_occupancy_table(50), 8) is None
    assert TC.packed_halo_rows(_occupancy_table(46), 8) == 61
    assert REGISTRY.counter("halo.layout_flips").value - f0 == 2
    assert JREG.counter("halo.layout_flips").value - j0 == 2


def test_halo_dense_rung(monkeypatch):
    """An injected ``halo.exchange`` fault on the packed route: the
    exchange runs on the dense layout, delivers its values, records the
    ``halo_dense`` ladder step, and the layout state is left alone."""
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    from parmmg_tpu_torch.parallel import dist as TD, multihost
    from parmmg_tpu_torch.resilience.faults import FAULTS
    vals, sidx, nbr = _chain_tables()
    monkeypatch.setattr(multihost, "is_multiprocess", lambda: True)
    monkeypatch.setattr(multihost, "world_size", lambda: 1)
    monkeypatch.setattr(multihost, "all_to_all_rows",
                        lambda *ts, kind: ts)
    monkeypatch.setattr(multihost, "agree", lambda v: [int(v)])
    routes = []

    def run(M):
        routes.append(M)
        return TC.halo_exchange(_t(vals), _t(sidx), _t(nbr), packed_M=M)
    state = {"layout": "packed"}
    M = TC.packed_halo_rows(nbr, 8, state=state)
    assert M is not None and state == {"layout": "packed"}
    c0 = REGISTRY.counter("resilience.halo_dense").value
    dense = TC.halo_exchange(_t(vals), _t(sidx), _t(nbr)).numpy()
    FAULTS.arm("halo.exchange")
    try:
        got = TD.halo_rung(run, M).numpy()
    finally:
        FAULTS.reset()
    assert routes == [None] and np.array_equal(got, dense)
    assert REGISTRY.counter("resilience.halo_dense").value == c0 + 1
    assert state == {"layout": "packed"}
    assert np.array_equal(TD.halo_rung(run, M).numpy(), dense)
    assert routes == [None, M]
    assert REGISTRY.counter("resilience.halo_dense").value == c0 + 1


def test_merge_owner_max_exact():
    vals, sidx, nbr = _mesh_tables(width=1)
    vals = vals[..., 0]
    recv = TC.halo_exchange(_t(vals), _t(sidx), _t(nbr))
    got = TC.merge_owner_max(_t(vals), _t(sidx), recv).numpy()
    for s in range(4):
        want = JC.merge_owner_max(jnp.asarray(vals[s]), jnp.asarray(sidx[s]),
                                  jnp.asarray(recv[s].numpy()))
        assert np.array_equal(got[s], np.asarray(want))
    small = TC.merge_owner_max(_t(np.array([[1.0, 5.0, 2.0, 0.0]])),
                               _t(np.array([[[0, 2, -1]]])),
                               _t(np.array([[[3.0, 1.0, 99.0]]])))
    assert small.tolist() == [[3.0, 5.0, 2.0, 0.0]]


# ---- the band exchange ------------------------------------------------------

def test_gather_band_and_its_ladder():
    """One process reads the band tables as a metered host copy: the
    values, their bytes on ``mh.band_exchange_bytes``, and no fault point
    or retry ladder (those belong to a cross-process exchange)."""
    from parmmg_tpu_torch.obs.metrics import REGISTRY
    from parmmg_tpu_torch.parallel import pod
    from parmmg_tpu_torch.resilience.faults import FAULTS
    rows = torch.tensor([[3, -1], [0, 5]], dtype=torch.int32)
    gids = torch.tensor([[7, -1], [8, 9]], dtype=torch.int32)
    b0 = REGISTRY.counter("mh.band_exchange_bytes").value
    r, g = pod.gather_band(rows, gids)
    assert isinstance(r, np.ndarray) and np.array_equal(r, rows.numpy())
    assert np.array_equal(g, gids.numpy())
    assert REGISTRY.counter("mh.band_exchange_bytes").value - b0 == 32
    one = pod.gather_band(rows)
    assert isinstance(one, np.ndarray)
    l0 = REGISTRY.counter("resilience.mh_allgather").value
    FAULTS.arm("multihost.exchange")
    try:
        r2, g2 = pod.gather_band(rows, gids)
    finally:
        FAULTS.reset()
    assert np.array_equal(r2, r) and np.array_equal(g2, g)
    assert REGISTRY.counter("resilience.mh_allgather").value == l0
