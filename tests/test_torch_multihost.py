"""Several processes (``parallel/multihost.py``, ``parallel/pod.py``,
``resilience/watchdog.py``'s leases, the dist checkpoints, the pod runner
``parallel/multihost_run.py``) on the CPU.

Host functions against the JAX package's on the same numpy inputs:
``plan_handoff``, ``permute_comms``, ``mh_uniform``, ``stale_ranks``, the
dist checkpoint's payload keys and a round trip through both packages'
loaders; the allgather meter, ``hot_path`` nesting, ``cold_io`` and the
strict knob as the JAX package's own tests hold them; the hot collective
meter.

Across processes (gloo, a file store under ``tmp_path``, the runner's
workers started with ``subprocess``; they never import jax): the
collectives and ``gather_band`` on two ranks (a transient exchange fault
retried, an exhausted budget re-raised, the hot collective bytes
counted), the two-pass ``distributed_adapt_multi`` on cube_mesh(3) under the shock map
h = 0.3, 4 shards, ``niter=2``, ``cycles=2``, ifc mode, on 2 ranks (G = 2)
and 4 ranks (G = 1): every rank's merged mesh and metric equal the
one-process run's byte for byte (that run is held to the JAX package by
``tests/test_torch_migrate.py``), ``mh.hot_allgather_bytes`` is 0 and
``mh.band_exchange_bytes`` above 0 on every rank.  The crash drill (rank
1 dies at its pass-1 extend exchange, after the pass-0 checkpoint; the
pack is relaunched with resume) and the wedge drill (rank 1 hangs there;
the heartbeat lease kills the pack, rc 9; the same resume) each end with
those bytes.  A handoff run from ``fixtures.end_slabs_partition``
(cube_mesh(6), 3 passes) moves a shard between ranks and writes a
conforming mesh.  Under several processes the full-view fallback raises
``NotImplementedError``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from parmmg_tpu.parallel import pod as JP
from parmmg_tpu.parallel.comms import InterfaceComms as JComms
from parmmg_tpu.resilience import checkpoint as JC
from parmmg_tpu.resilience import watchdog as JW
from parmmg_tpu_torch.core import mesh as tmesh
from parmmg_tpu_torch.obs.metrics import REGISTRY
from parmmg_tpu_torch.ops.adjacency import build_adjacency, check_adjacency
from parmmg_tpu_torch.parallel import dist as TDi
from parmmg_tpu_torch.parallel import multihost as TMH, pod as TP
from parmmg_tpu_torch.parallel.comms import InterfaceComms
from parmmg_tpu_torch.parallel.multihost_run import mesh_hash, worker_input
from parmmg_tpu_torch.resilience import checkpoint as TC
from parmmg_tpu_torch.resilience import watchdog as TW
from torch_parity import jax_ledger_listener_compat  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _c(name):
    return REGISTRY.counter(name).value


# ---------------------------------------------------------------------------
# host functions against the JAX package
# ---------------------------------------------------------------------------
_SIZES = {
    "skewed": (np.array([100, 90, 1, 1]), 2, 0.25),
    "balanced": (np.array([10, 11, 10, 9]), 2, 0.25),
    "empty": (np.zeros(4, np.int64), 2, 0.25),
    "one_device": (np.array([5, 5]), 1, 0.25),
    "ragged": (np.array([1, 2, 3]), 2, 0.25),
    "random12": (np.random.default_rng(3).integers(0, 1000, size=12), 4,
                 0.0),
    "random8": (np.random.default_rng(7).integers(0, 50, size=8), 2, 0.1),
}


@pytest.mark.parametrize("case", sorted(_SIZES))
def test_plan_handoff_equals_jax(case):
    sizes, ndev, imb = _SIZES[case]
    got = TP.plan_handoff(sizes, ndev, max_imbalance=imb)
    want = JP.plan_handoff(sizes, ndev, max_imbalance=imb)
    if want is None:
        assert got is None
    else:
        assert np.array_equal(got, want)
        G = len(sizes) // ndev
        for d in range(ndev):
            assert (np.diff(got[G * d: G * (d + 1)]) > 0).all()


def test_plan_handoff_reads_the_imbalance_knob(monkeypatch):
    sizes = np.array([12, 10, 10, 9])
    monkeypatch.setenv("PMTORCH_MH_IMBALANCE", "0.25")
    assert TP.plan_handoff(sizes, 2) is None
    monkeypatch.setenv("PMTORCH_MH_IMBALANCE", "0")
    assert np.array_equal(TP.plan_handoff(sizes, 2),
                          JP.plan_handoff(sizes, 2, max_imbalance=0.0))


def test_permute_comms_equals_jax():
    S, K, I = 4, 2, 4
    rng = np.random.default_rng(1)
    nbr = np.full((S, K), -1, np.int32)
    for s in range(S):
        nbr[s, 0] = (s + 1) % S
        nbr[s, 1] = (s + 2) % S if s % 2 else -1
    tabs = [rng.integers(-1, 6, size=(S, K, I)).astype(np.int32),
            rng.integers(0, I, size=(S, K)).astype(np.int32),
            rng.integers(-1, 6, size=(S, K, I)).astype(np.int32),
            rng.integers(0, I, size=(S, K)).astype(np.int32)]
    owner = [rng.integers(0, S, size=5).astype(np.int32) for _ in range(S)]
    perm = np.array([2, 3, 0, 1])
    got = TP.permute_comms(InterfaceComms(nbr, *tabs, owner), perm)
    want = JP.permute_comms(JComms(nbr, *tabs, owner), perm)
    for f in ("nbr", "node_idx", "node_cnt", "face_idx", "face_cnt"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(got.owner, want.owner):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    inv = np.empty(S, np.int64)
    inv[perm] = np.arange(S)
    back = TP.permute_comms(got, inv)
    assert np.array_equal(back.nbr, nbr)
    assert all(np.array_equal(a, b) for a, b in zip(back.owner, owner))


def test_mh_uniform_refuses_an_empty_reason():
    from parmmg_tpu.parallel.multihost import mh_uniform as jmh
    for fn in (TMH.mh_uniform, jmh):
        assert fn(3, "agreed: every rank computed it") == 3
        for why in ("", "   "):
            with pytest.raises(ValueError, match="non-empty"):
                fn(3, why)


def test_hot_path_nesting_and_cold_io():
    assert not TMH.in_hot_path()
    with TMH.hot_path():
        assert TMH.in_hot_path()
        with TMH.hot_path():
            with TMH.cold_io():
                assert not TMH.in_hot_path()
            assert TMH.in_hot_path()
        assert TMH.in_hot_path()
    assert not TMH.in_hot_path()


def test_allgather_meter_and_strict_knob(monkeypatch):
    monkeypatch.delenv("PMTORCH_MH_STRICT", raising=False)
    a0, h0 = _c("mh.allgather_bytes"), _c("mh.hot_allgather_bytes")
    TMH._note_allgather(100, "cold")
    assert _c("mh.allgather_bytes") == a0 + 100
    assert _c("mh.hot_allgather_bytes") == h0
    with TMH.hot_path():
        TMH._note_allgather(7, "hot")
    assert _c("mh.hot_allgather_bytes") == h0 + 7
    monkeypatch.setenv("PMTORCH_MH_STRICT", "1")
    TMH._note_allgather(1, "cold-ok")
    with TMH.hot_path():
        with pytest.raises(RuntimeError, match="PMTORCH_MH_STRICT"):
            TMH._note_allgather(1, "hot-trip")
        with TMH.cold_io():
            TMH._note_allgather(1, "ckpt-ok")


def test_collective_meter_counts_hot_sections():
    """Every collective counts on ``mh.collective_bytes``; inside
    ``hot_path`` also on ``mh.hot_collective_bytes``, and not under a
    nested ``cold_io``."""
    c0, h0 = _c("mh.collective_bytes"), _c("mh.hot_collective_bytes")
    TMH._count(10)
    assert (_c("mh.collective_bytes"), _c("mh.hot_collective_bytes")) == \
        (c0 + 10, h0)
    with TMH.hot_path():
        TMH._count(3)
        with TMH.cold_io():
            TMH._count(5)
    assert _c("mh.collective_bytes") == c0 + 18
    assert _c("mh.hot_collective_bytes") == h0 + 3


def test_one_process_helpers_and_backend_refusal(monkeypatch):
    """At one process the group is not joined, there is no backend, and
    every collective is the identity."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert TMH.init_multihost() is False
    assert not TMH.is_multiprocess() and TMH.world_size() == 1
    t = torch.arange(6).reshape(2, 3)
    assert TMH.all_gather_rows(t)[0] is t
    assert TMH.all_reduce(t, "max") is t and TMH.agree(5) == [5]
    assert np.array_equal(TMH.pull_host(t), t.numpy())
    TMH.require_single_process("a host path")
    assert TMH.all_to_all_rows(t)[0] is t
    assert TMH.backend() is None


def test_backend_follows_placement(monkeypatch):
    """The backend is a pure function of where the ranks are: gloo on
    the CPU, NCCL on distinct cards, gloo when ranks share a card; a rank
    without a card of its own raises under NCCL instead of sharing."""
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert TMH.placement("cpu", 2, 0) == [torch.device("cpu")] * 2
    assert TMH.backend_for(TMH.placement("cpu", 2, 0)) == "gloo"
    assert TMH.placement("cuda", 4, 4) == cuda
    assert TMH.backend_for(cuda) == "nccl"
    assert TMH.placement("cuda", 2, 1) == [cuda[0], cuda[0]]
    assert TMH.backend_for(TMH.placement("cuda", 2, 1)) == "gloo"
    assert TMH.backend_for(TMH.placement("cuda", 3, 2)) == "gloo"
    assert TMH.backend_for(TMH.placement("cuda:1", 2, 4)) == "gloo"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMH.placement("cuda", 2, 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert TMH.local_device("cuda", backend="gloo") == cuda[0]
    with pytest.raises(RuntimeError, match="no card of its own"):
        TMH.local_device("cuda", backend="nccl")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert TMH.local_device("cuda", backend="nccl") == cuda[1]


def test_failing_init_raises(monkeypatch, tmp_path):
    """A failing NCCL init raises and joins no group on another backend;
    a rank that asks for a card where there is none, as it does by
    default, raises before any init."""
    import torch.distributed as dist
    calls = []

    def boom(backend, **kw):
        calls.append((backend, kw.get("device_id")))
        raise RuntimeError("NCCL error: unhandled system error")
    monkeypatch.setattr(dist, "init_process_group", boom)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setenv("LOCAL_RANK", "1")
    kw = dict(init_method=f"file://{tmp_path}/store", world_size=2, rank=1,
              timeout_s=5)
    with pytest.raises(RuntimeError, match="NCCL error"):
        TMH.init_multihost(device="cuda", **kw)
    assert calls == [("nccl", torch.device("cuda", 1))]
    assert TMH.backend() is None and not TMH.is_multiprocess()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMH.init_multihost(device="cuda", **kw)
    # the default placement is the card, as the port's other entry points
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMH.init_multihost(**kw)
    assert len(calls) == 1


def test_beat_and_stale_ranks_equal_jax(tmp_path, monkeypatch):
    d = str(tmp_path / "hb")
    monkeypatch.delenv("PMTORCH_MH_HEARTBEAT_DIR", raising=False)
    assert TW.beat() is None                  # off without the runner
    monkeypatch.setenv("PMTORCH_MH_HEARTBEAT_DIR", d)
    monkeypatch.setenv("PMTORCH_HEARTBEAT_S", "0.05")
    monkeypatch.setattr(TW, "_HB", {"last": 0.0})
    b0 = _c("resilience.heartbeats")
    p = TW.beat(rank=3)
    assert p is not None and p.endswith("hb.3") and os.path.exists(p)
    assert _c("resilience.heartbeats") == b0 + 1
    assert TW.beat(rank=3) is None            # throttled
    now = time.time()
    cases = [(5.0, [3]), (5.0, [1, 3]), (0.0, [3])]
    for lease, ranks in cases:
        assert TW.stale_ranks(d, lease, ranks, now=now) == \
            JW.stale_ranks(d, lease, ranks, now=now) == []
    os.utime(p, (now - 10, now - 10))
    for lease, ranks in cases:
        assert TW.stale_ranks(d, lease, ranks, now=now) == \
            JW.stale_ranks(d, lease, ranks, now=now)
    assert TW.stale_ranks(d, 5.0, [1, 3], now=now) == [3]


def _ckpt_payload():
    rng = np.random.default_rng(5)
    S, capP, capT = 2, 8, 6
    st = {"vert": rng.random((S, capP, 3)).astype(np.float32),
          "vtag": rng.integers(-2 ** 31, 2 ** 31 - 1, (S, capP),
                               dtype=np.int64).astype(np.int32),
          "tet": rng.integers(0, capP, (S, capT, 4)).astype(np.int32),
          "tmask": rng.random((S, capT)) < 0.7}
    glo = [rng.integers(-1, 40, capP).astype(np.int64) for _ in range(S)]
    nbr = np.array([[1, -1], [0, -1]], np.int32)
    tabs = [rng.integers(-1, capP, (S, 2, 4)).astype(np.int32),
            np.array([[3, 0], [3, 0]], np.int32),
            rng.integers(-1, 4 * capT, (S, 2, 4)).astype(np.int32),
            np.array([[2, 0], [2, 0]], np.int32)]
    owner = [rng.integers(0, S, capP).astype(np.int32) for _ in range(S)]
    return (st, rng.random((S, capP)).astype(np.float32), glo, 77, nbr,
            tabs, owner, np.array([3, 9, 11], np.int64), 2)


def test_dist_checkpoint_round_trip_with_jax_keys(tmp_path, monkeypatch):
    st, met, glo, top, nbr, tabs, owner, shared, regrow = _ckpt_payload()
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setenv("PMTORCH_CKPT_DIR", str(pdir))
    monkeypatch.setenv("PARMMG_CKPT_DIR", str(jdir))
    jst = {k: (v.view(np.uint32) if k == "vtag" else v)
           for k, v in st.items()}
    pp = TC.save_dist_checkpoint("t", 0, st, met, glo, top,
                                 InterfaceComms(nbr, *tabs, owner), shared,
                                 regrow, fingerprint="fp")
    jp = JC.save_dist_checkpoint("t", 0, jst, met, glo, top,
                                 JComms(nbr, *tabs, owner), shared, regrow,
                                 fingerprint="fp")
    with np.load(pp) as a, np.load(jp) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert TC.latest_dist_checkpoint("t", "fp") == (pp, 0)
    assert TC.latest_dist_checkpoint("t", "other") is None
    for got in (TC.load_dist_checkpoint(pp), TC.load_dist_checkpoint(jp)):
        for k, v in st.items():
            assert got["stacked"][k].dtype == v.dtype
            assert np.array_equal(got["stacked"][k], v), k
        assert np.array_equal(got["met"], met)
        assert all(np.array_equal(a, b) for a, b in zip(got["glo"], glo))
        assert (got["top"], got["regrow"], got["it"]) == (top, regrow, 0)
        assert np.array_equal(got["shared_prev"], shared)
        assert np.array_equal(got["comms"].node_idx, tabs[0])
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["comms"].owner, owner))
    want = JC.load_dist_checkpoint(pp)
    assert np.array_equal(want["stacked"]["vtag"].view(np.int32), st["vtag"])


# ---------------------------------------------------------------------------
# several processes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_process():
    """The one-process port run of the runner's input: (host arrays of
    the merged mesh and metric, their hash)."""
    torch.set_num_threads(1)
    m, met = worker_input(3, 0.3, "cpu")
    out, met_m, _ = TDi.distributed_adapt_multi(m, met, 4, niter=2,
                                                cycles=2)
    return ({**tmesh.mesh_to_numpy(out), "met": met_m.numpy()},
            mesh_hash(out, met_m))


def _runner(tmp_path, *extra, env=None, timeout=240):
    """The pod runner on the CPU over a file store under ``tmp_path``,
    every rank's merged state dumped there; returns the artifact's
    ``extra``."""
    dump = tmp_path / "dump"
    dump.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "parmmg_tpu_torch.parallel.multihost_run",
           "--device", "cpu", "--n", "3", "--h", "0.3", "--shards", "4",
           "--niter", "2", "--cycles", "2", "--store",
           str(tmp_path / "store"), "--dump", str(dump), "--timeout",
           str(timeout - 40), "--coll-timeout", "120", "--verbose", *extra]
    e = dict(os.environ)
    e.update({"PMTORCH_RETRY_BASE_S": "0", **(env or {})})
    out = subprocess.run(cmd, cwd=ROOT, env=e, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])["extra"]


def _same_bytes(tmp_path, want, tag, nproc):
    for r in range(nproc):
        with np.load(tmp_path / "dump" / f"{tag}.r{r}.npz") as z:
            assert sorted(z.files) == sorted(want)
            for k, v in want.items():
                assert z[k].dtype == v.dtype, (r, k)
                assert z[k].tobytes() == v.tobytes(), (r, k)


@pytest.mark.parametrize("nproc", [2, 4])
def test_ranks_write_the_one_process_bytes(tmp_path, one_process, nproc):
    want, h = one_process
    ex = _runner(tmp_path, "--np", str(nproc))
    assert ex["ranks_agree"] and len(ex["workers"]) == nproc
    _same_bytes(tmp_path, want, "timed", nproc)
    for w in ex["workers"]:
        assert w["hash"] == h and w["processes"] == nproc
        assert w["mh.hot_allgather_bytes"] == 0
        assert w["mh.band_exchange_bytes"] > 0
        assert w["mh.allgather_bytes"] > 0        # the final merge only
        assert not w["jax_loaded"]


def test_crash_drill_resumes_to_the_same_bytes(tmp_path, one_process):
    want, h = one_process
    ex = _runner(tmp_path, "--np", "2", "--ckpt", str(tmp_path / "ck"),
                 "--fault", "1:multihost.exchange:key=extend;nth-2",
                 env={"PMTORCH_RETRY_MAX": "0"})
    assert ex["crashed_rc"] != 0 and ex["resumed"]
    assert sorted(os.listdir(tmp_path / "ck"))[:2] == ["mh.dpass0.npz",
                                                      "mh.dpass1.npz"]
    _same_bytes(tmp_path, want, "resumed", 2)
    for w in ex["workers"]:
        assert w["hash"] == h and w["resilience.resumes"] == 1
        assert w["mh.hot_allgather_bytes"] == 0


def test_wedge_drill_lease_kills_and_resumes(tmp_path, one_process):
    want, h = one_process
    ex = _runner(tmp_path, "--np", "2", "--ckpt", str(tmp_path / "ck"),
                 "--lease", "4", "--fault",
                 "1:multihost.exchange:key=extend;nth-2;hang=600",
                 env={"PMTORCH_RETRY_MAX": "0",
                      "PMTORCH_HEARTBEAT_S": "0.2"})
    assert ex["crashed_rc"] == 9 and ex["stale_heartbeat"]
    _same_bytes(tmp_path, want, "resumed", 2)
    assert all(w["hash"] == h for w in ex["workers"])


def test_handoff_moves_a_shard_and_conforms(tmp_path):
    """cube_mesh(6) from the end slabs, 3 passes on 2 ranks: the flood
    drains the light shards into shard 3, and before pass 2 the plan
    pairs it with a light one (the threshold set to 0)."""
    ex = _runner(tmp_path, "--np", "2", "--part", "end_slabs", "--n", "6",
                 "--niter", "3",
                 env={"PMTORCH_MH_HANDOFF": "1",
                      "PMTORCH_MH_IMBALANCE": "0"})
    assert ex["ranks_agree"]
    assert all(w["mh.handoffs"] >= 1 for w in ex["workers"])
    with np.load(tmp_path / "dump" / "timed.r0.npz") as z:
        mesh = tmesh.mesh_from_numpy({f: z[f] for f in tmesh.MESH_FIELDS})
    assert int(mesh.tmask.sum()) == ex["workers"][0]["ntets"]
    bad = check_adjacency(build_adjacency(mesh))
    assert not bad["asymmetric"] and not bad["face_mismatch"]
    assert bool((tmesh.tet_volumes(mesh)[mesh.tmask] > 0).all())


_EXCHANGE = """
import sys
import torch
from parmmg_tpu_torch.obs.metrics import REGISTRY
from parmmg_tpu_torch.parallel import multihost, pod
from parmmg_tpu_torch.resilience.faults import FAULTS
from parmmg_tpu_torch.resilience.recover import RetryBudgetExhausted
r = int(sys.argv[2])
multihost.init_multihost(init_method=sys.argv[1], world_size=2, rank=r,
                         timeout_s=60, device="cpu")
c = lambda n: int(REGISTRY.counter(n).value)
rows = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 10 * r
with pod.activate(4) as ctx, multihost.hot_path():
    assert (ctx.G, ctx.row0, pod.n_global(2)) == (2, 2 * r, 4)
    assert pod.shard_ids(2, "cpu").tolist() == [2 * r, 2 * r + 1]
    if r == 1:
        FAULTS.arm("multihost.exchange:nth-1")
    got = pod.gather_band(rows, rows[:, :1] * 2, what="t")
    FAULTS.reset()
    mx = multihost.all_reduce(torch.tensor([r, -r]), "max")
    ag = multihost.agree(7 + r)
    if r == 1:
        FAULTS.arm("multihost.exchange")
        try:
            pod.gather_band(rows, what="t")
            sys.exit(4)
        except RetryBudgetExhausted:
            pass
        FAULTS.reset()
full = torch.cat([torch.arange(6).reshape(2, 3),
                  torch.arange(6).reshape(2, 3) + 10]).numpy()
assert (got[0] == full).all() and (got[1] == full[:, :1] * 2).all()
assert mx.tolist() == [1, 0] and ag == [7, 8]
print("COUNTS", r, c("mh.band_exchange_bytes"), c("mh.hot_collective_bytes"),
      c("mh.hot_allgather_bytes"), c("resilience.retry_exhausted"))
assert multihost.backend() == "gloo" and c("mh.staged_bytes") == 0
# each collective counted under its kind, with the first one's seconds
snap = REGISTRY.snapshot()
kinds = [k[len("mh.collectives."):] for k in snap["counters"]
         if k.startswith("mh.collectives.")]
assert {"band", "agree"} <= set(kinds), kinds
assert sum(c(f"mh.collectives.{k}") for k in kinds) == c("mh.collectives")
assert all(0 < snap["gauges"][f"mh.first_collective_s.{k}"]
           <= snap["counters"][f"mh.collective_s.{k}"] for k in kinds)
# the halo exchange across the two ranks (the real all_to_all_single)
# equals the one-process exchange on the same tables: the dense tile, the
# packed rows, and the halo_dense rung (a fault on rank 1 only: both
# ranks agree and take the dense layout)
import numpy as np
from parmmg_tpu_torch.parallel import comms, dist as D
nbr = np.array([[1, -1], [0, 2], [3, 1], [2, -1]], np.int32)
rng = np.random.default_rng(7)
sidx = rng.integers(0, 8, size=(4, 2, 4)).astype(np.int32)
sidx[0, 1] = sidx[3, 1] = -1
sidx[1, 0, 2:] = sidx[0, 0, 2:] = -1
vals = torch.from_numpy(rng.normal(size=(4, 8, 3)).astype(np.float32))
sidx, nbr_t = torch.from_numpy(sidx), torch.from_numpy(nbr)
one = multihost.is_multiprocess
multihost.is_multiprocess = lambda: False     # the one-process exchange
want = comms.halo_exchange(vals, sidx, nbr_t)[2 * r:2 * r + 2]
multihost.is_multiprocess = one
M = comms.packed_halo_rows(nbr, 2)
assert M == 2
mine = vals[2 * r:2 * r + 2]
with pod.activate(4):
    dense = comms.halo_exchange(mine, sidx, nbr_t)
    packed = comms.halo_exchange(mine, sidx, nbr_t, packed_M=M)
    if r == 1:
        FAULTS.arm("halo.exchange")
    rung = D.halo_rung(lambda m: comms.halo_exchange(
        mine, sidx, nbr_t, packed_M=m), M)
    FAULTS.reset()
for got in (dense, packed, rung):
    assert got.dtype == want.dtype and torch.equal(got, want)
print("HALO", r, c("mh.halo_bytes"), c("mh.halo_allgather_bytes"),
      c("resilience.halo_dense"), c("mh.collective_bytes.halo"))
multihost.all_reduce(torch.zeros(1))
"""


def _two_ranks(tmp_path, script, timeout=180, env=None):
    """``script`` in two processes of a gloo group over a file store under
    ``tmp_path`` (argv: the init method, the rank); their stdouts."""
    init = f"file://{tmp_path}/store"
    e = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    procs = [subprocess.Popen([sys.executable, "-c", script, init, str(r)],
                              cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (o, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [o for o, _ in outs]


def test_collectives_and_gather_band_across_two_ranks(tmp_path):
    """Two ranks, G = 2: ``gather_band`` delivers every shard's rows in
    rank order, a transient ``multihost.exchange`` fault on one rank is
    retried into the same collective, an exhausted budget re-raises (no
    local fallback), and inside ``hot_path`` the collective bytes count
    on ``mh.hot_collective_bytes`` while no allgather counts hot.  Then
    the halo exchange over the real ``all_to_all_single``: the dense and
    packed layouts and the ``halo_dense`` rung (a fault on one rank)
    equal the one-process exchange on the same tables, and the bytes
    sent off-rank stay within the all_gather arm's."""
    outs = _two_ranks(tmp_path, _EXCHANGE, env={
        "PMTORCH_RETRY_BASE_S": "0", "PMTORCH_RETRY_MAX": "1"})
    for r, o in enumerate(outs):
        line = [ln for ln in o.splitlines() if ln.startswith("COUNTS")][0]
        band, hot, hot_ag, exhausted = map(int, line.split()[2:])
        assert band == 4 * 3 * 4 + 4 * 1 * 4
        # the band tables, the max reduction and the agreement
        assert hot == band + 2 * 2 * 8 + 2 * 4
        assert hot_ag == 0 and exhausted == (1 if r == 1 else 0)
        line = [ln for ln in o.splitlines() if ln.startswith("HALO")][0]
        halo, ag, dense_steps, wire = map(int, line.split()[2:])
        # dense: [2, 2, 2, 4, 3] float32, half to the peer (192 bytes),
        # twice; packed: [2, 2, 4, 3] rows + [2, 2, 2] int32 headers
        assert halo == 192 + 112 + 192 and wire == 2 * halo
        assert ag == 3 * 192 and halo <= ag
        assert dense_steps == 1


_FALLBACK = """
import sys
from parmmg_tpu_torch.parallel import dist, migrate_dev as MD, multihost
from parmmg_tpu_torch.parallel.multihost_run import worker_input
multihost.init_multihost(init_method=sys.argv[1], world_size=2,
                         rank=int(sys.argv[2]), timeout_s=60, device="cpu")
real = MD.device_migrate
MD.device_migrate = lambda *a, KB, KV: real(*a, KB=2, KV=2)
m, met = worker_input(3, 0.3, "cpu")
try:
    dist.distributed_adapt_multi(m, met, 4, niter=2, cycles=2)
except NotImplementedError as e:
    print("RAISED", e)
    sys.exit(0)
sys.exit(3)
"""


def test_full_view_fallback_raises_across_processes(tmp_path):
    """Tiny band budgets (``test_forced_band_overflow_falls_back``'s) on
    two ranks: the grow retries run out on both and the full-view
    fallback raises ``NotImplementedError`` on both, instead of computing
    on one rank's shards."""
    for o in _two_ranks(tmp_path, _FALLBACK):
        assert "RAISED" in o and "full-view migration fallback" in o
