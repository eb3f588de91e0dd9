"""Communicator layer: interface index arrays, halo exchange, numbering
(port of ``parallel/comms.py``).

Re-design of the reference's communicator abstraction
(libparmmgtypes.h:253-280; construction communicators_pmmg.c; checks
chkcomm_pmmg.c; global numbering libparmmg.c:464-1105):

- the *internal communicator* (flat per-rank interface array) and the
  *external communicators* (per-neighbor ordered item lists) become, per
  shard, one padded index table ``send_idx[s, k, i]`` = local entity id of
  item i of neighbor slot k, with ``nbr[s, k]`` the neighbor shard;
- the canonical ParMmg exchange idiom (scatter -> Sendrecv -> merge with
  an owner rule, e.g. libparmmg.c:743-790) becomes ``halo_exchange``:
  gather item values into per-neighbor send rows -> exchange -> each
  shard reads the mirrored row it received from each neighbor -> merge.
  Matching item order on the two sides of a pair is guaranteed by
  construction: both sides sort items by *global* entity key — the
  ordering contract of the reference API (API_functions_pmmg.c:1295-1330);
- owner rule: max shard id touching the entity (libparmmg.c:962-973);
- the chkcomm "coordinate echo" oracle is :func:`check_node_comms`.

The host half (table construction, numbering, the checks) is the JAX
package's numpy, copied; every rank holds the tables of every shard.  The
device half works on the shard stack a rank holds (every shard at one
process): the JAX package's ``all_to_all`` (and its dense and packed
layouts of G logical shards a device, which only shape the bytes that
cross devices) is a gather of each neighbour's send row, through one
collective of the ranks' packed send rows across processes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import IDIR
from ..utils.compilecache import bucket


@dataclasses.dataclass
class InterfaceComms:
    """Padded per-shard communicator tables (host-built, device-ready).

    For S shards, K = max neighbors, I = max items per neighbor pair:
      nbr[s, k]           neighbor shard id or -1
      node_idx[s, k, i]   local vertex row in shard s (or -1 pad)
      face_idx[s, k, i]   local tet-face slot 4*t+f in shard s (or -1)
    Item order along i is identical on the two sides of every pair.
    """
    nbr: np.ndarray
    node_idx: np.ndarray
    node_cnt: np.ndarray     # [S, K]
    face_idx: np.ndarray
    face_cnt: np.ndarray     # [S, K]
    owner: list[np.ndarray]  # per shard: owner shard of each local vertex


def build_interface_comms(tet: np.ndarray, part: np.ndarray,
                          nparts: int,
                          l2g: list[np.ndarray],
                          g2l: list[np.ndarray]) -> InterfaceComms:
    """Build node+face comms from a partition of a global mesh.

    ``l2g[s]``: shard-local vertex row -> global vertex id;
    ``g2l[s]``: global vertex id -> local row (-1 if absent).
    Reproduces PMMG_build_faceCommIndex/_nodeCommFromFaces semantics
    (communicators_pmmg.c:894-1823) including nodes shared by shards with
    no common face (the completeExtNodeComm case :1826): node comms here
    are derived from the full vertex->shards incidence, which covers
    vertex-only adjacency by construction.

    Fully sort/segment based: no [nvert, nparts] dense incidence and no
    per-item Python loops, so construction stays O(interface log) at
    S=64 and beyond.  Item ordering is bit-identical to the reference
    implementation below (faces by global key, nodes by global id — the
    A.4 ordering contract); tests/test_torch_comms.py holds both to the
    JAX package's.
    """
    n = len(tet)
    S = nparts
    # ---- interface faces (matched pairs across parts) -------------------
    faces = np.sort(tet[:, IDIR].reshape(n * 4, 3), axis=1)
    key = (faces[:, 0].astype(np.int64) << 42) | \
          (faces[:, 1].astype(np.int64) << 21) | faces[:, 2].astype(np.int64)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    same = ks[1:] == ks[:-1]
    fA, fB = order[:-1][same], order[1:][same]
    pA, pB = part[fA // 4], part[fB // 4]
    cross = pA != pB
    fA, fB, pA, pB = fA[cross], fB[cross], pA[cross], pB[cross]
    fkey = key[fA]

    # group matched faces by unordered pair, keep fkey order inside each
    lo = np.minimum(pA, pB).astype(np.int64)
    hi = np.maximum(pA, pB).astype(np.int64)
    o2 = np.lexsort((fkey, hi, lo))
    loS, hiS = lo[o2], hi[o2]
    fA_s, fB_s, pA_s = fA[o2], fB[o2], pA[o2]
    head = np.concatenate([[True], (loS[1:] != loS[:-1]) |
                           (hiS[1:] != hiS[:-1])]) \
        if len(loS) else np.zeros(0, bool)
    bounds = np.concatenate([np.where(head)[0], [len(loS)]]) \
        if len(loS) else np.array([0])
    face_lists = [[[] for _ in range(S)] for _ in range(S)]
    for bi in range(len(bounds) - 1):
        sl = slice(bounds[bi], bounds[bi + 1])
        a, b = int(loS[bounds[bi]]), int(hiS[bounds[bi]])
        a_is_A = pA_s[sl] == a
        fa = np.where(a_is_A, fA_s[sl], fB_s[sl])
        fb = np.where(a_is_A, fB_s[sl], fA_s[sl])
        face_lists[a][b] = fa.tolist()
        face_lists[b][a] = fb.tolist()

    # ---- vertex -> parts incidence (sorted pairs, no dense matrix) ------
    allg = np.concatenate([np.asarray(l, np.int64) for l in l2g]) \
        if l2g else np.zeros(0, np.int64)
    allsh = np.concatenate([np.full(len(l), s, np.int64)
                            for s, l in enumerate(l2g)])
    ov = np.lexsort((allsh, allg))
    gs, ss = allg[ov], allsh[ov]
    headv = np.concatenate([[True], gs[1:] != gs[:-1]]) \
        if len(gs) else np.zeros(0, bool)
    segv = np.cumsum(headv) - 1
    nseg = int(segv[-1]) + 1 if len(segv) else 0
    cnt = np.bincount(segv, minlength=nseg)
    # owner per global id = max incident shard (sorted segments: last)
    last = np.concatenate([headv[1:], [True]]) if len(gs) else headv
    owner_of_seg = ss[last] if len(gs) else np.zeros(0, np.int64)
    seg_gid = gs[headv] if len(gs) else np.zeros(0, np.int64)

    # pair expansion: each row pairs with every OTHER row of its segment
    crow = cnt[segv]
    startv = np.zeros(nseg, np.int64)
    if nseg:
        startv[1:] = np.cumsum(cnt)[:-1]
    rankv = np.arange(len(gs)) - startv[segv]
    rep = np.repeat(np.arange(len(gs)), np.maximum(crow - 1, 0))
    m = len(rep)
    if m:
        off_in = np.arange(m) - np.repeat(
            np.concatenate([[0], np.cumsum(np.maximum(crow - 1, 0))[:-1]]),
            np.maximum(crow - 1, 0))
        r_rep = rankv[rep]
        other_rank = off_in + (off_in >= r_rep)
        other = startv[segv[rep]] + other_rank
        a_sh = ss[rep]
        b_sh = ss[other]
        gid_p = gs[rep]
    else:
        a_sh = b_sh = gid_p = np.zeros(0, np.int64)
    # group by (a, b); gid order inside each pair list is preserved by a
    # stable sort (segments were gid-ascending already)
    node_lists = [[[] for _ in range(S)] for _ in range(S)]
    if m:
        op = np.lexsort((gid_p, b_sh, a_sh))
        aS, bS, gS = a_sh[op], b_sh[op], gid_p[op]
        headp = np.concatenate([[True], (aS[1:] != aS[:-1]) |
                                (bS[1:] != bS[:-1])])
        pb = np.concatenate([np.where(headp)[0], [len(aS)]])
        for bi in range(len(pb) - 1):
            sl = slice(pb[bi], pb[bi + 1])
            node_lists[int(aS[pb[bi]])][int(bS[pb[bi]])] = gS[sl].tolist()

    # ---- convert to local indices and pad into tables -------------------
    node_loc = [[(g2l[s][np.asarray(node_lists[s][b], np.int64)].tolist()
                  if node_lists[s][b] else [])
                 for b in range(S)] for s in range(S)]
    face_loc = [[(_global_face_to_local(
                    np.asarray(face_lists[s][b], np.int64), part,
                    s).tolist() if face_lists[s][b] else [])
                 for b in range(S)] for s in range(S)]
    owner = []
    gid2owner = np.full(int(allg.max()) + 1 if len(allg) else 1, -1,
                        np.int64)
    if nseg:
        gid2owner[seg_gid] = owner_of_seg
    for s in range(S):
        ow = gid2owner[np.asarray(l2g[s], np.int64)].astype(np.int32) \
            if len(l2g[s]) else np.zeros(0, np.int32)
        ow[ow < 0] = s
        owner.append(ow)
    return pad_comm_tables(node_loc, face_loc, owner, S)


def build_interface_comms_ref(tet: np.ndarray, part: np.ndarray,
                              nparts: int,
                              l2g: list[np.ndarray],
                              g2l: list[np.ndarray]) -> InterfaceComms:
    """Reference (dense-incidence, per-item Python loop) construction —
    kept as the bit-identity oracle for the sort-based builder above."""
    n = len(tet)
    # ---- interface faces (matched pairs across parts) -------------------
    faces = np.sort(tet[:, IDIR].reshape(n * 4, 3), axis=1)
    key = (faces[:, 0].astype(np.int64) << 42) | \
          (faces[:, 1].astype(np.int64) << 21) | faces[:, 2].astype(np.int64)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    same = ks[1:] == ks[:-1]
    fA, fB = order[:-1][same], order[1:][same]
    pA, pB = part[fA // 4], part[fB // 4]
    cross = pA != pB
    fA, fB, pA, pB = fA[cross], fB[cross], pA[cross], pB[cross]
    fkey = key[fA]                       # global face key (same for both)

    # ---- vertex -> parts incidence --------------------------------------
    nvert = max(int(l.max()) + 1 if len(l) else 0 for l in l2g) \
        if l2g else int(tet.max()) + 1
    incid = np.zeros((nvert, nparts), bool)
    for s in range(nparts):
        incid[l2g[s], s] = True
    shared = incid.sum(axis=1) > 1
    owner_g = np.where(incid.any(axis=1),
                       nparts - 1 - np.argmax(incid[:, ::-1], axis=1), -1)

    # ---- per-pair item lists, ordered by global key ---------------------
    S = nparts
    node_lists = [[[] for _ in range(S)] for _ in range(S)]
    face_lists = [[[] for _ in range(S)] for _ in range(S)]
    # faces: ordered by fkey
    o = np.argsort(fkey, kind="stable")
    for i in o:
        a, b = int(pA[i]), int(pB[i])
        face_lists[a][b].append(int(fA[i]))
        face_lists[b][a].append(int(fB[i]))
    # nodes: every globally-shared vertex, for each pair of its parts,
    # ordered by global id
    shared_ids = np.where(shared)[0]
    for g in shared_ids:
        ps = np.where(incid[g])[0]
        for a in ps:
            for b in ps:
                if a < b:
                    node_lists[a][b].append(int(g))
                    node_lists[b][a].append(int(g))

    # ---- convert to local indices and pad into tables --------------------
    node_loc = [[(g2l[s][np.asarray(node_lists[s][b], np.int64)].tolist()
                  if node_lists[s][b] else [])
                 for b in range(S)] for s in range(S)]
    face_loc = [[(_global_face_to_local(
                    np.asarray(face_lists[s][b], np.int64), part,
                    s).tolist() if face_lists[s][b] else [])
                 for b in range(S)] for s in range(S)]
    owner = []
    for s in range(S):
        ow = owner_g[l2g[s]].astype(np.int32)
        ow[ow < 0] = s
        owner.append(ow)
    return pad_comm_tables(node_loc, face_loc, owner, S)


def pad_comm_tables(node_lists, face_lists, owner,
                    n_shards: int) -> InterfaceComms:
    """Pad per-pair item lists (LOCAL indices, both-sides-identical
    order — the A.4 contract) into the device-ready InterfaceComms
    layout.  Single source of truth for the padding/K>=1 clamps, shared
    by build_interface_comms and the migration rebuild
    (the JAX package's parallel/migrate.py).

    Pad widths are BUCKETED (utils/compilecache.bucket), not exact, as
    in the JAX package (where every consumer of node_idx/face_idx keys a
    compile on these shapes): the item axes on the geometric 1.5x
    ladder, the neighbor axis pow2 from a floor of 2, so that the tables
    have the JAX package's shapes bit for bit.  Consumers tolerate pads
    by construction (-1 idx, cnt arrays)."""
    S = n_shards
    nbrs = [[b for b in range(S)
             if b != s and (node_lists[s][b] or face_lists[s][b])]
            for s in range(S)]
    K = bucket(max((len(x) for x in nbrs), default=1), floor=2,
               cap=max(1, S - 1), scheme="pow2")
    In = bucket(max((len(node_lists[s][b]) for s in range(S)
                     for b in range(S)), default=1), floor=64)
    If = bucket(max((len(face_lists[s][b]) for s in range(S)
                     for b in range(S)), default=1), floor=64)
    nbr = np.full((S, K), -1, np.int32)
    node_idx = np.full((S, K, In), -1, np.int32)
    node_cnt = np.zeros((S, K), np.int32)
    face_idx = np.full((S, K, If), -1, np.int32)
    face_cnt = np.zeros((S, K), np.int32)
    for s in range(S):
        for k, b in enumerate(nbrs[s]):
            nbr[s, k] = b
            nl = node_lists[s][b]
            node_idx[s, k, : len(nl)] = nl
            node_cnt[s, k] = len(nl)
            fl = face_lists[s][b]
            face_idx[s, k, : len(fl)] = fl
            face_cnt[s, k] = len(fl)
    return InterfaceComms(nbr, node_idx, node_cnt, face_idx, face_cnt,
                          owner)


def _global_face_to_local(gface: np.ndarray, part: np.ndarray, s: int)\
        -> np.ndarray:
    """global 4*tet+face slot -> local 4*tet+face for shard s (tets of
    shard s are numbered in global order, as split_to_shards does)."""
    sel = np.where(part == s)[0]
    g2l_t = np.full(len(part), -1, np.int64)
    g2l_t[sel] = np.arange(len(sel))
    return (4 * g2l_t[gface // 4] + (gface % 4)).astype(np.int32)


# ---------------------------------------------------------------------------
# halo exchange over a shard stack
# ---------------------------------------------------------------------------
def halo_exchange(vals, send_idx, nbr):
    """Exchange per-interface-item values between the shards of a run
    (the JAX package's ``halo_exchange`` and its grouped dense and packed
    layouts: every one of them delivers the same values).

    vals:      [L, P, ...] per-local-entity values of the L shards this
               rank holds (every shard at one process)
    send_idx:  [S, K, I] local entity ids (-1 pad) of EVERY shard (the
               comm tables, global shard ids); item order matches the
               neighbor's table for the same pair (ordering contract)
    nbr:       [S, K] neighbor shard ids (-1 pad)
    Returns ``recv[L, K, I, ...]``: each neighbor's values for each item
    (zeros on pads).  The caller merges with its own gather + owner rule.

    At one process every shard is on this stack, so shard ``l`` reads
    ``recv[l, k, i] = vals[b, send_idx[b, k', i]]`` with ``b = nbr[l,
    k]`` and ``k'`` the slot of ``l`` in ``b``'s table.  Across processes
    each shard packs its send rows ``send[l, k, i] = vals[l, send_idx[l,
    k, i]]``, the packs of every rank are gathered in one collective, and
    shard ``l`` reads ``send[b, k', i]``."""
    from . import multihost, pod
    L = vals.shape[0]
    S, K, I = send_idx.shape
    dev = vals.device
    r0 = pod.row0()
    nbr_l = nbr[r0:r0 + L]
    b = nbr_l.clamp(0, S - 1).long()                     # [L,K]
    me = pod.shard_ids(L, dev).to(nbr.dtype).view(L, 1, 1)
    back = nbr[b] == me                                  # [L,K,K]
    kp = back.to(torch.int8).argmax(dim=-1)              # slot of l in b
    src = send_idx[b, kp]                                # [L,K,I]
    ok = ((nbr_l >= 0) & back.any(dim=-1))[..., None] & (src >= 0)
    if multihost.is_multiprocess():
        lix = torch.arange(L, device=dev).view(L, 1, 1).expand(L, K, I)
        send = vals[lix, send_idx[r0:r0 + L].clamp(
            0, vals.shape[1] - 1).long()]
        (send,) = multihost.all_gather_rows(send)        # [S,K,I,...]
        recv = send[b[..., None].expand(L, K, I),
                    kp[..., None].expand(L, K, I),
                    torch.arange(I, device=dev).expand(L, K, I)]
    else:
        recv = vals[b[..., None].expand(L, K, I),
                    src.clamp(0, vals.shape[1] - 1).long()]  # [L,K,I,...]
    ok = ok.view(L, K, I, *([1] * (recv.dim() - 3)))
    return torch.where(ok, recv, torch.zeros((), dtype=recv.dtype,
                                             device=dev))


def merge_owner_max(vals, send_idx, recv):
    """Merge received neighbor values into local entity values with the
    max rule (the reference's max-rank/max-value priority merges), for
    every shard of the stack: vals [S, P, ...], send_idx [S, K, I], recv
    [S, K, I, ...]."""
    from ..ops.primitives import reduce_drop
    S, K, I = send_idx.shape
    out = []
    for s in range(S):
        flat = torch.where(send_idx[s] >= 0, send_idx[s],
                           vals.shape[1]).reshape(-1)
        out.append(reduce_drop(vals[s], flat,
                               recv[s].reshape((K * I,) + tuple(
                                   recv.shape[3:])), "amax"))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# global numbering (PMMG_Compute_verticesGloNum, libparmmg.c:923)
# ---------------------------------------------------------------------------
def global_node_numbering(comms: InterfaceComms,
                          npoin: list[int]) -> list[np.ndarray]:
    """1-based global vertex numbers per shard.  Owner = max incident
    shard; per-shard owned counts -> exclusive scan offsets (the
    MPI_Allgather + prefix of the reference); non-owners receive the
    owner's number through the node comm tables."""
    S = len(npoin)
    owned = [comms.owner[s] == s for s in range(S)]
    counts = np.array([int(o.sum()) for o in owned])
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    glo = []
    for s in range(S):
        g = np.zeros(npoin[s], np.int64)
        g[owned[s]] = offs[s] + 1 + np.arange(counts[s])
        glo.append(g)
    # propagate owner numbers to the other copies via the comm tables:
    # item order matches pairwise, so positional transfer is exact
    for s in range(S):
        for k in range(comms.nbr.shape[1]):
            b = int(comms.nbr[s, k])
            if b < 0:
                continue
            cnt = int(comms.node_cnt[s, k])
            mine = comms.node_idx[s, k, :cnt]
            kp = int(np.where(comms.nbr[b] == s)[0][0])
            theirs = comms.node_idx[b, kp, :cnt]
            take = glo[b][theirs] > 0
            upd = (glo[s][mine] == 0) & take
            g = glo[s]
            g[mine[upd]] = glo[b][theirs][upd]
    return glo


def global_triangle_numbering(comms: InterfaceComms, ntria_owned:
                              list[int]) -> np.ndarray:
    """Offsets for boundary-triangle numbering (two-phase scheme of
    PMMG_Compute_trianglesGloNum, libparmmg.c:464): owned boundary tris
    first, then interface tris numbered by their owner side."""
    counts = np.asarray(ntria_owned)
    return np.concatenate([[0], np.cumsum(counts)[:-1]])


# ---------------------------------------------------------------------------
# the chkcomm oracle
# ---------------------------------------------------------------------------
def check_node_comms(comms: InterfaceComms,
                     verts: list[np.ndarray]) -> dict:
    """Coordinate-echo invariant check (PMMG_check_extNodeComm,
    chkcomm_pmmg.c:815): for every pair, the two ordered item lists must
    reference identical coordinates within a bbox-scaled epsilon."""
    S = comms.nbr.shape[0]
    allv = np.concatenate([v for v in verts if len(v)]) \
        if any(len(v) for v in verts) else np.zeros((1, 3))
    scale = max(1e-30, float(np.abs(allv).max()))
    bad = 0
    checked = 0
    for s in range(S):
        for k in range(comms.nbr.shape[1]):
            b = int(comms.nbr[s, k])
            if b < 0 or b < s:
                continue
            cnt = int(comms.node_cnt[s, k])
            kp_arr = np.where(comms.nbr[b] == s)[0]
            if len(kp_arr) == 0:
                bad += cnt
                continue
            kp = int(kp_arr[0])
            if int(comms.node_cnt[b, kp]) != cnt:
                bad += abs(int(comms.node_cnt[b, kp]) - cnt)
            m = min(cnt, int(comms.node_cnt[b, kp]))
            a_ids = comms.node_idx[s, k, :m]
            b_ids = comms.node_idx[b, kp, :m]
            d = np.abs(verts[s][a_ids] - verts[b][b_ids]).max(axis=1)
            bad += int((d > 1e-9 * scale).sum())
            checked += m
    return {"items_checked": checked, "mismatch": bad}


def check_face_comms(comms: InterfaceComms, tets: list[np.ndarray],
                     verts: list[np.ndarray]) -> dict:
    """Face version of the oracle (PMMG_check_extFaceComm,
    chkcomm_pmmg.c:1027): matched face barycenters must coincide."""
    S = comms.nbr.shape[0]
    bad = checked = 0
    for s in range(S):
        for k in range(comms.nbr.shape[1]):
            b = int(comms.nbr[s, k])
            if b < 0 or b < s:
                continue
            cnt = int(comms.face_cnt[s, k])
            kp = int(np.where(comms.nbr[b] == s)[0][0])
            m = min(cnt, int(comms.face_cnt[b, kp]))

            def bary(shard, slots):
                t, f = slots // 4, slots % 4
                tri = tets[shard][t][np.arange(len(t))[:, None],
                                     IDIR[f]]
                return verts[shard][tri].mean(axis=1)

            ba = bary(s, comms.face_idx[s, k, :m])
            bb = bary(b, comms.face_idx[b, kp, :m])
            d = np.abs(ba - bb).max(axis=1)
            bad += int((d > 1e-9).sum())
            checked += m
    return {"items_checked": checked, "mismatch": bad}
