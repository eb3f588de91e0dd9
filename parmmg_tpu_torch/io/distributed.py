"""Distributed Medit I/O: per-shard mesh files + communicator sections
(port of the file format half of ``io/distributed.py``).

ParMmg's distributed format (src/inout_pmmg.c): each shard writes
``name.<rank>.mesh[b]`` (filename decoration ``PMMG_insert_rankIndex``,
inout_pmmg.c:387) containing its submesh plus custom Medit sections
describing the parallel interfaces:

    ParallelTriangleCommunicators        (or ParallelVertexCommunicators)
    <ncomm>
    <color_out_0> <nitem_0>
    ...
    # then, per communicator, nitem lines of
    <local id> <global id>

(The reference stores (local, global, icomm) triples after per-comm
color/size headers, inout_pmmg.c:74-186; grouping the triples per comm is
the same information.)  This doubles as the framework's checkpoint/resume
format, like the reference's ``-distributed-output`` round trip.
:func:`stacked_to_distributed_files` writes slots of a stacked state
straight to rank files, without a merge (the serve pool's tenant output;
with the comm tables and the global numbering of a distributed run, each
file's vertex communicators), :func:`shards_to_distributed_files` host
shards with their communicators (the CLI's ``-ndev N
-distributed-output``); :func:`interface_comms_of` turns a read-back
file set's sections into the padded tables of ``parallel/comms.py``, for
its echo checks.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .medit import MeditMesh, read_mesh, write_mesh


@dataclasses.dataclass
class ShardComm:
    """One external communicator of a shard (PMMG_Ext_comm analogue)."""
    color_out: int                  # neighbor shard id
    local: np.ndarray               # local entity ids (1-based, Medit-style)
    global_: np.ndarray             # global entity ids


def insert_rank_index(path: str | Path, rank: int) -> Path:
    """name.mesh -> name.<rank>.mesh (PMMG_insert_rankIndex flavor)."""
    p = Path(path)
    return p.with_name(f"{p.stem}.{rank}{p.suffix}")


def save_distributed_mesh(path: str | Path, rank: int, m: MeditMesh,
                          face_comms: list[ShardComm] | None = None,
                          node_comms: list[ShardComm] | None = None) -> Path:
    """Write one shard's mesh + communicator sections."""
    out = insert_rank_index(path, rank)
    write_mesh(out, m)
    # append communicator sections to the ASCII file / as sidecar for binary
    if out.suffix == ".meshb":
        side = out.with_suffix(".comm")
        with open(side, "w") as f:
            _write_comm_sections(f, face_comms, node_comms)
    else:
        text = out.read_text()
        text = text.replace("\nEnd\n", "\n")
        with open(out, "w") as f:
            f.write(text)
            _write_comm_sections(f, face_comms, node_comms)
            f.write("End\n")
    return out


def _write_comm_sections(f, face_comms, node_comms):
    for name, comms in (("ParallelTriangleCommunicators", face_comms),
                        ("ParallelVertexCommunicators", node_comms)):
        if not comms:
            continue
        f.write(f"\n{name}\n{len(comms)}\n")
        for c in comms:
            f.write(f"{c.color_out} {len(c.local)}\n")
        for c in comms:
            for lo, gl in zip(c.local, c.global_):
                f.write(f"{int(lo)} {int(gl)}\n")


def load_distributed_mesh(path: str | Path, rank: int):
    """Read one shard file -> (MeditMesh, face_comms, node_comms)."""
    p = insert_rank_index(path, rank)
    m = read_mesh(p)
    face_comms, node_comms = [], []
    src = p.with_suffix(".comm") if p.suffix == ".meshb" else p
    if src.exists():
        face_comms = _parse_comm_section(
            src, "ParallelTriangleCommunicators")
        node_comms = _parse_comm_section(
            src, "ParallelVertexCommunicators")
    return m, face_comms, node_comms


def _parse_comm_section(path: Path, keyword: str) -> list[ShardComm]:
    toks = []
    with open(path) as f:
        txt = f.read()
    if keyword not in txt:
        return []
    toks = txt[txt.index(keyword) + len(keyword):].split()
    ncomm = int(toks[0])
    i = 1
    heads = []
    for _ in range(ncomm):
        heads.append((int(toks[i]), int(toks[i + 1])))
        i += 2
    comms = []
    for color, nit in heads:
        lo = np.zeros(nit, np.int64)
        gl = np.zeros(nit, np.int64)
        for k in range(nit):
            lo[k] = int(toks[i]); gl[k] = int(toks[i + 1])
            i += 2
        comms.append(ShardComm(color, lo, gl))
    return comms


def probe_distributed(path: str | Path, rank: int = 0) -> bool:
    """Centralized-vs-distributed input probe (parmmg.c:161-188 flavor):
    True if the rank-decorated file exists."""
    return insert_rank_index(path, rank).exists()


# ---------------------------------------------------------------------------
# stacked state -> rank files, no merge
# ---------------------------------------------------------------------------
def writer_tables(vmask: torch.Tensor, tmask: torch.Tensor,
                  tet: torch.Tensor):
    """Per slot of a stacked state: the dense-to-compact vertex
    renumbering, the renumbered connectivity and the live counts (the JAX
    package's jitted ``writer_tables`` program, as plain torch).

    ``vmask`` [S, capP], ``tmask`` [S, capT], ``tet`` [S, capT, 4] ->
    (new_id [S, capP] (-1 dead), tet_l [S, capT, 4] (-1 dead rows),
    nvert [S], ntet [S]), int32."""
    capP = vmask.shape[1]
    new_id = torch.where(vmask, torch.cumsum(vmask, dim=1,
                                             dtype=torch.int32) - 1, -1)
    ix = tet.clamp(0, capP - 1).reshape(tet.shape[0], -1).long()
    tet_l = torch.where(tmask[..., None],
                        torch.gather(new_id, 1, ix).reshape(tet.shape), -1)
    return (new_id, tet_l, vmask.sum(dim=1, dtype=torch.int32),
            tmask.sum(dim=1, dtype=torch.int32))


def stacked_to_distributed_files(path, stacked, n_shards: int,
                                 shards=None, comms=None,
                                 glo=None) -> list[Path]:
    """Write ``name.<rank>.mesh`` files directly from a stacked state
    (``core.mesh.MeshStack``), with no ``merge_shards`` (the reference's
    ``-distributed-output`` never centralizes either, inout_pmmg.c:387).

    ``shards`` selects a subset of slots, re-ranked densely (slot
    ``shards[i]`` -> ``name.<i>.mesh``): the serve pool writes one
    tenant's slot this way.  With ``comms`` (a distributed run's
    ``InterfaceComms``) and ``glo`` (its global vertex numbering, one
    array a shard) each file gets its vertex communicators: local ids
    renumbered into the file's compacted numbering, globals from ``glo``
    (1-based); a neighbor outside the written subset is an error, since
    the file set could never resolve it.  Without ``comms`` no
    communicator section is written."""
    new_id, tet_l, _, _ = writer_tables(stacked.vmask, stacked.tmask,
                                        stacked.tet)
    new_id = new_id.cpu().numpy()
    tet_l = tet_l.cpu().numpy()
    vert, vref, tref, vmask, tmask = (
        getattr(stacked, f).cpu().numpy()
        for f in ("vert", "vref", "tref", "vmask", "tmask"))
    ranks = list(range(n_shards)) if shards is None \
        else [int(s) for s in shards]
    rankmap = {r: i for i, r in enumerate(ranks)}
    outs = []
    for i, r in enumerate(ranks):
        m = MeditMesh()
        m.vert = vert[r][vmask[r]].astype(np.float64)
        m.vref = vref[r][vmask[r]]
        m.tetra = tet_l[r][tmask[r]].astype(np.int32)
        m.tref = tref[r][tmask[r]]
        node_comms = []
        for k in range(comms.nbr.shape[1] if comms is not None else 0):
            b = int(comms.nbr[r, k])
            if b < 0:
                continue
            if b not in rankmap:
                raise ValueError(
                    f"shard {r} has a communicator to slot {b} outside "
                    f"the written subset {ranks}: the subset must be "
                    "closed under its communicators")
            cnt = int(comms.node_cnt[r, k])
            rows = comms.node_idx[r, k, :cnt]
            node_comms.append(ShardComm(
                rankmap[b], new_id[r][rows].astype(np.int64) + 1,
                np.asarray(glo[r])[rows].astype(np.int64) + 1))
        outs.append(save_distributed_mesh(path, i, m, None, node_comms))
    return outs


def shards_to_distributed_files(path, shards_host: list[dict]) -> list[Path]:
    """Write one rank file a shard: ``shards_host`` holds dicts with keys
    vert, tet (0-based) and optionally vref, tref, tria / triaref and
    'face_comms' / 'node_comms' (``ShardComm`` lists)."""
    outs = []
    for r, sh in enumerate(shards_host):
        m = MeditMesh()
        m.vert = np.asarray(sh["vert"], np.float64)
        m.vref = np.asarray(sh.get("vref",
                                   np.zeros(len(m.vert), np.int32)))
        m.tetra = np.asarray(sh["tet"], np.int32)
        m.tref = np.asarray(sh.get("tref",
                                   np.zeros(len(m.tetra), np.int32)))
        if "tria" in sh:
            m.tria = np.asarray(sh["tria"], np.int32)
            m.triaref = np.asarray(sh.get("triaref",
                                          np.zeros(len(m.tria), np.int32)))
        outs.append(save_distributed_mesh(
            path, r, m, sh.get("face_comms"), sh.get("node_comms")))
    return outs


def interface_comms_of(parts):
    """The ``parallel.comms.InterfaceComms`` of a distributed file set:
    ``parts`` is one ``(MeditMesh, face_comms, node_comms)`` a rank, as
    :func:`load_distributed_mesh` returns them.  Node items become vertex
    rows, face items (triangle ids of the rank's ``tria``) the tet-face
    slots 4*t+f of the tet holding that triangle; the owner of a vertex is
    the largest rank that shares it.  ``check_node_comms`` /
    ``check_face_comms`` on the result echo the files' communicators."""
    from ..core.constants import IDIR
    from ..parallel.comms import pad_comm_tables
    S = len(parts)
    node_lists = [[[] for _ in range(S)] for _ in range(S)]
    face_lists = [[[] for _ in range(S)] for _ in range(S)]
    owner = []
    for s, (m, fcs, ncs) in enumerate(parts):
        own = np.full(len(m.vert), s, np.int32)
        for c in ncs:
            rows = np.asarray(c.local, np.int64) - 1
            node_lists[s][c.color_out] = rows.tolist()
            own[rows] = np.maximum(own[rows], c.color_out)
        owner.append(own)
        if not fcs:
            continue
        tet = np.asarray(m.tetra, np.int64)
        fk = np.sort(tet[:, IDIR].reshape(-1, 3), axis=1)
        key = (fk[:, 0] << 42) | (fk[:, 1] << 21) | fk[:, 2]
        order = np.argsort(key, kind="stable")
        for c in fcs:
            tri = np.sort(np.asarray(m.tria, np.int64)[
                np.asarray(c.local, np.int64) - 1], axis=1)
            tk = (tri[:, 0] << 42) | (tri[:, 1] << 21) | tri[:, 2]
            pos = np.clip(np.searchsorted(key[order], tk), 0, len(key) - 1)
            if not np.array_equal(key[order][pos], tk):
                raise ValueError(f"rank {s}: a communicator triangle is no "
                                 "face of the rank's tets")
            face_lists[s][c.color_out] = order[pos].tolist()
    return pad_comm_tables(node_lists, face_lists, owner, S)
