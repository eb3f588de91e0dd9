"""Debug dumps (the port's copy of ``utils/debug.py``; debug_pmmg.c
parity).

The reference dumps per-group meshes, tag tables and communicator
contents to text and ``.mesh`` files (debug_pmmg.c:62-773) for
post-mortem inspection.  :func:`dump_mesh` writes the JAX package's bytes
for the same mesh, :func:`dump_comms` its text for the same communicator
tables.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core import constants as C
from ..core.mesh import Mesh, mesh_to_host


def dump_mesh(mesh: Mesh, path: str | Path, met=None) -> Path:
    """Write the (compacted) mesh as Medit .mesh with its boundary
    triangles (+ .sol for the metric): PMMG_grplst_meshes_to_saveMesh
    flavor."""
    from ..core.mesh import tet_face_vertices
    from ..io.medit import (SOL_SCALAR, SOL_TENSOR, MeditMesh, write_mesh,
                            write_sol)

    path = Path(path)
    vert, tet, vref, tref, vtag = mesh_to_host(mesh)
    m = MeditMesh()
    m.vert, m.vref = vert, vref
    m.tetra, m.tref = tet, tref
    vm = mesh.vmask.cpu().numpy()
    new_id = np.cumsum(vm) - 1
    fv = tet_face_vertices(mesh.tet).cpu().numpy()
    ftag = mesh.ftag.cpu().numpy()
    sel = ((ftag & C.MG_BDY) != 0) & mesh.tmask.cpu().numpy()[:, None]
    m.tria = new_id[fv[sel]].astype(np.int32)
    m.triaref = mesh.fref.cpu().numpy()[sel]
    write_mesh(path, m)
    if met is not None:
        mh = met.cpu().numpy()[vm]
        write_sol(path.with_suffix(".sol"), mh.reshape(len(vert), -1),
                  [SOL_TENSOR if mh.ndim == 2 and mh.shape[1] == 6
                   else SOL_SCALAR])
    return path


def dump_tags(mesh: Mesh, path: str | Path) -> Path:
    """Per-vertex tag table (PMMG_print_* flavor)."""
    path = Path(path)
    vert, tet, vref, tref, vtag = mesh_to_host(mesh)
    names = [("BDY", C.MG_BDY), ("REQ", C.MG_REQ), ("CRN", C.MG_CRN),
             ("GEO", C.MG_GEO), ("REF", C.MG_REF), ("NOM", C.MG_NOM),
             ("PARBDY", C.MG_PARBDY), ("PARBDYBDY", C.MG_PARBDYBDY)]
    with open(path, "w") as f:
        for i, t in enumerate(vtag):
            tags = "|".join(n for n, b in names if t & b) or "-"
            f.write(f"{i} {vert[i][0]:.6g} {vert[i][1]:.6g} "
                    f"{vert[i][2]:.6g} {tags}\n")
    return path


def dump_comms(comms, path: str | Path) -> Path:
    """Communicator tables printer (PMMG_print_ext_comm flavor): for every
    shard pair its node and face counts and the node items."""
    path = Path(path)
    with open(path, "w") as f:
        S, K, _ = comms.node_idx.shape
        for s in range(S):
            for k in range(K):
                b = int(comms.nbr[s, k])
                if b < 0:
                    continue
                n = int(comms.node_cnt[s, k])
                nf = int(comms.face_cnt[s, k])
                f.write(f"shard {s} <-> {b}: {n} nodes, {nf} faces\n")
                f.write("  nodes: " + " ".join(
                    map(str, comms.node_idx[s, k, :n])) + "\n")
    return path


def check_mesh_consistency(mesh: Mesh) -> dict:
    """Aggregate self-check: adjacency symmetry, positive volumes, mask
    consistency (the debug-build assertion battery of the reference)."""
    from ..core.mesh import tet_volumes
    from ..ops.adjacency import build_adjacency, check_adjacency

    m = build_adjacency(mesh)
    out = dict(check_adjacency(m))
    tmask = m.tmask.cpu().numpy()
    vols = tet_volumes(m).cpu().numpy()[tmask]
    out["nonpositive_vols"] = int((vols <= 0).sum())
    tet = m.tet.cpu().numpy()[tmask]
    vm = m.vmask.cpu().numpy()
    out["dangling_vertex_refs"] = int((~vm[tet]).sum())
    return out
