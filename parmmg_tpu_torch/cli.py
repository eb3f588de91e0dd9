"""Command-line interface of the PyTorch port (port of ``cli.py``).

    python -m parmmg_tpu_torch.cli -in X.mesh [-sol X.sol] [-field F.sol]
                                   -out Y.mesh

Runs on the CUDA device unless ``-device cpu`` is given.  The input is a
Medit ``.mesh``/``.meshb`` file, an ascii ``.vtu`` file (its ``metric`` /
``sol`` point field is the metric, its other point fields are solution
fields carried through the remesh), or a distributed set
``name.<rank>.mesh`` (reassembled into one mesh).  The metric file holds a
scalar size (``SOL_SCALAR``) or a packed symmetric tensor (``SOL_TENSOR``)
per vertex; the output ``.sol`` has the input's kind.  ``-field`` names a
``.sol`` file of solution fields, P1-interpolated onto the new mesh.  The
output is ``.mesh``/``.meshb``, ``.vtu`` or ``.pvtu``; with
``-distributed-output`` it is written as the distributed file
``name.0.mesh``, or with ``-ndev N`` as N rank files ``name.<r>.mesh``
holding their vertex and face communicator sections.  ``-mesh-size N``
below the tet count remeshes in
groups of about N tets (``parallel/groups.py``) over ``-niter`` passes,
displacing the group seams by ``-nlayers`` layers between passes; with
``PMTORCH_CKPT_DIR`` set, every pass is checkpointed there and
``-resume`` restarts a killed grouped run after its newest pass
checkpoint, writing the bytes of an uninterrupted run.  ``-ndev N`` runs
N shards stacked on the one device, repartitioned between ``-niter``
passes unless ``-nobalance`` is set.  Every flag of the JAX package's CLI
is accepted.  ``python -m parmmg_tpu_torch.api.knobs`` lists
the ``PMTORCH_*`` environment knobs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from .api.parmesh import ParMesh
from .core import constants as C


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parmmg_tpu_torch", prefix_chars="-",
        description="PyTorch/CUDA tetrahedral remesher")
    a = p.add_argument
    a("-in", dest="inp", metavar="file",
      help="input mesh (.mesh/.meshb/.vtu, or name.<rank>.mesh shards)")
    a("-out", dest="out", metavar="file", help="output mesh")
    a("-sol", "-met", dest="sol", metavar="file", help="metric file")
    a("-field", dest="field", metavar="file",
      help="solution fields to interpolate (.sol)")
    a("-noout", action="store_true", help="no output mesh")
    a("-v", dest="verbose", type=int, default=1, help="verbosity")
    a("-mmg-v", dest="mmg_verbose", type=int, default=-1,
      help="remesh-kernel verbosity")
    a("-m", dest="mem", type=int, default=-1, help="memory budget MB")
    a("-d", dest="debug", action="store_true", help="debug mode")
    a("-niter", type=int, default=C.NITER_DEFAULT,
      help="adaptation iterations")
    a("-mesh-size", dest="mesh_size", type=int,
      default=C.TARGET_MESH_SIZE_SENTINEL, help="target group mesh size")
    a("-metis-ratio", dest="metis_ratio", type=int,
      default=C.RATIO_MMG_METIS_SENTINEL,
      help="ratio of migration groups to remesh groups (multi-device)")
    a("-nlayers", type=int, default=C.MVIFCS_NLAYERS,
      help="interface displacement layers (grouped runs)")
    a("-groups-ratio", dest="groups_ratio", type=float, default=C.GRPS_RATIO,
      help="allowed group imbalance (multi-device)")
    a("-nobalance", action="store_true",
      help="no load balancing (multi-device)")
    a("-ndev", type=int, default=1,
      help="number of shards (distributed pass, all on the one device)")
    a("-device", default="cuda", choices=("cuda", "cpu"),
      help="torch device (default cuda)")
    a("-hmin", type=float, default=-1.0)
    a("-hmax", type=float, default=-1.0)
    a("-hsiz", type=float, default=-1.0, help="constant target size")
    a("-hausd", type=float, default=C.HAUSD_DEFAULT)
    a("-hgrad", type=float, default=C.HGRAD_DEFAULT)
    a("-hgradreq", type=float, default=C.HGRADREQ_DEFAULT)
    a("-ar", dest="angle", type=float, default=C.ANGEDG_DEG,
      help="ridge detection angle (deg)")
    a("-nr", dest="noridge", action="store_true", help="no ridge detection")
    a("-A", dest="aniso", action="store_true",
      help="anisotropic metric computation (reference -A flag)")
    a("-mmg-d", dest="mmg_debug", action="store_true",
      help="remesh-kernel debug mode")
    a("-optim", action="store_true", help="preserve current sizing")
    a("-optimLES", action="store_true")
    a("-noinsert", action="store_true")
    a("-noswap", action="store_true")
    a("-nomove", action="store_true")
    a("-nosurf", action="store_true")
    a("-nofem", action="store_true")
    a("-opnbdy", action="store_true", help="preserve open boundaries")
    a("-octree", type=int, default=-1, help="(accepted, unused)")
    a("-rn", type=int, default=-1, help="(renumbering: accepted, unused)")
    a("-centralized-output", dest="cent_out", action="store_true")
    a("-distributed-output", dest="dist_out", action="store_true",
      help="write the output as distributed files name.<rank>.mesh (one "
           "a shard with -ndev)")
    a("-resume", action="store_true",
      help="resume a grouped (-mesh-size) run after the newest pass "
           "checkpoint of the same input in PMTORCH_CKPT_DIR (from scratch "
           "if there is none)")
    a("-group-polish", dest="group_polish", action="store_true",
      help="polish each group after every grouped (-mesh-size) pass, "
           "before the merge; a chunked pass polishes in a fresh process "
           "with PMTORCH_POLISH_SUBPROC=1")
    a("-val", action="store_true", help="print default values and exit")
    a("-bench-json", dest="bench_json", action="store_true",
      help="print one JSON line with timing/quality stats")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.val:
        from .api.params import Info
        for f, v in sorted(vars(Info()).items()):
            print(f"  {f:24s} {v}")
        return 0
    if not args.inp:
        print("missing -in <mesh>", file=sys.stderr)
        return 1
    from .io import medit
    from .io.distributed import load_distributed_mesh, probe_distributed

    t0 = time.perf_counter()
    pm = ParMesh(device=args.device)
    inp = Path(args.inp)
    vtu_met = vtu_fields = None
    if inp.suffix == ".vtu":
        from .io.vtk import read_vtu_medit
        if not inp.exists():
            print(f"cannot open {inp}", file=sys.stderr)
            return 1
        m, vtu_met, vtu_fields = read_vtu_medit(inp)
    else:
        if inp.suffix not in (".mesh", ".meshb"):
            inp = inp.with_suffix(".mesh")
        if inp.exists():
            m = medit.read_mesh(inp)
        elif probe_distributed(inp, 0):
            parts = []
            while probe_distributed(inp, len(parts)):
                parts.append(load_distributed_mesh(inp, len(parts))[0])
            m = _concat_shards(parts)
            # distributed input stays distributed: the run adopts the
            # caller's decomposition when -ndev matches the shard count
            pm._in_part = m.src_part
        else:
            print(f"cannot open {inp}", file=sys.stderr)
            return 1
    pm.set_mesh_size(np_=len(m.vert), ne=len(m.tetra), nt=len(m.tria),
                     na=len(m.edges))
    pm.set_vertices(m.vert, m.vref)
    pm.set_tetrahedra(m.tetra + 1, m.tref)
    if len(m.tria):
        pm.set_triangles(m.tria + 1, m.triaref)
    if len(m.edges):
        pm.set_edges(m.edges + 1, m.edgeref)
    for c in m.corners:
        pm.set_corner(int(c) + 1)
    for rv in m.required_vert:
        pm.set_required_vertex(int(rv) + 1)
    for rid in m.ridges:
        pm.set_ridge(int(rid) + 1)
    if args.sol:
        vals, types = medit.read_sol(args.sol)
        if types[0] == medit.SOL_TENSOR:
            pm.set_met_size(3, len(m.vert))
            pm.set_tensor_mets(vals.reshape(len(m.vert), 6))
        else:
            pm.set_met_size(1, len(m.vert))
            pm.set_scalar_mets(vals.reshape(len(m.vert)))
    elif vtu_met is not None:
        if vtu_met.ndim == 2 and vtu_met.shape[1] == 6:
            pm.set_met_size(3, len(m.vert))
            pm.set_tensor_mets(vtu_met)
        else:
            pm.set_met_size(1, len(m.vert))
            pm.set_scalar_mets(np.asarray(vtu_met).reshape(len(m.vert)))
    if args.field:
        vals, types = medit.read_sol(args.field)
        pm.set_sols_at_vertices_size(len(types), types)
        vals2 = vals.reshape(len(m.vert), -1)
        off = 0
        for i, t in enumerate(types):
            w = {1: 1, 2: 3, 3: 6}[t]
            chunk = vals2[:, off:off + w]
            pm.set_ith_sol_in_sols_at_vertices(
                i + 1, chunk if w > 1 else chunk[:, 0])
            off += w
    elif vtu_fields:
        # the other point fields ride along as solution fields: 1, 3 and
        # 6 components map to the Medit sol types, others are dropped
        carried, types = [], []
        for nm, arr in vtu_fields.items():
            a = np.asarray(arr, np.float64).reshape(len(m.vert), -1)
            typ = {1: medit.SOL_SCALAR, 3: medit.SOL_VECTOR,
                   6: medit.SOL_TENSOR}.get(a.shape[1])
            if typ is None:
                print(f"warning: dropping VTU point field '{nm}' "
                      f"({a.shape[1]} components)", file=sys.stderr)
                continue
            carried.append(a[:, 0] if a.shape[1] == 1 else a)
            types.append(typ)
        if carried:
            pm.set_sols_at_vertices_size(len(types), types)
            for i, chunk in enumerate(carried):
                pm.set_ith_sol_in_sols_at_vertices(i + 1, chunk)

    info = pm.info
    info.imprim = args.verbose
    info.mmg_imprim = args.mmg_verbose
    info.debug = args.debug
    info.mmg_debug = args.mmg_debug
    info.niter = args.niter
    info.target_mesh_size = args.mesh_size
    info.metis_ratio = args.metis_ratio
    info.ifc_layers = args.nlayers
    info.grps_ratio = args.groups_ratio
    info.nobalancing = args.nobalance
    info.n_devices = args.ndev
    info.hmin, info.hmax = args.hmin, args.hmax
    info.hsiz = args.hsiz
    info.hausd = args.hausd
    info.hgrad = args.hgrad
    info.hgradreq = args.hgradreq
    info.angle_deg = args.angle
    info.angle_detection = not args.noridge
    info.optim = args.optim
    info.optimLES = args.optimLES
    info.anisosize = args.aniso
    info.noinsert = args.noinsert
    info.noswap = args.noswap
    info.nomove = args.nomove
    info.nosurf = args.nosurf
    info.fem = not args.nofem
    info.opnbdy = args.opnbdy
    info.mem_budget_mb = args.mem
    info.centralized_output = not args.dist_out
    info.noout = args.noout
    info.resume = args.resume
    info.group_polish = args.group_polish

    parfile = Path(args.inp).with_suffix(".mmg3d")
    if parfile.exists():
        try:
            parsed = _parse_parfile(parfile)
        except (IndexError, ValueError) as e:
            print(f"  ## Warning: unable to parse {parfile} ({e}); local "
                  "parameters ignored.", file=sys.stderr)
            parsed = []
        for entry in parsed:
            pm.set_local_parameter(*entry)

    ret = pm.run()
    dt = time.perf_counter() - t0
    if ret == C.PMMG_LOWFAILURE:
        print("adaptation INCOMPLETE (low failure): saving the last "
              "conforming mesh", file=sys.stderr)
        if not args.noout:
            _save_outputs(pm, args)
        return ret
    if ret != C.PMMG_SUCCESS:
        print(f"adaptation FAILED ({ret})", file=sys.stderr)
        return ret
    if args.verbose >= C.PMMG_VERB_QUAL or args.bench_json:
        _report(pm, dt, args.bench_json, args.verbose)
    if not args.noout:
        _save_outputs(pm, args)
    return 0


def _parse_parfile(path):
    """Mmg local-parameter file -> [(typ, ref, hmin, hmax, hausd)]."""
    typ_map = {"triangle": 1, "triangles": 1,
               "tetrahedron": 2, "tetrahedra": 2, "tetrahedrons": 2,
               "edge": 3, "edges": 3, "ridge": 3,
               "vertex": 0, "vertices": 0}
    out = []
    lines = [ln.strip() for ln in path.read_text().splitlines()
             if ln.strip() and not ln.strip().startswith("#")]
    i = 0
    while i < len(lines):
        if lines[i].lower().startswith("parameters"):
            n = int(lines[i + 1].split()[0])
            for j in range(n):
                tok = lines[i + 2 + j].split()
                typ = typ_map.get(tok[1].lower())
                if typ is None:
                    print(f"  ## Warning: unsupported local-parameter type "
                          f"'{tok[1]}' in {path}; entry skipped.",
                          file=sys.stderr)
                    continue
                out.append((typ, int(tok[0]), float(tok[2]), float(tok[3]),
                            float(tok[4])))
            i += 2 + n
        else:
            i += 1
    return out


def _concat_shards(parts):
    """One mesh from distributed shard files, interface vertices merged on
    equal coordinates (rounded to 1e-12); ``src_part`` is each tet's
    shard."""
    from .io.medit import MeditMesh
    m = MeditMesh()
    off = 0
    vs, vr, ts, tr, src = [], [], [], [], []
    for k, p in enumerate(parts):
        vs.append(p.vert)
        vr.append(p.vref)
        ts.append(p.tetra + off)
        tr.append(p.tref)
        src.append(np.full(len(p.tetra), k, np.int32))
        off += len(p.vert)
    m.vert = np.concatenate(vs)
    m.vref = np.concatenate(vr)
    m.tetra = np.concatenate(ts)
    m.tref = np.concatenate(tr)
    m.src_part = np.concatenate(src)
    uniq, inv = np.unique(m.vert.round(12), axis=0, return_inverse=True)
    if len(uniq) < len(m.vert):
        inv = inv.reshape(-1)
        # the first vertex of each coordinate keeps its place
        seen = np.full(len(uniq), len(inv), np.int64)
        np.minimum.at(seen, inv, np.arange(len(inv)))
        keep = np.zeros(len(m.vert), bool)
        keep[seen] = True
        newid = np.cumsum(keep) - 1
        m.tetra = newid[seen[inv[m.tetra]]].astype(np.int32)
        m.vert = m.vert[keep]
        m.vref = m.vref[keep]
    return m


def _save_distributed_shards(pm, m, tri_tet, out, ndev):
    """Distributed output of a ``-ndev`` run: the adapted mesh split into
    ``ndev`` shards, written as ``name.<rank>.mesh`` files with
    ParallelVertex/TriangleCommunicators sections (inout_pmmg.c:74-486
    format), the reference's ``-distributed-output`` round trip.  The
    partition is the run's own (``pm._out_part``, the source shard of
    every output tet) when the polish kept the tet set, else a fresh
    greedy partition.  ``tri_tet``: the output tet adjacent to each of
    ``m.tria``; a boundary triangle goes to that tet's shard."""
    from .core.constants import IDIR
    from .io.distributed import ShardComm, shards_to_distributed_files
    from .parallel.comms import build_interface_comms
    from .parallel.partition import fix_contiguity, greedy_partition

    tet0 = np.asarray(m.tetra, np.int64)
    part = getattr(pm, "_out_part", None)
    if part is None or len(part) != len(tet0) or part.max() >= ndev:
        cent = m.vert[tet0].mean(axis=1)
        part = fix_contiguity(tet0, greedy_partition(tet0, cent, ndev))
    l2g = [np.unique(tet0[part == s]) for s in range(ndev)]
    g2l = []
    for s in range(ndev):
        mp = np.full(len(m.vert), -1, np.int64)
        mp[l2g[s]] = np.arange(len(l2g[s]))
        g2l.append(mp)
    comms = build_interface_comms(tet0, part, ndev, l2g, g2l)

    tglob = np.asarray(m.tria, np.int64) if len(m.tria) else \
        np.zeros((0, 3), np.int64)
    tri_owner = part[np.asarray(tri_tet, np.int64)]

    shards = []
    for s in range(ndev):
        sel = part == s
        stet = g2l[s][tet0[sel]].astype(np.int32)
        # the shard's triangles: its interface faces (in comm-table order,
        # so communicator items reference them by position), then its
        # share of the true boundary triangles
        tris, trefs, face_comms, node_comms = [], [], [], []
        for k in range(comms.nbr.shape[1]):
            b = int(comms.nbr[s, k])
            if b < 0:
                continue
            nf = int(comms.face_cnt[s, k])
            fidx = comms.face_idx[s, k, :nf]         # 4*local_tet+face
            lt, lf = fidx // 4, fidx % 4
            fv = stet[lt][np.arange(nf)[:, None], np.asarray(IDIR)[lf]]
            first = sum(len(t) for t in tris)
            tris.append(fv)
            trefs.append(np.zeros(nf, np.int32))
            # global face id, the same on both sides: the sorted global
            # vertex triple
            gfv = np.sort(l2g[s][fv], axis=1)
            gid = (gfv[:, 0] << 42) | (gfv[:, 1] << 21) | gfv[:, 2]
            face_comms.append(ShardComm(
                b, np.arange(first + 1, first + nf + 1), gid))
            nn = int(comms.node_cnt[s, k])
            nidx = comms.node_idx[s, k, :nn]
            node_comms.append(ShardComm(b, nidx + 1, l2g[s][nidx] + 1))
        if len(tglob):
            mine = tri_owner == s
            tris.append(g2l[s][tglob[mine]].astype(np.int32))
            trefs.append(m.triaref[mine])
        sh = {"vert": m.vert[l2g[s]], "vref": m.vref[l2g[s]],
              "tet": stet, "tref": m.tref[sel], "face_comms": face_comms,
              "node_comms": node_comms}
        if tris:
            sh["tria"] = np.concatenate(tris).astype(np.int32)
            sh["triaref"] = np.concatenate(trefs)
        shards.append(sh)
    shards_to_distributed_files(out, shards)


def _report(pm, dt, as_json, verbose):
    from .ops.quality import tet_quality
    q = tet_quality(pm._out, pm._out_met).cpu().numpy()
    tm = pm._out.tmask.cpu().numpy()
    st = pm.stats
    rec = {
        "ntets": int(tm.sum()),
        "qmin": float(q[tm].min()) if tm.any() else 0.0,
        "qmean": float(q[tm].mean()) if tm.any() else 0.0,
        "nsplit": st.nsplit, "ncollapse": st.ncollapse, "nswap": st.nswap,
        "cycles": st.cycles,
        "wall_s": round(dt, 3),
    }
    if as_json:
        print(json.dumps(rec))
    elif verbose >= C.PMMG_VERB_VERSION:
        print(f"  #tets {rec['ntets']}  quality min {rec['qmin']:.4f} mean "
              f"{rec['qmean']:.4f}  ops s/c/w {rec['nsplit']}/"
              f"{rec['ncollapse']}/{rec['nswap']}  {rec['wall_s']}s")


def _save_outputs(pm, args):
    from .io.medit import (MeditMesh, SOL_SCALAR, SOL_TENSOR, write_mesh,
                           write_sol)
    out = Path(args.out) if args.out else \
        Path(args.inp).with_name(Path(args.inp).stem + ".o.mesh")
    vert, vref = pm.get_vertices()
    tet, tref = pm.get_tetrahedra()
    if out.suffix in (".vtu", ".pvtu"):
        from .io.vtk import write_pvtu, write_vtu
        vtu = write_vtu(out.with_suffix(".vtu"), vert, tet - 1)
        if out.suffix == ".pvtu":
            write_pvtu(out, [vtu])
        return
    tris, trefs = pm.get_triangles()
    m = MeditMesh()
    m.vert, m.vref = vert.astype(np.float64), vref
    m.tetra, m.tref = tet - 1, tref
    m.tria, m.triaref = tris - 1, trefs
    edges, erefs, eridge, ereq = pm.get_edges()
    if len(edges):
        m.edges, m.edgeref = edges - 1, erefs
        m.ridges = np.flatnonzero(eridge).astype(np.int32)
        m.required_edges = np.flatnonzero(ereq).astype(np.int32)
    vtag = pm._out_host()[4]
    m.corners = np.flatnonzero(vtag & C.MG_CRN).astype(np.int32)
    m.required_vert = np.flatnonzero(
        ((vtag & C.MG_REQ) != 0) & ((vtag & C.MG_PARBDY) == 0)
    ).astype(np.int32)
    if args.dist_out:
        from .io.distributed import save_distributed_mesh
        if pm.info.n_devices > 1:
            _save_distributed_shards(pm, m, pm._out_triangles()[3], out,
                                     pm.info.n_devices)
        else:
            save_distributed_mesh(out, 0, m)
    else:
        write_mesh(out, m)
    met = pm.get_metric()
    if met is not None:
        write_sol(out.with_suffix(".sol"), met.reshape(len(vert), -1),
                  [SOL_TENSOR if met.ndim == 2 else SOL_SCALAR])


if __name__ == "__main__":
    sys.exit(main())
