"""ParMesh: the public mesh-adaptation object (port of ``api/parmesh.py``).

The set/get surface of the JAX class: numpy staging arrays in, one flat
torch Mesh adapted on ``device`` (``"cuda"`` unless the caller asks for
``"cpu"``), numpy arrays out; entity ids are 1-based.  The metric is a
scalar size per vertex or a packed symmetric tensor (m11, m12, m13, m22,
m23, m33).  User solution fields at vertices are carried through the
remesh by P1 interpolation from a background copy of the input
(``driver.interpolate_fields``).  Prisms and quadrilaterals pass through
untouched, their vertices frozen.  The distributed API's node and face
communicators (``set_*_communicator*`` / ``get_*_communicator*``, the
owners queries, ``print_communicator``) are staged per rank as in the JAX
class: ``nprocs`` / ``myrank`` name the rank, and a single-process run
checks the staged items for range and order; ``info.n_devices`` > 1 runs
the distributed pass, its shards spread over the ranks of the process
group when there is one (``parallel/multihost.init_multihost``): there
rank 0 holds the output, and every other rank ends its run after the
merge with none.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from .params import DParam, Info, IParam


def resolve_device(device) -> torch.device:
    """The torch device for an entry point; a CUDA request without a
    CUDA device raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"parmmg_tpu_torch runs on the CUDA device by default "
            f"(device={device!r}) but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: -device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _grow(a, n: int, width, dtype):
    shape = (n,) if width is None else (n, width)
    out = np.zeros(shape, dtype)
    if a is not None:
        k = min(len(a), n)
        out[:k] = a[:k]
    return out


class ParMesh:
    """Staged mesh + metric + parameters; :meth:`run` adapts it."""

    def __init__(self, device="cuda", nprocs: int = 1, myrank: int = 0):
        self.device = resolve_device(device)
        self.nprocs = nprocs
        self.myrank = myrank
        self.n_node_comm = 0
        self.n_face_comm = 0
        self.node_comms: list[dict] = []
        self.face_comms: list[dict] = []
        self.info = Info()
        self.np_ = self.ne_ = self.nt_ = self.na_ = 0
        self.nprism_ = self.nquad_ = 0
        self.vert = self.vref = self.vreq = self.vcrn = None
        self.vnormal = None
        self.tetra = self.tref = self.tetra_req = None
        self.tria = self.triaref = self.tria_req = None
        self.edge = self.edgeref = self.edge_ridge = self.edge_req = None
        self.prism = self.prism_ref = self.quad = self.quad_ref = None
        self.met = None
        self.met_type = 0
        self.fields: list[np.ndarray] = []
        self.field_types: list[int] = []
        self._out = None
        self._out_met = None
        self._out_stats = None
        # every rank's record of a several-process run, on rank 0
        # (driver._leave_group); None otherwise
        self.rank_records = None
        self._drop_out_caches()

    def _drop_out_caches(self) -> None:
        self._glonum = None
        self._out_vn = None
        self._out_ridge_nn = None
        self._out_vtag_cache = None
        self._out_host_cache = None
        self._out_edges_cache = None
        self._out_tria_cache = None
        self._out_ftag_cache = None

    # -- sizes and entities (1-based ids, like the reference API) ---------
    def set_mesh_size(self, np_: int, ne: int, nprism: int = 0, nt: int = 0,
                      nquad: int = 0, na: int = 0) -> None:
        self.np_, self.ne_, self.nt_, self.na_ = np_, ne, nt, na
        self.nprism_, self.nquad_ = nprism, nquad
        self.vert = _grow(self.vert, np_, 3, np.float64)
        self.vref = _grow(self.vref, np_, None, np.int32)
        self.vreq = _grow(self.vreq, np_, None, bool)
        self.vcrn = _grow(self.vcrn, np_, None, bool)
        self.tetra = _grow(self.tetra, ne, 4, np.int64)
        self.tref = _grow(self.tref, ne, None, np.int32)
        self.tetra_req = _grow(self.tetra_req, ne, None, bool)
        self.tria = _grow(self.tria, nt, 3, np.int64)
        self.triaref = _grow(self.triaref, nt, None, np.int32)
        self.tria_req = _grow(self.tria_req, nt, None, bool)
        self.edge = _grow(self.edge, na, 2, np.int64)
        self.edgeref = _grow(self.edgeref, na, None, np.int32)
        self.edge_ridge = _grow(self.edge_ridge, na, None, bool)
        self.edge_req = _grow(self.edge_req, na, None, bool)
        self.prism = _grow(self.prism, nprism, 6, np.int64)
        self.prism_ref = _grow(self.prism_ref, nprism, None, np.int32)
        self.quad = _grow(self.quad, nquad, 4, np.int64)
        self.quad_ref = _grow(self.quad_ref, nquad, None, np.int32)

    def get_mesh_size(self):
        """(np, ne, nprism, nt, nquad, na) of the current mesh: after
        run() the adapted output's, with its rebuilt feature-edge count."""
        if self._out is not None:
            vert, tet, _, _, _ = self._out_host()
            return len(vert), len(tet), self.nprism_, self._out_ntria(), \
                self.nquad_, len(self.get_edges()[0])
        return self.np_, self.ne_, self.nprism_, self.nt_, self.nquad_, \
            self.na_

    def set_vertex(self, x, y, z, ref: int, pos: int) -> None:
        self.vert[pos - 1] = (x, y, z)
        self.vref[pos - 1] = ref

    def set_tetrahedron(self, v0, v1, v2, v3, ref: int, pos: int) -> None:
        self.tetra[pos - 1] = (v0, v1, v2, v3)
        self.tref[pos - 1] = ref

    def set_triangle(self, v0, v1, v2, ref: int, pos: int) -> None:
        self.tria[pos - 1] = (v0, v1, v2)
        self.triaref[pos - 1] = ref

    def set_edge(self, v0, v1, ref: int, pos: int) -> None:
        self.edge[pos - 1] = (v0, v1)
        self.edgeref[pos - 1] = ref

    def set_prism(self, vs, ref: int, pos: int) -> None:
        self.prism[pos - 1] = vs
        self.prism_ref[pos - 1] = ref

    def set_quadrilateral(self, vs, ref: int, pos: int) -> None:
        self.quad[pos - 1] = vs
        self.quad_ref[pos - 1] = ref

    def set_required_tetrahedron(self, pos: int) -> None:
        self.tetra_req[pos - 1] = True

    def set_required_triangle(self, pos: int) -> None:
        self.tria_req[pos - 1] = True

    def set_required_edge(self, pos: int) -> None:
        self.edge_req[pos - 1] = True

    def set_normal_at_vertex(self, pos: int, nx, ny, nz) -> None:
        if self.vnormal is None:
            self.vnormal = np.zeros((self.np_, 3))
        self.vnormal[pos - 1] = (nx, ny, nz)

    def set_vertices(self, coords, refs=None) -> None:
        self.vert[:] = np.asarray(coords, np.float64).reshape(self.np_, 3)
        if refs is not None:
            self.vref[:] = np.asarray(refs, np.int32).reshape(self.np_)

    def set_tetrahedra(self, tets, refs=None) -> None:
        self.tetra[:] = np.asarray(tets, np.int64).reshape(self.ne_, 4)
        if refs is not None:
            self.tref[:] = np.asarray(refs, np.int32).reshape(self.ne_)

    def set_triangles(self, tris, refs=None) -> None:
        self.tria[:] = np.asarray(tris, np.int64).reshape(self.nt_, 3)
        if refs is not None:
            self.triaref[:] = np.asarray(refs, np.int32).reshape(self.nt_)

    def set_edges(self, edges, refs=None) -> None:
        self.edge[:] = np.asarray(edges, np.int64).reshape(self.na_, 2)
        if refs is not None:
            self.edgeref[:] = np.asarray(refs, np.int32).reshape(self.na_)

    def set_corner(self, pos: int) -> None:
        self.vcrn[pos - 1] = True

    def set_required_vertex(self, pos: int) -> None:
        self.vreq[pos - 1] = True

    def set_ridge(self, pos: int) -> None:
        self.edge_ridge[pos - 1] = True

    # -- metric and parameters -------------------------------------------
    def set_met_size(self, typ: int, np_: int) -> None:
        """typ: 1 = scalar, 3 = tensor (MMG5_Scalar / MMG5_Tensor)."""
        if np_ != self.np_:
            raise ValueError("metric size must match vertex count")
        if typ not in (1, 3):
            raise ValueError(f"metric type {typ}: expected 1 (scalar) or "
                             "3 (tensor)")
        self.met_type = typ
        self.met = _grow(None, np_, None if typ == 1 else 6, np.float64)

    def set_scalar_met(self, m: float, pos: int) -> None:
        self.met[pos - 1] = m

    def set_scalar_mets(self, m) -> None:
        self.met[:] = np.asarray(m, np.float64).reshape(self.np_)

    def set_tensor_met(self, m11, m12, m13, m22, m23, m33, pos: int) -> None:
        self.met[pos - 1] = (m11, m12, m13, m22, m23, m33)

    def set_tensor_mets(self, m) -> None:
        self.met[:] = np.asarray(m, np.float64).reshape(self.np_, 6)

    def set_sols_at_vertices_size(self, nsols: int, types) -> None:
        """Declare user fields at vertices: type 1 scalar, 2 vector (3
        components), 3 tensor (6)."""
        self.fields = []
        self.field_types = list(types)
        for t in types:
            self.fields.append(_grow(None, self.np_, {1: None, 2: 3, 3: 6}[t],
                                     np.float64))

    def set_ith_sol_in_sols_at_vertices(self, i: int, vals) -> None:
        f = self.fields[i - 1]
        self.fields[i - 1] = np.asarray(vals, np.float64).reshape(f.shape)

    def get_ith_sol_in_sols_at_vertices(self, i: int) -> np.ndarray:
        """The i-th field: the staged values before run(), the values at
        the output vertices (float32) after it."""
        return self.fields[i - 1]

    def set_local_parameter(self, typ: int, ref: int, hmin: float,
                            hmax: float, hausd: float) -> None:
        self.info.local_params.append(
            (int(typ), int(ref), float(hmin), float(hmax), float(hausd)))

    def set_iparameter(self, key: IParam, val: int) -> None:
        self.info.set_iparameter(key, val)

    def set_dparameter(self, key: DParam, val: float) -> None:
        self.info.set_dparameter(key, val)

    # -- run ---------------------------------------------------------------
    # ------------------------------------------------------------------
    # distributed-API communicators (libparmmg.h Set_ith*Communicator*)
    # ------------------------------------------------------------------
    def set_number_of_node_communicators(self, n: int) -> None:
        self.n_node_comm = n
        self.node_comms = [dict(color_out=-1, local=None, global_=None)
                           for _ in range(n)]

    def set_number_of_face_communicators(self, n: int) -> None:
        self.n_face_comm = n
        self.face_comms = [dict(color_out=-1, local=None, global_=None)
                           for _ in range(n)]

    def set_ith_node_communicator_size(self, i: int, color_out: int,
                                       nitem: int) -> None:
        c = self.node_comms[i]
        c["color_out"] = color_out
        c["local"] = np.zeros(nitem, np.int64)
        c["global_"] = np.zeros(nitem, np.int64)

    def set_ith_face_communicator_size(self, i: int, color_out: int,
                                       nitem: int) -> None:
        c = self.face_comms[i]
        c["color_out"] = color_out
        c["local"] = np.zeros(nitem, np.int64)
        c["global_"] = np.zeros(nitem, np.int64)

    def set_ith_node_communicator_nodes(self, i: int, local_ids, global_ids,
                                        is_not_ordered: bool = True) -> None:
        """Items must appear in the same order on both sides of a rank
        pair; with ``is_not_ordered`` they are sorted by global id (the
        ordering contract, reference API_functions_pmmg.c:1295-1330)."""
        c = self.node_comms[i]
        lo = np.asarray(local_ids, np.int64)
        gl = np.asarray(global_ids, np.int64)
        if is_not_ordered:
            o = np.argsort(gl, kind="stable")
            lo, gl = lo[o], gl[o]
        c["local"], c["global_"] = lo, gl

    def set_ith_face_communicator_faces(self, i: int, local_ids, global_ids,
                                        is_not_ordered: bool = True) -> None:
        c = self.face_comms[i]
        lo = np.asarray(local_ids, np.int64)
        gl = np.asarray(global_ids, np.int64)
        if is_not_ordered:
            o = np.argsort(gl, kind="stable")
            lo, gl = lo[o], gl[o]
        c["local"], c["global_"] = lo, gl

    def get_number_of_node_communicators(self) -> int:
        return self.n_node_comm

    def get_number_of_face_communicators(self) -> int:
        return self.n_face_comm

    def get_ith_node_communicator_size(self, i: int):
        c = self.node_comms[i]
        return c["color_out"], len(c["local"])

    def get_ith_face_communicator_size(self, i: int):
        c = self.face_comms[i]
        return c["color_out"], len(c["local"])

    def get_ith_node_communicator_nodes(self, i: int):
        return self.node_comms[i]["local"]

    def get_ith_face_communicator_faces(self, i: int):
        return self.face_comms[i]["local"]

    def check_set_node_communicators(self) -> bool:
        """Coordinate-based sanity check of the user comms
        (PMMG_Check_Set_NodeCommunicators, chkcomm oracle flavor).
        Single-process form: verify ids are in range and orderings are
        self-consistent (pairwise exchange happens in parallel/comms)."""
        for c in self.node_comms:
            if c["local"] is None:
                return False
            if (np.asarray(c["local"]) < 1).any() or \
                    (np.asarray(c["local"]) > self.np_).any():
                return False
        return True

    def check_set_face_communicators(self) -> bool:
        """Face-comm mirror of the check above
        (PMMG_Check_Set_FaceCommunicators, libparmmg.h:2279-2346 flavor):
        every item set, local triangle ids in range."""
        for c in self.face_comms:
            if c["local"] is None:
                return False
            lo = np.asarray(c["local"])
            ntri = self.nt_ if self.tria is None \
                else max(self.nt_, len(self.tria))
            if (lo < 1).any() or (lo > ntri).any():
                return False
        return True

    def get_node_communicator_owners(self):
        """Owner rank of each node-comm item + its global id
        (PMMG_Get_NodeCommunicator_owners semantics: owner = max rank
        touching the entity, libparmmg.c:962-973).  Returns
        (owners_per_comm, globals_per_comm, nunique, ntot)."""
        owners, globs = [], []
        ntot = 0
        seen = set()
        for c in self.node_comms:
            n = 0 if c["local"] is None else len(c["local"])
            own = np.full(n, max(self.myrank, int(c["color_out"])), np.int64)
            owners.append(own)
            g = (np.zeros(n, np.int64) if c["global_"] is None
                 else np.asarray(c["global_"], np.int64))
            globs.append(g)
            ntot += n
            seen.update(int(x) for x in g)
        return owners, globs, len(seen), ntot

    def get_face_communicator_owners(self):
        """Face-comm mirror of the owners query.  Interface faces are
        shared by exactly 2 ranks; owner = max of the pair."""
        owners, globs = [], []
        ntot = 0
        seen = set()
        for c in self.face_comms:
            n = 0 if c["local"] is None else len(c["local"])
            own = np.full(n, max(self.myrank, int(c["color_out"])), np.int64)
            owners.append(own)
            g = (np.zeros(n, np.int64) if c["global_"] is None
                 else np.asarray(c["global_"], np.int64))
            globs.append(g)
            ntot += n
            seen.update(int(x) for x in g)
        return owners, globs, len(seen), ntot

    def _build_core_mesh(self):
        """Staged arrays -> analysed core Mesh + metric on the device."""
        from ..core.mesh import make_mesh, replace
        from ..ops.analysis import analyze_mesh
        from ..utils.budget import plan_capacities

        if self.np_ == 0 or self.ne_ == 0:
            raise ValueError("mesh size not set")
        capP, capT = plan_capacities(self.np_, self.ne_,
                                     self.info.mem_budget_mb)
        mesh = make_mesh(self.vert, (self.tetra - 1).astype(np.int32),
                         vref=self.vref, tref=self.tref, capP=capP,
                         capT=capT, device=self.device)
        mesh = analyze_mesh(mesh, angedg=self.info.angedg()).mesh
        vtag = mesh.vtag.cpu().numpy().copy()
        vtag[: self.np_][self.vreq] |= C.MG_REQ
        vtag[: self.np_][self.vcrn] |= C.MG_CRN
        mesh = replace(mesh, vtag=torch.from_numpy(vtag).to(self.device))
        mesh = self._freeze_hybrid(mesh)
        if self.tetra_req is not None and self.tetra_req.any():
            # required tets: all their faces, edges and vertices get MG_REQ
            req = np.flatnonzero(self.tetra_req)
            ftag = mesh.ftag.cpu().numpy().copy()
            etag = mesh.etag.cpu().numpy().copy()
            vtag = mesh.vtag.cpu().numpy().copy()
            ftag[req] |= C.MG_REQ
            etag[req] |= C.MG_REQ
            vtag[mesh.tet.cpu().numpy()[req].reshape(-1)] |= C.MG_REQ
            mesh = replace(mesh, ftag=self._dev(ftag), etag=self._dev(etag),
                           vtag=self._dev(vtag))
        if self.nt_:
            mesh = self._apply_user_triangles(mesh)
        if self.na_:
            mesh = self._apply_user_edges(mesh)
            self.info._user_edges = (self.edge[: self.na_] - 1,
                                     self.edgeref[: self.na_])
        met = None
        if self.met is not None and self.met_type in (1, 3):
            # spare rows: size 1 / the identity tensor
            spare = 1.0 if self.met_type == 1 else \
                np.array([1, 0, 0, 1, 0, 1.0])
            m = np.empty((mesh.capP,) + self.met.shape[1:])
            m[: self.np_] = self.met
            m[self.np_:] = spare
            met = torch.from_numpy(m).to(self.device, torch.float32)
        return mesh, met

    def _freeze_hybrid(self, mesh):
        """Prism and quadrilateral vertices get MG_REQ, and so do the tet
        faces and edges whose vertices are all such vertices: a split
        there would hang a point on a pass-through element."""
        hybrid = np.concatenate([
            self.prism.reshape(-1) if self.nprism_ else np.zeros(0, np.int64),
            self.quad.reshape(-1) if self.nquad_ else np.zeros(0, np.int64)])
        if not len(hybrid):
            return mesh
        from ..core.mesh import replace
        hyb = np.zeros(mesh.capP, bool)
        hyb[(hybrid - 1).astype(np.int64)] = True
        vtag = mesh.vtag.cpu().numpy().copy()
        vtag[hyb] |= C.MG_REQ
        hv = hyb[np.clip(mesh.tet.cpu().numpy(), 0, mesh.capP - 1)] \
            & mesh.tmask.cpu().numpy()[:, None]
        ftag = mesh.ftag.cpu().numpy().copy()
        etag = mesh.etag.cpu().numpy().copy()
        for f in range(4):
            ftag[hv[:, C.IDIR[f]].all(axis=1), f] |= C.MG_REQ
        for e in range(6):
            etag[hv[:, C.IARE[e]].all(axis=1), e] |= C.MG_REQ
        return replace(mesh, vtag=self._dev(vtag), ftag=self._dev(ftag),
                       etag=self._dev(etag))

    def _dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _apply_user_triangles(self, mesh):
        """Match user boundary triangles to tet faces; transfer refs (open-boundary ingestion with ``info.opnbdy``)."""
        from ..core.mesh import replace, tet_face_vertices
        capT = mesh.capT
        keys = np.sort(tet_face_vertices(mesh.tet).cpu().numpy(),
                       axis=2).reshape(capT * 4, 3)
        tria = np.sort(self.tria - 1, axis=1)
        allk = np.concatenate([keys, tria])
        tag = np.concatenate([np.full(capT * 4, -1), np.arange(len(tria))])
        o = np.lexsort(allk.T[::-1])
        ks, ts = allk[o], tag[o]
        same_next = np.concatenate(
            [(ks[1:] == ks[:-1]).all(axis=1), [False]])
        head = np.concatenate([[True], ~same_next[:-1]])
        seg = np.cumsum(head) - 1
        nseg = seg[-1] + 1 if len(ks) else 0
        is_face = ts < 0
        tria_of = np.full(nseg, -1, np.int64)
        np.maximum.at(tria_of, seg[~is_face], ts[~is_face])
        nfaces = np.bincount(seg[is_face], minlength=nseg)
        ftag = mesh.ftag.cpu().numpy().copy().reshape(-1)
        fref = mesh.fref.cpu().numpy().copy().reshape(-1)
        face_rows = np.where(is_face)[0]
        fseg = seg[face_rows]
        hit = tria_of[fseg] >= 0
        tids = tria_of[fseg][hit]
        slots = o[face_rows[hit]]
        fref[slots] = self.triaref[tids]
        ftag[slots] |= np.where(self.tria_req[tids], C.MG_REQ, 0).astype(
            np.int32)
        if self.info.opnbdy:
            interior = nfaces[fseg][hit] == 2
            ftag[slots[interior]] |= C.MG_BDY | C.MG_OPNBDY
        return replace(mesh, ftag=self._dev(ftag.reshape(capT, 4)),
                       fref=self._dev(fref.reshape(capT, 4)))

    def _apply_user_edges(self, mesh):
        """Transfer user edge ridge / ref flags onto tet edges."""
        from ..core.mesh import replace, tet_edge_vertices
        capT = mesh.capT
        ev2 = np.sort(tet_edge_vertices(mesh.tet).cpu().numpy()
                      .reshape(capT * 6, 2), axis=1)
        ue = np.sort(self.edge - 1, axis=1)
        etag = mesh.etag.cpu().numpy().copy().reshape(-1)
        add = np.where(self.edge_ridge, C.MG_GEO, 0) | \
            np.where(self.edge_req, C.MG_REQ, 0) | \
            np.where(self.edgeref != 0, C.MG_REF, 0)
        key = ev2[:, 0].astype(np.int64) << 32 | ev2[:, 1]
        ukey = ue[:, 0].astype(np.int64) << 32 | ue[:, 1]
        o = np.argsort(ukey)
        pos = np.clip(np.searchsorted(ukey[o], key), 0, len(ukey) - 1)
        hit = ukey[o][pos] == key
        etag[hit] |= add[o][pos[hit]].astype(np.int32)
        return replace(mesh, etag=self._dev(etag.reshape(capT, 6)))

    def run(self) -> int:
        """The adaptation entry; returns PMMG_SUCCESS / LOWFAILURE /
        STRONGFAILURE.  On a rank other than 0 of a several-process
        distributed run the run ends after the merge: that rank leaves
        the group and holds no output."""
        from ..driver import parmmg_run
        from .params import InputError
        self.rank_records = None
        try:
            out, met, stats = parmmg_run(self)
        except InputError as e:
            if self.info.imprim >= C.PMMG_VERB_VERSION:
                print(f"  ## Error: {e}.")
            return C.PMMG_STRONGFAILURE
        self._out, self._out_met, self._out_stats = out, met, stats
        self._drop_out_caches()
        return stats.status

    # -- output getters ------------------------------------------------------
    def _out_host(self):
        from ..core.mesh import mesh_to_host
        if self._out is None:
            raise RuntimeError("run() first")
        if self._out_host_cache is None:
            self._out_host_cache = mesh_to_host(self._out)
        return self._out_host_cache

    def _out_ntria(self) -> int:
        m = self._out
        return int((((m.ftag & C.MG_BDY) != 0) & m.tmask[:, None]).sum())

    def get_vertices(self):
        vert, _, vref, _, _ = self._out_host()
        return vert, vref

    def get_tetrahedra(self):
        _, tet, _, tref, _ = self._out_host()
        return tet + 1, tref

    def get_vertex(self, pos: int):
        """(x, y, z, ref, isCorner, isRequired) of output vertex ``pos``."""
        vert, _, vref, _, vtag = self._out_host()
        t = int(vtag[pos - 1])
        return (*map(float, vert[pos - 1]), int(vref[pos - 1]),
                bool(t & C.MG_CRN), bool(t & C.MG_REQ))

    def get_tetrahedron(self, pos: int):
        """(v0..v3 1-based, ref, isRequired); required reads as all four
        faces MG_REQ, the mark ``set_required_tetrahedron`` leaves."""
        _, tet, _, tref, _ = self._out_host()
        if self._out_ftag_cache is None:
            m = self._out
            self._out_ftag_cache = m.ftag.cpu().numpy()[m.tmask.cpu().numpy()]
        req = bool((self._out_ftag_cache[pos - 1] & C.MG_REQ).all())
        return tuple(int(v) + 1 for v in tet[pos - 1]) + \
            (int(tref[pos - 1]), req)

    def get_triangle(self, pos: int):
        """(v0..v2 1-based, ref, isRequired) of an output boundary face."""
        tris, refs, req, _ = self._out_triangles()
        return tuple(int(v) for v in tris[pos - 1]) + \
            (int(refs[pos - 1]), bool(req[pos - 1]))

    def get_edge(self, pos: int):
        """(v0, v1 1-based, ref, isRidge, isRequired)."""
        e, r, rid, req = self.get_edges()
        return (int(e[pos - 1, 0]), int(e[pos - 1, 1]), int(r[pos - 1]),
                bool(rid[pos - 1]), bool(req[pos - 1]))

    def _input_vertex_remap(self):
        """Output 1-based id of each staged input vertex (meaningful for
        frozen vertices, such as those of prisms and quadrilaterals)."""
        if self._out is None:
            return None
        return np.cumsum(self._out.vmask.cpu().numpy())[: self.np_]

    def get_prisms(self):
        """Prisms, passed through untouched, renumbered to the output
        vertex ids after run()."""
        if self._out is not None and self.nprism_:
            return self._input_vertex_remap()[self.prism - 1], self.prism_ref
        return self.prism, self.prism_ref

    def get_quadrilaterals(self):
        if self._out is not None and self.nquad_:
            return self._input_vertex_remap()[self.quad - 1], self.quad_ref
        return self.quad, self.quad_ref

    def get_normals(self):
        """Unit outward normals at the output vertices [np, 3] (zero off
        the surface)."""
        if self._out_vn is None:
            from ..ops.analysis import analyze_mesh
            vn = analyze_mesh(self._out).vnormal
            self._out_vn = vn.cpu().numpy()[self._out.vmask.cpu().numpy()]
        return self._out_vn

    def get_normal_at_vertex(self, pos: int):
        """(nx, ny, nz) at output vertex ``pos``; at a ridge point the
        first side's normal (both: :meth:`get_ridge_normals_at_vertex`)."""
        if self._out_vtag_cache is None:
            self._out_vtag_cache = \
                self._out.vtag.cpu().numpy()[self._out.vmask.cpu().numpy()]
        t = int(self._out_vtag_cache[pos - 1])
        if (t & (C.MG_GEO | C.MG_REF)) and not (t & (C.MG_CRN | C.MG_NOM)):
            return self.get_ridge_normals_at_vertex(pos)[0]
        n = self.get_normals()[pos - 1]
        return float(n[0]), float(n[1]), float(n[2])

    def get_ridge_normals_at_vertex(self, pos: int):
        """Both per-side normals (n1, n2) at a ridge vertex; zeros at
        other points."""
        if self._out_ridge_nn is None:
            from ..ops.analysis import ridge_vertex_normals
            n1, n2 = ridge_vertex_normals(self._out)
            vm = self._out.vmask.cpu().numpy()
            self._out_ridge_nn = (n1.cpu().numpy()[vm], n2.cpu().numpy()[vm])
        n1, n2 = self._out_ridge_nn
        return (tuple(float(x) for x in n1[pos - 1]),
                tuple(float(x) for x in n2[pos - 1]))

    def get_scalar_met(self, pos: int) -> float:
        return float(self.get_metric()[pos - 1])

    def get_scalar_mets(self):
        return self.get_metric()

    def get_vertex_glonum(self, pos: int) -> int:
        if self._glonum is None:
            self._compute_glonum()
        return int(self._glonum[pos - 1])

    def get_vertices_glonum(self):
        if self._glonum is None:
            self._compute_glonum()
        return self._glonum

    def _compute_glonum(self):
        """Global vertex numbering of the output: the identity on one
        device."""
        vert = self._out_host()[0]
        self._glonum = np.arange(1, len(vert) + 1, dtype=np.int64)

    def get_triangle_glonum(self, pos: int) -> int:
        """Global id of an output boundary triangle: the identity on one
        device."""
        return pos

    def get_triangles_glonum(self):
        return np.arange(1, self._out_ntria() + 1, dtype=np.int64)

    def get_metric(self):
        """The output metric of the live vertices: [np] sizes or [np, 6]
        packed tensors."""
        if self._out_met is None:
            return None
        return self._out_met.cpu().numpy()[self._out.vmask.cpu().numpy()]

    def get_tensor_met(self, pos: int):
        return tuple(float(x) for x in self.get_metric()[pos - 1])

    def get_tensor_mets(self):
        return self.get_metric()

    def _out_triangles(self):
        """(tris 1-based, refs, isRequired, compacted tet id) of the output
        boundary faces."""
        if self._out_tria_cache is not None:
            return self._out_tria_cache
        from ..core.mesh import tet_face_vertices
        m = self._out
        new_id = np.cumsum(m.vmask.cpu().numpy()) - 1
        tm = m.tmask.cpu().numpy()
        tet_new = np.cumsum(tm) - 1
        fv = tet_face_vertices(m.tet).cpu().numpy()
        ftag = m.ftag.cpu().numpy()
        sel = ((ftag & C.MG_BDY) != 0) & tm[:, None]
        rows = np.nonzero(sel)[0]
        self._out_tria_cache = (new_id[fv[sel]] + 1,
                                m.fref.cpu().numpy()[sel],
                                (ftag[sel] & C.MG_REQ) != 0, tet_new[rows])
        return self._out_tria_cache

    def get_triangles(self):
        tris, refs, _, _ = self._out_triangles()
        return tris, refs

    def get_edges(self):
        """Feature edges (ridge / ref / required) of the output: (edges
        [na,2] 1-based, refs, isRidge, isRequired)."""
        if self._out_edges_cache is not None:
            return self._out_edges_cache
        from ..core.mesh import tet_edge_vertices
        m = self._out
        ev = tet_edge_vertices(m.tet).cpu().numpy().reshape(-1, 2)
        etag = m.etag.cpu().numpy().reshape(-1)
        live = np.repeat(m.tmask.cpu().numpy(), 6)
        feat = live & ((etag & (C.MG_GEO | C.MG_REQ | C.MG_REF)) != 0)
        e = np.sort(ev[feat], axis=1)
        tags = etag[feat]
        if len(e) == 0:
            self._out_edges_cache = (np.zeros((0, 2), np.int64),
                                     np.zeros(0, np.int32),
                                     np.zeros(0, bool), np.zeros(0, bool))
            return self._out_edges_cache
        key = e[:, 0].astype(np.int64) << 32 | e[:, 1]
        o = np.argsort(key, kind="stable")
        key, e, tags = key[o], e[o], tags[o]
        head = np.concatenate([[True], key[1:] != key[:-1]])
        seg = np.cumsum(head) - 1
        utags = np.zeros(int(head.sum()), np.int32)
        np.bitwise_or.at(utags, seg, tags)
        e = e[head]
        new_id = np.cumsum(m.vmask.cpu().numpy()) - 1
        refs = np.zeros(len(e), np.int32)
        if self.na_:
            orig = (e < self.np_).all(axis=1)
            ue = np.sort(self.edge - 1, axis=1)
            ukey = ue[:, 0].astype(np.int64) << 32 | ue[:, 1]
            ekey = e[:, 0].astype(np.int64) << 32 | e[:, 1]
            o = np.argsort(ukey)
            pos = np.clip(np.searchsorted(ukey[o], ekey), 0, len(ukey) - 1)
            hit = orig & (ukey[o][pos] == ekey)
            refs[hit] = self.edgeref[o][pos[hit]]
        self._out_edges_cache = (new_id[e] + 1, refs,
                                 (utags & C.MG_GEO) != 0,
                                 (utags & C.MG_REQ) != 0)
        return self._out_edges_cache

    def print_communicator(self, path: str) -> None:
        """PMMG_printCommunicator (libparmmg.h:2554): dump the staged
        node/face communicators to a text file for debugging."""
        with open(path, "w") as f:
            f.write(f"rank {self.myrank} / {self.nprocs}\n")
            f.write(f"node communicators: {self.n_node_comm}\n")
            for i, c in enumerate(self.node_comms):
                n = 0 if c["local"] is None else len(c["local"])
                f.write(f"  comm {i}: color_out {c['color_out']} "
                        f"nitem {n}\n")
                if n:
                    for lo, gl in zip(c["local"], c["global_"]):
                        f.write(f"    {int(lo)} {int(gl)}\n")
            f.write(f"face communicators: {self.n_face_comm}\n")
            for i, c in enumerate(self.face_comms):
                n = 0 if c["local"] is None else len(c["local"])
                f.write(f"  comm {i}: color_out {c['color_out']} "
                        f"nitem {n}\n")
                if n:
                    for lo, gl in zip(c["local"], c["global_"]):
                        f.write(f"    {int(lo)} {int(gl)}\n")

    @property
    def stats(self):
        return self._out_stats
