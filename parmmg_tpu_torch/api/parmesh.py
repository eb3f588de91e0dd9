"""ParMesh: the public mesh-adaptation object (port of ``api/parmesh.py``).

The set/get surface the CLI and the README example use: numpy staging
arrays in, one flat torch Mesh adapted on ``device`` (``"cuda"`` unless the
caller asks for ``"cpu"``), numpy arrays out.  The metric is a scalar size
per vertex or a packed symmetric tensor (m11, m12, m13, m22, m23, m33).
Distributed communicators, user fields and prisms/quads belong to later
slices.
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

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.info = Info()
        self.np_ = self.ne_ = self.nt_ = self.na_ = 0
        self.vert = self.vref = self.vreq = self.vcrn = None
        self.tetra = self.tref = None
        self.tria = self.triaref = None
        self.edge = self.edgeref = self.edge_ridge = None
        self.met = None
        self.met_type = 0
        self._out = None
        self._out_met = None
        self._out_stats = None
        self._out_host_cache = None
        self._out_edges_cache = None
        self._out_tria_cache = None

    # -- sizes and entities (1-based ids, like the reference API) ---------
    def set_mesh_size(self, np_: int, ne: int, nprism: int = 0, nt: int = 0,
                      nquad: int = 0, na: int = 0) -> None:
        if nprism or nquad:
            raise NotImplementedError(
                "prisms / quadrilaterals are not yet ported to "
                "parmmg_tpu_torch")
        self.np_, self.ne_, self.nt_, self.na_ = np_, ne, nt, na
        self.vert = _grow(self.vert, np_, 3, np.float64)
        self.vref = _grow(self.vref, np_, None, np.int32)
        self.vreq = _grow(self.vreq, np_, None, bool)
        self.vcrn = _grow(self.vcrn, np_, None, bool)
        self.tetra = _grow(self.tetra, ne, 4, np.int64)
        self.tref = _grow(self.tref, ne, None, np.int32)
        self.tria = _grow(self.tria, nt, 3, np.int64)
        self.triaref = _grow(self.triaref, nt, None, np.int32)
        self.edge = _grow(self.edge, na, 2, np.int64)
        self.edgeref = _grow(self.edgeref, na, None, np.int32)
        self.edge_ridge = _grow(self.edge_ridge, na, None, bool)

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

    def set_scalar_mets(self, m) -> None:
        self.met[:] = np.asarray(m, np.float64).reshape(self.np_)

    def set_tensor_met(self, m11, m12, m13, m22, m23, m33, pos: int) -> None:
        self.met[pos - 1] = (m11, m12, m13, m22, m23, m33)

    def set_tensor_mets(self, m) -> None:
        self.met[:] = np.asarray(m, np.float64).reshape(self.np_, 6)

    def set_local_parameter(self, typ: int, ref: int, hmin: float,
                            hmax: float, hausd: float) -> None:
        self.info.local_params.append(
            (int(typ), int(ref), float(hmin), float(hmax), float(hausd)))

    def set_iparameter(self, key: IParam, val: int) -> None:
        self.info.set_iparameter(key, val)

    def set_dparameter(self, key: DParam, val: float) -> None:
        self.info.set_dparameter(key, val)

    # -- run ---------------------------------------------------------------
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
        STRONGFAILURE."""
        from ..driver import parmmg_run
        from .params import InputError
        try:
            out, met, stats = parmmg_run(self)
        except InputError as e:
            if self.info.imprim >= C.PMMG_VERB_VERSION:
                print(f"  ## Error: {e}.")
            return C.PMMG_STRONGFAILURE
        self._out, self._out_met, self._out_stats = out, met, stats
        self._out_host_cache = None
        self._out_edges_cache = None
        self._out_tria_cache = None
        return stats.status

    # -- output getters ------------------------------------------------------
    def _out_host(self):
        from ..core.mesh import mesh_to_host
        if self._out is None:
            raise RuntimeError("run() first")
        if self._out_host_cache is None:
            self._out_host_cache = mesh_to_host(self._out)
        return self._out_host_cache

    def get_vertices(self):
        vert, _, vref, _, _ = self._out_host()
        return vert, vref

    def get_tetrahedra(self):
        _, tet, _, tref, _ = self._out_host()
        return tet + 1, tref

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

    @property
    def stats(self):
        return self._out_stats
