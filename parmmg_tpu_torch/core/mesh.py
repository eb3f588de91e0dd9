"""Flat, masked, fixed-capacity mesh tensors (port of ``core/mesh.py``).

Same layout as the JAX package: static capacity, per-slot validity masks,
dense per-face / per-edge tag arrays, ``adja = 4*neighbour + face`` or -1.
Tags are int32 (torch's uint32 lacks shifts and most CPU ops); the bit
patterns equal the JAX package's uint32 tags because every tag bit is
below bit 31.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constants import IARE, IDIR


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A tetrahedral mesh in fixed-capacity tensors on one device."""
    vert: torch.Tensor   # [capP, 3] float32
    vref: torch.Tensor   # [capP] int32
    vtag: torch.Tensor   # [capP] int32 MG_* bits
    vmask: torch.Tensor  # [capP] bool
    tet: torch.Tensor    # [capT, 4] int32
    tref: torch.Tensor   # [capT] int32
    tmask: torch.Tensor  # [capT] bool
    adja: torch.Tensor   # [capT, 4] int32
    ftag: torch.Tensor   # [capT, 4] int32
    fref: torch.Tensor   # [capT, 4] int32
    etag: torch.Tensor   # [capT, 6] int32
    npoin: torch.Tensor  # 0-d int32 used-prefix hint
    nelem: torch.Tensor  # 0-d int32 used-prefix hint

    @property
    def capP(self) -> int:
        return self.vert.shape[0]

    @property
    def capT(self) -> int:
        return self.tet.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vert.device

    def np_counts(self):
        """(#valid points, #valid tets) as Python ints (host sync)."""
        return int(self.vmask.sum()), int(self.tmask.sum())


MESH_FIELDS = tuple(f.name for f in dataclasses.fields(Mesh))
_TAG_FIELDS = ("vtag", "ftag", "etag")


def replace(mesh: Mesh, **kw) -> Mesh:
    return dataclasses.replace(mesh, **kw)


def make_mesh(vert, tet, vref=None, tref=None, capP: int | None = None,
              capT: int | None = None, device="cpu") -> Mesh:
    """Build a Mesh from host arrays, padded to the given capacities."""
    vert = np.asarray(vert, dtype=np.float64)
    tet = np.asarray(tet, dtype=np.int32)
    n_p, n_t = vert.shape[0], tet.shape[0]
    if capP is None:
        capP = max(64, int(3 * n_p))
    if capT is None:
        capT = max(64, int(3 * n_t))
    if capP < n_p or capT < n_t:
        raise ValueError("capacity smaller than input mesh")
    if n_t and tet.max() >= n_p:
        raise ValueError("tet references nonexistent vertex")

    def pad(a, cap, fill=0):
        out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
        out[: a.shape[0]] = a
        return torch.from_numpy(out).to(device)

    vref = np.zeros(n_p, np.int32) if vref is None \
        else np.asarray(vref, np.int32)
    tref = np.zeros(n_t, np.int32) if tref is None \
        else np.asarray(tref, np.int32)
    i32 = dict(dtype=torch.int32, device=device)
    return Mesh(
        vert=pad(vert, capP).to(torch.float32),
        vref=pad(vref, capP),
        vtag=torch.zeros(capP, **i32),
        vmask=pad(np.ones(n_p, bool), capP, False),
        tet=pad(tet, capT),
        tref=pad(tref, capT),
        tmask=pad(np.ones(n_t, bool), capT, False),
        adja=torch.full((capT, 4), -1, **i32),
        ftag=torch.zeros((capT, 4), **i32),
        fref=torch.zeros((capT, 4), **i32),
        etag=torch.zeros((capT, 6), **i32),
        npoin=torch.tensor(n_p, **i32),
        nelem=torch.tensor(n_t, **i32),
    )


def mesh_from_numpy(fields: dict, device="cpu") -> Mesh:
    """Mesh from numpy arrays named as the Mesh fields (e.g. the JAX
    package's ``np.asarray(getattr(jax_mesh, f))``).  uint32 tags become
    the same int32 bit patterns; the round trip with
    :func:`mesh_to_numpy` is exact."""
    out = {}
    for f in MESH_FIELDS:
        a = np.asarray(fields[f])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[f] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return Mesh(**out)


def mesh_to_numpy(mesh: Mesh) -> dict:
    """Inverse of :func:`mesh_from_numpy`: tags come back as uint32, as
    the JAX package stores them."""
    out = {}
    for f in MESH_FIELDS:
        a = getattr(mesh, f).cpu().numpy()
        out[f] = a.view(np.uint32) if f in _TAG_FIELDS else a
    return out


def mesh_to_host(mesh: Mesh):
    """Compacted (vert, tet, vref, tref, vtag) numpy arrays, vertices
    renumbered densely."""
    vmask = mesh.vmask.cpu().numpy()
    tmask = mesh.tmask.cpu().numpy()
    vert = mesh.vert.cpu().numpy()[vmask]
    vref = mesh.vref.cpu().numpy()[vmask]
    vtag = mesh.vtag.cpu().numpy()[vmask]
    new_id = np.cumsum(vmask) - 1
    tet = new_id[mesh.tet.cpu().numpy()[tmask]].astype(np.int32)
    tref = mesh.tref.cpu().numpy()[tmask]
    return vert, tet.reshape(-1, 4), vref, tref, vtag


_IDIR_CACHE: dict = {}


def _table(tab: np.ndarray, device) -> torch.Tensor:
    key = (id(tab), str(device))
    t = _IDIR_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(tab).to(device)
        _IDIR_CACHE[key] = t
    return t


def tet_face_vertices(tet: torch.Tensor) -> torch.Tensor:
    """[capT, 4, 3] vertex ids of each face (face f opposite vertex f)."""
    return tet[:, _table(IDIR, tet.device)]


def tet_edge_vertices(tet: torch.Tensor) -> torch.Tensor:
    """[capT, 6, 2] vertex ids of each tet edge."""
    return tet[:, _table(IARE, tet.device)]


def tet_volumes(mesh: Mesh) -> torch.Tensor:
    """Signed volume of every tet slot (garbage where tmask is False)."""
    p = mesh.vert[mesh.tet.long()]
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    d3 = p[:, 3] - p[:, 0]
    return (d1 * torch.linalg.cross(d2, d3, dim=-1)).sum(-1) / 6.0


def compact(mesh: Mesh) -> Mesh:
    """Move valid slots to the front (order kept) and renumber."""
    capP, capT = mesh.capP, mesh.capT
    vperm = torch.sort((~mesh.vmask).to(torch.uint8), stable=True).indices
    tperm = torch.sort((~mesh.tmask).to(torch.uint8), stable=True).indices
    dev = mesh.device
    old2new = torch.empty(capP, dtype=torch.int32, device=dev)
    old2new[vperm] = torch.arange(capP, dtype=torch.int32, device=dev)
    tet = old2new[mesh.tet[tperm].long()]
    t_old2new = torch.empty(capT, dtype=torch.int32, device=dev)
    t_old2new[tperm] = torch.arange(capT, dtype=torch.int32, device=dev)
    adja = mesh.adja[tperm]
    nb = (adja >> 2).clamp(0, capT - 1).long()
    adja = torch.where(adja >= 0, 4 * t_old2new[nb] + (adja & 3),
                       torch.full_like(adja, -1))
    n_p, n_t = mesh.np_counts()
    i32 = dict(dtype=torch.int32, device=dev)
    return Mesh(
        vert=mesh.vert[vperm], vref=mesh.vref[vperm],
        vtag=mesh.vtag[vperm], vmask=mesh.vmask[vperm],
        tet=tet, tref=mesh.tref[tperm], tmask=mesh.tmask[tperm],
        adja=adja, ftag=mesh.ftag[tperm], fref=mesh.fref[tperm],
        etag=mesh.etag[tperm],
        npoin=torch.tensor(n_p, **i32), nelem=torch.tensor(n_t, **i32))


def with_capacity(mesh: Mesh, capP: int, capT: int) -> Mesh:
    """Grow (never below the live content) the capacities."""
    mesh = compact(mesh)
    n_p, n_t = mesh.np_counts()
    if capP < n_p or capT < n_t:
        raise ValueError("cannot shrink below live content")

    def grow(a, cap, fill=0):
        out = torch.full((cap,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                         device=a.device)
        k = min(a.shape[0], cap)
        out[:k] = a[:k]
        return out

    return Mesh(
        vert=grow(mesh.vert, capP), vref=grow(mesh.vref, capP),
        vtag=grow(mesh.vtag, capP), vmask=grow(mesh.vmask, capP, False),
        tet=grow(mesh.tet, capT), tref=grow(mesh.tref, capT),
        tmask=grow(mesh.tmask, capT, False),
        adja=grow(mesh.adja, capT, -1),
        ftag=grow(mesh.ftag, capT), fref=grow(mesh.fref, capT),
        etag=grow(mesh.etag, capT),
        npoin=mesh.npoin, nelem=mesh.nelem)


@dataclasses.dataclass(frozen=True)
class MeshStack:
    """Meshes of one capacity stacked on a leading group axis: the fields
    of :class:`Mesh`, each with a leading [G] dimension (``npoin`` and
    ``nelem`` are [G]).  The stacked layout of the JAX package's grouped
    paths (a ``Mesh`` pytree with a leading axis), as its own type so that
    no code reads a :class:`Mesh` capacity off the group axis.  The
    tensors may lie on the card or, between a chunked pipeline's
    dispatches, on the host."""
    vert: torch.Tensor   # [G, capP, 3] float32
    vref: torch.Tensor   # [G, capP] int32
    vtag: torch.Tensor   # [G, capP] int32
    vmask: torch.Tensor  # [G, capP] bool
    tet: torch.Tensor    # [G, capT, 4] int32
    tref: torch.Tensor   # [G, capT] int32
    tmask: torch.Tensor  # [G, capT] bool
    adja: torch.Tensor   # [G, capT, 4] int32
    ftag: torch.Tensor   # [G, capT, 4] int32
    fref: torch.Tensor   # [G, capT, 4] int32
    etag: torch.Tensor   # [G, capT, 6] int32
    npoin: torch.Tensor  # [G] int32
    nelem: torch.Tensor  # [G] int32

    @property
    def ngroups(self) -> int:
        return self.vert.shape[0]

    @property
    def capP(self) -> int:
        return self.vert.shape[1]

    @property
    def capT(self) -> int:
        return self.tet.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vert.device

    def slot(self, g: int) -> Mesh:
        """Group ``g`` as a :class:`Mesh` of views into the stack."""
        return Mesh(**{f: getattr(self, f)[g] for f in MESH_FIELDS})

    def map(self, fn) -> "MeshStack":
        """A stack of ``fn(field)`` for every field tensor."""
        return MeshStack(**{f: fn(getattr(self, f)) for f in MESH_FIELDS})

    @staticmethod
    def stack(meshes) -> "MeshStack":
        """Stack meshes of one capacity along a new group axis."""
        return MeshStack(**{f: torch.stack([getattr(m, f) for m in meshes])
                            for f in MESH_FIELDS})
