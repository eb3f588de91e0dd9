"""Tet-tet adjacency and boundary detection by face sort (port of
``ops/adjacency.py``): all 4*capT faces become sorted vertex triples,
twins are neighbours in sorted order.  The face sort and the twin compare
run on the sort engine (K7 ``radix_sort``, K8 ``segment_flags``), as the
JAX package runs them on the TPU."""
from __future__ import annotations

import torch

from ..core.constants import FACE_EDGES, IDIR, INT32_MAX, MG_BDY
from ..core.mesh import Mesh, replace, tet_face_vertices
from . import kernels
from .edges import PACK_LIMIT
from .primitives import reduce_drop


def _face_keys(mesh: Mesh):
    """Sorted-triple face keys [F,3] int32 (invalid tets INT32_MAX)."""
    capT = mesh.capT
    fv = tet_face_vertices(mesh.tet).reshape(capT * 4, 3)
    fv = torch.sort(fv, dim=1).values
    invalid = ~mesh.tmask.repeat_interleave(4)
    return torch.where(invalid[:, None], torch.full_like(fv, INT32_MAX), fv)


def face_sort(mesh: Mesh):
    """Sorted-order face records ``(t, f, partner, matched, valid_s)``:
    per sorted slot the tet, its local face, the sorted index of the twin
    (self if unmatched), whether a twin exists, whether the tet is live.
    Shared by ``build_adjacency`` and swap23's face-sort pairing."""
    cols = _face_keys(mesh)
    c0 = cols[:, 0].contiguous()
    if mesh.capP <= PACK_LIMIT:
        # two minor vertices packed into one word; the major vertex id is
        # below capP <= PACK_LIMIT < 2^16, so it sorts in 2 digit passes
        w = torch.where(c0 == INT32_MAX, torch.full_like(c0, INT32_MAX),
                        cols[:, 1] * mesh.capP + cols[:, 2])
        words, nbits = (c0, w), (16, 32)
    else:
        words, nbits = (c0, cols[:, 1].contiguous(),
                        cols[:, 2].contiguous()), None
    order = kernels.radix_sort(words, nbits=nbits)
    # K8 gathers the sorted keys and flags them in one launch
    keys, first = kernels.segment_flags(words, order=order)
    return face_records_from_sorted(mesh, order, *keys, first=first)


def face_records_from_sorted(mesh: Mesh, order, *keys, first):
    """``face_sort``'s records from a precomputed face sort: ``order`` the
    stable permutation of the 4*capT face slots (tet-major), ``keys`` the
    ascending key columns (major first), ``first`` their segment flags."""
    order = order.to(torch.int32)
    t = torch.div(order, 4, rounding_mode="floor")
    f = order % 4
    return _pair_records(mesh.capT, keys, t, f, first)


def _pair_records(capT: int, keys, t, f, first):
    """Twin pairing over sorted face keys: matched twins are adjacent."""
    eq_next = ~first[1:] & (keys[0][:-1] != INT32_MAX)
    false1 = torch.zeros(1, dtype=torch.bool, device=t.device)
    same_next = torch.cat([eq_next, false1])
    same_prev = torch.cat([false1, eq_next])
    idx = torch.arange(capT * 4, dtype=torch.int32, device=t.device)
    partner = torch.where(same_next, idx + 1,
                          torch.where(same_prev, idx - 1, idx))
    matched = same_next | same_prev
    valid_s = keys[0] != INT32_MAX
    return t, f, partner, matched, valid_s


def bdy_tags_from_sort(mesh: Mesh, t, f, matched, valid_s) -> Mesh:
    """``build_adjacency``'s MG_BDY face tagging straight off the face
    sort records: a live unmatched slot is a boundary face."""
    hit = torch.zeros((mesh.capT, 4), dtype=torch.bool, device=mesh.device)
    hit[t.long(), f.long()] = valid_s & ~matched   # (t, f) is a permutation
    return replace(mesh, ftag=torch.where(hit, mesh.ftag | MG_BDY, mesh.ftag))


def build_adjacency(mesh: Mesh, set_bdy_tags: bool = True) -> Mesh:
    """``adja[t,f] = 4*t' + f'`` for every matched face, -1 otherwise;
    unmatched faces of live tets get MG_BDY unless ``set_bdy_tags`` is
    False: on an active sub-mesh (``ops/active.py``) a face whose twin
    lies outside is unmatched without being boundary."""
    t, f, partner, matched, _ = face_sort(mesh)
    return adjacency_from_records(mesh, t, f, partner, matched,
                                  set_bdy_tags=set_bdy_tags)


def adjacency_from_records(mesh: Mesh, t, f, partner, matched,
                           set_bdy_tags: bool = True) -> Mesh:
    """``build_adjacency``'s scatter epilogue from face-sort records."""
    p = partner.long()
    adj_val = torch.where(matched, 4 * t[p] + f[p], torch.full_like(t, -1))
    adja = torch.full((mesh.capT, 4), -1, dtype=torch.int32,
                      device=mesh.device)
    adja[t.long(), f.long()] = adj_val          # (t, f) is a permutation
    adja = torch.where(mesh.tmask[:, None], adja, torch.full_like(adja, -1))
    if not set_bdy_tags:
        return replace(mesh, adja=adja)
    is_bdy = (adja < 0) & mesh.tmask[:, None]
    ftag = torch.where(is_bdy, mesh.ftag | MG_BDY, mesh.ftag)
    return replace(mesh, adja=adja, ftag=ftag)


def check_adjacency(mesh: Mesh) -> dict:
    """Invariant oracle: symmetric adja and matching shared faces."""
    adja = mesh.adja
    nb = (adja >> 2).clamp(0, mesh.capT - 1).long()
    nf = (adja & 3).long()
    valid = adja >= 0
    back = torch.where(valid, adja[nb, nf], torch.full_like(adja, -1))
    tid = torch.arange(mesh.capT, dtype=torch.int32,
                       device=mesh.device)[:, None]
    fid = torch.arange(4, dtype=torch.int32, device=mesh.device)[None, :]
    sym_bad = (valid & (back != 4 * tid + fid)).sum()
    fv = torch.sort(tet_face_vertices(mesh.tet), dim=2).values
    nbv = fv[nb, nf]
    face_bad = (valid[..., None] & (fv != nbv)).sum()
    return {"asymmetric": int(sym_bad), "face_mismatch": int(face_bad)}


def boundary_edge_tags(mesh: Mesh) -> Mesh:
    """Propagate MG_BDY from boundary faces to their edges and vertices."""
    is_bdy_face = (mesh.ftag & MG_BDY) != 0                    # [T,4]
    edge_hit = torch.zeros((mesh.capT, 6), dtype=torch.bool,
                           device=mesh.device)
    for f in range(4):
        for j in range(3):
            e = int(FACE_EDGES[f, j])
            edge_hit[:, e] |= is_bdy_face[:, f]
    etag = torch.where(edge_hit, mesh.etag | MG_BDY, mesh.etag)
    capP = mesh.capP
    vids_all = torch.cat([mesh.tet[:, IDIR[f].tolist()].reshape(-1)
                          for f in range(4)])
    m_all = torch.cat([(is_bdy_face[:, f] & mesh.tmask).repeat_interleave(3)
                       for f in range(4)])
    hit = reduce_drop(torch.zeros(capP + 1, dtype=torch.bool,
                                  device=mesh.device),
                      torch.where(m_all, vids_all,
                                  torch.full_like(vids_all, capP)),
                      m_all, "amax")
    vtag = torch.where(hit[:capP], mesh.vtag | MG_BDY, mesh.vtag)
    return replace(mesh, etag=etag, vtag=vtag)
