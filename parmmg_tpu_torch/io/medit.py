"""Medit .mesh/.meshb and .sol/.solb reader/writer.

The port's own copy of ``parmmg_tpu/io/medit.py``.  An ASCII file with
only Vertices, Tetrahedra and Triangles goes through meshkit's scanner
(``native.scan_medit``, built with g++) where a compiler exists; other
files, and every file where none does, take the Python tokenizer.

Covers the format surface the reference handles through Mmg's I/O plus the
ParMmg distributed extensions (ParMmg src/inout_pmmg.c):
- ASCII ``.mesh`` with Vertices/Tetrahedra/Triangles/Edges/Corners/
  RequiredVertices/Ridges/RequiredTriangles sections;
- binary ``.meshb`` (GMF format: int code table, little/big endian);
- ``.sol``/``.solb`` metric & field files (scalar / vector / sym tensor);
- the distributed extensions ``ParallelTriangleCommunicators`` /
  ``ParallelVertexCommunicators`` and rank-decorated filenames
  ``name.<rank>.mesh`` (inout_pmmg.c:74-486) live in ``io/distributed.py``.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# GMF keyword codes (libmeshb v7) — subset we support
_KW = {
    "MeshVersionFormatted": 1,
    "Dimension": 3,
    "Vertices": 4,
    "Edges": 5,
    "Triangles": 6,
    "Quadrilaterals": 7,
    "Tetrahedra": 8,
    "Corners": 13,
    "RequiredVertices": 15,
    "Ridges": 14,
    "RequiredEdges": 16,
    "RequiredTriangles": 17,
    "Normals": 60,
    "SolAtVertices": 62,
    "End": 54,
}
_KW_INV = {v: k for k, v in _KW.items()}

SOL_SCALAR = 1
SOL_VECTOR = 2
SOL_TENSOR = 3
_SOL_NCOMP = {SOL_SCALAR: 1, SOL_VECTOR: 3, SOL_TENSOR: 6}


class MeditMesh:
    """Host-side container for everything a Medit file can carry."""

    def __init__(self):
        self.vert = np.zeros((0, 3), np.float64)
        self.vref = np.zeros(0, np.int32)
        self.tetra = np.zeros((0, 4), np.int32)   # 0-based
        self.tref = np.zeros(0, np.int32)
        self.tria = np.zeros((0, 3), np.int32)
        self.triaref = np.zeros(0, np.int32)
        self.edges = np.zeros((0, 2), np.int32)
        self.edgeref = np.zeros(0, np.int32)
        self.corners = np.zeros(0, np.int32)
        self.required_vert = np.zeros(0, np.int32)
        self.ridges = np.zeros(0, np.int32)       # edge indices (into edges)
        self.required_tria = np.zeros(0, np.int32)
        self.required_edges = np.zeros(0, np.int32)


# sections the native scanner does not read: a file naming any of them
# takes the Python tokenizer (the JAX package's test, io/medit.py:69-82)
_NOT_SIMPLE = (b"Edges", b"Corners", b"Required", b"Ridges", b"Parallel",
               b"Normals")


def read_mesh(path: str | Path) -> MeditMesh:
    path = Path(path)
    if path.suffix == ".meshb":
        return _read_meshb(path)
    from .. import native
    if native.available():
        data = path.read_bytes()
        got = None if any(k in data for k in _NOT_SIMPLE) else \
            native.scan_medit(data)
        if got is not None:
            m = MeditMesh()
            m.vert, m.vref = got["vert"], got["vref"]
            m.tetra, m.tref = got["tet"], got["tref"]
            m.tria, m.triaref = got["tria"], got["triaref"]
            return m
    return _read_mesh_ascii(path)


def _tokens(path: Path):
    with open(path) as f:
        for line in f:
            line = line.split("#")[0]
            yield from line.split()


def _read_mesh_ascii(path: Path) -> MeditMesh:
    m = MeditMesh()
    it = _tokens(path)
    tok = next(it, None)
    while tok is not None:
        kw = tok
        if kw == "End":
            break
        if kw in ("MeshVersionFormatted", "Dimension"):
            next(it)
        elif kw == "Vertices":
            n = int(next(it))
            dat = np.fromiter((next(it) for _ in range(4 * n)), float,
                              count=4 * n).reshape(n, 4)
            m.vert = dat[:, :3]
            m.vref = dat[:, 3].astype(np.int32)
        elif kw == "Tetrahedra":
            n = int(next(it))
            dat = np.fromiter((next(it) for _ in range(5 * n)), float,
                              count=5 * n).reshape(n, 5).astype(np.int64)
            m.tetra = (dat[:, :4] - 1).astype(np.int32)
            m.tref = dat[:, 4].astype(np.int32)
        elif kw == "Triangles":
            n = int(next(it))
            dat = np.fromiter((next(it) for _ in range(4 * n)), float,
                              count=4 * n).reshape(n, 4).astype(np.int64)
            m.tria = (dat[:, :3] - 1).astype(np.int32)
            m.triaref = dat[:, 3].astype(np.int32)
        elif kw == "Edges":
            n = int(next(it))
            dat = np.fromiter((next(it) for _ in range(3 * n)), float,
                              count=3 * n).reshape(n, 3).astype(np.int64)
            m.edges = (dat[:, :2] - 1).astype(np.int32)
            m.edgeref = dat[:, 2].astype(np.int32)
        elif kw == "Corners":
            n = int(next(it))
            m.corners = np.fromiter((next(it) for _ in range(n)), float,
                                    count=n).astype(np.int64).astype(np.int32) - 1
        elif kw == "RequiredVertices":
            n = int(next(it))
            m.required_vert = np.fromiter((next(it) for _ in range(n)), float,
                                          count=n).astype(np.int64).astype(np.int32) - 1
        elif kw == "Ridges":
            n = int(next(it))
            m.ridges = np.fromiter((next(it) for _ in range(n)), float,
                                   count=n).astype(np.int64).astype(np.int32) - 1
        elif kw == "RequiredEdges":
            n = int(next(it))
            m.required_edges = np.fromiter((next(it) for _ in range(n)), float,
                                           count=n).astype(np.int64).astype(np.int32) - 1
        elif kw == "RequiredTriangles":
            n = int(next(it))
            m.required_tria = np.fromiter((next(it) for _ in range(n)), float,
                                          count=n).astype(np.int64).astype(np.int32) - 1
        elif kw in ("ParallelTriangleCommunicators",
                    "ParallelVertexCommunicators"):
            # distributed extensions: consumed by io.distributed, which
            # re-reads the file; here skip the whole section
            ncomm = int(next(it))
            nit_tot = 0
            for _ in range(ncomm):
                next(it)                    # color
                nit_tot += int(next(it))    # nitem
            for _ in range(2 * nit_tot):
                next(it)
        else:
            # unknown section: assume "n" then n lines we cannot size — bail
            raise ValueError(f"unsupported Medit keyword: {kw}")
        tok = next(it, None)
    return m


def write_mesh(path: str | Path, m: MeditMesh) -> None:
    path = Path(path)
    if path.suffix == ".meshb":
        _write_meshb(path, m)
        return
    with open(path, "w") as f:
        f.write("MeshVersionFormatted 2\n\nDimension 3\n\n")
        f.write(f"Vertices\n{len(m.vert)}\n")
        for p, r in zip(m.vert, m.vref):
            f.write(f"{p[0]:.15g} {p[1]:.15g} {p[2]:.15g} {int(r)}\n")
        if len(m.tetra):
            f.write(f"\nTetrahedra\n{len(m.tetra)}\n")
            for t, r in zip(m.tetra + 1, m.tref):
                f.write(f"{t[0]} {t[1]} {t[2]} {t[3]} {int(r)}\n")
        if len(m.tria):
            f.write(f"\nTriangles\n{len(m.tria)}\n")
            for t, r in zip(m.tria + 1, m.triaref):
                f.write(f"{t[0]} {t[1]} {t[2]} {int(r)}\n")
        if len(m.edges):
            f.write(f"\nEdges\n{len(m.edges)}\n")
            for e, r in zip(m.edges + 1, m.edgeref):
                f.write(f"{e[0]} {e[1]} {int(r)}\n")
        for name, arr in [("Corners", m.corners),
                          ("RequiredVertices", m.required_vert),
                          ("Ridges", m.ridges),
                          ("RequiredEdges", m.required_edges),
                          ("RequiredTriangles", m.required_tria)]:
            if len(arr):
                f.write(f"\n{name}\n{len(arr)}\n")
                f.write("\n".join(str(int(i) + 1) for i in arr) + "\n")
        f.write("\nEnd\n")


# ---------------------------------------------------------------------------
# Binary GMF (.meshb) — version 2 (int32 positions) or 3 (int64), dim 3
# ---------------------------------------------------------------------------
def _read_meshb(path: Path) -> MeditMesh:
    data = path.read_bytes()
    (magic,) = struct.unpack_from("<i", data, 0)
    if magic == 1:
        en = "<"
    else:
        (magic_b,) = struct.unpack_from(">i", data, 0)
        if magic_b != 1:
            raise ValueError("not a meshb file")
        en = ">"
    (ver,) = struct.unpack_from(en + "i", data, 4)
    pos_fmt = "i" if ver < 3 else "q"
    pos_size = 4 if ver < 3 else 8
    flt = "f" if ver == 1 else "d"
    flt_size = 4 if ver == 1 else 8
    m = MeditMesh()
    off = 8

    def read_i(o):
        return struct.unpack_from(en + "i", data, o)[0], o + 4

    def read_pos(o):
        return struct.unpack_from(en + pos_fmt, data, o)[0], o + pos_size

    while off < len(data):
        kw, off = read_i(off)
        if kw == _KW["End"] or kw == 0:
            break
        nxt, off = read_pos(off)
        name = _KW_INV.get(kw)
        if name == "Dimension":
            _, off = read_i(off)
        elif name == "Vertices":
            n, off = read_i(off)
            rec = np.frombuffer(data, dtype=np.dtype(
                [("xyz", en + flt, 3), ("ref", en + "i")]), count=n,
                offset=off)
            m.vert = rec["xyz"].astype(np.float64)
            m.vref = rec["ref"].astype(np.int32)
            off += n * (3 * flt_size + 4)
        elif name in ("Tetrahedra", "Triangles", "Edges"):
            nv = {"Tetrahedra": 4, "Triangles": 3, "Edges": 2}[name]
            n, off = read_i(off)
            rec = np.frombuffer(data, dtype=np.dtype(
                [("v", en + "i", nv), ("ref", en + "i")]), count=n,
                offset=off)
            ids = rec["v"].astype(np.int32) - 1
            refs = rec["ref"].astype(np.int32)
            if name == "Tetrahedra":
                m.tetra, m.tref = ids, refs
            elif name == "Triangles":
                m.tria, m.triaref = ids, refs
            else:
                m.edges, m.edgeref = ids, refs
            off += n * (nv + 1) * 4
        elif name in ("Corners", "RequiredVertices", "Ridges",
                      "RequiredEdges", "RequiredTriangles"):
            n, off = read_i(off)
            arr = np.frombuffer(data, dtype=en + "i", count=n,
                                offset=off).astype(np.int32) - 1
            setattr(m, {"Corners": "corners",
                        "RequiredVertices": "required_vert",
                        "Ridges": "ridges",
                        "RequiredEdges": "required_edges",
                        "RequiredTriangles": "required_tria"}[name], arr)
            off += n * 4
        else:
            if nxt <= off or nxt > len(data):
                break
            off = nxt
    return m


def _write_meshb(path: Path, m: MeditMesh) -> None:
    out = bytearray()
    en = "<"

    def w(fmt, *vals):
        out.extend(struct.pack(en + fmt, *vals))

    w("ii", 1, 2)            # magic, version 2 (float64, int32 positions)
    w("ii", _KW["Dimension"], 0)
    # patch "next" later is optional (0 = unknown) — readers scan sequentially
    w("i", 3)
    w("ii", _KW["Vertices"], 0)
    w("i", len(m.vert))
    rec = np.zeros(len(m.vert), dtype=np.dtype(
        [("xyz", en + "d", 3), ("ref", en + "i")]))
    rec["xyz"] = m.vert
    rec["ref"] = m.vref
    out.extend(rec.tobytes())
    for name, ids, refs in [("Tetrahedra", m.tetra, m.tref),
                            ("Triangles", m.tria, m.triaref),
                            ("Edges", m.edges, m.edgeref)]:
        if len(ids):
            w("ii", _KW[name], 0)
            w("i", len(ids))
            nv = ids.shape[1]
            rec = np.zeros(len(ids), dtype=np.dtype(
                [("v", en + "i", nv), ("ref", en + "i")]))
            rec["v"] = ids + 1
            rec["ref"] = refs
            out.extend(rec.tobytes())
    for name, attr in [("Corners", "corners"),
                       ("RequiredVertices", "required_vert"),
                       ("Ridges", "ridges"),
                       ("RequiredEdges", "required_edges"),
                       ("RequiredTriangles", "required_tria")]:
        arr = getattr(m, attr)
        if len(arr):
            w("ii", _KW[name], 0)
            w("i", len(arr))
            out.extend((np.asarray(arr, np.int32) + 1).tobytes())
    w("ii", _KW["End"], 0)
    path.write_bytes(bytes(out))


# ---------------------------------------------------------------------------
# .sol files
# ---------------------------------------------------------------------------
def read_sol(path: str | Path):
    """Returns (values [n, ncomp_total], types list[int])."""
    path = Path(path)
    if path.suffix == ".solb":
        return _read_solb(path)
    it = _tokens(path)
    types, n = [], 0
    tok = next(it, None)
    while tok is not None:
        if tok == "End":
            break
        if tok in ("MeshVersionFormatted", "Dimension"):
            next(it)
        elif tok == "SolAtVertices":
            n = int(next(it))
            ntyp = int(next(it))
            types = [int(next(it)) for _ in range(ntyp)]
            ncomp = sum(_SOL_NCOMP[t] for t in types)
            vals = np.fromiter((next(it) for _ in range(n * ncomp)), float,
                               count=n * ncomp).reshape(n, ncomp)
            return vals, types
        else:
            raise ValueError(f"unsupported sol keyword {tok}")
        tok = next(it, None)
    raise ValueError("no SolAtVertices section")


def write_sol(path: str | Path, vals: np.ndarray, types: list[int]) -> None:
    path = Path(path)
    vals = np.atleast_2d(np.asarray(vals, np.float64))
    if vals.shape[0] == 1 and vals.shape[1] > 1 and sum(
            _SOL_NCOMP[t] for t in types) == 1:
        vals = vals.T
    if path.suffix == ".solb":
        _write_solb(path, vals, types)
        return
    with open(path, "w") as f:
        f.write("MeshVersionFormatted 2\n\nDimension 3\n\n")
        f.write(f"SolAtVertices\n{vals.shape[0]}\n")
        f.write(f"{len(types)} " + " ".join(str(t) for t in types) + "\n")
        for row in vals:
            f.write(" ".join(f"{v:.15g}" for v in row) + "\n")
        f.write("\nEnd\n")


def _read_solb(path: Path):
    data = path.read_bytes()
    (magic,) = struct.unpack_from("<i", data, 0)
    en = "<" if magic == 1 else ">"
    (ver,) = struct.unpack_from(en + "i", data, 4)
    pos_fmt, pos_size = ("i", 4) if ver < 3 else ("q", 8)
    flt = "f" if ver == 1 else "d"
    flt_size = 4 if ver == 1 else 8
    off = 8
    while off < len(data):
        (kw,) = struct.unpack_from(en + "i", data, off)
        off += 4
        if kw == _KW["End"] or kw == 0:
            break
        off += pos_size
        if kw == _KW["Dimension"]:
            off += 4
        elif kw == _KW["SolAtVertices"]:
            n, ntyp = struct.unpack_from(en + "ii", data, off)
            off += 8
            types = list(struct.unpack_from(en + f"{ntyp}i", data, off))
            off += 4 * ntyp
            ncomp = sum(_SOL_NCOMP[t] for t in types)
            vals = np.frombuffer(data, en + flt, count=n * ncomp,
                                 offset=off).reshape(n, ncomp).astype(np.float64)
            return vals, types
        else:
            raise ValueError(f"unsupported solb keyword {kw}")
    raise ValueError("no SolAtVertices section")


def _write_solb(path: Path, vals: np.ndarray, types: list[int]) -> None:
    out = bytearray()
    en = "<"
    out.extend(struct.pack(en + "ii", 1, 2))
    out.extend(struct.pack(en + "iii", _KW["Dimension"], 0, 3))
    out.extend(struct.pack(en + "ii", _KW["SolAtVertices"], 0))
    out.extend(struct.pack(en + "ii", vals.shape[0], len(types)))
    out.extend(struct.pack(en + f"{len(types)}i", *types))
    out.extend(np.asarray(vals, en + "f8").tobytes())
    out.extend(struct.pack(en + "ii", _KW["End"], 0))
    path.write_bytes(bytes(out))
