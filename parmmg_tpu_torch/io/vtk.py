"""VTK XML I/O: .vtu read, .vtu/.pvtu write (port of ``io/vtk.py``).

numpy and the standard library only, ascii XML with ``%.17g`` floats: the
same bytes as the JAX package's writer for the same arrays.  The role of
ParMmg's ``PMMG_loadVtuMesh_centralized`` and ``PMMG_savePvtuMesh``
(inoutcpp_pmmg.cpp:44-116) without the VTK library.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

_VTK_TETRA = 10
_VTK_TRIANGLE = 5
_VTK_LINE = 3


def write_vtu(path: str | Path, vert: np.ndarray, tet: np.ndarray,
              point_data: dict[str, np.ndarray] | None = None,
              cell_data: dict[str, np.ndarray] | None = None) -> Path:
    path = Path(path)
    n_p, n_c = len(vert), len(tet)
    lines = []
    a = lines.append
    a('<?xml version="1.0"?>')
    a('<VTKFile type="UnstructuredGrid" version="0.1" '
      'byte_order="LittleEndian">')
    a('  <UnstructuredGrid>')
    a(f'    <Piece NumberOfPoints="{n_p}" NumberOfCells="{n_c}">')
    a('      <Points>')
    a('        <DataArray type="Float64" NumberOfComponents="3" '
      'format="ascii">')
    for p in np.asarray(vert, np.float64):
        a(f"          {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}")
    a('        </DataArray>')
    a('      </Points>')
    a('      <Cells>')
    a('        <DataArray type="Int64" Name="connectivity" format="ascii">')
    for t in np.asarray(tet, np.int64):
        a("          " + " ".join(map(str, t)))
    a('        </DataArray>')
    a('        <DataArray type="Int64" Name="offsets" format="ascii">')
    a("          " + " ".join(str(4 * (i + 1)) for i in range(n_c)))
    a('        </DataArray>')
    a('        <DataArray type="UInt8" Name="types" format="ascii">')
    a("          " + " ".join([str(_VTK_TETRA)] * n_c))
    a('        </DataArray>')
    a('      </Cells>')

    def data_block(tag, data):
        if not data:
            return
        a(f'      <{tag}>')
        for name, arr in data.items():
            arr = np.asarray(arr)
            nc = 1 if arr.ndim == 1 else arr.shape[1]
            a(f'        <DataArray type="Float64" Name="{name}" '
              f'NumberOfComponents="{nc}" format="ascii">')
            for row in arr.reshape(len(arr), -1):
                a("          " + " ".join(f"{x:.17g}" for x in row))
            a('        </DataArray>')
        a(f'      </{tag}>')

    data_block("PointData", point_data)
    data_block("CellData", cell_data)
    a('    </Piece>')
    a('  </UnstructuredGrid>')
    a('</VTKFile>')
    path.write_text("\n".join(lines) + "\n")
    return path


def read_vtu(path: str | Path):
    """Read an ascii .vtu into (vert [n,3] f64, cells dict, point_data,
    cell_data) — the ``PMMG_loadVtuMesh_centralized`` role
    (inoutcpp_pmmg.cpp:44: load a centralized VTK mesh + metric/fields).

    ``cells`` maps VTK type -> [m, k] int64 connectivity (10 = tetra
    [m,4], 5 = triangle [m,3], 3 = line [m,2]); mixed-cell files
    partition by type.  Data arrays come back as float64; cell_data rows
    follow the FILE cell order, so per-type slices align with the cells
    dict (types are returned in first-appearance order with stable
    within-type order, and a "__order__" entry gives each type's row
    indices into the original cell sequence).

    Only ascii format is supported (the writer's own format and the
    common interchange case); binary/appended raise ValueError rather
    than mis-parse.
    """
    import xml.etree.ElementTree as ET
    root = ET.parse(str(path)).getroot()
    piece = root.find(".//Piece")
    if piece is None:
        raise ValueError(f"{path}: no <Piece> in VTU")

    def arr_of(da):
        if da.get("format", "ascii") != "ascii":
            raise ValueError(
                f"{path}: only ascii VTU supported "
                f"(format={da.get('format')!r})")
        text = da.text or ""
        dt = np.float64 if da.get("type", "").startswith("Float") \
            else np.int64
        if not text.strip():
            return np.zeros(0, dt)
        return np.array(text.split(), dtype=dt)

    pts = piece.find("Points/DataArray")
    vert = arr_of(pts).astype(np.float64).reshape(-1, 3)

    conn = offs = types = None
    for da in piece.findall("Cells/DataArray"):
        nm = da.get("Name")
        if nm == "connectivity":
            conn = arr_of(da).astype(np.int64)
        elif nm == "offsets":
            offs = arr_of(da).astype(np.int64)
        elif nm == "types":
            types = arr_of(da).astype(np.int64)
    if conn is None or offs is None or types is None:
        raise ValueError(f"{path}: incomplete <Cells> block")
    starts = np.concatenate([[0], offs[:-1]])
    cells: dict[int, np.ndarray] = {}
    order: dict[int, np.ndarray] = {}
    for t, k in ((_VTK_TETRA, 4), (_VTK_TRIANGLE, 3), (_VTK_LINE, 2)):
        rows = np.where(types == t)[0]
        if len(rows):
            if not (offs[rows] - starts[rows] == k).all():
                raise ValueError(f"{path}: cell type {t} with wrong "
                                 "vertex count")
            cells[t] = conn[starts[rows][:, None]
                            + np.arange(k)[None, :]]
            order[t] = rows
    unknown = set(np.unique(types)) - {_VTK_TETRA, _VTK_TRIANGLE,
                                       _VTK_LINE}
    if unknown:
        raise ValueError(f"{path}: unsupported VTK cell types "
                         f"{sorted(unknown)}")

    def data_of(tag, n):
        out = {}
        blk = piece.find(tag)
        if blk is not None:
            for da in blk.findall("DataArray"):
                v = arr_of(da).astype(np.float64)
                nc = int(da.get("NumberOfComponents", "1"))
                out[da.get("Name", "field")] = \
                    v.reshape(n, nc) if nc > 1 else v
        return out

    point_data = data_of("PointData", len(vert))
    cell_data = data_of("CellData", len(types))
    cell_data["__order__"] = order
    return vert, cells, point_data, cell_data


def read_vtu_medit(path: str | Path):
    """.vtu -> MeditMesh (+ metric/fields), the ingest shape the CLI and
    API load path consume.  References come from an integer-valued cell
    field named like the Medit convention when present
    ("medit:ref"/"ref"/"MaterialID"); otherwise zero."""
    from .medit import MeditMesh
    vert, cells, pdata, cdata = read_vtu(path)
    order = cdata.pop("__order__", {})
    m = MeditMesh()
    m.vert = vert
    m.vref = np.zeros(len(vert), np.int32)

    def refs_for(t, n):
        short = []
        for nm in ("medit:ref", "ref", "MaterialID", "CellEntityIds"):
            if nm in cdata and len(order.get(t, ())):
                # order[t] holds row indices into the FULL cell
                # sequence: the array must cover its MAX index, not
                # just this type's count (a per-type-length array from
                # a mixed-cell producer would otherwise fancy-index
                # out of range).  A short array is skipped in favor of
                # the next candidate name (the pre-existing fallthrough
                # contract); only if NO candidate is usable does the
                # ambiguity become a hard error instead of silently
                # zeroed refs.
                if len(cdata[nm]) <= int(np.max(order[t])):
                    short.append(nm)
                    continue
                v = np.asarray(cdata[nm])[order[t]]
                if v.ndim == 1:
                    return v.astype(np.int32)
        if short:
            raise ValueError(
                f"CellData {short} shorter than the file's cell list "
                "(per-type cell-data arrays are not supported) and no "
                "full-length ref array is present")
        return np.zeros(n, np.int32)

    if _VTK_TETRA in cells:
        m.tetra = cells[_VTK_TETRA].astype(np.int32)
        m.tref = refs_for(_VTK_TETRA, len(m.tetra))
    if _VTK_TRIANGLE in cells:
        m.tria = cells[_VTK_TRIANGLE].astype(np.int32)
        m.triaref = refs_for(_VTK_TRIANGLE, len(m.tria))
    if _VTK_LINE in cells:
        m.edges = cells[_VTK_LINE].astype(np.int32)
        m.edgeref = refs_for(_VTK_LINE, len(m.edges))
    # metric conventions: a scalar "metric"/"sol" point field, or the
    # 6-component packed tensor
    met = None
    for nm in ("metric", "sol", "met"):
        if nm in pdata:
            met = pdata[nm]
            break
    fields = {k: v for k, v in pdata.items()
              if k not in ("metric", "sol", "met")}
    return m, met, fields


def write_pvtu(path: str | Path, piece_files: list[str | Path],
               point_data: dict[str, int] | None = None,
               cell_data: dict[str, int] | None = None) -> Path:
    """Master file referencing per-shard .vtu pieces
    (PMMG_savePvtuMesh analogue).  ``point_data``/``cell_data`` map field
    name -> number of components."""
    path = Path(path)
    lines = []
    a = lines.append
    a('<?xml version="1.0"?>')
    a('<VTKFile type="PUnstructuredGrid" version="0.1" '
      'byte_order="LittleEndian">')
    a('  <PUnstructuredGrid GhostLevel="0">')
    a('    <PPoints>')
    a('      <PDataArray type="Float64" NumberOfComponents="3"/>')
    a('    </PPoints>')
    for tag, data in (("PPointData", point_data),
                      ("PCellData", cell_data)):
        if data:
            a(f'    <{tag}>')
            for name, nc in data.items():
                a(f'      <PDataArray type="Float64" Name="{name}" '
                  f'NumberOfComponents="{nc}"/>')
            a(f'    </{tag}>')
    for f in piece_files:
        a(f'    <Piece Source="{Path(f).name}"/>')
    a('  </PUnstructuredGrid>')
    a('</VTKFile>')
    path.write_text("\n".join(lines) + "\n")
    return path
