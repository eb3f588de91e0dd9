"""ctypes bindings of the port's host mesh kernels (``native/meshkit.cpp``).

The port's counterpart of the JAX package's ``native/``: the same four C
entry points (``build_adjacency``, ``greedy_partition``, ``scan_medit``,
``color_components``), compiled from this package's own copy of
``meshkit.cpp`` with ``g++ -O3 -std=c++17 -shared -fPIC`` into
``build/libmeshkit.so`` at the repository root, at first use and never at
import, through ``ops/cuda_build``'s machinery: rebuilt when older than
its source, renamed into place from a temporary name, its g++ seconds in
the shape ledger as ``gxx.meshkit``, loaded once.

Where ``g++`` exists (:func:`available`), the callers use the library and
a failed build or load raises with the compiler's output: a broken build
never changes a partition quietly.  Only where no compiler exists do they
take their numpy paths (``parallel/partition.greedy_partition``'s BFS, the
Python tokenizer of ``io/medit``), and :func:`available` says so once
through ``obs.trace.log``: the one case where the JAX package computes the
numpy result too.
"""
from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

import numpy as np

from ..ops import cuda_build

SRC = Path(__file__).resolve().parent / "meshkit.cpp"
SO = cuda_build.BUILD / "libmeshkit.so"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_SAID = [False]


def compiler() -> str | None:
    """The ``g++`` on the PATH, or None."""
    return shutil.which("g++")


def available() -> bool:
    """Whether the callers use the library: True where ``g++`` exists
    (the build and load then raise on failure).  Where it does not, logs
    once that the numpy paths run instead."""
    if compiler() is not None:
        return True
    if not _SAID[0]:
        _SAID[0] = True
        from ..obs.trace import log
        log(1, "  ## native: no g++ on the PATH; the numpy partition and "
               "the Python Medit tokenizer run instead of meshkit",
            err=True)
    return False


def build() -> float:
    """Compile ``meshkit.cpp`` into ``build/libmeshkit.so`` when it is
    missing or older than the source; returns the g++ seconds (0.0 when
    nothing was built).  Raises with the compiler's output when g++ is
    missing or fails."""
    if not cuda_build.stale(SO, [SRC]):
        return 0.0
    gxx = compiler()
    if gxx is None:
        raise RuntimeError("meshkit: g++ not found on the PATH")
    return cuda_build.compile_libs(
        [("meshkit", "gxx", [gxx, *GXX_FLAGS, str(SRC)], SO)])


def _bind(lib: ctypes.CDLL) -> None:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.build_adjacency.argtypes = [ctypes.c_int64, i32p, i32p]
    lib.greedy_partition.argtypes = [ctypes.c_int64, i32p, f64p,
                                     ctypes.c_int32, i64p, i32p]
    lib.scan_medit.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_int, i64p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.color_components.argtypes = [ctypes.c_int64, i32p, i32p, i32p]
    for fn in (lib.build_adjacency, lib.greedy_partition, lib.scan_medit,
               lib.color_components):
        fn.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises on failure."""
    return cuda_build.load_lib(SO, build, _bind)


def build_adjacency(tet: np.ndarray) -> np.ndarray:
    """adja[t, f] = 4 t' + f' of the tet across face f (face f opposite
    vertex f), or -1 on the boundary."""
    lib = _lib()
    tet = np.ascontiguousarray(tet, np.int32)
    ne = len(tet)
    adja = np.empty(4 * ne, np.int32)
    lib.build_adjacency(ne, tet.reshape(-1), adja)
    return adja.reshape(ne, 4)


def greedy_partition(adja: np.ndarray, nparts: int, seeds: np.ndarray,
                     weights: np.ndarray | None = None) -> np.ndarray:
    """BFS graph growing over the dual graph from ``seeds``, the least
    loaded part taking the next tet; disconnected leftovers go to the
    least loaded part."""
    lib = _lib()
    ne = len(adja)
    w = np.ascontiguousarray(
        np.ones(ne) if weights is None else weights, np.float64)
    part = np.empty(ne, np.int32)
    lib.greedy_partition(ne, np.ascontiguousarray(adja, np.int32)
                         .reshape(-1), w, nparts,
                         np.ascontiguousarray(seeds, np.int64), part)
    return part


def scan_medit(data: bytes) -> dict | None:
    """The bytes of one ASCII Medit file with Vertices, Tetrahedra and
    Triangles only, scanned twice (counts, then values): a dict of vert,
    vref, tet, tref, tria, triaref with 0-based ids.  None when the file
    has a section the scanner does not read: the caller then takes the
    tokenizer, which reads it or raises on it."""
    lib = _lib()
    counts = np.zeros(3, np.int64)
    if lib.scan_medit(data, len(data), 0, counts, None, None, None, None,
                      None, None):
        return None
    np_, ne, nt = map(int, counts)
    vert = np.empty((np_, 3), np.float64)
    vref = np.empty(np_, np.int32)
    tet = np.empty((ne, 4), np.int32)
    tref = np.empty(ne, np.int32)
    tria = np.empty((max(nt, 1), 3), np.int32)
    triaref = np.empty(max(nt, 1), np.int32)
    lib.scan_medit(data, len(data), 1, counts,
                   vert.ctypes.data_as(ctypes.c_void_p),
                   vref.ctypes.data_as(ctypes.c_void_p),
                   tet.ctypes.data_as(ctypes.c_void_p),
                   tref.ctypes.data_as(ctypes.c_void_p),
                   tria.ctypes.data_as(ctypes.c_void_p),
                   triaref.ctypes.data_as(ctypes.c_void_p))
    return {"vert": vert, "vref": vref, "tet": tet - 1, "tref": tref,
            "tria": tria[:nt] - 1, "triaref": triaref[:nt]}


def color_components(adja: np.ndarray, part: np.ndarray) -> np.ndarray:
    """Connected components of each part over the dual graph: comp[t]
    numbers them in order of their first tet."""
    lib = _lib()
    ne = len(adja)
    comp = np.empty(ne, np.int32)
    lib.color_components(ne, np.ascontiguousarray(adja, np.int32)
                         .reshape(-1),
                         np.ascontiguousarray(part, np.int32), comp)
    return comp
