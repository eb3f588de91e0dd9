"""Build and load the hand-written native libraries of the port.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/lib<name>.so`` at the repository root the first time a kernel
of it is needed, then loaded with ctypes.  :func:`build_all` starts one
``nvcc`` per source, all together.  :func:`compile_libs` and
:func:`load_lib` are the machinery every native library goes through,
``native/meshkit.cpp``'s ``g++`` build included: each compiler writes a
temporary name that is renamed into place (processes that build at the
same time never load a half-written file), each build's seconds go into
the shape ledger (``utils/compilecache.record_build``), and a library is
loaded once.  ``build/`` is the persistent cache: a library newer than its
sources is loaded as it is (the polish worker, a fresh process, builds
nothing).  Nothing here runs at import time; a missing compiler or a
failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG.parent / "build"
SOURCES = ("edge_length_iso", "edge_length_ani", "score_count",
           "tet_quality", "merge_prefix", "radix_sort", "segment_flags")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of parmmg_tpu_torch "
                       "need the CUDA toolkit to build")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def stale(lib: Path, deps) -> bool:
    """``lib`` is missing or older than any of ``deps``."""
    return (not lib.exists()
            or lib.stat().st_mtime < max(d.stat().st_mtime for d in deps))


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any shared
    header of ``csrc/``."""
    return stale(_lib_path(name), [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])


def compile_libs(jobs, verbose: bool = False) -> float:
    """Run the compiler of every job at once; returns the wall seconds.
    A job is ``(name, tool, argv, lib)``: ``argv`` gets ``-o`` of a
    temporary name, renamed into ``lib`` when the compiler succeeds, and
    the seconds go into the shape ledger as ``<tool>.<name>``.  Raises
    with the output of every compiler that failed."""
    t0 = time.perf_counter()
    procs = []
    for name, tool, argv, lib in jobs:
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(
            f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        procs.append((name, tool, argv, lib, tmp, subprocess.Popen(
            [*argv, "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), {}))

    def reap(p, box):
        box["out"], _ = p.communicate()
        box["s"] = time.perf_counter() - t0
    waits = [threading.Thread(target=reap, args=(job[-2], job[-1]))
             for job in procs]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    from ..utils.compilecache import record_build
    errors = []
    for name, tool, argv, lib, tmp, p, box in procs:
        out = box["out"]
        record_build(name, box["s"], tool=tool)
        if verbose and out:
            print(f"[{tool} {name}]\n{out}")
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}: {Path(argv[0]).name} exit "
                          f"{p.returncode}\n{out}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("native build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def build_all(names=SOURCES, verbose: bool = False) -> float:
    """Compile every stale source of ``csrc/`` in parallel; returns the
    wall seconds.  ``verbose`` adds ``-Xptxas -v`` (registers / spills per
    kernel) and prints the compiler output."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    return compile_libs(
        [(n, "nvcc", [nvcc, *NVCC_FLAGS, *extra, str(CSRC / f"{n}.cu")],
          _lib_path(n)) for n in todo], verbose)


def load_lib(lib: Path, build, bind=None) -> ctypes.CDLL:
    """The loaded library at ``lib``: the first call runs ``build()``
    (which rebuilds it when stale), loads it and hands it to ``bind``
    (its argtypes); later calls return it as it is."""
    got = _LIBS.get(lib)
    if got is None:
        build()
        got = ctypes.CDLL(str(lib))
        if bind is not None:
            bind(got)
        _LIBS[lib] = got
    return got


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return load_lib(_lib_path(name), lambda: build_all((name,)))
