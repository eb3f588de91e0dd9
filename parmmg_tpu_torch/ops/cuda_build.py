"""Build and load the hand-written CUDA kernels of ``parmmg_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/lib<name>.so`` at the repository root the first time a kernel
of it is needed, then loaded with ctypes.  :func:`build_all` starts one
``nvcc`` per source, all together, and records each build's seconds in
the shape ledger (``utils/compilecache.record_build``).  ``build/`` is
the persistent cache: a library newer than its sources is loaded as it is
(the polish worker, a fresh process, builds nothing).  Nothing here runs
at import time; a missing ``nvcc`` or a failed build raises.
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

_LIBS: dict[str, ctypes.CDLL] = {}


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


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any shared
    header of ``csrc/``."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(d.stat().st_mtime for d in deps)


def build_all(names=SOURCES, verbose: bool = False) -> float:
    """Compile every stale source in parallel; returns the wall seconds.
    ``verbose`` adds ``-Xptxas -v`` (registers / spills per kernel) and
    prints the compiler output."""
    todo = [n for n in names if _stale(n)]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        tmp = BUILD / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), {}))

    def reap(p, box):
        box["out"], _ = p.communicate()
        box["s"] = time.perf_counter() - t0
    waits = [threading.Thread(target=reap, args=(p, box))
             for _, _, p, box in procs]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    from ..utils.compilecache import record_build
    errors = []
    for name, tmp, p, box in procs:
        out = box["out"]
        record_build(name, box["s"])
        if verbose and out:
            print(f"[nvcc {name}]\n{out}")
        if p.returncode != 0:
            errors.append(f"{name}: nvcc exit {p.returncode}\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
