"""Time K8 (``csrc/segment_flags.cu``) and K6 (``csrc/tet_quality.cu``)
against the kernels they replaced and against variants of their own sources.

The baselines are the replaced sources, kept in this file as they were:

  prev       K8: one thread a row, two scalar loads a word a row, one-byte
             stores, a grid capped at 132 x 16 blocks; its gathered mode is
             PyTorch's gather (``w[order]``, one ``aten::index`` a word)
             followed by that kernel, the pair the sort sites ran.
             K6: one thread a tet, four scalar id loads and scalar corner
             (and 24 scalar metric) loads, ``powf``.

The committed sources and their variants:

  K8 vec8    the source as it is (8 rows a thread, 16-byte loads)
  K8 vec16   16 rows a thread
  K8 scalar  the committed kernel with its vector path turned off (every
             thread on the scalar path)
  K6 t1      the source as it is (one tet a thread, a full grid of them,
             rap * sqrtf(rap))
  K6 flat    the same body without its loop (which runs once a thread)
  K6 t2      2 tets a thread, a block apart, the loop unrolled
  K6 cap6    a grid of at most 6 resident blocks an SM, the loop striding
  K6 cap4    the same, at most 4 blocks an SM
  K6 powf    powf(rap, 1.5f)
  K6 met1    the metric rows as six 4-byte loads instead of three 8-byte
  K6 ldcg    the corner and metric rows through L2 only (__ldcg), not L1

Each variant is the committed source with a few lines replaced.
Every library is built with the port's nvcc flags (one ``nvcc`` each, all
started together).  Each K8 variant is checked exactly against
``segment_flags_plain`` in both modes (the rows below, tails and a column
viewed at a 1-element offset), each K6 variant against
``tet_quality_plain`` at the port's tolerances (rtol 3e-5 / atol 3e-6 iso,
1e-4 / 1e-5 tensor).  Then every row is timed in turns, the variants in
order and then in reverse.  The rows are the main path's shapes: the
sorted edge keys (1,325,952 rows, 1 word) and face keys (883,968 rows, 2
words) of a mesh at the iso path's capacities, each also in gathered mode
from its unsorted keys and K7's permutation; K6 on that mesh (iso, capT
220,992, capP 42,364) and on a larger one under the shock tensor metric
(capT 407,648, capP 78,044), live tets first and dead slots after, as the
path's output mesh is laid out.  Each row runs on up to three meshes: a
structured cube ("cube"), the same cube with its vertices and tets
numbered at random ("shuffled": gathers with no locality; gathered-mode
K8 and K6 only), and the two output meshes ``chip_smoke.py`` writes under
``build/smoke/`` ("path"), when it ran first in the same checkout.  A reading is the median over 5 replays of a CUDA graph of 50 calls
between two CUDA events, per call (the device's time for the calls back to
back: issued one by one, a few µs of kernel would wait on tens of µs of
host), and the profiler's device time a call of every kernel the call
launches, issued one by one.  The
verdict line of each row says whether the committed kernel's batch time
is at or below the previous kernel's in every turn.

Run from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/k6_k8_variants.py
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "parmmg_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "k6_k8_variants")

# the previous csrc/segment_flags.cu, as it was
PREV_K8 = r"""// K8: segment-start flags over sorted key columns: flag[i] is true iff
// i == 0 or any of the 1-3 words differs from row i - 1.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:segment_flags_pallas
// (_seg_kernel), which carries the previous block's last row across the
// TPU's sequential grid in SMEM.  Here one thread handles one row and reads
// row i - 1 straight from device memory, so no carry is needed and blocks
// run in any order.
//
// Bound on the card: bytes (4 bytes a word read, 1 byte a flag written).
// Row i - 1 is the neighbouring thread's row, so the second read hits the
// same cache lines; loads are coalesced; a grid-stride loop over at most
// 132 * 16 blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segment_flags_kernel(const int* __restrict__ w0,
                                     const int* __restrict__ w1,
                                     const int* __restrict__ w2, int nwords,
                                     uint8_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    bool f = i == 0;
    if (!f) {
      f = w0[i] != w0[i - 1];
      if (nwords > 1) f = f || w1[i] != w1[i - 1];
      if (nwords > 2) f = f || w2[i] != w2[i - 1];
    }
    out[i] = f ? 1 : 0;
  }
}

}  // namespace

extern "C" int pm_segment_flags(const int* w0, const int* w1, const int* w2,
                                int nwords, uint8_t* out, long long n,
                                void* stream) {
  if (n <= 0) return 0;
  if (nwords < 1 || nwords > 3) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  segment_flags_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(w0, w1, w2, nwords, out, n);
  return (int)cudaGetLastError();
}
"""

# the previous csrc/tet_quality.cu, as it was
PREV_K6 = r"""// Tet quality ALPHA * vol * sqrt(det Mbar) / (sum of squared edge lengths in
// Mbar)^1.5, clamped to <= 1 (<= 0 when inverted), 0 on dead tets.  One
// thread per tet slot; iso and aniso modes are one template.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:quality_pallas (_qual_kernel),
// which ops/quality.py:tet_quality feeds.  The TPU version received the
// corner coordinates [N,4,3] (and the tet-mean metric [N,6]) already gathered
// by XLA; here the kernel gathers the corners itself from vert/tet (and
// met6), so the [capT,4,3] coordinate array never reaches device memory.
//
// Bound on the card: bytes.  Per tet it reads 16 bytes of ids + 1 byte of
// mask and writes 4; the corner rows (12 bytes, +24 aniso) are gathers that
// mostly hit L2.  Least time = (21 * capT + 12 * capP (+24 * capP aniso))
// bytes / 3.35 TB/s.  Arithmetic: ~60 (iso) / ~150 (aniso) flops per tet
// plus one pow, well below the float32 peak for these sizes.  Design: plain
// grid-stride loop, all math in registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEpsd = 1e-30f;
constexpr float kAlpha = 124.70765814495915f;  // 36 * sqrt(12)

template <bool ANISO>
__global__ void tet_quality_kernel(const float* __restrict__ vert,
                                   const int* __restrict__ tet,
                                   const uint8_t* __restrict__ tmask,
                                   const float* __restrict__ met6,
                                   float* __restrict__ out, int capP,
                                   long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n; t += stride) {
    if (!tmask[t]) {
      out[t] = 0.0f;
      continue;
    }
    float x[4], y[4], z[4];
    float m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = min(max(tet[4 * t + c], 0), capP - 1);
      x[c] = vert[3 * v];
      y[c] = vert[3 * v + 1];
      z[c] = vert[3 * v + 2];
      if (ANISO) {
#pragma unroll
        for (int k = 0; k < 6; ++k) m[k] += met6[6 * v + k];
      }
    }
    const float d1x = x[1] - x[0], d1y = y[1] - y[0], d1z = z[1] - z[0];
    const float d2x = x[2] - x[0], d2y = y[2] - y[0], d2z = z[2] - z[0];
    const float d3x = x[3] - x[0], d3y = y[3] - y[0], d3z = z[3] - z[0];
    const float cx = d2y * d3z - d2z * d3y;
    const float cy = d2z * d3x - d2x * d3z;
    const float cz = d2x * d3y - d2y * d3x;
    const float vol = (d1x * cx + d1y * cy + d1z * cz) / 6.0f;
    float M11 = 0.f, M12 = 0.f, M13 = 0.f, M22 = 0.f, M23 = 0.f, M33 = 0.f;
    if (ANISO) {
      M11 = 0.25f * m[0];
      M12 = 0.25f * m[1];
      M13 = 0.25f * m[2];
      M22 = 0.25f * m[3];
      M23 = 0.25f * m[4];
      M33 = 0.25f * m[5];
    }
    // IARE order: (0,1)(0,2)(0,3)(1,2)(1,3)(2,3)
    const int ei[6] = {0, 0, 0, 1, 1, 2};
    const int ej[6] = {1, 2, 3, 2, 3, 3};
    float rap = 0.0f;
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const float ex = x[ej[e]] - x[ei[e]];
      const float ey = y[ej[e]] - y[ei[e]];
      const float ez = z[ej[e]] - z[ei[e]];
      if (ANISO) {
        rap += M11 * ex * ex + M22 * ey * ey + M33 * ez * ez +
               2.0f * (M12 * ex * ey + M13 * ex * ez + M23 * ey * ez);
      } else {
        rap += ex * ex + ey * ey + ez * ez;
      }
    }
    float num;
    if (ANISO) {
      const float det = M11 * (M22 * M33 - M23 * M23) -
                        M12 * (M12 * M33 - M23 * M13) +
                        M13 * (M12 * M23 - M22 * M13);
      num = kAlpha * vol * sqrtf(fmaxf(det, 0.0f));
    } else {
      num = kAlpha * vol;
    }
    const float q = num / powf(fmaxf(rap, kEpsd), 1.5f);
    out[t] = vol > 0.0f ? fminf(q, 1.0f) : fminf(q, 0.0f);
  }
}

}  // namespace

extern "C" int pm_tet_quality(const float* vert, const int* tet,
                              const uint8_t* tmask, const float* met6,
                              float* out, int capP, long long n,
                              void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  cudaStream_t s = (cudaStream_t)stream;
  if (met6 != nullptr) {
    tet_quality_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
        vert, tet, tmask, met6, out, capP, n);
  } else {
    tet_quality_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
        vert, tet, tmask, met6, out, capP, n);
  }
  return (int)cudaGetLastError();
}
"""

# K8 "scalar": the vector path turned off
_SCALAR_OLD = "  bool aligned = aligned_to(flags, ROWS) && aligned_to(order, 16);\n"
_SCALAR_NEW = "  bool aligned = false;\n"
# K8 "vec16": 16 rows a thread, the flags in one 16-byte store
_K8_ROWS = "constexpr int ROWS = 8;  // rows a thread\n"
_K8_STORE8 = ("    *reinterpret_cast<uint2*>(flags + r0) = "
              "make_uint2(packed[0], packed[1]);\n")
_K8_STORE16 = ("    *reinterpret_cast<uint4*>(flags + r0) =\n"
               "        make_uint4(packed[0], packed[1], packed[2], "
               "packed[3]);\n")
# K6: the kernel's loop and grid ("flat", "t2", "cap6", "cap4"), rap^1.5
# ("powf"), the metric rows' loads ("met1") and the corner rows' ("ldcg")
_K6_HEAD = """\
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < n;
       t += (long long)gridDim.x * THREADS) {
"""
_K6_HEAD_FLAT = """\
  {
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (t >= n) return;
"""
_K6_HEAD_T2 = """\
  for (long long t0 = (long long)blockIdx.x * 2 * THREADS + threadIdx.x;
       t0 < n; t0 += (long long)gridDim.x * 2 * THREADS)
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long t = t0 + u * THREADS;
    if (t >= n) break;
"""
_K6_GRID = "  const long long blocks = (n + THREADS - 1) / THREADS;\n"
_K6_GRID_T2 = ("  const long long blocks = (n + 2 * THREADS - 1) / "
               "(2 * THREADS);\n")
_K6_GRID_CAP = """\
  long long blocks = (n + THREADS - 1) / THREADS;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks > (long long)sms * {cap}) blocks = (long long)sms * {cap};
"""
_K6_POW = "float pow15(float x) { return x * sqrtf(x); }"
_K6_POWF = "float pow15(float x) { return powf(x, 1.5f); }"
_K6_MET2 = """\
          const float2* r =
              reinterpret_cast<const float2*>(met6 + 6 * (long long)v);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float2 a = __ldg(r + k);
            m[2 * k] += a.x;
            m[2 * k + 1] += a.y;
          }
"""
_K6_MET1 = """\
#pragma unroll
          for (int k = 0; k < 6; ++k)
            m[k] += __ldg(met6 + 6 * (long long)v + k);
"""
_K6_CORNERS = ("        x[c] = __ldg(p);\n        y[c] = __ldg(p + 1);\n"
               "        z[c] = __ldg(p + 2);\n")


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _patch(text: str, *pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds, once:\n{old}")
        text = text.replace(old, new)
    return text



def variants() -> dict:
    """(kernel, variant) -> CUDA source."""
    k8, k6 = _read("segment_flags.cu"), _read("tet_quality.cu")

    def cap(c):
        return _patch(k6, (_K6_GRID, _K6_GRID_CAP.format(cap=c)))
    return {
        ("k8", "prev"): PREV_K8,
        ("k8", "vec8"): k8,
        ("k8", "vec16"): _patch(k8, (_K8_ROWS, _K8_ROWS.replace("8", "16")),
                                (_K8_STORE8, _K8_STORE16)),
        ("k8", "scalar"): _patch(k8, (_SCALAR_OLD, _SCALAR_NEW)),
        ("k6", "prev"): PREV_K6,
        ("k6", "t1"): k6,
        ("k6", "flat"): _patch(k6, (_K6_HEAD, _K6_HEAD_FLAT)),
        ("k6", "t2"): _patch(k6, (_K6_HEAD, _K6_HEAD_T2),
                             (_K6_GRID, _K6_GRID_T2)),
        ("k6", "cap6"): cap(6),
        ("k6", "cap4"): cap(4),
        ("k6", "powf"): _patch(k6, (_K6_POW, _K6_POWF)),
        ("k6", "met1"): _patch(k6, (_K6_MET2, _K6_MET1)),
        ("k6", "ldcg"): _patch(k6, (_K6_MET2, _K6_MET2.replace(
            "__ldg", "__ldcg")), (_K6_CORNERS, _K6_CORNERS.replace(
                "__ldg", "__ldcg"))),
    }


def build(srcs: dict) -> dict:
    """(kernel, variant) -> loaded library; a variant that fails to build
    is printed and left out."""
    from parmmg_tpu_torch.ops import cuda_build
    procs = {}
    for (kern, name), text in srcs.items():
        d = os.path.join(OUT, f"{kern}_{name}")
        os.makedirs(d, exist_ok=True)
        src, lib = os.path.join(d, "k.cu"), os.path.join(d, "lib.so")
        with open(src, "w") as f:
            f.write(text)
        procs[(kern, name)] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
             "-Xptxas", "-v", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, p) in procs.items():
        out, _ = p.communicate()
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(f"[build] {key[0]} {key[1]}: nvcc exit {p.returncode}; "
              + " | ".join(regs))
        if p.returncode:
            print(out[-3000:])
        else:
            libs[key] = ctypes.CDLL(lib)
    return libs


def _bind(lib, sym, argtypes):
    f = getattr(lib, sym)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def use(kern: str, lib) -> None:
    """Point the port's K8 or K6 wrapper at the library ``lib``."""
    from parmmg_tpu_torch.ops import kernels as K
    syms = (("pm_segment_flags", "pm_segment_flags_rows") if kern == "k8"
            else ("pm_tet_quality",))
    for sym in syms:
        K._FNS[sym] = _bind(lib, sym, K._SIGS[sym][1])


def prev_flags(lib):
    """The previous K8 as a function of the sorted columns, and its gathered
    mode: PyTorch's gather of each column (int64 permutation, as the sort
    sites held it), then the kernel."""
    import torch
    from parmmg_tpu_torch.ops import kernels as K
    P = ctypes.c_void_p
    f = _bind(lib, "pm_segment_flags",
              [P, P, P, ctypes.c_int, P, ctypes.c_longlong, P])

    def flags(words):
        n = words[0].shape[0]
        out = torch.empty(n, dtype=torch.bool, device=words[0].device)
        ptrs = [w.data_ptr() for w in words] + [None] * (3 - len(words))
        rc = f(*ptrs, len(words), out.data_ptr(), n, K._stream(out))
        if rc:
            raise RuntimeError(f"the previous K8: CUDA error {rc}")
        return out

    def gathered(words, order64):
        srt = tuple(w[order64] for w in words)
        return srt, flags(srt)
    return flags, gathered


def batch_ms(fn, reps: int = 50, batches: int = 5) -> float:
    """Median over ``batches`` replays of a CUDA graph of ``reps`` calls of
    ``fn``, between two CUDA events, per call: the device's time for the
    calls back to back, without the host's time to issue them (a few µs of
    kernel against tens of µs of Python and ctypes a call)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    del g
    ts.sort()
    return ts[len(ts) // 2]


# the main path's capacities (chip_smoke.py's [main] and [aniso] lines)
ISO_CAP, TENSOR_CAP = (42364, 220992), (78044, 407648)
SMOKE = os.path.join(ROOT, "build", "smoke")


def _shuffled(vert, tet, seed):
    """The same mesh with its vertices and tets numbered at random."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pv = rng.permutation(len(vert))
    v = np.empty_like(vert)
    v[pv] = vert
    return v, pv[tet][rng.permutation(len(tet))].astype(np.int32), pv


def _keys(mesh):
    """(edge keys [6*capT], face keys (f0, fw) [4*capT]) of a mesh, as the
    sort sites build them, each with K7's permutation."""
    import torch
    from parmmg_tpu_torch.core.constants import INT32_MAX
    from parmmg_tpu_torch.core.mesh import tet_edge_vertices
    from parmmg_tpu_torch.ops import kernels as K
    from parmmg_tpu_torch.ops.adjacency import _face_keys
    capP = mesh.capP
    ev6 = tet_edge_vertices(mesh.tet).reshape(-1, 2)
    ekey = torch.where(mesh.tmask.repeat_interleave(6),
                       ev6.min(1).values * capP + ev6.max(1).values,
                       INT32_MAX).to(torch.int32).contiguous()
    cols = _face_keys(mesh)
    f0 = cols[:, 0].contiguous()
    fw = torch.where(f0 == INT32_MAX, INT32_MAX,
                     cols[:, 1] * capP + cols[:, 2]).to(torch.int32)
    return (((ekey,), K.radix_sort_plain((ekey,))),
            ((f0, fw), K.radix_sort_plain((f0, fw), (16, 32))))


def inputs(dev):
    """The rows' inputs, by source: "cube", a structured cube mesh at the
    main path's capacities (live tets first, dead slots after, as the
    path's output mesh is laid out); "shuffled", the same mesh with its
    vertices and tets numbered at random (gathers with no locality); and
    "path", the output meshes chip_smoke.py wrote in this checkout, when
    it ran first.  Returns ({label: (key words, K7 permutation)}, {label:
    K6 arguments}); the K8 rows of "shuffled" are gathered mode only."""
    import torch
    import chip_smoke as cs
    from parmmg_tpu_torch.core.mesh import make_mesh
    from parmmg_tpu_torch.utils.fixtures import analytic_ani_metric, cube_mesh

    def metric(v, capP):
        met6 = torch.tensor([1, 0, 0, 1, 0, 1.0], device=dev).repeat(capP, 1)
        met6[:len(v)] = torch.from_numpy(analytic_ani_metric(
            v, "shock", h=1.5 / 48, h_tan=0.1)).to(dev, torch.float32)
        return met6.contiguous()
    meshes = {}
    v, t = cube_mesh(26)                       # 105,456 tets
    va, ta = cube_mesh(33)                     # 215,622 tets
    for src, shuffle in (("cube", False), ("shuffled", True)):
        if shuffle:
            v, t, _ = _shuffled(v, t, 1)
            va, ta, _ = _shuffled(va, ta, 2)
        m = make_mesh(v, t, capP=ISO_CAP[0], capT=ISO_CAP[1], device=dev)
        ma = make_mesh(va, ta, capP=TENSOR_CAP[0], capT=TENSOR_CAP[1],
                       device=dev)
        meshes[src] = (m, ma, metric(va, TENSOR_CAP[0]))
    iso, ani = (os.path.join(SMOKE, f"{s}.o.mesh")
                for s in ("cube16", "cube16ani"))
    if os.path.exists(iso) and os.path.exists(ani):
        m = cs._read_output(iso, dev, *ISO_CAP)[0]
        ma, met6, _ = cs._read_output(ani, dev, *TENSOR_CAP)
        meshes["path"] = (m, ma, met6)
    keys, quals = {}, {}
    for src, (m, ma, met6) in meshes.items():
        ek, fk = _keys(m)
        keys[f"edge keys, {src}"], keys[f"face keys, {src}"] = ek, fk
        quals[f"iso, {src}"] = (m.vert, m.tet, m.tmask, None)
        quals[f"tensor, {src}"] = (ma.vert, ma.tet, ma.tmask, met6)
    return keys, quals


def check_k8(K, keys, dev) -> bool:
    """The K8 wrapper (whatever library it points at) equal to
    segment_flags_plain in both modes on the rows, on tails of them and on
    columns viewed at a 1-element offset."""
    import torch
    ok = True
    for c, (words, order) in keys.items():
        srt = tuple(w[order.long()] for w in words)
        for m in (srt[0].shape[0], 1, 2047, 2049, 100003):
            for off in (0, 1):
                if off + m > srt[0].shape[0]:
                    continue
                s = tuple(w[off:off + m] for w in srt)
                ok = ok and torch.equal(K.segment_flags(s),
                                        K.segment_flags_plain(s))
                u = tuple(w[off:off + m] for w in words)
                o = K.radix_sort_plain(u)
                got, ref = K.segment_flags(u, order=o), \
                    K.segment_flags_plain(u, order=o)
                ok = ok and torch.equal(got[1], ref[1]) and all(
                    torch.equal(a, b) for a, b in zip(got[0], ref[0]))
    big = torch.randint(0, 50, (2 ** 24 + 3,), device=dev,
                        dtype=torch.int32)
    o = K.radix_sort_plain((big,))
    got, ref = K.segment_flags((big,), order=o), \
        K.segment_flags_plain((big,), order=o)
    return ok and torch.equal(got[1], ref[1]) and torch.equal(got[0][0],
                                                              ref[0][0])


def check_k6(K, quals) -> float:
    """Max abs error of the K6 wrapper against tet_quality_plain on both
    modes; raises past the port's tolerances."""
    import torch
    err = 0.0
    for mode, a in quals.items():
        got, ref = K.tet_quality(*a), K.tet_quality_plain(*a)
        tol = dict(rtol=1e-4, atol=1e-5) if a[3] is not None else \
            dict(rtol=3e-5, atol=3e-6)
        torch.testing.assert_close(got, ref, **tol)
        err = max(err, float((got - ref).abs().max()))
    return err


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from parmmg_tpu_torch.ops import kernels as K
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    cs.phase_build()
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    libs = build(variants())
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    keys, quals = inputs(dev)
    rows = {}              # row -> {variant: (kernel, library, fn)}
    for (kern, name), lib in libs.items():
        try:
            if kern == "k8" and name == "prev":
                flags, gathered = prev_flags(lib)
                srt = {c: tuple(w[o.long()] for w in ws)
                       for c, (ws, o) in keys.items()}
                good = all(torch.equal(flags(srt[c]),
                                       K.segment_flags_plain(srt[c]))
                           for c in keys)
                fns = {}
                for c, (ws, o) in keys.items():
                    if "shuffled" not in c:
                        fns[f"K8 sorted {c}"] = lambda s=srt[c]: flags(s)
                    fns[f"K8 gathered {c}"] = (
                        lambda ws=ws, o64=o.long(): gathered(ws, o64))
                print(f"[check] k8 prev {'equal' if good else 'WRONG'}")
            elif kern == "k8":
                use(kern, lib)
                good = check_k8(K, keys, dev)
                print(f"[check] k8 {name} {'equal' if good else 'WRONG'} "
                      f"({K._fn('pm_segment_flags_rows')()} rows a thread)")
                fns = {}
                for c, (ws, o) in keys.items():
                    srt = tuple(w[o.long()] for w in ws)
                    if "shuffled" not in c:
                        fns[f"K8 sorted {c}"] = (
                            lambda s=srt: K.segment_flags(s))
                    fns[f"K8 gathered {c}"] = (
                        lambda ws=ws, o=o: K.segment_flags(ws, order=o))
            else:
                use(kern, lib)
                err = check_k6(K, quals)
                good = True
                print(f"[check] k6 {name} within tolerance (max abs err "
                      f"{err:.3g})")
                fns = {f"K6 {m}": (lambda a=a: K.tet_quality(*a))
                       for m, a in quals.items()}
        except Exception as ex:     # a variant that faults is dropped
            print(f"[check] {kern} {name}: {ex}")
            good = False
        if good:
            for r, fn in fns.items():
                rows.setdefault(r, {})[name] = (kern, lib, fn)
    torch.cuda.synchronize()
    res: dict = {}
    for turn in range(2):
        for r, vs in rows.items():
            names = list(vs) if turn == 0 else list(vs)[::-1]
            for name in names:
                kern, lib, fn = vs[name]
                if (kern, name) != ("k8", "prev"):   # it calls its own
                    use(kern, lib)
                bm = batch_ms(fn)
                dms, nl = cs._device_ms(fn, None)
                res.setdefault((r, name), []).append(bm)
                print(f"[turn {turn + 1}] {r:32s} {name:7s} graph batch ms "
                      f"{bm:.5f}, profiler device ms {dms}, device launches "
                      f"{nl:g} a call", flush=True)
    fail = False
    for r, vs in rows.items():
        new = "vec8" if r.startswith("K8") else "t1"
        if "prev" not in vs or new not in vs:
            print(f"[verdict] {r}: the committed kernel or the previous one "
                  "is missing")
            fail = True
            continue
        base = res[(r, "prev")]
        parts = [f"{n} {min(res[(r, n)]):.5f}-{max(res[(r, n)]):.5f} "
                 f"({min(res[(r, n)]) / min(base):.3f}x prev)" for n in vs]
        at_or_below = all(x <= y for x, y in zip(res[(r, new)], base))
        fail = fail or not at_or_below
        print(f"[verdict] {r}: batch ms best-worst of 2 turns: "
              f"{'; '.join(parts)}; {new} at or below prev in every turn: "
              f"{at_or_below}")
    print(cs._card_line())
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
