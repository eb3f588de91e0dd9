// K6: tet quality ALPHA * vol * sqrt(det Mbar) / (sum of squared edge
// lengths in Mbar)^1.5, clamped to <= 1 (<= 0 when inverted), 0 on dead
// tets; Mbar is the mean of the corners' metrics (tensor mode) or the
// identity (iso mode).  Iso and tensor modes are one template.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:quality_pallas (_qual_kernel),
// which ops/quality.py:tet_quality feeds.  The TPU version received the
// corner coordinates [N,4,3] (and the tet-mean metric [N,6]) already gathered
// by XLA; here the kernel gathers the corners itself from vert/tet (and
// met6), so the [capT,4,3] coordinate array never reaches device memory.
//
// Bound on the card: bytes.  Per tet it reads 16 bytes of ids and 1 byte of
// mask and writes 4; each point row (12 bytes, and 24 of metric in tensor
// mode) is read at least once: least time = (21 * capT + 12 * capP
// (+ 24 * capP tensor)) bytes / 3.35 TB/s (0.0015 ms iso at capT 220,992,
// 0.0034 ms tensor at capT 407,648).  Arithmetic: ~70 (iso) / ~160
// (tensor) float32 operations a tet, far below the card's float32 peak.
//
// Design: at these sizes the kernel is about one wave of blocks, so its
// time is the launch ramp plus the chain of dependent loads each tet waits
// on: the mask byte, then the ids, then the corners.  One thread takes one
// tet, over a full grid.  The mask byte is read first and a dead tet
// writes 0 and loads nothing else; the four ids come in one 16-byte load
// ([capT, 4] int32 rows are 16-byte aligned: the wrapper checks); the
// corner rows (and the 24-byte metric rows, as three 8-byte loads) come
// through the read-only path; rap^1.5 is rap * sqrtf(rap).
//
// Measured by chip_smoke.py in the proof run of PERF.md's kernel table
// (its chip call 14; NVIDIA H100 80GB HBM3, 700.00 W), on the paths'
// output meshes (device ms a call, warm L2; share of the bound): iso [capT
// 220,992] 0.0041 ms, 37%; tensor [capT 407,648] 0.0134 ms, 25%.  On a
// structured cube mesh of the same capacities the same kernel takes 0.0025
// / 0.0063 ms (the profiler in tools/k6_k8_variants.py, same call), so
// what holds it on the paths is the corner gathers in the mesh's own
// order: each 12-byte point row and 24-byte metric row costs one or two
// 32-byte L2 sectors.  Only a mesh numbered for locality removes that.  None
// of the tool's variants (two tets a thread, a grid capped at 6 or 4
// blocks an SM, powf, six 4-byte metric loads, L2-only loads, no loop) was
// faster on every row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEpsd = 1e-30f;
constexpr float kAlpha = 124.70765814495915f;  // 36 * sqrt(12)
constexpr int THREADS = 256;

__device__ __forceinline__ float pow15(float x) { return x * sqrtf(x); }

template <bool ANISO>
__device__ __forceinline__ float quality(const float (&x)[4],
                                         const float (&y)[4],
                                         const float (&z)[4],
                                         const float (&m)[6]) {
  const float d1x = x[1] - x[0], d1y = y[1] - y[0], d1z = z[1] - z[0];
  const float d2x = x[2] - x[0], d2y = y[2] - y[0], d2z = z[2] - z[0];
  const float d3x = x[3] - x[0], d3y = y[3] - y[0], d3z = z[3] - z[0];
  const float cx = d2y * d3z - d2z * d3y;
  const float cy = d2z * d3x - d2x * d3z;
  const float cz = d2x * d3y - d2y * d3x;
  const float vol = (d1x * cx + d1y * cy + d1z * cz) / 6.0f;
  const float M11 = 0.25f * m[0], M12 = 0.25f * m[1], M13 = 0.25f * m[2];
  const float M22 = 0.25f * m[3], M23 = 0.25f * m[4], M33 = 0.25f * m[5];
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
  const float q = num / pow15(fmaxf(rap, kEpsd));
  return vol > 0.0f ? fminf(q, 1.0f) : fminf(q, 0.0f);
}

template <bool ANISO>
__global__ void __launch_bounds__(THREADS)
    tet_quality_kernel(const float* __restrict__ vert,
                       const int4* __restrict__ tet,
                       const uint8_t* __restrict__ tmask,
                       const float* __restrict__ met6,
                       float* __restrict__ out, int capP, long long n) {
  // The grid covers n, so the loop runs once a thread.  Written so, with
  // the ids loaded before the corners' branch, ptxas issues a tensor tet's
  // 24 corner and metric loads back to back in two runs; the same body
  // without the loop interleaves more of them with the sums and runs
  // slower on scattered meshes (the "flat" variant of
  // tools/k6_k8_variants.py).
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < n;
       t += (long long)gridDim.x * THREADS) {
    // the mask byte first: a dead tet loads nothing else
    const bool live = __ldg(tmask + t) != 0;
    int4 ids;
    if (live) ids = __ldg(tet + t);
    float x[4], y[4], z[4], m[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      const int id[4] = {ids.x, ids.y, ids.z, ids.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = min(max(id[c], 0), capP - 1);
        const float* p = vert + 3 * (long long)v;
        x[c] = __ldg(p);
        y[c] = __ldg(p + 1);
        z[c] = __ldg(p + 2);
        if (ANISO) {
          const float2* r =
              reinterpret_cast<const float2*>(met6 + 6 * (long long)v);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float2 a = __ldg(r + k);
            m[2 * k] += a.x;
            m[2 * k + 1] += a.y;
          }
        }
      }
    }
    out[t] = live ? quality<ANISO>(x, y, z, m) : 0.0f;
  }
}

}  // namespace

// tet: [n, 4] int32, 16-byte aligned; met6 (tensor mode, else null):
// [capP, 6] float32, 8-byte aligned.
extern "C" int pm_tet_quality(const float* vert, const int* tet,
                              const uint8_t* tmask, const float* met6,
                              float* out, int capP, long long n,
                              void* stream) {
  if (n <= 0) return 0;
  if ((uintptr_t)tet % 16 || (uintptr_t)met6 % 8)
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (n + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  const int4* t4 = reinterpret_cast<const int4*>(tet);
  if (met6 != nullptr) {
    tet_quality_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        vert, t4, tmask, met6, out, capP, n);
  } else {
    tet_quality_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        vert, t4, tmask, met6, out, capP, n);
  }
  return (int)cudaGetLastError();
}
