// K2: anisotropic metric edge length with the endpoint gathers folded in.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:edge_length_ani_pallas
// (_len_ani_kernel): per edge e = p1 - p0, the endpoint quadratic forms
// q_i = e^T M_i e of the packed tensors (m11, m12, m13, m22, m23, m33),
// l_i = sqrt(max(q_i, 0)) and l = 2/3 (l0^2 + l0 l1 + l1^2) / max(l0 + l1,
// EPSD).  The TPU version left the endpoint gathers and the index clip of
// ops/edges.py:edge_lengths to XLA, which wrote [capE, 3] and [capE, 6]
// endpoint rows to memory before the kernel read them back; here they are
// folded in, so the edge table's (a, b) ids are read once and no endpoint
// row reaches device memory.  max(q, 0) keeps a NaN form NaN, as
// torch.clamp and jnp.maximum do (fmaxf alone would make it 0).
//
// Bound on the card: bytes.  Per row it reads 8 bytes of ids and writes 4;
// the endpoint rows (12 bytes of point, 24 of tensor) are gathers that
// mostly hit L2 (vert + met6 of a 100k-point mesh take 3.6 MB), so they are
// counted once per point.  Least time = (12 * capE + 36 * capP) bytes /
// 3.35 TB/s.
//
// The rows are the 6 capT sorted slot keys of ops/edges.py:unique_edges,
// not unique edges: every tet around an edge gives a row with the same
// (a, b), so rows come in runs of ~5-6, and the dead slots form one run of
// (INT32_MAX, INT32_MAX) at the end; the tensor path's calls evaluate
// 7-21% of their rows (heads).  The kernel before evaluated every row: two
// 4-byte id loads, 18 scalar endpoint gathers and a scalar store a row.
// Design: rows go in groups of 4 (two 16-byte id loads, one float4 store),
// kRows / 4 groups a thread, a warp's lanes on neighbouring groups, so
// every access of a warp is one contiguous run.  A row whose clipped
// (i0, i1) equals the row before it (the lane before's last row comes by
// __shfl_up_sync) is not a head.  The warp ranks its heads (__ballot_sync),
// writes their ids to shared memory, and its 32 lanes evaluate them in
// turn, so a live warp-chunk of 128 rows (~25 heads) costs one round of
// gathers and arithmetic; every row then reads its run's head value from
// shared memory.  Equal ids give equal bits, so this holds on any input,
// sorted or not; only the savings depend on the sort.  The tensor rows
// are read as three float2 (a 24-byte row is 8-byte aligned when the base
// is), the points as three floats, both through the read-only path.
// Tails, and an id table or a tensor table that is not aligned for the
// vector loads (a view at an element offset), take scalar loads in the
// same kernel.  One launch a call, a full grid, no scratch, 32 registers
// (8 blocks an SM).  The arithmetic is the previous kernel's, in one
// function (the form summed in the Pallas kernel's order, the multiply-adds
// contracted by nvcc alike), so every row keeps its bits, but where a NaN
// form made it 0.
//
// Chosen by tools/k2_variants.py (CUDA-graph replays of 50 calls, warm and
// cold, NVIDIA H100 80GB HBM3 at 700 W; the numbers in PERF.md).  The
// gathers cost latency and occupancy more than load instructions: an
// endpoint's rows in two loads each instead of three (a float2 and a float,
// a float4 and a float2, split by the id's parity) took 44 registers and
// was 5-16% slower.  4 rows a thread beat 2 (1.2x) and 8 (54 registers,
// 8-13% slower but on the path's median call warm), sharing the warp's
// heads beat each lane evaluating its own (4 predicated rounds, 18-20%
// slower), runs carried across lanes saved 10-14%, and evaluating every
// row was slower than the kernel before (1.1-1.4x).  Capped grids were
// within -5% / +7%, plain-load gathers within 1%, scalar tensor loads
// 3-5% slower; evict-first ids and stores were 13% faster warm on 3.5M
// rows and 19% slower warm on the median call (its ids stay in L2).
// Against the kernel before: 0.77x warm / 0.74x cold on the 3,538,944
// rows of chip_smoke.py's fixture, 0.77x / 0.78x on the path's median
// call (1,769,472 rows).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;            // rows a thread: 2, 4 or 8
constexpr bool kReuse = true;       // one evaluation a run of equal rows
constexpr bool kCrossLane = true;   // runs carried across lanes (else a
                                    // lane's first row of a group is a head)
constexpr bool kCompact = true;     // the warp's lanes share its heads (else
                                    // each lane evaluates its own)
constexpr bool kLdg = true;         // endpoint gathers by ld.global.nc
constexpr bool kMetVec = true;      // tensor rows as three float2
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = kRows < 4 ? kRows : 4;   // rows a group
constexpr int kGroups = kRows / kGroup;         // groups a thread
constexpr int kChunk = 32 * kRows;              // rows a warp-chunk
constexpr int kWarps = kThreads / 32;
constexpr float kEpsd = 1e-30f;

template <typename T>
__device__ __forceinline__ T gather(const T* p) {
  if (kLdg) return __ldg(p);
  return *p;
}

__device__ __forceinline__ float quad(const float* m, float x, float y,
                                      float z) {
  return m[0] * x * x + m[3] * y * y + m[5] * z * z +
         2.0f * (m[1] * x * y + m[2] * x * z + m[4] * y * z);
}

// point row i: three floats
__device__ __forceinline__ void point(const float* __restrict__ vert, int i,
                                      float* p) {
  const float* q = vert + 3 * (long long)i;
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = gather(q + k);
}

// tensor row i: three float2 where met6 is 8-byte aligned (vec), else six
// floats
__device__ __forceinline__ void tensor(const float* __restrict__ met6,
                                       int i, bool vec, float* m) {
  const float* p = met6 + 6 * (long long)i;
  if (vec) {
    const float2* q = reinterpret_cast<const float2*>(p);
    const float2 a = gather(q), b = gather(q + 1), c = gather(q + 2);
    m[0] = a.x; m[1] = a.y; m[2] = b.x; m[3] = b.y; m[4] = c.x; m[5] = c.y;
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) m[k] = gather(p + k);
  }
}
// end of the endpoint loads

// sqrt(max(q, 0)), a NaN form staying NaN
__device__ __forceinline__ float root(float q) {
  return sqrtf(q != q ? q : fmaxf(q, 0.0f));
}

// the metric length of edge (i0, i1), clipped ids
__device__ __forceinline__ float length(const float* __restrict__ vert,
                                        const float* __restrict__ met6,
                                        int i0, int i1, bool met_vec) {
  float p0[3], p1[3], m0[6], m1[6];
  point(vert, i0, p0);
  point(vert, i1, p1);
  tensor(met6, i0, met_vec, m0);
  tensor(met6, i1, met_vec, m1);
  const float x = p1[0] - p0[0];
  const float y = p1[1] - p0[1];
  const float z = p1[2] - p0[2];
  const float l0 = root(quad(m0, x, y, z));
  const float l1 = root(quad(m1, x, y, z));
  const float s = fmaxf(l0 + l1, kEpsd);
  return (2.0f / 3.0f) * (l0 * l0 + l0 * l1 + l1 * l1) / s;
}

__global__ void __launch_bounds__(kThreads)
edge_length_ani_kernel(const float* __restrict__ vert,
                       const float* __restrict__ met6,
                       const int* __restrict__ ev, float* __restrict__ out,
                       int capP, long long n, long long nchunks, bool ev_vec,
                       bool out_vec, bool met_vec) {
  __shared__ int2 sid[kCompact ? kWarps : 1][kCompact ? kChunk : 1];
  __shared__ float sval[kWarps][kChunk];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long nwarps = (long long)gridDim.x * kWarps;
  // warp-chunk c holds rows kChunk c .. kChunk (c + 1) - 1: group j of lane
  // L the kGroup rows from kChunk c + kGroup (32 j + L), so the chunk's row
  // order is (j, L, s)
  for (long long c = (long long)blockIdx.x * kWarps + w; c < nchunks;
       c += nwarps) {
    int a[kRows], b[kRows];
    bool ok[kRows];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const long long r0 = c * kChunk + (long long)kGroup * (32 * j + lane);
      if (ev_vec && r0 + kGroup <= n) {
        const int4* p = reinterpret_cast<const int4*>(ev + 2 * r0);
#pragma unroll
        for (int h = 0; h < kGroup / 2; ++h) {
          const int4 q = __ldg(p + h);
          const int k = j * kGroup + 2 * h;
          a[k] = q.x; b[k] = q.y; a[k + 1] = q.z; b[k + 1] = q.w;
          ok[k] = ok[k + 1] = true;
        }
      } else {
#pragma unroll
        for (int s = 0; s < kGroup; ++s) {
          const int k = j * kGroup + s;
          ok[k] = r0 + s < n;
          a[k] = ok[k] ? __ldg(ev + 2 * (r0 + s)) : 0;
          b[k] = ok[k] ? __ldg(ev + 2 * (r0 + s) + 1) : 0;
        }
      }
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const int k = j * kGroup + s;
        a[k] = min(max(a[k], 0), capP - 1);
        b[k] = min(max(b[k], 0), capP - 1);
      }
    }
    // heads: a row whose ids differ from the row before it in the chunk;
    // the chunk's first row is one.  rank[k]: the index among the chunk's
    // heads of the head of row k's run
    bool hd[kRows];
    int rank[kRows];
    int nheads = 0;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int e = j * kGroup + kGroup - 1;    // the group's last row
      int pa = __shfl_up_sync(kFull, a[e], 1);
      int pb = __shfl_up_sync(kFull, b[e], 1);
      if (j > 0) {                 // lane 0: lane 31's group before
        const int qa = __shfl_sync(kFull, a[e - kGroup], 31);
        const int qb = __shfl_sync(kFull, b[e - kGroup], 31);
        if (lane == 0) { pa = qa; pb = qb; }
      }
      int before = nheads;
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const int k = j * kGroup + s;
        if (s > 0) { pa = a[k - 1]; pb = b[k - 1]; }
        const bool first = s == 0 && ((j == 0 && lane == 0) || !kCrossLane);
        hd[k] = ok[k] && (!kReuse || first || a[k] != pa || b[k] != pb);
        const unsigned m = __ballot_sync(kFull, hd[k]);
        nheads += __popc(m);
        before += __popc(m & below);
      }
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const int k = j * kGroup + s;
        before += hd[k] ? 1 : 0;
        rank[k] = before - 1;
      }
    }
    if constexpr (kCompact) {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (hd[k]) sid[w][rank[k]] = make_int2(a[k], b[k]);
      __syncwarp();
      for (int t = lane; t < nheads; t += 32) {
        const int2 q = sid[w][t];
        sval[w][t] = length(vert, met6, q.x, q.y, met_vec);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (hd[k]) sval[w][rank[k]] = length(vert, met6, a[k], b[k], met_vec);
    }
    __syncwarp();
    float v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) v[k] = sval[w][rank[k]];
    __syncwarp();                  // before the next chunk writes sval
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const long long r0 = c * kChunk + (long long)kGroup * (32 * j + lane);
      const float* g = v + j * kGroup;
      if (out_vec && r0 + kGroup <= n) {
        if constexpr (kGroup == 4)
          *reinterpret_cast<float4*>(out + r0) =
              make_float4(g[0], g[1], g[2], g[3]);
        else
          *reinterpret_cast<float2*>(out + r0) = make_float2(g[0], g[1]);
      } else {
#pragma unroll
        for (int s = 0; s < kGroup; ++s)
          if (ok[j * kGroup + s]) out[r0 + s] = g[s];
      }
    }
  }
}

}  // namespace

extern "C" int pm_edge_lengths_ani(const float* vert, const float* met6,
                                   const int* ev, float* out, int capP,
                                   long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out % 4 || (uintptr_t)ev % 4 || (uintptr_t)met6 % 4 ||
      (uintptr_t)vert % 4)
    return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  const long long nchunks = (n + kChunk - 1) / kChunk;
  const long long blocks = (nchunks + kWarps - 1) / kWarps;
  const bool ev_vec = (uintptr_t)ev % 16 == 0;
  const bool out_vec = (uintptr_t)out % (4 * kGroup) == 0;
  const bool met_vec = kMetVec && (uintptr_t)met6 % 8 == 0;
  edge_length_ani_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      vert, met6, ev, out, capP, n, nchunks, ev_vec, out_vec, met_vec);
  return (int)cudaGetLastError();
}
