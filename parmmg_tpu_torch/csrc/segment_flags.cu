// K8: segment-start flags over sorted key columns: flag[i] is true iff
// i == 0 or any of the 1-3 words differs from row i - 1.  In its gathered
// mode the kernel first gathers the columns through a sort's permutation
// (row i is word[order[i]]), writes those sorted columns, and flags them.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:segment_flags_pallas
// (_seg_kernel), which carries the previous block's last row across the
// TPU's sequential grid in SMEM; the gathered mode also takes the place of
// the XLA gather the JAX package runs just before it (key[order]).  No
// carry is needed here: each thread finds its predecessor row itself, so
// blocks run in any order.
//
// Bound on the card: bytes.  Sorted mode reads 4n a word and writes n
// flags: (4 * nwords + 1) * n bytes / 3.35 TB/s (0.0020 ms at 1,325,952
// one-word rows).  Gathered mode reads the permutation (4n) and each word
// once (4n a word), writes the sorted words (4n a word) and the flags (n):
// (4 + 8 * nwords + 1) * n bytes.
//
// Design: a block takes a tile of 256 threads x 8 rows, a thread 8
// consecutive rows.  The thread loads its rows of each word (and, gathered,
// of the permutation) as 16-byte vectors, takes the row before its first
// from the previous lane by __shfl_up_sync (lane 0 loads it itself), and
// writes its 8 flags in one 8-byte store (and, gathered, the sorted rows
// as 16-byte vectors).  A thread whose rows run past n, or a call whose
// columns are not 16-byte aligned (a view at an odd offset), takes the
// scalar path of the same kernel.  The grid covers n with no cap.  (16 rows
// a thread and the scalar path alone are variants that
// tools/k6_k8_variants.py times; both were slower.)
//
// Measured by chip_smoke.py in the proof run of PERF.md's kernel table
// (its chip call 14; NVIDIA H100 80GB HBM3, 700.00 W), on the iso path's
// output mesh (device ms a call, warm L2; share of the bound): sorted edge
// keys [1,325,952] 0.0023 ms, 86%; sorted face keys (2 words) [883,968]
// 0.0026 ms, 91%; gathered edge keys 0.0070 ms, 73%; gathered face keys
// 0.0085 ms, 65%.  The gathered mode's random gathers fetch a 32-byte
// sector for each 4-byte key, which the byte bound does not count.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 8;  // rows a thread
constexpr unsigned FULL = 0xffffffffu;

struct Cols {
  const int* w[3];
};
struct OutCols {
  int* w[3];
};

// rows r0 .. r0 + ROWS - 1 of a column (0 past n)
__device__ __forceinline__ void load_rows(const int* __restrict__ p,
                                          long long r0, long long n,
                                          bool vec, int (&v)[ROWS]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < ROWS; k += 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(p + r0 + k));
      v[k] = q.x;
      v[k + 1] = q.y;
      v[k + 2] = q.z;
      v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) v[k] = r0 + k < n ? __ldg(p + r0 + k) : 0;
  }
}

__device__ __forceinline__ void store_rows(int* __restrict__ p, long long r0,
                                           long long n, bool vec,
                                           const int (&v)[ROWS]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < ROWS; k += 4)
      *reinterpret_cast<int4*>(p + r0 + k) =
          make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      if (r0 + k < n) p[r0 + k] = v[k];
  }
}

template <int NW, bool GATHER>
__global__ void __launch_bounds__(THREADS)
    segment_flags_kernel(Cols in, const int* __restrict__ order, OutCols out,
                         uint8_t* __restrict__ flags, long long n,
                         bool aligned) {
  const long long r0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * ROWS;
  const bool live = r0 < n;
  const bool vec = aligned && r0 + ROWS <= n;
  int v[NW][ROWS];
  int o[ROWS];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int k = 0; k < ROWS; ++k) v[j][k] = 0;
  if (live) {
    if (GATHER) {
      load_rows(order, r0, n, vec, o);
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        o[k] = min(max(o[k], 0), (int)(n - 1));  // in range, whatever given
#pragma unroll
      for (int j = 0; j < NW; ++j) {
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
          if (r0 + k < n) v[j][k] = __ldg(in.w[j] + o[k]);
        store_rows(out.w[j], r0, n, vec, v[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) load_rows(in.w[j], r0, n, vec, v[j]);
    }
  }
  // row r0 - 1 is the previous lane's last row; lane 0 loads it
  int prev[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) prev[j] = __shfl_up_sync(FULL, v[j][ROWS - 1], 1);
  if ((threadIdx.x & 31) == 0 && live && r0 > 0) {
    const long long src =
        GATHER ? (long long)min(max(__ldg(order + r0 - 1), 0), (int)(n - 1))
               : r0 - 1;
#pragma unroll
    for (int j = 0; j < NW; ++j) prev[j] = __ldg(in.w[j] + src);
  }
  if (!live) return;
  uint32_t packed[ROWS / 4];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    bool d = r0 + k == 0;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      d = d || v[j][k] != (k == 0 ? prev[j] : v[j][k - 1]);
    if (k % 4 == 0) packed[k / 4] = 0;
    packed[k / 4] |= (uint32_t)d << (8 * (k % 4));
  }
  if (vec) {
    *reinterpret_cast<uint2*>(flags + r0) = make_uint2(packed[0], packed[1]);
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      if (r0 + k < n) flags[r0 + k] = (packed[k / 4] >> (8 * (k % 4))) & 1u;
  }
}

template <int NW>
cudaError_t launch(Cols in, const int* order, OutCols out, uint8_t* flags,
                   long long n, bool aligned, cudaStream_t s) {
  const long long blocks = (n + (long long)THREADS * ROWS - 1) /
                           ((long long)THREADS * ROWS);
  if (order != nullptr)
    segment_flags_kernel<NW, true><<<(unsigned)blocks, THREADS, 0, s>>>(
        in, order, out, flags, n, aligned);
  else
    segment_flags_kernel<NW, false><<<(unsigned)blocks, THREADS, 0, s>>>(
        in, order, out, flags, n, aligned);
  return cudaGetLastError();
}

bool aligned_to(const void* p, uintptr_t a) {
  return p == nullptr || ((uintptr_t)p % a) == 0;
}

}  // namespace

// Rows a thread (the tile is 256 of them).
extern "C" int pm_segment_flags_rows() { return ROWS; }

// Sorted mode (order == nullptr): flags over w0..w{nwords-1} as given.
// Gathered mode: row i of word j is wj[order[i]]; written to sj, then
// flagged.  One launch either way.
extern "C" int pm_segment_flags(const int* w0, const int* w1, const int* w2,
                                int nwords, const int* order, int* s0,
                                int* s1, int* s2, uint8_t* flags, long long n,
                                void* stream) {
  if (n <= 0) return 0;
  if (nwords < 1 || nwords > 3) return (int)cudaErrorInvalidValue;
  const Cols in = {{w0, w1, w2}};
  const OutCols out = {{s0, s1, s2}};
  bool aligned = aligned_to(flags, ROWS) && aligned_to(order, 16);
  for (int j = 0; j < nwords; ++j)
    aligned = aligned && aligned_to(in.w[j], 16) &&
              (order == nullptr || aligned_to(out.w[j], 16));
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (nwords) {
    case 1: e = launch<1>(in, order, out, flags, n, aligned, s); break;
    case 2: e = launch<2>(in, order, out, flags, n, aligned, s); break;
    default: e = launch<3>(in, order, out, flags, n, aligned, s); break;
  }
  return (int)e;
}
