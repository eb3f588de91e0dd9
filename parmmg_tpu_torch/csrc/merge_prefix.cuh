// Inclusive int32 prefix sum on the card, shared by merge_prefix.cu (the
// standalone K5 entry point) and radix_sort.cu (K7's scatter offsets).
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:merge_prefix_pallas
// (_prefix_kernel), which carries the running block total across the TPU's
// sequential grid in SMEM.  A CUDA grid has no order, so this is a
// scan-then-propagate in three launches:
//   1. prefix_block_kernel: each block scans its TILE of 1024 elements
//      (4 consecutive items per thread, warp shuffles, one shared word per
//      warp) and writes the block total;
//   2. prefix_totals_kernel: one block scans the block totals into
//      exclusive carries, 256 at a time with a running carry;
//   3. prefix_add_kernel: every block adds its carry.
// Adds are done in uint32 (wrap-around, as torch.cumsum(dtype=int32) and
// jnp.cumsum do in int32), and integer addition is associative, so the
// result equals cumsum bit for bit in any block order.
//
// Bound on the card: bytes.  x is read once and the result written once
// (8 bytes an element); launches 1 and 3 touch each element again (another
// 8 bytes), so the design moves about twice the bound's bytes.  At the
// main path's sizes (10^5-10^6 elements) the three launches, not the bytes,
// set the time.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace pm_scan {
namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ unsigned warp_inclusive(unsigned v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive scan of one value per thread over the block; *total gets the
// block sum.  s_warp is shared scratch of WARPS + 1 words; the trailing
// barrier lets the caller call again at once.
__device__ __forceinline__ unsigned block_exclusive(unsigned v,
                                                    unsigned* s_warp,
                                                    unsigned* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const unsigned incl = warp_inclusive(v, lane);
  if (lane == 31) s_warp[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const unsigned w = lane < WARPS ? s_warp[lane] : 0u;
    const unsigned wi = warp_inclusive(w, lane);
    if (lane < WARPS) s_warp[lane] = wi - w;
    if (lane == WARPS - 1) s_warp[WARPS] = wi;
  }
  __syncthreads();
  const unsigned excl = s_warp[wid] + incl - v;
  *total = s_warp[WARPS];
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(THREADS)
prefix_block_kernel(const int* __restrict__ x, int* __restrict__ out,
                    int* __restrict__ totals, long long n) {
  __shared__ unsigned s[TILE];
  __shared__ unsigned s_warp[WARPS + 1];
  const long long base = (long long)blockIdx.x * TILE;
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k * THREADS + threadIdx.x;
    s[k * THREADS + threadIdx.x] = i < n ? (unsigned)x[i] : 0u;
  }
  __syncthreads();
  unsigned loc[ITEMS];
  unsigned run = 0;
  for (int k = 0; k < ITEMS; ++k) {
    run += s[threadIdx.x * ITEMS + k];
    loc[k] = run;
  }
  unsigned tot;
  const unsigned ex = block_exclusive(run, s_warp, &tot);
  for (int k = 0; k < ITEMS; ++k) s[threadIdx.x * ITEMS + k] = loc[k] + ex;
  __syncthreads();
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k * THREADS + threadIdx.x;
    if (i < n) out[i] = (int)s[k * THREADS + threadIdx.x];
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = (int)tot;
}

__global__ void __launch_bounds__(THREADS)
prefix_totals_kernel(int* __restrict__ totals, int nb) {
  __shared__ unsigned s_warp[WARPS + 1];
  unsigned carry = 0;
  for (int start = 0; start < nb; start += THREADS) {
    const int i = start + threadIdx.x;
    const unsigned v = i < nb ? (unsigned)totals[i] : 0u;
    unsigned tot;
    const unsigned ex = block_exclusive(v, s_warp, &tot);
    if (i < nb) totals[i] = (int)(carry + ex);
    carry += tot;
  }
}

__global__ void __launch_bounds__(THREADS)
prefix_add_kernel(int* __restrict__ out, const int* __restrict__ carry,
                  long long n) {
  if (blockIdx.x == 0) return;
  const long long base = (long long)blockIdx.x * TILE;
  const unsigned c = (unsigned)carry[blockIdx.x];
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k * THREADS + threadIdx.x;
    if (i < n) out[i] = (int)((unsigned)out[i] + c);
  }
}

// out[i] = x[0] + ... + x[i] (int32, wrapping).  totals: scratch of
// ceil(n / TILE) ints.  Launches on `s`, does not synchronise.
inline cudaError_t inclusive_scan(const int* x, int* out, int* totals,
                                  long long n, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const long long nb = (n + TILE - 1) / TILE;
  if (nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  prefix_block_kernel<<<(unsigned)nb, THREADS, 0, s>>>(x, out, totals, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nb == 1) return e;
  prefix_totals_kernel<<<1, THREADS, 0, s>>>(totals, (int)nb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  prefix_add_kernel<<<(unsigned)nb, THREADS, 0, s>>>(out, totals, n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pm_scan
