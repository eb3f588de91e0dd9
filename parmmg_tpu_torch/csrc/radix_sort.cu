// K7: stable LSD radix sort permutation of 1-3 int32 key words.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:radix_sort_pallas (its per-pass
// kernel _radix_pass_kernel).  The logical key is the words' tuple, major
// word first; each word is ordered as uint32 and sorted in 8-bit digit
// passes, minor word first, shifts range(0, nbits, 8).  A word declared
// with nbits < 31 has its INT32_MAX tombstones remapped to 2^nbits - 1
// (every valid value is smaller), so a 16-bit word costs 2 passes, not 4.
// The result is the permutation a chain of stable sorts gives, bit for bit.
//
// The Pallas pass carries the stable ranks across the TPU's sequential
// grid.  A CUDA grid has no order, so each pass is three launches:
//   1. radix_hist_kernel: every block counts the digits of its tile of
//      RTILE = 2048 positions (gathering key[order_in[i]]) in shared memory
//      with integer atomics and writes them digit-major, block-minor;
//   2. the K5 scan (merge_prefix.cuh) over that histogram gives every
//      (digit, block) its first output slot;
//   3. radix_scatter_kernel: every block walks its tile in position order,
//      256 items a round; __match_any_sync + __popc(peers & lanes below)
//      rank an item among the warp's items of the same digit, a per-digit
//      scan over the 8 warps' counts orders the warps, and a per-digit
//      running count carries the rounds, so equal digits keep their order.
// The ragged last tile is masked (no 0xFFFFFFFF padding, which only the
// TPU's tiling needed).  One C call runs every pass on the caller's stream.
//
// Bound on the card: bytes.  The function must read its key words once and
// write the permutation (4 bytes per word and 4 per element).  Each pass of
// this design reads order_in twice, gathers the key twice and writes
// order_out (about 20 bytes an element a pass, 4-6 passes on the main
// path); the scatter writes land 256 ways apart.  The passes are what a
// later, faster version (one-sweep with decoupled look-back) would fuse.
#include "merge_prefix.cuh"

namespace {

constexpr int RT = 256;              // threads per block == radix
constexpr int RITEMS = 8;            // rounds per tile
constexpr int RTILE = RT * RITEMS;   // positions per block
constexpr int RADIX = 256;
constexpr int RWARPS = RT / 32;

__device__ __forceinline__ unsigned key_digit(const int* __restrict__ word,
                                              int src, int bits, int shift) {
  unsigned k = (unsigned)word[src];
  if (bits < 31 && k == 0x7fffffffu) k = (1u << bits) - 1u;
  return (k >> shift) & 0xFFu;
}

__global__ void __launch_bounds__(RT)
radix_hist_kernel(const int* __restrict__ word,
                  const int* __restrict__ order_in, int bits, int shift,
                  int* __restrict__ hist, long long n, int nblocks) {
  __shared__ int h[RADIX];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * RTILE;
  for (int r = 0; r < RITEMS; ++r) {
    const long long i = base + r * RT + threadIdx.x;
    if (i < n) {
      const int src = order_in ? order_in[i] : (int)i;
      atomicAdd(&h[key_digit(word, src, bits, shift)], 1);
    }
  }
  __syncthreads();
  hist[(long long)threadIdx.x * nblocks + blockIdx.x] = h[threadIdx.x];
}

__global__ void __launch_bounds__(RT)
radix_scatter_kernel(const int* __restrict__ word,
                     const int* __restrict__ order_in, int bits, int shift,
                     const int* __restrict__ hist,
                     const int* __restrict__ incl,
                     int* __restrict__ order_out, long long n, int nblocks) {
  __shared__ int base_s[RADIX];
  __shared__ int wc[RWARPS][RADIX];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  const long long h = (long long)t * nblocks + blockIdx.x;
  base_s[t] = incl[h] - hist[h];           // exclusive offset of digit t
  for (int w = 0; w < RWARPS; ++w) wc[w][t] = 0;
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  const long long tile = (long long)blockIdx.x * RTILE;
  for (int r = 0; r < RITEMS; ++r) {
    const long long i = tile + r * RT + t;
    const bool ok = i < n;
    int src = 0;
    unsigned d = RADIX;                    // masked items share a dummy digit
    if (ok) {
      src = order_in ? order_in[i] : (int)i;
      d = key_digit(word, src, bits, shift);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & below);
    if (ok && lane == __ffs(peers) - 1) wc[wid][d] = __popc(peers);
    __syncthreads();
    int run = 0;                           // thread t scans digit t's warps
    for (int w = 0; w < RWARPS; ++w) {
      const int c = wc[w][t];
      wc[w][t] = run;
      run += c;
    }
    __syncthreads();
    if (ok) order_out[base_s[d] + wc[wid][d] + rank] = src;
    __syncthreads();
    base_s[t] += run;
    for (int w = 0; w < RWARPS; ++w) wc[w][t] = 0;
    __syncthreads();
  }
}

}  // namespace

extern "C" int pm_radix_tile() { return RTILE; }
extern "C" int pm_radix_scan_tile() { return pm_scan::TILE; }

// Sort permutation of n rows by (w0, w1, w2)[:nwords], major first.
// out, tmp: [n] int32; hist, incl: [256 * ceil(n / RTILE)] int32; totals:
// [ceil(256 * ceil(n / RTILE) / scan tile)] int32.  Runs sum over words of
// ceil(nbits / 8) passes, each with one K5 scan; does not synchronise.
extern "C" int pm_radix_sort(const int* w0, const int* w1, const int* w2,
                             int nwords, int b0, int b1, int b2, int* out,
                             int* tmp, int* hist, int* incl, int* totals,
                             long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL || nwords < 1 || nwords > 3)
    return (int)cudaErrorInvalidValue;
  const int* words[3] = {w0, w1, w2};
  const int bits[3] = {b0, b1, b2};
  int npass = 0;
  for (int j = 0; j < nwords; ++j) {
    if (bits[j] < 1 || bits[j] > 32) return (int)cudaErrorInvalidValue;
    npass += (bits[j] + 7) / 8;
  }
  const long long nblocks = (n + RTILE - 1) / RTILE;
  const long long m = (long long)RADIX * nblocks;
  const int* in = nullptr;                 // pass 0 reads positions
  int k = 0;
  for (int j = nwords - 1; j >= 0; --j) {  // LSD: minor word first
    for (int shift = 0; shift < bits[j]; shift += 8, ++k) {
      int* dst = ((npass - 1 - k) % 2 == 0) ? out : tmp;
      radix_hist_kernel<<<(unsigned)nblocks, RT, 0, s>>>(
          words[j], in, bits[j], shift, hist, n, (int)nblocks);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      e = pm_scan::inclusive_scan(hist, incl, totals, m, s);
      if (e != cudaSuccess) return (int)e;
      radix_scatter_kernel<<<(unsigned)nblocks, RT, 0, s>>>(
          words[j], in, bits[j], shift, hist, incl, dst, n, (int)nblocks);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      in = dst;
    }
  }
  return 0;
}
