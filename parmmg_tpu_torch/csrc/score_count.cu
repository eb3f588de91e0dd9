// K3 / K4: candidate scoring for a wave's top-k cut: out = mask ? -v : -inf,
// plus the exact int32 count of the mask, in one launch.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:score_count_pallas
// (_score_kernel) and score3_count_pallas (_score_min3_kernel, where
// v = min(v0, min(v1, v2)) in that association, NaN propagating as in
// torch.minimum; a NaN score is the canonical NaN PyTorch's negation gives
// on the card, so the output is bit for bit the plain version's).  The
// Pallas count relied on the TPU's sequential grid (cnt += ... across grid
// steps).  A CUDA grid has no order: each block reduces its share and adds
// it, together with a ticket, to one 64-bit word with one atomic (the
// count in the low half, the blocks done in the high half); the block that
// finds all the others done writes the count and leaves the word at 0 for
// the next call.  No fence is needed: every add is to the one word.
// Integer sums, so the count is exact and independent of block order.  The
// word is scratch the wrapper keeps per stream (ops/kernels._scratch), so
// no cudaMemsetAsync is needed and two streams share nothing.
//
// Bound on the card: bytes.  The function needs the mask (1 byte a row), the
// output (4 bytes a row), the count and the values of the selected rows only
// (4 bytes a row for K3, 12 for K4): 5 n + 4 + 4 nsel (K3) or 12 nsel (K4)
// bytes / 3.35 TB/s.  On the path's masks nsel is 0.01-50% of n (PERF.md),
// so the mask and the output dominate.  Design: rows go in groups of 4 (16
// bytes of output, 4 bytes of mask), a thread takes kRows / 4 groups, a
// warp's lanes take neighbouring groups so that every access of the warp is
// one contiguous run: the 4 mask bytes of a group in one load, a group's
// values as one float4 an array only where one of its mask bytes is set (a
// masked-off group never touches its values' sectors, a dense one costs one
// vector load an array), no value code at all for a warp without a set
// byte (__ballot_sync), the output as one float4 store a group.  The rows
// before the output's first 16-byte boundary and after the last full group
// are done one a thread by block 0; a mask or value array that is not
// aligned with the output (a view at an element offset) is read with
// narrower loads in the same kernel.  One warp-chunk of 32 kRows rows a
// warp, a full grid of them.
//
// Chosen by tools/k3_k4_variants.py (CUDA-graph replays of 50 calls, warm
// and cold, NVIDIA H100 80GB HBM3 at 700 W; the numbers in PERF.md).  A
// first version gave each thread 16 consecutive rows (one 16-byte mask
// load, four float4s): a warp's accesses then stride by 64 bytes, and it was
// slower than the kernel it replaced on the K3 rows (up to 1.4x warm on the
// tensor path's largest call).  Here 4 rows a thread won against 8 and 16
// (8 is 3-6% faster warm on the 1.8M- and 3.5M-row calls, 4 is 2-16% faster
// cold on all but one row, and the paths' calls are mostly below 1M rows),
// the full grid against grids of 2 or 4 blocks an SM (those are up to 10%
// faster warm, 9-61% slower cold), the one-word count against an
// accumulator and a ticket with a fence between (1.1-2.9 us a call slower
// warm), block partials summed by the last block (1.5-4 us slower) and a
// memset plus one atomic a block (1.7-1.9 us slower); the warp skip is
// within 1% either way.  Against the kernel it replaced: 0.58x warm and
// 0.51x cold on K3's fixture row, 0.44x / 0.34x on K4's, 0.41x / 0.51x on
// K3's densest call, 0.27x / 0.37x on K4's largest.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;            // rows a thread: 4, 8 or 16
constexpr bool kWarpSkip = true;    // skip a warp's value code when its
                                    // groups hold no set mask byte
constexpr unsigned kFull = 0xffffffffu;

// torch.minimum on the card: a NaN operand is returned as it is
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

template <bool MIN3>
__device__ __forceinline__ float value(const float* __restrict__ v0,
                                       const float* __restrict__ v1,
                                       const float* __restrict__ v2,
                                       long long i) {
  const float a = __ldg(v0 + i);
  if (!MIN3) return a;
  return min_nan(a, min_nan(__ldg(v1 + i), __ldg(v2 + i)));
}

// -v as PyTorch's negation gives it on the card: a NaN comes out as the
// canonical 0x7fffffff, whatever its payload and sign
__device__ __forceinline__ float neg(float v) {
  return v != v ? __int_as_float(0x7fffffff) : -v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// the scores of rows i .. i + 3, whose mask bytes compare to 0xff in `nz`
// where set; values are loaded only when one of the four is set
template <bool MIN3>
__device__ __forceinline__ float4 group(uint32_t nz, bool vec,
                                        const float* __restrict__ v0,
                                        const float* __restrict__ v1,
                                        const float* __restrict__ v2,
                                        long long i) {
  float4 o = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  if (nz == 0) return o;
  float4 v;
  if (vec) {
    v = ld4(v0 + i);
    if (MIN3) {
      const float4 b = ld4(v1 + i), c = ld4(v2 + i);
      v.x = min_nan(v.x, min_nan(b.x, c.x));
      v.y = min_nan(v.y, min_nan(b.y, c.y));
      v.z = min_nan(v.z, min_nan(b.z, c.z));
      v.w = min_nan(v.w, min_nan(b.w, c.w));
    }
  } else {
    v.x = (nz & 0xffu) ? value<MIN3>(v0, v1, v2, i) : 0.0f;
    v.y = (nz & 0xff00u) ? value<MIN3>(v0, v1, v2, i + 1) : 0.0f;
    v.z = (nz & 0xff0000u) ? value<MIN3>(v0, v1, v2, i + 2) : 0.0f;
    v.w = (nz & 0xff000000u) ? value<MIN3>(v0, v1, v2, i + 3) : 0.0f;
  }
  if (nz & 0xffu) o.x = neg(v.x);
  if (nz & 0xff00u) o.y = neg(v.y);
  if (nz & 0xff0000u) o.z = neg(v.z);
  if (nz & 0xff000000u) o.w = neg(v.w);
  return o;
}

// the 4 mask bytes at p as one little-endian word: one load where p is
// 4-byte aligned, byte loads otherwise
__device__ __forceinline__ uint32_t mask_word(const uint8_t* __restrict__ p,
                                              bool vec) {
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  return (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8) |
         ((uint32_t)__ldg(p + 2) << 16) | ((uint32_t)__ldg(p + 3) << 24);
}

template <bool MIN3>
__global__ void __launch_bounds__(kThreads)
score_kernel(const uint8_t* __restrict__ mask, const float* __restrict__ v0,
             const float* __restrict__ v1, const float* __restrict__ v2,
             float* __restrict__ out, int* __restrict__ cnt,
             int* __restrict__ ctrl, long long n, long long head,
             long long ngroups, bool mask_vec, bool val_vec) {
  constexpr int G = kRows / 4;      // groups a thread
  int local = 0;
  // block 0: the head rows (before out's first 16-byte boundary) and the
  // tail rows (after the last full group), one a thread
  if (blockIdx.x == 0) {
    const long long t = threadIdx.x, tail0 = head + 4 * ngroups;
    const long long r = t < head ? t
                        : (t - head < n - tail0 ? tail0 + t - head : -1);
    if (r >= 0) {
      const bool sel = __ldg(mask + r) != 0;
      out[r] = sel ? neg(value<MIN3>(v0, v1, v2, r)) : -INFINITY;
      local += sel ? 1 : 0;
    }
  }
  // the groups: warp chunk c holds groups 32 G c .. 32 G (c + 1) - 1, lane
  // L of it groups 32 G c + 32 j + L (j < G); every lane of a warp runs the
  // loop as often (__ballot_sync needs them all)
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (kThreads / 32);
  for (long long c = (long long)blockIdx.x * (kThreads / 32) +
                     (threadIdx.x >> 5);
       c * 32 * G < ngroups; c += nwarps) {
    uint32_t nz[G];
    bool any = false;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long g = (c * G + j) * 32 + lane;
      nz[j] = 0;
      if (g < ngroups) {
        nz[j] = __vcmpne4(mask_word(mask + head + 4 * g, mask_vec), 0u);
        local += __popc(nz[j]) >> 3;
        any = any || nz[j] != 0;
      }
    }
    const bool skip = kWarpSkip && __ballot_sync(kFull, any) == 0;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long g = (c * G + j) * 32 + lane;
      if (g < ngroups) {
        const long long r = head + 4 * g;
        const float4 o =
            skip ? make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY)
                 : group<MIN3>(nz[j], val_vec, v0, v1, v2, r);
        *reinterpret_cast<float4*>(out + r) = o;
      }
    }
  }
  // the block's count
  __shared__ int warp_sum[kThreads / 32];
  local = __reduce_add_sync(kFull, local);
  if (lane == 0) warp_sum[threadIdx.x >> 5] = local;
  __syncthreads();
  // count: one 64-bit word, the blocks done above the count so far
  if (threadIdx.x == 0) {
    int b = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) b += warp_sum[k];
    unsigned long long* word = reinterpret_cast<unsigned long long*>(ctrl);
    const unsigned long long was =
        atomicAdd(word, (1ull << 32) | (unsigned)b);
    if ((was >> 32) == gridDim.x - 1) {   // the last block: every add is in
      *cnt = (int)(unsigned)was + b;
      *word = 0ull;                       // for the next call
    }
  }
  // end count
}

template <bool MIN3>
int launch(const uint8_t* mask, const float* v0, const float* v1,
           const float* v2, float* out, int* cnt, int* ctrl, long long n,
           void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const uintptr_t o = (uintptr_t)out;
  if (o % 4) return (int)cudaErrorMisalignedAddress;
  long long head = (long long)((16 - o % 16) % 16 / 4);
  if (head > n) head = n;
  const long long ngroups = (n - head) / 4;
  const bool mask_vec = ((uintptr_t)mask + head) % 4 == 0;
  bool val_vec = ((uintptr_t)v0 + 4 * head) % 16 == 0;
  if (MIN3)
    val_vec = val_vec && ((uintptr_t)v1 + 4 * head) % 16 == 0 &&
              ((uintptr_t)v2 + 4 * head) % 16 == 0;
  const long long chunks = (ngroups + 32 * (kRows / 4) - 1) /
                           (32 * (kRows / 4));
  long long blocks = (chunks + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  score_kernel<MIN3><<<(unsigned)blocks, kThreads, 0, s>>>(
      mask, v0, v1, v2, out, cnt, ctrl, n, head, ngroups, mask_vec, val_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// ints of the per-stream scratch a call needs: one 64-bit word, the
// blocks done (high half) and their count (low half), zeroed once; every
// call leaves it at 0
extern "C" int pm_score_scratch_ints() { return 2; }

extern "C" int pm_score_count(const uint8_t* mask, const float* v,
                              float* out, int* cnt, int* ctrl, long long n,
                              void* stream) {
  return launch<false>(mask, v, nullptr, nullptr, out, cnt, ctrl, n, stream);
}

extern "C" int pm_score3_count(const uint8_t* mask, const float* v0,
                               const float* v1, const float* v2, float* out,
                               int* cnt, int* ctrl, long long n,
                               void* stream) {
  return launch<true>(mask, v0, v1, v2, out, cnt, ctrl, n, stream);
}
