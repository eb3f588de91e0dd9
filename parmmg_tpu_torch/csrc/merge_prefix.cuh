// K5: inclusive int32 prefix sum on the card, and the scan and look-back
// primitives that radix_sort.cu (K7) shares with it.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:merge_prefix_pallas
// (_prefix_kernel), which carries the running block total across the TPU's
// sequential grid in SMEM.  A CUDA grid has no order.  This is a single-pass
// scan with decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016): one launch a call.
//   - Every block takes its tile id from a global atomic counter, not from
//     blockIdx.x: blocks are not scheduled in index order, and a block that
//     waited on a tile nobody had started would hang.  The block that takes
//     the last id resets the counter; it is the last to fetch one.
//   - A tile is SCAN_THREADS x SCAN_ITEMS = 512 x 8 consecutive int32
//     (16-byte vector loads and stores where the pointers allow).  Each
//     thread scans its 8 items; the block scans the thread totals with warp
//     shuffles and one shared word per warp.
//   - The block publishes its tile's aggregate in a 64-bit status word
//     {tag, flag, value}.  Then one warp reads the status of the 32 tiles
//     before it at a time, adds aggregates until it meets an inclusive
//     prefix, and publishes its own inclusive prefix.  The value is any 32
//     bits (sums wrap), so the flag and the tag take the word's upper half.
//     A word is read and written whole (relaxed, GPU scope) and carries
//     its own flag, so no fence orders it after anything else.
//   - Status words are never cleared.  Each call's words carry a tag made
//     from an epoch kept on the device in the counter's upper half (one
//     atomic gives a block its tile id and the call's epoch), which the
//     block with the last tile id advances as it resets the counter; a word
//     left by an earlier call reads as "not published".
//     Nothing is set from the host between calls, so the launch can be
//     captured in a CUDA graph.
// Adds are done in uint32 (wrap-around, as torch.cumsum(dtype=int32) and
// jnp.cumsum do in int32), and integer addition is associative, so the
// result equals cumsum bit for bit in any block order.
//
// Bound on the card: bytes (x read once, the result written once: 8 bytes
// an element).  At the main path's sizes (10^5-10^6 elements, L2-resident)
// latency sets the time: the launch, a tile's load, and the look-back's
// round trips through L2.  The scan-then-propagate design this replaced took
// three launches and moved every element twice.
//
// Scratch, owned by the wrapper, zeroed once and kept with the device:
// ctrl = epoch << 32 | tile counter, and status[>= tiles], all 64-bit
// words.  Calls that share it must run one after another on one stream;
// the wrapper keeps one set a stream.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace pm_scan {
namespace {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned warp_inclusive(unsigned v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Exclusive scan of one value per thread over a block of THREADS threads
// (every thread must call it); *total gets the block sum.  s_warp is shared
// scratch of THREADS / 32 + 1 words; the trailing barrier lets the caller
// call again at once.
template <int THREADS>
__device__ __forceinline__ unsigned block_exclusive(unsigned v,
                                                    unsigned* s_warp,
                                                    unsigned* total) {
  constexpr int WARPS = THREADS / 32;
  static_assert(WARPS <= 32, "one warp scans the warp totals");
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

// Status words are published and read at GPU scope, past the SM's L1.
// Each word carries its own flag beside its value and no other data hangs
// on it, so relaxed single-word atomicity is all the look-back needs: no
// fence.
__device__ __forceinline__ u64 ld_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

constexpr int SCAN_THREADS = 512;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
static_assert(SCAN_ITEMS % 4 == 0, "items load as int4");

// K5 status word: upper half (tag << 1 | is_prefix), lower half the value.
// Tags run over 1 .. 2^31 - 1, so a zeroed word is never valid.
__device__ __forceinline__ u64 scan_status(unsigned tag, unsigned prefix,
                                           unsigned value) {
  return ((u64)((tag << 1) | prefix) << 32) | value;
}

__global__ void __launch_bounds__(SCAN_THREADS)
prefix_scan_kernel(const int* __restrict__ x, int* __restrict__ out,
                   long long n, u64* __restrict__ ctrl,
                   u64* __restrict__ status) {
  __shared__ unsigned s_warp[SCAN_THREADS / 32 + 1];
  __shared__ unsigned s_tile, s_tag, s_excl;
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t == 0) {
    // the block with the last id advances the epoch after every other
    // block has taken its id, and so read this call's epoch
    const u64 c = atomicAdd(ctrl, 1ull);
    const unsigned tile = (unsigned)c;
    const unsigned epoch = (unsigned)(c >> 32);
    if (tile == gridDim.x - 1) atomicExch(ctrl, (u64)(epoch + 1u) << 32);
    s_tile = tile;
    s_tag = epoch % 0x7fffffffu + 1u;
  }
  __syncthreads();
  const unsigned tile = s_tile;
  const unsigned tag = s_tag;
  const long long base = (long long)tile * SCAN_TILE +
                         (long long)t * SCAN_ITEMS;
  const bool vec = base + SCAN_ITEMS <= n &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  unsigned v[SCAN_ITEMS];
  if (vec) {
    const int4* x4 = reinterpret_cast<const int4*>(x + base);
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 4; ++q) {
      const int4 a = x4[q];
      v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k)
      v[k] = base + k < n ? (unsigned)x[base + k] : 0u;
  }
  unsigned run = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    run += v[k];
    v[k] = run;
  }
  unsigned agg;
  const unsigned ex = block_exclusive<SCAN_THREADS>(run, s_warp, &agg);
  if (t < 32) {                          // warp 0: publish, look back
    unsigned excl = 0;
    if (tile == 0) {
      if (lane == 0) st_status(&status[0], scan_status(tag, 1u, agg));
    } else {
      if (lane == 0) st_status(&status[tile], scan_status(tag, 0u, agg));
      long long win = (long long)tile - 1;
      while (true) {
        const long long p = win - lane;  // lane 0: the nearest predecessor
        u64 s = scan_status(tag, 1u, 0u);  // before tile 0: a zero prefix
        if (p >= 0) {
          do {
            s = ld_status(&status[p]);
          } while ((unsigned)(s >> 33) != tag);
        }
        const unsigned pre = __ballot_sync(FULL, (unsigned)(s >> 32) & 1u);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        excl += warp_sum(lane <= stop ? (unsigned)s : 0u);
        if (pre) break;
        win -= 32;
      }
      if (lane == 0)
        st_status(&status[tile], scan_status(tag, 1u, excl + agg));
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const unsigned off = s_excl + ex;
  if (vec) {
    int4* o4 = reinterpret_cast<int4*>(out + base);
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS / 4; ++q)
      o4[q] = make_int4((int)(v[4 * q] + off), (int)(v[4 * q + 1] + off),
                        (int)(v[4 * q + 2] + off), (int)(v[4 * q + 3] + off));
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k)
      if (base + k < n) out[base + k] = (int)(v[k] + off);
  }
}

// out[i] = x[0] + ... + x[i] (int32, wrapping) in one launch on `s`; does
// not synchronise.  ctrl, status: the scratch above, status_cap words.
inline cudaError_t inclusive_scan(const int* x, int* out, long long n,
                                  u64* ctrl, u64* status,
                                  long long status_cap, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const long long tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (tiles > status_cap || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  prefix_scan_kernel<<<(unsigned)tiles, SCAN_THREADS, 0, s>>>(x, out, n, ctrl,
                                                               status);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pm_scan
