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
// grid.  A CUDA grid has no order.  This is a one-sweep LSD radix sort
// (Adinets & Merrill, "Onesweep: A Faster Least Significant Digit Radix
// Sort for GPUs", 2022): 1 + npass launches in one C call on the caller's
// stream, and no K5 scan.
//   1. radix_hist_kernel reads every key word once, in position order
//      (counts do not depend on order), and counts the 256-bin histograms
//      of all passes at once in shared memory, a thread's 16 loads in
//      flight before its first count; then one global atomicAdd per bin per
//      block.  The last block to finish scans each pass's 256 counts into
//      its digits' global bases and zeroes the counts for the next call.
//      It also clears pass 0's status words.
//   2. radix_pass_kernel, one launch a pass.  Each block takes a dynamic
//      tile id (SORT_TILE = 512 threads x 10 = 5,120 positions, so the
//      main path's 1.3 M edge keys fit in one wave at two blocks an SM),
//      loads its tile warp-striped (warp w owns 320 consecutive positions,
//      item j of lane l sits at w * 320 + j * 32 + l, so order_in loads
//      coalesce and the pass's key word is gathered from L2), and ranks all
//      10 items of a thread in one go: eight ballots, one a digit bit, give
//      the lanes of the warp with the item's digit, and a per-warp digit
//      counter in shared memory carries the items, so rank order is
//      position order.  (__match_any_sync did the same at several times
//      the cost.)  One thread per digit scans the warps' counts.
//      Look-back over a Fenwick tree of tiles: with 1-based tile index m,
//      a tile's 64-bit status word {flag, count} for a digit holds the
//      digit's count over tiles m - lowbit(m) + 1 .. m.  The digit's
//      thread reads the words of the tiles that tree makes its children
//      (at most log2(tiles), 4 loads in flight), adds its own count and
//      publishes; then it reads the words that tile the range before it
//      (at most log2(tiles)) for the digit's count over every earlier tile.
//      At these sizes every tile of a pass runs in one wave, and a tile's
//      wait is the tree's depth in round trips through L2 (9 for the main
//      path's 259 tiles), where a walk from tile to tile back to the
//      nearest published prefix, 8 loads in flight, took up to tiles / 8.
//      Each word is written once and carries its flag, so no fence orders
//      it.  The block sorts the tile by digit in shared memory and writes
//      order_out (and, while the next pass sorts the same word, the key
//      beside it, which that pass then reads in order instead of
//      gathering), so each digit's run of a tile lands in consecutive
//      addresses.  A tile's prefix comes only from tiles of
//      lower id, which cover the positions before it: equal digits keep
//      their order.  Pass k uses status set k & 1 and clears its own row
//      of set (k + 1) & 1 for pass k + 1; the block that takes the last
//      tile id resets the tile counter.
// The ragged last tile is masked (no 0xFFFFFFFF padding, which only the
// TPU's tiling needed).
//
// Bound on the card: bytes.  The function must read its key words once and
// write the permutation (4 bytes per word and 4 per element).  Each pass
// reads order_in and a key (gathered, or carried in order) and writes
// order_out (and the carried key): 12-16 bytes an element a pass, 4-6
// passes on the main path, most of it in L2.  At the main path's sizes
// (10^6 keys) latency sets the time, not bytes: the launches, the tree
// look-back's round trips, and the chain of a tile's loads, ranking,
// barriers and stores (PERF.md).
#include "merge_prefix.cuh"

namespace {

using pm_scan::u64;

constexpr int RADIX = 256;
constexpr int MAX_PASSES = 12;          // 3 words x 4 digits
constexpr int HIST_THREADS = 512;
constexpr int HIST_ITEMS = 16;          // keys a thread loads at once
constexpr int SORT_THREADS = 512;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int SORT_ITEMS = 10;
constexpr int WARP_SPAN = 32 * SORT_ITEMS;
constexpr int SORT_TILE = SORT_THREADS * SORT_ITEMS;
// status word of a (tile, digit): the digit's count over the tile's
// Fenwick range below, this flag above (a cleared word reads as not out)
constexpr u64 FLAG_OUT = 1ull << 32;
constexpr int FENW = 4;                 // look-back loads in flight
// dynamic shared memory of radix_pass_kernel: warp counters, the tile's
// values and keys in digit order, per-digit starts and offsets, scan words
// and the tile id
constexpr size_t SORT_SMEM =
    sizeof(unsigned) * (SORT_WARPS * RADIX + 2 * SORT_TILE + 2 * RADIX +
                        SORT_WARPS + 2);

__device__ __forceinline__ unsigned key_digit(unsigned k, int bits,
                                              int shift) {
  if (bits < 31 && k == 0x7fffffffu) k = (1u << bits) - 1u;
  return (k >> shift) & 0xFFu;
}

__device__ __forceinline__ const int* pick(const int* w0, const int* w1,
                                           const int* w2, int j) {
  return j == 0 ? w0 : (j == 1 ? w1 : w2);
}

// Sum of digit d's range counts of the 1-based tiles j, j - lowbit(j), ...
// while j > stop (a Fenwick walk), FENW loads in flight, each spun on
// until its tile has published it.
__device__ __forceinline__ unsigned fenwick_sum(const u64* status, int d,
                                                unsigned j, unsigned stop) {
  unsigned s = 0;
  while (j > stop) {
    unsigned q[FENW];
    u64 w[FENW];
#pragma unroll
    for (int u = 0; u < FENW; ++u) {
      q[u] = j > stop ? j : 0u;
      w[u] = q[u] ? pm_scan::ld_status(&status[(long long)(j - 1) * RADIX + d])
                  : FLAG_OUT;
      if (q[u]) j -= j & (0u - j);
    }
#pragma unroll
    for (int u = 0; u < FENW; ++u) {
      u64 v = w[u];
      while (!(v >> 32))
        v = pm_scan::ld_status(&status[(long long)(q[u] - 1) * RADIX + d]);
      s += (unsigned)v;
    }
  }
  return s;
}

__global__ void __launch_bounds__(HIST_THREADS)
radix_hist_kernel(const int* __restrict__ w0, const int* __restrict__ w1,
                  const int* __restrict__ w2, int nwords, int b0, int b1,
                  int b2, long long n, int npass,
                  unsigned* __restrict__ ghist, unsigned* __restrict__ gbase,
                  unsigned* __restrict__ ctrl, u64* __restrict__ status0,
                  long long nstatus) {
  __shared__ unsigned h[MAX_PASSES * RADIX];
  __shared__ unsigned s_warp[HIST_THREADS / 32 + 1];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const long long stride = (long long)gridDim.x * HIST_THREADS;
  for (int i = t; i < npass * RADIX; i += HIST_THREADS) h[i] = 0;
  for (long long i = (long long)blockIdx.x * HIST_THREADS + t; i < nstatus;
       i += stride)
    status0[i] = 0;
  __syncthreads();
  int k0 = 0;                           // first pass of word j
  for (int j = nwords - 1; j >= 0; --j) {
    const int* w = pick(w0, w1, w2, j);
    const int bits = j == 0 ? b0 : (j == 1 ? b1 : b2);
    const int np = (bits + 7) / 8;
    // all of a thread's loads in flight before its first count
    for (long long base = (long long)blockIdx.x * HIST_THREADS * HIST_ITEMS;
         base < n; base += stride * HIST_ITEMS) {
      unsigned k[HIST_ITEMS];
#pragma unroll
      for (int u = 0; u < HIST_ITEMS; ++u) {
        const long long i = base + u * HIST_THREADS + t;
        k[u] = i < n ? (unsigned)w[i] : 0u;
      }
#pragma unroll
      for (int u = 0; u < HIST_ITEMS; ++u) {
        if (base + u * HIST_THREADS + t >= n) break;
        for (int p = 0; p < np; ++p)
          atomicAdd(&h[(k0 + p) * RADIX + key_digit(k[u], bits, 8 * p)], 1u);
      }
    }
    k0 += np;
  }
  __syncthreads();
  for (int i = t; i < npass * RADIX; i += HIST_THREADS)
    if (h[i]) atomicAdd(&ghist[i], h[i]);
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&ctrl[1], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block: every other block's counts are in ghist
  __threadfence();
  for (int i = t; i < npass * RADIX; i += HIST_THREADS)
    h[i] = atomicExch(&ghist[i], 0u);
  __syncthreads();
  for (int p = 0; p < npass; ++p) {
    const unsigned v = t < RADIX ? h[p * RADIX + t] : 0u;
    unsigned tot;
    const unsigned ex =
        pm_scan::block_exclusive<HIST_THREADS>(v, s_warp, &tot);
    if (t < RADIX) gbase[p * RADIX + t] = ex;
  }
  if (t == 0) atomicExch(&ctrl[1], 0u);
}

__global__ void __launch_bounds__(SORT_THREADS, 2)
radix_pass_kernel(const int* __restrict__ word, int bits, int shift,
                  const int* __restrict__ order_in,
                  const int* __restrict__ keys_in,
                  int* __restrict__ order_out, int* __restrict__ keys_out,
                  const unsigned* __restrict__ gbase,
                  u64* __restrict__ status, u64* __restrict__ status_next,
                  unsigned* __restrict__ ctrl, long long n) {
  extern __shared__ unsigned smem[];
  unsigned* cnt = smem;                                // [warp][digit]
  int* s_val = (int*)(cnt + SORT_WARPS * RADIX);       // [SORT_TILE]
  unsigned* s_key = (unsigned*)(s_val + SORT_TILE);    // [SORT_TILE]
  unsigned* s_dstart = s_key + SORT_TILE;              // [RADIX]
  int* s_off = (int*)(s_dstart + RADIX);               // [RADIX]
  unsigned* s_warp = (unsigned*)(s_off + RADIX);       // [SORT_WARPS + 1]
  unsigned* s_tile = s_warp + SORT_WARPS + 1;          // the tile id
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  for (int i = t; i < SORT_WARPS * RADIX; i += SORT_THREADS) cnt[i] = 0;
  if (t == 0) {
    const unsigned tile = atomicAdd(&ctrl[0], 1u);
    if (tile == gridDim.x - 1) atomicExch(&ctrl[0], 0u);
    *s_tile = tile;
  }
  if (t < RADIX) s_off[t] = (int)gbase[t];  // the digit's global base
  __syncthreads();
  const unsigned tile = *s_tile;
  const long long tbase = (long long)tile * SORT_TILE;
  const long long wbase = tbase + (long long)wid * WARP_SPAN;
  int src[SORT_ITEMS];
  unsigned key[SORT_ITEMS];
  unsigned rnk[SORT_ITEMS];
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    src[j] = 0;
    key[j] = 0;
    if (i < n) {
      src[j] = order_in ? order_in[i] : (int)i;
      key[j] = keys_in ? (unsigned)keys_in[i] : (unsigned)word[src[j]];
    }
  }
  // rank: the lanes of the warp with the same digit (8 ballots, one a
  // digit bit), in lane order; a per-warp digit counter carries the items,
  // so rank order is position order
  const unsigned below = (1u << lane) - 1u;
  unsigned* wc = cnt + wid * RADIX;
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    const bool ok = wbase + j * 32 + lane < n;
    const unsigned d = key_digit(key[j], bits, shift);
    unsigned peers = __ballot_sync(pm_scan::FULL, ok);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned set = __ballot_sync(pm_scan::FULL, (d >> b) & 1u);
      peers &= ((d >> b) & 1u) ? set : ~set;
    }
    const int leader = __ffs(peers) - 1;
    unsigned c = 0;
    if (ok && lane == leader) {
      c = wc[d];
      wc[d] = c + __popc(peers);
    }
    c = __shfl_sync(pm_scan::FULL, c, leader < 0 ? 0 : leader);
    __syncwarp();
    rnk[j] = c + __popc(peers & below);
  }
  __syncthreads();
  // thread t < RADIX owns digit t: the warps' exclusive offsets, the
  // tile's count, and the digit's count over the tile's Fenwick range
  // (1-based tiles m - lowbit(m) + 1 .. m), published as soon as the
  // ranges it covers are out
  const unsigned m = tile + 1;
  unsigned count = 0;
  if (t < RADIX) {
    for (int w = 0; w < SORT_WARPS; ++w) {
      const unsigned c = cnt[w * RADIX + t];
      cnt[w * RADIX + t] = count;
      count += c;
    }
    const unsigned range =
        count + fenwick_sum(status, t, m - 1, m - (m & (0u - m)));
    pm_scan::st_status(&status[(long long)tile * RADIX + t],
                       FLAG_OUT | range);
  }
  unsigned tot;
  const unsigned dstart =
      pm_scan::block_exclusive<SORT_THREADS>(count, s_warp, &tot);
  if (t < RADIX) s_dstart[t] = dstart;
  __syncthreads();
  // the tile in digit order in shared memory
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    if (wbase + j * 32 + lane < n) {
      const unsigned d = key_digit(key[j], bits, shift);
      const unsigned lp = s_dstart[d] + wc[d] + rnk[j];
      s_val[lp] = src[j];
      s_key[lp] = key[j];
    }
  }
  if (t < RADIX) {
    // the digit's count over tiles 0 .. tile - 1: the Fenwick prefix
    const unsigned excl = fenwick_sum(status, t, m - 1, 0u);
    s_off[t] += (int)excl - (int)s_dstart[t];
    if (status_next) status_next[(long long)tile * RADIX + t] = 0;
  }
  __syncthreads();
  const long long left = n - tbase;
  const int tile_n = left < SORT_TILE ? (int)left : SORT_TILE;
  for (int i = t; i < tile_n; i += SORT_THREADS) {
    const unsigned k = s_key[i];
    const int pos = s_off[key_digit(k, bits, shift)] + i;
    order_out[pos] = s_val[i];
    if (keys_out) keys_out[pos] = (int)k;
  }
}

}  // namespace

extern "C" int pm_radix_tile() { return SORT_TILE; }

// Sort permutation of n rows by (w0, w1, w2)[:nwords], major first, in
// 1 + npass launches on `stream`; does not synchronise.  out, tmp: [n]
// int32 (tmp unused for one pass); keys_a, keys_b: [n] int32 to carry a
// word's key in order between its passes, or null to gather it every
// pass.  Scratch kept with the device: ctrl int32[2] and ghist
// int32[MAX_PASSES * 256], zeroed once and left zeroed by every call;
// gbase int32[MAX_PASSES * 256]; status int64[2 * status_tiles * 256]
// with status_tiles >= ceil(n / tile): two sets of one word a (tile,
// digit), cleared by the kernels themselves.
extern "C" int pm_radix_sort(const int* w0, const int* w1, const int* w2,
                             int nwords, int b0, int b1, int b2, int* out,
                             int* tmp, int* keys_a, int* keys_b,
                             unsigned* ctrl, unsigned* ghist,
                             unsigned* gbase, unsigned long long* status,
                             long long status_tiles, long long n,
                             void* stream) {
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
  const long long tiles = (n + SORT_TILE - 1) / SORT_TILE;
  if (tiles > status_tiles) return (int)cudaErrorInvalidValue;
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(radix_pass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SORT_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  u64* st[2] = {status, status + status_tiles * RADIX};
  long long hblocks = (n + HIST_THREADS * HIST_ITEMS - 1) /
                      (HIST_THREADS * HIST_ITEMS);
  if (hblocks > 1024) hblocks = 1024;
  radix_hist_kernel<<<(unsigned)hblocks, HIST_THREADS, 0, s>>>(
      w0, w1, w2, nwords, b0, b1, b2, n, npass, ghist, gbase, ctrl, st[0],
      tiles * RADIX);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int* in = nullptr;              // pass 0 reads positions
  const int* kin = nullptr;             // a carried key, in order
  int k = 0;
  for (int j = nwords - 1; j >= 0; --j) {  // LSD: minor word first
    for (int shift = 0; shift < bits[j]; shift += 8, ++k) {
      const bool to_out = (npass - 1 - k) % 2 == 0;
      int* dst = to_out ? out : tmp;
      // carry the key only while the next pass sorts the same word
      int* kdst = (keys_a && shift + 8 < bits[j]) ? (k % 2 ? keys_b : keys_a)
                                                  : nullptr;
      radix_pass_kernel<<<(unsigned)tiles, SORT_THREADS, SORT_SMEM, s>>>(
          words[j], bits[j], shift, in, kin, dst, kdst, gbase + k * RADIX,
          st[k & 1], k + 1 < npass ? st[(k + 1) & 1] : nullptr, ctrl, n);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      in = dst;
      kin = kdst;
    }
  }
  return 0;
}
