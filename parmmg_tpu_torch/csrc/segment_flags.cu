// K8: segment-start flags over sorted key columns: flag[i] is true iff
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
