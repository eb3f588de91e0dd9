// Isotropic metric edge length, one thread per unique edge.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:edge_length_iso_pallas
// (_len_iso_kernel): the log-mean integral of 1/h along each edge, with the
// same `close` guard.  The TPU version left the endpoint gathers and the
// index clip of ops/edges.py:edge_lengths to XLA; here they are folded in,
// so the edge table's (a, b) ids are read once and the [capE, 3] endpoint
// rows never reach device memory.
//
// Bound on the card: bytes.  Per edge it reads 8 bytes of ids and writes 4;
// the endpoint rows (16 bytes each) are random gathers that mostly hit L2
// for meshes of this size (vert + met of a 30k-point mesh fit in 50 MB).
// Least time = (12 * capE + 16 * capP) bytes / 3.35 TB/s.  Design: a plain
// grid-stride loop, one thread per edge, no shared memory; the arithmetic
// (one sqrt, two reciprocals, one log) is far below the memory time.
//
// Every clamp keeps NaN, as jnp.maximum / torch.clamp do: CUDA's
// fmaxf(NaN, x) is x, which turned a NaN point into length 0 and a NaN
// size into a finite length.
#include <cuda_runtime.h>

namespace {

constexpr float kEpsd = 1e-30f;

// max(a, b) that is NaN when either is (jnp.maximum's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__global__ void edge_length_iso_kernel(const float* __restrict__ vert,
                                       const float* __restrict__ met,
                                       const int* __restrict__ ev,
                                       float* __restrict__ out, int capP,
                                       long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int i0 = min(max(ev[2 * i], 0), capP - 1);
    int i1 = min(max(ev[2 * i + 1], 0), capP - 1);
    const float dx = vert[3 * i1] - vert[3 * i0];
    const float dy = vert[3 * i1 + 1] - vert[3 * i0 + 1];
    const float dz = vert[3 * i1 + 2] - vert[3 * i0 + 2];
    const float d = sqrtf(max_nan(dx * dx + dy * dy + dz * dz, 0.0f));
    const float ha = max_nan(met[i0], kEpsd);
    const float hb = max_nan(met[i1], kEpsd);
    const float r0 = 1.0f / ha;
    const float r1 = 1.0f / hb;
    const bool close = fabsf(r0 - r1) < 1e-6f * max_nan(r0, r1);
    float lm;
    if (close) {
      lm = 0.5f * (r0 + r1);
    } else {
      lm = (r1 - r0) / logf(max_nan(ha / hb, kEpsd));
    }
    out[i] = d * lm;
  }
}

}  // namespace

extern "C" int pm_edge_lengths_iso(const float* vert, const float* met,
                                   const int* ev, float* out, int capP,
                                   long long n, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  edge_length_iso_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(vert, met, ev, out, capP,
                                                   n);
  return (int)cudaGetLastError();
}
