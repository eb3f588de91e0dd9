// Anisotropic metric edge length, one thread per unique edge.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:edge_length_ani_pallas
// (_len_ani_kernel): per edge e = p1 - p0, the endpoint quadratic forms
// q_i = e^T M_i e of the packed tensors (m11, m12, m13, m22, m23, m33),
// l_i = sqrt(max(q_i, 0)) and l = 2/3 (l0^2 + l0 l1 + l1^2) / max(l0 + l1,
// EPSD).  The TPU version left the endpoint gathers and the index clip of
// ops/edges.py:edge_lengths to XLA, which wrote [capE, 3] and [capE, 6]
// endpoint rows to memory before the kernel read them back; here they are
// folded in, so the edge table's (a, b) ids are read once and no endpoint
// row reaches device memory.
//
// Bound on the card: bytes.  Per edge it reads 8 bytes of ids and writes 4;
// the endpoint rows (12 bytes of point, 24 of tensor) are random gathers
// that mostly hit L2 (vert + met6 of a 50k-point mesh take 1.8 MB), so they
// are counted once per point.  Least time = (12 * capE + 36 * capP) bytes /
// 3.35 TB/s.  Design: a plain grid-stride loop, one thread per edge, no
// shared memory; the arithmetic (two quadratic forms, two sqrt, one divide,
// ~40 flops) is far below the memory time.  nvcc contracts the multiply-adds
// into FMAs and the form is summed in the Pallas kernel's order, not
// einsum's, so results agree with the plain version to a few ulp.
#include <cuda_runtime.h>

namespace {

constexpr float kEpsd = 1e-30f;

__device__ __forceinline__ float quad(const float* __restrict__ m, float x,
                                      float y, float z) {
  return m[0] * x * x + m[3] * y * y + m[5] * z * z +
         2.0f * (m[1] * x * y + m[2] * x * z + m[4] * y * z);
}

__global__ void edge_length_ani_kernel(const float* __restrict__ vert,
                                       const float* __restrict__ met6,
                                       const int* __restrict__ ev,
                                       float* __restrict__ out, int capP,
                                       long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int i0 = min(max(ev[2 * i], 0), capP - 1);
    const int i1 = min(max(ev[2 * i + 1], 0), capP - 1);
    const float x = vert[3 * i1] - vert[3 * i0];
    const float y = vert[3 * i1 + 1] - vert[3 * i0 + 1];
    const float z = vert[3 * i1 + 2] - vert[3 * i0 + 2];
    const float l0 = sqrtf(fmaxf(quad(met6 + 6 * (long long)i0, x, y, z),
                                 0.0f));
    const float l1 = sqrtf(fmaxf(quad(met6 + 6 * (long long)i1, x, y, z),
                                 0.0f));
    const float s = fmaxf(l0 + l1, kEpsd);
    out[i] = (2.0f / 3.0f) * (l0 * l0 + l0 * l1 + l1 * l1) / s;
  }
}

}  // namespace

extern "C" int pm_edge_lengths_ani(const float* vert, const float* met6,
                                   const int* ev, float* out, int capP,
                                   long long n, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  edge_length_ani_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(vert, met6, ev, out, capP,
                                                   n);
  return (int)cudaGetLastError();
}
