// K5: inclusive int32 prefix sum, the standalone entry point.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:merge_prefix_pallas.  The
// kernel, its bound and its design are in merge_prefix.cuh, whose scan and
// look-back primitives radix_sort.cu shares.
#include "merge_prefix.cuh"

extern "C" int pm_merge_prefix_tile() { return pm_scan::SCAN_TILE; }

// out[i] = x[0] + ... + x[i]; ctrl: int64[1] and status: int64[status_cap]
// of scratch kept with the device, zeroed once (status_cap >= tiles).
extern "C" int pm_merge_prefix(const int* x, int* out, long long n,
                               unsigned long long* ctrl,
                               unsigned long long* status,
                               long long status_cap, void* stream) {
  return (int)pm_scan::inclusive_scan(x, out, n, ctrl, status, status_cap,
                                      (cudaStream_t)stream);
}
