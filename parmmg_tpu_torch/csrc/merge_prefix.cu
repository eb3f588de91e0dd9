// K5: inclusive int32 prefix sum, the standalone entry point.
//
// Replaces parmmg_tpu/ops/pallas_kernels.py:merge_prefix_pallas.  The
// kernels, their bound and their design are in merge_prefix.cuh, which
// radix_sort.cu includes too: inside a K7 sort the scan of the digit
// histogram runs from the sort's own entry point, so a sort stays one
// host call.
#include "merge_prefix.cuh"

extern "C" int pm_merge_prefix_tile() { return pm_scan::TILE; }

// out[i] = x[0] + ... + x[i]; totals: scratch of ceil(n / tile) ints.
extern "C" int pm_merge_prefix(const int* x, int* out, int* totals,
                               long long n, void* stream) {
  return (int)pm_scan::inclusive_scan(x, out, totals, n,
                                      (cudaStream_t)stream);
}
