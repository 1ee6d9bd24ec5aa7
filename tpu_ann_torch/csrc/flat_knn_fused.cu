// Fused flat k-NN scan (K1): each query's W-wide lane-min reservoir over
// the whole packed database, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_ann/ops/flat_knn_pallas.py::_flat_kernel_grid
// with _merge_groups (and the fori / pipe / unrolled schedules
// _flat_kernel and _flat_kernel_unrolled, which compute the same
// reservoir), launched by flat_knn_fused. Python side, plain version and
// binding: tpu_ann_torch/ops/flat_knn_fused.py.
//
// The body lives in flat_knn_core.cuh (shared with K1p and the probe folds
// of flat_knn_variants.cu); this library instantiates its serial fold only:
//   score(q, r) = bias[r] + q . x_r           (f32 accumulation)
//   lane j of query q keeps the smallest score among rows r = g*W + j,
//   g = 0, 1, ...; strict < keeps the earlier row on a tie.
// Out: (nq, W) f32 values and int32 row positions; (+inf, -1) where no
// finite score reached the lane.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see tpu_ann_torch/kernels). Plain C interface.

#include "flat_knn_core.cuh"

namespace {

using namespace flat_knn;

__global__ void __launch_bounds__(kThreads, 2)  // two CTAs per SM
flat_knn_fused_kernel(
    const uint16_t* __restrict__ qv,    // (nq, dp) bf16, pre-scaled
    const uint16_t* __restrict__ data,  // (n, dp) bf16 packed rows
    const float* __restrict__ bias,     // (n,) f32
    int nq, int n, int dp, int W,
    float* __restrict__ resv,           // (nq, W) f32
    int* __restrict__ resp) {           // (nq, W) int32 row positions
  scan_body<FoldSerial>(qv, data, bias, nq, n, dp, W, 1, resv, resp);
}

}  // namespace

extern "C" {

// Launches (W / kLB) * ceil(nq / kQB) CTAs (at most 2^31 - 1) on
// `stream`; allocates nothing. n (packed rows) must be a multiple of W, W of kLB, dp of 16.
// Returns cudaGetLastError() (0 on success).
int flat_knn_fused(const void* qv, const void* data, const void* bias,
                   int nq, int n, int dp, int W, void* resv, void* resp,
                   void* stream) {
  unsigned nblocks = 0;
  size_t smem = 0;
  const int e = prepare_launch(flat_knn_fused_kernel, nq, n, dp, W, &nblocks,
                               &smem);
  if (e != 0) return e;
  if (nq > 0) {
    flat_knn_fused_kernel<<<nblocks, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(qv), static_cast<const uint16_t*>(data),
        static_cast<const float*>(bias), nq, n, dp, W,
        static_cast<float*>(resv), static_cast<int*>(resp));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
