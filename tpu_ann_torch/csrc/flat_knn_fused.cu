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
// A CTA is 384 threads: a producer warpgroup whose one thread feeds a TMA
// ring, and two consumer warpgroups of 64 queries that multiply with wgmma
// in turns and fold beside the accumulator (one consumer of 64 queries
// above dp 384, where 64-query CTAs fill at most one wave, or where a CTA
// holds no more than 64 real queries).
// One CTA an SM; the tensor maps are encoded at each launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see tpu_ann_torch/kernels). Plain C interface.

#include "flat_knn_core.cuh"

namespace {

using namespace flat_knn;

__global__ void __launch_bounds__(kThreads, 1)
flat_knn_fused_kernel(
    const __grid_constant__ CUtensorMap qmap,  // (nq, dp) bf16, pre-scaled
    const __grid_constant__ CUtensorMap dmap,  // (n, dp) bf16 packed rows
    const float* __restrict__ bias,            // (n,) f32
    int nq, int n, int dp, int W, int qtile,
    float* __restrict__ resv,                  // (nq, W) f32
    int* __restrict__ resp) {                  // (nq, W) int32 row positions
  scan_body<FoldSerial>(qmap, dmap, bias, nq, n, dp, W, qtile, 1, resv,
                        resp);
}

}  // namespace

extern "C" {

// Launches (W / 128) * ceil(nq / qtile) CTAs (qtile 128 or 64, see
// prepare_launch; at most 2^31 - 1) on `stream`; allocates nothing. n
// (packed rows) must be a multiple of W, W of 128, dp of 16; the pointers
// 16-byte aligned. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes outside these rules.
int flat_knn_fused(const void* qv, const void* data, const void* bias,
                   int nq, int n, int dp, int W, void* resv, void* resp,
                   void* stream) {
  Launch l;
  const int e = prepare_launch(flat_knn_fused_kernel, qv, data, bias, nq, n,
                               dp, W, &l);
  if (e != 0) return e;
  if (nq > 0) {
    flat_knn_fused_kernel<<<l.nblocks, kThreads, l.smem,
                            static_cast<cudaStream_t>(stream)>>>(
        l.qmap, l.dmap, static_cast<const float*>(bias), nq, n, dp, W,
        l.qtile, static_cast<float*>(resv), static_cast<int*>(resp));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
