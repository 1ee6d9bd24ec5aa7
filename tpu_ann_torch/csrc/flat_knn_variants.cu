// Variants of the fused flat scan (K1) for NVIDIA Hopper (sm_90a), one
// library beside K1's own so K1's instantiation stays as it is:
//
// K1p, flat_knn_packed: replaces tpu_ann/ops/flat_knn_pallas.py::
//   _flat_kernel_grid_packed (schedule="grid", :392) and
//   _flat_kernel_packed (schedule="fori" with any unroll, :412), both
//   launched by flat_knn_fused(merge="packed") (:704, :746). One int32 per
//   reservoir lane holds (bits(score) & 0xFFFF0000) + g, the score's top 16
//   bits and its global group, folded with one integer min per score from
//   0x7FFFFFFF. The caller adds a shift C to the bias so every score is
//   non-negative and its IEEE bits order like the value (C = max|q|^2 + 1
//   for L2, sqrt(max|q|^2) sqrt(max|x|^2) + 1 for IP), keeps n / W <= 65536
//   groups (16 bits) and decodes value = bits(acc & 0xFFFF0000) - C, row =
//   (acc & 0xFFFF) * W + lane. The reference's U independent accumulators
//   of the unrolled fori schedule min-merge after its loop; a min over U
//   accumulators is the min over one, so this one kernel serves every
//   schedule and unroll.
//
// B1, flat_probe_scan: the probe merges of the round-4 flat-kernel ceiling
//   ladder (benchs/r4/r4_queue3.py:149, benchs/r4/r4_queue4.py:157), which
//   run _flat_kernel_grid with its merge replaced:
//   fold 0, min1:   the f32 lane-min over the first W-wide group of every
//                   R-row chunk only (g % gpc == 0, gpc = R / W);
//   fold 1, minall: the f32 lane-min over every group, no provenance;
//   fold 2, serial: K1's own fold (values and rows), for the same ladder.
//   min1 / minall write rows -1, as the harness's untouched position plane.
//   Every group's products are computed for every fold (asm volatile mma),
//   so the ladder's times split K1's into products and fold.
//
// The body is flat_knn_core.cuh's; see there for the design and the bound.
// Python side, plain versions and binding: tpu_ann_torch/ops/
// flat_knn_fused.py. Plain C interface.

#include "flat_knn_core.cuh"

namespace {

using namespace flat_knn;

__global__ void __launch_bounds__(kThreads, 2)
flat_knn_packed_kernel(const uint16_t* __restrict__ qv,
                       const uint16_t* __restrict__ data,
                       const float* __restrict__ bias, int nq, int n, int dp,
                       int W, int* __restrict__ out) {
  scan_body<FoldPacked>(qv, data, bias, nq, n, dp, W, 1, nullptr, out);
}

template <class Fold>
__global__ void __launch_bounds__(kThreads, 2)
flat_probe_kernel(const uint16_t* __restrict__ qv,
                  const uint16_t* __restrict__ data,
                  const float* __restrict__ bias, int nq, int n, int dp,
                  int W, int gpc, float* __restrict__ resv,
                  int* __restrict__ resp) {
  scan_body<Fold>(qv, data, bias, nq, n, dp, W, gpc, resv, resp);
}

template <class Fold>
int launch_probe(const void* qv, const void* data, const void* bias, int nq,
                 int n, int dp, int W, int gpc, void* resv, void* resp,
                 void* stream) {
  unsigned nblocks = 0;
  size_t smem = 0;
  const int e = prepare_launch(flat_probe_kernel<Fold>, nq, n, dp, W,
                               &nblocks, &smem);
  if (e != 0) return e;
  if (nq > 0) {
    flat_probe_kernel<Fold><<<nblocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(qv), static_cast<const uint16_t*>(data),
        static_cast<const float*>(bias), nq, n, dp, W, gpc,
        static_cast<float*>(resv), static_cast<int*>(resp));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1p: (nq, W) int32 packed reservoir on `stream`; allocates nothing. n
// (packed rows) must be a multiple of W and at most 65536 * W, W of kLB,
// dp of 16. Returns cudaGetLastError() (0 on success).
int flat_knn_packed(const void* qv, const void* data, const void* bias,
                    int nq, int n, int dp, int W, void* out, void* stream) {
  unsigned nblocks = 0;
  size_t smem = 0;
  if (W > 0 && n / W > 65536) return static_cast<int>(cudaErrorInvalidValue);
  const int e = prepare_launch(flat_knn_packed_kernel, nq, n, dp, W,
                               &nblocks, &smem);
  if (e != 0) return e;
  if (nq > 0) {
    flat_knn_packed_kernel<<<nblocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(qv), static_cast<const uint16_t*>(data),
        static_cast<const float*>(bias), nq, n, dp, W,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// B1: the probe fold `fold` (0 min1, 1 minall, 2 serial) into (nq, W) f32
// values and int32 rows; gpc (R / W) >= 1 is min1's group stride. Returns
// cudaGetLastError() (0 on success).
int flat_probe_scan(const void* qv, const void* data, const void* bias,
                    int nq, int n, int dp, int W, int gpc, int fold,
                    void* resv, void* resp, void* stream) {
  if (gpc < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (fold) {
    case 0:
      return launch_probe<FoldMin1>(qv, data, bias, nq, n, dp, W, gpc, resv,
                                    resp, stream);
    case 1:
      return launch_probe<FoldMinAll>(qv, data, bias, nq, n, dp, W, gpc,
                                      resv, resp, stream);
    case 2:
      return launch_probe<FoldSerial>(qv, data, bias, nq, n, dp, W, gpc,
                                      resv, resp, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
