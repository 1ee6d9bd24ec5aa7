// Per-row top-k of a lane-min reservoir (K2), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// tpu_ann/ops/flat_knn_pallas.py::_reservoir_topk_kernel (launched by
// reservoir_topk). Python side, plain version and binding:
// tpu_ann_torch/ops/flat_knn_fused.py.
//
// Computes, for each row of an (nq, W) reservoir of f32 values and int32
// positions, the k smallest values in ascending order and their
// positions: k rounds of min extraction, where a tie goes to the lowest
// reservoir lane and a non-finite minimum gives (+inf, -1). Out: (nq, k).
//
// What bounds it on the H100: it reads the reservoir once (8 bytes per
// entry: 164 MB at 10k x 2048) and does k rounds of a 32-lane reduction per
// row, so it is HBM-bound when k is small against W. The TPU kernel
// re-scans the whole (QB, W) block on the vector unit every round; here
// one warp owns a row, lane l keeps entries l, l+32, ... in registers
// with its own running minimum, a round is one warp arg-min over 32
// candidates by shuffles, and only the winning lane rescans its W/32
// entries. Positions are read from memory only for the k winners. The
// output is (nq, k) directly (the TPU's 128-lane padded output is a
// lane-width rule and is not copied).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see tpu_ann_torch/kernels). Plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kWarps = 8;             // rows per CTA, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kWMax = 4096;
constexpr int kKMax = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = __builtin_huge_valf();

// PER = entries per lane (W <= 32 * PER; lanes past W hold +inf)
template <int PER>
__global__ void __launch_bounds__(kThreads)
reservoir_topk_kernel(const float* __restrict__ resv,  // (nq, W) f32
                      const int* __restrict__ resp,    // (nq, W) int32
                      int nq, int W, int k,
                      float* __restrict__ outv,        // (nq, k) f32
                      int* __restrict__ outp) {        // (nq, k) int32
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= nq) return;  // warp-uniform
  const float* rv = resv + static_cast<size_t>(row) * W;

  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < W ? rv[j] : kInf;
  }
  // this lane's minimum; strict < keeps the lowest entry on a tie
  float lm = kInf;
  int li = -1;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (v[i] < lm) {
      lm = v[i];
      li = i;
    }

  for (int r = 0; r < k; ++r) {
    // warp arg-min of (value, reservoir lane); every lane ends with it
    float bv = lm;
    int bj = li < 0 ? INT_MAX : lane + 32 * li;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oj = __shfl_xor_sync(kFull, bj, off);
      if (ov < bv || (ov == bv && oj < bj)) {
        bv = ov;
        bj = oj;
      }
    }
    if (lane == 0) {
      const size_t o = static_cast<size_t>(row) * k + r;
      const bool ok = isfinite(bv);
      outv[o] = ok ? bv : kInf;
      outp[o] = ok ? resp[static_cast<size_t>(row) * W + bj] : -1;
    }
    if (bj != INT_MAX && lane == (bj & 31)) {
      // knock the winner out and rescan this lane's entries
      const int wi = bj >> 5;
      lm = kInf;
      li = -1;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (i == wi) v[i] = kInf;
        if (v[i] < lm) {
          lm = v[i];
          li = i;
        }
      }
    }
  }
}

template <int PER>
void launch(const void* resv, const void* resp, int nq, int W, int k,
            void* outv, void* outp, cudaStream_t stream) {
  const int grid = (nq + kWarps - 1) / kWarps;
  reservoir_topk_kernel<PER><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(resv), static_cast<const int*>(resp), nq, W,
      k, static_cast<float*>(outv), static_cast<int*>(outp));
}

}  // namespace

extern "C" {

// Launches ceil(nq / 8) CTAs of 8 warps on `stream`; allocates nothing.
// Needs 1 <= k <= min(128, W) and W <= 4096. Returns cudaGetLastError()
// (0 on success).
int reservoir_topk(const void* resv, const void* resp, int nq, int W, int k,
                   void* outv, void* outp, void* stream) {
  if (nq < 0 || W <= 0 || W > kWMax || k < 1 || k > kKMax || k > W)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq > 0) {
    const int per = (W + 31) / 32;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (per <= 4)
      launch<4>(resv, resp, nq, W, k, outv, outp, s);
    else if (per <= 8)
      launch<8>(resv, resp, nq, W, k, outv, outp, s);
    else if (per <= 16)
      launch<16>(resv, resp, nq, W, k, outv, outp, s);
    else if (per <= 32)
      launch<32>(resv, resp, nq, W, k, outv, outp, s);
    else if (per <= 64)
      launch<64>(resv, resp, nq, W, k, outv, outp, s);
    else
      launch<128>(resv, resp, nq, W, k, outv, outp, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
