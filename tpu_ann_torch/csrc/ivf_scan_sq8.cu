// List-major fused IVF scan over the SQ8 stream (K3-SQ8): per (query,
// probe) pair, the exact top-kp stream rows of the pair's inverted list,
// scored against uint8 codes, for NVIDIA Hopper (sm_90a).
//
// Replaces the uint8 branch of the TPU kernel tpu_ann/ops/ivf_scan_pallas.py
// ::_grouped_kernel (the in-kernel cast of a uint8 chunk, :172-180, under
// scan_invlists_fused with a PackedInvListsSQ8). Python side, plain version
// and binding: tpu_ann_torch/ops/ivf_scan_fused.py, which folds the dequant
// affine into the queries (q' = bf16(q * scale), qn = |q|^2 - 2 q.bias for
// L2, q.bias for IP) and re-ranks on the dequantized rows.
//
// The kernel is K3's body (ivf_scan_core.cuh) instantiated on a uint8
// stream: each chunk's codes land in shared memory as bytes (8-byte
// cp.async copies) and are widened there to the bf16 operand tile, so the
// stream's HBM bytes halve while the tensor-core products and the top-kp
// epilogue are K3's, with K3's three kernels: up to kp 32, with two list
// entries a lane up to kp 64, and with the lists in shared memory (in its
// output rows past what it holds) above.
// It is a library of its own so that K3's instantiations, and their
// register counts, stay as they are.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see tpu_ann_torch/kernels). Plain C interface.

#include "ivf_scan_core.cuh"

namespace {

// K3's launch bounds: two CTAs an SM.
__global__ void __launch_bounds__(ivf_scan::kThreads, 2)
ivf_scan_sq8_kernel(IVF_SCAN_TILE_PARAMS(uint8_t)) {
  ivf_scan::scan_tile<false>(IVF_SCAN_TILE_ARGS);
}

// K3's wide lists (kp 33 to 64): 64 pairs a CTA, two CTAs an SM.
__global__ void __launch_bounds__(ivf_scan::kThreads, 2)
ivf_scan_sq8_wide_kernel(IVF_SCAN_TILE_PARAMS(uint8_t)) {
  ivf_scan::scan_tile<false, uint8_t, 2, ivf_scan::kPTWide>(
      IVF_SCAN_TILE_ARGS);
}

// K3's lists above kp 64: in shared memory, np pairs a CTA.
__global__ void __launch_bounds__(ivf_scan::kThreads, 2)
ivf_scan_sq8_global_kernel(IVF_SCAN_TILE_PARAMS(uint8_t)) {
  ivf_scan::scan_tile<false, uint8_t, ivf_scan::kRGlobal>(IVF_SCAN_TILE_ARGS);
}

}  // namespace

extern "C" {

// pairs per tile the kernel is written for (the wrapper checks it)
int ivf_scan_sq8_tile_pairs() { return ivf_scan::kPT; }

// Launches one CTA per tile on `stream` (any kp >= 1); allocates
// nothing. `codes` is the (rows, d) uint8 stream, each row 8-byte aligned
// (d % 8 == 0). Returns cudaGetLastError() (0 on success).
int ivf_scan_sq8(const void* xq, const void* qn, const void* pair_q,
                 const void* pstart, const void* pend, const void* tile_bs,
                 const void* tile_nb, const void* codes, const void* ids,
                 const void* norms, int ntiles, int d, int B, int kp,
                 int similarity, void* out_d, void* out_p, void* stream) {
  if (kp > 2 * ivf_scan::kKPMax)
    return ivf_scan::launch_scan_tiles<uint8_t, ivf_scan::kRGlobal>(
        ivf_scan_sq8_global_kernel, xq, qn, pair_q, pstart, pend, tile_bs,
        tile_nb, codes, ids, norms, /*wrow0=*/0, /*wrow1=*/INT_MAX,
        /*tile0=*/0, ntiles, d, B, kp, similarity, out_d, out_p, stream);
  if (kp > ivf_scan::kKPMax)
    return ivf_scan::launch_scan_tiles<uint8_t, 2, ivf_scan::kPTWide>(
        ivf_scan_sq8_wide_kernel, xq, qn, pair_q, pstart, pend, tile_bs,
        tile_nb, codes, ids, norms, /*wrow0=*/0, /*wrow1=*/INT_MAX,
        /*tile0=*/0, ntiles, d, B, kp, similarity, out_d, out_p, stream);
  return ivf_scan::launch_scan_tiles<uint8_t>(
      ivf_scan_sq8_kernel, xq, qn, pair_q, pstart, pend, tile_bs, tile_nb,
      codes, ids, norms, /*wrow0=*/0, /*wrow1=*/INT_MAX, /*tile0=*/0, ntiles,
      d, B, kp, similarity, out_d, out_p, stream);
}

}  // extern "C"
