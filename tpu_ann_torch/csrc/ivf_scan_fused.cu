// List-major fused IVF scan (K3): per (query, probe) pair, the exact top-kp
// stream rows of the pair's inverted list, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_ann/ops/ivf_scan_pallas.py::_grouped_kernel
// (launched by scan_invlists_fused). Python side, plain version and
// binding: tpu_ann_torch/ops/ivf_scan_fused.py. The kernel itself, its
// design and what bounds it are in ivf_scan_core.cuh, which the SQ8 scan
// (K3-SQ8, ivf_scan_sq8.cu) and the out-of-core window scan (K4,
// ivf_scan_paged.cu) share; K3 runs its instantiation without the window
// code, over the whole bf16 stream: one kernel up to kp 32, one with two
// list entries a lane up to kp 64 (an IVFHNSW quantizer's hop-0 scan, an
// IVFPQR's kp 46), and one with the lists in shared memory (in its output
// rows past 2969 entries at d 128) for any kp above (a search at k >= 59,
// an IVFPQR at k >= 15), chosen by kp at launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see tpu_ann_torch/kernels). Plain C interface.

#include "ivf_scan_core.cuh"

namespace {

// Two CTAs an SM: at most 128 registers a thread (the body's shared
// memory, 108 KB at d = 128, fits twice).
__global__ void __launch_bounds__(ivf_scan::kThreads, 2)
ivf_scan_fused_kernel(IVF_SCAN_TILE_PARAMS(uint16_t)) {
  ivf_scan::scan_tile<false>(IVF_SCAN_TILE_ARGS);
}

// The wide lists (kp 33 to 64): two list entries a lane, 64 pairs a CTA
// (two CTAs a tile), two CTAs an SM.
__global__ void __launch_bounds__(ivf_scan::kThreads, 2)
ivf_scan_fused_wide_kernel(IVF_SCAN_TILE_PARAMS(uint16_t)) {
  ivf_scan::scan_tile<false, uint16_t, 2, ivf_scan::kPTWide>(
      IVF_SCAN_TILE_ARGS);
}

// The lists in shared memory (kp 65 and up; in the output rows past what
// it holds): no list registers, np pairs a CTA (global_lists), two CTAs
// an SM where they fit.
__global__ void __launch_bounds__(ivf_scan::kThreads, 2)
ivf_scan_fused_global_kernel(IVF_SCAN_TILE_PARAMS(uint16_t)) {
  ivf_scan::scan_tile<false, uint16_t, ivf_scan::kRGlobal>(
      IVF_SCAN_TILE_ARGS);
}

}  // namespace

extern "C" {

// pairs per tile the kernel is written for (the wrapper checks it)
int ivf_scan_fused_tile_pairs() { return ivf_scan::kPT; }

// Launches one CTA per tile on `stream` (any kp >= 1); allocates nothing.
// Returns cudaGetLastError() (0 on success).
int ivf_scan_fused(const void* xq, const void* qn, const void* pair_q,
                   const void* pstart, const void* pend, const void* tile_bs,
                   const void* tile_nb, const void* data, const void* ids,
                   const void* norms, int ntiles, int d, int B, int kp,
                   int similarity, void* out_d, void* out_p, void* stream) {
  if (kp > 2 * ivf_scan::kKPMax)
    return ivf_scan::launch_scan_tiles<uint16_t, ivf_scan::kRGlobal>(
        ivf_scan_fused_global_kernel, xq, qn, pair_q, pstart, pend, tile_bs,
        tile_nb, data, ids, norms, /*wrow0=*/0, /*wrow1=*/INT_MAX,
        /*tile0=*/0, ntiles, d, B, kp, similarity, out_d, out_p, stream);
  if (kp > ivf_scan::kKPMax)
    return ivf_scan::launch_scan_tiles<uint16_t, 2, ivf_scan::kPTWide>(
        ivf_scan_fused_wide_kernel, xq, qn, pair_q, pstart, pend, tile_bs,
        tile_nb, data, ids, norms, /*wrow0=*/0, /*wrow1=*/INT_MAX,
        /*tile0=*/0, ntiles, d, B, kp, similarity, out_d, out_p, stream);
  return ivf_scan::launch_scan_tiles(
      ivf_scan_fused_kernel, xq, qn, pair_q, pstart, pend, tile_bs, tile_nb,
      data, ids, norms, /*wrow0=*/0, /*wrow1=*/INT_MAX, /*tile0=*/0, ntiles,
      d, B, kp, similarity, out_d, out_p, stream);
}

}  // extern "C"
