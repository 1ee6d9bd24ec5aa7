// Out-of-core IVF window scan (K4): the list-major fused scan over one
// window of the block stream that the host pipeline has put on the device,
// merged into each pair's running top-kp, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_ann/ops/ivf_scan_paged.py::_make_window_kernel
// (launched by scan_invlists_paged once per (window, tile batch)). Python
// side, plain version (scan_window_reference) and binding:
// tpu_ann_torch/ops/ivf_scan_paged.py.
//
// Against the TPU kernel:
// - It reads the global pair plan once: the device arrays of plan_pairs
//   plus the window's first block and width, and clamps every pair and tile
//   range in the kernel, where the TPU version built and uploaded seven
//   window-local arrays per call.
// - It returns global positions and merges into the running per-pair top-kp
//   in place (the kernel starts each pair's list from it), so no separate
//   merge pass reads and writes (tiles, kp, PT) per call; a pair with
//   nothing in the window keeps its list untouched. An earlier window
//   holds lower positions, so on equal distances the running entry wins,
//   the tie rule of the reference's merge_topk.
// - The window buffer holds only real blocks: no CB-block over-read
//   padding, since no clamped range reaches past the stream's last block.
// The kernel body, its design and what bounds it are in ivf_scan_core.cuh
// (shared with K3): a tile streams only its segments' rows clamped to the
// window, so a list the window cuts is finished by the next launch. As K3,
// one kernel keeps kp up to 32, a second, with two list entries a lane
// (32 pairs a CTA, two CTAs an SM), kp 33 to 64, and a third any kp
// above, its running lists copied from run_d / run_p into shared memory,
// merged there and written back (past what shared memory holds, merged
// in place in run_d / run_p). On the out-of-core path the scan of a
// window overlaps the host-to-device copy of the next one; the pipeline
// is bound by that copy's bytes over the host link when the window's scan
// takes less time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see tpu_ann_torch/kernels). Plain C interface.

#include "ivf_scan_core.cuh"

namespace {

// K3's launch bounds: two CTAs an SM.
__global__ void __launch_bounds__(ivf_scan::kThreads, 2)
ivf_scan_window_kernel(IVF_SCAN_TILE_PARAMS(uint16_t)) {
  ivf_scan::scan_tile<true>(IVF_SCAN_TILE_ARGS);
}

// The wide lists (kp 33 to 64): 32 pairs a CTA (at 64 the window kernel
// needs more than 128 registers), two CTAs an SM.
__global__ void __launch_bounds__(ivf_scan::kThreads, 2)
ivf_scan_window_wide_kernel(IVF_SCAN_TILE_PARAMS(uint16_t)) {
  ivf_scan::scan_tile<true, uint16_t, 2, ivf_scan::kPTWideWindow>(
      IVF_SCAN_TILE_ARGS);
}

// The lists above kp 64: in shared memory, np pairs a CTA.
__global__ void __launch_bounds__(ivf_scan::kThreads, 2)
ivf_scan_window_global_kernel(IVF_SCAN_TILE_PARAMS(uint16_t)) {
  ivf_scan::scan_tile<true, uint16_t, ivf_scan::kRGlobal>(IVF_SCAN_TILE_ARGS);
}

}  // namespace

extern "C" {

// pairs per tile the kernel is written for (the wrapper checks it)
int ivf_scan_window_tile_pairs() { return ivf_scan::kPT; }

// Scans tiles [tile0, tile0 + ntiles) against the window of blocks
// [w0, w0 + nwin), whose rows lie at data / ids / norms, and merges the
// result into run_d / run_p ((ntiles_total * kPT, kp), global positions) in
// place (any kp >= 1). One CTA per tile on `stream`; allocates nothing.
// Returns cudaGetLastError() (0 on success).
int ivf_scan_window(const void* xq, const void* qn, const void* pair_q,
                    const void* pstart, const void* pend, const void* tile_bs,
                    const void* tile_nb, const void* data, const void* ids,
                    const void* norms, int w0, int nwin, int tile0,
                    int ntiles, int d, int B, int kp, int similarity,
                    void* run_d, void* run_p, void* stream) {
  if (w0 < 0 || nwin < 0 || B <= 0 ||
      static_cast<long long>(w0 + static_cast<long long>(nwin)) * B >=
          INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kp > 2 * ivf_scan::kKPMax)
    return ivf_scan::launch_scan_tiles<uint16_t, ivf_scan::kRGlobal>(
        ivf_scan_window_global_kernel, xq, qn, pair_q, pstart, pend, tile_bs,
        tile_nb, data, ids, norms, w0 * B, (w0 + nwin) * B, tile0, ntiles, d,
        B, kp, similarity, run_d, run_p, stream);
  if (kp > ivf_scan::kKPMax)
    return ivf_scan::launch_scan_tiles<uint16_t, 2, ivf_scan::kPTWideWindow>(
        ivf_scan_window_wide_kernel, xq, qn, pair_q, pstart, pend, tile_bs,
        tile_nb, data, ids, norms, w0 * B, (w0 + nwin) * B, tile0, ntiles, d,
        B, kp, similarity, run_d, run_p, stream);
  return ivf_scan::launch_scan_tiles(
      ivf_scan_window_kernel, xq, qn, pair_q, pstart, pend, tile_bs, tile_nb,
      data, ids, norms, w0 * B, (w0 + nwin) * B, tile0, ntiles, d, B, kp,
      similarity, run_d, run_p, stream);
}

}  // extern "C"
