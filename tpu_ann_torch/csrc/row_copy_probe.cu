// Row-copy issue probe (B2) for NVIDIA Hopper (sm_90a): the cost of
// issuing many single-row copies from global memory into shared memory.
//
// Replaces the DMA-issue microbenchmark of the round-5 harness,
// benchs/r5/r5_queue7.py:43-119 (kern2): one TPU core issues NR single-row
// HBM -> VMEM DMAs through NS semaphore slots, waiting on a slot before it
// reuses it and draining every slot at the end. The question it answers is
// whether a refine's per-candidate row gather (about 400k rows per 10k
// queries) could be folded into a kernel as row copies.
//
// Here one CTA has one issuing thread and NS shared-memory slots of one
// dp-wide f32 row each. Each copy is one 1-D bulk copy
// (cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes, the
// TMA unit's untiled mode: dp * 4 bytes, a multiple of 16) completing on
// its slot's mbarrier, the Hopper counterpart of one DMA descriptor and
// its semaphore. Copy i goes to slot i % NS; before the copy the thread
// waits for the slot's previous copy; after the last copy it waits for
// every slot. Then the CTA writes the slots to an (NS, dp) output, so the
// result can be checked:
//   out[s] = xb[rows[i_s]], i_s the last i < NR with i % NS == s
//   (zeros for slots no copy reached when NR < NS).
// cycles[0] is the issuing thread's clock64() span over the issue loop and
// the drain, at the SM clock.
//
// Python side, plain version and binding: tpu_ann_torch/ops/
// row_copy_probe.py. Plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNSMax = 32;        // slots (one parity bit each)
constexpr int kBarBytes = 256;    // the barriers' region, keeps slots aligned
constexpr int kThreads = 128;     // threads that write the output

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of transactions to complete
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_row_copy(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
row_copy_probe_kernel(const float* __restrict__ xb,   // (nb, dp) f32
                      const int* __restrict__ rows,   // (nr,) in [0, nb)
                      int nr, int dp, int ns,
                      float* __restrict__ out,        // (ns, dp) f32
                      long long* __restrict__ cycles) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* slots = reinterpret_cast<float*>(smem + kBarBytes);
  const uint32_t bytes = static_cast<uint32_t>(dp) * 4u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) mbar_init(smem_addr(bars + s), 1);
    // make the initialised barriers visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    uint32_t parity = 0;  // bit s: the phase slot s waits for next
    const long long t0 = clock64();
    for (int i = 0; i < nr; ++i) {
      const int s = i % ns;
      const uint32_t bar = smem_addr(bars + s);
      if (i >= ns) {  // retire the slot's previous copy
        mbar_wait(bar, (parity >> s) & 1u);
        parity ^= 1u << s;
      }
      mbar_expect_tx(bar, bytes);
      bulk_row_copy(smem_addr(slots + static_cast<size_t>(s) * dp),
                    xb + static_cast<size_t>(__ldg(rows + i)) * dp, bytes,
                    bar);
    }
    const int used = min(nr, ns);
    for (int s = 0; s < used; ++s)  // drain
      mbar_wait(smem_addr(bars + s), (parity >> s) & 1u);
    cycles[0] = clock64() - t0;
  }
  __syncthreads();
  const int filled = min(nr, ns) * dp;
  for (int i = threadIdx.x; i < ns * dp; i += blockDim.x)
    out[i] = i < filled ? slots[i] : 0.f;
}

}  // namespace

extern "C" {

// The probe on `stream`: one CTA; allocates nothing. dp must be a positive
// multiple of 4 (16-byte rows), 1 <= ns <= 32, xb 16-byte aligned, every
// row in [0, nb). Returns cudaGetLastError() (0 on success).
int row_copy_probe(const void* xb, const void* rows, int nr, int dp, int ns,
                   void* out, void* cycles, void* stream) {
  if (nr < 0 || dp <= 0 || dp % 4 != 0 || ns < 1 || ns > kNSMax ||
      reinterpret_cast<uintptr_t>(xb) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kBarBytes + sizeof(float) * static_cast<size_t>(ns) * dp;
  cudaError_t e = cudaFuncSetAttribute(
      row_copy_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  row_copy_probe_kernel<<<1, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xb), static_cast<const int*>(rows), nr, dp,
      ns, static_cast<float*>(out), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// The SM clock of `device` that cudaDeviceProp reports (clockRate), kHz;
// 0 on error.
int row_copy_probe_sm_khz(int device) {
  int khz = 0;
  if (cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, device) !=
      cudaSuccess)
    return 0;
  return khz;
}

}  // extern "C"
