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
// The function, with NS the output's slot count:
//   out[s] = xb[rows[i_s]], i_s the last i < NR with i % NS == s
//   (zeros for slots no copy reached when NR < NS);
//   xor[c] = XOR over all NR copies of the bit pattern of xb[rows[i], c],
//   each folded from its shared-memory slot after the copy landed, so the
//   output shows that every row was moved;
//   cycles[b] = CTA b's clock64() span, at the SM clock.
//
// What bounds it on the H100: bytes (NR rows of dp f32 read once), if
// enough copies are in flight: about 3.35 TB/s x ~1 us = 3.4 MB over the
// card, >= 26 KB an SM. One thread of one CTA issuing every copy through
// 16 slots (8 KB in flight on one SM of 132) is a latency chain of ~180 ns
// a copy, as kern2's one core is. Here the grid is sized to the SMs (two
// CTAs an SM where two rings fit, else one); CTA b takes the contiguous
// copies [b NR / G, (b+1) NR / G). Each CTA has a ring of kRing = 64
// one-row slots with a full and an empty mbarrier each. Warp 0 issues:
// its lane l issues the CTA's copies c = l, l + 32, ..., each one 1-D
// bulk copy (cp.async.bulk.shared::cluster.global.mbarrier::complete_tx
// ::bytes, the TMA unit's untiled mode, the Hopper counterpart of one DMA
// descriptor) into slot c % 64, after waiting on that slot's empty
// barrier. Four consumer warps take the copies c = w, w + 4, ...: wait on
// the slot's full barrier, XOR the row into registers with 16-byte shared
// loads, write it to out[i % NS] if i is one of the i_s, and free the
// slot. The warps' XORs meet in shared memory, and each CTA folds its XOR
// into the output with one atomicXor a word (the output starts at zero).
// A wait that never ends traps, so a fault fails the launch instead of
// holding the card.
//
// Python side, plain version and binding: tpu_ann_torch/ops/
// row_copy_probe.py. Plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNSMax = 32;          // output slots
constexpr int kRing = 64;           // ring slots a CTA, one row each
constexpr int kConsumers = 4;       // consumer warps
constexpr int kThreads = 32 * (1 + kConsumers);
constexpr int kBarBytes = 2 * kRing * 8;  // full then empty barriers
constexpr int kSmemMax = 232448;    // dynamic shared memory a CTA may use
constexpr int kSmemTwo = 113 * 1024;  // at most this, two CTAs fit an SM
// widest row: barriers, the CTA's XOR and the ring in kSmemMax
constexpr int kDpMax = (kSmemMax - kBarBytes) / (4 * (kRing + 1)) / 4 * 4;
constexpr int kVecMax = (kDpMax / 4 + 31) / 32;  // int4 a lane a row

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// waits for the phase of the given parity to complete; a wait that never
// ends (a fault in the ring's bookkeeping) traps
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
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

size_t smem_bytes(int dp) {
  return kBarBytes + sizeof(int) * static_cast<size_t>(dp) * (kRing + 1);
}

__global__ void __launch_bounds__(kThreads)
row_copy_probe_kernel(const float* __restrict__ xb,   // (nb, dp) f32
                      const int* __restrict__ rows,   // (nr,) in [0, nb)
                      int nr, int dp, int ns,
                      float* __restrict__ out,        // (ns, dp) f32, zeroed
                      int* __restrict__ xor_out,      // (dp,) int32, zeroed
                      long long* __restrict__ cycles) {  // (grid,)
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRing;
  int* cta_xor = reinterpret_cast<int*>(smem + kBarBytes);
  int4* ring = reinterpret_cast<int4*>(cta_xor + dp);  // kRing rows of dp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dv = dp / 4;                                // int4 a row
  const uint32_t bytes = static_cast<uint32_t>(dp) * 4u;
  const long long begin = static_cast<long long>(blockIdx.x) * nr / gridDim.x;
  const int n = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * nr / gridDim.x - begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), 1);
    }
    // make the initialised barriers visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < dp; c += kThreads) cta_xor[c] = 0;
  __syncthreads();
  const long long t0 = clock64();

  if (warp == 0) {
    // issuing lanes: lane l owns slots l and l + 32
    for (int c = lane; c < n; c += 32) {
      const int s = c % kRing;
      const int use = c / kRing;
      const int row = __ldg(rows + begin + c);
      if (use > 0) mbar_wait(smem_addr(empty + s), (use - 1) & 1);
      mbar_expect_tx(smem_addr(full + s), bytes);
      bulk_row_copy(smem_addr(ring + static_cast<size_t>(s) * dv),
                    xb + static_cast<size_t>(row) * dp, bytes,
                    smem_addr(full + s));
    }
  } else {
    int4 acc[kVecMax];
#pragma unroll
    for (int v = 0; v < kVecMax; ++v) acc[v] = make_int4(0, 0, 0, 0);
    for (int c = warp - 1; c < n; c += kConsumers) {
      const int s = c % kRing;
      mbar_wait(smem_addr(full + s), (c / kRing) & 1);
      const long long i = begin + c;
      const int4* src = ring + static_cast<size_t>(s) * dv;
      int4* dst = i + ns >= nr  // the last copy to reach slot i % ns
                      ? reinterpret_cast<int4*>(out) + (i % ns) * dv
                      : nullptr;
#pragma unroll
      for (int v = 0; v < kVecMax; ++v) {
        const int x = lane + 32 * v;
        if (x < dv) {
          const int4 r = src[x];
          acc[v].x ^= r.x;
          acc[v].y ^= r.y;
          acc[v].z ^= r.z;
          acc[v].w ^= r.w;
          if (dst) dst[x] = r;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(empty + s));
    }
#pragma unroll
    for (int v = 0; v < kVecMax; ++v) {
      const int x = lane + 32 * v;
      if (x < dv) {
        atomicXor(cta_xor + 4 * x, acc[v].x);
        atomicXor(cta_xor + 4 * x + 1, acc[v].y);
        atomicXor(cta_xor + 4 * x + 2, acc[v].z);
        atomicXor(cta_xor + 4 * x + 3, acc[v].w);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  if (n > 0)
    for (int c = threadIdx.x; c < dp; c += kThreads)
      atomicXor(xor_out + c, cta_xor[c]);
}

}  // namespace

extern "C" {

// The widest row (f32 words) the probe takes.
int row_copy_probe_dp_max() { return kDpMax; }

// CTAs of a launch for nr copies of dp-wide rows on the current device:
// one or two an SM (two where two rings fit), at most nr, at least 1.
int row_copy_probe_ctas(int nr, int dp) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long most = static_cast<long long>(sms) *
                         (smem_bytes(dp) <= static_cast<size_t>(kSmemTwo)
                              ? 2 : 1);
  return static_cast<int>(nr < 1 ? 1 : nr < most ? nr : most);
}

// The probe on `stream`: row_copy_probe_ctas(nr, dp) CTAs; allocates
// nothing. out (ns, dp) and xor (dp,) must be zero on entry; cycles holds
// one int64 a CTA. dp must be a positive multiple of 4 (16-byte rows) and
// at most row_copy_probe_dp_max(), 1 <= ns <= 32, xb 16-byte aligned,
// every row in [0, nb). Returns cudaGetLastError() (0 on success).
int row_copy_probe(const void* xb, const void* rows, int nr, int dp, int ns,
                   void* out, void* xor_out, void* cycles, void* stream) {
  if (nr < 0 || dp <= 0 || dp % 4 != 0 || dp > kDpMax || ns < 1 ||
      ns > kNSMax || reinterpret_cast<uintptr_t>(xb) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(dp);
  cudaError_t e = cudaFuncSetAttribute(
      row_copy_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  row_copy_probe_kernel<<<row_copy_probe_ctas(nr, dp), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xb), static_cast<const int*>(rows), nr, dp,
      ns, static_cast<float*>(out), static_cast<int*>(xor_out),
      static_cast<long long*>(cycles));
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
