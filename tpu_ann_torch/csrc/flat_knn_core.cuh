// Device code shared by the fused flat scan (K1, flat_knn_fused.cu) and its
// variants (flat_knn_variants.cu: the packed reservoir K1p and the probe
// folds B1): each query's W-wide lane-min reservoir over the whole packed
// database, for NVIDIA Hopper (sm_90a).
//
// Replaces the body of the TPU kernels tpu_ann/ops/flat_knn_pallas.py::
// _flat_kernel_grid (K1; the fori / pipe / unrolled schedules compute the
// same reservoir), _flat_kernel_grid_packed and _flat_kernel_packed (K1p),
// and the probe merges the round-4 harness plugs into _flat_kernel_grid
// (B1: benchs/r4/r4_queue3.py:149, benchs/r4/r4_queue4.py:157).
//
// Computes, for queries q (pre-scaled bf16: -2q for L2, -q for IP) and
// packed rows x (bf16, dp = d rounded up to 16) with an f32 bias per row
// (L2 norm or 0, plus the packed fold's shift; +inf for padded, invalid or
// masked rows):
//   score(q, r) = bias[r] + q . x_r           (f32 accumulation)
// and folds the scores of rows r = g*W + j, g = 0, 1, ..., into lane j of
// query q with a fold policy:
//   FoldSerial  (K1)  the smallest score and its group; strict < keeps the
//                     earlier row on a tie. Out: f32 values, int32 rows.
//   FoldPacked  (K1p) one int32 per lane, min over (bits(score) &
//                     0xFFFF0000) + g, from 0x7FFFFFFF: the score's top 16
//                     bits and the group in one integer min (a tie keeps
//                     the lower group, as strict < does). Out: the int32s.
//   FoldMin1    (B1)  f32 min over the groups g % gpc == 0 only (gpc =
//                     groups per reference chunk, R / W); rows -1.
//   FoldMinAll  (B1)  f32 min over every group; rows -1.
// Every group's products are computed whatever the fold (the wgmma is asm
// volatile), so the folds differ only in the epilogue.
//
// What bounds it on the H100: operations. At 10k queries x 1M rows x 128-d
// the scan is 2.56 TFLOP, 2.59 ms at the 989 TFLOP/s bf16 tensor-core peak;
// the 256 MB base read once from HBM is 0.08 ms. Five things held the
// first (mma.sync) body at ~15% of that peak, and the design answers each:
//  1. Warp-level mma.sync fed by ldmatrix moves 2 KB of shared memory per
//     32 KFLOP, which caps an SM near half its peak. Here the products are
//     wgmma.mma_async m64n128k16 (bf16 in, f32 accumulate) reading both
//     operands from 128-byte-swizzled shared memory through descriptors: no
//     register traffic for the operands, and the queries' tile is read by
//     the tensor cores in place.
//  2. A CTA now owns 128 queries (two consumer warpgroups of 64) x 128
//     lanes, so each row crosses L2 once per 128 queries, half as often.
//  3. One producer thread issues every load with TMA: a tensor map over the
//     (n, dp) bf16 base, boxes of 64 dims x 128 rows, a ring of stages
//     completed on mbarriers, and the group's 128 bias floats as a 1-D bulk
//     copy on the same barrier. No consumer thread computes a load address.
//     The box runs past dp as zeros (dp = 80 or 144 needs no mask: a zero
//     column adds 0 to every score); the query box runs past nq as zeros.
//  4. One CTA an SM (about 170 KB of shared memory at dp 128): the producer
//     warpgroup gives its registers up (setmaxnreg), so each consumer thread
//     holds 64 accumulators and its 64 reservoir states (two words each for
//     the serial fold) without spilling.
//  5. The fold runs beside the tensor cores: the two consumer warpgroups
//     take turns issuing a group's products (two named barriers, as
//     CUTLASS's ping-pong schedule orders them), so one folds group g while
//     the other's wgmmas of group g run, and a warpgroup hands the turn on
//     as soon as its group is issued.
// Two consumers need a ring that holds a whole group's slabs: a stage is
// freed only once both warpgroups have read it, and the second starts on a
// group only after the first has issued all of it. Above dp 384 the 128
// queries leave fewer stages than that, so the CTA drops to one consumer
// warpgroup of 64 queries (dp up to 1024). It does so too where 64-query
// CTAs fill at most one wave (few queries on few lane blocks), and a CTA
// whose queries end within its first 64 runs one consumer.
//
// Where it stands (H100 80GB HBM3 at 700 W, chip_smoke.py): ~5.4 ms at 10k
// queries x 1M x 128-d, 47% of the bf16 peak, against 17.4 ms for the
// mma.sync body. With the fold cut to one group in eight (B1's min1) it
// takes ~3.8 ms, 68%; a plain min a score (minall) adds ~0.8 ms and the
// serial fold's compare and two selects ~1.6 ms, so the fold overlaps the
// other warpgroup's products only in part. A copy of the body whose
// producer stops loading after the first ring fill ran as fast as this
// one: L2 and TMA do not bound it, so neither of the next steps planned
// for the feed (a persistent grid, a cluster of two query blocks sharing a
// multicast row tile) was built. Tried and kept: the turn handed over
// right after the group's last commit. Tried and dropped, each slower or
// no faster: a wgmma under a per-k-step dp condition (ptxas issues it
// apart from its neighbours), a 4-stage ring, holding a group's slabs
// until its last wait, handing over after the first slab, and consumers
// running free without turns.
//
// The grid is one CTA per (query block, lane block), lane blocks fastest,
// so the CTAs resident together read the same rows and share them through
// L2. A lane's rows are all visited by one CTA, in increasing group order,
// so no merge across CTAs is needed. The thread holding accumulator element
// i holds the same (query, lane) pair in every group: the reservoir lives in
// registers beside the accumulator, and each group starts with the wgmma's
// accumulator scale at 0 instead of a zeroing pass.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flat_knn {

constexpr int kLB = 128;              // reservoir lanes per CTA (wgmma N)
constexpr int kWGQ = 64;              // queries per consumer warpgroup (M)
constexpr int kKS = 64;               // dims per slab: one 128-byte row
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kDPMax = 1024;          // widest padded dimension
constexpr int kMaxStages = 8;         // ring depth where shared memory allows
constexpr int kSlabBytes = kLB * kKS * 2;   // one stage of rows: 16 KB
constexpr int kBiasBytes = kLB * 4;         // one group's bias: 512 B
constexpr size_t kSmemMax = 232448;         // a CTA's dynamic shared memory
constexpr float kInf = __builtin_huge_valf();
constexpr int kPackedInit = 0x7FFFFFFF;
constexpr int kHiMask = static_cast<int>(0xFFFF0000u);

// The shared-memory plan of a launch, the same on the host and the device:
// the queries' slabs [nks][qtile rows][64 dims], the ring of row slabs and
// their bias, then the mbarriers (full[stages], empty[stages], queries).
struct Layout {
  int qtile;      // queries per CTA: 128 (two consumers) or 64 (one)
  int nks;        // 64-dim slabs per row
  int stages;     // ring depth
  int a_bytes;    // the queries' slabs
  size_t smem;    // dynamic shared memory, with 1 KB to align the base
};

// qtile is 128 where asked for (`two`) and the ring then still holds a
// whole group (stages >= nks, dp <= 384), else 64.
__host__ __device__ inline Layout layout(int dp, bool two) {
  Layout L;
  L.nks = (dp + kKS - 1) / kKS;
  const int per = kSlabBytes + kBiasBytes + 16;
  for (int nc = two ? 2 : 1;; --nc) {
    L.qtile = nc * kWGQ;
    L.a_bytes = L.nks * L.qtile * kKS * 2;
    const int fit =
        static_cast<int>((kSmemMax - 1024 - 8 - L.a_bytes) / per);
    L.stages = fit < kMaxStages ? fit : kMaxStages;
    if (nc == 1 || L.stages >= L.nks) break;
  }
  L.smem = 1024 + static_cast<size_t>(L.a_bytes) +
           static_cast<size_t>(L.stages) * (kSlabBytes + kBiasBytes) +
           (2 * L.stages + 1) * 8;
  return L;
}

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma, named barriers, register moves.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// returns once the barrier's phase `parity` has completed; a wait that
// never ends (a fault in the ring's bookkeeping) traps, so the launch fails
// instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// a (64 dims x rows) box of the 2-D tensor map at (dim c0, row c1)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// K-major operand in 128-byte-swizzled rows of 64 bf16 (as TMA's
// SWIZZLE_128B writes them): 8-row atoms 1024 B apart (SBO), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching the accumulators across a wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = [d if accumulate] + A (64 x 16) . B (128 x 16)^T,
// both bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// Fold policies: the per-(query, lane) state, the fold of one score of
// group g, and the store of two adjacent lanes c, c + 1 of row q at o.
// ---------------------------------------------------------------------------

struct FoldSerial {
  struct State {
    float v;
    int g;
  };
  __device__ static bool active(int, int) { return true; }
  __device__ static void init(State& s) {
    s.v = kInf;
    s.g = -1;
  }
  __device__ static void fold(State& s, float score, int g) {
    if (score < s.v) {
      s.v = score;
      s.g = g;
    }
  }
  __device__ static void store(const State& a, const State& b, size_t o,
                               int c, int W, float* out_v, int* out_p) {
    *reinterpret_cast<float2*>(out_v + o) = make_float2(a.v, b.v);
    *reinterpret_cast<int2*>(out_p + o) =
        make_int2(a.g < 0 ? -1 : a.g * W + c, b.g < 0 ? -1 : b.g * W + c + 1);
  }
};

struct FoldPacked {
  struct State {
    int a;
  };
  __device__ static bool active(int, int) { return true; }
  __device__ static void init(State& s) { s.a = kPackedInit; }
  __device__ static void fold(State& s, float score, int g) {
    s.a = min(s.a, (__float_as_int(score) & kHiMask) + g);
  }
  __device__ static void store(const State& a, const State& b, size_t o, int,
                               int, float*, int* out_p) {
    *reinterpret_cast<int2*>(out_p + o) = make_int2(a.a, b.a);
  }
};

template <bool kEveryGroup>
struct FoldMin {
  struct State {
    float v;
  };
  __device__ static bool active(int g, int gpc) {
    return kEveryGroup || g % gpc == 0;
  }
  __device__ static void init(State& s) { s.v = kInf; }
  __device__ static void fold(State& s, float score, int) {
    s.v = fminf(s.v, score);
  }
  __device__ static void store(const State& a, const State& b, size_t o, int,
                               int, float* out_v, int* out_p) {
    *reinterpret_cast<float2*>(out_v + o) = make_float2(a.v, b.v);
    *reinterpret_cast<int2*>(out_p + o) = make_int2(-1, -1);
  }
};
using FoldMin1 = FoldMin<false>;
using FoldMinAll = FoldMin<true>;

// ---------------------------------------------------------------------------
// The body of one CTA (see the header comment): warpgroup 0 loads,
// warpgroups 1 and 2 multiply and fold. qtile is the launch's queries per
// CTA (prepare_launch); gpc is FoldMin1's groups per reference chunk and
// unused by the other folds.
// ---------------------------------------------------------------------------

template <class Fold>
__device__ __forceinline__ void scan_body(
    const CUtensorMap& qmap,            // (nq, dp) bf16 queries, pre-scaled
    const CUtensorMap& dmap,            // (n, dp) bf16 packed rows
    const float* __restrict__ bias,     // (n,) f32
    int nq, int n, int dp, int W, int qtile, int gpc,
    float* __restrict__ out_v,          // (nq, W) f32 (unused by K1p)
    int* __restrict__ out_p) {          // (nq, W) int32
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Layout L = layout(dp, qtile == 2 * kWGQ);
  unsigned char* as = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xs = as + L.a_bytes;  // [stages][kLB rows][64 dims]
  float* bs = reinterpret_cast<float*>(xs + L.stages * kSlabBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + L.stages * kLB);
  uint64_t* empty = full + L.stages;
  uint64_t* qbar = empty + L.stages;

  // a 1-D grid, lane blocks fastest: no 65535 bound on the query blocks
  const int nlb = W / kLB;
  const int qb = static_cast<int>(blockIdx.x / nlb);
  const int j0 = static_cast<int>(blockIdx.x - qb * nlb) * kLB;
  const int q0 = qb * L.qtile;
  // consumer warpgroups: a second one only if some of its queries are real
  const int nc = L.qtile == 2 * kWGQ && nq - q0 > kWGQ ? 2 : 1;
  const int ngroups = n / W;
  // the warpgroup, broadcast so the compiler sees it uniform (a role
  // branch it cannot prove uniform serializes the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7,
                             0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * nc);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer: one thread issues every copy ----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, L.nks * nc * kWGQ * kKS * 2);
      for (int s = 0; s < L.nks; ++s)
        for (int w = 0; w < nc; ++w)
          tma_load_2d(as + (s * L.qtile + w * kWGQ) * 128, &qmap, s * kKS,
                      q0 + w * kWGQ, qbar);
      int stage = 0;
      uint32_t phase = 0;
      for (int g = 0; g < ngroups; ++g) {
        for (int ks = 0; ks < L.nks; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          const bool last = ks == L.nks - 1;
          mbar_expect_tx(&full[stage], kSlabBytes + (last ? kBiasBytes : 0));
          tma_load_2d(xs + stage * kSlabBytes, &dmap, ks * kKS, g * W + j0,
                      &full[stage]);
          if (last)
            bulk_load(bs + stage * kLB, bias + static_cast<size_t>(g) * W + j0,
                      kBiasBytes, &full[stage]);
          if (++stage == L.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // -- consumers: warpgroup c owns queries q0 + 64c .. + 64 ---------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    if (c >= nc) return;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5;
    const int lane = t & 31;

    // accumulator element i = 4j + 2h + e: query row 16*warp + lane/4 + 8h,
    // lane column 8j + 2*(lane%4) + e
    float acc[64];
    typename Fold::State best[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      Fold::init(best[i]);
    }
    const uint32_t a0 = smem_addr(as) + c * kWGQ * 128;
    const uint32_t x0 = smem_addr(xs);
    const int mine = 1 + c, other = 2 - c;  // named barriers: whose turn
    mbar_wait(qbar, 0);
    if (nc == 2 && c == 1) named_arrive(1);  // warpgroup 1 issues first

    int stage = 0;
    uint32_t phase = 0;
    for (int g = 0; g < ngroups; ++g) {
      // this warpgroup's turn: issue every slab of group g
      if (nc == 2) named_sync(mine);
      int prev = -1;
      for (int ks = 0; ks < L.nks; ++ks) {
        mbar_wait(&full[stage], phase);
        wgmma_fence();
        const uint32_t a = a0 + ks * L.qtile * 128;
        const uint32_t x = x0 + stage * kSlabBytes;
        // all four k-steps even where the slab runs past dp (zeros there):
        // a wgmma under a condition is issued apart from its neighbours
#pragma unroll
        for (int kk = 0; kk < kKS / 16; ++kk)
          wgmma_m64n128k16(acc, sw128_desc(a + kk * 32),
                           sw128_desc(x + kk * 32), (ks | kk) != 0);
        wgmma_commit();
        // the group is issued: the other warpgroup's turn (it has no turn
        // after its last group)
        if (ks == L.nks - 1 && nc == 2 && (c == 0 || g + 1 < ngroups))
          named_arrive(other);
        if (prev >= 0) {
          wgmma_wait<1>();  // the previous slab's products are done
          mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == L.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);

      if (Fold::active(g, gpc)) {
        // group g complete: fold its scores into the reservoir
        const float* bg = bs + prev * kLB + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 bv = *reinterpret_cast<const float2*>(bg + 8 * j);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            Fold::fold(best[4 * j + 2 * h], acc[4 * j + 2 * h] + bv.x, g);
            Fold::fold(best[4 * j + 2 * h + 1], acc[4 * j + 2 * h + 1] + bv.y,
                       g);
          }
        }
      }
      // a group the fold skips had its products computed all the same
      mbar_arrive(&empty[prev]);
    }

    const int qr = q0 + c * kWGQ + warp * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = qr + 8 * h;
      if (q >= nq) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = j0 + 8 * j + 2 * (lane & 3);
        const size_t o = static_cast<size_t>(q) * W + col;
        Fold::store(best[4 * j + 2 * h], best[4 * j + 2 * h + 1], o, col, W,
                    out_v, out_p);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the tensor maps and the launch's sizes.
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver call; the libraries link only the
// runtime, so its entry point is fetched through the runtime, once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (rows, cols) row-major bf16 matrix read in boxes of 64 cols x box_rows
// rows, 128-byte swizzled; boxes past the edges are filled with zeros
inline int encode_bf16_2d(CUtensorMap* map, const void* base, int rows,
                          int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectInitFailed);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kKS),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  unsigned nblocks;
  int qtile;
  size_t smem;
  CUtensorMap qmap, dmap;
};

// Checks a launch's sizes, encodes the two tensor maps (the pointers may
// change between calls) and raises the kernel's shared-memory limit; sets
// the grid ((W / kLB) * ceil(nq / qtile) CTAs, at most 2^31 - 1). qtile is
// 128, or 64 where layout() allows no more or where 64-query CTAs fit in
// one wave of the device's SMs. Returns 0 or a cudaError_t. n (packed rows)
// must be a multiple of W, W of kLB, dp of 16, nq below 2^31 - 128; qv,
// data and bias must be 16-byte aligned.
template <typename Kernel>
int prepare_launch(Kernel kernel, const void* qv, const void* data,
                   const void* bias, int nq, int n, int dp, int W,
                   Launch* launch) {
  if (nq < 0 || nq > 0x7fffffff - 2 * kWGQ || n <= 0 || dp <= 0 ||
      dp % 16 != 0 || dp > kDPMax || W <= 0 || W % kLB != 0 || n % W != 0 ||
      (reinterpret_cast<uintptr_t>(qv) | reinterpret_cast<uintptr_t>(data) |
       reinterpret_cast<uintptr_t>(bias)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, nsm = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const long long nlb = W / kLB;
  const bool one_wave = nlb * ((nq + kWGQ - 1LL) / kWGQ) <= nsm;
  const Layout L = layout(dp, !one_wave);
  const long long nb = nlb * ((nq + L.qtile - 1LL) / L.qtile);
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  launch->nblocks = static_cast<unsigned>(nb);
  launch->qtile = L.qtile;
  launch->smem = L.smem;
  if (nq > 0) {
    int e = encode_bf16_2d(&launch->qmap, qv, nq, dp, kWGQ);
    if (e == 0) e = encode_bf16_2d(&launch->dmap, data, n, dp, kLB);
    if (e != 0) return e;
  }
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.smem)));
}

}  // namespace flat_knn
