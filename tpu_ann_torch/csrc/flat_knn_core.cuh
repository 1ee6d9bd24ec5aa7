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
// Every group's products are computed whatever the fold: the mma is asm
// volatile, so the folds differ only in the epilogue.
//
// What bounds it on the H100: at 10k queries x 1M rows x 128-d the scan
// is 1.28 TFMA (2.56 TFLOP). On CUDA cores (67 TFLOP/s f32) that is at
// least 38 ms, so the products run on the tensor cores with warp-level
// mma.sync m16n8k16 (bf16 in, f32 accumulate). The database is 256 MB of
// bf16 and every query block streams it once, so the kernel is
// tensor-core bound as long as the CTAs that share rows meet in L2.
//
// Design: one CTA owns kQB queries x kLB reservoir lanes [j0, j0 + kLB)
// and walks the groups g = 0 .. n/W - 1; for each it streams the kLB
// contiguous rows g*W + j0 .. and their bias. The (query, lane) pairs a
// thread holds in the mma accumulator fragment are the same in every
// group, so the reservoir lives in registers beside the accumulator and
// the serial merge is one add, one compare and two selects per score. No
// merge across CTAs is needed: a lane's rows are all visited by one CTA,
// in increasing order. Rows reach shared memory through a kStages-deep
// cp.async ring of kKS-dim slices; the CTA's queries stay in shared memory
// for the whole scan. The grid runs the lane blocks fastest, so the CTAs
// resident together read the same rows and share them through L2.
// wgmma, TMA and warp specialisation are later steps.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flat_knn {

constexpr int kQB = 64;               // queries per CTA
constexpr int kLB = 128;              // reservoir lanes per CTA
constexpr int kWarps = 8;             // 2 (queries) x 4 (lanes) warps
constexpr int kThreads = kWarps * 32;
constexpr int kKS = 64;               // dims per pipeline stage
constexpr int kStages = 3;            // cp.async ring depth
constexpr int kXS = kKS + 8;          // padded row stride of a stage (bf16)
constexpr int kDPMax = 1024;          // widest padded dimension
constexpr float kInf = __builtin_huge_valf();
constexpr int kPackedInit = 0x7FFFFFFF;
constexpr int kHiMask = static_cast<int>(0xFFFF0000u);

// padded row strides keep every ldmatrix of 8 rows on 8 distinct 16-byte
// bank groups: (stride in bytes) / 16 is odd
inline size_t smem_bytes(int dp) {
  return sizeof(uint16_t) * (static_cast<size_t>(kQB) * (dp + 8) +
                             static_cast<size_t>(kStages) * kLB * kXS);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// The body of one CTA (see the header comment); gpc is FoldMin1's groups
// per reference chunk and unused by the other folds.
template <class Fold>
__device__ __forceinline__ void scan_body(
    const uint16_t* __restrict__ qv,    // (nq, dp) bf16, pre-scaled
    const uint16_t* __restrict__ data,  // (n, dp) bf16 packed rows
    const float* __restrict__ bias,     // (n,) f32
    int nq, int n, int dp, int W, int gpc,
    float* __restrict__ out_v,          // (nq, W) f32 (unused by K1p)
    int* __restrict__ out_p) {          // (nq, W) int32
  extern __shared__ __align__(16) unsigned char smem[];
  const int qstride = dp + 8;
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);  // [kQB][qstride]
  uint16_t* xs = qs + kQB * qstride;                 // [kStages][kLB][kXS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;   // 32-query slice of the CTA
  const int wn = warp & 3;    // 32-lane slice of the CTA
  // a 1-D grid, lane blocks fastest: no 65535 bound on the query blocks
  const int nlb = W / kLB;
  const int qb = static_cast<int>(blockIdx.x / nlb);
  const int j0 = static_cast<int>(blockIdx.x - qb * nlb) * kLB;
  const int q0 = qb * kQB;
  const int ngroups = n / W;
  const int nks = (dp + kKS - 1) / kKS;
  const int nstages = ngroups * nks;

  // the CTA's queries, zero rows past nq
  const int nv = dp / 8;  // 16-byte vectors per row
  for (int i = tid; i < kQB * nv; i += kThreads) {
    const int r = i / nv, v = i - r * nv;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < nq)
      val = *reinterpret_cast<const uint4*>(
          qv + static_cast<size_t>(q0 + r) * dp + v * 8);
    *reinterpret_cast<uint4*>(qs + r * qstride + v * 8) = val;
  }

  // stage t: dims [ks*kKS, +kKS) of rows g*W + j0 .. + kLB
  auto load_stage = [&](int t) {
    const int g = t / nks;
    const int d0 = (t - g * nks) * kKS;
    const int nvs = min(kKS, dp - d0) / 8;
    uint16_t* buf = xs + (t % kStages) * kLB * kXS;
    const uint16_t* src =
        data + (static_cast<size_t>(g) * W + j0) * dp + d0;
    for (int i = tid; i < kLB * nvs; i += kThreads) {
      const int r = i / nvs, v = i - r * nvs;
      cp_async16(buf + r * kXS + v * 8, src + static_cast<size_t>(r) * dp +
                                            v * 8);
    }
  };

  float acc[2][4][4];
  typename Fold::State best[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0.f;
        Fold::init(best[mi][ni][e]);
      }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) load_stage(s);
    cp_async_commit();
  }

  for (int t = 0; t < nstages; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed; stage t-1's buffer is free
    if (t + kStages - 1 < nstages) load_stage(t + kStages - 1);
    cp_async_commit();

    const int g = t / nks;
    const int ks = t - g * nks;
    const int d0 = ks * kKS;
    const int width = min(kKS, dp - d0);
    const uint16_t* buf = xs + (t % kStages) * kLB * kXS;
    for (int kk = 0; kk < width; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], qs + (wm * 32 + mi * 16 + (lane & 15)) * qstride +
                               d0 + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, buf + (wn * 32 + nj * 16 + ((lane >> 4) << 3) +
                              (lane & 7)) * kXS +
                             kk + ((lane >> 3) & 1) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }

    if (ks == nks - 1) {
      if (Fold::active(g, gpc)) {
        // group g complete: fold its scores into the reservoir
        const float* bg = bias + static_cast<size_t>(g) * W + j0 + wn * 32 +
                          2 * (lane & 3);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float2 bv = *reinterpret_cast<const float2*>(bg + ni * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float s = acc[mi][ni][e] + ((e & 1) ? bv.y : bv.x);
              Fold::fold(best[mi][ni][e], s, g);
              acc[mi][ni][e] = 0.f;
            }
        }
      } else {
        // a group the fold skips: its products were computed all the same
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      }
    }
  }

  // fragment element e of tile (mi, ni): row lane/4 (+8 for e >= 2),
  // column 2*(lane%4) (+1 for odd e)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int q = q0 + wm * 32 + mi * 16 + (lane >> 2) + e2 * 8;
      if (q >= nq) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = j0 + wn * 32 + ni * 8 + 2 * (lane & 3);
        const size_t o = static_cast<size_t>(q) * W + c;
        const int e = 2 * e2;
        Fold::store(best[mi][ni][e], best[mi][ni][e + 1], o, c, W, out_v,
                    out_p);
      }
    }
}

// Checks a launch's sizes and raises the kernel's shared-memory limit;
// sets the grid ((W / kLB) * ceil(nq / kQB) CTAs, at most 2^31 - 1) and the
// dynamic shared memory. Returns 0 or a cudaError_t. n (packed rows) must be
// a multiple of W, W of kLB, dp of 16.
template <typename Kernel>
int prepare_launch(Kernel kernel, int nq, int n, int dp, int W,
                   unsigned* nblocks, size_t* smem) {
  if (nq < 0 || n <= 0 || dp <= 0 || dp % 16 != 0 || dp > kDPMax ||
      W <= 0 || W % kLB != 0 || n % W != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb =
      static_cast<long long>(W / kLB) * ((nq + kQB - 1LL) / kQB);
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *nblocks = static_cast<unsigned>(nb);
  *smem = smem_bytes(dp);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

}  // namespace flat_knn
