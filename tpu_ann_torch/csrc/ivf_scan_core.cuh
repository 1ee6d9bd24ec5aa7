// Device code shared by the list-major fused IVF scan (K3,
// ivf_scan_fused.cu), its SQ8 variant (K3-SQ8, ivf_scan_sq8.cu) and the
// out-of-core window scan (K4, ivf_scan_paged.cu): per (query, probe) pair,
// the exact top-kp stream rows of the pair's inverted list, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the body of the TPU kernels, tpu_ann/ops/ivf_scan_pallas.py::
// _grouped_kernel, which K3 (scan_invlists_fused) launches over the whole
// bf16 or uint8 stream and K4 (tpu_ann/ops/ivf_scan_paged.py::
// _make_window_kernel) over one uploaded window.
//
// Work: the wrapper sorts the pairs by list id and cuts them into tiles of
// kPT pairs. Lists are packed contiguously in id order, so a tile's pairs
// cover one contiguous range of stream rows. One CTA owns one tile and
// walks that range in chunks of kCR rows with a runtime loop: each chunk
// is staged once in shared memory and feeds every pair of the tile whose
// list it belongs to (list-major reuse). The tile's pairs form register
// groups of kP consecutive pairs, dealt to the warps in turn, so the groups
// of one list run on different warps; a lane scores two rows of the chunk
// against its group's pairs with bf16 x bf16 -> f32 products (f32
// accumulation).
//   L2: max(qn + |x|^2 - 2 q.x, 0)             IP: -q.x - qn
// qn is the wrapper's per-query offset: |q|^2 for L2 and 0 for IP on a
// bf16 stream. On the SQ8 stream (Elem = uint8_t) x is the code row, q the
// query times the dequant scale (rounded to bf16 once), and qn folds in
// the bias: |q|^2 - 2 q.bias for L2, q.bias for IP. Each code is widened
// to bf16 in registers as its chunk is staged (exact: every integer up to
// 256 is a bf16), so the shared-memory chunk and the inner loop are the
// bf16 stream's; only the HBM read halves.
// A row counts for a pair if it lies in the pair's list block range and
// holds a real entry (id >= 0). Each pair keeps an exact sorted top-kp
// spread over the warp's lanes (lane i holds entry i), ordered by
// (distance, stream position): ties go to the lower position, empty slots
// are (+inf, -1). A few new candidates are inserted one by one; many (the
// first chunks of a list) are merged in at once with a warp bitonic sort.
//
// The window (kWindow = true, K4): the kernel reads global stream rows
// [wrow0, wrow1) only; they lie at data / ids / norms + (row - wrow0).
// Every pair and tile range is clamped to the window, and positions stay
// global. Each pair's list starts from its top-kp so far (out_d / out_p,
// from earlier windows, whose positions are all lower), so the new rows
// merge into it with the same tie rule, and the merged list is written
// back in place. K3 (kWindow = false) reads the whole stream and starts
// from empty lists; its instantiation has none of the window code.
//
// What bounds it on the H100: at d = 128 a streamed row is 256 B of bf16
// (128 B of codes on the SQ8 stream) plus 8 B of id and norm, and it feeds
// (pairs of the tile on its list) x d fused multiply-adds. At the IVF4096
// main path (1M rows, 10k queries, nprobe 16-64) a list is probed by
// 40-160 pairs, so a row read feeds thousands of FMAs: the kernel is
// bound by CUDA-core FMA issue and shared-memory operand traffic, not by
// HBM. The design keeps the operand reads low (queries converted to f32
// once per tile and read as warp broadcasts, rows read with
// bank-conflict-free 16-byte loads, 16 accumulators per lane) and skips a
// register group's work on chunks that hold none of its pairs' lists.
// Tensor cores (mma.sync / wgmma), cp.async or TMA double buffering and
// persistent CTAs are later steps.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace ivf_scan {

constexpr int kPT = 128;             // pairs per tile (one CTA)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPW = kPT / kWarps;    // pairs per warp
constexpr int kP = 8;                // pairs per register group
constexpr int kNG = kPW / kP;        // register groups per warp
constexpr int kCR = 64;              // stream rows per chunk (2 per lane)
constexpr int kDS = 128;             // dims per shared-memory slice
constexpr int kXS = kDS + 8;         // padded row stride of the chunk (bf16)
constexpr int kKPMax = 32;           // one top-kp entry per lane
constexpr int kSerialMax = 6;        // more candidates: bitonic merge
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = __builtin_huge_valf();

constexpr size_t kSmemBytes =
    sizeof(float) * kPT * kDS            // qs: tile queries, f32
    + sizeof(uint16_t) * kCR * kXS       // xs: chunk rows, bf16
    + sizeof(int) * kCR                  // sid: chunk row ids
    + sizeof(float) * kCR                // snorm: chunk row norms
    + sizeof(int) * kPT * 3              // plo, phi, pq
    + sizeof(float) * kPT                // pqn
    + sizeof(int) * kWarps * kNG * 2;    // glo, ghi

// 8 bf16 (one 16-byte vector) -> 8 f32; bf16 is the top half of an f32
__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
  f[4] = __uint_as_float(v.z << 16);
  f[5] = __uint_as_float(v.z & 0xffff0000u);
  f[6] = __uint_as_float(v.w << 16);
  f[7] = __uint_as_float(v.w & 0xffff0000u);
}

// Two codes -> two bf16 in one word, exactly: 2^23 + c is exact in f32,
// so (2^23 + c) - 2^23 = c, whose f32 bits end in 16 zero bits (c < 256)
__device__ __forceinline__ uint32_t codes2_bf16(uint32_t c0, uint32_t c1) {
  const float f0 = __uint_as_float(0x4b000000u | c0) - 8388608.0f;
  const float f1 = __uint_as_float(0x4b000000u | c1) - 8388608.0f;
  // the top halves of f0 (low word) and f1 (high word)
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// 8 stream elements at p as 8 bf16 (one 16-byte vector): a 16-byte load
// of a bf16 stream, or an 8-byte load of uint8 codes widened in registers
template <typename Elem>
__device__ __forceinline__ uint4 load8_bf16(const Elem* p) {
  if constexpr (sizeof(Elem) == 1) {
    const uint2 c = *reinterpret_cast<const uint2*>(p);
    return make_uint4(codes2_bf16(c.x & 0xffu, (c.x >> 8) & 0xffu),
                      codes2_bf16((c.x >> 16) & 0xffu, c.x >> 24),
                      codes2_bf16(c.y & 0xffu, (c.y >> 8) & 0xffu),
                      codes2_bf16((c.y >> 16) & 0xffu, c.y >> 24));
  } else {
    return *reinterpret_cast<const uint4*>(p);
  }
}

__device__ __forceinline__ float dot8(const float4 a, const float4 b,
                                      const float (&x)[8], float acc) {
  acc = fmaf(a.x, x[0], acc);
  acc = fmaf(a.y, x[1], acc);
  acc = fmaf(a.z, x[2], acc);
  acc = fmaf(a.w, x[3], acc);
  acc = fmaf(b.x, x[4], acc);
  acc = fmaf(b.y, x[5], acc);
  acc = fmaf(b.z, x[6], acc);
  acc = fmaf(b.w, x[7], acc);
  return acc;
}

// (d1, p1) before (d2, p2): by distance, then by stream position
__device__ __forceinline__ bool before(float d1, int p1, float d2, int p2) {
  return d1 < d2 || (d1 == d2 && p1 < p2);
}

// A stream row clamped to the window [wrow0, wrow1) (K4), or as it is (K3)
template <bool kWindow>
__device__ __forceinline__ int in_window(int row, int wrow0, int wrow1) {
  if constexpr (kWindow) return min(max(row, wrow0), wrow1);
  return row;
}

// Warp-wide: (d, p) holds a list sorted ascending over the 32 lanes; the
// candidates (cd, cp), one per lane, in any order. Leaves in (d, p) the 32
// smallest of both, sorted: bitonic sort of the candidates, then the
// elementwise min with the reversed list (a bitonic sequence), then a
// bitonic merge.
__device__ __forceinline__ void merge32(float& d, int& p, float cd, int cp,
                                        int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float od = __shfl_xor_sync(kFull, cd, j);
      const int op = __shfl_xor_sync(kFull, cp, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      if (before(od, op, cd, cp) == keep_min) {
        cd = od;
        cp = op;
      }
    }
  }
  const float rd = __shfl_sync(kFull, cd, 31 - lane);
  const int rp = __shfl_sync(kFull, cp, 31 - lane);
  if (before(rd, rp, d, p)) {
    d = rd;
    p = rp;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, j);
    const int op = __shfl_xor_sync(kFull, p, j);
    if (before(od, op, d, p) == ((lane & j) == 0)) {
      d = od;
      p = op;
    }
  }
}

// The body of one CTA, for tile tile0 + blockIdx.x (see the header
// comment). Elem is the stream's element: uint16_t (bf16 bits) or uint8_t
// (SQ8 codes).
template <bool kWindow, typename Elem = uint16_t>
__device__ __forceinline__ void scan_tile(
    const uint16_t* __restrict__ xq,      // (nq, d) bf16 queries
    const float* __restrict__ qn,         // (nq,) f32 per-query offset
    const int* __restrict__ pair_q,       // (ntiles*kPT,) query row
    const int* __restrict__ pstart,       // (ntiles*kPT,) first block
    const int* __restrict__ pend,         // (ntiles*kPT,) end block
    const int* __restrict__ tile_bs,      // (ntiles,) first block of tile
    const int* __restrict__ tile_nb,      // (ntiles,) blocks of tile
    const Elem* __restrict__ data,        // window rows, (rows, d)
    const int* __restrict__ ids,          // window rows' ids, -1 = pad
    const float* __restrict__ norms,      // window rows' |x|^2
    int wrow0, int wrow1, int tile0,      // window rows; first tile
    int d, int B, int kp, int similarity,
    float* __restrict__ out_d,            // (ntiles*kPT, kp)
    int* __restrict__ out_p) {            // (ntiles*kPT, kp) positions
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  uint16_t* xs = reinterpret_cast<uint16_t*>(qs + kPT * kDS);
  int* sid = reinterpret_cast<int*>(xs + kCR * kXS);
  float* snorm = reinterpret_cast<float*>(sid + kCR);
  int* plo = reinterpret_cast<int*>(snorm + kCR);
  int* phi = plo + kPT;
  int* pq = phi + kPT;
  float* pqn = reinterpret_cast<float*>(pq + kPT);
  int* glo = reinterpret_cast<int*>(pqn + kPT);
  int* ghi = glo + kWarps * kNG;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = kWindow ? tile0 + static_cast<int>(blockIdx.x)
                           : static_cast<int>(blockIdx.x);
  const int base = kWindow ? wrow0 : 0;     // stream row of data[0]
  const long long pbase = static_cast<long long>(tile) * kPT;
  const int row0 = in_window<kWindow>(tile_bs[tile] * B, wrow0, wrow1);
  const int row1 = in_window<kWindow>((tile_bs[tile] + tile_nb[tile]) * B,
                                      wrow0, wrow1);

  for (int p = tid; p < kPT; p += kThreads) {
    const int q = pair_q[pbase + p];
    pq[p] = q;
    plo[p] = in_window<kWindow>(pstart[pbase + p] * B, wrow0, wrow1);
    phi[p] = in_window<kWindow>(pend[pbase + p] * B, wrow0, wrow1);
    pqn[p] = qn[q];
  }
  __syncthreads();
  if (tid < kWarps * kNG) {
    // row range of one register group's pairs (empty pairs excluded)
    int lo = INT_MAX, hi = INT_MIN;
    for (int p = tid * kP; p < tid * kP + kP; ++p) {
      if (phi[p] > plo[p]) {
        lo = min(lo, plo[p]);
        hi = max(hi, phi[p]);
      }
    }
    glo[tid] = lo;
    ghi[tid] = hi;
  }

  float ld[kPW];
  int lp[kPW];
#pragma unroll
  for (int j = 0; j < kPW; ++j) {
    ld[j] = kInf;
    lp[j] = -1;
    if (kWindow && lane < kp) {
      const int pr = ((j / kP) * kWarps + warp) * kP + j % kP;
      const size_t o = static_cast<size_t>(pbase + pr) * kp + lane;
      ld[j] = out_d[o];
      lp[j] = ld[j] == kInf ? -1 : out_p[o];
    }
  }

  const int nslices = (d + kDS - 1) / kDS;
  for (int c0 = row0; c0 < row1; c0 += kCR) {
    float acc[kNG][kP][2];
#pragma unroll
    for (int g = 0; g < kNG; ++g)
#pragma unroll
      for (int p = 0; p < kP; ++p) acc[g][p][0] = acc[g][p][1] = 0.f;

    for (int s = 0; s < nslices; ++s) {
      const int d0 = s * kDS;
      const int nv = min(kDS, d - d0) / 8;  // 8-element vectors per slice
      __syncthreads();                      // previous chunk fully consumed
      for (int i = tid; i < kCR * nv; i += kThreads) {
        const int r = i / nv, v = i - r * nv;
        const int row = c0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < row1)
          val = load8_bf16(data + static_cast<size_t>(row - base) * d + d0 +
                           v * 8);
        *reinterpret_cast<uint4*>(xs + r * kXS + v * 8) = val;
      }
      if (s == 0) {
        for (int r = tid; r < kCR; r += kThreads) {
          const int row = c0 + r;
          const bool in = row < row1;
          sid[r] = in ? ids[row - base] : -1;
          snorm[r] = in ? norms[row - base] : 0.f;
        }
      }
      if (nslices > 1 || c0 == row0) {
        for (int i = tid; i < kPT * nv; i += kThreads) {
          const int p = i / nv, v = i - p * nv;
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(
                      xq + static_cast<size_t>(pq[p]) * d + d0 + v * 8),
                  f);
          float4* dst = reinterpret_cast<float4*>(qs + p * kDS + v * 8);
          dst[0] = make_float4(f[0], f[1], f[2], f[3]);
          dst[1] = make_float4(f[4], f[5], f[6], f[7]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kNG; ++g) {
        const int gi = g * kWarps + warp;             // register group
        if (glo[gi] < c0 + kCR && ghi[gi] > c0) {   // warp-uniform
          const float* qg = qs + gi * kP * kDS;
          for (int v = 0; v < nv; ++v) {
            float xa[8], xb[8];
            unpack8(*reinterpret_cast<const uint4*>(xs + lane * kXS + v * 8),
                    xa);
            unpack8(*reinterpret_cast<const uint4*>(
                        xs + (lane + 32) * kXS + v * 8),
                    xb);
#pragma unroll
            for (int p = 0; p < kP; ++p) {
              const float4 q0 =
                  *reinterpret_cast<const float4*>(qg + p * kDS + v * 8);
              const float4 q1 =
                  *reinterpret_cast<const float4*>(qg + p * kDS + v * 8 + 4);
              acc[g][p][0] = dot8(q0, q1, xa, acc[g][p][0]);
              acc[g][p][1] = dot8(q0, q1, xb, acc[g][p][1]);
            }
          }
        }
      }
    }

    // scores -> per-pair top-kp, rows in increasing stream position
#pragma unroll
    for (int g = 0; g < kNG; ++g) {
      const int gi = g * kWarps + warp;
      if (!(glo[gi] < c0 + kCR && ghi[gi] > c0)) continue;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int j = g * kP + p;
        const int pr = gi * kP + p;
        const int lo = plo[pr], hi = phi[pr];
        const float qv = pqn[pr];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rl = lane + 32 * r;
          const int row = c0 + rl;
          const float ip = acc[g][p][r];
          const float dis = similarity
                                ? -ip - qv
                                : fmaxf(qv + snorm[rl] - 2.0f * ip, 0.0f);
          const bool ok = row >= lo && row < hi && sid[rl] >= 0;
          float thr = __shfl_sync(kFull, ld[j], kp - 1);
          const bool cand = ok && dis < thr;
          unsigned m = __ballot_sync(kFull, cand);
          if (__popc(m) > kSerialMax) {
            merge32(ld[j], lp[j], cand ? dis : kInf, cand ? row : INT_MAX,
                    lane);
            continue;
          }
          while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float dv = __shfl_sync(kFull, dis, src);
            if (dv < thr) {
              // insert after every kept entry <= dv (they have lower
              // positions), shift the rest one lane up
              const int idx =
                  __popc(__ballot_sync(kFull, lane < kp && ld[j] <= dv));
              const float ud = __shfl_up_sync(kFull, ld[j], 1);
              const int up = __shfl_up_sync(kFull, lp[j], 1);
              if (lane == idx) {
                ld[j] = dv;
                lp[j] = c0 + src + 32 * r;
              } else if (lane > idx) {
                ld[j] = ud;
                lp[j] = up;
              }
              thr = __shfl_sync(kFull, ld[j], kp - 1);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPW; ++j) {
    if (lane < kp) {
      const int pr = ((j / kP) * kWarps + warp) * kP + j % kP;
      const size_t o = static_cast<size_t>(pbase + pr) * kp + lane;
      out_d[o] = ld[j];
      out_p[o] = ld[j] == kInf ? -1 : lp[j];
    }
  }
}

// The parameters of a kernel that runs scan_tile on a stream of Elem, and
// the call: K3 (ivf_scan_fused.cu), K3-SQ8 (ivf_scan_sq8.cu) and K4
// (ivf_scan_paged.cu) each define one, with their own launch bounds.
#define IVF_SCAN_TILE_PARAMS(Elem)                                          \
  const uint16_t *__restrict__ xq, const float *__restrict__ qn,            \
      const int *__restrict__ pair_q, const int *__restrict__ pstart,       \
      const int *__restrict__ pend, const int *__restrict__ tile_bs,        \
      const int *__restrict__ tile_nb, const Elem *__restrict__ data,       \
      const int *__restrict__ ids, const float *__restrict__ norms,         \
      int wrow0, int wrow1, int tile0, int d, int B, int kp, int similarity, \
      float *__restrict__ out_d, int *__restrict__ out_p
#define IVF_SCAN_TILE_ARGS                                                   \
  xq, qn, pair_q, pstart, pend, tile_bs, tile_nb, data, ids, norms, wrow0,  \
      wrow1, tile0, d, B, kp, similarity, out_d, out_p

// Launches `kernel` (a scan_tile kernel on a stream of Elem), one CTA per
// tile of [tile0, tile0 + ntiles), on `stream`; allocates nothing. Returns
// cudaGetLastError() (0 on success).
template <typename Elem = uint16_t, typename Kernel>
int launch_scan_tiles(Kernel kernel, const void* xq, const void* qn,
                      const void* pair_q, const void* pstart,
                      const void* pend, const void* tile_bs,
                      const void* tile_nb, const void* data, const void* ids,
                      const void* norms, int wrow0, int wrow1, int tile0,
                      int ntiles, int d, int B, int kp, int similarity,
                      void* out_d, void* out_p, void* stream) {
  if (d <= 0 || d % 8 != 0 || B <= 0 || kp < 1 || kp > kKPMax ||
      ntiles < 0 || tile0 < 0 || wrow0 < 0 || wrow1 < wrow0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (ntiles > 0) {
    kernel<<<ntiles, kThreads, kSmemBytes,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(xq), static_cast<const float*>(qn),
        static_cast<const int*>(pair_q), static_cast<const int*>(pstart),
        static_cast<const int*>(pend), static_cast<const int*>(tile_bs),
        static_cast<const int*>(tile_nb), static_cast<const Elem*>(data),
        static_cast<const int*>(ids), static_cast<const float*>(norms), wrow0,
        wrow1, tile0, d, B, kp, similarity, static_cast<float*>(out_d),
        static_cast<int*>(out_p));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ivf_scan
