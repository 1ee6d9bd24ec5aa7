// Per-row top-k of a lane-min reservoir (K2), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// tpu_ann/ops/flat_knn_pallas.py::_reservoir_topk_kernel (launched by
// reservoir_topk). Python side, plain version and binding:
// tpu_ann_torch/ops/flat_knn_fused.py.
//
// Computes, for each row of an (nq, W) reservoir of f32 values and int32
// positions, the k smallest values in ascending order and their
// positions. The order is that of the key (value, reservoir lane): the
// lowest lane wins a tie, and -0.0 equals +0.0 (they tie by lane). A slot
// whose value is not finite gives (+inf, -1). A row that holds any NaN
// gives (+inf, -1) in all k slots, as the TPU kernel does (its row minimum
// is NaN, so no round finds a winner). Out: (nq, k).
//
// What bounds it on the H100: bytes. It must read the values once (4 B an
// entry: 82 MB at 10k x 2048) and, for the k winners only, a position and
// the two outputs; it has no products. k dependent warp rounds a row (a
// shuffle arg-min, then a rescan by the winner's lane), one warp a row and
// W/32 values a lane in registers stay far from that bound. This kernel
// has no round that depends on k; it is a warp select in the manner of
// Faiss's WarpSelect (Johnson, Douze and Jegou, 2017):
//  - keys are 64 bits, the order-preserving u32 of the value (-0.0 folded
//    onto +0.0) above the lane, so ties follow the plain version; a warp
//    keeps a sorted queue of N = 32R keys (R = 1, 2, 4 for k <= 32, 64,
//    128), striped over its lanes, R a lane;
//  - a row goes in chunks of up to 2048 entries, read with 16-byte loads
//    (V a lane in flight) and staged in shared memory. Pass 1 keeps each
//    lane's R smallest keys in registers (a few selects an entry), sorts
//    those 32R by a bitonic network over shuffles and registers and merges
//    them into the queue (min against the reversed list, then
//    half-cleaners); the queue's k-th key is then the threshold. Pass 2
//    offers from shared memory only the keys a lane kept no room for and
//    that lie below the threshold: two compares an entry, and none at all
//    for a row whose k smallest spread over the lanes. Survivors go to a
//    shared-memory buffer and are sorted and merged in one flush;
//  - the next chunk's loads (of the row or the warp's next row) are issued
//    before pass 2, so they fly while it runs. With one warp a row the
//    CTAs are persistent (as many as fit at once), each walking its rows;
//  - below 4 rows an SM (528 on 132 SMs) a row is split over S = 2, 4 or
//    8 warps of one CTA
//    (every warp keeping >= 128 entries), so one query is not one warp.
//    The warps share the least of their thresholds in shared memory (any
//    warp's k-th key bounds the row's), and the first warp merges the
//    others' queues at the end;
//  - a warp vote finds a NaN; positions are read only for the k winners
//    (and a value only for a zero, whose sign the key does not keep).
// What is left: pass 1's sort and pass 2's scan of the staged chunk are
// instructions the loads do not hide at R >= 2 (k 40), see PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see tpu_ann_torch/kernels). Plain C interface.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // warps a CTA: 8 / S rows
constexpr int kThreads = kWarps * 32;
constexpr int kWMax = 4096;
constexpr int kKMax = 128;
constexpr int kSMax = 8;              // most warps a row
constexpr int kMinEntries = 128;      // fewest entries a warp of a split row
constexpr int kWarpsPerSM = 4;        // split rows until this many warps
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kSentinel = ~0ull;  // above every real key
constexpr float kInf = __builtin_huge_valf();

// order-preserving u32 of a value, -0.0 folded onto +0.0
__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t b = __float_as_uint(v == 0.f ? 0.f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the value whose order_bits are u
__device__ __forceinline__ float order_value(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// One compare-exchange stage of a bitonic network over N = 32R keys,
// element e = r * 32 + lane in x[r]: e meets e ^ d; the lower of the two
// keeps the minimum where e & s == 0 (an ascending run), else the maximum.
template <int R>
__device__ __forceinline__ void bitonic_stage(uint64_t (&x)[R], int lane,
                                              int s, int d) {
  if (d >= 32) {
    const int rd = d >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & rd) continue;
      const int r2 = r | rd;
      const bool asc = ((r * 32) & s) == 0;
      const uint64_t lo = kmin(x[r], x[r2]), hi = kmax(x[r], x[r2]);
      x[r] = asc ? lo : hi;
      x[r2] = asc ? hi : lo;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint64_t o = __shfl_xor_sync(kFull, x[r], d);
      const bool asc = ((r * 32 + lane) & s) == 0;
      const bool lower = (lane & d) == 0;
      x[r] = asc == lower ? kmin(x[r], o) : kmax(x[r], o);
    }
  }
}

template <int R>
__device__ __forceinline__ void bitonic_sort(uint64_t (&x)[R], int lane) {
#pragma unroll
  for (int s = 2; s <= 32 * R; s <<= 1)
#pragma unroll
    for (int d = s >> 1; d > 0; d >>= 1) bitonic_stage<R>(x, lane, s, d);
}

// q <- the N smallest of q and b (both ascending), ascending
template <int R>
__device__ __forceinline__ void merge_sorted(uint64_t (&q)[R],
                                             const uint64_t (&b)[R],
                                             int lane) {
  // element N-1-e of b is register R-1-r of lane 31-lane
#pragma unroll
  for (int r = 0; r < R; ++r)
    q[r] = kmin(q[r], __shfl_xor_sync(kFull, b[R - 1 - r], 31));
  // q is bitonic now; half-cleaners sort it ascending (s = 2N: all runs up)
#pragma unroll
  for (int d = 16 * R; d > 0; d >>= 1) bitonic_stage<R>(q, lane, 64 * R, d);
}

// The running selection of one warp.
template <int R>
struct WarpQueue {
  uint64_t q[R];   // the N smallest keys offered so far, ascending, striped
  uint64_t tk;     // the threshold key: only keys below it can still be
                   // among the row's k smallest (the least bound known)
  float tf;        // tk as (value, lane): an entry passes if
  uint32_t tl;     // v < tf or (v == tf and lane < tl)
  int count;       // keys waiting in the buffer (a copy of *cnt, read
                   // after a __syncwarp)

  __device__ __forceinline__ void set_threshold(uint64_t t) {
    tk = t;
    if (t == kSentinel) {
      tf = kInf;
      tl = 0xffffffffu;
    } else {
      tf = order_value(static_cast<uint32_t>(t >> 32));
      tl = static_cast<uint32_t>(t);
    }
  }

  __device__ __forceinline__ void lower(uint64_t t) {
    if (t < tk) set_threshold(t);
  }

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) q[r] = kSentinel;
    set_threshold(kSentinel);
    count = 0;
  }

  // sort the buffer's first N keys (sentinels past count), merge them into
  // q, move the rest (< 128) to the front, and lower the threshold to q's
  // k-th key (and a split row's shared one, row_kth, when there is one)
  __device__ __forceinline__ void flush(uint64_t* buf, int* cnt, int lane,
                                        int k, uint64_t* row_kth) {
    constexpr int N = 32 * R;
    __syncwarp();
    uint64_t b[R], carry[4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      b[r] = e < count ? buf[e] : kSentinel;
    }
    const int rest = count - N;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int e = t * 32 + lane;
      carry[t] = e < rest ? buf[N + e] : kSentinel;
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t * 32 + lane < rest) buf[t * 32 + lane] = carry[t];
    count = rest > 0 ? rest : 0;
    if (lane == 0) *cnt = count;
    __syncwarp();
    bitonic_sort<R>(b, lane);
    merge_sorted<R>(q, b, lane);
    uint64_t t = kth(q, k);
    if (row_kth) t = share(row_kth, t, lane);
    lower(t);
  }

  // offer entry j with value x (NaN where there is no entry) of a lane
  // whose R kept keys end at (tv, tj): append its key to the buffer if it
  // lies below the threshold and above the lane's kept keys (those are in
  // q already). The common case costs two compares and a branch that no
  // lane takes. Returns whether it appended.
  __device__ __forceinline__ bool offer(float x, uint32_t j, float tv,
                                        uint32_t tj, uint64_t* buf,
                                        int* cnt) {
    if ((x <= tf) & (x >= tv)) {
      if (((x < tf) | (j < tl)) & ((x > tv) | (j > tj))) {
        buf[atomicAdd(cnt, 1)] =
            (static_cast<uint64_t>(order_bits(x)) << 32) | j;
        return true;
      }
    }
    return false;
  }

  // element k-1 of a sorted striped list, on every lane
  static __device__ __forceinline__ uint64_t kth(const uint64_t (&x)[R],
                                                 int k) {
    // masks, not a select: a select chain becomes an indexed local load
    uint64_t t = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      t |= x[r] & (0ull - static_cast<uint64_t>(r == (k - 1) >> 5));
    return __shfl_sync(kFull, t, (k - 1) & 31);
  }

  // the least of t and the split row's shared threshold key, which then
  // holds it too
  static __device__ __forceinline__ uint64_t share(uint64_t* row_kth,
                                                   uint64_t t, int lane) {
    uint64_t old = kSentinel;
    if (lane == 0)
      old = atomicMin(reinterpret_cast<unsigned long long*>(row_kth),
                      static_cast<unsigned long long>(t));
    return kmin(t, __shfl_sync(kFull, old, 0));
  }
};

__device__ __forceinline__ float comp(const float4& f, int c) {
  return c == 0 ? f.x : c == 1 ? f.y : c == 2 ? f.z : f.w;
}

// Pass 1 over a chunk in registers: every lane keeps its R smallest
// (value, lane) keys (entries reach a lane in ascending lane order, so a
// strict < keeps the lower lane of a tie; +inf and NaN never enter, and a
// +inf slot of the output is (+inf, -1) whichever lane it came from).
// Returns the 32R kept keys sorted in b (sentinels where a lane kept
// fewer), and the lane's last kept key as (tv, tj) (+inf, 0xffffffff if
// it kept fewer than R). Sets nan where a valid entry is NaN.
template <int R, int V>
__device__ __forceinline__ void chunk_keep(const float4 (&ld)[V], int nm,
                                           int cb, int g1, int W, int lane,
                                           uint64_t (&b)[R], float& tv,
                                           uint32_t& tj, bool& nan) {
  float bv[R];
  uint32_t bj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bv[r] = kInf;
    bj[r] = 0xffffffffu;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (v >= nm) break;
    const int g = cb + 32 * v + lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * g + c;
      const float x = comp(ld[v], c);  // NaN where there is no entry
      nan |= (g < g1) & (j < W) & (x != x);
      // insert x into the sorted bv (the last entry drops out)
#pragma unroll
      for (int i = R - 1; i > 0; --i) {
        const bool before = x < bv[i - 1], here = x < bv[i];
        bj[i] = before ? bj[i - 1] : here ? static_cast<uint32_t>(j) : bj[i];
        bv[i] = before ? bv[i - 1] : here ? x : bv[i];
      }
      if (x < bv[0]) {
        bv[0] = x;
        bj[0] = static_cast<uint32_t>(j);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    b[r] = bj[r] == 0xffffffffu
               ? kSentinel
               : (static_cast<uint64_t>(order_bits(bv[r])) << 32) | bj[r];
  bitonic_sort<R>(b, lane);
  tv = bv[R - 1];
  tj = bj[R - 1];
}

// Loads groups [cb, cb + 32V) ∩ [cb, g1) of a row into ld, V 16-byte loads
// a lane in flight (VEC: W % 4 == 0 and 16-byte aligned rows; else 4
// scalar loads a group); NaN where there is no entry, so it never passes.
template <int V, bool VEC>
__device__ __forceinline__ void load_chunk(float4 (&ld)[V],
                                           const float* __restrict__ rv,
                                           int cb, int g1, int W, int lane) {
  const float kNaN = __int_as_float(0x7fffffff);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int g = cb + 32 * v + lane;
    ld[v] = make_float4(kNaN, kNaN, kNaN, kNaN);
    if (g < g1) {
      if constexpr (VEC) {
        ld[v] = __ldg(reinterpret_cast<const float4*>(rv) + g);
      } else {
        const int j = 4 * g;
        ld[v].x = __ldg(rv + j);
        if (j + 1 < W) ld[v].y = __ldg(rv + j + 1);
        if (j + 2 < W) ld[v].z = __ldg(rv + j + 2);
        if (j + 3 < W) ld[v].w = __ldg(rv + j + 3);
      }
    }
  }
}

// Writes row's k slots from a sorted queue (see the rules at the top).
template <int R>
__device__ __forceinline__ void write_row(const WarpQueue<R>& wq,
                                          bool any_nan, int row, int W,
                                          int k, const float* resv,
                                          const int* resp, float* outv,
                                          int* outp, int lane) {
  const size_t base = static_cast<size_t>(row) * W;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e >= k) break;
    const uint64_t key = wq.q[r];
    float v = kInf;
    int p = -1;
    if (!any_nan && key != kSentinel) {
      // the key holds the value, but for the sign of a zero (folded onto
      // +0.0): read the position, and the value only for a zero
      const uint32_t j = static_cast<uint32_t>(key);
      const int pos = __ldg(resp + base + j);
      float x = order_value(static_cast<uint32_t>(key >> 32));
      if (x == 0.f) x = __ldg(resv + base + j);
      if (isfinite(x)) {
        v = x;
        p = pos;
      }
    }
    const size_t o = static_cast<size_t>(row) * k + e;
    outv[o] = v;
    outp[o] = p;
  }
}

// Selects the k smallest keys of groups [g0, g1) of 4 entries (entries
// 4g .. 4g+3 < W) of rows row0, row0 + rstride, ... < nq, a row at a time,
// in chunks of 32V groups. A chunk is loaded into registers (load_chunk)
// and staged in shared memory (st). Pass 1 (chunk_keep) merges the lanes'
// R smallest keys into q, which lowers the threshold to q's k-th key; the
// next chunk's loads (of this row or the next) are then issued, so they
// fly while pass 2 offers from st only what a lane kept no room for: keys
// below the threshold and above the lane's last kept key. Those are few (a
// row whose k smallest spread over the lanes has none), so most rows need
// no flush. cnt: the buffer's fill, in shared memory.
// row_kth: a split row's shared threshold key (S > 1: one row, whose first
// warp merges the queues and writes it; nan_out gets the warp's NaN vote);
// any warp's k-th key bounds the row's, so a warp adopts it at any time.
// Without it (S = 1) each row is written here.
template <int R, int V, bool VEC>
__device__ __forceinline__ void warp_rows(
    const float* __restrict__ resv, const int* __restrict__ resp, int nq,
    int W, int k, int row0, int rstride, int g0, int g1, float4* st,
    uint64_t* buf, int* cnt, uint64_t* row_kth, WarpQueue<R>& wq,
    bool& nan_out, float* __restrict__ outv, int* __restrict__ outp,
    int lane) {
  float4 ld[V];
  int row = row0, cb = g0;
  if (row < nq) load_chunk<V, VEC>(ld, resv + static_cast<size_t>(row) * W,
                                   cb, g1, W, lane);
  bool nan = false;
  while (row < nq) {  // warp-uniform
    const int nm = min(V, (g1 - cb + 31) / 32);  // 16-byte steps a lane
    uint64_t b[R];
    float tv;
    uint32_t tj;
    chunk_keep<R, V>(ld, nm, cb, g1, W, lane, b, tv, tj, nan);
    merge_sorted<R>(wq.q, b, lane);
    uint64_t t = WarpQueue<R>::kth(wq.q, k);
    if (row_kth) t = WarpQueue<R>::share(row_kth, t, lane);
    wq.lower(t);
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < nm) st[v * 32 + lane] = ld[v];
    const bool last_chunk = cb + 32 * V >= g1;
    const int nrow = last_chunk ? row + rstride : row;
    const int ncb = last_chunk ? g0 : cb + 32 * V;
    if (nrow < nq)
      load_chunk<V, VEC>(ld, resv + static_cast<size_t>(nrow) * W, ncb, g1,
                         W, lane);
    // pass 2; the extra step m == nm drains the buffer after the last chunk
    for (int m = 0; m <= nm; ++m) {
      bool added = false;
      if (m < nm) {
        if (row_kth) wq.lower(*static_cast<volatile uint64_t*>(row_kth));
        const float4 f = st[m * 32 + lane];
        const uint32_t j = 4u * static_cast<uint32_t>(cb + 32 * m + lane);
        added |= wq.offer(f.x, j, tv, tj, buf, cnt);
        added |= wq.offer(f.y, j + 1, tv, tj, buf, cnt);
        added |= wq.offer(f.z, j + 2, tv, tj, buf, cnt);
        added |= wq.offer(f.w, j + 3, tv, tj, buf, cnt);
      }
      if (__any_sync(kFull, added) || m == nm) {
        __syncwarp();
        wq.count = *static_cast<volatile int*>(cnt);
        // the one flush site (a step adds up to 128 keys)
        while (wq.count >= 32 * R || (m == nm && last_chunk && wq.count > 0))
          wq.flush(buf, cnt, lane, k, row_kth);
      }
    }
    __syncwarp();  // st is rewritten by the next chunk
    if (last_chunk) {
      const bool any_nan = __any_sync(kFull, nan);
      if (row_kth) {
        nan_out = any_nan;
        return;
      }
      write_row<R>(wq, any_nan, row, W, k, resv, resp, outv, outp, lane);
      wq.init();
      nan = false;
    }
    row = nrow;
    cb = ncb;
  }
}

template <int R, int V>
constexpr size_t smem_bytes() {
  return kWarps * (32 * V * sizeof(float4) + (32 * R + 128) * 8 + 8 + 4 + 4);
}

// S = 1: persistent CTAs, warp w of CTA b takes rows b * 8 + w + i * 8 *
// gridDim.x. S > 1: CTA b takes rows b * (8 / S) + w / S, S warps each.
// (kThreads, 1): without the second bound ptxas keeps some of these at 64
// or 80 registers and spills.
template <int R, int V, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
reservoir_topk_kernel(const float* __restrict__ resv,  // (nq, W) f32
                      const int* __restrict__ resp,    // (nq, W) int32
                      int nq, int W, int k, int S,
                      float* __restrict__ outv,        // (nq, k) f32
                      int* __restrict__ outp) {        // (nq, k) int32
  constexpr int N = 32 * R;
  // a warp's chunk stage, its buffer (N + 127 keys at most; then its
  // queue for the merge), a split row's threshold key, NaN votes and each
  // warp's buffer fill
  extern __shared__ __align__(16) unsigned char smem[];
  float4* stage = reinterpret_cast<float4*>(smem);
  uint64_t* bufs = reinterpret_cast<uint64_t*>(stage + kWarps * 32 * V);
  uint64_t* row_kth = bufs + kWarps * (N + 128);
  int* nan_of = reinterpret_cast<int*>(row_kth + kWarps);
  int* cnts = nan_of + kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ng = (W + 3) / 4;
  uint64_t* buf = bufs + warp * (N + 128);
  float4* st = stage + warp * 32 * V;
  if (lane == 0) cnts[warp] = 0;
  WarpQueue<R> wq;
  wq.init();
  if (S == 1) {  // CTA-uniform
    __syncwarp();
    bool unused = false;
    warp_rows<R, V, VEC>(resv, resp, nq, W, k, blockIdx.x * kWarps + warp,
                         gridDim.x * kWarps, 0, ng, st, buf, cnts + warp,
                         nullptr, wq, unused, outv, outp, lane);
    return;
  }
  const int slot = warp / S;  // the CTA's row of this warp
  const int row = blockIdx.x * (kWarps / S) + slot;
  const int part = warp % S;
  if (part == 0 && lane == 0) row_kth[slot] = kSentinel;
  __syncthreads();
  bool any_nan = false;
  warp_rows<R, V, VEC>(resv, resp, nq, W, k, row, nq, part * ng / S,
                       (part + 1) * ng / S, st, buf, cnts + warp,
                       row_kth + slot, wq, any_nan, outv, outp, lane);
  // the row's first warp merges the others' queues and writes the row
  if (part > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) buf[r * 32 + lane] = wq.q[r];
    if (lane == 0) nan_of[warp] = any_nan;
  }
  __syncthreads();
  if (part > 0 || row >= nq) return;
  for (int o = 1; o < S; ++o) {
    uint64_t b[R];
#pragma unroll
    for (int r = 0; r < R; ++r) b[r] = buf[o * (N + 128) + r * 32 + lane];
    merge_sorted<R>(wq.q, b, lane);
    any_nan |= nan_of[warp + o] != 0;
  }
  write_row<R>(wq, any_nan, row, W, k, resv, resp, outv, outp, lane);
}

template <int R, int V, bool VEC>
cudaError_t launch(const void* resv, const void* resp, int nq, int W, int k,
                   int S, void* outv, void* outp, cudaStream_t stream) {
  auto kernel = reservoir_topk_kernel<R, V, VEC>;
  constexpr size_t smem = smem_bytes<R, V>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = kWarps / S;
  int grid = (nq + rows - 1) / rows;
  if (S == 1) {  // persistent: the CTAs that fit at once, at most
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return e;
    grid = min(grid, max(1, per_sm * sms));
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(resv), static_cast<const int*>(resp), nq, W,
      k, S, static_cast<float*>(outv), static_cast<int*>(outp));
  return cudaSuccess;
}

// V = 16-byte loads a lane a chunk: the fewest that cover a warp's part
// (up to 16: 2048 entries a chunk; V 16 for every part measured 3-6%
// slower at 1 to 64 rows and at W 1024); rows with W % 4 != 0 or
// unaligned take scalar loads with V = 4
template <int R>
cudaError_t launch_r(bool vec, int groups, const void* resv,
                     const void* resp, int nq, int W, int k, int S,
                     void* outv, void* outp, cudaStream_t stream) {
  if (!vec)
    return launch<R, 4, false>(resv, resp, nq, W, k, S, outv, outp, stream);
  if (groups <= 32 * 4)
    return launch<R, 4, true>(resv, resp, nq, W, k, S, outv, outp, stream);
  if (groups <= 32 * 8)
    return launch<R, 8, true>(resv, resp, nq, W, k, S, outv, outp, stream);
  return launch<R, 16, true>(resv, resp, nq, W, k, S, outv, outp, stream);
}

}  // namespace

extern "C" {

// Warps a row for nq rows of width W on the current device: 1, 2, 4 or 8.
int reservoir_topk_split(int nq, int W) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int S = 1;
  while (S < kSMax && static_cast<long long>(nq) * S < kWarpsPerSM * sms &&
         W >= 2 * S * kMinEntries)
    S *= 2;
  return S;
}

// Launches CTAs of 8 warps on `stream` (S warps a row,
// reservoir_topk_split; for S = 1 at most the CTAs that fit the card at
// once, each walking its rows); allocates nothing. Needs 1 <= k <= min(128, W)
// and W <= 4096. Returns cudaGetLastError() (0 on success).
int reservoir_topk(const void* resv, const void* resp, int nq, int W, int k,
                   void* outv, void* outp, void* stream) {
  if (nq < 0 || W <= 0 || W > kWMax || k < 1 || k > kKMax || k > W)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq > 0) {
    const int S = reservoir_topk_split(nq, W);
    const int groups = ((W + 3) / 4 + S - 1) / S;  // a warp's part
    const bool vec =
        W % 4 == 0 && reinterpret_cast<uintptr_t>(resv) % 16 == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (k <= 32)
      e = launch_r<1>(vec, groups, resv, resp, nq, W, k, S, outv, outp, s);
    else if (k <= 64)
      e = launch_r<2>(vec, groups, resv, resp, nq, W, k, S, outv, outp, s);
    else
      e = launch_r<4>(vec, groups, resv, resp, nq, W, k, S, outv, outp, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
