// Device code shared by the list-major fused IVF scan (K3,
// ivf_scan_fused.cu), its SQ8 variant (K3-SQ8, ivf_scan_sq8.cu) and the
// out-of-core window scan (K4, ivf_scan_paged.cu): per (query, probe) pair,
// the exact top-kp stream rows of the pair's inverted list, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the body of the TPU kernels, tpu_ann/ops/ivf_scan_pallas.py::
// _grouped_kernel, which K3 (scan_invlists_fused) launches over the whole
// bf16 or uint8 stream and K4 (tpu_ann/ops/ivf_scan_paged.py::
// _make_window_kernel) over one uploaded window, with its exact per-chunk
// epilogue (ivf_scan_pallas.py:217-250, taken once 8 kp > RW) for every kp.
//
// The function: the wrapper sorts the pairs by list id and cuts them into
// tiles of kPT pairs, one CTA each up to kp 32 (the wider lists split a
// tile over several CTAs, below). A row counts for a pair if it lies in
// the pair's block range [pstart, pend) and holds a real entry (id >= 0);
// its score, with bf16 x bf16 -> f32 products, is
//   L2: max(qn + |x|^2 - 2 q.x, 0)             IP: -q.x - qn
// qn is the wrapper's per-query offset: |q|^2 for L2 and 0 for IP on a
// bf16 stream. On the SQ8 stream (Elem = uint8_t) x is the code row, q the
// query times the dequant scale (rounded to bf16 once), and qn folds in
// the bias: |q|^2 - 2 q.bias for L2, q.bias for IP. Each pair keeps an
// exact sorted top-kp ordered by (distance, stream position): ties go to
// the lower position, empty slots are (+inf, -1). Where the list lives
// depends on kp (the kR template argument):
// - kp <= 32 (kR = 1): spread over the lanes of the warp that owns the
//   pair, lane i holding entry i, in registers;
// - kp 33..64 (kR = 2): two entries a lane, i and 32 + i, in registers,
//   each tile run by two CTAs of kPTWide = 64 pairs (four of 32 in K4; see
//   "The wide lists" below);
// - kp >= 65 (kR = kRGlobal): in shared memory, kp slots a pair, with
//   fewer pairs a CTA as kp grows; past what shared memory holds (kp 2969
//   at d = 128) in the pair's own row of out_d / out_p (see "Lists above
//   kp 64" below); no cap on kp.
//
// What bounds it on the H100: a streamed row is 2d bytes of bf16 (d of
// codes on the SQ8 stream) plus 8 B of id and norm, read once for every
// pair of the tile on its list. With the products on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate) a 128-pair x 64-row x
// 128-d chunk is 1M multiply-adds, about 0.3 us of one SM's share of the
// tensor-core peak against about 0.7 us of its share of HBM for the
// chunk's 16.5 KB: the card's bound is the rows' bytes. Measured, the
// per-pair top-kp epilogue (its warp sorting networks) takes more of a
// launch than the bytes and the products at the main path's 10k-query
// batch (PERF.md): it is the next step. The design:
// 1. Segments. The pairs of a tile fall into segments, runs of
//    consecutive pairs with the same row range (the same list; for K4 the
//    same range clamped to the window, for K3g the same cut range). The
//    CTA finds them in shared memory from the ranges it loads and streams
//    each segment's rows once, in chunks of kCR rows that start at the
//    segment's first row, and no row that no pair needs: a sparse plan
//    (a graph hop, a -1-heavy probe set) costs its own rows, not the span
//    of its tile. A pair whose range is empty is in no segment.
// 2. Every warp works on every chunk. A chunk is one score tile, (segment
//    pairs) x (kCR rows): m16 tiles of pairs by n8 tiles of rows, dealt to
//    the 8 warps in blocks of 2 m-tiles x 1, 2 or 4 n-tiles, so a segment
//    of one pair keeps the 8 warps on 8 row tiles, and one of 128 pairs
//    gives each warp a 32 x 32 block.
// 3. Tensor-core products: the tile's queries (A) and the chunk's rows (B)
//    stay in shared memory as bf16, d padded with zeros to a multiple of
//    16 in both, and reach the mma through ldmatrix. Up to kDS = 128 dims
//    the queries are loaded once per CTA (kPT x 136 bf16, 34 KB); a wider
//    d is cut into kDS-dim slices, each staged with its chunk. SQ8 codes
//    land in shared memory as bytes (HBM reads stay one byte a dimension)
//    and are widened to bf16 there, exactly (every integer up to 256 is a
//    bf16), into the operand tile of the chunk.
// 4. Asynchronous, double-buffered staging: cp.async 16-byte copies (8
//    bytes for codes; rows past the segment and the padded dims are
//    zero-filled, so they score 0, never NaN), with the rows' ids and norms
//    beside them. While a chunk multiplies, the next chunk of the segment,
//    or the first of the next segment, is in flight.
// 5. Top-kp epilogue: the accumulators go to a shared-memory score tile
//    (f32, pairs x kCR rows), then the warp that owns a pair filters its row
//    of scores against the pair's threshold and merges the chunk's
//    survivors into its list in one update (update_chunk): one by one, in
//    stream order, when they are few; when there are many (a list's first
//    chunks) with warp bitonic sorts and merges.
// Shared memory at d = 128: 34 KB of queries, 2 x 17 KB of chunk, 36 KB of
// scores and 4 KB of pair and segment tables, 108 KB in all, so that two
// CTAs share an SM (their registers are capped at 128 a thread by the
// kernels' launch bounds): one CTA's epilogue overlaps the other's loads
// and products.
//
// The wide lists (kp 33..64). Measured on the H100 (PERF.md, clock64
// split of the earlier design, one CTA of 128 pairs an SM): the kernel did
// the kp-32 kernel's warp work (5.1G against 4.8G warp-cycles at 10k
// queries, nprobe 32), 62% of it the list updates, at half its warps an
// SM, so it took twice its time (2.8 ms against 1.3). The lists of 16
// pairs a warp took 64 registers a thread. Now a tile runs as two CTAs of
// 64 pairs, 8 a warp: the lists take 32 registers, as kp 32's do, the
// accumulators are zeroed once the chunk's products are in the score tile
// (so they hold no register through the epilogue), and the kernels run two
// CTAs an SM (128 registers, no spill) on 72 KB of shared memory each.
// Both CTAs of a tile stream the rows their pairs need, the second mostly
// from L2. K4's window state leaves no room for 8 pairs a warp at 128
// registers: its wide kernel runs four CTAs of 32 pairs a tile. Measured
// (PERF.md, 10k queries, nprobe 32): 1.82 ms at kp 46 (2.80 before), K4
// 0.41 at kp 58 (0.76, 1024 queries).
//
// Lists above kp 64 (kR = kRGlobal). Registers cannot hold them (8 kp / 32
// registers a thread at 8 pairs a warp). The earlier design kept each
// sorted list in its own row of out_d / out_p and merged every chunk's
// survivors into it by a walk of the list's tail in L2, ranks found with
// shuffles: 59% of the warp time at kp 106 and 69% at kp 262 (PERF.md).
// Now:
// - The lists live in shared memory, kp slots a pair, beside their
//   threshold (entry kp - 1, +inf while the list is not full) and filled
//   count. The launch cuts a tile into kPT / np CTAs of np pairs, np the
//   largest of 64, 32, 16, 8 whose layout lets two CTAs share an SM (113
//   KB each), else one (227 KB) (global_lists). To leave room for them the
//   score tile (row stride kSSG) lies in the chunk's operand tile once
//   the products have read it. At d = 128: np 64 up to kp 109, 32 to 257,
//   16 to 553, 8 to 1145, one CTA an SM to 2969; above, the lists stay in
//   the output rows, 128 pairs a CTA; the same code runs on either memory.
// - A list that is not full keeps its entries unsorted: each chunk's
//   survivors (every real row, the threshold being +inf) are appended in
//   stream order, with no sort. The first time the list reaches kp it is
//   sorted once in place (sort_list: runs of 64 from its head, each sorted
//   in registers by the warp bitonic network and merged into the sorted
//   entries before it) and the threshold is set; a list that never fills
//   (kp at or above its rows) is sorted at the end, with no merge at all.
// - A full list takes each chunk's survivors by merge_run: the owning
//   warp sorts the (at most 64) survivors in registers, puts them in its
//   64 scratch slots of shared memory, and merges them into the list by
//   ranks: survivor j moves to j + (entries before it), entry i to i +
//   (survivors before it), each a binary search by one lane over the
//   other sorted side in shared memory, the entries in blocks of 32 from
//   the list's tail towards its head, stopping at the first block whose
//   entries all precede every survivor (they stay). Entries only move
//   towards the tail, so a block is read before anything is written over
//   it. A chunk that would take a filling list past kp sorts its entries
//   and merges the same way.
// - At the end each CTA writes its lists to their rows (K3 with the empty
//   slots, K4 only for pairs with rows in the window).
// Measured (PERF.md, 10k queries, nprobe 32): 4.18 ms at kp 106 (4.36
// before), 5.89 at kp 262 (6.06-6.26), 1.03 at kp 1030 on 1024 queries
// (1.29-1.31); K4 0.80 / 0.88 / 0.83 at kp 100 / 262 / 1030 (0.85 / 1.12
// / 1.22). An alternative merge (one survivor a lane, unsorted, its place
// from counters and prefix sums) ran 1.3x slower, and one CTA of 16 warps
// an SM over whole tiles no faster than two of 8 over sub-tiles.
//
// The window (kWindow = true, K4): the kernel reads global stream rows
// [wrow0, wrow1) only; they lie at data / ids / norms + (row - wrow0).
// Every pair range is clamped to the window, and positions stay global. A
// pair whose clamped range is not empty starts from its top-kp so far
// (out_d / out_p, from earlier windows, whose positions are all lower), so
// the new rows merge into it with the same tie rule, and the merged list is
// written back in place; the running list of a pair with nothing in the
// window is neither read nor written. K3 (kWindow = false) reads the whole
// stream, starts from empty lists and writes every pair.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace ivf_scan {

constexpr int kPT = 128;             // pairs per tile of the plan
constexpr int kPTWide = 64;          // pairs per CTA of the wide lists
constexpr int kPTWideWindow = 32;    // the same for K4 (its window state
                                     // leaves no room for 64 at 128 regs)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCR = 64;              // stream rows per chunk (8 n8 tiles)
constexpr int kDS = 128;             // dims per slice
constexpr int kStages = 2;           // chunks in the cp.async ring
constexpr int kSS = kCR + 8;         // row stride of the score tile (f32)
constexpr int kSSG = kCR + 4;        // the same for the kp >= 65 lists
constexpr int kKPMax = 32;           // top-kp entries a lane holds, per kR
constexpr int kRGlobal = 0;          // kR of the lists in global memory
constexpr int kSerialMax = 6;        // more candidates: bitonic merge
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = __builtin_huge_valf();

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Shared-memory layout for width d (byte offsets). Rows of the query and
// chunk tiles are (slice width rounded to 16) + 8 bf16 long: a multiple of
// 16 bytes whose 16-byte count is odd, or an odd multiple of 2 or 4, so the
// 8 rows of an ldmatrix hit 8 distinct 16-byte bank groups.
struct Layout {
  int stride;      // bf16 elements per query / chunk row
  int rstride;     // bytes per staged code row (SQ8)
  int nslices;     // kDS-dim slices of d
  size_t qs, xs, raw, sid, snorm, sc, plo, phi, pq, pqn, sfirst, send, nseg;
  size_t thr, nfill;  // the lists of kp >= 65 only
  size_t csd, csp;    // the kp >= 65 merges' scratch, 64 slots a warp
  size_t ld, lp;      // the lists of kp >= 65 kept in shared memory
  size_t total;
  int sstride;        // f32 row stride of the score tile
  bool sc_xs;         // the score tile lies in the chunk's operand tile
};

// Per-SM shared memory of the H100: up to 227 KB for one CTA, and 113 KB
// each for two (228 KB an SM, 1 KB of it reserved a CTA)
constexpr size_t kSmemOne = 232448;
constexpr size_t kSmemTwo = 115712;

// np: pairs a CTA; glist: the per-pair threshold and count of the kp >= 65
// lists; kpl: list entries a pair kept in shared memory (0: none)
template <typename Elem>
__host__ __device__ inline Layout layout(int d, int np, bool glist,
                                         int kpl) {
  constexpr bool kU8 = sizeof(Elem) == 1;
  Layout L;
  const int wmax = round16(d) < kDS ? round16(d) : kDS;
  L.stride = wmax + 8;
  L.rstride = wmax;
  L.nslices = (d + kDS - 1) / kDS;
  const size_t row = sizeof(uint16_t) * L.stride;
  size_t o = 0;
  // the tile's queries once (one slice), or each stage's slice of them
  L.qs = o;
  o += (L.nslices > 1 ? kStages : 1) * np * row;
  // bf16 chunks: one per stage; SQ8: one widened tile, the codes per stage
  L.xs = o;
  o += (kU8 ? 1 : kStages) * kCR * row;
  L.raw = o;
  o += kU8 ? static_cast<size_t>(kStages) * kCR * L.rstride : 0;
  L.sid = o;
  o += sizeof(int) * kStages * kCR;
  L.snorm = o;
  o += sizeof(float) * kStages * kCR;
  // the score tile: the products write blocks of 16 pair rows. For the
  // kp >= 65 lists it takes the chunk's operand tile when that holds it
  // (the operand is read by then; the next chunk loads into the other)
  const int srows = np < 16 ? 16 : np;
  L.sstride = glist ? kSSG : kSS;
  L.sc_xs = glist && sizeof(float) * srows * L.sstride <= kCR * row;
  L.sc = o;
  o += L.sc_xs ? 0 : sizeof(float) * srows * L.sstride;
  L.plo = o;
  o += sizeof(int) * np;
  L.phi = o;
  o += sizeof(int) * np;
  L.pq = o;
  o += sizeof(int) * np;
  L.pqn = o;
  o += sizeof(float) * np;
  L.sfirst = o;
  o += sizeof(int) * np;
  L.send = o;
  o += sizeof(int) * np;
  L.nseg = o;
  o += 16;
  // per pair: the list's threshold and filled entries (kp >= 65)
  L.thr = o;
  o += glist ? sizeof(float) * np : 0;
  L.nfill = o;
  o += glist ? sizeof(int) * np : 0;
  L.csd = o;
  o += glist ? sizeof(float) * kWarps * 64 : 0;
  L.csp = o;
  o += glist ? sizeof(int) * kWarps * 64 : 0;
  L.ld = o;
  o += sizeof(float) * np * kpl;
  L.lp = o;
  o += sizeof(int) * np * kpl;
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of N bytes; the bytes past `src_bytes` (all of them at 0) are
// written as zeros and not read
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool read) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(read ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N), "r"(read ? N : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
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

// Two codes -> two bf16 in one word, exactly: 2^23 + c is exact in f32,
// so (2^23 + c) - 2^23 = c, whose f32 bits end in 16 zero bits (c < 256)
__device__ __forceinline__ uint32_t codes2_bf16(uint32_t c0, uint32_t c1) {
  const float f0 = __uint_as_float(0x4b000000u | c0) - 8388608.0f;
  const float f1 = __uint_as_float(0x4b000000u | c1) - 8388608.0f;
  // the top halves of f0 (low word) and f1 (high word)
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// 8 codes -> 8 bf16 (one 16-byte vector)
__device__ __forceinline__ uint4 widen8(const uint2 c) {
  return make_uint4(codes2_bf16(c.x & 0xffu, (c.x >> 8) & 0xffu),
                    codes2_bf16((c.x >> 16) & 0xffu, c.x >> 24),
                    codes2_bf16(c.y & 0xffu, (c.y >> 8) & 0xffu),
                    codes2_bf16((c.y >> 16) & 0xffu, c.y >> 24));
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

// Warp-wide bitonic sort, ascending over the 32 lanes, of one (distance,
// position) a lane.
__device__ __forceinline__ void sort32(float& d, int& p, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float od = __shfl_xor_sync(kFull, d, j);
      const int op = __shfl_xor_sync(kFull, p, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      if (before(od, op, d, p) == keep_min) {
        d = od;
        p = op;
      }
    }
  }
}

// sort32 of two independent sets a lane; their steps interleave.
__device__ __forceinline__ void sort32x2(float& da, int& pa, float& db,
                                         int& pb, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float oda = __shfl_xor_sync(kFull, da, j);
      const int opa = __shfl_xor_sync(kFull, pa, j);
      const float odb = __shfl_xor_sync(kFull, db, j);
      const int opb = __shfl_xor_sync(kFull, pb, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      if (before(oda, opa, da, pa) == keep_min) {
        da = oda;
        pa = opa;
      }
      if (before(odb, opb, db, pb) == keep_min) {
        db = odb;
        pb = opb;
      }
    }
  }
}

// Warp-wide: (d, p) and (cd, cp) each sorted ascending over the 32 lanes.
// Leaves in (d, p) the 32 smallest of both, sorted: the elementwise min
// with the reversed second list (a bitonic sequence), then a bitonic merge.
__device__ __forceinline__ void merge_sorted(float& d, int& p, float cd,
                                             int cp, int lane) {
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

// Warp-wide: inserts the candidates of mask m (lane l: distance dis, stream
// position row0 + l, in increasing position, each after every kept entry
// with a distance <= its own, which has a lower position) into the sorted
// top-kp list (d, p), entry i in lane i.
__device__ __forceinline__ void insert_each(float& d, int& p, float dis,
                                            unsigned m, int row0, int kp,
                                            int lane) {
  float thr = __shfl_sync(kFull, d, kp - 1);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float dv = __shfl_sync(kFull, dis, src);
    if (dv < thr) {
      const int idx = __popc(__ballot_sync(kFull, lane < kp && d <= dv));
      const float ud = __shfl_up_sync(kFull, d, 1);
      const int up = __shfl_up_sync(kFull, p, 1);
      if (lane == idx) {
        d = dv;
        p = row0 + src;
      } else if (lane > idx) {
        d = ud;
        p = up;
      }
      thr = __shfl_sync(kFull, d, kp - 1);
    }
  }
}

// One lane's entry of a pair's top-kp list: lane i holds entry i
struct Entry {
  float d;
  int p;
};

// Warp-wide: merges one chunk's candidates of a pair, rows row0 + lane
// (c0: below the list's threshold, distance dis0) and row0 + 32 + lane (c1,
// dis1), into its sorted top-kp list e; returns the lane's entry. A few are
// inserted one by one, in increasing position. Up to 32 are packed into
// one set through `row` (the pair's row of the score tile, read already:
// 32 distances, then 32 positions), sorted and merged into the list; more
// are sorted as two sets, cut to their 32 smallest and merged. Sorted
// candidates become the list if it is empty (a list's first chunk). The tie
// order is (distance, position) throughout.
// A call, not inlined: the epilogue visits up to kPW pairs, each warp a
// different one at a time, and a copy per pair would outgrow the
// instruction cache. The entry travels in registers, by value, so the
// lists stay in the caller's registers.
__device__ __noinline__ Entry update_chunk(Entry e, float dis0, bool c0,
                                           float dis1, bool c1, int row0,
                                           int kp, float* row, int lane) {
  const unsigned m0 = __ballot_sync(kFull, c0);
  const unsigned m1 = __ballot_sync(kFull, c1);
  const int n0 = __popc(m0), n = n0 + __popc(m1);
  if (n <= kSerialMax) {
    insert_each(e.d, e.p, dis0, m0, row0, kp, lane);
    insert_each(e.d, e.p, dis1, m1, row0 + 32, kp, lane);
    return e;
  }
  float da, db;
  int pa, pb;
  if (n <= 32) {
    const unsigned below = (1u << lane) - 1u;
    int* rowp = reinterpret_cast<int*>(row) + 32;
    __syncwarp();
    if (c0) {
      const int i = __popc(m0 & below);
      row[i] = dis0;
      rowp[i] = row0 + lane;
    }
    if (c1) {
      const int i = n0 + __popc(m1 & below);
      row[i] = dis1;
      rowp[i] = row0 + 32 + lane;
    }
    __syncwarp();
    da = lane < n ? row[lane] : kInf;
    pa = lane < n ? rowp[lane] : INT_MAX;
    sort32(da, pa, lane);
  } else {
    da = c0 ? dis0 : kInf;
    db = c1 ? dis1 : kInf;
    pa = c0 ? row0 + lane : INT_MAX;
    pb = c1 ? row0 + 32 + lane : INT_MAX;
    sort32x2(da, pa, db, pb, lane);
    merge_sorted(da, pa, db, pb, lane);
  }
  if (__shfl_sync(kFull, e.d, 0) == kInf) return {da, pa};
  merge_sorted(e.d, e.p, da, pa, lane);
  return e;
}

// The wide list (kR = 2, kp up to 64): lane i holds entries i (a) and
// 32 + i (b) of a pair's sorted top-kp.
struct Entry2 {
  float da;
  int pa;
  float db;
  int pb;
};

// Entry kp - 1 of a wide list: the pair's threshold (kp warp-uniform)
__device__ __forceinline__ float kth2(const Entry2& e, int kp) {
  return kp <= 32 ? __shfl_sync(kFull, e.da, kp - 1)
                  : __shfl_sync(kFull, e.db, kp - 33);
}

// Warp-wide: the half-cleaners at distances 16 .. 1 of one bitonic set of
// 32, ascending (the second half of merge_sorted)
__device__ __forceinline__ void bitonic32(float& d, int& p, int lane) {
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

// Warp-wide: (a, b) holds a bitonic sequence of 64 (entry i in a for i <
// 32, in b at 32 + i); sorts it ascending in place.
__device__ __forceinline__ void bitonic64(Entry2& e, int lane) {
  if (before(e.db, e.pb, e.da, e.pa)) {
    const float td = e.da;
    const int tp = e.pa;
    e.da = e.db;
    e.pa = e.pb;
    e.db = td;
    e.pb = tp;
  }
  bitonic32(e.da, e.pa, lane);
  bitonic32(e.db, e.pb, lane);
}

// Warp-wide: sorts 64 entries, c.a of lane i entry i and c.b entry 32 + i,
// ascending by (distance, position) in place: two sorts of 32, the second
// reversed (bitonic), then a bitonic merge.
__device__ __forceinline__ void sort64(Entry2& c, int lane) {
  sort32x2(c.da, c.pa, c.db, c.pb, lane);
  c.db = __shfl_sync(kFull, c.db, 31 - lane);
  c.pb = __shfl_sync(kFull, c.pb, 31 - lane);
  bitonic64(c, lane);
}

// Warp-wide: one chunk's candidates of a pair, rows row0 + lane (c0,
// distance dis0) and row0 + 32 + lane (c1, dis1), sorted ascending by
// (distance, position) into entries lane (a) and 32 + lane (b); the rest
// are (+inf, INT_MAX).
__device__ __forceinline__ Entry2 sorted_candidates(float dis0, bool c0,
                                                    float dis1, bool c1,
                                                    int row0, int lane) {
  Entry2 c{c0 ? dis0 : kInf, c0 ? row0 + lane : INT_MAX, c1 ? dis1 : kInf,
           c1 ? row0 + 32 + lane : INT_MAX};
  sort64(c, lane);
  return c;
}

// Warp-wide insert_each on a wide list: inserts the candidates of mask m
// (lane l: distance dis, stream position row0 + l, in increasing position)
// one by one.
__device__ __forceinline__ void insert_each2(Entry2& e, float dis, unsigned m,
                                             int row0, int kp, int lane) {
  float thr = kth2(e, kp);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float dv = __shfl_sync(kFull, dis, src);
    if (dv < thr) {
      const int idx =
          __popc(__ballot_sync(kFull, lane < kp && e.da <= dv)) +
          __popc(__ballot_sync(kFull, lane + 32 < kp && e.db <= dv));
      const float a31 = __shfl_sync(kFull, e.da, 31);
      const int pa31 = __shfl_sync(kFull, e.pa, 31);
      const float uda = __shfl_up_sync(kFull, e.da, 1);
      const int upa = __shfl_up_sync(kFull, e.pa, 1);
      const float udb = __shfl_up_sync(kFull, e.db, 1);
      const int upb = __shfl_up_sync(kFull, e.pb, 1);
      if (lane == idx) {
        e.da = dv;
        e.pa = row0 + src;
      } else if (lane > idx) {
        e.da = uda;
        e.pa = upa;
      }
      if (lane + 32 == idx) {
        e.db = dv;
        e.pb = row0 + src;
      } else if (lane + 32 > idx) {
        e.db = lane ? udb : a31;
        e.pb = lane ? upb : pa31;
      }
      thr = kth2(e, kp);
    }
  }
}

// update_chunk on a wide list: a few candidates are inserted one by one;
// more (up to the chunk's 64) are sorted as two sets of 32, merged into
// one sorted set of 64, which becomes the list if it is empty and is
// otherwise merged with it, keeping the 64 smallest (the elementwise min of
// the list and the reversed set is bitonic). Not inlined, as update_chunk.
__device__ __noinline__ Entry2 update_chunk2(Entry2 e, float dis0, bool c0,
                                             float dis1, bool c1, int row0,
                                             int kp, int lane) {
  const unsigned m0 = __ballot_sync(kFull, c0);
  const unsigned m1 = __ballot_sync(kFull, c1);
  if (__popc(m0) + __popc(m1) <= kSerialMax) {
    insert_each2(e, dis0, m0, row0, kp, lane);
    insert_each2(e, dis1, m1, row0 + 32, kp, lane);
    return e;
  }
  Entry2 c = sorted_candidates(dis0, c0, dis1, c1, row0, lane);
  if (__shfl_sync(kFull, e.da, 0) == kInf) return c;
  // entry i of the list against entry 63 - i of the candidates
  const float rd0 = __shfl_sync(kFull, c.db, 31 - lane);
  const int rp0 = __shfl_sync(kFull, c.pb, 31 - lane);
  const float rd1 = __shfl_sync(kFull, c.da, 31 - lane);
  const int rp1 = __shfl_sync(kFull, c.pa, 31 - lane);
  if (before(rd0, rp0, e.da, e.pa)) {
    e.da = rd0;
    e.pa = rp0;
  }
  if (before(rd1, rp1, e.db, e.pb)) {
    e.db = rd1;
    e.pb = rp1;
  }
  bitonic64(e, lane);
  return e;
}

// Warp-wide: the filled entries of a pair's sorted list in global memory
// (its finite distances, a prefix of its kp).
__device__ __forceinline__ int filled_entries(const float* ld, int kp,
                                              int lane) {
  for (int b = 0; b < kp; b += 32) {
    const int i = b + lane;
    const unsigned m = __ballot_sync(kFull, i >= kp || ld[i] == kInf);
    if (m) return b + __ffs(m) - 1;
  }
  return kp;
}

// One lane: how many of the n entries of a sorted list (ld, lp) come
// before (xd, xp); a binary search of ceil(log2(n + 1)) steps.
__device__ __forceinline__ int rank_in_list(const float* ld, const int* lp,
                                            int n, float xd, int xp) {
  int r = 0;
  for (int s = 1 << (31 - __clz(n | 1)); s > 0; s >>= 1) {
    const int t = r + s;
    if (t <= n && before(ld[t - 1], lp[t - 1], xd, xp)) r = t;
  }
  return r;
}

// Warp-wide: merges m (at most 64) sorted entries c (entry i in c.da /
// c.pa of lane i, entry 32 + i in c.db / c.pb) into the sorted list (ld,
// lp) of nf entries, keeping its first cap; returns its new count. cs_d /
// cs_p: the warp's 64 scratch slots in shared memory. Each entry of c
// moves to j + (list entries before it), each list entry i to i + (entries
// of c before it), both found by binary searches (rank_in_list), the
// list's in blocks of 32 from its tail towards its head, stopping at the
// first block whose entries all precede every entry of c (they stay).
// Entries only move towards the tail, so a block is read before anything
// is written over it; the entries of c are written last.
__device__ __noinline__ int merge_run(Entry2 c, int m, float* ld, int* lp,
                                      int nf, int cap, float* cs_d,
                                      int* cs_p, int lane) {
  __syncwarp();
  cs_d[lane] = c.da;
  cs_p[lane] = c.pa;
  cs_d[32 + lane] = c.db;
  cs_p[32 + lane] = c.pb;
  const int ra = lane < m ? lane + rank_in_list(ld, lp, nf, c.da, c.pa)
                          : cap;
  const int rb = 32 + lane < m
                     ? 32 + lane + rank_in_list(ld, lp, nf, c.db, c.pb)
                     : cap;
  __syncwarp();
  const float fd = __shfl_sync(kFull, c.da, 0);   // the first entry of c
  const int fp = __shfl_sync(kFull, c.pa, 0);
  for (int b = (nf - 1) & ~31; b >= 0; b -= 32) {
    const int i = b + lane;
    const bool in = i < nf;
    const float ed = in ? ld[i] : kInf;
    const int ep = in ? lp[i] : INT_MAX;
    const int last = min(nf - 1 - b, 31);
    if (before(__shfl_sync(kFull, ed, last), __shfl_sync(kFull, ep, last),
               fd, fp))
      break;
    const int r = in ? rank_in_list(cs_d, cs_p, m, ed, ep) : 0;
    __syncwarp();
    if (in && r > 0 && i + r < cap) {
      ld[i + r] = ed;
      lp[i + r] = ep;
    }
  }
  __syncwarp();
  if (ra < cap) {
    ld[ra] = c.da;
    lp[ra] = c.pa;
  }
  if (rb < cap) {
    ld[rb] = c.db;
    lp[rb] = c.pb;
  }
  __syncwarp();
  return min(nf + m, cap);
}

// Warp-wide: sorts the n entries of a list (ld, lp), shared or global
// memory, ascending by (distance, position), in runs of 64 from its head:
// each run is sorted in registers (sort64) and merged into the sorted
// entries before it (merge_run). Not inlined, as update_chunk.
__device__ __noinline__ void sort_list(float* ld, int* lp, int n,
                                       float* cs_d, int* cs_p, int lane) {
  __syncwarp();
  for (int b = 0; b < n; b += 64) {
    const int m = min(64, n - b);
    Entry2 c{lane < m ? ld[b + lane] : kInf,
             lane < m ? lp[b + lane] : INT_MAX,
             32 + lane < m ? ld[b + 32 + lane] : kInf,
             32 + lane < m ? lp[b + 32 + lane] : INT_MAX};
    sort64(c, lane);
    merge_run(c, m, ld, lp, b, b + m, cs_d, cs_p, lane);
  }
}

// Warp-wide update of a kp >= 65 list (ld, lp: the pair's slots in shared
// memory, or its row of out_d / out_p) with one chunk's candidates, rows
// row0 + lane (c0: below the threshold, distance dis0) and row0 + 32 +
// lane (c1, dis1). *nfill entries are held, *thr is entry kp - 1 once
// the list is full (+inf before). A list that is not full holds its
// entries unsorted (only a threshold needs order, and there is none
// before kp entries): the candidates are appended in stream order, and
// the first time the list reaches kp it is sorted once (sort_list). If the
// candidates would pass kp, the entries are sorted and the candidates,
// sorted, merged into them (merge_run), as every chunk's are into a full
// list. cs_d / cs_p: the warp's scratch. Not inlined, as update_chunk.
__device__ __noinline__ void update_list(float dis0, bool c0, float dis1,
                                         bool c1, int row0, int kp,
                                         float* ld, int* lp, float* thr,
                                         int* nfill, float* cs_d, int* cs_p,
                                         int lane) {
  const unsigned m0 = __ballot_sync(kFull, c0);
  const unsigned m1 = __ballot_sync(kFull, c1);
  const int n0 = __popc(m0), m = n0 + __popc(m1);
  const int nf = *nfill;
  if (nf + m > kp) {
    if (nf < kp) sort_list(ld, lp, nf, cs_d, cs_p, lane);
    merge_run(sorted_candidates(dis0, c0, dis1, c1, row0, lane), m, ld, lp,
              nf, kp, cs_d, cs_p, lane);
    if (lane == 0) {
      *thr = ld[kp - 1];
      *nfill = kp;
    }
    __syncwarp();
    return;
  }
  const unsigned below = (1u << lane) - 1u;
  if (c0) {
    const int i = nf + __popc(m0 & below);
    ld[i] = dis0;
    lp[i] = row0 + lane;
  }
  if (c1) {
    const int i = nf + n0 + __popc(m1 & below);
    ld[i] = dis1;
    lp[i] = row0 + 32 + lane;
  }
  if (nf + m == kp) {
    sort_list(ld, lp, kp, cs_d, cs_p, lane);
    if (lane == 0) *thr = ld[kp - 1];
  }
  __syncwarp();
  if (lane == 0) *nfill = nf + m;
  __syncwarp();
}

// Warp 0: the CTA's segments, runs of consecutive pairs (of its np) with
// the same non-empty row range [lo[p], hi[p]): sfirst[i], send[i] bound
// segment i's pairs, *nseg counts them.
__device__ __forceinline__ void find_segments(const int* lo, const int* hi,
                                              int* sfirst, int* send,
                                              int* nseg, int np, int lane) {
  int ns = 0, ne = 0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int b = 0; b < np; b += 32) {
    const int p = b + lane;
    const bool real = p < np && hi[p] > lo[p];
    const bool same_prev =
        p > 0 && lo[p - 1] == lo[p] && hi[p - 1] == hi[p];
    const bool same_next =
        p + 1 < np && lo[p + 1] == lo[p] && hi[p + 1] == hi[p];
    const unsigned ms = __ballot_sync(kFull, real && !same_prev);
    const unsigned me = __ballot_sync(kFull, real && !same_next);
    if (real && !same_prev) sfirst[ns + __popc(ms & below)] = p;
    if (real && !same_next) send[ne + __popc(me & below)] = p + 1;
    ns += __popc(ms);
    ne += __popc(me);
  }
  if (lane == 0) *nseg = ns;
}

// One step of the walk: slice s of the chunk at stream row c0 of segment
// seg (seg == nseg: past the end)
struct Step {
  int seg, c0, s;
};

// The body of one CTA (see the header comment): np pairs of a tile of kPT,
// CTA b taking tile tile0 + b / (kPT / np), its np pairs from (b % (kPT /
// np)) np on. Elem is the stream's element: uint16_t (bf16 bits) or
// uint8_t (SQ8 codes). kR is the list entries a lane: 1 (kp up to 32) or 2
// (kp up to 64, the wide list: lane i holds entries i and 32 + i), or
// kRGlobal (any kp: the lists in shared memory, kpl = kp slots a pair, or
// with kpl = 0 in out_d / out_p). kP is the np of the register lists (kR 1
// or 2); kRGlobal takes np from the launch.
template <bool kWindow, typename Elem = uint16_t, int kR = 1, int kP = kPT>
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
    int* __restrict__ out_p,              // (ntiles*kPT, kp) positions
    int np_g, int kpl) {                  // kRGlobal: pairs a CTA, slots
  constexpr bool kU8 = sizeof(Elem) == 1;
  constexpr bool kG = kR == kRGlobal;
  constexpr int kRL = kG ? 1 : kR;      // list registers a lane (none if kG)
  constexpr int kPW = kP / kWarps;      // pairs a warp (register lists)
  const int np = kG ? np_g : kP;        // pairs of this CTA
  (void)tile_bs;  // the segments replace the tile's block hull
  (void)tile_nb;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<Elem>(d, np, kG, kG ? kpl : 0);
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem + L.qs);
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + L.xs);
  unsigned char* raw = smem + L.raw;
  int* sid = reinterpret_cast<int*>(smem + L.sid);
  float* snorm = reinterpret_cast<float*>(smem + L.snorm);
  float* const sc_own = reinterpret_cast<float*>(smem + L.sc);
  const int ss = L.sstride;
  int* plo = reinterpret_cast<int*>(smem + L.plo);
  int* phi = reinterpret_cast<int*>(smem + L.phi);
  int* pq = reinterpret_cast<int*>(smem + L.pq);
  float* pqn = reinterpret_cast<float*>(smem + L.pqn);
  int* sfirst = reinterpret_cast<int*>(smem + L.sfirst);
  int* send = reinterpret_cast<int*>(smem + L.send);
  int* snseg = reinterpret_cast<int*>(smem + L.nseg);
  float* sthr = reinterpret_cast<float*>(smem + L.thr);
  int* snfill = reinterpret_cast<int*>(smem + L.nfill);
  float* sld = reinterpret_cast<float*>(smem + L.ld);
  int* slp = reinterpret_cast<int*>(smem + L.lp);
  const int stride = L.stride;
  const int nslices = L.nslices;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // the warp's merge scratch (kG)
  float* cs_d = reinterpret_cast<float*>(smem + L.csd) + warp * 64;
  int* cs_p = reinterpret_cast<int*>(smem + L.csp) + warp * 64;
  const int per = kPT / np;                 // CTAs a tile
  const int blk = static_cast<int>(blockIdx.x);
  const int tile = (kWindow ? tile0 : 0) + blk / per;
  const int base = kWindow ? wrow0 : 0;     // stream row of data[0]
  const long long pbase = static_cast<long long>(tile) * kPT +
                          static_cast<long long>(blk % per) * np;

  if (tid < np) {
    const int q = pair_q[pbase + tid];
    pq[tid] = q;
    plo[tid] = in_window<kWindow>(pstart[pbase + tid] * B, wrow0, wrow1);
    phi[tid] = in_window<kWindow>(pend[pbase + tid] * B, wrow0, wrow1);
    pqn[tid] = qn[q];
  }
  __syncthreads();
  if (warp == 0) find_segments(plo, phi, sfirst, send, snseg, np, lane);
  __syncthreads();
  const int nseg = *snseg;

  // the pairs' lists: warp w holds pairs w, w + 8, ..., entry 32 r + i in
  // lane i, register r; or, for kG, their thresholds and filled entries,
  // and with kpl the lists themselves in shared memory (K4: its running
  // lists' filled entries copied in)
  float ld[kPW][kRL];
  int lp[kPW][kRL];
  // a kG list: slot 0 of pair p's entries
  auto list_d = [&](int p) {
    return kpl ? sld + p * kpl : out_d + static_cast<size_t>(pbase + p) * kp;
  };
  auto list_p = [&](int p) {
    return kpl ? slp + p * kpl : out_p + static_cast<size_t>(pbase + p) * kp;
  };
  if constexpr (kG) {
    for (int p = warp; p < np; p += kWarps) {
      float t = kInf;
      int nf = 0;
      if (kWindow && phi[p] > plo[p]) {
        const size_t o = static_cast<size_t>(pbase + p) * kp;
        t = out_d[o + kp - 1];
        nf = t < kInf ? kp : filled_entries(out_d + o, kp, lane);
        if (kpl) {
          for (int i = lane; i < nf; i += 32) {
            sld[p * kpl + i] = out_d[o + i];
            slp[p * kpl + i] = out_p[o + i];
          }
        }
      }
      if (lane == 0) {
        sthr[p] = t;
        snfill[p] = nf;
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int j = 0; j < kPW; ++j) {
      const int p = j * kWarps + warp;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        ld[j][r] = kInf;
        lp[j][r] = -1;
        if (kWindow && 32 * r + lane < kp && phi[p] > plo[p]) {
          const size_t o =
              static_cast<size_t>(pbase + p) * kp + 32 * r + lane;
          ld[j][r] = out_d[o];
          lp[j][r] = ld[j][r] == kInf ? -1 : out_p[o];
        }
      }
    }
  }

  // the width of slice s of d (a multiple of 8; the mma depth rounds it
  // to 16)
  auto slice_w = [&](int s) { return min(kDS, d - s * kDS); };
  auto advance = [&](Step st) -> Step {
    if (st.s + 1 < nslices) return {st.seg, st.c0, st.s + 1};
    if (st.c0 + kCR < phi[sfirst[st.seg]]) return {st.seg, st.c0 + kCR, 0};
    const int ns = st.seg + 1;
    return {ns, ns < nseg ? plo[sfirst[ns]] : 0, 0};
  };
  // cp.async of one step into ring slot `slot`: the chunk's rows (slice
  // st.s), at the chunk's last slice its ids and norms, and for a d of
  // several slices the segment's queries' slice
  auto issue = [&](Step st, int slot) {
    const int s0 = sfirst[st.seg];
    const int hi = phi[s0];
    const int d0 = st.s * kDS;
    const int w = slice_w(st.s);
    const int nv = round16(w) / 8, nreal = w / 8;
    for (int i = tid; i < kCR * nv; i += kThreads) {
      const int r = i / nv, v = i - r * nv;
      const int row = st.c0 + r;
      const bool ok = row < hi && v < nreal;
      const Elem* src =
          ok ? data + static_cast<size_t>(row - base) * d + d0 + v * 8 : data;
      if constexpr (kU8)
        cp_async<8>(raw + (slot * kCR + r) * L.rstride + v * 8, src, ok);
      else
        cp_async<16>(xs + (slot * kCR + r) * stride + v * 8, src, ok);
    }
    if (st.s == nslices - 1 && tid < 2 * kCR) {
      const int r = tid & (kCR - 1);
      const int row = st.c0 + r;
      const bool ok = row < hi;
      const size_t o = ok ? static_cast<size_t>(row - base) : 0;
      if (tid < kCR)
        cp_async<4>(sid + slot * kCR + r, ids + o, ok);
      else
        cp_async<4>(snorm + slot * kCR + r, norms + o, ok);
    }
    if (nslices > 1) {
      const int S = send[st.seg] - s0;
      for (int i = tid; i < S * nv; i += kThreads) {
        const int pl = i / nv, v = i - pl * nv;
        const bool ok = v < nreal;
        const uint16_t* src =
            ok ? xq + static_cast<size_t>(pq[s0 + pl]) * d + d0 + v * 8 : xq;
        cp_async<16>(qs + (slot * np + pl) * stride + v * 8, src, ok);
      }
    }
  };

  if (nslices == 1) {
    // the tile's queries, once: rows of the pairs in some segment
    const int nv = round16(d) / 8, nreal = d / 8;
    for (int i = tid; i < np * nv; i += kThreads) {
      const int p = i / nv, v = i - p * nv;
      if (phi[p] > plo[p]) {
        const bool ok = v < nreal;
        const uint16_t* src =
            ok ? xq + static_cast<size_t>(pq[p]) * d + v * 8 : xq;
        cp_async<16>(qs + p * stride + v * 8, src, ok);
      }
    }
  }
  Step cur{0, nseg > 0 ? plo[sfirst[0]] : 0, 0};
  Step nxt = cur;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (nxt.seg < nseg) {
      issue(nxt, i);
      nxt = advance(nxt);
    }
    cp_async_commit();
  }

  float acc[2][4][4];
  int slot = 0;
  while (cur.seg < nseg) {
    cp_async_wait<kStages - 2>();
    __syncthreads();    // step cur landed; every warp is done with the last
    if (nxt.seg < nseg) {
      issue(nxt, (slot + kStages - 1) % kStages);
      nxt = advance(nxt);
    }
    cp_async_commit();

    const int s0 = sfirst[cur.seg];
    const int S = send[cur.seg] - s0;
    const int wp = round16(slice_w(cur.s));
    const uint16_t* xt = xs + (kU8 ? 0 : slot * kCR * stride);
    if constexpr (kU8) {
      // widen the codes to the bf16 operand tile
      const int nv = wp / 8;
      for (int i = tid; i < kCR * nv; i += kThreads) {
        const int r = i / nv, v = i - r * nv;
        const uint2 c = *reinterpret_cast<const uint2*>(
            raw + (slot * kCR + r) * L.rstride + v * 8);
        *reinterpret_cast<uint4*>(xs + r * stride + v * 8) = widen8(c);
      }
      __syncthreads();
    }
    // the warp's block of the (S x kCR) score tile: m-tiles 2 mg, 2 mg + 1
    // (of Mt), n-tiles ng * nw .. + nw - 1 (of 8)
    const int Mt = (S + 15) >> 4;
    const int MG = (Mt + 1) >> 1;
    const int NG = MG == 1 ? 8 : (MG == 2 ? 4 : 2);
    const int nw = kWarps / NG;
    const int mg = warp / NG, ng = warp - (warp / NG) * NG;
    const bool mine = mg < MG;
    const bool two = 2 * mg + 1 < Mt;
    if (cur.s == 0) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
    }
    if (mine) {
      // A rows: the segment's pairs (past the tile: any row, unused)
      const uint16_t* qt = nslices > 1 ? qs + slot * np * stride : qs;
      const int q0 = nslices > 1 ? 0 : s0;
      const int ra = min(q0 + 32 * mg + (lane & 15), np - 1);
      const int rb = min(q0 + 32 * mg + 16 + (lane & 15), np - 1);
      const uint16_t* pa = qt + ra * stride + (lane >> 4) * 8;
      const uint16_t* pb = qt + rb * stride + (lane >> 4) * 8;
      // B rows: lanes 8i .. 8i + 7 address matrix i = (n-tile, k half)
      const uint16_t* px =
          xt + (8 * ng * nw + (nw > 1 ? 8 * (lane >> 4) : 0) + (lane & 7)) *
                   stride +
          ((lane >> 3) & 1) * 8;
      for (int k0 = 0; k0 < wp; k0 += 16) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, pa + k0);
        if (two) ldmatrix_x4(a1, pb + k0);
#pragma unroll
        for (int n = 0; n < 4; n += 2) {
          if (n < nw) {
            uint32_t b[4];
            if (nw == 1)
              ldmatrix_x2(b, px + k0);
            else
              ldmatrix_x4(b, px + n * 8 * stride + k0);
            mma_bf16(acc[0][n], a0, b[0], b[1]);
            if (nw > 1) mma_bf16(acc[0][n + 1], a0, b[2], b[3]);
            if (two) {
              mma_bf16(acc[1][n], a1, b[0], b[1]);
              if (nw > 1) mma_bf16(acc[1][n + 1], a1, b[2], b[3]);
            }
          }
        }
      }
    }
    if (cur.s == nslices - 1) {
      float* const sc = L.sc_xs
          ? reinterpret_cast<float*>(const_cast<uint16_t*>(xt))
          : sc_own;
      if (L.sc_xs) __syncthreads();   // every warp is done with the operand
      if (mine) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (a == 0 || two) {
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              if (n < nw) {
                float* o = sc + (32 * mg + 16 * a + (lane >> 2)) * ss +
                           8 * (ng * nw + n) + 2 * (lane & 3);
                *reinterpret_cast<float2*>(o) =
                    make_float2(acc[a][n][0], acc[a][n][1]);
                *reinterpret_cast<float2*>(o + 8 * ss) =
                    make_float2(acc[a][n][2], acc[a][n][3]);
              }
            }
          }
        }
      }
      if constexpr (kR != 1) {
        // the chunk's products are in the score tile: the next chunk
        // starts from zero, so the accumulators hold no register through
        // the epilogue (the wide and global lists need them)
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
      }
      __syncthreads();

      // scores -> per-pair top-kp, rows in increasing stream position
      const int c0 = cur.c0;
      const int hi = phi[s0];
      const int* cid = sid + slot * kCR;
      const float* cn = snorm + slot * kCR;
      const bool ok0 = c0 + lane < hi && cid[lane] >= 0;
      const bool ok1 = c0 + lane + 32 < hi && cid[lane + 32] >= 0;
      const float n0 = cn[lane], n1 = cn[lane + 32];
      if constexpr (kG) {
#pragma unroll 1
        for (int p = warp; p < np; p += kWarps) {
          if (p < s0 || p >= s0 + S) continue;          // warp-uniform
          const float* srow = sc + (p - s0) * ss;
          const float qv = pqn[p];
          const float ip0 = srow[lane], ip1 = srow[lane + 32];
          const float dis0 = similarity ? -ip0 - qv
                                        : fmaxf(qv + n0 - 2.0f * ip0, 0.0f);
          const float dis1 = similarity ? -ip1 - qv
                                        : fmaxf(qv + n1 - 2.0f * ip1, 0.0f);
          const float thr = sthr[p];
          const bool cand0 = ok0 && dis0 < thr, cand1 = ok1 && dis1 < thr;
          if (!__any_sync(kFull, cand0 || cand1)) continue;
          update_list(dis0, cand0, dis1, cand1, c0, kp, list_d(p),
                      list_p(p), sthr + p, snfill + p, cs_d, cs_p, lane);
        }
      } else {
#pragma unroll
      for (int j = 0; j < kPW; ++j) {
        const int p = j * kWarps + warp;
        if (p < s0 || p >= s0 + S) continue;            // warp-uniform
        float* srow = sc + (p - s0) * ss;
        const float qv = pqn[p];
        const float ip0 = srow[lane], ip1 = srow[lane + 32];
        const float dis0 = similarity ? -ip0 - qv
                                      : fmaxf(qv + n0 - 2.0f * ip0, 0.0f);
        const float dis1 = similarity ? -ip1 - qv
                                      : fmaxf(qv + n1 - 2.0f * ip1, 0.0f);
        float thr;
        if constexpr (kR == 1)
          thr = __shfl_sync(kFull, ld[j][0], kp - 1);
        else
          thr = kth2({ld[j][0], lp[j][0], ld[j][1], lp[j][1]}, kp);
        const bool cand0 = ok0 && dis0 < thr, cand1 = ok1 && dis1 < thr;
        if (!__any_sync(kFull, cand0 || cand1)) continue;
        if constexpr (kR == 1) {
          const Entry e = update_chunk({ld[j][0], lp[j][0]}, dis0, cand0,
                                       dis1, cand1, c0, kp, srow, lane);
          ld[j][0] = e.d;
          lp[j][0] = e.p;
        } else {
          const Entry2 e =
              update_chunk2({ld[j][0], lp[j][0], ld[j][1], lp[j][1]}, dis0,
                            cand0, dis1, cand1, c0, kp, lane);
          ld[j][0] = e.da;
          lp[j][0] = e.pa;
          ld[j][1] = e.db;
          lp[j][1] = e.pb;
        }
      }
      }
    }
    cur = advance(cur);
    slot = (slot + 1) % kStages;
  }
  cp_async_wait<0>();

  if constexpr (kG) {
    // a list that never filled is sorted now; lists in shared memory go to
    // their rows; K3 writes the empty slots past each list's entries (K4's
    // running lists hold theirs already, and a pair with no rows in the
    // window keeps its list untouched)
    for (int p = warp; p < np; p += kWarps) {
      if (kWindow && !(phi[p] > plo[p])) continue;
      const int nf = snfill[p];
      float* ld_p = list_d(p);
      int* lp_p = list_p(p);
      if (nf < kp) sort_list(ld_p, lp_p, nf, cs_d, cs_p, lane);
      const size_t o = static_cast<size_t>(pbase + p) * kp;
      if (kpl) {
        for (int i = lane; i < nf; i += 32) {
          out_d[o + i] = ld_p[i];
          out_p[o + i] = lp_p[i];
        }
      }
      if (!kWindow) {
        for (int i = nf + lane; i < kp; i += 32) {
          out_d[o + i] = kInf;
          out_p[o + i] = -1;
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kPW; ++j) {
    const int p = j * kWarps + warp;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (32 * r + lane < kp && (!kWindow || phi[p] > plo[p])) {
        const size_t o = static_cast<size_t>(pbase + p) * kp + 32 * r + lane;
        out_d[o] = ld[j][r];
        out_p[o] = ld[j][r] == kInf ? -1 : lp[j][r];
      }
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
      float *__restrict__ out_d, int *__restrict__ out_p, int np, int kpl
#define IVF_SCAN_TILE_ARGS                                                   \
  xq, qn, pair_q, pstart, pend, tile_bs, tile_nb, data, ids, norms, wrow0,  \
      wrow1, tile0, d, B, kp, similarity, out_d, out_p, np, kpl

// Where the kp >= 65 lists live: in shared memory, kpl = kp slots a pair,
// at the largest np (pairs a CTA, 64 down to 8) whose layout lets two CTAs
// share an SM, else one; past that (kp above ~2900 at d = 128) in the
// output rows (kpl = 0), a tile a CTA.
template <typename Elem>
inline void global_lists(int d, int kp, int& np, int& kpl) {
  const size_t caps[2] = {kSmemTwo, kSmemOne};
  for (int c = 0; c < 2; ++c) {
    for (int n = 64; n >= 8; n >>= 1) {
      if (layout<Elem>(d, n, true, kp).total <= caps[c]) {
        np = n;
        kpl = kp;
        return;
      }
    }
  }
  np = kPT;
  kpl = 0;
}

// Launches `kernel` (a scan_tile kernel on a stream of Elem, kR list
// entries a lane and kP pairs a CTA, or kRGlobal: no cap on kp, the pairs
// a CTA from global_lists) over the tiles [tile0, tile0 + ntiles), kPT /
// np CTAs a tile, on `stream`; allocates nothing. Returns
// cudaGetLastError() (0 on success).
template <typename Elem = uint16_t, int kR = 1, int kP = kPT,
          typename Kernel>
int launch_scan_tiles(Kernel kernel, const void* xq, const void* qn,
                      const void* pair_q, const void* pstart,
                      const void* pend, const void* tile_bs,
                      const void* tile_nb, const void* data, const void* ids,
                      const void* norms, int wrow0, int wrow1, int tile0,
                      int ntiles, int d, int B, int kp, int similarity,
                      void* out_d, void* out_p, void* stream) {
  if (d <= 0 || d % 8 != 0 || B <= 0 || kp < 1 ||
      (kR != kRGlobal && kp > kR * kKPMax) || ntiles < 0 || tile0 < 0 ||
      wrow0 < 0 || wrow1 < wrow0)
    return static_cast<int>(cudaErrorInvalidValue);
  int np = kP, kpl = 0;
  if (kR == kRGlobal) global_lists<Elem>(d, kp, np, kpl);
  const size_t smem = layout<Elem>(d, np, kR == kRGlobal, kpl).total;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (ntiles > 0) {
    kernel<<<ntiles * (kPT / np), kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(xq), static_cast<const float*>(qn),
        static_cast<const int*>(pair_q), static_cast<const int*>(pstart),
        static_cast<const int*>(pend), static_cast<const int*>(tile_bs),
        static_cast<const int*>(tile_nb), static_cast<const Elem*>(data),
        static_cast<const int*>(ids), static_cast<const float*>(norms), wrow0,
        wrow1, tile0, d, B, kp, similarity, static_cast<float*>(out_d),
        static_cast<int*>(out_p), np, kpl);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ivf_scan
