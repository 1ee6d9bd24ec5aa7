#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. device  — a CUDA device is required; nvidia-smi's name and power limit.
  2. build   — compile the seven CUDA libraries from tpu_ann_torch/csrc
     (one nvcc each, in parallel): K3 ivf_scan_fused, K3-SQ8 ivf_scan_sq8,
     K1 flat_knn_fused, K2 reservoir_topk, K4 ivf_scan_paged, K1p and B1
     flat_knn_variants, B2 row_copy_probe.
  3. IVF path at the benchmark's size: calibrated SIFT1M surrogate (1M
     base, 100k train, 10k queries, seed 123); the exact IndexFlat's
     ground truth (no K1 launch); make_ivf_flat(128, 4096) -> train
     (k-means, 10 iterations) -> add -> search and search_stats at nprobe
     16 / 32 / 64, k=10. Recall@10 must reach the floors; every search is
     exactly one K3 launch and no K1 / K2 launch.
  4. K3 vs its plain torch version at the IVF path's shapes (1024 queries,
     nprobe 32): per-pair outputs and final (D, I) equal on the integer
     data; IP on float data with id overlap >= 0.999; times.
  4a. IVF-SQ8 path on the same data and centroids:
     IndexIVFScalarQuantizer(phase 3's quantizer, 128, 4096, QT_8BIT),
     quantizer_trains_alone=1 (no k-means) -> train (the codec, on the
     train slice) -> add -> search and search_stats at nprobe 16 / 32 / 64.
     Recall@10 must reach the fixed SQ8_FLOORS and lose at most
     SQ8_MAX_LOSS against phase 3's at the same nprobe (the reference's
     8-bit codec decodes at (code + 0.5) / 256 of the range after encoding
     at code / 255, which loses more than the IVF floors allow at nprobe
     64; see ROADMAP.md, queue 3); the codec's own recall@10 (exact f32
     search over the whole base encoded and decoded) is printed beside
     them. Every search is exactly one K3-SQ8 launch and nothing else; the
     device holds the uint8 codes and no f32 / bf16 copy of the stream.
     Then the same with QT_8BIT_DIRECT, lossless on this integer data: its
     (D, I) must equal phase 3's bit for bit at every nprobe.
  4b. K3-SQ8 vs its plain version (run on the card), on both indexes, at
     1024 queries x nprobe 32 and at the main path's 10k queries x nprobe
     16 / 32 / 64: per-pair outputs bit for bit for QT_8BIT_DIRECT, within
     rtol 1e-5 (positions equal outside near-ties) for QT_8BIT; at 1024
     queries final (D, I) equal, and K3-SQ8, plain and K3 times on the
     same plan, in turns; at 10k queries K3-SQ8, plain and K3 times.
  4c. K3g (scan_invlists_fused_grid) at 1024 queries x nprobe 32 on phase
     3's bf16 index: with grid2d_maxc's bound it equals K3 bit for bit;
     with half of it (ranges cut) the kernels' per-pair outputs and the
     route's (D, I) equal the plain version over the same cut plan, on the
     bf16 stream and on the QT_8BIT codes; times.
  5. flat path on the same data: IndexFlat(128) opted into bf16 search
     (compute_dtype="bfloat16", approx_topk=True, scan_mode "auto") takes
     the fused scan. The exact route (integer data detected: W=2048,
     refine 0) must reach recall@10 0.9969, the refine route
     (exact_kernel=False: W=1024, refine 4) 0.9942; every search is one K1
     and one K2 launch. Then IndexFlatIP on float data (base + uniform
     noise, 1024 noisy queries) through the refine route: recall@10 >= 0.98
     against the exact f32 IndexFlatIP.
  6. K1 and K2 vs their plain torch versions at the flat path's shapes
     (1024 and 10k queries x 1M rows, W=2048 and 1024; k=10 and 40): bit
     for bit on the integer data; kernel and plain times at both batch
     sizes; torch.topk on K2's input as its one-call yardstick.
  7. out-of-core path on the same data: the base written to an np.memmap
     in a temporary directory (removed at the end), the pinned
     host-to-device bandwidth measured alone, IndexIVFFlatPaged(128, 4096,
     <tmp>/index) -> train (10 iterations) -> add(memmap) -> a fresh
     IndexIVFFlatPaged.load -> search / search_stats at nprobe 16 / 32 /
     64, k=10, in three settings: the default window (8192 blocks), 1024-
     block windows, and 1024-block windows over a resident half (the hot
     tier). Recall@10 must reach the IVF floors; (D, I) must equal K3's
     scan over a device copy of the same directory's arrays bit for bit;
     each search launches K4 once per planned call and no K3 / K1 / K2.
  8. K4 vs its plain torch version at the path's shapes (10k queries,
     nprobe 32, the first call of each of the two default windows, the
     second merging into the first's result), and on the same window
     padded from d=96: bit for bit; kernel and plain times.
  9. IVFHNSW path on phase 3's data (the JAX package's bench.py config
     3): IndexIVFHNSW(128, 15625, M=16), efConstruction 40 -> train on the
     train slice (k-means, then the graph over the centroids) -> add -> search
     at nprobe 32 / 64. coarse_mode "auto" (the exact product over the
     centroid table) must reach IVFHNSW_FLOORS, one K3 launch a search;
     "quantizer" (the graph's fused tiles) must return >= 0.99 of the exact
     top-nprobe lists and recall@10 within 0.01 of auto's, with 1 +
     fused_hops K3 launches per 8192-query chunk for the tiles and one for
     the lists. Build split (k-means, graph, add) and QPS are printed.
  10. the graph section of the round-4 probe harness (benchs/r4/r4_queue4.py
     section A): its clustered set (RandomState(11): 1024 centres rand * 10
     plus N(0, 1), 1M base, 10k queries), exact ground truth on the card;
     build_graph_knn(xb, 16, 40) twice (cold and warm), build_tiles_fused in
     the build's coarse order, tile_search_fused at (nprobe0 12, hops 1, F
     4), (12, 2) and (12, 0), scored on the node ids: recall@10 >= 0.97 at
     (12, 1) and hops 2 >= hops 1 > hops 0; 1 + hops K3 launches a search.
     Then IndexHNSWFlat(128, 16) over the same base, searched at efSearch
     16 and 64.
  11. K1p on phase 5's data: flat_knn_fused(merge="packed") over the r5
     harness's grid (W 1024 / R 8192 grid, W 2048 / R 16384 grid, W 1024
     fori unroll 4; sel "kernel", refine 0: recall printed), and the refine
     route (W 1024, refine 4) >= phase 5's refine recall less 0.003; one K1p
     launch a search. K1p against its plain version at 1024 and 10k queries:
     the packed reservoir bit for bit.
  12. the B1 ladder at 10k queries x 1M x W 1024 (R 8192): min1, minall,
     serial (flat_probe_scan) and packed (K1p) on the same inputs, each bit
     for bit against its plain version; times and each kernel's mma count
     in the SASS (cuobjdump), which must be the same for the four folds.
  13. B2, the row-copy issue probe, at NR 4096 / 16384 / 65536 rows of the
     1M x 128 f32 base, NS 16: the slots equal the plain version; ns and SM
     cycles per copy; xb.index_select(0, rows) on the same rows.
The last two lines are the kernels' JSON record (each with its time,
its plain version's, the card's bound for the same work and, where one
torch call computes the same function, that call's time) and
{"ok": true, ...}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

import tpu_ann_torch as T
from tpu_ann_torch import kernels
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import flat_knn_fused as FK
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops import hnsw as HN
from tpu_ann_torch.ops import hnsw_tiles as HT
from tpu_ann_torch.ops import ivf_scan_paged as P
from tpu_ann_torch.ops import row_copy_probe as B2
from tpu_ann_torch.ops import sq as SQ

# recall@10 floors at nprobe 16 / 32 / 64: the JAX package's benchmark
# recalls on this workload (0.8831 / 0.9718 / 0.9978) less 0.01 for
# k-means differences
RECALL_FLOORS = {16: 0.8731, 32: 0.9618, 64: 0.9878}
# IVF4096,SQ8 (QT_8BIT) on IVF-Flat's centroids: recall@10 floors at
# nprobe 16 / 32 / 64, and the most recall@10 it may lose against IVF-Flat
# in the same run. The IVF floors and 0.01 hold at nprobe 16 / 32. At
# nprobe 64 the reference's codec (encode at code / 255 of the range,
# decode at (code + 0.5) / 256) loses more than they allow: the floor is
# the 0.98565 measured there on an H100 less 0.005, and the loss limit its
# measured 0.0122 plus 0.003. Neither is derived from the run.
SQ8_FLOORS = {16: 0.8731, 32: 0.9618, 64: 0.9807}
SQ8_MAX_LOSS = {16: 0.01, 32: 0.01, 64: 0.015}
# flat path recall@10 floors: the exact route, the JAX package's 0.9979 at
# W=2048 (BENCH_r05.json) less 0.001 for the order of ground-truth ties;
# the refine route, its 0.99516 at W=1024 (benchs/logs/r5_queue1.jsonl)
# less about 0.001; IP on float data has no reference value
FLAT_FLOORS = {"exact": 0.9969, "refine": 0.9942, "ip_float": 0.98}
KERNELS = ("ivf_scan_fused", "ivf_scan_sq8", "flat_knn_fused",
           "reservoir_topk", "ivf_scan_paged", "flat_knn_variants",
           "row_copy_probe")
# IVFHNSW15625 (coarse_mode "auto") recall@10 floors at nprobe 32 / 64: the
# JAX package's 0.8754 / 0.9602 (BENCH_r05.json) less 0.01 for k-means
IVFHNSW_FLOORS = {32: 0.8654, 64: 0.9502}
# the round-4 harness's tile search at (nprobe0 12, hops 1, F 4): the JAX
# package's 0.9910 (BENCHMARKS.md, round 2's clustered set, whose generator
# is not recorded) less 0.02
GRAPH_FLOOR = 0.97
# K1p's refine route may lose this much recall@10 against phase 5's (the
# reference lost 0.001: 0.99408 against 0.99508, benchs/logs/r4_queue2 and
# r4_queue4)
PACKED_MAX_LOSS = 0.003
D, NLIST, K = 128, 4096, 10
NB, NT, NQ = 1_000_000, 100_000, 10_000
TIMED_REPS = 3
# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM bytes/s
# and bf16 tensor-core FLOP/s. A kernel's bound is the larger of the bytes
# it must move over the first and the products it must compute over the
# second, both counted from this run's inputs.
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Median wall time of fn() (ending in a device sync), after warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def reset_counts() -> None:
    F.LAUNCHES = 0
    F.LAUNCHES_SQ8 = 0
    P.LAUNCHES = 0
    B2.LAUNCHES = 0
    for name in FK.LAUNCHES:
        FK.LAUNCHES[name] = 0


def counts() -> dict:
    return {"ivf_scan_fused": F.LAUNCHES, "ivf_scan_sq8": F.LAUNCHES_SQ8,
            **FK.LAUNCHES, "ivf_scan_paged": P.LAUNCHES,
            "row_copy_probe": B2.LAUNCHES}


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for the work: bytes over HBM
    bandwidth or bf16 products over the tensor-core peak, the larger."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pair_scan_work(plan, ids, B, d, kp, lo, hi, ta=0, tb=None,
                   running=False, elem_bytes=2):
    """Bytes and bf16 products the per-pair scan of tiles [ta, tb) needs
    over stream blocks [lo, hi): every valid row of a pair's clamped range
    scored against its query, each needed block read once (``elem_bytes``
    a stream element: 2 for bf16, 1 for SQ8 codes, plus 8 B of id and norm
    a row), the queries, the plan and the (pairs, kp) result written once
    (and, ``running``, read once). ``ids`` (nblocks, B) are the blocks
    [lo, hi) of the stream."""
    tb = plan.ntiles if tb is None else tb
    sl = slice(ta * F.PT, tb * F.PT)
    ps = plan.pstart[sl].long().clamp(lo, hi) - lo
    pe = plan.pend[sl].long().clamp(lo, hi) - lo
    csum = torch.zeros(hi - lo + 1, dtype=torch.long, device=ids.device)
    csum[1:] = torch.cumsum((ids[:hi - lo] >= 0).sum(1), 0)
    rows = int((csum[pe] - csum[ps]).sum())
    mark = torch.zeros(hi - lo + 1, dtype=torch.long, device=ids.device)
    mark.index_add_(0, ps, torch.ones_like(ps))
    mark.index_add_(0, pe, -torch.ones_like(pe))
    blocks = int((torch.cumsum(mark, 0) > 0).sum())
    npairs = ps.numel()
    nq = int(plan.pair_q.max()) + 1
    nbytes = (blocks * B * (elem_bytes * d + 8) + nq * (2 * d + 4)
              + npairs * 12
              + npairs * kp * 8 * (2 if running else 1))
    return nbytes, 2.0 * rows * d


def assert_equal(name, a, b) -> None:
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"{name}: kernel differs from the plain version "
                             f"in {int((a != b).sum())} entries")


def max_abs_err(a, b) -> float:
    a, b = a.cpu().numpy(), b.cpu().numpy()
    fin = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def assert_same_topk(D0, I0, D1, I1) -> None:
    """Exact distances; ids equal up to ties (equal distance, any order)."""
    if not np.array_equal(D0, D1):
        raise AssertionError(f"distances differ in "
                             f"{int((D0 != D1).sum())} entries")
    for r in range(len(D0)):
        for v in np.unique(D0[r]):
            m = D0[r] == v
            last = m[-1]              # the tie group at the cut may differ
            if not last and sorted(I0[r][m]) != sorted(I1[r][m]):
                raise AssertionError(f"row {r}: ids differ: {I0[r]} {I1[r]}")


def main() -> None:
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    phase("device", kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load_libraries(KERNELS)
    t_build = time.perf_counter() - t0
    for name in KERNELS:
        ptxas = [ln.strip() for ln in kernels.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", kernel=name, seconds=kernels.BUILD_SECONDS[name],
              ptxas=ptxas)
    phase("build_all", seconds=t_build)

    # -- 3. main path at real size ----------------------------------------
    t0 = time.perf_counter()
    allx = T.sift_surrogate(NB + NT + NQ, seed=123, **T.SIFT1M_CALIBRATED)
    xb, xt, xq = allx[:NB], allx[NB:NB + NT], allx[NB + NT:]
    t_data = time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    flat = T.IndexFlat(D, device="cuda")
    flat.add(xb)
    _, gt = flat.search(xq, K)
    t_gt = time.perf_counter() - t0
    del flat
    if any(counts().values()):
        raise AssertionError(f"the exact ground truth launched kernels: "
                             f"{counts()}")

    reset_counts()
    n_search = 0
    t0 = time.perf_counter()
    index = T.make_ivf_flat(D, NLIST, device="cuda")
    index.cp.niter = 10
    index.train(xt)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    index.add(xb)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    if F.LAUNCHES != 0:
        raise AssertionError("train/add launched the scan kernel")
    phase("build_index", data_s=t_data, ground_truth_s=t_gt,
          train_s=t_train, add_s=t_add,
          imbalance=index.imbalance_factor(),
          kmeans_final_obj=index.clustering_stats[-1].obj)

    results, flat_out = {}, {}
    for nprobe in (16, 32, 64):
        p = T.SearchParametersIVF(nprobe=nprobe)
        before = F.LAUNCHES
        Dv, Iv = index.search(xq, K, params=p)           # warm-up
        times = []
        for _ in range(TIMED_REPS):
            t1 = time.perf_counter()
            Dv, Iv = index.search(xq, K, params=p)      # numpy out: synced
            times.append(time.perf_counter() - t1)
        Ds, Is, st = index.search_stats(xq, K, params=p)
        n_calls = 2 + TIMED_REPS
        n_search += n_calls
        if F.LAUNCHES - before != n_calls:
            raise AssertionError(f"nprobe={nprobe}: {F.LAUNCHES - before} "
                                 f"kernel launches for {n_calls} searches")
        if not (Dv.shape == Iv.shape == (NQ, K) and np.isfinite(Dv).all()
                and (Iv >= 0).all() and (Iv < NB).all()):
            raise AssertionError(f"nprobe={nprobe}: malformed results")
        if not (np.array_equal(Ds, Dv) and np.array_equal(Is, Iv)):
            raise AssertionError("search and search_stats disagree")
        rec = T.recall_k_at_k(Iv, gt, K)
        med = float(np.median(times))
        results[nprobe] = rec
        flat_out[nprobe] = (Dv, Iv)
        phase("search", nprobe=nprobe, recall_at_10=rec,
              floor=RECALL_FLOORS[nprobe], qps=NQ / med,
              search_ms=[t * 1e3 for t in times],
              quantization_ms=st.quantization_us / 1e3,
              list_scan_ms=st.list_scan_us / 1e3, ndis=st.ndis,
              launches=F.LAUNCHES - before)
    main_launches = F.LAUNCHES
    if FK.LAUNCHES["flat_knn_fused"] or FK.LAUNCHES["reservoir_topk"]:
        raise AssertionError(f"the IVF path launched K1 / K2: {counts()}")
    for nprobe, rec in results.items():
        if rec < RECALL_FLOORS[nprobe]:
            raise AssertionError(f"recall@10 {rec} < floor "
                                 f"{RECALL_FLOORS[nprobe]} at nprobe "
                                 f"{nprobe}")
    if main_launches != n_search or main_launches == 0:
        raise AssertionError("the main path did not run the kernel once "
                             "per search")

    # -- 4. kernel vs plain version at the main path's shapes ------------
    il = index.invlists
    xq_s = torch.from_numpy(xq[:1024]).to(dev)
    _, probes = index._coarse_search_device(xq_s, 32)
    plan = F.plan_pairs(probes, il)
    kp = F.default_kp(K)
    qn = TD.l2_norms(xq_s)
    q16 = xq_s.to(torch.bfloat16)

    d1, p1 = F.scan_pairs(q16, qn, plan, il, kp, False)
    d0, p0 = F.scan_pairs_reference(q16, qn, plan, il, kp, False)
    d0, p0, d1, p1 = (t.cpu().numpy() for t in (d0, p0, d1, p1))
    fin = np.isfinite(d0)
    if not (np.array_equal(fin, np.isfinite(d1))
            and np.array_equal(d0, d1) and np.array_equal(p0, p1)):
        raise AssertionError("kernel per-pair top-kp differs from the "
                             "plain version")
    max_abs_err_k3 = float(np.abs(d1[fin] - d0[fin]).max()) if fin.any() \
        else 0.0
    D1, I1, n1 = F.scan_invlists_fused(xq_s, probes, il, K)
    D0, I0, n0 = F.scan_invlists_fused_reference(xq_s, probes, il, K)
    assert_same_topk(D0.cpu().numpy(), I0.cpu().numpy(),
                     D1.cpu().numpy(), I1.cpu().numpy())
    if int(n0) != int(n1):
        raise AssertionError("ndis differs")

    ms = cuda_ms(lambda: F.scan_pairs(q16, qn, plan, il, kp, False), 20)
    plain_ms = host_ms(
        lambda: F.scan_pairs_reference(q16, qn, plan, il, kp, False), 3)
    search_ms = host_ms(lambda: F.scan_invlists_fused(xq_s, probes, il, K),
                        5)

    # IP on float data: the same layout with non-integer rows and queries
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    valid = (il.ids >= 0).unsqueeze(-1)
    data_f = il.data + torch.rand(il.data.shape, generator=g,
                                  device=dev) * valid
    il_f = T.PackedInvLists(
        data=data_f, data_bf16=data_f.to(torch.bfloat16), ids=il.ids,
        norms=(data_f * data_f).sum(-1), list_block_start=il.list_block_start,
        list_nblocks=il.list_nblocks)
    xq_f = xq_s + torch.randn(xq_s.shape, generator=g, device=dev)
    _, I1f, _ = F.scan_invlists_fused(xq_f, probes, il_f, K,
                                      TD.METRIC_INNER_PRODUCT)
    _, I0f, _ = F.scan_invlists_fused_reference(xq_f, probes, il_f, K,
                                                TD.METRIC_INNER_PRODUCT)
    I0f, I1f = I0f.cpu().numpy(), I1f.cpu().numpy()
    overlap = float(np.mean([len(set(a) & set(b)) / K
                             for a, b in zip(I0f, I1f)]))
    if overlap < 0.999:
        raise AssertionError(f"IP float overlap {overlap} < 0.999")
    phase("kernel_check", nq=len(xq_s), nprobe=probes.shape[1], kp=kp,
          npairs=probes.numel(),
          ntiles=plan.ntiles, pairs_equal=True, final_equal=True,
          max_abs_err=max_abs_err_k3, ip_float_overlap=overlap,
          kernel_ms=ms, plain_ms=plain_ms, fused_search_ms=search_ms)

    k3 = {
        "name": "ivf_scan_fused",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_fused.cu",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:60",
        "launches": main_launches,
        "max_abs_err": max_abs_err_k3,
        "ms": ms,
        "plain_ms": plain_ms,
        **bound(*pair_scan_work(plan, il.ids, il.block_size, D, kp, 0,
                                il.nblocks)),
        "library_ms": None,
    }
    del il_f, data_f
    sq_records = sq_phases(index, xt, xb, xq, gt, results, flat_out,
                           xq_s, probes, dev)
    del index, il
    torch.cuda.empty_cache()

    flat_records, flat_index, refine_rec = flat_phases(xb, xq, gt, dev)
    variant_records = variant_phases(flat_index, xb, xq, gt, refine_rec, dev)
    del flat_index
    torch.cuda.empty_cache()
    k4 = paged_phases(xb, xt, xq, gt, dev)
    ivf_hnsw_phase(xb, xt, xq, gt, dev)
    graph_phase(dev)
    b2 = row_copy_phase(xb, dev)
    print(json.dumps({"kernels": [k3, *sq_records, *flat_records,
                                  *variant_records, k4, b2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def assert_close_pairs(name, d0, p0, d1, p1, rtol=1e-5) -> float:
    """Per-pair top-kp outputs agree: the same empty slots, distances within
    rtol of the largest finite one, and positions equal except inside a
    group of near-equal distances (a tie within the tolerance). Returns the
    largest absolute difference."""
    d0, p0, d1, p1 = (t.cpu().numpy() for t in (d0, p0, d1, p1))
    fin = np.isfinite(d0)
    if not np.array_equal(fin, np.isfinite(d1)):
        raise AssertionError(f"{name}: empty slots differ")
    tol = rtol * float(np.abs(d0[fin]).max()) if fin.any() else 0.0
    err = float(np.abs(d1[fin] - d0[fin]).max()) if fin.any() else 0.0
    if err > tol:
        raise AssertionError(f"{name}: distances differ by {err} > {tol}")
    for r in np.nonzero((p0 != p1).any(1))[0]:
        for j in np.nonzero(p0[r] != p1[r])[0]:
            near = np.abs(d0[r] - d0[r, j]) <= tol
            tie_ok = near.sum() > 1 and (
                near[-1] or sorted(p0[r][near]) == sorted(p1[r][near]))
            if not tie_ok:
                raise AssertionError(f"{name}: pair {r} positions differ: "
                                     f"{p0[r]} {p1[r]}")
    return err


def sq_search(idx, xq, gt, name, nprobe, flat_rec, flat_dv_iv,
              lossy) -> dict:
    """Phase 4a for one index and nprobe: a warm-up, TIMED_REPS timed
    searches and one search_stats, each exactly one K3-SQ8 launch. A
    ``lossy`` codec is held to SQ8_FLOORS and SQ8_MAX_LOSS; a lossless one
    must return IVF-Flat's (D, I) instead."""
    p = T.SearchParametersIVF(nprobe=nprobe)
    before = counts()
    Dv, Iv = idx.search(xq, K, params=p)                  # warm-up
    times = []
    for _ in range(TIMED_REPS):
        t1 = time.perf_counter()
        Dv, Iv = idx.search(xq, K, params=p)
        times.append(time.perf_counter() - t1)
    Ds, Is, st = idx.search_stats(xq, K, params=p)
    now = counts()
    launches = {k: now[k] - before[k] for k in now}
    n_calls = 2 + TIMED_REPS
    if launches["ivf_scan_sq8"] != n_calls or \
            sum(launches.values()) != n_calls:
        raise AssertionError(f"{name} nprobe={nprobe}: launches {launches} "
                             f"for {n_calls} searches")
    if not (Dv.shape == Iv.shape == (NQ, K) and np.isfinite(Dv).all()
            and (Iv >= 0).all() and (Iv < NB).all()):
        raise AssertionError(f"{name} nprobe={nprobe}: malformed results")
    if not (np.array_equal(Ds, Dv) and np.array_equal(Is, Iv)):
        raise AssertionError(f"{name}: search and search_stats disagree")
    rec = T.recall_k_at_k(Iv, gt, K)
    med = float(np.median(times))
    equal_flat = bool(np.array_equal(Dv, flat_dv_iv[0])
                      and np.array_equal(Iv, flat_dv_iv[1]))
    floor = SQ8_FLOORS[nprobe] if lossy else None
    max_loss = SQ8_MAX_LOSS[nprobe] if lossy else 0.0
    phase("ivf_sq_search", qtype=name, nprobe=nprobe, recall_at_10=rec,
          ivf_flat_recall=flat_rec, floor=floor, max_loss=max_loss,
          qps=NQ / med, search_ms=[t * 1e3 for t in times],
          quantization_ms=st.quantization_us / 1e3,
          list_scan_ms=st.list_scan_us / 1e3, ndis=st.ndis,
          equal_to_ivf_flat=equal_flat, launches=launches)
    if not lossy:
        if not equal_flat:
            raise AssertionError(f"{name} nprobe={nprobe}: (D, I) differ "
                                 f"from IVF-Flat's")
    elif rec < floor or flat_rec - rec > max_loss:
        raise AssertionError(f"{name} nprobe={nprobe}: recall@10 {rec} "
                             f"below {floor} or more than {max_loss} under "
                             f"IVF-Flat's {flat_rec}")
    return launches


def codec_recall(codec, xb, xq, gt, dev) -> float:
    """recall@10 of exact f32 search over the whole base encoded and
    decoded by ``codec``: the codec's own loss, apart from IVF and from
    K3-SQ8 (the plain blocked k-NN, no kernel)."""
    dec = SQ.sq_decode(SQ.sq_encode(torch.from_numpy(xb).to(dev), codec),
                       codec)
    _, I = TD.knn(torch.from_numpy(xq).to(dev), dec, K)
    return T.recall_k_at_k(I.cpu().numpy(), gt, K)


def device_stream_bytes(idx) -> dict:
    """The IVF-SQ8 index's device tensors: uint8 codes shared by its
    invlists and its SQ8 view, and no f32 / bf16 tensor as large as the
    stream."""
    il, view = idx.invlists, idx._sq8_view()
    if il.codes.dtype != torch.uint8 or \
            view.codes.data_ptr() != il.codes.data_ptr():
        raise AssertionError("the SQ8 view does not scan the packed codes")
    held = {}
    for obj in (il, view):
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if t.is_floating_point() and t.numel() >= il.codes.numel():
                raise AssertionError(f"a {t.dtype} copy of the stream "
                                     f"({f.name}) lives on the device")
            held[t.data_ptr()] = t.numel() * t.element_size()
    return {"code_bytes": il.codes.numel(), "device_bytes": sum(held.values())}


def sq_phases(index, xt, xb, xq, gt, flat_rec, flat_out, xq_s, probes,
              dev) -> list:
    """Phases 4a-4c: the IVF-SQ8 path, K3-SQ8 and K3g; returns their
    records of the kernels line."""
    # -- 4a. IVF-SQ8 path at real size -------------------------------------
    reset_counts()
    sq_idx = {}
    for name, qtype in (("QT_8BIT", T.QT_8BIT),
                        ("QT_8BIT_DIRECT", T.QT_8BIT_DIRECT)):
        before = counts()
        t0 = time.perf_counter()
        idx = T.IndexIVFScalarQuantizer(index.quantizer, D, NLIST, qtype,
                                        device="cuda")
        idx.quantizer_trains_alone = 1
        idx.train(xt)
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.add(xb)
        torch.cuda.synchronize()
        t_add = time.perf_counter() - t0
        if counts() != before:
            raise AssertionError(f"{name}: train/add launched kernels")
        codec_rec = codec_recall(idx.sq, xb, xq, gt, dev)
        for nprobe in (16, 32, 64):
            sq_search(idx, xq, gt, name, nprobe, flat_rec[nprobe],
                      flat_out[nprobe], qtype != T.QT_8BIT_DIRECT)
        phase("ivf_sq", qtype=name, train_s=t_train, add_s=t_add,
              codec_recall_at_10=codec_rec,
              ivf_flat_stream_bytes=index.invlists.data_bf16.numel() * 2,
              **device_stream_bytes(idx))
        sq_idx[name] = idx
    sq_launches = counts()
    if sq_launches["ivf_scan_sq8"] == 0:
        raise AssertionError("the IVF-SQ8 path did not run K3-SQ8")

    # -- 4b. K3-SQ8 vs its plain version ------------------------------------
    il = index.invlists
    kp = F.default_kp(K)
    q16, qn = F.fold_queries(xq_s, il, False)
    plan3 = F.plan_pairs(probes, il)
    sq8_err, sq8_ms = 0.0, {}
    for name, idx in sq_idx.items():
        view = idx._sq8_view()
        plan = F.plan_pairs(probes, view)
        q, qn8 = F.fold_queries(xq_s, view, False)
        d1, p1 = F.scan_pairs(q, qn8, plan, view, kp, False)
        d0, p0 = F.scan_pairs_reference(q, qn8, plan, view, kp, False)
        if name == "QT_8BIT_DIRECT":
            assert_equal("K3-SQ8 direct distances", d0, d1)
            assert_equal("K3-SQ8 direct positions", p0, p1)
        sq8_err = max(sq8_err, assert_close_pairs(f"K3-SQ8 {name}", d0, p0,
                                                  d1, p1))
        D1, I1, _ = F.scan_invlists_fused(xq_s, probes, view, K)
        D0, I0, _ = F.scan_invlists_fused_reference(xq_s, probes, view, K)
        assert_same_topk(D0.cpu().numpy(), I0.cpu().numpy(),
                         D1.cpu().numpy(), I1.cpu().numpy())

        def sq8():
            F.scan_pairs(q, qn8, plan, view, kp, False)

        def k3():
            F.scan_pairs(q16, qn, plan3, il, kp, False)

        a, b, c, e = (cuda_ms(sq8, 20), cuda_ms(k3, 20), cuda_ms(k3, 20),
                      cuda_ms(sq8, 20))
        sq8_ms[name] = {
            "ms": [a, e], "k3_ms": [b, c],
            "plain_ms": host_ms(lambda: F.scan_pairs_reference(
                q, qn8, plan, view, kp, False), 3),
            **bound(*pair_scan_work(plan, view.ids, view.block_size, D, kp,
                                    0, view.nblocks, elem_bytes=1))}
    # the main path's batch, 10k queries: K3-SQ8 against its plain
    # version on both indexes, and K3 on the same plan, alone
    xq_dev = torch.from_numpy(xq).to(dev)
    q3, qn3 = F.fold_queries(xq_dev, il, False)
    ms_10k = {}
    for nprobe in (16, 32, 64):
        _, pr = index._coarse_search_device(xq_dev, nprobe)
        p3 = F.plan_pairs(pr, il)
        row = {"ntiles": p3.ntiles}
        for name, idx in sq_idx.items():
            view = idx._sq8_view()
            p8 = F.plan_pairs(pr, view)
            q, qn8 = F.fold_queries(xq_dev, view, False)
            d1, p1 = F.scan_pairs(q, qn8, p8, view, kp, False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            d0, p0 = F.scan_pairs_reference(q, qn8, p8, view, kp, False)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t1) * 1e3
            where = f"K3-SQ8 {name} nq={NQ} nprobe={nprobe}"
            if name == "QT_8BIT_DIRECT":
                assert_equal(f"{where} distances", d0, d1)
                assert_equal(f"{where} positions", p0, p1)
            sq8_err = max(sq8_err, assert_close_pairs(where, d0, p0, d1, p1))
            del d0, p0, d1, p1
            row[name] = {
                "ms": cuda_ms(lambda: F.scan_pairs(q, qn8, p8, view, kp,
                                                   False), 5),
                "plain_ms": plain}
        row["k3_ms"] = cuda_ms(
            lambda: F.scan_pairs(q3, qn3, p3, il, kp, False), 5)
        ms_10k[nprobe] = row
    phase("sq8_kernel_check", nq=[len(xq_s), NQ], nprobe=probes.shape[1],
          kp=kp, ntiles=plan3.ntiles, direct_equal=True, pairs_equal_10k=True,
          max_abs_err=sq8_err, calls=sq8_ms, calls_10k=ms_10k)

    # -- 4c. K3g: the grid route on a cut plan -------------------------------
    view = sq_idx["QT_8BIT"]._sq8_view()
    full = F.grid2d_maxc(il, probes)
    cut = full // 2
    while cut > 1 and torch.equal(F.truncate_plan(plan3, cut).tile_nb,
                                  plan3.tile_nb):
        cut //= 2
    reset_counts()
    Dg, Ig, _ = F.scan_invlists_fused_grid(xq_s, probes, il, K, maxc=full)
    Dc, Ic, _ = F.scan_invlists_fused_grid(xq_s, probes, il, K, maxc=cut)
    Dcs, Ics, _ = F.scan_invlists_fused_grid(xq_s, probes, view, K,
                                             maxc=cut)
    torch.cuda.synchronize()
    grid_launches = counts()
    if grid_launches["ivf_scan_fused"] != 2 or \
            grid_launches["ivf_scan_sq8"] != 1 or \
            sum(grid_launches.values()) != 3:
        raise AssertionError(f"the K3g route launched {grid_launches}")
    D3, I3, _ = F.scan_invlists_fused(xq_s, probes, il, K)
    assert_equal("K3g uncut distances vs K3", D3, Dg)
    assert_equal("K3g uncut ids vs K3", I3, Ig)
    g_err = 0.0
    for name, lists, q, n, Dk, Ik in (("bf16", il, q16, qn, Dc, Ic),
                                       ("sq8", view,
                                        *F.fold_queries(xq_s, view, False),
                                        Dcs, Ics)):
        cplan = F.truncate_plan(F.plan_pairs(probes, lists), cut)
        d1, p1 = F.scan_pairs(q, n, cplan, lists, kp, False)
        d0, p0 = F.scan_pairs_reference(q, n, cplan, lists, kp, False)
        if name == "bf16":
            assert_equal("K3g cut distances", d0, d1)
            assert_equal("K3g cut positions", p0, p1)
        g_err = max(g_err, assert_close_pairs(f"K3g {name}", d0, p0, d1,
                                              p1))
        D0, I0, _ = F.scan_invlists_fused_reference(xq_s, probes, lists, K,
                                                    maxc=cut)
        assert_same_topk(D0.cpu().numpy(), I0.cpu().numpy(),
                         Dk.cpu().numpy(), Ik.cpu().numpy())
    cplan = F.truncate_plan(plan3, cut)
    g_ms = cuda_ms(lambda: F.scan_pairs(q16, qn, cplan, il, kp, False), 20)
    g_plain = host_ms(lambda: F.scan_pairs_reference(q16, qn, cplan, il, kp,
                                                     False), 3)
    g_route = host_ms(lambda: F.scan_invlists_fused_grid(
        xq_s, probes, il, K, maxc=cut), 5)
    g_bound = bound(*pair_scan_work(cplan, il.ids, il.block_size, D, kp, 0,
                                    il.nblocks))
    phase("k3g_check", nq=len(xq_s), nprobe=probes.shape[1], maxc_full=full,
          maxc_cut=cut, tiles_cut=int((cplan.tile_nb < plan3.tile_nb).sum()),
          uncut_equal_k3=True, max_abs_err=g_err, kernel_ms=g_ms,
          plain_ms=g_plain, route_ms=g_route, launches=grid_launches,
          **g_bound)
    del sq_idx
    torch.cuda.empty_cache()

    rec = sq8_ms["QT_8BIT"]
    return [{
        "name": "ivf_scan_sq8",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_sq8.cu",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:172",
        "launches": sq_launches["ivf_scan_sq8"],
        "max_abs_err": sq8_err,
        "ms": min(rec["ms"]),
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,
    }, {
        "name": "ivf_scan_fused_grid",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_fused.cu, "
                  "tpu_ann_torch/csrc/ivf_scan_sq8.cu",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:542",
        "launches": sum(grid_launches.values()),
        "max_abs_err": g_err,
        "ms": g_ms,
        "plain_ms": g_plain,
        **g_bound,
        "library_ms": None,
    }]


def flat_search(index, xq, gt, name, floor) -> float:
    """Phase 5 for one route: a warm-up and TIMED_REPS timed searches
    (numpy in and out), each exactly one K1 and one K2 launch."""
    before = counts()
    Dv, Iv = index.search(xq, K)                      # warm-up
    times = []
    for _ in range(TIMED_REPS):
        t1 = time.perf_counter()
        Dv, Iv = index.search(xq, K)
        times.append(time.perf_counter() - t1)
    n_calls = 1 + TIMED_REPS
    now = counts()
    for kname in ("flat_knn_fused", "reservoir_topk"):
        if now[kname] - before[kname] != n_calls:
            raise AssertionError(f"{name}: {now[kname] - before[kname]} "
                                 f"{kname} launches for {n_calls} searches")
    if now["ivf_scan_fused"] != before["ivf_scan_fused"]:
        raise AssertionError(f"{name}: the flat path launched K3")
    if not (Dv.shape == Iv.shape == (len(xq), K) and np.isfinite(Dv).all()
            and (Iv >= 0).all() and (Iv < index.ntotal).all()):
        raise AssertionError(f"{name}: malformed results")
    rec = T.recall_k_at_k(Iv, gt, K)
    med = float(np.median(times))
    phase("flat_search", route=name, recall_at_10=rec, floor=floor,
          qps=len(xq) / med, search_ms=[t * 1e3 for t in times],
          launches={k: now[k] - before[k] for k in now})
    if rec < floor:
        raise AssertionError(f"{name}: recall@10 {rec} < floor {floor}")
    return rec


def flat_phases(xb, xq, gt, dev):
    """Phases 5 and 6: the fused flat path and its kernels; returns the
    K1 and K2 records of the kernels line, the opted-in IndexFlat and its
    refine route's recall@10."""
    # -- 5. flat path at real size ----------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    index = T.IndexFlat(D, device="cuda")
    index.add(xb)
    index.compute_dtype, index.approx_topk = "bfloat16", True
    xq_dev = torch.from_numpy(xq).to(dev)
    if not (index.scan_mode == "auto" and index._use_fused(K)):
        raise AssertionError("the opted-in IndexFlat does not take the "
                             "fused path")
    flat_search(index, xq, gt, "exact", FLAT_FLOORS["exact"])
    if index._db_int_max is None or not index._use_exact_kernel(xq_dev):
        raise AssertionError("the integer-exact route was not chosen")
    index.exact_kernel = False
    refine_rec = flat_search(index, xq, gt, "refine", FLAT_FLOORS["refine"])
    index.exact_kernel = None
    flat_launches = counts()
    t_flat = time.perf_counter() - t0

    # IP on float data: base rows + uniform noise in [0, 1)
    rng = np.random.default_rng(7)
    xb_f = xb + rng.random(xb.shape, dtype=np.float32)
    xq_f = xq[:1024] + rng.random(xq[:1024].shape, dtype=np.float32)
    exact_ip = T.IndexFlatIP(D, device="cuda")
    exact_ip.add(xb_f)
    _, gt_ip = exact_ip.search(xq_f, K)
    del exact_ip
    ip = T.IndexFlatIP(D, device="cuda")
    ip.add(xb_f)
    ip.compute_dtype, ip.approx_topk = "bfloat16", True
    flat_search(ip, xq_f, gt_ip, "ip_float", FLAT_FLOORS["ip_float"])
    del ip, xb_f
    torch.cuda.empty_cache()
    phase("flat_path", seconds=t_flat, launches=flat_launches)

    # -- 6. K1 and K2 vs their plain versions -----------------------------
    data, bias = index._fused_packed
    q = torch.from_numpy(xq[:1024]).to(dev)
    qv = torch.zeros((len(q), data.shape[-1]), device=dev)
    qv[:, :D] = -2.0 * q
    qv = qv.to(torch.bfloat16)
    qv_10k = torch.zeros((NQ, data.shape[-1]), device=dev)
    qv_10k[:, :D] = -2.0 * xq_dev
    qv_10k = qv_10k.to(torch.bfloat16)
    k1_err = k2_err = 0.0
    k1, k2 = {}, {}
    k2_library_ms = None
    for W in (2048, 1024):
        v1, p1 = FK.flat_reservoir(qv, data, bias, W)
        v0, p0 = FK.flat_reservoir_reference(qv, data, bias, W)
        assert_equal(f"K1 values W={W}", v0, v1)
        assert_equal(f"K1 positions W={W}", p0, p1)
        # the main path's batch: 10k queries, so a partial last block of 16
        rv10, rp10 = FK.flat_reservoir(qv_10k, data, bias, W)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rv0, rp0 = FK.flat_reservoir_reference(qv_10k, data, bias, W)
        torch.cuda.synchronize()
        plain_10k = (time.perf_counter() - t1) * 1e3
        assert_equal(f"K1 values W={W} nq={NQ}", rv0, rv10)
        assert_equal(f"K1 positions W={W} nq={NQ}", rp0, rp10)
        k1_err = max(k1_err, max_abs_err(v0, v1), max_abs_err(rv0, rv10))
        del rv0, rp0
        k1[W] = {
            "ms": cuda_ms(lambda: FK.flat_reservoir(qv, data, bias, W), 5),
            "plain_ms": host_ms(
                lambda: FK.flat_reservoir_reference(qv, data, bias, W), 2),
            "ms_10k": cuda_ms(
                lambda: FK.flat_reservoir(qv_10k, data, bias, W), 3),
            "plain_ms_10k": plain_10k}
        for k in (10, 40):
            for name, (rv, rp) in (("1024", (v1, p1)),
                                   (str(NQ), (rv10, rp10))):
                o1 = FK.reservoir_topk(rv, rp, k)
                o0 = FK.reservoir_topk_reference(rv, rp, k)
                assert_equal(f"K2 values W={W} k={k} nq={name}", o0[0], o1[0])
                assert_equal(f"K2 positions W={W} k={k} nq={name}", o0[1],
                             o1[1])
                k2_err = max(k2_err, max_abs_err(o0[0], o1[0]))
            k2[(W, k)] = {
                "ms": cuda_ms(lambda: FK.reservoir_topk(v1, p1, k), 20),
                "plain_ms": host_ms(
                    lambda: FK.reservoir_topk_reference(v1, p1, k), 5),
                "ms_10k": cuda_ms(lambda: FK.reservoir_topk(rv10, rp10, k),
                                  20),
                "plain_ms_10k": host_ms(
                    lambda: FK.reservoir_topk_reference(rv10, rp10, k), 5)}
            if (W, k) == (2048, 10):
                # one torch call selecting the same k smallest of the row
                k2_library_ms = cuda_ms(
                    lambda: torch.topk(v1, k, dim=1, largest=False), 20)
        if W == 2048:
            k1_bound = bound(data.numel() * 2 + bias.numel() * 4
                             + qv.numel() * 2 + v1.numel() * 8,
                             2.0 * len(q) * index.ntotal * D)
            k2_bound = bound(v1.numel() * 8 + len(q) * 10 * 8, 0.0)
        del rv10, rp10
    phase("flat_kernel_check", nq=[len(q), NQ], nb=index.ntotal,
          k1_equal=True, k2_equal=True,
          k1={str(W): t for W, t in k1.items()},
          k2={f"W{W}_k{k}": t for (W, k), t in k2.items()},
          k2_torch_topk_ms=k2_library_ms)

    return [{
        "name": "flat_knn_fused",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/flat_knn_fused.cu",
        "replaces": "tpu_ann/ops/flat_knn_pallas.py:472",
        "launches": flat_launches["flat_knn_fused"],
        "max_abs_err": k1_err,
        "ms": k1[2048]["ms"],
        "plain_ms": k1[2048]["plain_ms"],
        **k1_bound,
        "library_ms": None,
    }, {
        "name": "reservoir_topk",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/reservoir_topk.cu",
        "replaces": "tpu_ann/ops/flat_knn_pallas.py:283",
        "launches": flat_launches["reservoir_topk"],
        "max_abs_err": k2_err,
        "ms": k2[(2048, 10)]["ms"],
        "plain_ms": k2[(2048, 10)]["plain_ms"],
        **k2_bound,
        "library_ms": k2_library_ms,
    }], index, refine_rec


def pinned_gbps(dev, nbytes: int = 1 << 28) -> float:
    """Host-to-device bandwidth of one pinned buffer, alone (GB/s)."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 5)
    return nbytes / ms / 1e6


# (name, window_blocks, the first half of the stream resident on the
# device): the default window, many windows with straddling tiles, and
# the hot tier
PAGED_SETTINGS = (("default", 8192, False), ("w1024", 1024, False),
                  ("hot_half", 1024, True))


def paged_search(idx, xq, gt, setting, nprobe):
    """Phase 7 for one setting and nprobe: a warm-up, TIMED_REPS timed
    searches (numpy in and out) and one search_stats; each search is
    stats["calls"] K4 launches and nothing else."""
    p = T.SearchParametersIVF(nprobe=nprobe)
    before = counts()
    Dv, Iv = idx.search(xq, K, params=p)                  # warm-up
    times = []
    for _ in range(TIMED_REPS):
        t1 = time.perf_counter()
        Dv, Iv = idx.search(xq, K, params=p)
        times.append(time.perf_counter() - t1)
    Ds, Is, st = idx.search_stats(xq, K, params=p)
    now = counts()
    n_calls = 2 + TIMED_REPS
    ex = st.extra
    k4 = now["ivf_scan_paged"] - before["ivf_scan_paged"]
    if k4 != n_calls * ex["calls"]:
        raise AssertionError(f"{setting} nprobe={nprobe}: {k4} K4 launches "
                             f"for {n_calls} searches of {ex['calls']} "
                             f"calls")
    others = {k: now[k] - before[k] for k in now if k != "ivf_scan_paged"}
    if any(others.values()):
        raise AssertionError(f"{setting}: the paged path launched {others}")
    if not (Dv.shape == Iv.shape == (NQ, K) and np.isfinite(Dv).all()
            and (Iv >= 0).all() and (Iv < NB).all()):
        raise AssertionError(f"{setting} nprobe={nprobe}: malformed results")
    if not (np.array_equal(Ds, Dv) and np.array_equal(Is, Iv)):
        raise AssertionError("search and search_stats disagree")
    rec = T.recall_k_at_k(Iv, gt, K)
    med = float(np.median(times))
    phase("paged_search", setting=setting, nprobe=nprobe, recall_at_10=rec,
          floor=RECALL_FLOORS[nprobe], qps=NQ / med,
          search_ms=[t * 1e3 for t in times],
          coarse_ms=st.quantization_us / 1e3,
          list_scan_ms=st.list_scan_us / 1e3,
          windows_ms=ex["windows_ms"], stage_ms=ex["stage_ms"],
          upload_ms=ex["upload_ms"], gather_ms=ex["gather_ms"],
          rerank_ms=ex["rerank_ms"], windows=ex["windows"],
          calls=ex["calls"], windows_resident=ex["windows_resident"],
          bytes_uploaded=ex["bytes_uploaded"],
          upload_gbps=(ex["bytes_uploaded"] / ex["upload_ms"] / 1e6
                       if ex["upload_ms"] else None),
          launches=k4)
    if rec < RECALL_FLOORS[nprobe]:
        raise AssertionError(f"{setting}: recall@10 {rec} < floor "
                             f"{RECALL_FLOORS[nprobe]} at nprobe {nprobe}")
    return Dv, Iv, ex


def paged_phases(xb, xt, xq, gt, dev) -> dict:
    """Phases 7 and 8: the out-of-core path and K4; returns K4's record
    of the kernels line. The index lives in a temporary directory that is
    removed at the end."""
    tmp = tempfile.mkdtemp(prefix="tpu_ann_paged_")
    try:
        return _paged_phases(xb, xt, xq, gt, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _paged_phases(xb, xt, xq, gt, dev, tmp) -> dict:
    # -- 7. out-of-core path at real size ---------------------------------
    link_gbps = pinned_gbps(dev)
    t0 = time.perf_counter()
    xb_mm = np.memmap(os.path.join(tmp, "xb.f32"), mode="w+",
                      dtype=np.float32, shape=xb.shape)
    xb_mm[:] = xb
    xb_mm.flush()
    path = os.path.join(tmp, "index")
    t_write = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    build = T.IndexIVFFlatPaged(D, NLIST, path)
    build.train(xt)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    build.add(xb_mm)
    t_add = time.perf_counter() - t0
    del build, xb_mm
    if any(counts().values()):
        raise AssertionError(f"the paged build launched kernels: {counts()}")
    idx = T.IndexIVFFlatPaged.load(path)
    pil = idx.invlists
    phase("paged_build", memmap_write_s=t_write, train_s=t_train,
          add_s=t_add, nblocks=pil.nblocks, dp=pil.dp,
          stream_bytes=pil.nbytes_stream(), pinned_link_gbps=link_gbps)

    results = {}
    reset_counts()
    for setting, window, hot in PAGED_SETTINGS:
        idx.window_blocks = window
        idx.resident_blocks = pil.nblocks // 2 if hot else 0
        idx._resident = None
        for nprobe in (16, 32, 64):
            results[setting, nprobe] = paged_search(idx, xq, gt, setting,
                                                    nprobe)
        ex = results[setting, 64][2]
        if setting != "default" and ex["windows"] < 2:
            raise AssertionError(f"{setting}: {ex['windows']} windows")
        if setting == "hot_half" and ex["windows_resident"] < 1:
            raise AssertionError("the hot tier served no window")
    paged_launches = counts()
    if paged_launches["ivf_scan_paged"] == 0:
        raise AssertionError("the paged path did not run K4")
    idx.resident_blocks, idx._resident = 0, None
    torch.cuda.empty_cache()

    # K3 over a device copy of the same directory's arrays, same probes
    il = T.PackedInvLists.from_arrays(pil.data_f32, pil.ids, pil.norms,
                                      pil.list_block_start, pil.list_nblocks,
                                      device=dev)
    xq_dev = torch.from_numpy(xq).to(dev)
    for nprobe in (16, 32, 64):
        _, probes = TD.knn(xq_dev, idx._cent_dev, nprobe)
        D3, I3, _ = F.scan_invlists_fused(xq_dev, probes, il, K)
        D3, I3 = D3.cpu().numpy(), I3.cpu().numpy()
        for setting, _, _ in PAGED_SETTINGS:
            Dp, Ip, _ = results[setting, nprobe]
            if not (np.array_equal(Dp, D3) and np.array_equal(Ip, I3)):
                raise AssertionError(
                    f"{setting} nprobe={nprobe}: paged (D, I) differ from "
                    f"K3's in {int((Dp != D3).sum())} / "
                    f"{int((Ip != I3).sum())} entries")
    del il
    torch.cuda.empty_cache()
    phase("paged_path", launches=paged_launches, equal_to_k3=True)

    # -- 8. K4 vs its plain version at the path's shapes -------------------
    _, probes = TD.knn(xq_dev, idx._cent_dev, 32)
    plan = F.plan_pairs(probes, pil)
    kp = F.default_kp(K)
    qn = TD.l2_norms(xq_dev)
    q16 = xq_dev.to(torch.bfloat16)
    tbs = plan.tile_bs.long().cpu().numpy()
    tbe = tbs + plan.tile_nb.long().cpu().numpy()
    W = PAGED_SETTINGS[0][1]
    entries = list(P._plan_windows(tbs, tbe, W, idx.tile_batch))
    firsts = [e for i, e in enumerate(entries)
              if i == 0 or e[0] != entries[i - 1][0]]
    if len(firsts) < 2:
        raise AssertionError("phase 8 needs two windows")
    rd = torch.full((plan.ntiles * F.PT, kp), float("inf"), device=dev)
    rp = torch.full(rd.shape, -1, dtype=torch.int32, device=dev)
    k4_err, checks = 0.0, []
    for w0, ta, tb in firsts[:2]:
        win = P.window_of(pil, w0, min(W, pil.nblocks - w0), dev)
        d96 = P.Window(win.data_bf16.clone(), win.ids, None)
        d96.data_bf16[..., 96:] = 0
        d96.norms = (d96.data_bf16.float() ** 2).sum(-1)
        q96 = q16.clone()
        q96[:, 96:] = 0
        qn96 = (q96.float() ** 2).sum(1)
        for name, w, q, n in (("d128", win, q16, qn), ("d96", d96, q96,
                                                        qn96)):
            r1 = (rd.clone(), rp.clone())
            r0 = (rd.clone(), rp.clone())
            P.scan_window(q, n, plan, w, w0, ta, tb, *r1, False)
            P.scan_window_reference(q, n, plan, w, w0, ta, tb, *r0, False)
            assert_equal(f"K4 {name} w0={w0} distances", r0[0], r1[0])
            assert_equal(f"K4 {name} w0={w0} positions", r0[1], r1[1])
            k4_err = max(k4_err, max_abs_err(r0[0], r1[0]))
            if name == "d128":
                nxt = r1
                run = (rd.clone(), rp.clone())

                def reset_run():
                    run[0].copy_(rd)
                    run[1].copy_(rp)

                def call():
                    reset_run()
                    P.scan_window(q, n, plan, w, w0, ta, tb, *run, False)

                def plain():
                    reset_run()
                    P.scan_window_reference(q, n, plan, w, w0, ta, tb,
                                            *run, False)

                copy_ms = cuda_ms(reset_run, 20)
                checks.append({
                    "w0": w0, "tiles": [ta, tb], "nblocks": w.nblocks,
                    "ms": cuda_ms(call, 10) - copy_ms,
                    "plain_ms": host_ms(plain, 2) - copy_ms,
                    **bound(*pair_scan_work(plan, w.ids, w.block_size, D,
                                            kp, w0, w0 + w.nblocks, ta, tb,
                                            running=True))})
        rd, rp = nxt
        del win, d96
    phase("paged_kernel_check", nq=NQ, nprobe=32, kp=kp, ntiles=plan.ntiles,
          equal=True, d96_equal=True, max_abs_err=k4_err, calls=checks)
    first = checks[0]
    return {
        "name": "ivf_scan_paged",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_paged.cu",
        "replaces": "tpu_ann/ops/ivf_scan_paged.py:339",
        "launches": paged_launches["ivf_scan_paged"],
        "max_abs_err": k4_err,
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "library_ms": None,
    }


# -- phases 9-13: the HNSW graph path, K1p, the B1 ladder and B2 -------------

def sass_mma_counts(name: str) -> dict:
    """Tensor-core mma instructions (HMMA) per kernel in the SASS of the
    built library ``name`` (cuobjdump from nvcc's directory)."""
    tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", kernels.library_path(name)],
                         capture_output=True, text=True, check=True).stdout
    found, fn = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            found[fn] = 0
        elif fn is not None and "HMMA" in ln:
            found[fn] += 1
    return found


def device_profile(fn, top: int = 4) -> dict:
    """One call of fn under torch.profiler: its wall time (profiler on),
    the device time summed over the device's own events (kernels and
    copies; the host-side operator entries that launched them are left
    out, so nothing is counted twice), the busy share (busy / wall, one
    stream) and the device events that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    # None where the profiler saw no device event: "not measured"
    busy = sum(e.self_device_time_total for e in ev) / 1e3 if ev else None
    ev.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "busy_share": busy / wall if ev else None,
            "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                    for e in ev[:top]]}


def variant_phases(index, xb, xq, gt, refine_rec, dev) -> list:
    """Phases 11 and 12: K1p through flat_knn_fused(merge="packed") and the
    B1 probe ladder, on phase 5's IndexFlat and data; returns their records
    of the kernels line."""
    # -- 11. K1p on the r5 harness's grid ---------------------------------
    xb_dev = index.vectors
    xq_dev = torch.from_numpy(xq).to(dev)
    packs = {(8192, 1): index._fused_packed}
    grid = (("grid_W1024", dict(R=8192, W=1024, schedule="grid")),
            ("grid_W2048", dict(R=16384, W=2048, schedule="grid")),
            ("fori_U4", dict(R=8192, W=1024, schedule="fori", unroll=4)))
    reset_counts()
    n_calls, rows = 0, {}
    for name, kw in grid + (("refine4", dict(R=8192, W=1024,
                                             schedule="grid", refine=4)),):
        key = (kw["R"], kw.get("unroll", 1))
        if key not in packs:
            packs[key] = FK.pack_flat_db(xb_dev, TD.METRIC_L2, R=kw["R"],
                                         unroll=key[1])
        kw = {"refine": 0, **kw}

        def call():
            return FK.flat_knn_fused(xq_dev, xb_dev, K, TD.METRIC_L2,
                                     packed=packs[key], merge="packed",
                                     sel="kernel", Q=512, **kw)
        Dv, Iv = call()
        ms = host_ms(call, TIMED_REPS)
        n_calls += 2 + TIMED_REPS
        Iv = Iv.cpu().numpy()
        if not (Iv.shape == (NQ, K) and (Iv >= 0).all()
                and torch.isfinite(Dv).all()):
            raise AssertionError(f"K1p {name}: malformed results")
        rows[name] = {"recall_at_10": T.recall_k_at_k(Iv, gt, K),
                      "ms": ms, "qps": NQ / ms * 1e3}
    packed_launches = counts()
    if packed_launches["flat_knn_packed"] != n_calls or \
            packed_launches["flat_knn_fused"]:
        raise AssertionError(f"the packed searches launched "
                             f"{packed_launches} for {n_calls} searches")
    floor = refine_rec - PACKED_MAX_LOSS
    phase("packed_search", searches=rows, refine_floor=floor,
          phase5_refine_recall=refine_rec, launches=packed_launches)
    if rows["refine4"]["recall_at_10"] < floor:
        raise AssertionError(f"K1p refine route recall@10 "
                             f"{rows['refine4']['recall_at_10']} < {floor}")

    # K1p against its plain version, 1024 and 10k queries (W 1024, R 8192)
    data, bias = index._fused_packed
    C = FK.packed_shift(xq_dev, xb_dev, False)
    shifted = (bias + C).contiguous()
    qv = torch.zeros((NQ, data.shape[-1]), device=dev)
    qv[:, :D] = -2.0 * xq_dev
    qv = qv.to(torch.bfloat16)
    W = 1024
    k1p_err = 0.0
    for nq in (1024, NQ):
        a1 = FK.flat_reservoir_packed(qv[:nq], data, shifted, W)
        a0 = FK.flat_reservoir_packed_reference(qv[:nq], data, shifted, W)
        assert_equal(f"K1p nq={nq}", a0, a1)
        v1, _ = FK.decode_packed(a1, W, C)
        v0, _ = FK.decode_packed(a0, W, C)
        k1p_err = max(k1p_err, max_abs_err(v0, v1))
        del a0, a1

    # -- 12. the B1 ladder on the same inputs ------------------------------
    reset_counts()
    ladder = {}
    for fold in FK.PROBE_FOLDS:
        ladder[fold] = {"ms": cuda_ms(lambda: FK.flat_probe_scan(
            qv, data, bias, W, fold), 3)}
    ladder["packed"] = {"ms": cuda_ms(lambda: FK.flat_reservoir_packed(
        qv, data, shifted, W), 3)}
    ladder_launches = counts()
    for fold in FK.PROBE_FOLDS:
        if ladder_launches["flat_probe_" + fold] != 4:
            raise AssertionError(f"B1 {fold}: {ladder_launches}")
    for fold in FK.PROBE_FOLDS:
        v1, p1 = FK.flat_probe_scan(qv, data, bias, W, fold)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v0, p0 = FK.flat_probe_scan_reference(qv, data, bias, W, fold)
        torch.cuda.synchronize()
        ladder[fold]["plain_ms"] = (time.perf_counter() - t1) * 1e3
        assert_equal(f"B1 {fold} values", v0, v1)
        assert_equal(f"B1 {fold} positions", p0, p1)
        ladder[fold]["max_abs_err"] = max_abs_err(v0, v1)
        del v0, p0, v1, p1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    FK.flat_reservoir_packed_reference(qv, data, shifted, W)
    torch.cuda.synchronize()
    ladder["packed"]["plain_ms"] = (time.perf_counter() - t1) * 1e3
    mma = {**sass_mma_counts("flat_knn_variants"),
           **sass_mma_counts("flat_knn_fused")}
    names = {"min1": "FoldMinILb0", "minall": "FoldMinILb1",
             "serial": "FoldSerial", "packed": "flat_knn_packed_kernel",
             "k1": "flat_knn_fused_kernel"}
    hmma = {k: [v for f, v in mma.items() if tag in f] for k, tag in
            names.items()}
    if any(len(v) != 1 for v in hmma.values()) or \
            len({v[0] for v in hmma.values()}) != 1 or \
            hmma["k1"][0] == 0:
        raise AssertionError(f"the folds' mma counts differ: {mma}")
    k1_ms = ladder["serial"]["ms"]
    phase("b1_ladder", nq=NQ, nb=index.ntotal, W=W, R=data.shape[1],
          folds=ladder, hmma={k: v[0] for k, v in hmma.items()},
          products_share_of_serial=ladder["min1"]["ms"] / k1_ms,
          fold_share_of_serial=1.0 - ladder["min1"]["ms"] / k1_ms,
          launches=ladder_launches)
    work = bound(data.numel() * 2 + bias.numel() * 4 + qv.numel() * 2
                 + NQ * W * 8, 2.0 * NQ * index.ntotal * D)
    records = [{
        "name": "flat_knn_packed",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/flat_knn_variants.cu",
        "replaces": "tpu_ann/ops/flat_knn_pallas.py:704",
        "launches": packed_launches["flat_knn_packed"],
        "max_abs_err": k1p_err,
        "ms": ladder["packed"]["ms"],
        "plain_ms": ladder["packed"]["plain_ms"],
        **work,
        "library_ms": None,
    }]
    for fold in FK.PROBE_FOLDS:
        records.append({
            "name": "flat_probe_scan_" + fold,
            "route": "cuda",
            "source": "tpu_ann_torch/csrc/flat_knn_variants.cu",
            "replaces": "benchs/r4/r4_queue4.py:157",
            "launches": ladder_launches["flat_probe_" + fold],
            "max_abs_err": ladder[fold]["max_abs_err"],
            "ms": ladder[fold]["ms"],
            "plain_ms": ladder[fold]["plain_ms"],
            **work,
            "library_ms": None,
        })
    del packs
    return records


def ivf_hnsw_search(idx, xq_dev, xq, gt, nprobe, mode, n_chunks) -> dict:
    """One nprobe of phase 9: a warm-up and TIMED_REPS timed searches, the
    launches checked against the mode's count."""
    idx.coarse_mode = mode
    p = T.SearchParametersIVF(nprobe=nprobe)
    hops = idx.quantizer.hnsw.fused_hops
    per = 1 if mode == "auto" else n_chunks * (1 + hops) + 1
    before = counts()
    Dv, Iv = idx.search(xq, K, params=p)
    times = []
    for _ in range(TIMED_REPS):
        t1 = time.perf_counter()
        Dv, Iv = idx.search(xq, K, params=p)
        times.append(time.perf_counter() - t1)
    now = counts()
    launches = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    if launches != {"ivf_scan_fused": per * (1 + TIMED_REPS)}:
        raise AssertionError(f"IVFHNSW {mode} nprobe={nprobe}: launches "
                             f"{launches}, want {per} a search")
    if not (Dv.shape == Iv.shape == (NQ, K) and np.isfinite(Dv).all()
            and (Iv >= 0).all() and (Iv < NB).all()):
        raise AssertionError(f"IVFHNSW {mode} nprobe={nprobe}: malformed")
    med = float(np.median(times))
    return {"recall_at_10": T.recall_k_at_k(Iv, gt, K), "qps": NQ / med,
            "search_ms": [t * 1e3 for t in times],
            "launches_per_search": per}


def ivf_hnsw_phase(xb, xt, xq, gt, dev) -> None:
    """Phase 9: the namesake IVFHNSW at the JAX package's bench config 3."""
    reset_counts()
    t0 = time.perf_counter()
    idx = T.IndexIVFHNSW(D, 15625, M=16, device="cuda")
    idx.set_hnsw_parameters(efConstruction=40)
    idx.train(xt)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.add(xb)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"IVFHNSW train/add launched {counts()}")
    t_graph = idx.quantizer.build_seconds["graph"]
    xq_dev = torch.from_numpy(xq).to(dev)
    n_chunks = -(-NQ // idx.quantizer.search_chunk)
    out = {}
    for nprobe in (32, 64):
        auto = ivf_hnsw_search(idx, xq_dev, xq, gt, nprobe, "auto", n_chunks)
        quant = ivf_hnsw_search(idx, xq_dev, xq, gt, nprobe, "quantizer",
                                n_chunks)
        idx.coarse_mode = "quantizer"
        _, hp = idx._coarse_search_device(xq_dev, nprobe)
        idx.coarse_mode = "auto"
        _, ep = idx._coarse_search_device(xq_dev, nprobe)
        hp, ep = hp.cpu().numpy(), ep.cpu().numpy()
        fid = float(np.mean([len(set(a) & set(b)) / nprobe
                             for a, b in zip(hp, ep)]))
        out[nprobe] = {"auto": auto, "quantizer": quant, "fidelity": fid}
        phase("ivf_hnsw_search", nprobe=nprobe, floor=IVFHNSW_FLOORS[nprobe],
              auto=auto, quantizer=quant, quantizer_fidelity=fid)
    profiles = {}
    for mode in ("auto", "quantizer"):
        idx.coarse_mode = mode
        profiles[mode] = device_profile(lambda: idx.search(
            xq, K, params=T.SearchParametersIVF(nprobe=64)))
    idx.coarse_mode = "auto"
    phase("ivf_hnsw_profile", nprobe=64, **profiles)
    phase("ivf_hnsw", nlist=15625, M=16, train_s=t_train,
          kmeans_s=t_train - t_graph, graph_s=t_graph,
          tiles_s=idx.quantizer.build_seconds.get("tiles"), add_s=t_add,
          launches=counts())
    for nprobe, r in out.items():
        a, q = r["auto"]["recall_at_10"], r["quantizer"]["recall_at_10"]
        if a < IVFHNSW_FLOORS[nprobe] or r["fidelity"] < 0.99 or \
                abs(q - a) > 0.01:
            raise AssertionError(f"IVFHNSW nprobe={nprobe}: auto {a} (floor "
                                 f"{IVFHNSW_FLOORS[nprobe]}), quantizer {q}, "
                                 f"fidelity {r['fidelity']}")
    del idx
    torch.cuda.empty_cache()


def graph_phase(dev) -> None:
    """Phase 10: the round-4 harness's graph section on its own data."""
    rs = np.random.RandomState(11)
    cents = rs.rand(1024, D).astype(np.float32) * 10

    def draw(n):
        return cents[rs.randint(1024, size=n)] + \
            rs.randn(n, D).astype(np.float32)

    xb = draw(NB)
    xq = draw(NQ)
    xb_dev = torch.from_numpy(xb).to(dev)
    xq_dev = torch.from_numpy(xq).to(dev)
    _, gt = TD.knn(xq_dev, xb_dev, K)
    gt = gt.cpu().numpy()
    reset_counts()
    builds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph, assign = HN.build_graph_knn(xb_dev, 16, 40)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    if any(counts().values()):
        raise AssertionError(f"the graph build launched {counts()}")
    t0 = time.perf_counter()
    order = np.argsort(assign, kind="stable")
    ftg = HT.build_tiles_fused(xb, graph.neighbors0, order=order)
    t_tiles = time.perf_counter() - t0
    deg = (graph.neighbors0 >= 0).sum(1).float().mean().item()
    rows = {}
    for hops in (1, 2, 0):
        def call():
            return HT.tile_search_fused(ftg, xq_dev, K, nprobe0=12, hops=hops,
                                        F=4)
        before = counts()
        ms = host_ms(call, TIMED_REPS)
        launches = counts()["ivf_scan_fused"] - before["ivf_scan_fused"]
        if launches != (1 + TIMED_REPS) * (1 + hops):
            raise AssertionError(f"tile search hops={hops}: {launches} K3 "
                                 f"launches")
        _, _, I = call()
        I = I.cpu().numpy()
        if not (I.shape == (NQ, K) and (I >= 0).all() and (I < NB).all()):
            raise AssertionError(f"tile search hops={hops}: malformed")
        rows[hops] = {"recall_at_10": T.recall_k_at_k(I, gt, K), "ms": ms,
                      "qps": NQ / ms * 1e3, "k3_launches_per_search": 1 + hops,
                      "profile": device_profile(call)}
    phase("graph_build", n=NB, M=16, efConstruction=40, build_s=builds,
          tiles_s=t_tiles, mean_level0_degree=deg,
          max_level=graph.max_level)
    phase("tile_search", nprobe0=12, F=4, floor=GRAPH_FLOOR,
          hops={str(h): r for h, r in rows.items()})
    r0, r1, r2 = (rows[h]["recall_at_10"] for h in (0, 1, 2))
    if r1 < GRAPH_FLOOR or not r2 >= r1 > r0:
        raise AssertionError(f"tile search recall@10 hops 0/1/2: {r0} / "
                             f"{r1} / {r2} (floor {GRAPH_FLOOR})")
    del ftg, graph
    torch.cuda.empty_cache()

    # IndexHNSWFlat over the same base: build, then search
    reset_counts()
    t0 = time.perf_counter()
    idx = T.IndexHNSWFlat(D, 16, device="cuda")
    idx.add(xb)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    hrows = {}
    for ef in (16, 64):
        p = T.SearchParametersHNSW(efSearch=ef)
        idx.search(xq, K, params=p)
        times = []
        for _ in range(TIMED_REPS):
            t1 = time.perf_counter()
            Dv, Iv = idx.search(xq, K, params=p)
            times.append(time.perf_counter() - t1)
        if not (Iv.shape == (NQ, K) and (Iv >= 0).all()
                and np.isfinite(Dv).all()):
            raise AssertionError(f"IndexHNSWFlat ef={ef}: malformed")
        med = float(np.median(times))
        hrows[ef] = {"recall_at_10": T.recall_k_at_k(Iv, gt, K),
                     "qps": NQ / med, "search_ms": [t * 1e3 for t in times]}
    launches = counts()
    want = 2 * (1 + TIMED_REPS) * -(-NQ // idx.search_chunk) * \
        (1 + idx.hnsw.fused_hops)
    if launches["ivf_scan_fused"] != want or \
            sum(launches.values()) != want:
        raise AssertionError(f"IndexHNSWFlat: launches {launches}, want "
                             f"{want} K3")
    phase("hnsw_flat", add_s=t_add, build_seconds=idx.build_seconds,
          searches={str(ef): r for ef, r in hrows.items()},
          launches=launches)
    if hrows[64]["recall_at_10"] < hrows[16]["recall_at_10"]:
        raise AssertionError("IndexHNSWFlat: efSearch 64 below 16")
    del idx, xb_dev
    torch.cuda.empty_cache()


def row_copy_phase(xb, dev) -> dict:
    """Phase 13: B2 on the 1M x 128 f32 base; returns its record."""
    xb_dev = torch.from_numpy(xb).to(dev)
    khz = B2.sm_clock_khz()
    rows_out, b2_err = {}, 0.0
    reset_counts()
    inputs = {}
    for nr in (4096, 16384, 65536):
        rows = torch.from_numpy(np.random.RandomState(0).randint(
            0, NB, size=nr).astype(np.int32)).to(dev)
        inputs[nr] = rows
        ms = cuda_ms(lambda: B2.row_copy_probe(xb_dev, rows, 16,
                                               validate=False), 5)
        out, cyc = B2.row_copy_probe(xb_dev, rows, 16)
        rows_out[nr] = {"ms": ms, "ns_per_copy": ms * 1e6 / nr,
                        "cycles_per_copy": int(cyc.item()) / nr,
                        "cycles_per_copy_from_ms": ms * 1e-3 * khz * 1e3 / nr,
                        "index_select_ms": cuda_ms(
                            lambda: xb_dev.index_select(0, rows.long()), 5),
                        **bound(nr * D * 4 + nr * 4 + 16 * D * 4, 0.0)}
        rows_out[nr]["out"] = out
    launches = counts()
    for nr, r in rows_out.items():
        out = r.pop("out")
        ref = B2.row_copy_probe_reference(xb_dev, inputs[nr], 16)
        assert_equal(f"B2 nr={nr}", ref, out)
        b2_err = max(b2_err, max_abs_err(ref, out))
        r["plain_ms"] = host_ms(lambda: B2.row_copy_probe_reference(
            xb_dev, inputs[nr], 16), 3)
    if launches["row_copy_probe"] != 3 * 7:
        raise AssertionError(f"B2 launches {launches}")
    phase("row_copy_probe", ns=16, dp=D, nb=NB, sm_clock_khz=khz,
          calls={str(nr): r for nr, r in rows_out.items()},
          launches=launches)
    last = rows_out[65536]
    del xb_dev
    return {
        "name": "row_copy_probe",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/row_copy_probe.cu",
        "replaces": "benchs/r5/r5_queue7.py:88",
        "launches": launches["row_copy_probe"],
        "max_abs_err": b2_err,
        "ms": last["ms"],
        "plain_ms": last["plain_ms"],
        "bound_ms": last["bound_ms"],
        "bound_by": last["bound_by"],
        "library_ms": last["index_select_ms"],
    }


if __name__ == "__main__":
    main()
