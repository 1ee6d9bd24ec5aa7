#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. device  — a CUDA device is required; nvidia-smi's name and power limit.
  2. build   — compile the three CUDA kernels from tpu_ann_torch/csrc (one
     nvcc each, in parallel): K3 ivf_scan_fused, K1 flat_knn_fused, K2
     reservoir_topk.
  3. IVF path at the benchmark's size: calibrated SIFT1M surrogate (1M
     base, 100k train, 10k queries, seed 123); the exact IndexFlat's
     ground truth (no K1 launch); make_ivf_flat(128, 4096) -> train
     (k-means, 10 iterations) -> add -> search and search_stats at nprobe
     16 / 32 / 64, k=10. Recall@10 must reach the floors; every search is
     exactly one K3 launch and no K1 / K2 launch.
  4. K3 vs its plain torch version at the IVF path's shapes (1024 queries,
     nprobe 32): per-pair outputs and final (D, I) equal on the integer
     data; IP on float data with id overlap >= 0.999; times.
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
     sizes.
The last two lines are the kernels' JSON record and {"ok": true, ...}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

import tpu_ann_torch as T
from tpu_ann_torch import kernels
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import flat_knn_fused as FK
from tpu_ann_torch.ops import ivf_scan_fused as F

# recall@10 floors at nprobe 16 / 32 / 64: the JAX package's benchmark
# recalls on this workload (0.8831 / 0.9718 / 0.9978) less 0.01 for
# k-means differences
RECALL_FLOORS = {16: 0.8731, 32: 0.9618, 64: 0.9878}
# flat path recall@10 floors: the exact route, the JAX package's 0.9979 at
# W=2048 (BENCH_r05.json) less 0.001 for the order of ground-truth ties;
# the refine route, its 0.99516 at W=1024 (benchs/logs/r5_queue1.jsonl)
# less about 0.001; IP on float data has no reference value
FLAT_FLOORS = {"exact": 0.9969, "refine": 0.9942, "ip_float": 0.98}
KERNELS = ("ivf_scan_fused", "flat_knn_fused", "reservoir_topk")
D, NLIST, K = 128, 4096, 10
NB, NT, NQ = 1_000_000, 100_000, 10_000
TIMED_REPS = 3


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
    for name in FK.LAUNCHES:
        FK.LAUNCHES[name] = 0


def counts() -> dict:
    return {"ivf_scan_fused": F.LAUNCHES, **FK.LAUNCHES}


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

    results = {}
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
    }
    del index, il, il_f, data_f
    torch.cuda.empty_cache()

    flat_records = flat_phases(xb, xq, gt, dev)
    print(json.dumps({"kernels": [k3, *flat_records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


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


def flat_phases(xb, xq, gt, dev) -> list:
    """Phases 5 and 6: the fused flat path and its kernels; returns the
    K1 and K2 records of the kernels line."""
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
    flat_search(index, xq, gt, "refine", FLAT_FLOORS["refine"])
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
        del rv10, rp10
    phase("flat_kernel_check", nq=[len(q), NQ], nb=index.ntotal,
          k1_equal=True, k2_equal=True,
          k1={str(W): t for W, t in k1.items()},
          k2={f"W{W}_k{k}": t for (W, k), t in k2.items()})

    return [{
        "name": "flat_knn_fused",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/flat_knn_fused.cu",
        "replaces": "tpu_ann/ops/flat_knn_pallas.py:472",
        "launches": flat_launches["flat_knn_fused"],
        "max_abs_err": k1_err,
        "ms": k1[2048]["ms"],
        "plain_ms": k1[2048]["plain_ms"],
    }, {
        "name": "reservoir_topk",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/reservoir_topk.cu",
        "replaces": "tpu_ann/ops/flat_knn_pallas.py:283",
        "launches": flat_launches["reservoir_topk"],
        "max_abs_err": k2_err,
        "ms": k2[(2048, 10)]["ms"],
        "plain_ms": k2[(2048, 10)]["plain_ms"],
    }]


if __name__ == "__main__":
    main()
