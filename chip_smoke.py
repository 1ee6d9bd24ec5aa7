#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. device  — a CUDA device is required; nvidia-smi's name and power limit.
  2. build   — compile the CUDA kernel from tpu_ann_torch/csrc.
  3. main path at the benchmark's size: calibrated SIFT1M surrogate (1M
     base, 100k train, 10k queries, seed 123); make_ivf_flat(128, 4096)
     -> train (k-means, 10 iterations) -> add -> search and search_stats
     at nprobe 16 / 32 / 64, k=10. Recall@10 against the port's exact
     IndexFlat on the GPU must reach the floors; every search is exactly
     one kernel launch.
  4. kernel vs its plain torch version at the main path's shapes (1024
     queries, nprobe 32): per-pair outputs and final (D, I) equal on the
     integer data; IP on float data with id overlap >= 0.999; times.
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
from tpu_ann_torch.ops import ivf_scan_fused as F

# recall@10 floors at nprobe 16 / 32 / 64: the JAX package's benchmark
# recalls on this workload (0.8831 / 0.9718 / 0.9978) less 0.01 for
# k-means differences
RECALL_FLOORS = {16: 0.8731, 32: 0.9618, 64: 0.9878}
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
    kernels.load_library("ivf_scan_fused")
    ptxas = [ln.strip() for ln in kernels.build_log("ivf_scan_fused")
             .splitlines() if "registers" in ln or "spill" in ln]
    phase("build", kernel="ivf_scan_fused",
          seconds=kernels.BUILD_SECONDS["ivf_scan_fused"], ptxas=ptxas)

    # -- 3. main path at real size ----------------------------------------
    t0 = time.perf_counter()
    allx = T.sift_surrogate(NB + NT + NQ, seed=123, **T.SIFT1M_CALIBRATED)
    xb, xt, xq = allx[:NB], allx[NB:NB + NT], allx[NB + NT:]
    t_data = time.perf_counter() - t0

    t0 = time.perf_counter()
    flat = T.IndexFlat(D, device="cuda")
    flat.add(xb)
    _, gt = flat.search(xq, K)
    t_gt = time.perf_counter() - t0
    del flat

    F.LAUNCHES = 0
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
    max_abs_err = float(np.abs(d1[fin] - d0[fin]).max()) if fin.any() \
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
          max_abs_err=max_abs_err, ip_float_overlap=overlap,
          kernel_ms=ms, plain_ms=plain_ms, fused_search_ms=search_ms)

    print(json.dumps({"kernels": [{
        "name": "ivf_scan_fused",
        "route": "cuda",
        "source": "tpu_ann_torch/csrc/ivf_scan_fused.cu",
        "replaces": "tpu_ann/ops/ivf_scan_pallas.py:60",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
