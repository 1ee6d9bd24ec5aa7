"""Entry points of tpu_ann_torch — PyTorch counterpart of the JAX
package's ``__graft_entry__.py``.

`entry(device)` returns the single-device forward step over the flagship
model (the IVF search path: an exact f32 coarse GEMM top-nprobe, then the
query-major packed invlist scan) and its example arguments on the device.
`dryrun_multichip(n, device)` runs one sharded training and search step of
every distributed path over an n-rank torch.distributed world
(tpu_ann_torch.parallel): k-means, exact k-NN, the IVF scan (plain, and
through the scan kernel K3), the 4-bit IVF-PQ scan, the exact refine, the
HNSW-routed hybrid and the out-of-core paged container (the window kernel
K4), on tiny shapes.

    python -m tpu_ann_torch.graft_entry [--device cpu] [--ranks 4]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def _build_tiny_index(d=32, nb=2048, nlist=16, seed=0, device="cuda"):
    from .models.ivf import make_ivf_flat

    rs = np.random.RandomState(seed)
    xt = rs.rand(1024, d).astype(np.float32)
    xb = rs.rand(nb, d).astype(np.float32)
    index = make_ivf_flat(d, nlist, device=device)
    index.cp.niter = 4
    index.train(xt)
    index.add(xb)
    return index


def make_step(index, nprobe: int = 4, k: int = 10):
    """The IVF search forward step over ``index``'s lists: (D, I) of an
    (nq, d) query tensor on the index's device. ``step.index`` is the
    index."""
    from .ops import distances as D
    from .ops.ivf_scan import scan_invlists

    index._maybe_repack()
    invlists = index.invlists
    centroids = index.quantizer.vectors.float()
    mnb = invlists.max_nblocks_per_list

    def ivf_search_step(xq):
        # phase 1: coarse quantization (f32 GEMM + top-nprobe)
        _, probes = D.knn(xq, centroids, nprobe, D.METRIC_L2)
        # phase 2: packed invlist scan + k-select merge
        dis, ids, _ = scan_invlists(xq, probes, invlists, k, D.METRIC_L2,
                                    max_nblocks=mnb)
        return dis, ids

    ivf_search_step.index = index
    return ivf_search_step


def entry(device="cuda", index=None):
    """(fn, example_args): the IVF search forward step over the tiny index
    (d 32, nb 2048, nlist 16, 4 k-means iterations; built on ``device``
    unless ``index`` is given), and 64 queries on ``device``."""
    import torch

    index = _build_tiny_index(device=device) if index is None else index
    rs = np.random.RandomState(1)
    xq = torch.from_numpy(rs.rand(64, index.d).astype(np.float32)).to(
        device)
    return make_step(index), (xq,)


def _dryrun_rank(device, n_devices, n_rep, n_shards):
    """One rank of `dryrun_multichip`: every section on this rank's part;
    returns its results (numpy, the same on every rank) and its K3 / K4
    launches."""
    import torch

    from .models.hnsw import IndexHNSWFlat
    from .models.ivf_paged import IndexIVFFlatPaged
    from .ops import distances as D
    from .ops import ivf_scan_fused, ivf_scan_paged
    from .ops import pq as PQ
    from .ops.ivf_scan import pack_code_invlists, pack_invlists
    from .parallel import (local_rows, make_mesh, sharded_ivf_scan,
                           sharded_ivf_scan_pq, sharded_kmeans_iter,
                           sharded_knn, sharded_refine)

    mesh = make_mesh(n_shards=n_shards, n_replicas=n_rep, device=device)
    dev = mesh.device
    d, nlist, k, B = 16, 8, 5, 8
    rs = np.random.RandomState(0)
    n = 64 * n_devices
    x = rs.rand(n, d).astype(np.float32)
    xq = rs.rand(2 * n_rep, d).astype(np.float32)
    x_dev, xq_dev = torch.from_numpy(x).to(dev), torch.from_numpy(xq).to(dev)
    out = {}

    # --- distributed k-means training step (rows over the world) ---
    new_c, counts, obj = sharded_kmeans_iter(
        local_rows(x, mesh, axis="world"), x[:nlist], nlist, mesh=mesh)
    assert float(counts.sum()) == n
    out["kmeans"] = (new_c.cpu().numpy(), float(obj))

    # --- sharded exact search (db sharded, queries replica-split) ---
    dflat, iflat = sharded_knn(x, local_rows(x, mesh), k, mesh=mesh)
    assert (iflat[:, 0] >= 0).all()
    out["knn"] = (dflat.cpu().numpy(), iflat.cpu().numpy())

    # --- sharded IVF search: this shard's lists, common quantizer ---
    _, assign = D.knn(x_dev, new_c, 1)
    assign = assign[:, 0].cpu().numpy()
    rows = n // n_shards
    lo, hi = mesh.shard * rows, (mesh.shard + 1) * rows
    # the longest list of any shard, in blocks
    mnb = max(-(-int(np.bincount(assign[s * rows:(s + 1) * rows],
                                 minlength=nlist).max()) // B)
              for s in range(n_shards))
    il = pack_invlists(x[lo:hi], np.arange(lo, hi), assign[lo:hi], nlist,
                       block_size=B, device=dev)
    cdq, probes = D.knn(xq_dev, new_c, 4)
    div, iiv = sharded_ivf_scan(xq_dev, probes, il, k, max_nblocks=mnb,
                                mesh=mesh)
    assert iiv.shape == (len(xq), k)
    out["ivf"] = (div.cpu().numpy(), iiv.cpu().numpy())

    # --- the same scan through the fused scan (K3 on the card) ---
    dfu, ifu = sharded_ivf_scan(xq_dev, probes, il, k, max_nblocks=mnb,
                                mesh=mesh, fused=True)
    ifu_h, iiv_h = ifu.cpu().numpy(), iiv.cpu().numpy()
    ov = np.mean([len(set(ifu_h[q]) & set(iiv_h[q])) / k
                  for q in range(len(xq))])
    assert ov >= 0.9, f"fused sharded scan disagrees: overlap {ov}"
    out["fused"] = (dfu.cpu().numpy(), ifu_h)

    # --- sharded PQ-coded IVF search (4-bit codes) ---
    cent_h = new_c.cpu().numpy()
    resid = x - cent_h[assign]
    pqc = PQ.train_pq(resid, M=4, nbits=4, device=dev)
    books = torch.from_numpy(pqc.centroids).to(dev)
    codes = PQ.pack_codes_4bit(PQ.pq_encode(
        torch.from_numpy(resid).to(dev), books)).cpu().numpy()
    cil = pack_code_invlists(codes[lo:hi], np.arange(lo, hi), assign[lo:hi],
                             nlist, block_size=B, device=dev)
    dpq, ipq = sharded_ivf_scan_pq(xq_dev, probes, cdq, cil, books, new_c, k,
                                   max_nblocks=mnb, packed4=True, mesh=mesh)
    assert ipq.shape == (len(xq), k) and (ipq >= 0).any()
    out["pq"] = (dpq.cpu().numpy(), ipq.cpu().numpy())

    # --- exact refine of the coded candidates over the sharded raw rows
    # (IndexRefineFlat's k_factor step) ---
    dref, iref = sharded_refine(xq_dev, ipq, local_rows(x, mesh), k,
                                mesh=mesh)
    assert iref.shape == (len(xq), k) and (iref >= 0).any()
    out["refine"] = (dref.cpu().numpy(), iref.cpu().numpy())

    # --- the namesake hybrid: an HNSW coarse quantizer (replicated, a graph
    # over the centroids) routes probes into the same sharded list scan,
    # here through the fused scan (K3 on the card) ---
    hq = IndexHNSWFlat(d, 4, device=dev)
    hq.add(cent_h)
    hq.hnsw.efSearch = nlist          # exhaustive beam at toy scale
    _, probes_h = hq.search_device(xq_dev, 4)
    dhy, ihy = sharded_ivf_scan(xq_dev, probes_h, il, k, max_nblocks=mnb,
                                mesh=mesh, fused=True)
    assert ihy.shape == (len(xq), k) and (ihy >= 0).any()
    out["hybrid"] = (dhy.cpu().numpy(), ihy.cpu().numpy())

    # --- out-of-core paged container search (K4 on the card) ---
    with tempfile.TemporaryDirectory() as td:
        pidx = IndexIVFFlatPaged(d, nlist, path=os.path.join(td, "p"),
                                 block_size=128, device=dev)
        pidx.cp_niter = 3
        pidx.train(x[:256])
        pidx.add(x)
        pidx.nprobe = 4
        dpg, ipg = pidx.search(xq, k)
        assert ipg.shape == (len(xq), k) and (ipg >= 0).any()
        out["paged"] = (dpg, ipg)
        del pidx
    return {"results": out, "replica": mesh.replica, "shard": mesh.shard,
            "k3_launches": int(ivf_scan_fused.LAUNCHES),
            "k4_launches": int(ivf_scan_paged.LAUNCHES)}


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = 120.0) -> dict:
    """One sharded training + search step over an n_devices-rank world on
    ``device`` (`demos.demo_sharded_search.run_world`: gloo on the CPU and
    for ranks sharing one card, NCCL with a card a rank), a (replica,
    shard) mesh of 2 x (n/2) when n is even, else 1 x n. Every rank must
    return the same results. Returns the layout and the K3 / K4 launches
    summed over the ranks."""
    from .demos.demo_sharded_search import run_world, world_layout

    n_rep = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_shards = n_devices // n_rep
    ranks = run_world(_dryrun_rank, n_devices, device,
                      (n_devices, n_rep, n_shards), timeout_s)
    r0 = ranks[0]["results"]
    for r, res in enumerate(ranks[1:], 1):
        for name, arrays in r0.items():
            for a, b in zip(arrays, res["results"][name]):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    raise AssertionError(f"dryrun: rank {r}'s {name} "
                                         f"differs from rank 0's")
    print(f"dryrun_multichip({n_devices}): ok "
          f"(mesh replica={n_rep} x shard={n_shards}; "
          f"flat+kmeans+ivf+fused+pq+refine+hybrid+paged)")
    return {"n_replicas": n_rep, "n_shards": n_shards,
            "backend": world_layout(n_devices, device)[0],
            "k3_launches": sum(r["k3_launches"] for r in ranks),
            "k4_launches": sum(r["k4_launches"] for r in ranks)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="entry() and dryrun_multichip")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    Dv, Iv = fn(*example)
    assert Dv.shape == Iv.shape == (len(example[0]), 10)
    assert bool((Iv >= 0).all())
    print("entry: ok")
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
