"""Port parity: tpu_ann_torch.models.ivf_hnsw.IndexIVFHNSW (IVF-Flat with
an HNSW coarse quantizer) against the JAX package's, on the CPU, on
integer-valued SIFT-surrogate data, nlist 64.

(a) The JAX index's centroids, graph and lists carried over
    (ivf_hnsw_from_reference): with coarse_mode "auto" (the exact product
    over the centroid table) both packages search the very same index, so
    ids are equal up to ties and distances within rtol 1e-5 (f32 sums in
    another order). With coarse_mode "quantizer" the probes come from the
    graph search (the per-node beam at this size): recall@10 within 0.01
    of the JAX package's.
(b) Each package trains and builds on its own: recall@10 within 0.02
    (k-means runs in different libraries)."""

import numpy as np
import pytest

from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.models.ivf_hnsw import IndexIVFHNSW as JIVFHNSW
from tpu_ann_torch.models.ivf import SearchParametersIVF as TParams
from tpu_ann_torch.models.ivf_hnsw import IndexIVFHNSW as TIVFHNSW
from tpu_ann_torch.utils.convert import ivf_hnsw_from_reference
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from tpu_ann_torch.utils.evaluation import recall_k_at_k
from torch_parity import assert_topk_equal

D, NLIST, K, M = 128, 64, 10, 16


@pytest.fixture(scope="module")
def data():
    x = sift_surrogate(8200, seed=6, **SIFT1M_CALIBRATED)
    xb, xt, xq = x[:6000], x[6000:8000], x[8000:]
    d2 = ((xq[:, None, :].astype(np.float64) - xb[None]) ** 2).sum(-1)
    return xb, xt, xq, np.argsort(d2, axis=1, kind="stable")[:, :K]


@pytest.fixture(scope="module")
def jax_index(data):
    xb, xt, _, _ = data
    idx = JIVFHNSW(D, NLIST, M=M)
    idx.cp.niter = 6
    idx.train(xt)
    idx.add(xb)
    return idx


def _export_hnsw(q) -> dict:
    g = q.graph
    return {"d": q.d, "metric": q.metric_type, "M": q.hnsw.M,
            "efSearch": q.hnsw.efSearch,
            "efConstruction": q.hnsw.efConstruction,
            "xb": np.asarray(q.storage.vectors)[:q.ntotal],
            "neighbors0": np.asarray(g.neighbors0),
            "upper_ids": np.asarray(g.upper_ids),
            "upper_neighbors": np.asarray(g.upper_neighbors),
            "levels": np.asarray(g.levels), "entry": int(g.entry),
            "max_level": int(g.max_level)}


def _export(idx) -> dict:
    il = idx.invlists
    return {"d": idx.d, "metric": idx.metric_type, "nlist": idx.nlist,
            "ntotal": idx.ntotal, "quantizer": _export_hnsw(idx.quantizer),
            "data": np.asarray(il.data), "ids": np.asarray(il.ids),
            "norms": np.asarray(il.norms),
            "list_block_start": np.asarray(il.list_block_start),
            "list_nblocks": np.asarray(il.list_nblocks),
            "ids_flat": np.asarray(idx._ids_flat)}


@pytest.mark.parametrize("nprobe", [1, 8])
def test_carried_index_auto_equal(data, jax_index, nprobe):
    _, _, xq, _ = data
    tidx = ivf_hnsw_from_reference(_export(jax_index), device="cpu")
    assert tidx.coarse_mode == "auto"
    D0, I0 = jax_index.search(xq, K, params=JParams(nprobe=nprobe))
    D1, I1 = tidx.search(xq, K, params=TParams(nprobe=nprobe))
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


@pytest.mark.parametrize("nprobe", [4, 12])
def test_carried_index_quantizer_mode_recall(data, jax_index, nprobe):
    _, _, xq, gt = data
    tidx = ivf_hnsw_from_reference(_export(jax_index), device="cpu")
    tidx.coarse_mode = "quantizer"
    jax_index.coarse_mode = "quantizer"
    try:
        _, I0 = jax_index.search(xq, K, params=JParams(nprobe=nprobe))
    finally:
        jax_index.coarse_mode = "auto"
    _, I1 = tidx.search(xq, K, params=TParams(nprobe=nprobe))
    r0, r1 = recall_k_at_k(I0, gt, K), recall_k_at_k(I1, gt, K)
    assert abs(r1 - r0) <= 0.01, (r0, r1)
    # the graph's probes are (nearly) the exact top-nprobe lists
    tidx.coarse_mode = "auto"
    _, I2 = tidx.search(xq, K, params=TParams(nprobe=nprobe))
    assert abs(recall_k_at_k(I2, gt, K) - r1) <= 0.01


def test_own_training_recall(data, jax_index):
    xb, xt, xq, gt = data
    tidx = TIVFHNSW(D, NLIST, M=M, device="cpu")
    tidx.cp.niter = 6
    tidx.add_chunk_size = 2500                      # three chunks
    tidx.train(xt)
    assert tidx.quantizer.ntotal == NLIST and tidx.quantizer.graph is not None
    tidx.add(xb)
    assert tidx.ntotal == len(xb)
    _, I0 = jax_index.search(xq, K, params=JParams(nprobe=8))
    _, I1 = tidx.search(xq, K, params=TParams(nprobe=8))
    assert abs(recall_k_at_k(I1, gt, K) - recall_k_at_k(I0, gt, K)) <= 0.02
    tidx.set_hnsw_parameters(efSearch=48)
    assert tidx.efSearch == 48
    with pytest.raises(NotImplementedError):
        tidx.save_to_disk("unused")
