"""The IVF-Flat slice as a whole: tpu_ann_torch's make_ivf_flat ->
train -> add -> search / search_stats against the JAX package's, on the
CPU, on integer-valued SIFT-surrogate data (exact scores on both sides).

(a) The JAX index's arrays carried over (ivf_flat_from_reference): both
    packages search the very same index. Ids equal up to ties, distances
    within rtol 1e-5 (f32 sums in another order), ndis equal.
(b) Each package trains on its own: recall@10 against exact ground truth
    within 0.02 (k-means runs in different libraries)."""

import numpy as np
import pytest
import torch

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.models.ivf import make_ivf_flat as j_make
from tpu_ann.ops.ivf_scan import pack_invlists as j_pack
from tpu_ann_torch.models import base as tbase
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import SearchParametersIVF as TParams
from tpu_ann_torch.models.ivf import make_ivf_flat as t_make
from tpu_ann_torch.utils.convert import (flat_from_reference,
                                         ivf_flat_from_reference)
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from tpu_ann_torch.utils.evaluation import recall_k_at_k
from torch_parity import assert_topk_equal

D, NLIST, K = 128, 32, 10


@pytest.fixture(scope="module")
def data():
    x = sift_surrogate(7000, seed=5, **SIFT1M_CALIBRATED)
    return x[:6000], x[6000:6960], x[6960:]          # xb, xt, xq


@pytest.fixture(scope="module")
def jax_index(data):
    xb, xt, _ = data
    idx = j_make(D, NLIST)
    idx.train(xt)
    idx.add_with_ids(xb, 1000 + 3 * np.arange(len(xb), dtype=np.int64))
    return idx


def _export(idx) -> dict:
    il = idx.invlists
    return {
        "d": idx.d, "metric": idx.metric_type, "nlist": idx.nlist,
        "ntotal": idx.ntotal,
        "vectors": np.asarray(idx.quantizer.vectors),
        "data": np.asarray(il.data), "ids": np.asarray(il.ids),
        "norms": np.asarray(il.norms),
        "list_block_start": np.asarray(il.list_block_start),
        "list_nblocks": np.asarray(il.list_nblocks),
        "ids_flat": np.asarray(idx._ids_flat),
    }


@pytest.mark.parametrize("nprobe", [1, 6])
def test_carried_index_searches_like_reference(data, jax_index, nprobe):
    _, _, xq = data
    tidx = ivf_flat_from_reference(_export(jax_index), device="cpu")
    D0, I0, s0 = jax_index.search_stats(xq, K, params=JParams(nprobe=nprobe))
    D1, I1, s1 = tidx.search_stats(xq, K, params=TParams(nprobe=nprobe))
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    assert s1.ndis == s0.ndis
    assert s1.nlist_visited == s0.nlist_visited == len(xq) * nprobe
    tidx.nprobe = nprobe
    D2, I2 = tidx.search(xq, K)
    np.testing.assert_array_equal(D2, D1)
    np.testing.assert_array_equal(I2, I1)
    assert I1.min() >= 1000                     # user ids, not rows


def test_carried_index_is_search_only(data, jax_index):
    tidx = ivf_flat_from_reference(_export(jax_index), device="cpu")
    np.testing.assert_array_equal(tidx.list_sizes, jax_index.list_sizes)
    assert tidx.imbalance_factor() == pytest.approx(
        jax_index.imbalance_factor())
    with pytest.raises(RuntimeError):
        tidx.add(data[0][:10])


def test_flat_from_reference(data):
    xb, _, xq = data
    j = JFlat(D)
    j.add(xb)
    t = flat_from_reference(j.state_dict(), device="cpu")
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


def test_own_training_recall_close_to_reference(data, jax_index):
    xb, xt, xq = data
    flat = TFlat(D, device="cpu")
    flat.add(xb)
    _, gt = flat.search(xq, K)
    tidx = t_make(D, NLIST, device="cpu")
    tidx.train(xt)
    tidx.add(xb)
    assert len(tidx.clustering_stats) == 10
    for nprobe in (2, 6):
        _, I0 = jax_index.search(xq, K, params=JParams(nprobe=nprobe))
        I0 = np.where(I0 >= 0, (I0 - 1000) // 3, -1)    # back to rows
        _, I1 = tidx.search(xq, K, params=TParams(nprobe=nprobe))
        r0, r1 = recall_k_at_k(I0, gt, K), recall_k_at_k(I1, gt, K)
        assert abs(r1 - r0) <= 0.02, (nprobe, r0, r1)


def test_prebuilt_quantizer_and_chunked_add(data, jax_index):
    """quantizer_trains_alone=1 keeps a pre-built quantizer; adding in
    chunks packs the same lists as one add; both match the reference."""
    xb, xt, xq = data
    cent = np.asarray(jax_index.quantizer.vectors)
    tidx = t_make(D, NLIST, device="cpu")
    tidx.quantizer.add(cent)
    tidx.quantizer_trains_alone = 1
    tidx.train(xt)
    assert tidx.clustering_stats == []
    ids = 1000 + 3 * np.arange(len(xb), dtype=np.int64)
    tidx.add_with_ids(xb[:2500], ids[:2500])
    tidx.add_with_ids(xb[2500:], ids[2500:])
    # same coarse assignment, and the layout the reference's host pack
    # gives it (its device pack pads extra trailing blocks)
    assign = np.concatenate(jax_index._assign_host)
    np.testing.assert_array_equal(np.concatenate(tidx._assign_host), assign)
    ref = j_pack(xb, np.arange(len(xb)), assign, NLIST)
    for name in ("data", "ids", "norms", "list_block_start",
                 "list_nblocks"):
        np.testing.assert_array_equal(
            getattr(tidx.invlists, name).numpy(),
            np.asarray(getattr(ref, name)), err_msg=name)
    D0, I0 = jax_index.search(xq, K, params=JParams(nprobe=4))
    D1, I1 = tidx.search(xq, K, params=TParams(nprobe=4))
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


def test_search_stats_split_and_global_counters(data):
    xb, xt, xq = data
    tidx = t_make(D, 16, device="cpu")
    tidx.cp.niter = 3
    tidx.train(xt)
    tidx.add(xb)
    tbase.indexIVF_stats.reset()
    _, _, st = tidx.search_stats(xq, K, params=TParams(nprobe=3))
    assert st.nq == len(xq)
    assert st.quantization_us > 0 and st.list_scan_us > 0
    assert st.total_us == pytest.approx(st.quantization_us + st.list_scan_us)
    assert 0 < st.ndis <= len(xq) * len(xb)
    assert tbase.indexIVF_stats.ndis == st.ndis
    assert tbase.indexIVF_stats.nq == len(xq)


def test_unported_options_raise(data, jax_index):
    """The options that raised before the IVF API was ported now answer as
    the reference's: max_codes and a selector (the query-major scan), and
    coarse_mode="quantizer" over an IndexFlat quantizer (the same probes as
    "auto"). A quantizer with no search of its own, and an untrained add,
    still raise."""
    from tpu_ann.models.selectors import IDSelectorRange as JRange
    from tpu_ann_torch.models.base import Index as TIndex
    from tpu_ann_torch.models.selectors import IDSelectorRange as TRange

    xb, xt, xq = data
    tidx = t_make(D, NLIST, device="cpu")
    tidx.quantizer.add(np.asarray(jax_index.quantizer.vectors))
    tidx.quantizer_trains_alone = 1
    tidx.train(xt)
    tidx.add_with_ids(xb, 1000 + 3 * np.arange(len(xb), dtype=np.int64))
    D0, I0 = jax_index.search(xq, K, params=JParams(nprobe=2, max_codes=100))
    D1, I1 = tidx.search(xq, K, params=TParams(nprobe=2, max_codes=100))
    np.testing.assert_array_equal(D1, D0)
    assert_topk_equal(D0, I0, D1, I1)
    D0, I0 = jax_index.search(xq, K, params=JParams(
        nprobe=2, sel=JRange(1000, 1000 + 3 * 3000)))
    D1, I1 = tidx.search(xq, K, params=TParams(
        nprobe=2, sel=TRange(1000, 1000 + 3 * 3000)))
    np.testing.assert_array_equal(D1, D0)
    assert_topk_equal(D0, I0, D1, I1)
    D2, I2 = tidx.search(xq, K, params=TParams(nprobe=2))
    tidx.coarse_mode = "quantizer"
    D3, I3 = tidx.search(xq, K, params=TParams(nprobe=2))
    np.testing.assert_array_equal(D3, D2)
    np.testing.assert_array_equal(I3, I2)
    tidx.quantizer = TIndex(D, device="cpu")
    with pytest.raises(NotImplementedError):
        tidx.search(xq, K)
    with pytest.raises(RuntimeError):
        t_make(D, 8, device="cpu").add(xb[:10])     # untrained