"""Port parity: tpu_ann_torch.ops.extra_distances and IndexFlat's extra
metrics against the JAX package, on the CPU.

Each of the nine metrics (L1, Linf, Lp with p 3, Canberra, BrayCurtis,
JensenShannon, Jaccard, NaNEuclidean with 1% NaNs, ABS_INNER_PRODUCT) on
non-negative rows: IndexFlat's (D, I) within rtol 1e-5 of the reference's,
ids equal up to ties (both sum the same f32 terms in another order), and
pairwise_extra_distances within the same tolerance. The port's selector
route is held to exact search over the selected rows: the reference's
IndexFlat returns before it reads ``params.sel`` (tpu_ann/models/flat.py
:246-253)."""

import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from torch_parity import assert_topk_equal
from tpu_ann.models.base import SearchParameters as JParams
from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.ops import extra_distances as JX
from tpu_ann_torch.ops import extra_distances as TX

D, NB, NQ, K = 24, 3000, 40, 10
METRICS = [(T.METRIC_L1, 0.0), (T.METRIC_Linf, 0.0), (T.METRIC_Lp, 3.0),
           (T.METRIC_Canberra, 0.0), (T.METRIC_BrayCurtis, 0.0),
           (T.METRIC_JensenShannon, 0.0), (T.METRIC_Jaccard, 0.0),
           (T.METRIC_NaNEuclidean, 0.0), (T.METRIC_ABS_INNER_PRODUCT, 0.0)]
IDS = ["L1", "Linf", "Lp3", "Canberra", "BrayCurtis", "JensenShannon",
       "Jaccard", "NaNEuclidean", "AbsIP"]
RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(11)
    xb = rs.rand(NB, D).astype(np.float32)
    xq = rs.rand(NQ, D).astype(np.float32)
    xb_nan, xq_nan = xb.copy(), xq.copy()
    xb_nan[rs.rand(NB, D) < 0.01] = np.nan
    xq_nan[rs.rand(NQ, D) < 0.01] = np.nan
    return xb, xq, xb_nan, xq_nan


def _rows(data, metric):
    xb, xq, xb_nan, xq_nan = data
    if metric == T.METRIC_NaNEuclidean:
        return xb_nan, xq_nan
    return xb, xq


def _pair(metric, arg, xb):
    j = JFlat(D, metric)
    t = T.IndexFlat(D, metric, device="cpu")
    j.metric_arg = t.metric_arg = arg
    j.add(xb)
    t.add(xb)
    return j, t


@pytest.mark.parametrize("metric,arg", METRICS, ids=IDS)
def test_index_flat_extra_metric(metric, arg, data):
    xb, xq = _rows(data, metric)
    j, t = _pair(metric, arg, xb)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert I1.dtype == np.int64 and (I1 >= 0).all()
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1, rtol=RTOL)
    # best first: ascending distances, descending for Jaccard
    step = np.diff(D1, axis=1)
    assert ((step <= 0) if metric == T.METRIC_Jaccard else (step >= 0)).all()


@pytest.mark.parametrize("metric,arg", METRICS, ids=IDS)
def test_pairwise_extra_distances(metric, arg, data, monkeypatch):
    xb, xq = _rows(data, metric)
    P0 = JX.pairwise_extra_distances(xq, xb[:500], metric, arg)
    P1 = TX.pairwise_extra_distances(xq, xb[:500], metric, arg,
                                     device="cpu")
    np.testing.assert_allclose(P1, P0, rtol=RTOL, atol=1e-6)
    # the tensor route keeps tensors, and a small tile budget changes
    # nothing
    monkeypatch.setattr(TX, "TILE_BYTES", 1 << 14)
    P2 = TX.pairwise_extra_distances(torch.from_numpy(xq),
                                     torch.from_numpy(xb[:500]), metric, arg)
    np.testing.assert_array_equal(P2.numpy(), P1)


@pytest.mark.parametrize("metric,arg", METRICS, ids=IDS)
def test_knn_tiles_and_f64(metric, arg, data, monkeypatch):
    """Many small tiles give the one-tile result bit for bit, and the f32
    result agrees with the same formula in f64."""
    xb, xq = _rows(data, metric)
    q, b = torch.from_numpy(xq), torch.from_numpy(xb)
    D1, I1 = TX.knn_extra_metrics(q, b, K, metric, arg)
    monkeypatch.setattr(TX, "TILE_BYTES", 1 << 15)
    D2, I2 = TX.knn_extra_metrics(q, b, K, metric, arg)
    np.testing.assert_array_equal(D2.numpy(), D1.numpy())
    np.testing.assert_array_equal(I2.numpy(), I1.numpy())
    P64 = TX.tile_distances(q.double(), b.double(), metric, arg)
    sim = metric == T.METRIC_Jaccard
    order = torch.sort(P64, dim=1, descending=sim, stable=True).indices[:, :K]
    D64 = torch.gather(P64, 1, order).numpy()
    assert_topk_equal(D64, order.numpy(), D1.numpy().astype(np.float64),
                      I1.numpy(), rtol=1e-5)


@pytest.mark.parametrize("metric,arg", METRICS, ids=IDS)
def test_selector_is_honoured(metric, arg, data):
    """IDSelectorRange(0, 10) and a scattered IDSelectorBatch: the results
    are exact search over the selected rows. The reference returns other
    rows (its extra-metric route ignores params.sel, flat.py:246-253)."""
    xb, xq = _rows(data, metric)
    j, t = _pair(metric, arg, xb)
    rng = T.IDSelectorRange(0, 10)
    D1, I1 = t.search(xq, K, params=T.SearchParameters(sel=rng))
    assert ((I1 >= 0) & (I1 < 10)).all()
    sub = T.IndexFlat(D, metric, device="cpu")
    sub.metric_arg = arg
    sub.add(xb[:10])
    Ds, Is = sub.search(xq, K)
    np.testing.assert_array_equal(D1, Ds)
    np.testing.assert_array_equal(I1, Is)
    pick = np.random.RandomState(3).choice(NB, 300, replace=False)
    D2, I2 = t.search(xq, K, params=T.SearchParameters(
        sel=T.IDSelectorBatch(pick)))
    sub = T.IndexFlat(D, metric, device="cpu")
    sub.metric_arg = arg
    sub.add(xb[np.sort(pick)])
    Ds, Is = sub.search(xq, K)
    np.testing.assert_array_equal(D2, Ds)
    np.testing.assert_array_equal(I2, np.sort(pick)[Is])
    if metric == T.METRIC_L1:
        from tpu_ann.models.selectors import IDSelectorRange as JRange

        _, I0 = j.search(xq, K, params=JParams(sel=JRange(0, 10)))
        assert (np.asarray(I0) >= 10).any()       # the reference's fault


@pytest.mark.parametrize("metric", [T.METRIC_L1, T.METRIC_Jaccard])
def test_extra_metric_edges(metric, data):
    """k above ntotal pads with (worst, -1); an empty index returns the
    worst value; range search raises (ValueError), as the reference's."""
    xb, xq = _rows(data, metric)
    j, t = _pair(metric, 0.0, xb[:5])
    D0, I0 = j.search(xq, 8)
    D1, I1 = t.search(xq, 8)
    np.testing.assert_array_equal(I1[:, 5:], -1)
    np.testing.assert_array_equal(I1, np.asarray(I0))
    np.testing.assert_allclose(D1, np.asarray(D0), rtol=RTOL)
    De, Ie = T.IndexFlat(D, metric, device="cpu").search(xq, 3)
    assert (Ie == -1).all() and np.isinf(De).all()
    for idx in (j, t):
        with pytest.raises(ValueError):
            idx.range_search(xq, 1.0)
