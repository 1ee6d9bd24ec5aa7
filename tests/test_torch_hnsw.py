"""Port parity: tpu_ann_torch.ops.hnsw (the batch kNN-graph build and the
per-node search) and the query-major scan of tpu_ann_torch.ops.ivf_scan,
on the CPU, against the JAX package on the same numpy inputs.

Tolerances:
- random_levels: numpy draws, equal;
- build_graph_knn on float data: both packages take the same kNN
  candidates and the same diversity prune, but sum their products in
  another order, so a near-tie can flip a kept link; each node's level-0
  and upper-level link SETS must be equal on >= 99% of rows;
- hnsw_search over the same (reference) graph: id overlap >= 0.99 and
  recall@10 within 0.01 of the JAX package's;
- pack_invlists_device and scan_invlists on integer data (every product
  and sum exact): the layout and (D, I) equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import distances as JD
from tpu_ann.ops import hnsw as JH
from tpu_ann.ops import ivf_scan as JIV
from tpu_ann_torch.ops import hnsw as H
from tpu_ann_torch.ops import ivf_scan as IV
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate

L2, IP = JD.METRIC_L2, JD.METRIC_INNER_PRODUCT
CPU = torch.device("cpu")


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y) - {-1}) / max(
        len(set(y) - {-1}), 1) for x, y in zip(a, b)]))


def _row_sets_equal(a, b):
    return float(np.mean([set(x[x >= 0]) == set(y[y >= 0])
                          for x, y in zip(a, b)]))


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(21)
    cent = rs.randn(30, 32).astype(np.float32) * 3
    xb = (cent[rs.randint(0, 30, 3000)]
          + rs.randn(3000, 32).astype(np.float32))
    xq = (cent[rs.randint(0, 30, 200)]
          + rs.randn(200, 32).astype(np.float32))
    return xb.astype(np.float32), xq.astype(np.float32)


@pytest.mark.parametrize("n,m,seed", [(3000, 16, 1234), (100000, 8, 7),
                                      (10, 32, 0)])
def test_random_levels_equal(n, m, seed):
    np.testing.assert_array_equal(H.random_levels(n, m, seed),
                                  JH.random_levels(n, m, seed))


def _build_both(xb, m, metric, prune_mode):
    levels = JH.random_levels(len(xb), m, 1234)
    jg, _ = JH.build_graph_knn(jnp.asarray(xb), m, 40, levels=levels,
                               metric=metric, prune_mode=prune_mode)
    tg, assign = H.build_graph_knn(xb, m, 40, levels=levels, metric=metric,
                                   prune_mode=prune_mode, device=CPU)
    assert assign is None                         # n <= 32768: exact kNN
    return jg, tg


@pytest.mark.parametrize("m,metric,prune_mode", [(8, L2, "single"),
                                                 (16, L2, "single"),
                                                 (16, IP, "single"),
                                                 (8, L2, "double")])
def test_build_graph_knn_links_equal(data, m, metric, prune_mode):
    xb, _ = data
    jg, tg = _build_both(xb, m, metric, prune_mode)
    assert tg.entry == int(jg.entry) and tg.max_level == jg.max_level
    np.testing.assert_array_equal(tg.upper_ids.numpy(),
                                  np.asarray(jg.upper_ids))
    assert tg.neighbors0.shape == (len(xb), 2 * m)
    assert _row_sets_equal(tg.neighbors0.numpy(),
                           np.asarray(jg.neighbors0)) >= 0.99
    ju = np.asarray(jg.upper_neighbors)
    tu = tg.upper_neighbors.numpy()
    assert tu.shape == ju.shape
    for lev in range(ju.shape[1]):
        assert _row_sets_equal(tu[:, lev], ju[:, lev]) >= 0.99


@pytest.mark.parametrize("metric", [L2, IP])
def test_hnsw_search_over_the_reference_graph(data, metric):
    xb, xq = data
    levels = JH.random_levels(len(xb), 16, 1234)
    jg, _ = JH.build_graph_knn(jnp.asarray(xb), 16, 40, levels=levels,
                               metric=metric)
    tg = H.HNSWGraph(
        neighbors0=torch.from_numpy(np.array(jg.neighbors0)),
        upper_ids=torch.from_numpy(np.array(jg.upper_ids)),
        upper_neighbors=torch.from_numpy(np.array(jg.upper_neighbors)),
        levels=torch.from_numpy(np.array(jg.levels)),
        entry=int(jg.entry), max_level=jg.max_level)
    D0, I0, _ = JH.hnsw_search(jnp.asarray(xb), jg, jnp.asarray(xq), ef=32,
                               k=10, metric=metric)
    D1, I1, st = H.hnsw_search(torch.from_numpy(xb), tg, torch.from_numpy(xq),
                               ef=32, k=10, metric=metric)
    I0, I1 = np.asarray(I0), I1.numpy()
    assert _overlap(I1, I0) >= 0.99
    _, gt = JD.knn(jnp.asarray(xq), jnp.asarray(xb), 10, metric)
    gt = np.asarray(gt)
    assert abs(_overlap(I1, gt) - _overlap(I0, gt)) <= 0.01
    assert int(st["ndis"]) > 0 and int(st["nhops"]) > 0


@pytest.fixture(scope="module")
def lists():
    x = sift_surrogate(2300, seed=4, **SIFT1M_CALIBRATED)
    xb, xq = x[:2000], x[2000:]
    rs = np.random.RandomState(5)
    assign = rs.randint(0, 40, 2000)
    assign[assign == 7] = 8                       # an empty list
    probes = rs.randint(0, 40, size=(300, 6)).astype(np.int32)
    return xb, xq, assign.astype(np.int64), probes


def test_pack_invlists_device_layout_equal(lists):
    xb, _, assign, _ = lists
    ids = np.arange(len(xb), dtype=np.int64)
    j = JIV.pack_invlists_device(jnp.asarray(xb), ids, assign, 40,
                                 block_size=32)
    t = IV.pack_invlists_device(torch.from_numpy(xb), ids, assign, 40,
                                block_size=32)
    for name in ("data", "ids", "norms", "list_block_start", "list_nblocks"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    assert t.max_nblocks_per_list == j._max_nblocks


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("max_nblocks", [0, 2])
def test_scan_invlists_equal(lists, metric, max_nblocks, monkeypatch):
    xb, xq, assign, probes = lists
    ids = np.arange(len(xb), dtype=np.int64)
    j = JIV.pack_invlists_device(jnp.asarray(xb), ids, assign, 40,
                                 block_size=32)
    t = IV.pack_invlists_device(torch.from_numpy(xb), ids, assign, 40,
                                block_size=32)
    mnb = max_nblocks or j._max_nblocks
    D0, I0, n0 = JIV.scan_invlists(jnp.asarray(xq), jnp.asarray(probes), j,
                                   12, metric, max_nblocks=mnb, qt=64)
    monkeypatch.setattr(IV, "SCAN_BUDGET", 20000)     # several query tiles
    D1, I1, n1 = IV.scan_invlists(torch.from_numpy(xq),
                                  torch.from_numpy(probes), t, 12, metric,
                                  max_nblocks=mnb)
    np.testing.assert_array_equal(D1.numpy(), np.asarray(D0))
    np.testing.assert_array_equal(I1.numpy(), np.asarray(I0))
    assert int(n1) == int(n0)


def test_knn_candidates_scan_route():
    """Past 32768 rows the candidates come from k-means probes and the
    query-major scan: every row's candidates exclude padding and mostly
    hold its true nearest neighbours."""
    x = sift_surrogate(33000, seed=9, **SIFT1M_CALIBRATED)[:, :16].copy()
    dis, ids, assign = H.knn_candidates(torch.from_numpy(x), 20, L2, 1234)
    assert assign is not None and assign.shape == (33000,)
    assert ids.shape == (33000, 21) and (ids >= 0).all()
    q = torch.from_numpy(x[:200])
    _, gt = torch.cdist(q, torch.from_numpy(x)).topk(10, largest=False)
    assert _overlap(ids[:200, :10].numpy(), gt.numpy()) >= 0.9


def test_index_hnsw_flat_end_to_end(data):
    """IndexHNSWFlat built and searched by each package on its own (the
    per-node route below tile_threshold): recall@10 within 0.01; above the
    threshold the port takes its fused tiles."""
    from tpu_ann.models.hnsw import IndexHNSWFlat as JHNSW
    from tpu_ann_torch.models.hnsw import IndexHNSWFlat as THNSW
    from tpu_ann_torch.models.hnsw import SearchParametersHNSW

    xb, xq = data
    _, gt = JD.knn(jnp.asarray(xq), jnp.asarray(xb), 10)
    gt = np.asarray(gt)
    j = JHNSW(32, 16)
    j.add(xb)
    t = THNSW(32, 16, device=CPU)
    t.add(xb)
    assert t.ntotal == len(xb) and "graph" in t.build_seconds
    _, I0 = j.search(xq, 10, params=None)
    D1, I1, st = t.search_stats(xq, 10)
    assert abs(_overlap(I1, gt) - _overlap(np.asarray(I0), gt)) <= 0.01
    assert st.ndis > 0 and I1.dtype == np.int64
    hist = t.degree_histogram()
    assert hist.sum() == len(xb) and len(hist) == 33
    np.testing.assert_array_equal(t.reconstruct(5), xb[5])
    t.hnsw.tile_threshold = 1000                  # the fused tile route
    D2, I2 = t.search(xq, 10, params=SearchParametersHNSW(efSearch=64))
    assert _overlap(I2, gt) >= 0.95
    assert "tiles" in t.build_seconds
    t.hnsw.tile_mode = "beam"
    with pytest.raises(NotImplementedError):
        t.search(xq, 10)
    with pytest.raises(NotImplementedError):
        t.range_search(xq, 1.0)
    with pytest.raises(NotImplementedError):
        t.add(xb[:10])                            # extend_graph waits
