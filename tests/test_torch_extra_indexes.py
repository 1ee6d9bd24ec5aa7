"""The long-tail indexes of tpu_ann_torch (models/extra.py: IndexLSH,
IndexRowwiseMinMax, MultiIndexQuantizer, IndexSplitVectors, IndexRandom)
and the k-means extras of ops/kmeans.py against the JAX package's, on the
CPU.

Data: d 32, at most 2000 rows from a numpy seed. Tolerances, as written in
each test: IndexLSH's projection equals the reference's bit for bit; its
codes are equal except where a projection lies within 1e-5 of its
threshold (the two products round apart there; none does on this data);
distances within rtol 1e-5 (the two packages' f32 products round apart),
ids equal up to ties; MultiIndexQuantizer against the enumeration of all
cells within rtol 1e-6; IndexRandom's draws equal."""

import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from tpu_ann.models import extra as JX
from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.ops import kmeans as JK
from tpu_ann_torch.ops import kmeans as TK
from torch_parity import assert_topk_equal

D, NB, NT, NQ, K = 32, 1500, 1000, 40, 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(3)
    xt = rs.randn(NT, D).astype(np.float32)
    xb = rs.randn(NB, D).astype(np.float32)
    xq = rs.randn(NQ, D).astype(np.float32)
    return xt, xb, xq


@pytest.mark.parametrize("nbits,rotate,train", [(64, True, True),
                                                (48, True, False),
                                                (16, False, True)])
def test_lsh(data, nbits, rotate, train):
    """P is the reference's draw; thresholds, codes and search are its;
    range search rounds the radius up; carried across, the same index."""
    xt, xb, xq = data
    j = JX.IndexLSH(D, nbits, rotate, train)
    t = T.IndexLSH(D, nbits, rotate, train, device="cpu")
    np.testing.assert_array_equal(t.P, j.P)
    for idx in (j, t):
        idx.train(xt)
        idx.add(xb)
    np.testing.assert_allclose(t.thresholds, j.thresholds, rtol=1e-5,
                               atol=1e-6)
    proj = xb @ j.P if rotate else xb[:, :nbits]
    sure = (np.abs(proj - j.thresholds) > 1e-5).all(1)
    c0, c1 = j.sa_encode(xb), t.sa_encode(xb)
    np.testing.assert_array_equal(c1[sure], c0[sure])
    assert sure.mean() > 0.99
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert D1.dtype == np.float32
    assert_topk_equal(D0, I0, D1, I1)
    r0, r1 = j.range_search(xq, nbits / 3), t.range_search(xq, nbits / 3)
    np.testing.assert_array_equal(r1[0], r0[0])
    assert r1[1].dtype == np.float32
    c = T.lsh_from_reference({"d": D, "nbits": nbits, "rotate_data": rotate,
                              "train_thresholds": train, "P": j.P,
                              "thresholds": j.thresholds, "codes": c0},
                             device="cpu")
    np.testing.assert_array_equal(c.search(xq, K)[0], D0)
    assert t.sa_code_size() == j.sa_code_size() == nbits // 8


def test_rowwise_minmax(data):
    """The normalized rows are the reference's bit for bit (the same f32
    arithmetic); search through a flat sub-index, reconstruct and the
    carried index (mins, scales) as the reference."""
    xt, xb, xq = data
    j = JX.IndexRowwiseMinMax(JFlat(D))
    t = T.IndexRowwiseMinMax(T.IndexFlat(D, device="cpu"))
    for idx in (j, t):
        idx.train(xt)
        idx.add(xb[:700])
        idx.add(xb[700:])
    xn, mn, sc = t._normalize(xb)
    x0, m0, s0 = j._normalize(xb)
    np.testing.assert_array_equal(xn.numpy(), x0)
    np.testing.assert_array_equal(sc.numpy(), s0)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.reconstruct(11), j.reconstruct(11),
                               rtol=1e-6, atol=1e-6)
    sub = T.IndexFlat(D, device="cpu")
    sub.add(x0)
    c = T.rowwise_minmax_from_reference(
        {"mins": np.concatenate(j._mins), "scales": np.concatenate(
            j._scales)}, sub)
    np.testing.assert_allclose(c.reconstruct(11), j.reconstruct(11),
                               rtol=1e-6, atol=1e-6)
    assert_topk_equal(D0, I0, *c.search(xq, K), rtol=1e-5, atol=1e-6)


def _enumerate(t, xq, k):
    tabs = t.tables(xq)
    full = (tabs[:, 0, :, None] + tabs[:, 1, None, :]).reshape(len(xq), -1)
    return torch.sort(full, dim=1, stable=True).values[:, :k].numpy()


def test_imi_exact_where_the_reference_misses():
    """M = 2: the port's top-k equals the enumeration of all cells; the
    reference's (top ceil(sqrt(4k)) a subspace) does not on this case (d
    16, nbits 6, k 20: 4096 cells)."""
    rs = np.random.RandomState(0)
    xt = rs.randn(5000, 16).astype(np.float32)
    xq = rs.randn(200, 16).astype(np.float32)
    j = JX.MultiIndexQuantizer(16, 2, 6)
    j.train(xt)
    t = T.imi_from_reference({"d": 16, "M": 2, "nbits": 6,
                              "centroids": np.asarray(j.pq.centroids)},
                             device="cpu")
    assert t.ntotal == j.ntotal == 4096
    D0, I0 = j.search(xq, 20)
    D1, I1 = t.search(xq, 20)
    want = _enumerate(t, xq, 20)
    np.testing.assert_allclose(D1, want, rtol=1e-6)
    miss = ~np.isclose(D0, want, rtol=1e-5).all(1)
    assert miss.sum() > 0                   # the reference's fault
    tabs = t.tables(xq).numpy()
    cell = tabs[np.arange(200)[:, None], 0, I1 // 64] + \
        tabs[np.arange(200)[:, None], 1, I1 % 64]
    np.testing.assert_allclose(cell, D1, rtol=1e-6)
    with pytest.raises(RuntimeError):
        t.add(xq)


@pytest.mark.parametrize("M", [1, 3])
def test_imi_other_m(data, M):
    """M = 1 is exact in both; past the second subspace the reference's
    greedy rule (each adds its best cell) is kept."""
    xt, _, xq = data
    j = JX.MultiIndexQuantizer(D if M == 1 else 30, M, 4)
    x = xt if M == 1 else xt[:, :30]
    q = xq if M == 1 else xq[:, :30]
    j.train(x)
    t = T.imi_from_reference({"d": j.d, "M": M, "nbits": 4,
                              "centroids": np.asarray(j.pq.centroids)},
                             device="cpu")
    D0, I0 = j.search(q, 5)
    D1, I1 = t.search(q, 5)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M", [1, 2, 3])
def test_imi_pads_past_its_cells(data, M):
    """At k above the cells a search ranks (nbits 2: 4 cells at M 1, 16 at
    M 2, and at M 3 the first two subspaces' 4 x 4 = 16), the result is
    (nq, k) all the same: the ranked cells first, equal to the k = cells
    search, then id -1 and +inf (faiss's contract)."""
    xt, _, xq = data
    d = 30 if M == 3 else D
    t = T.MultiIndexQuantizer(d, M, 2, device="cpu")
    t.train(xt[:, :d])
    ranked = 4 if M == 1 else 16
    D1, I1 = t.search(xq[:3, :d], 20)
    assert D1.shape == I1.shape == (3, 20)
    assert I1.dtype == np.int64 and D1.dtype == np.float32
    D0, I0 = t.search(xq[:3, :d], ranked)
    np.testing.assert_array_equal(D1[:, :ranked], D0)
    np.testing.assert_array_equal(I1[:, :ranked], I0)
    assert (I1[:, ranked:] == -1).all() and np.isposinf(D1[:, ranked:]).all()
    assert (I0 >= 0).all() and np.isfinite(D0).all()


def test_imi_trains(data):
    xt, _, xq = data
    t = T.MultiIndexQuantizer(D, 2, 4, device="cpu")
    t.train(xt)
    assert t.ntotal == 256
    np.testing.assert_allclose(t.search(xq, 7)[0], _enumerate(t, xq, 7),
                               rtol=1e-6)


def test_split_vectors_and_random(data, monkeypatch):
    """IndexSplitVectors sums its halves' distances as the reference (in
    query chunks of any size); IndexRandom's draws are the reference's."""
    _, xb, xq = data
    j = JX.IndexSplitVectors(D)
    t = T.IndexSplitVectors(D, device="cpu")
    for _ in range(2):
        j.add_sub_index(JFlat(D // 2))
        t.add_sub_index(T.IndexFlat(D // 2, device="cpu"))
    j.add(xb)
    t.add(xb)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    monkeypatch.setattr(T.IndexSplitVectors, "SPLIT_BUDGET", 3 * NB)
    np.testing.assert_array_equal(t.search(xq, K)[1], I1)
    subs = [T.IndexFlat(D // 2, device="cpu") for _ in range(2)]
    subs[0].add(xb[:, :D // 2])
    subs[1].add(xb[:, D // 2:])
    c = T.split_vectors_from_reference(D, subs)
    np.testing.assert_array_equal(c.search(xq, K)[1], I1)
    jr, tr = JX.IndexRandom(D, 100, 7), T.IndexRandom(D, 100, 7,
                                                      device="cpu")
    for a, b in zip(jr.search(xq, 5), tr.search(xq, 5)):
        np.testing.assert_array_equal(a, b)
    cr = T.random_from_reference({"d": D, "ntotal": 100, "seed": 7},
                                 device="cpu")
    np.testing.assert_array_equal(cr.search(xq, 5)[1], tr.search(xq, 5)[1])


def test_kmeans1d():
    rs = np.random.RandomState(1)
    x = np.concatenate([rs.randn(40) * 0.3, rs.randn(30) * 0.3 + 4,
                        rs.randn(20) + 9])
    c0, a0 = JK.kmeans1d(x, 3)
    c1, a1 = TK.kmeans1d(x, 3)
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_array_equal(a1, a0)


def test_kmeans_object_and_progressive(data):
    """Kmeans and progressive_dim_clustering from the reference's numpy
    draws: on data without empty clusters the runs follow the same path,
    centroids within 1e-4 (the two libraries sum in different orders)."""
    xt, xb, _ = data
    j = JK.Kmeans(D, 20, niter=6, seed=5)
    t = T.Kmeans(D, 20, niter=6, seed=5, device="cpu")
    o0, o1 = j.train(xt), t.train(xt)
    np.testing.assert_allclose(t.centroids, j.centroids, atol=1e-4)
    assert o1 == pytest.approx(o0, rel=1e-5)
    a0, a1 = j.assign(xb), t.assign(xb)
    np.testing.assert_allclose(a1[0], a0[0], rtol=1e-4)
    assert (a1[1] == a0[1]).mean() > 0.99
    with pytest.raises(TypeError):
        T.Kmeans(D, 4, bogus=1)
    cp = JK.ClusteringParameters(niter=5)
    c0, _ = JK.progressive_dim_clustering(xt, 16, cp, levels=3)
    c1, _ = TK.progressive_dim_clustering(xt, 16, TK.ClusteringParameters(
        niter=5), levels=3, device="cpu")
    np.testing.assert_allclose(c1, c0, atol=1e-3)


def test_knn_aliases(data):
    _, xb, xq = data
    q, b = torch.from_numpy(xq), torch.from_numpy(xb)
    for f, m in ((T.knn_l2sqr, T.METRIC_L2),
                 (T.knn_inner_product, T.METRIC_INNER_PRODUCT)):
        np.testing.assert_array_equal(f(q, b, 5)[1].numpy(),
                                      T.knn(q, b, 5, m)[1].numpy())
    np.testing.assert_allclose(T.pairwise_distances(q, b).numpy(),
                               ((xq[:, None] - xb[None]) ** 2).sum(-1),
                               rtol=1e-4, atol=1e-3)
