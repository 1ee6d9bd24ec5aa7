"""The contrib tools of tpu_ann_torch (utils/contrib.py) against the JAX
package's, on the CPU: knn_ground_truth, big_batch_search with its
checkpoint and interrupts, MatrixStats, kmin / kmax / bucket_sort /
rand_smooth_vectors, two-level clustering, the invlist permutations and
the DatasetAssign k-means loop.

Data: d 32, at most 3000 rows of small integers from a numpy seed, and IVF
indexes of 16 lists over the same integer centroids in both packages
(quantizer_trains_alone=1), so every distance is exact in f32 in both.
Tolerances, as written in each test: exact paths equal the reference with
distances bit for bit and ids equal up to ties (`assert_topk_equal`);
numpy copies (MatrixStats, bucket_sort, rand_smooth_vectors) bit-equal;
kmin / kmax bit-equal, ties included; two-level clustering and
kmeans_assign within 1% of the reference's k-means objective (their
random streams differ); DatasetAssign's sums within rtol 1e-6 (the order
of the f32 additions differs)."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import IndexIVFFlat as JIVF
from tpu_ann.utils import contrib as JC
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import IndexIVFFlat as TIVF
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.utils import contrib as TC
from tpu_ann_torch.utils.interrupt import (FunctionInterrupt,
                                           InterruptCallback,
                                           InterruptError, TimeoutGuard)
from torch_parity import assert_topk_equal

D, NLIST, K = 32, 16, 10
L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(21)
    xb = rs.randint(0, 256, size=(3000, D)).astype(np.float32)
    xq = rs.randint(0, 256, size=(50, D)).astype(np.float32)
    cent = xb[rs.choice(len(xb), NLIST, replace=False)]
    return xb, xq, cent


def _pair(data, ids=None):
    """(JAX, port) IVF-Flat indexes over the same centroids and rows."""
    xb, _, cent = data
    out = []
    for q, cls, kw in ((JFlat(D), JIVF, {}),
                       (TFlat(D, device="cpu"), TIVF, {"device": "cpu"})):
        q.add(cent)
        idx = cls(q, D, NLIST, **kw)
        idx.max_list_scan_factor = 0
        idx.quantizer_trains_alone = 1
        idx.train(xb[:100])
        if ids is None:
            idx.add(xb)
        else:
            idx.add_with_ids(xb, ids)
        idx.nprobe = 4
        out.append(idx)
    return out


@pytest.fixture(scope="module")
def pair(data):
    return _pair(data)


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("chunk", [700, 3000])
def test_knn_ground_truth(data, metric, chunk):
    """Equal to the reference and to the one-chunk result (distances bit
    for bit, ids up to ties); the stable merge puts the earlier chunk's
    rows first in every tie: over two copies of the same rows, each a
    chunk, each tie group lists the first copy's ids before the
    second's."""
    xb, xq, _ = data
    chunks = [xb[i:i + chunk] for i in range(0, len(xb), chunk)]
    Dj, Ij = JC.knn_ground_truth(xq, iter(chunks), K, metric)
    Dt, It = TC.knn_ground_truth(xq, iter(chunks), K, metric, device="cpu")
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    assert_topk_equal(Dj, Ij, Dt, It)
    D1, I1 = TC.knn_ground_truth(xq, iter([xb]), K, metric, device="cpu")
    assert_topk_equal(D1, I1, Dt, It)
    half = xb[:200]
    D2, I2 = TC.knn_ground_truth(xq, iter([half, half]), 40, metric,
                                 device="cpu")
    for r in range(len(D2)):
        for v in np.unique(D2[r]):
            second = (I2[r][D2[r] == v] >= 200).astype(int)
            assert (np.diff(second) >= 0).all(), (r, I2[r])
    assert (I2[:, 0] < 200).all()
    # k above the rows: padded with the worst value and id -1
    Ds, Is = TC.knn_ground_truth(xq[:3], iter([xb[:4], xb[4:6]]), 8, metric,
                                 device="cpu")
    assert (Is[:, 6:] == -1).all() and np.isinf(Ds[:, 6:]).all()
    assert sorted(Is[0, :6]) == list(range(6))


def test_big_batch_search_equals_search(pair, data):
    """Through search_device with 2 batches in flight and a ragged last
    batch of 2 rows: equal to the port's search bit for bit, and to the
    reference's big_batch_search up to ties."""
    j, t = pair
    _, xq, _ = data
    Dt, It = TC.big_batch_search(t, xq, K, batch_size=16, pipeline_depth=2)
    Ds, Is = t.search(xq, K)
    np.testing.assert_array_equal(Dt, Ds)
    np.testing.assert_array_equal(It, Is)
    Dj, Ij = JC.big_batch_search(j, xq, K, batch_size=16)
    assert_topk_equal(Dj, Ij, Dt, It)


def test_big_batch_search_resumes_and_interrupts(data, tmp_path):
    """An InterruptCallback stops it before batch 2 (the batch before is
    finalized, at depth 1); a second call resumes from the checkpoint and
    equals the uninterrupted run; each package resumes from the other's
    checkpoint; a TimeoutGuard stops it with InterruptError."""
    ids = 5000 + 7 * np.arange(len(data[0]), dtype=np.int64)
    j, t = _pair(data, ids)
    _, xq, _ = data
    full_t = TC.big_batch_search(t, xq, K, batch_size=16)
    full_j = JC.big_batch_search(j, xq, K, batch_size=16)
    ck = str(tmp_path / "bbs.pkl")
    polls = []
    InterruptCallback.set(FunctionInterrupt(
        lambda: polls.append(1) or len(polls) > 2))
    try:
        with pytest.raises(InterruptError):
            TC.big_batch_search(t, xq, K, batch_size=16, pipeline_depth=1,
                                checkpoint_path=ck, checkpoint_freq=1)
    finally:
        InterruptCallback.clear()
    with open(ck, "rb") as f:
        st = pickle.load(f)
    assert set(st) == {"done", "D", "I"}
    np.testing.assert_array_equal(st["done"], [True, False, False, False])
    np.testing.assert_array_equal(st["I"][:16], full_t[1][:16])
    partial = open(ck, "rb").read()
    resumed = TC.big_batch_search(t, xq, K, batch_size=16,
                                  checkpoint_path=ck)
    for a, b in zip(resumed, full_t):
        np.testing.assert_array_equal(a, b)
    # the reference resumes from the port's partial file, and the port
    # from the reference's
    with open(ck, "wb") as f:
        f.write(partial)
    res_j = JC.big_batch_search(j, xq, K, batch_size=16, checkpoint_path=ck)
    assert_topk_equal(*full_j, *res_j)
    ck2 = str(tmp_path / "bbs_ref.pkl")
    JC.big_batch_search(j, xq[:16], K, batch_size=16, checkpoint_path=ck2)
    with open(ck2, "rb") as f:
        st = pickle.load(f)
    st["done"] = np.array([True, False, False, False])
    st["D"] = np.concatenate([st["D"], np.zeros((34, K), np.float32)])
    st["I"] = np.concatenate([st["I"], np.full((34, K), -1, np.int64)])
    with open(ck2, "wb") as f:
        pickle.dump(st, f)
    res_t = TC.big_batch_search(t, xq, K, batch_size=16,
                                checkpoint_path=ck2)
    assert_topk_equal(*full_t, *res_t)
    with TimeoutGuard(0.0):
        with pytest.raises(InterruptError):
            TC.big_batch_search(t, xq, K, batch_size=16)


def test_big_batch_search_without_search_device(data):
    """An index with only search() runs batch by batch."""
    xb, xq, _ = data

    class Plain:
        def __init__(self):
            self.flat = TFlat(D, device="cpu")
            self.flat.add(xb)

        def search(self, x, k):
            return self.flat.search(x, k)

    Dv, Iv = TC.big_batch_search(Plain(), xq, K, batch_size=20)
    Ds, Is = Plain().search(xq, K)
    np.testing.assert_array_equal(Dv, Ds)
    np.testing.assert_array_equal(Iv, Is)


def test_matrix_stats_bit_equal(data):
    def same(x):
        a = dataclasses.asdict(TC.MatrixStats.compute(x))
        assert a == dataclasses.asdict(JC.MatrixStats.compute(x))
        return TC.MatrixStats.compute(x)

    xb = data[0].copy()
    for x in (xb[:500], xb[:0].reshape(0, D)):
        same(x)
    bad = xb[:400].copy()
    bad[0] = 0
    bad[1] = bad[2]
    bad[3, 4] = np.nan
    bad[5, 6] = np.inf
    bad[:, 7] = 2.0
    st = same(bad)
    assert st.n_dup_rows == 1 and st.n_constant_dims == 1
    assert st.n_nan == 1 and st.n_inf == 1 and st.n_zero_rows == 0


def test_kmin_kmax_bucket_sort_smooth():
    """kmin / kmax equal lax.top_k's values and indices, ties included;
    bucket_sort and rand_smooth_vectors are bit-equal copies."""
    rs = np.random.RandomState(0)
    for Dm in (rs.randn(10, 50).astype(np.float32),
               rs.randint(0, 4, (12, 40)).astype(np.float32)):
        for fn in ("kmin", "kmax"):
            vj, ij = getattr(JC, fn)(Dm, 7)
            vt, it = getattr(TC, fn)(Dm, 7, device="cpu")
            np.testing.assert_array_equal(vt, vj)
            np.testing.assert_array_equal(it, ij)
            assert it.dtype == np.int64
    tab = rs.randint(0, 8, 100)
    for a, b in zip(TC.bucket_sort(tab, 8), JC.bucket_sort(tab, 8)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="bucket_sort"):
        TC.bucket_sort(np.array([0, 5, 1]), 3)
    np.testing.assert_array_equal(TC.rand_smooth_vectors(100, 32, seed=3),
                                  JC.rand_smooth_vectors(100, 32, seed=3))


def _objective(xt, cent):
    d2 = ((xt.astype(np.float64)[:, None, :]
           - np.asarray(cent, np.float64)[None]) ** 2).sum(-1)
    return float(d2.min(1).sum())


@pytest.fixture(scope="module")
def clustered():
    """32 well-separated gaussian clusters in d 16, 2400 rows."""
    rs = np.random.RandomState(5)
    mu = rs.randn(32, 16).astype(np.float32) * 6
    lab = rs.randint(0, 32, 2400)
    return (mu[lab] + rs.randn(2400, 16).astype(np.float32)).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["rebalance", "equal", "batched"])
def test_two_level_clustering(clustered, mode):
    """(32, d) centroids whose k-means objective is within 1% of the
    reference's on the same data and mode."""
    kw = {"rebalance": mode == "rebalance", "clustering_niter": 10,
          "batched": mode == "batched"}
    ct = TC.two_level_clustering(clustered, 4, 32, device="cpu", **kw)
    cj = JC.two_level_clustering(clustered, 4, 32, **kw)
    assert ct.shape == (32, 16) and ct.dtype == np.float32
    assert np.isfinite(ct).all()
    ot, oj = _objective(clustered, ct), _objective(clustered, cj)
    assert ot <= oj * 1.01, (ot, oj)
    if mode == "batched":
        with pytest.raises(ValueError, match="batched"):
            TC.two_level_clustering(clustered, 4, 32, batched=True,
                                    device="cpu")


def test_train_ivf_index_with_2level(clustered):
    """The IVF's quantizer gets the two-level centroids (nc1 = sqrt(nlist)
    by default) and the index trains, also under an IndexPreTransform."""
    from tpu_ann_torch.models.ivf import make_ivf_flat
    from tpu_ann_torch.models.transforms import IndexPreTransform, PCAMatrix

    idx = make_ivf_flat(16, 16, device="cpu")
    TC.train_ivf_index_with_2level(idx, clustered, clustering_niter=5)
    assert idx.is_trained and idx.quantizer.ntotal == 16
    idx.add(clustered)
    idx.nprobe = 16
    _, I = idx.search(clustered[:20], 1)
    np.testing.assert_array_equal(I[:, 0], np.arange(20))
    pt = IndexPreTransform(PCAMatrix(16, 8, device="cpu"),
                           make_ivf_flat(8, 16, device="cpu"))
    TC.train_ivf_index_with_2level(pt, clustered, clustering_niter=4)
    assert pt.is_trained and pt.index.quantizer.ntotal == 16


def test_permute_sort_invlists(data):
    """permute_invlists / sort_invlists_by_size leave every search as it
    was, and lay the lists out as the reference's do."""
    j, t = _pair(data)
    _, xq, _ = data
    D0, I0 = t.search(xq, K)
    perm = np.random.RandomState(0).permutation(NLIST)
    TC.permute_invlists(t, perm)
    JC.permute_invlists(j, perm)
    np.testing.assert_array_equal(TC.get_invlist_sizes(t),
                                  np.asarray(JC.get_invlist_sizes(j)))
    D1, I1 = t.search(xq, K)
    np.testing.assert_array_equal(D0, D1)
    np.testing.assert_array_equal(I0, I1)
    pt, pj = TC.sort_invlists_by_size(t), JC.sort_invlists_by_size(j)
    np.testing.assert_array_equal(pt, pj)
    sizes = TC.get_invlist_sizes(t)
    assert (np.diff(sizes) >= 0).all()
    D2, I2 = t.search(xq, K)
    np.testing.assert_array_equal(D0, D2)
    np.testing.assert_array_equal(I0, I2)
    for l in (0, 7, NLIST - 1):
        it, rt = TC.get_invlist(t, l)
        ij, rj = JC.get_invlist(j, l)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(rt, rj)
    with pytest.raises(ValueError, match="permutation"):
        TC.permute_invlists(t, np.zeros(NLIST, np.int64))


def test_dataset_assign(data):
    """assign_to equals the reference's (integer data and centroids:
    assignments and distances bit for bit, sums within rtol 1e-6), with
    and without weights, and through DatasetAssignDispatch."""
    xb, _, cent = data
    x = xb[:1000]
    w = np.random.RandomState(4).rand(len(x)).astype(np.float32)
    for wt in (None, w):
        at, dt, st = TC.DatasetAssign(x, device="cpu").assign_to(cent, wt)
        aj, dj, sj = JC.DatasetAssign(x).assign_to(cent, wt)
        np.testing.assert_array_equal(at, aj)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_allclose(st, sj, rtol=1e-6)
        disp = TC.DatasetAssignDispatch(
            [TC.DatasetAssign(p, device="cpu")
             for p in np.array_split(x, 3)])
        a2, d2, s2 = disp.assign_to(cent, wt)
        np.testing.assert_array_equal(a2, at)
        np.testing.assert_array_equal(d2, dt)
        np.testing.assert_allclose(s2, st, rtol=1e-5, atol=1e-3)
    assert disp.count() == 1000 and disp.dim() == D
    np.testing.assert_array_equal(disp.get_subset([3, 400, 999]),
                                  x[[3, 400, 999]])


def test_kmeans_assign_objective(clustered):
    """kmeans_assign over a DatasetAssign and over three dispatched
    parts: the same trajectory (one host loop), and an objective within
    1% of the reference's at the same seed."""
    ct, stt = TC.kmeans_assign(16, TC.DatasetAssign(clustered, device="cpu"),
                               niter=8, seed=5, return_stats=True)
    cj = JC.kmeans_assign(16, JC.DatasetAssign(clustered), niter=8, seed=5)
    assert stt[-1]["obj"] <= stt[0]["obj"]
    assert _objective(clustered, ct) <= _objective(clustered, cj) * 1.01
    disp = TC.DatasetAssignDispatch(
        [TC.DatasetAssign(p, device="cpu")
         for p in np.array_split(clustered, 3)])
    c2 = TC.kmeans_assign(16, disp, niter=8, seed=5)
    np.testing.assert_allclose(c2, ct, rtol=1e-4, atol=1e-4)


def test_dataset_assign_sparse():
    """The host scipy path is the reference's: equal results, and the
    same k-means trajectory as the dense assigner."""
    sp = pytest.importorskip("scipy.sparse")
    rs = np.random.RandomState(8)
    dense = rs.rand(600, 24).astype(np.float32)
    dense[dense < 0.7] = 0.0
    xs = sp.csr_matrix(dense)
    das = TC.DatasetAssignSparse(xs)
    assert das.count() == 600 and das.dim() == 24
    np.testing.assert_array_equal(das.get_subset([3, 7]), dense[[3, 7]])
    w = rs.rand(600).astype(np.float32)
    for wt in (None, w):
        for a, b in zip(das.assign_to(dense[:8], wt),
                        JC.DatasetAssignSparse(xs).assign_to(dense[:8], wt)):
            np.testing.assert_array_equal(a, b)
    a1, _, s1 = TC.DatasetAssign(dense, device="cpu").assign_to(dense[:8])
    a2, _, s2 = das.assign_to(dense[:8])
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_allclose(s1, s2, rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError):
        TC.DatasetAssignSparse(dense)
