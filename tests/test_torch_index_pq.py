"""IndexPQ of tpu_ann_torch against the JAX package's, on the CPU, with the
reference's codebooks carried over (`pq_from_reference`): the codes byte
for byte, ST_PQ through the bf16 decoded cache (8-bit; (D, I) equal at rtol
0 on integer codebooks), through the table scan (4-bit and
use_decoded_cache=False; rtol 1e-5), ST_SDC, range_search as sets, the
standalone codec, and the refusals (polysemous, untrained, empty)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_ann.models.pq import IndexPQ as JPQIndex
from tpu_ann_torch.models.pq import IndexPQ as TPQIndex
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.utils.convert import pq_from_reference
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

D, K = 32, 10
L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT


@pytest.fixture(scope="module")
def data():
    x = sift_surrogate(3000, seed=21, **SIFT1M_CALIBRATED)[:, :D].copy()
    return x[:2500], x[2500:2900], x[2900:]


def _pair(data, M, nbits, metric=L2, integer=True):
    """(JAX, port) IndexPQ with the same codebook (the JAX one's, rounded
    to integers when ``integer``) and rows."""
    xb, xt, _ = data
    j = JPQIndex(D, M, nbits, metric)
    j.train(xt)
    if integer:
        j.pq.centroids = np.round(j.pq.centroids).astype(np.float32)
        j._centroids_dev = jnp.asarray(j.pq.centroids)
    j.add(xb)
    t = pq_from_reference(
        {"d": D, "M": M, "nbits": nbits, "metric": metric,
         "centroids": j.pq.centroids,
         "codes": np.asarray(j._codes[:j.ntotal])}, device="cpu")
    return j, t


@pytest.mark.parametrize("nbits,M,metric,cache", [
    (8, 8, L2, True), (8, 8, IP, True), (8, 8, L2, False),
    (4, 16, L2, None), (4, 16, IP, None)])
def test_search_matches_reference(data, nbits, M, metric, cache):
    xb, _, xq = data
    j, t = _pair(data, M, nbits, metric)
    assert t.ntotal == j.ntotal == len(xb)
    np.testing.assert_array_equal(t.sa_encode(xb), j.sa_encode(xb))
    if cache is False:
        j.use_decoded_cache = t.use_decoded_cache = False
    assert t._cache_enabled() == j._cache_enabled() == bool(cache)
    before = F.LAUNCHES
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert F.LAUNCHES == before
    assert D1.dtype == np.float32 and I1.dtype == np.int64
    # integer codebooks: the cache's bf16 product and the tables are exact
    assert_topk_equal(D0, I0, D1, I1, rtol=0 if cache else 1e-5,
                      atol=0 if cache else 1e-2)


def test_float_codebook_and_sdc(data):
    xb, _, xq = data
    j, t = _pair(data, 8, 8, integer=False)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    ov = np.mean([len(set(a) & set(b)) / K for a, b in zip(I0, I1)])
    assert ov >= 0.99
    np.testing.assert_allclose(D1, D0, rtol=1e-5)
    for idx in (j, t):
        idx.search_type = idx.ST_SDC
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5, atol=1e-2)


def test_range_codec_and_reconstruct(data):
    xb, _, xq = data
    j, t = _pair(data, 8, 8)
    r = float(np.median(t.search(xq, 20)[0][:, -1]))
    l0, d0, i0 = j.range_search(xq, r)
    l1, d1, i1 = t.range_search(xq, r)
    np.testing.assert_array_equal(l1, l0)
    for q in range(len(xq)):
        a = dict(zip(i0[l0[q]:l0[q + 1]], d0[l0[q]:l0[q + 1]]))
        b = dict(zip(i1[l1[q]:l1[q + 1]], d1[l1[q]:l1[q + 1]]))
        assert a.keys() == b.keys()
        np.testing.assert_allclose([b[i] for i in a], list(a.values()),
                                   rtol=1e-5)
    codes = j.sa_encode(xq)
    assert t.sa_code_size() == j.sa_code_size() == 8
    np.testing.assert_array_equal(t.sa_decode(codes), j.sa_decode(codes))
    np.testing.assert_array_equal(t.reconstruct(17), j.reconstruct(17))
    with pytest.raises(KeyError):
        t.reconstruct(t.ntotal)


def test_train_add_and_refusals(data):
    xb, xt, xq = data
    t = TPQIndex(D, 8, 8, device="cpu")
    with pytest.raises(RuntimeError):
        t.add(xb)
    Dv, Iv = t.search(xq, K)                    # empty: worst value, -1
    assert np.isinf(Dv).all() and (Iv == -1).all()
    t.train(xt)
    t.add(xb[:1000])
    t.add(xb[1000:])                            # the cache follows adds
    assert t._dec.shape[0] == t.ntotal == len(xb)
    one = TPQIndex(D, 8, 8, device="cpu")
    one._set_codec(t.pq.centroids)
    one.add(xb)
    for a, b in zip(t.search(xq, K), one.search(xq, K)):
        np.testing.assert_array_equal(a, b)
    # ST_POLYSEMOUS with the filter off (ht 0) equals the table scan of
    # ST_PQ, and do_polysemous_training permutes the trained codebook
    t.use_decoded_cache = False
    D_pq, I_pq = t.search(xq, K)
    t.search_type = t.ST_POLYSEMOUS
    D_p, I_p = t.search(xq, K)
    np.testing.assert_array_equal(D_p, D_pq)
    np.testing.assert_array_equal(I_p, I_pq)
    assert t.last_hamming_pass == len(xq) * t.ntotal
    t.polysemous_ht = 24
    D_h, I_h = t.search(xq, K)
    assert 0 < t.last_hamming_pass < len(xq) * t.ntotal
    poly = TPQIndex(D, 8, 8, device="cpu")
    poly.do_polysemous_training = True
    poly.polysemous_iters = 300
    poly.train(xt)
    plain = TPQIndex(D, 8, 8, device="cpu")
    plain.train(xt)
    a, b = poly.pq.centroids, plain.pq.centroids
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(np.sort(a, axis=1), np.sort(b, axis=1))
    t.reset()
    assert t.ntotal == 0 and t._dec is None
