"""Hamming operators (ops/hamming.py) and polysemous PQ (ops/polysemous.py,
IndexPQ's ST_POLYSEMOUS) of tpu_ann_torch against the JAX package's, on
the CPU. Everything here is integer or a copy of the reference's host
numpy: distances, ids, permutations and pass counts are held equal, and
ADC distances to rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import hamming as JH
from tpu_ann.ops import polysemous as JP
from tpu_ann.ops import pq as JPQ
from tpu_ann_torch.models.base import SearchParameters
from tpu_ann_torch.models.pq import IndexPQ as TPQIndex
from tpu_ann_torch.models.selectors import IDSelectorRange as TRange
from tpu_ann_torch.ops import hamming as TH
from tpu_ann_torch.ops import polysemous as TP
from tpu_ann_torch.ops import pq as TPQ

D, K = 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small torch ops on the CPU: one intra-op thread
    keeps them from oversubscribing the cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(5)
    return (rs.randn(3000, D).astype(np.float32),
            rs.randn(50, D).astype(np.float32))


@pytest.fixture(scope="module")
def codec(data):
    """PQ4x6 trained by the reference, permuted by its annealing."""
    pq = JPQ.train_pq(data[0], 4, 6, niter=5)
    return JP.optimize_pq_for_hamming(pq.centroids, n_iter=400)


@pytest.mark.parametrize("nbytes", [1, 5, 8, 13])
def test_knn_hamming_matches_reference(nbytes):
    rs = np.random.RandomState(nbytes)
    xb = rs.randint(0, 256, (700, nbytes)).astype(np.uint8)
    xq = rs.randint(0, 256, (30, nbytes)).astype(np.uint8)
    np.testing.assert_array_equal(
        TH.hamming_distances(torch.from_numpy(xq),
                             torch.from_numpy(xb)).numpy(),
        np.asarray(JH.hamming_distances(jnp.asarray(xq), jnp.asarray(xb))))
    D0, I0 = JH.knn_hamming(jnp.asarray(xq), jnp.asarray(xb), 7,
                            db_block=256)
    D1, I1 = TH.knn_hamming(torch.from_numpy(xq), torch.from_numpy(xb), 7,
                            db_block=300)
    np.testing.assert_array_equal(D1.numpy(), np.asarray(D0))
    np.testing.assert_array_equal(I1.numpy(), np.asarray(I0))
    bits = rs.randint(0, 2, (20, 8 * nbytes))
    pj = np.asarray(JH.pack_bits(jnp.asarray(bits)))
    pt = TH.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(TH.unpack_bits(pt).numpy(),
                                  np.asarray(JH.unpack_bits(jnp.asarray(pj))))


def test_optimize_pq_for_hamming_equals_reference(data):
    pq = JPQ.train_pq(data[0], 2, 5, niter=4)
    j = JP.optimize_pq_for_hamming(pq.centroids, n_iter=1500, seed=9)
    t = TP.optimize_pq_for_hamming(pq.centroids, n_iter=1500, seed=9)
    np.testing.assert_array_equal(t, j)
    assert not np.array_equal(t, pq.centroids)     # it did permute


@pytest.mark.parametrize("ht", [4, 9, 25])
def test_polysemous_knn_matches_reference(data, codec, ht):
    xb, xq = data
    cj = jnp.asarray(codec)
    codes = np.asarray(JPQ.pq_encode(jnp.asarray(xb), cj))
    D0, I0, n0 = JP.polysemous_knn(jnp.asarray(xq), jnp.asarray(codes), cj,
                                   K, ht, jnp.int32(len(xb)), db_block=1024)
    D1, I1, n1 = TP.polysemous_knn(torch.from_numpy(xq),
                                   torch.from_numpy(codes),
                                   torch.from_numpy(codec), K, ht,
                                   db_block=1024)
    np.testing.assert_array_equal(I1.numpy(), np.asarray(I0))
    np.testing.assert_allclose(D1.numpy(), np.asarray(D0), rtol=1e-6)
    np.testing.assert_array_equal(n1, np.asarray(n0).astype(np.int64))


def test_index_pq_polysemous(data, codec):
    """ST_POLYSEMOUS with the filter off (ht 0 = M nbits + 1) equals ST_PQ's
    table scan; under a threshold every returned distance is the ADC
    distance of its id, and the pass count grows with ht."""
    xb, xq = data
    t = TPQIndex(D, 4, 6, device="cpu")
    t._set_codec(codec)
    t.use_decoded_cache = False
    t.add(xb)
    D_pq, I_pq = t.search(xq, K)
    t.search_type = t.ST_POLYSEMOUS
    D0, I0 = t.search(xq, K)
    np.testing.assert_array_equal(D0, D_pq)
    np.testing.assert_array_equal(I0, I_pq)
    assert t.last_hamming_pass == len(xq) * len(xb)
    lut = TPQ.query_tables(torch.from_numpy(xq), t._cent)
    adc = TPQ.adc_scan_db(lut, t._codes).numpy()
    last = 0
    for ht in (6, 10, 14):
        t.polysemous_ht = ht
        Dv, Iv = t.search(xq, K)
        ok = Iv >= 0
        np.testing.assert_array_equal(
            Dv[ok], adc[np.nonzero(ok)[0], Iv[ok]])
        assert last < t.last_hamming_pass < len(xq) * len(xb)
        last = t.last_hamming_pass
    Ds, Is = t.search(xq, K, params=SearchParameters(sel=TRange(0, 900)))
    assert (Is < 900).all()


@pytest.mark.parametrize("dense_share", [0.0, 1.0])
@pytest.mark.parametrize("nbits,ht", [(6, 9), (4, 5), (4, 8)])
def test_compacted_pairs_equal_dense_filter(data, monkeypatch, nbits, ht,
                                            dense_share):
    """polysemous_knn scores only the pairs that pass (DENSE_SHARE 1: every
    block) or each block densely (DENSE_SHARE 0); its (D, I) and pass
    counts equal the dense form (the ADC of every code, the rejected ones
    set to inf, one stable sort), bit for bit, with 4-bit packed codes, a
    selector's mask and the pairs split over steps."""
    monkeypatch.setattr(TP, "PAIR_CHUNK", 37)
    monkeypatch.setattr(TP, "DENSE_SHARE", dense_share)
    xb, xq = data
    rs = np.random.RandomState(nbits + ht)
    cent = torch.from_numpy(rs.randn(4, 1 << nbits, D // 4)
                            .astype(np.float32))
    codes = TPQ.pq_encode(torch.from_numpy(xb), cent)
    packed4 = nbits == 4
    stored = TPQ.pack_codes_4bit(codes) if packed4 else codes
    mask = torch.from_numpy((rs.rand(len(xb)) < 0.8).astype(np.uint8))
    q = torch.from_numpy(xq)
    D1, I1, n1 = TP.polysemous_knn(q, stored, cent, K, ht, 2900,
                                   db_block=700, packed4=packed4,
                                   id_mask=mask)
    qc = TPQ.pq_encode(q, cent)
    ok = (TH.hamming_distances(qc, codes) <= ht) & \
        (torch.arange(len(xb)) < 2900) & (mask != 0)
    dense = torch.where(ok, TPQ.adc_scan_db(TPQ.query_tables(q, cent),
                                            codes), float("inf"))
    D0, pos = torch.sort(dense, dim=1, stable=True)
    D0, I0 = D0[:, :K], torch.where(torch.isfinite(D0[:, :K]), pos[:, :K],
                                    -1)
    assert 0 < int(ok.sum()) < ok.numel() // 2
    np.testing.assert_array_equal(D1.numpy(), D0.numpy())
    np.testing.assert_array_equal(I1.numpy(), I0.numpy())
    assert int(n1.sum()) == int(ok.sum())
