"""IndexIVFPQR of tpu_ann_torch on the CPU: search against the JAX
package's with both codebooks carried over (integer codebooks: (D, I)
equal up to ties at rtol 0), search_preassigned and the per-query stats
against the port's own search (the reference's skip the re-rank), the
distances against exact f32 over the two-level reconstructions, and the
row tables after removals, updates and merges."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.models.ivf_pq import IndexIVFPQR as JPQR
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import SearchParametersIVF as TParams
from tpu_ann_torch.models.ivf_pq import IndexIVFPQR as TPQR
from tpu_ann_torch.models.selectors import IDSelectorBatch as TBatch
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.utils.convert import ivf_pqr_from_reference
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

D, NLIST, K, B = 32, 16, 10, 32


@pytest.fixture(scope="module")
def data():
    x = sift_surrogate(4200, seed=31, **SIFT1M_CALIBRATED)[:, :D].copy()
    xb, xt, xq = x[:3000], x[3000:4100], x[4100:]
    cent = xt[np.random.RandomState(2).choice(len(xt), NLIST, replace=False)]
    return xb, xt, xq, cent


def _port(data, books, rows=None, ids=None):
    xb, xt, _, cent = data
    q = TFlat(D, device="cpu")
    q.add(cent)
    t = TPQR(q, D, NLIST, 8, 8, 4, 8, block_size=B, device="cpu")
    t.quantizer_trains_alone = 1
    t.train(xt)
    t._set_codec(books[0])
    t._set_refine_codec(books[1])
    rows = xb if rows is None else rows
    t.add_with_ids(rows, np.arange(len(rows)) if ids is None else ids)
    return t


@pytest.fixture(scope="module")
def pair(data):
    xb, xt, _, cent = data
    q = JFlat(D)
    q.add(cent)
    j = JPQR(q, D, NLIST, 8, 8, 4, 8, block_size=B)
    j.quantizer_trains_alone = 1
    j.max_list_scan_factor = 0      # the reference's TPU-watchdog cap off
    j.train(xt)
    for pq, attr in ((j.pq, "_pq_cent_dev"),
                     (j.refine_pq, "_refine_cent_dev")):
        pq.centroids = np.round(pq.centroids).astype(np.float32)
        setattr(j, attr, jnp.asarray(pq.centroids))
    j.add(xb)
    books = (j.pq.centroids, j.refine_pq.centroids)
    return j, _port(data, books), books


def _two_level(t, ids):
    """Exact reconstructions: coarse centroid + PQ + refine PQ of rows."""
    rows = np.asarray(ids)
    rec = (t._cent.numpy()[np.arange(8), t._row_codes.numpy()[rows]]
           .reshape(len(rows), D)
           + t._rcent.numpy()[np.arange(4), t._row_refine.numpy()[rows]]
           .reshape(len(rows), D))
    return rec + t._coarse_centroids().numpy()[
        t._row_assign.numpy()[rows]]


def test_search_matches_reference(data, pair):
    xq = data[2]
    j, t, _ = pair
    np.testing.assert_array_equal(t._row_codes.numpy(),
                                  np.asarray(j._row_codes))
    np.testing.assert_array_equal(t._row_refine.numpy(),
                                  np.asarray(j._row_refine))
    before = F.LAUNCHES
    for nprobe in (3, 6):
        D0, I0 = j.search(xq, K, params=JParams(nprobe=nprobe))
        D1, I1 = t.search(xq, K, params=TParams(nprobe=nprobe))
        assert_topk_equal(D0, I0, D1, I1, rtol=0)
        D2, I2, _ = t.search_stats(xq, K, params=TParams(nprobe=nprobe))
        np.testing.assert_array_equal(D2, D1)
        np.testing.assert_array_equal(I2, I1)
    assert F.LAUNCHES == before
    # exact f32 over the two-level reconstructions of the returned rows
    rec = _two_level(t, I1.reshape(-1)).reshape(len(xq), K, D)
    np.testing.assert_allclose(D1, ((rec - xq[:, None]) ** 2).sum(-1),
                               rtol=1e-6)
    assert (np.diff(D1, axis=1) >= 0).all()


def test_preassigned_and_per_query_rerank(data, pair):
    """Every entry point re-ranks: search_preassigned and
    search_stats_per_query return search's (D, I)."""
    xq = data[2][:40]
    _, t, _ = pair
    p = TParams(nprobe=5)
    D0, I0 = t.search(xq, K, params=p)
    probes = t.coarse_assign(xq, 5)
    D1, I1 = t.search_preassigned(xq, K, probes)
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)
    D2, I2, st = t.search_stats_per_query(xq, K, params=p)
    np.testing.assert_allclose(D2, D0, rtol=1e-6)
    assert_topk_equal(D0, I0, D2, I2, rtol=1e-6)
    assert st.per_query.ndis.shape == (len(xq),)


def test_k_factor_and_selector(data, pair):
    xq = data[2]
    _, t, books = pair
    t.k_factor = 1                  # no re-rank room: the PQ order
    D1, I1 = t.search(xq, K, params=TParams(nprobe=4))
    t.k_factor = 4
    D4, I4 = t.search(xq, K, params=TParams(nprobe=4))
    assert (D4[:, 0] <= D1[:, 0] + 1e-3).all()
    sel = TBatch(np.arange(0, 3000, 2))
    Ds, Is = t.search(xq, K, params=TParams(nprobe=4, sel=sel))
    assert (Is % 2 == 0).all()
    even = _port(data, books, rows=data[0][::2], ids=np.arange(0, 3000, 2))
    assert_topk_equal(*even.search(xq, K, params=TParams(nprobe=4)), Ds, Is,
                      rtol=0)


def test_row_tables_follow_mutations(data, pair):
    """remove_ids leaves rows in place (the tables stay valid); an update
    and a merge repack and rebuild them: each equals an index built over
    the resulting rows."""
    xb, _, xq, _ = data
    _, _, books = pair
    t = _port(data, books)
    p = TParams(nprobe=6)
    gone = np.random.RandomState(4).choice(len(xb), 200, replace=False)
    assert t.remove_ids(TBatch(gone)) == 200
    keep = np.setdiff1d(np.arange(len(xb)), gone)
    ref = _port(data, books, rows=xb[keep], ids=keep)
    D1, I1 = t.search(xq, K, params=p)
    assert not np.isin(I1, gone).any()
    assert_topk_equal(*ref.search(xq, K, params=p), D1, I1, rtol=0)
    t.update_vectors(keep[:3], xb[keep[3:6]])
    rows = xb.copy()
    rows[keep[:3]] = xb[keep[3:6]]
    ref = _port(data, books, rows=rows[keep], ids=keep)
    assert_topk_equal(*ref.search(xq, K, params=p),
                      *t.search(xq, K, params=p), rtol=0)
    a = _port(data, books, rows=xb[:1000], ids=np.arange(1000))
    b = _port(data, books, rows=xb[1000:], ids=np.arange(1000, len(xb)))
    a.merge_from(b)
    whole = _port(data, books)
    for x0, x1 in zip(whole.search(xq, K, params=p),
                      a.search(xq, K, params=p)):
        np.testing.assert_array_equal(x1, x0)


def test_ivf_pqr_from_reference(data, pair):
    xq = data[2]
    j, _, _ = pair
    il = j.invlists
    state = {"d": D, "metric": j.metric_type, "nlist": NLIST,
             "ntotal": j.ntotal, "vectors": np.asarray(j.quantizer.vectors),
             "codes": np.asarray(il.codes), "ids": np.asarray(il.ids),
             "list_block_start": np.asarray(il.list_block_start),
             "list_nblocks": np.asarray(il.list_nblocks),
             "ids_flat": np.asarray(j._ids_flat), "M": 8, "nbits": 8,
             "by_residual": True, "pq_centroids": j.pq.centroids,
             "M_refine": 4, "nbits_refine": 8, "k_factor": j.k_factor,
             "refine_centroids": j.refine_pq.centroids,
             "row_codes": np.asarray(j._row_codes),
             "row_refine": np.asarray(j._row_refine),
             "row_assign": np.asarray(j._row_assign)}
    t = ivf_pqr_from_reference(state, device="cpu")
    D0, I0 = j.search(xq, K, params=JParams(nprobe=4))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=4))
    assert_topk_equal(D0, I0, D1, I1, rtol=0)
