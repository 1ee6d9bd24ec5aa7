"""The scalar-quantizer IVF slice as a whole: tpu_ann_torch's
IndexIVFScalarQuantizer -> train (codec) -> add (encode + packed code
lists) -> search / search_stats against the JAX package's, on the CPU.

Both indexes get the same centroids (a pre-built flat quantizer,
quantizer_trains_alone=1), so they hold the same lists. On the CPU the JAX
index scans query-major (its fused route refuses the CPU backend) and
decodes codes as vmin + (code + 0.5)/256 * vdiff, while the port runs the
fused scan's SQ8 route (the plain version of K3-SQ8 here) on
bias + code * scale. On the integer SIFT surrogate QT_8BIT_DIRECT is
lossless and every score exact on both sides: (D, I) equal up to ties at
rtol 0. QT_8BIT: distances within rtol 1e-5, ids overlapping >= 0.99."""

import numpy as np
import pytest
import torch

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.models.ivf_pq import IndexIVFScalarQuantizer as JIVFSQ
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import SearchParametersIVF as TParams
from tpu_ann_torch.models.ivf_pq import IndexIVFScalarQuantizer as TIVFSQ
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan as TS
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops import sq as TSQ
from tpu_ann_torch.utils.convert import ivf_sq_from_reference
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

D, NLIST, K = 128, 32, 10
L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT


@pytest.fixture(scope="module")
def data():
    x = sift_surrogate(5000, seed=8, **SIFT1M_CALIBRATED)
    xb, xt, xq = x[:4000], x[4000:4900], x[4900:]
    cent = xt[np.random.RandomState(1).choice(len(xt), NLIST, replace=False)]
    return xb, xt, xq, cent


def _build(pkg, data, qtype, metric, chunks=1):
    xb, xt, _, cent = data
    if pkg == "jax":
        quant = JFlat(D, metric)
        quant.add(cent)
        idx = JIVFSQ(quant, D, NLIST, qtype, metric)
    else:
        quant = TFlat(D, metric, device="cpu")
        quant.add(cent)
        idx = TIVFSQ(quant, D, NLIST, qtype, metric, device="cpu")
    idx.quantizer_trains_alone = 1
    idx.train(xt)
    ids = 500 + 2 * np.arange(len(xb), dtype=np.int64)
    for part in np.array_split(np.arange(len(xb)), chunks):
        idx.add_with_ids(xb[part], ids[part])
    return idx


def _overlap(I0, I1):
    return np.mean([len(set(a) & set(b)) / I0.shape[1]
                    for a, b in zip(I0, I1)])


CASES = [(TSQ.QT_8BIT_DIRECT, L2), (TSQ.QT_8BIT_DIRECT, IP),
         (TSQ.QT_8BIT, L2), (TSQ.QT_8BIT, IP)]


@pytest.mark.parametrize("qtype,metric", CASES)
def test_search_matches_reference(data, qtype, metric):
    _, _, xq, _ = data
    j = _build("jax", data, qtype, metric)
    t = _build("torch", data, qtype, metric)
    # the same codec, lists and codes
    if j.sq.vmin is not None:
        np.testing.assert_array_equal(t.sq.vmin, j.sq.vmin)
        np.testing.assert_array_equal(t.sq.vdiff, j.sq.vdiff)
    for name in ("codes", "ids", "list_block_start", "list_nblocks"):
        np.testing.assert_array_equal(getattr(t.invlists, name).numpy(),
                                      np.asarray(getattr(j.invlists, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t.list_sizes, j.list_sizes)
    before = (F.LAUNCHES, F.LAUNCHES_SQ8)
    for nprobe in (4, 8):
        D0, I0 = j.search(xq, K, params=JParams(nprobe=nprobe))
        D1, I1 = t.search(xq, K, params=TParams(nprobe=nprobe))
        assert D1.dtype == np.float32 and I1.dtype == np.int64
        assert I1.min() >= 500                  # user ids, not rows
        if qtype == TSQ.QT_8BIT_DIRECT:
            assert_topk_equal(D0, I0, D1, I1, rtol=0)
        else:
            assert _overlap(I0, I1) >= 0.99
            for q in range(len(xq)):
                m0, m1 = dict(zip(I0[q], D0[q])), dict(zip(I1[q], D1[q]))
                for i in set(m0) & set(m1):
                    np.testing.assert_allclose(m1[i], m0[i], rtol=1e-5)
        D2, I2, st = t.search_stats(xq, K, params=TParams(nprobe=nprobe))
        np.testing.assert_array_equal(D2, D1)
        np.testing.assert_array_equal(I2, I1)
        assert st.nq == len(xq) and st.nlist_visited == len(xq) * nprobe
        assert 0 < st.ndis <= len(xq) * t.ntotal
    assert (F.LAUNCHES, F.LAUNCHES_SQ8) == before     # CPU: plain version


def test_device_holds_codes_only(data):
    """The search scans a zero-copy SQ8 view of the packed uint8 codes: no
    f32 or bf16 copy of the stream exists, and the view is rebuilt only
    when the lists change."""
    t = _build("torch", data, TSQ.QT_8BIT, L2)
    t.search(data[2][:4], K)
    view = t._sq8
    assert isinstance(t.invlists, TS.PackedCodeInvLists)
    assert t.invlists.codes.dtype == view.codes.dtype == torch.uint8
    assert view.codes.data_ptr() == t.invlists.codes.data_ptr()
    assert not hasattr(view, "data") and not hasattr(view, "data_bf16")
    assert view.norms.shape == view.codes.shape[:2]
    t.search(data[2][:4], K)
    assert t._sq8 is view
    t.add(data[0][:10])
    t.search(data[2][:4], K)
    assert t._sq8 is not view


def test_chunked_add_equals_one_add(data):
    _, _, xq, _ = data
    a = _build("torch", data, TSQ.QT_8BIT, L2, chunks=1)
    b = _build("torch", data, TSQ.QT_8BIT, L2, chunks=3)
    for name in ("codes", "ids", "list_block_start", "list_nblocks"):
        np.testing.assert_array_equal(getattr(a.invlists, name).numpy(),
                                      getattr(b.invlists, name).numpy())
    Da, Ia = a.search(xq, K, params=TParams(nprobe=6))
    Db, Ib = b.search(xq, K, params=TParams(nprobe=6))
    np.testing.assert_array_equal(Da, Db)
    np.testing.assert_array_equal(Ia, Ib)


@pytest.mark.parametrize("qtype", [TSQ.QT_4BIT, TSQ.QT_4BIT_UNIFORM,
                                   TSQ.QT_6BIT, TSQ.QT_FP16, TSQ.QT_BF16])
def test_other_qtypes_train_add_but_search_raises(data, qtype):
    xb, xt, xq, _ = data
    j = _build("jax", data, qtype, L2)
    t = _build("torch", data, qtype, L2)
    assert t.ntotal == len(xb)
    # the codes are the reference's, byte for byte
    np.testing.assert_array_equal(
        t.invlists.codes.contiguous().view(torch.uint8).numpy(),
        np.ascontiguousarray(np.asarray(j.invlists.codes)).view(np.uint8))
    # searched through the query-major scan_invlists_sq, as the
    # reference's: D within rtol 1e-5, ids up to ties, ndis equal
    D0, I0, s0 = j.search_stats(xq, K, params=JParams(nprobe=4))
    D1, I1, s1 = t.search_stats(xq, K, params=TParams(nprobe=4))
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    assert s1.ndis == s0.ndis
    D2, I2 = t.search(xq, K, params=TParams(nprobe=4))
    np.testing.assert_array_equal(D2, D1)
    np.testing.assert_array_equal(I2, I1)


@pytest.mark.parametrize("qtype,metric", [(TSQ.QT_8BIT_DIRECT, L2),
                                          (TSQ.QT_8BIT, IP)])
def test_ivf_sq_from_reference(data, qtype, metric):
    """The JAX index's arrays carried over: the port searches the very same
    codes and lists."""
    _, _, xq, _ = data
    j = _build("jax", data, qtype, metric)
    il = j.invlists
    state = {"d": j.d, "metric": j.metric_type, "nlist": j.nlist,
             "ntotal": j.ntotal, "vectors": np.asarray(j.quantizer.vectors),
             "codes": np.asarray(il.codes), "ids": np.asarray(il.ids),
             "list_block_start": np.asarray(il.list_block_start),
             "list_nblocks": np.asarray(il.list_nblocks),
             "ids_flat": np.asarray(j._ids_flat), "qtype": j.qtype,
             "vmin": j.sq.vmin, "vdiff": j.sq.vdiff}
    t = ivf_sq_from_reference(state, device="cpu")
    assert t.ntotal == j.ntotal and t.qtype == qtype
    D0, I0 = j.search(xq, K, params=JParams(nprobe=5))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=5))
    if qtype == TSQ.QT_8BIT_DIRECT:
        assert_topk_equal(D0, I0, D1, I1, rtol=0)
    else:
        assert _overlap(I0, I1) >= 0.99
    with pytest.raises(RuntimeError):
        t.add(data[0][:5])                      # search-only
