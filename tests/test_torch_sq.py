"""Port parity for the scalar-quantizer codecs (tpu_ann_torch.ops.sq) and
the flat IndexScalarQuantizer (tpu_ann_torch.models.pq) against the JAX
package, on the CPU.

Training runs the same numpy on both sides, so ranges are equal. Encoding
repeats the reference's arithmetic op for op (round half to even on both),
so codes are byte-equal, including the 4- and 6-bit packing at odd d.
Decoding agrees to 1 ulp (rtol 1e-6). The flat index decodes and runs the
exact k-NN: distances within rtol 1e-5 (f32 sums in another order), ids
equal up to ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.models.pq import IndexScalarQuantizer as JSQIndex
from tpu_ann.ops import distances as JD
from tpu_ann.ops import sq as JSQ
from tpu_ann_torch.models.pq import IndexScalarQuantizer as TSQIndex
from tpu_ann_torch.ops import sq as TSQ
from tpu_ann_torch.utils.convert import sq_from_reference
from torch_parity import assert_topk_equal

QTYPES = [TSQ.QT_8BIT, TSQ.QT_8BIT_UNIFORM, TSQ.QT_FP16, TSQ.QT_BF16,
          TSQ.QT_4BIT, TSQ.QT_4BIT_UNIFORM, TSQ.QT_6BIT, TSQ.QT_8BIT_DIRECT,
          TSQ.QT_8BIT_DIRECT_SIGNED]
RANGESTATS = [TSQ.RS_MINMAX, TSQ.RS_MEANSTD, TSQ.RS_QUANTILES]


def _data(qtype, n, d, seed):
    """Values the codec is meant for: bytes for the direct codecs, floats
    (with a few out of the trained range) otherwise."""
    rs = np.random.RandomState(seed)
    if qtype == TSQ.QT_8BIT_DIRECT:
        return rs.randint(0, 256, size=(n, d)).astype(np.float32)
    if qtype == TSQ.QT_8BIT_DIRECT_SIGNED:
        return rs.randint(-128, 128, size=(n, d)).astype(np.float32)
    return (rs.randn(n, d) * rs.uniform(0.5, 4.0, d)).astype(np.float32)


def _bytes(codes):
    """Codes as raw bytes (JAX or torch, any code dtype)."""
    if isinstance(codes, torch.Tensor):
        return codes.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(codes)).view(np.uint8)


def test_constants_match_reference():
    for name in ("QT_8BIT", "QT_8BIT_UNIFORM", "QT_FP16", "QT_BF16",
                 "QT_4BIT", "QT_4BIT_UNIFORM", "QT_6BIT", "QT_8BIT_DIRECT",
                 "QT_8BIT_DIRECT_SIGNED", "RS_MINMAX", "RS_MEANSTD",
                 "RS_QUANTILES"):
        assert getattr(TSQ, name) == getattr(JSQ, name), name


@pytest.mark.parametrize("rangestat", RANGESTATS)
@pytest.mark.parametrize("qtype", QTYPES)
def test_train_sq_matches_reference(qtype, rangestat):
    x = _data(qtype, 500, 12, seed=qtype)
    j = JSQ.train_sq(x, qtype, rangestat=rangestat)
    t = TSQ.train_sq(x, qtype, rangestat=rangestat)
    assert t.code_size == j.code_size
    for name in ("vmin", "vdiff"):
        a, b = getattr(j, name), getattr(t, name)
        if a is None:
            assert b is None, name
        else:
            assert b.dtype == np.float32
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("d", [32, 13])
@pytest.mark.parametrize("qtype", QTYPES)
def test_encode_decode_match_reference(qtype, d):
    xt = _data(qtype, 400, d, seed=1)
    x = _data(qtype, 300, d, seed=2)
    x[:3] *= 3.0                          # some values outside the range
    jc = JSQ.train_sq(xt, qtype)
    tc = TSQ.train_sq(xt, qtype)
    j_codes = JSQ.sq_encode(jnp.asarray(x), jc)
    t_codes = TSQ.sq_encode(torch.from_numpy(x), tc)
    assert t_codes.dtype == tc.code_dtype
    assert t_codes.shape == tuple(j_codes.shape)
    np.testing.assert_array_equal(_bytes(t_codes), _bytes(j_codes))
    j_dec = np.asarray(JSQ.sq_decode(j_codes, jc))
    t_dec = TSQ.sq_decode(t_codes, tc).numpy()
    assert t_dec.shape == (len(x), d)
    np.testing.assert_allclose(t_dec, j_dec, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("d", [5, 6, 7, 8])
def test_bit_packing_matches_reference(d):
    rs = np.random.RandomState(d)
    for bits, jp, ju, tp, tu in ((4, JSQ.pack_4bit, JSQ.unpack_4bit,
                                  TSQ.pack_4bit, TSQ.unpack_4bit),
                                 (6, JSQ.pack_6bit, JSQ.unpack_6bit,
                                  TSQ.pack_6bit, TSQ.unpack_6bit)):
        q = rs.randint(0, 1 << bits, size=(9, d)).astype(np.uint8)
        jb = np.asarray(jp(jnp.asarray(q)))
        tb = tp(torch.from_numpy(q))
        np.testing.assert_array_equal(tb.numpy(), jb)
        np.testing.assert_array_equal(tu(tb, d).numpy(), q)
        np.testing.assert_array_equal(np.asarray(ju(jnp.asarray(jb), d)), q)


@pytest.mark.parametrize("qtype,metric", [(q, JD.METRIC_L2) for q in QTYPES]
                         + [(TSQ.QT_8BIT, JD.METRIC_INNER_PRODUCT),
                            (TSQ.QT_8BIT_DIRECT, JD.METRIC_INNER_PRODUCT)])
def test_index_scalar_quantizer_matches_reference(qtype, metric):
    d, k = 24, 10
    xt, xb, xq = (_data(qtype, n, d, seed=s)
                  for n, s in ((600, 3), (900, 4), (40, 5)))
    j = JSQIndex(d, qtype, metric)
    t = TSQIndex(d, qtype, metric, device="cpu")
    assert t.is_trained == j.is_trained
    assert t.sa_code_size() == j.sa_code_size()
    j.train(xt)
    t.train(xt)
    j.add(xb[:500])
    j.add(xb[500:])
    t.add(xb[:500])
    t.add(xb[500:])
    assert t.ntotal == j.ntotal == len(xb)
    D0, I0 = j.search(xq, k)
    D1, I1 = t.search(xq, k)
    assert D1.dtype == np.float32 and I1.dtype == np.int64
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    # standalone codec: bytes and decodes agree, and decode(encode) round
    # trips through the codes
    c0, c1 = j.sa_encode(xq), t.sa_encode(xq)
    assert c1.dtype == np.uint8
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_allclose(t.sa_decode(c1), j.sa_decode(c0), rtol=1e-6,
                               atol=1e-30)
    np.testing.assert_array_equal(t.sa_encode(t.sa_decode(c1)), c1)
    for key in (0, 7, len(xb) - 1):
        np.testing.assert_allclose(t.reconstruct(key), j.reconstruct(key),
                                   rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("qtype", [TSQ.QT_8BIT, TSQ.QT_BF16, TSQ.QT_6BIT])
def test_sq_from_reference(qtype):
    d, k = 16, 5
    xt, xb, xq = (_data(qtype, n, d, seed=s)
                  for n, s in ((300, 6), (400, 7), (20, 8)))
    j = JSQIndex(d, qtype)
    j.train(xt)
    j.add(xb)
    sq = j.sq
    t = sq_from_reference({"qtype": qtype, "d": d, "vmin": sq.vmin,
                           "vdiff": sq.vdiff, "codes": np.asarray(j._codes)},
                          device="cpu")
    assert t.ntotal == j.ntotal
    D0, I0 = j.search(xq, k)
    D1, I1 = t.search(xq, k)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


def test_empty_and_unported():
    t = TSQIndex(8, TSQ.QT_8BIT, device="cpu")
    with pytest.raises(RuntimeError):
        t.add(np.zeros((2, 8), np.float32))             # untrained
    t.train(np.random.RandomState(0).rand(50, 8))
    D, I = t.search(np.zeros((3, 8), np.float32), 4)
    assert np.isinf(D).all() and (I == -1).all()
    xb = np.random.RandomState(1).rand(10, 8)
    t.add(xb)
    # range_search is ported: the hits of the decoded rows
    lims, Dv, Iv = t.range_search(np.zeros((1, 8), np.float32), 1.0)
    dec = t.sa_decode(t.sa_encode(xb))
    want = np.nonzero((dec * dec).sum(1) < 1.0)[0]
    np.testing.assert_array_equal(Iv, want)
    assert lims.tolist() == [0, len(want)]
    t.reset()
    assert t.ntotal == 0


def test_8bit_decode_is_offset_from_encode_grid():
    """On the SIFT surrogate (integers spanning 0..255 in every dim) the
    QT_8BIT codes are the data itself, yet the reference's decode,
    vmin + (code + 0.5) / 256 * vdiff, returns x * 255/256 + 0.498 (up to
    half a unit off): the recall the codec loses is the decode's. The port
    keeps the reference's arithmetic, in both packages alike."""
    from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate

    x = sift_surrogate(3000, seed=4, **SIFT1M_CALIBRATED)
    codec = TSQ.train_sq(x, TSQ.QT_8BIT)
    np.testing.assert_array_equal(codec.vmin, 0.0)
    full = codec.vdiff == 255.0          # dims whose values span 0..255
    assert full.sum() >= 120
    codes = TSQ.sq_encode(torch.from_numpy(x), codec)
    np.testing.assert_array_equal(codes.numpy()[:, full],
                                  x[:, full].astype(np.uint8))
    dec = TSQ.sq_decode(codes, codec).numpy()[:, full]
    np.testing.assert_allclose(dec, (x[:, full] + 0.5)
                               * np.float32(255 / 256), rtol=1e-6)
    err = dec - x[:, full]
    assert err.max() <= 0.5 and err.min() >= -0.5 and np.abs(err).max() > 0.49
    np.testing.assert_array_equal(
        TSQ.sq_decode(codes, codec).numpy(),
        np.asarray(JSQ.sq_decode(jnp.asarray(codes.numpy()),
                                 JSQ.train_sq(x, JSQ.QT_8BIT))))
