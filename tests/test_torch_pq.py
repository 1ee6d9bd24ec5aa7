"""The PQ codec of tpu_ann_torch (ops/pq.py) and the PQ parts of
ops/ivf_scan.py against the JAX package's, on the CPU: encode byte for byte
on integer codebooks (>= 99.9% on float data, every other code a near-tie),
decode bit for bit, the tables, adc_scan and adc_scan_db within rtol 1e-5,
the 4-bit packing byte for byte, train_pq's quantization error within 1%,
the decoded code lists, and the query-major table scan scan_invlists_pq
(the 8-bit table against the reference's scan; the 4-bit one against exact
f32 ADC, since the reference rounds its 4-bit table to bf16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import ivf_scan as JScan
from tpu_ann.ops import pq as JPQ
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan as TScan
from tpu_ann_torch.ops import pq as TPQ
from torch_parity import assert_topk_equal

L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def fdata():
    rs = np.random.RandomState(0)
    x = rs.randn(3000, 32).astype(np.float32)
    j8 = JPQ.train_pq(x, 8, 8, seed=5)
    return x, j8.centroids


@pytest.fixture(scope="module")
def idata():
    """Integer rows and codebooks (|v| <= 256, exact in bf16)."""
    rs = np.random.RandomState(1)
    x = rs.randint(-40, 40, size=(2000, 32)).astype(np.float32)
    c8 = rs.randint(-40, 40, size=(8, 256, 4)).astype(np.float32)
    c4 = rs.randint(-40, 40, size=(16, 16, 2)).astype(np.float32)
    return x, c8, c4


@pytest.mark.parametrize("which", ["c8", "c4"])
def test_encode_decode_integer_codebooks_exact(idata, which):
    x, c8, c4 = idata
    c = c8 if which == "c8" else c4
    a = np.asarray(JPQ.pq_encode(_j(x), _j(c)))
    b = TPQ.pq_encode(_t(x), _t(c)).numpy()
    assert b.dtype == np.uint8
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(
        TPQ.pq_encode_chunked(x, _t(c), chunk=300).numpy(), a)
    np.testing.assert_array_equal(
        TPQ.pq_decode(_t(a), _t(c)).numpy(),
        np.asarray(JPQ.pq_decode(_j(a), _j(c))))


def test_encode_float_data_near_ties_only(fdata):
    x, c = fdata
    a = np.asarray(JPQ.pq_encode(_j(x), _j(c)))
    b = TPQ.pq_encode(_t(x), _t(c)).numpy()
    assert (a == b).mean() >= 0.999
    # every other code is a near-tie: both choices as close to the row
    xs = x.reshape(len(x), 8, 4)
    for r, m in zip(*np.nonzero(a != b)):
        da = ((xs[r, m] - c[m, a[r, m]]) ** 2).sum()
        db = ((xs[r, m] - c[m, b[r, m]]) ** 2).sum()
        assert abs(da - db) <= 1e-4 * max(da, db, 1.0)
    # decode is exact on float codebooks too
    np.testing.assert_array_equal(
        TPQ.pq_decode(_t(a), _t(c)).numpy(),
        np.asarray(JPQ.pq_decode(_j(a), _j(c))))


@pytest.mark.parametrize("nbits", [8, 4])
def test_train_pq_quantization_error(nbits):
    """Same data and seed: the same sample and initial centroids, then
    f32 Lloyd (the reference sums in bf16): MSE within 1%."""
    rs = np.random.RandomState(2)
    x = rs.randn(4000, 32).astype(np.float32)
    M = 8 if nbits == 8 else 16
    j = JPQ.train_pq(x, M, nbits, seed=7)
    t = TPQ.train_pq(x, M, nbits, seed=7, device="cpu")
    assert t.centroids.shape == j.centroids.shape
    assert (t.M, t.nbits, t.ksub, t.dsub) == (M, nbits, 1 << nbits, 32 // M)
    assert t.code_size == j.code_size

    def mse(c):
        codes = JPQ.pq_encode(_j(x), _j(c))
        return float(((np.asarray(JPQ.pq_decode(codes, _j(c))) - x) ** 2)
                     .sum(1).mean())

    assert abs(mse(t.centroids) - mse(j.centroids)) <= 0.01 * mse(
        j.centroids)
    with pytest.raises(ValueError):
        TPQ.train_pq(x[:100], 8, 8, device="cpu")
    with pytest.raises(ValueError):
        TPQ.train_pq(x, 5, 8, device="cpu")


@pytest.mark.parametrize("metric", [L2, IP])
def test_tables_and_adc(fdata, metric):
    x, c = fdata
    xq, codes = x[:37], np.asarray(JPQ.pq_encode(_j(x), _j(c)))
    lj = np.asarray(JPQ.query_tables(_j(xq), _j(c), metric))
    lt = TPQ.query_tables(_t(xq), _t(c), metric).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TPQ.query_tables_ip(_t(xq), _t(c)).numpy(),
        np.asarray(JPQ.query_tables_ip(_j(xq), _j(c))), rtol=1e-5,
        atol=1e-5)
    cl = x[100:116]
    np.testing.assert_allclose(
        TPQ.precomputed_tables(_t(cl), _t(c)).numpy(),
        np.asarray(JPQ.precomputed_tables(_j(cl), _j(c))), rtol=1e-5,
        atol=1e-5)
    sj = np.asarray(JPQ.sdc_tables(_j(c)))
    st = TPQ.sdc_tables(_t(c))
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        TPQ.sdc_query_tables(_t(codes[:37]), _t(sj)).numpy(),
        np.asarray(JPQ.sdc_query_tables(_j(codes[:37]), _j(sj))))
    # the ADC sums on the same table
    per_q = codes[:37 * 50].reshape(37, 50, 8)
    np.testing.assert_allclose(
        TPQ.adc_scan(_t(lj), _t(per_q)).numpy(),
        np.asarray(JPQ.adc_scan(_j(lj), _j(per_q))), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        TPQ.adc_scan_db(_t(lj), _t(codes)).numpy(),
        np.asarray(JPQ.adc_scan_db(_j(lj), _j(codes))), rtol=1e-5,
        atol=1e-4)


def test_pack_4bit_roundtrip():
    rs = np.random.RandomState(3)
    codes = rs.randint(0, 16, size=(300, 16)).astype(np.uint8)
    pj = np.asarray(JPQ.pack_codes_4bit(_j(codes)))
    pt = TPQ.pack_codes_4bit(_t(codes)).numpy()
    np.testing.assert_array_equal(pt, pj)
    assert pt.shape == (300, 8) and (pt[:, 0] & 0x0F == codes[:, 0]).all()
    np.testing.assert_array_equal(TPQ.unpack_codes_4bit(_t(pj)).numpy(),
                                  codes)
    np.testing.assert_array_equal(
        TPQ.unpack_codes_4bit(_t(pj.reshape(10, 30, 8))).numpy(),
        np.asarray(JPQ.unpack_codes_4bit(_j(pj.reshape(10, 30, 8)))))


def _code_lists(x, c, cent, nbits, residual=True, B=32):
    """(JAX, port) packed code lists of x's codes over coarse centroids
    ``cent``, and the assignment."""
    a = ((x[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
    r = x - cent[a] if residual else x
    codes = np.asarray(JPQ.pq_encode(_j(r), _j(c)))
    if nbits == 4:
        codes = np.asarray(JPQ.pack_codes_4bit(_j(codes)))
    ids = np.arange(len(x))
    jl = JScan.pack_code_invlists(codes, ids, a, len(cent), B)
    tl = TScan.pack_code_invlists(codes, ids, a, len(cent), B, device="cpu")
    np.testing.assert_array_equal(tl.codes.numpy(), np.asarray(jl.codes))
    return jl, tl, a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_code_invlists(idata, dtype):
    """The decoded cache: norms from the f32 decode, rows rounded to the
    cache dtype in ``data`` and ``data_bf16`` alike (one tensor for
    bf16)."""
    x, c8, _ = idata
    cent = x[:12] * 2
    jl, tl, _ = _code_lists(x, c8, cent, 8)
    jd = JScan.decode_code_invlists(jl, _j(c8), _j(cent),
                                    dtype=jnp.dtype(dtype))
    td = TScan.decode_code_invlists(tl, _t(c8), _t(cent),
                                    dtype=getattr(torch, dtype))
    ref = np.asarray(jd.data.astype(jnp.float32))
    np.testing.assert_array_equal(td.data.float().numpy(), ref)
    assert (td.data is td.data_bf16) == (dtype == "bfloat16")
    np.testing.assert_array_equal(td.data_bf16.float().numpy(),
                                  np.asarray(jd.data.astype(jnp.bfloat16)
                                             .astype(jnp.float32)))
    np.testing.assert_array_equal(td.norms.numpy(), np.asarray(jd.norms))
    assert td.ids is tl.ids
    # a float decode on residual codes is an exact sum as well
    jf = JScan.decode_code_invlists(jl, _j(c8 + 0.25), _j(cent))
    tf = TScan.decode_code_invlists(tl, _t(c8 + 0.25), _t(cent))
    np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data))
    np.testing.assert_allclose(tf.norms.numpy(), np.asarray(jf.norms),
                               rtol=1e-6)


@pytest.mark.parametrize("metric,residual", [(L2, True), (L2, False),
                                             (IP, True)])
def test_scan_invlists_pq_8bit(fdata, metric, residual):
    x, c = fdata
    cent = x[np.random.RandomState(4).choice(len(x), 16, replace=False)]
    jl, tl, _ = _code_lists(x, c, cent, 8, residual and metric == L2)
    xq = x[:40] + 0.1
    probes = np.stack([np.random.RandomState(i).choice(16, 4, replace=False)
                       for i in range(40)]).astype(np.int32)
    probes[::7, -1] = -1
    mask = (np.arange(len(x)) % 3 != 0).astype(np.uint8)
    for m in (None, mask):
        D0, I0, n0 = JScan.scan_invlists_pq(
            _j(xq), _j(probes), jnp.zeros(probes.shape), jl, _j(c),
            _j(cent), 10, metric, by_residual=residual, max_nblocks=8,
            id_mask=None if m is None else _j(m))
        D1, I1, n1 = TScan.scan_invlists_pq(
            _t(xq), _t(probes), tl, _t(c), _t(cent), 10, metric,
            by_residual=residual, max_nblocks=8,
            id_mask=None if m is None else _t(m))
        assert_topk_equal(np.asarray(D0), np.asarray(I0), D1.numpy(),
                          I1.numpy(), rtol=1e-5, atol=1e-4)
        assert int(n1) == int(n0)


def test_scan_invlists_pq_4bit_is_exact_adc(idata):
    """The 4-bit table sums in f32: equal to exact ADC over the decoded
    rows of the probed lists (the reference rounds the table to bf16, so
    it is held to an overlap only)."""
    x, _, c4 = idata
    xf = x + np.random.RandomState(5).rand(*x.shape).astype(np.float32)
    cent = xf[:16]
    jl, tl, a = _code_lists(xf, c4 + 0.5, cent, 4)
    codes = TPQ.unpack_codes_4bit(_t(np.asarray(jl.codes)))
    xq = xf[:30] + 0.3
    probes = np.stack([np.random.RandomState(i).choice(16, 5, replace=False)
                       for i in range(30)]).astype(np.int32)
    D1, I1, _ = TScan.scan_invlists_pq(
        _t(xq), _t(probes), tl, _t(c4 + 0.5), _t(cent), 10, L2,
        max_nblocks=tl.max_nblocks_per_list, packed4=True)
    # exact f32 ADC: decoded residual + centroid against the query
    rec = (TPQ.pq_decode(_t(np.asarray(JPQ.pq_encode(
        _j(xf - cent[a]), _j(c4 + 0.5)))), _t(c4 + 0.5)).numpy()
        + cent[a])
    for q in range(len(xq)):
        rows = np.nonzero(np.isin(a, probes[q]))[0]
        dis = ((rec[rows] - xq[q]) ** 2).sum(1)
        o = np.argsort(dis, kind="stable")[:10]
        np.testing.assert_allclose(D1[q].numpy(), dis[o], rtol=1e-5)
        assert len(set(I1[q].tolist()) & set(rows[o].tolist())) >= 9
    assert codes.shape[-1] == 16
    D0, I0, _ = JScan.scan_invlists_pq(
        _j(xq), _j(probes), jnp.zeros(probes.shape), jl, _j(c4 + 0.5),
        _j(cent), 10, L2, max_nblocks=tl.max_nblocks_per_list,
        packed4=True)
    ov = np.mean([len(set(a0) & set(a1)) / 10
                  for a0, a1 in zip(np.asarray(I0), I1.numpy())])
    assert ov >= 0.95
