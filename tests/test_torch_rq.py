"""The additive quantizers of tpu_ann_torch (ops/rq.py, ops/lsq.py and the
flat classes of models/rq.py) against the JAX package's, on the CPU.

Data: the SIFT surrogate cut to d 32 (integer values 0..255), M <= 4 stages
of 4 or 6 bits. Tolerances, as written in each test: training MSE within
1% of the reference's (each package its own k-means and, for LSQ, its own
perturbation stream); with the reference's codebooks carried across, the
beam encode's codes equal on >= 99% of the rows (f32 rounding may flip a
near-tie) and bit-equal on integer codebooks and data, where every sum is
exact in f32; decode, tables and ADC within rtol 1e-5; searches equal up
to ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.models import rq as JM
from tpu_ann.ops import lsq as JL
from tpu_ann.ops import rq as JR
from tpu_ann_torch.models import rq as TM
from tpu_ann_torch.models.selectors import IDSelectorRange as TRange
from tpu_ann_torch.ops import lsq as TL
from tpu_ann_torch.ops import rq as TR
from tpu_ann_torch.utils.convert import aq_from_reference
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

D, K = 32, 10


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
    x = sift_surrogate(4200, seed=8, **SIFT1M_CALIBRATED)[:, :D].copy()
    return x[:2000], x[2000:4000], x[4000:]          # xb, xt, xq


@pytest.fixture(scope="module")
def books(data):
    """The reference's RQ 3 x 4-bit codebooks on xt, and an integer copy."""
    cb = JR.train_rq(data[1], 3, 4, niter=8).codebooks
    return cb, np.round(cb).astype(np.float32)


def _mse(x, rec):
    return float(((np.asarray(x) - np.asarray(rec)) ** 2).sum(1).mean())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["rq", "lsq", "prq", "plsq"])
def test_train_mse_matches_reference(data, kind):
    """Each package trains on the same rows and encodes them with its own
    codec: MSE within 1%."""
    xt = data[1][:1200]
    if kind == "rq":
        jc = JR.train_rq(xt, 3, 4, niter=8)
        tc = TR.train_rq(xt, 3, 4, niter=8, device="cpu")
    elif kind == "lsq":
        jc = JL.train_lsq(xt, 3, 4, train_iters=2)
        tc = TL.train_lsq(xt, 3, 4, train_iters=2, device="cpu")
    else:
        jc = JL.train_product_aq(xt, 2, 2, 4, kind=kind[1:])
        tc = TL.train_product_aq(xt, 2, 2, 4, kind=kind[1:], device="cpu")
    assert tc.codebooks.shape == jc.codebooks.shape
    jb = jnp.asarray(jc.codebooks)
    j_mse = _mse(xt, JR.rq_decode(JR.rq_encode(jnp.asarray(xt), jb), jb))
    tb = _t(tc.codebooks)
    t_mse = _mse(xt, TR.rq_decode(TR.rq_encode(xt, tb), tb).numpy())
    assert abs(t_mse - j_mse) <= 0.01 * j_mse, (t_mse, j_mse)
    if kind.startswith("p"):
        # block-diagonal: each stage lives in its split's 16 dims
        nz = (tc.codebooks != 0).any(1)
        assert not nz[:2, 16:].any() and not nz[2:, :16].any()


@pytest.mark.parametrize("integer", [False, True])
def test_encode_matches_reference(data, books, integer):
    xb = data[0]
    cb = books[integer]
    jb, tb = jnp.asarray(cb), _t(cb)
    j_codes = np.asarray(JR.rq_encode(jnp.asarray(xb), jb, beam=5))
    t_codes = TR.rq_encode(xb, tb, beam=5, chunk=700).numpy()
    same = (j_codes == t_codes).all(1)
    if integer:
        assert same.all()
    else:
        assert same.mean() >= 0.99
    # the top-k beam (the coarse quantizer's primitive)
    je, jc = JR.rq_encode_topk(jnp.asarray(xb[:200]), jb, 6, 8)
    te, tc = TR.rq_encode_topk(xb[:200], tb, 6, 8)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-2)
    if integer:
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_decode_tables_adc(data, books):
    xb, _, xq = data
    cb = books[0]
    jb, tb = jnp.asarray(cb), _t(cb)
    codes = np.asarray(JR.rq_encode(jnp.asarray(xb), jb))
    rec_j = np.asarray(JR.rq_decode(jnp.asarray(codes), jb))
    rec_t = TR.rq_decode(_t(codes), tb).numpy()
    np.testing.assert_allclose(rec_t, rec_j, rtol=1e-5, atol=1e-4)
    lut_j = np.asarray(JR.rq_query_tables(jnp.asarray(xq), jb))
    lut_t = TR.rq_query_tables(_t(xq), tb)
    np.testing.assert_allclose(lut_t.numpy(), lut_j, rtol=1e-5, atol=1e-2)
    norms = (rec_j * rec_j).sum(1).astype(np.float32)
    qn = (xq * xq).sum(1).astype(np.float32)
    dj = np.asarray(JR.rq_adc_scan(jnp.asarray(lut_j), jnp.asarray(codes),
                                   jnp.asarray(norms), jnp.asarray(qn)))
    dt = TR.rq_adc_scan(lut_t, _t(codes), _t(norms), _t(qn)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1.0)
    # the ADC with the stored norm is the L2 to the decoded rows
    exact = ((xq[:, None, :] - rec_j[None]) ** 2).sum(-1)
    np.testing.assert_allclose(dt, exact, rtol=1e-4, atol=2.0)


def test_lsq_encode(data, books):
    """ICM without perturbations is deterministic: bit-equal on integer
    codebooks and data. With them the streams differ, and the encode is
    held to the beam-4 RQ encode it starts from (keep-if-better)."""
    xb = data[0]
    cb = books[1]
    jb, tb = jnp.asarray(cb), _t(cb)
    j0 = np.asarray(JL.lsq_encode(jnp.asarray(xb), jb, jax.random.PRNGKey(0),
                                  icm_iters=3, nperts=0))
    t0 = TL.lsq_encode(xb, tb, None, icm_iters=3, nperts=0, chunk=900)
    np.testing.assert_array_equal(t0.numpy(), j0)
    gen = torch.Generator()
    gen.manual_seed(3)
    t4 = TL.lsq_encode(xb, tb, gen, icm_iters=4, nperts=2)
    rq4 = TR.rq_encode(xb, tb, beam=4)
    err = ((xb - TR.rq_decode(t4, tb).numpy()) ** 2).sum(1)
    err_rq = ((xb - TR.rq_decode(rq4, tb).numpy()) ** 2).sum(1)
    assert (err <= err_rq).all() and err.mean() < err_rq.mean()


def test_update_codebooks_matches_reference(data, books):
    xb = data[0]
    codes = np.asarray(JR.rq_encode(jnp.asarray(xb), jnp.asarray(books[0])))
    j = JL._update_codebooks(xb, codes, 3, 16, 1e-2)
    t = TL.update_codebooks(_t(xb), _t(codes), 3, 16, 1e-2)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-3)


FLAT = [("IndexResidualQuantizer", (3, 4)),
        ("IndexLocalSearchQuantizer", (3, 4)),
        ("IndexProductResidualQuantizer", (2, 2, 4)),
        ("IndexProductLocalSearchQuantizer", (2, 2, 4))]


@pytest.fixture(scope="module")
def flat_pairs(data):
    """Each flat class trained and filled by the reference, and the port's
    index carried over from its arrays."""
    xb, xt, _ = data
    out = {}
    for name, shape in FLAT:
        j = getattr(JM, name)(D, *shape)
        if hasattr(j, "train_iters"):
            j.train_iters = 1
        j.train(xt[:800])
        j.add(xb)
        state = {"cls": name, "d": D, "M": j.M, "nbits": j.nbits,
                 "codebooks": np.asarray(j.rq.codebooks),
                 "codes": np.asarray(j._codes), "norms": np.asarray(j._norms)}
        if len(shape) == 3:
            state.update(nsplits=shape[0], Msub=shape[1])
        out[name] = j, aq_from_reference(state, device="cpu")
    return out


@pytest.mark.parametrize("name", [n for n, _ in FLAT])
def test_flat_search_matches_reference(data, flat_pairs, name):
    xq = data[2]
    j, t = flat_pairs[name]
    assert type(t).__name__ == name and t.M == j.M and t.ntotal == j.ntotal
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5, atol=1e-2)
    assert t.sa_code_size() == j.sa_code_size()


def test_flat_rq_own_encode(data, flat_pairs):
    """The port's own add of the carried codec stores the reference's codes
    on >= 99% of the rows, and norms within rtol 1e-5."""
    xb = data[0]
    j, _ = flat_pairs["IndexResidualQuantizer"]
    t = TM.IndexResidualQuantizer(D, 3, 4, device="cpu")
    t._set_codec(j.rq.codebooks)
    t.add(xb)
    assert (t._codes.numpy() == np.asarray(j._codes)).all(1).mean() >= 0.99
    np.testing.assert_allclose(t._norms.numpy(), np.asarray(j._norms),
                               rtol=1e-5)


def test_flat_sa_range_selector(data, flat_pairs):
    xb, _, xq = data
    j, t = flat_pairs["IndexResidualQuantizer"]
    # sa_encode: stage bytes then the f32 norm; the round trip decodes
    codes_t = t.sa_encode(xb[:300])
    codes_j = j.sa_encode(xb[:300])
    assert codes_t.shape == codes_j.shape == (300, 3 + 4)
    assert (codes_t[:, :3] == codes_j[:, :3]).all(1).mean() >= 0.99
    dec = t.sa_decode(codes_t)
    np.testing.assert_allclose(codes_t[:, 3:].copy().view(np.float32)[:, 0],
                               (dec * dec).sum(1), rtol=1e-5)
    np.testing.assert_allclose(dec, j.sa_decode(codes_t), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(t.reconstruct(5),
                               t.sa_decode(t._codes[5:6].numpy())[0])
    # range search: the exact L2 to the decoded rows (decoded rows repeat,
    # so rows within rtol 1e-5 of the radius may fall either way)
    rec = t.sa_decode(t._codes.numpy())
    dis = ((xq[:20, None, :] - rec[None]) ** 2).sum(-1)
    radius = float(np.quantile(dis, 0.01))
    lims, Dr, Ir = t.range_search(xq[:20], radius)
    for q in range(20):
        got = set(Ir[lims[q]:lims[q + 1]])
        assert set(np.nonzero(dis[q] < radius * (1 - 1e-5))[0]) <= got
        assert got <= set(np.nonzero(dis[q] < radius * (1 + 1e-5))[0])
        np.testing.assert_allclose(Dr[lims[q]:lims[q + 1]],
                                   dis[q][Ir[lims[q]:lims[q + 1]]], rtol=1e-5)
    # a selector (the reference ignores it): only ids in range, and the
    # same order as the search over those rows alone
    from tpu_ann_torch.models.base import SearchParameters

    Ds, Is = t.search(xq, K, params=SearchParameters(sel=TRange(100, 400)))
    assert ((Is >= 100) & (Is < 400)).all()
    sub = TM.IndexResidualQuantizer(D, 3, 4, device="cpu")
    sub._set_codec(t.rq.codebooks)
    sub._codes, sub._norms = t._codes[100:400], t._norms[100:400]
    sub.ntotal = 300
    D2, I2 = sub.search(xq, K)
    assert_topk_equal(D2, I2 + 100, Ds, Is)
