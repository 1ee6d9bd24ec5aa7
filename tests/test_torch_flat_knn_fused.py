"""Port parity: tpu_ann_torch.ops.flat_knn_fused (its plain versions of
kernels K1 and K2, on the CPU) against the JAX package's
`ops/flat_knn_pallas.py` run in interpret mode, on the same numpy inputs.

Tolerances:
- integer-valued data (the calibrated SIFT surrogate): bf16 operands are
  exact and every f32 partial sum is an exact integer, and both packages
  let the earlier row / lower lane / lower column win a tie, so (D, I) and
  the selected reservoir entries are equal;
- float data: the two libraries sum in other orders, so a near-tie can
  swap a reservoir lane's winner: ids overlap >= 0.99 and the distances of
  shared ids agree within rtol 1e-5 (both exact f32 re-ranks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import distances as JD
from tpu_ann.ops import flat_knn_pallas as JF
from tpu_ann_torch.ops import flat_knn_fused as F
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate

L2, IP = JD.METRIC_L2, JD.METRIC_INNER_PRODUCT
KW = dict(Q=128, R=1024, W=256, schedule="grid")


@pytest.fixture(scope="module")
def ints():
    x = sift_surrogate(2700, seed=3, **SIFT1M_CALIBRATED)
    rs = np.random.RandomState(4)
    mask = (rs.rand(2600) > 0.3).astype(np.uint8)
    return x[:2600], x[2600:], mask                  # nb % R != 0


def _overlap(I0, I1):
    return float(np.mean([len(set(a) & set(b)) / len(a)
                          for a, b in zip(I0, I1)]))


def _shared_close(D0, I0, D1, I1, rtol):
    for q in range(len(I0)):
        m0 = dict(zip(I0[q], D0[q]))
        m1 = dict(zip(I1[q], D1[q]))
        for i in set(m0) & set(m1):
            if i >= 0:
                np.testing.assert_allclose(m1[i], m0[i], rtol=rtol)


@pytest.mark.parametrize("sel", ["kernel", "exact"])
@pytest.mark.parametrize("variant", ["plain", "valid_n", "id_mask",
                                     "packed"])
def test_integer_refine0_equal(ints, sel, variant):
    xb, xq, mask = ints
    jkw, tkw = {}, {}
    if variant == "valid_n":
        jkw["valid_n"] = tkw["valid_n"] = 2222
    if variant in ("id_mask", "packed"):
        jkw["id_mask"] = jnp.asarray(mask)
        tkw["id_mask"] = torch.from_numpy(mask)
    if variant == "packed":
        jkw["packed"] = JF.pack_flat_db(jnp.asarray(xb), L2, valid_n=2400,
                                        R=1024)
        tkw["packed"] = F.pack_flat_db(torch.from_numpy(xb), L2,
                                       valid_n=2400, R=1024)
    D0, I0 = JF.flat_knn_fused(jnp.asarray(xq), jnp.asarray(xb), 10, L2,
                               refine=0, sel=sel, interpret=True, **KW,
                               **jkw)
    D1, I1 = F.flat_knn_fused(torch.from_numpy(xq), torch.from_numpy(xb),
                              10, L2, refine=0, sel=sel, **KW, **tkw)
    np.testing.assert_array_equal(D1.numpy(), np.asarray(D0))
    np.testing.assert_array_equal(I1.numpy(), np.asarray(I0))
    if variant == "id_mask":
        assert (mask[I1.numpy()] == 1).all()


@pytest.mark.parametrize("metric", [L2, IP])
def test_float_refine4_overlap(metric):
    rs = np.random.RandomState(11)
    xb = rs.randn(3000, 40).astype(np.float32)
    xq = rs.randn(100, 40).astype(np.float32)
    D0, I0 = JF.flat_knn_fused(jnp.asarray(xq), jnp.asarray(xb), 10, metric,
                               refine=4, sel="kernel", interpret=True, **KW)
    D1, I1 = F.flat_knn_fused(torch.from_numpy(xq), torch.from_numpy(xb),
                              10, metric, refine=4, sel="kernel", **KW)
    D0, I0, D1, I1 = np.asarray(D0), np.asarray(I0), D1.numpy(), I1.numpy()
    assert _overlap(I0, I1) >= 0.99
    _shared_close(D0, I0, D1, I1, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 12, 40])
def test_reservoir_topk_on_ties_equal(k):
    rs = np.random.RandomState(k)
    resv = rs.randint(0, 6, size=(70, 256)).astype(np.float32)
    resv[rs.rand(70, 256) < 0.3] = np.inf
    resv[3] = np.inf                               # a dead row
    resv[4, 2:] = np.inf                           # fewer than k finite
    resp = rs.randint(0, 10**6, size=(70, 256)).astype(np.int32)
    v0, p0 = JF.reservoir_topk(jnp.asarray(resv), jnp.asarray(resp), k,
                               interpret=True)
    v1, p1 = F.reservoir_topk(torch.from_numpy(resv), torch.from_numpy(resp),
                              k)
    np.testing.assert_array_equal(v1.numpy(), np.asarray(v0))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(p0))


def test_plain_reservoir_is_the_lane_min():
    """flat_reservoir_reference against the definition, row by row: lane
    j keeps the first of its rows (r = j mod W) with the smallest score."""
    rs = np.random.RandomState(5)
    W, d = 128, 16
    xb = rs.randint(0, 4, size=(1000, d)).astype(np.float32)  # many ties
    xq = rs.randint(0, 4, size=(9, d)).astype(np.float32)
    data, bias = F.pack_flat_db(torch.from_numpy(xb), L2, valid_n=900,
                                R=512)
    qv = torch.zeros((9, 16))
    qv[:, :d] = -2.0 * torch.from_numpy(xq)
    v, p = F.flat_reservoir_reference(qv.bfloat16(), data, bias, W)
    scores = bias.reshape(-1)[None, :].numpy() + \
        qv.numpy() @ data.reshape(-1, 16).float().numpy().T
    for j in range(W):
        s = scores[:, j::W]
        g = np.argmin(s, axis=1)                    # first minimum
        best = s[np.arange(9), g]
        np.testing.assert_array_equal(v[:, j].numpy(), best)
        np.testing.assert_array_equal(
            p[:, j].numpy(), np.where(np.isfinite(best), g * W + j, -1))


@pytest.mark.parametrize("metric,valid_n,unroll", [(L2, None, 1),
                                                    (L2, 1500, 2),
                                                    (IP, 1999, 3)])
def test_pack_flat_db_equal(metric, valid_n, unroll):
    # integer rows: the f32 norms are exact in both packages
    rs = np.random.RandomState(6)
    xb = rs.randint(0, 256, size=(2000, 40)).astype(np.float32)
    d0, b0 = JF.pack_flat_db(jnp.asarray(xb), metric, valid_n=valid_n,
                             R=512, unroll=unroll)
    d1, b1 = F.pack_flat_db(torch.from_numpy(xb), metric, valid_n=valid_n,
                            R=512, unroll=unroll)
    assert b1.shape == b0.shape and d1.shape[:2] == d0.shape[:2]
    np.testing.assert_array_equal(b1.numpy(), np.asarray(b0))
    assert np.isinf(b1.numpy()).any()
    np.testing.assert_array_equal(
        d1[..., :40].float().numpy(),
        np.asarray(d0[..., :40].astype(jnp.float32)))
    assert d1.shape[2] == 48 and (d1[..., 40:] == 0).all()


@pytest.mark.parametrize("strategy", [dict(schedule="fori"),
                                      dict(schedule="fori", unroll=2),
                                      dict(schedule="pipe"),
                                      dict(merge="tree")])
def test_loop_strategies_equal_the_reference(ints, strategy):
    """The reference's other loop strategies (its fori / pipe / unrolled
    kernels and the tree merge) compute the reservoir the port's one K1
    computes: (D, I) equal on integer data, with valid_n and unroll baked
    into the pack as the reference's IndexFlat does."""
    xb, xq, _ = ints
    kw = {**KW, **strategy}
    jpack = JF.pack_flat_db(jnp.asarray(xb), L2, valid_n=2500, R=1024,
                            unroll=kw.get("unroll", 1))
    D0, I0 = JF.flat_knn_fused(jnp.asarray(xq), jnp.asarray(xb), 10, L2,
                               packed=jpack, refine=0, sel="kernel",
                               interpret=True, **kw)
    tpack = F.pack_flat_db(torch.from_numpy(xb), L2, valid_n=2500, R=1024,
                           unroll=kw.get("unroll", 1))
    D1, I1 = F.flat_knn_fused(torch.from_numpy(xq), torch.from_numpy(xb), 10,
                              L2, packed=tpack, refine=0, sel="kernel", **kw)
    np.testing.assert_array_equal(D1.numpy(), np.asarray(D0))
    np.testing.assert_array_equal(I1.numpy(), np.asarray(I0))


def test_argument_checks():
    x = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="packed"):
        F.flat_knn_fused(x, x, 2, R=256, W=128, merge="packed",
                         schedule="pipe")
    for kw in (dict(R=384, W=256), dict(R=512, W=192), dict(W=128, R=256,
                                                            k=129)):
        k = kw.pop("k", 2)
        with pytest.raises(ValueError):
            F.flat_knn_fused(x, x, k, **kw)
    with pytest.raises(ValueError):
        F.flat_knn_fused(x, x, 2, R=256, W=128, sel="best")
    packed = F.pack_flat_db(x, R=512)
    with pytest.raises(ValueError):
        F.flat_knn_fused(x, x, 2, R=256, W=128, packed=packed)
    with pytest.raises(ValueError):
        F.flat_knn_fused(x, x, 2, R=512, W=128, packed=packed, valid_n=4)
