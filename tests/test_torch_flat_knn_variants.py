"""Port parity: the fused flat scan's variants in tpu_ann_torch.ops.
flat_knn_fused — K1p (merge="packed") and the B1 probe folds — on the CPU
(their plain versions) against the JAX package run in Pallas interpret
mode, on the same numpy inputs.

Tolerances:
- integer-valued data: bf16 operands are exact and every f32 partial sum
  is an exact integer, so the scores, the shift C and each packed lane are
  equal in both packages: (D, I) and the probes' reservoirs are equal bit
  for bit;
- float data through the exact re-rank: ids overlap >= 0.99.

The B1 merges are defined inside the round-4 harness's main()
(benchs/r4/r4_queue4.py:133-141), so this file keeps its own copies of
merge_min1 and merge_minall and plugs them into the JAX package's
`_flat_kernel_grid` as the harness does."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_ann.ops import distances as JD
from tpu_ann.ops import flat_knn_pallas as JF
from tpu_ann_torch.ops import flat_knn_fused as F
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate

L2, IP = JD.METRIC_L2, JD.METRIC_INNER_PRODUCT
KW = dict(Q=128, R=1024, W=256)


def merge_min1(dis, av, ap, base, W_, lane):
    return jnp.minimum(av, dis[:, :W_]), ap


def merge_minall(dis, av, ap, base, W_, lane):
    for g in range(dis.shape[1] // W_):
        av = jnp.minimum(av, dis[:, g * W_:(g + 1) * W_])
    return av, ap


@pytest.fixture(scope="module")
def ints():
    x = sift_surrogate(2700, seed=3, **SIFT1M_CALIBRATED)
    return x[:2600], x[2600:]                        # nb % R != 0


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("schedule", [dict(schedule="grid"),
                                      dict(schedule="fori", unroll=2)])
def test_packed_equal_the_reference(ints, metric, schedule):
    xb, xq = ints
    kw = {**KW, **schedule}
    D0, I0 = JF.flat_knn_fused(jnp.asarray(xq), jnp.asarray(xb), 10, metric,
                               refine=0, sel="kernel", merge="packed",
                               interpret=True, **kw)
    D1, I1 = F.flat_knn_fused(torch.from_numpy(xq), torch.from_numpy(xb), 10,
                              metric, refine=0, sel="kernel", merge="packed",
                              **kw)
    np.testing.assert_array_equal(D1.numpy(), np.asarray(D0))
    np.testing.assert_array_equal(I1.numpy(), np.asarray(I0))


@pytest.mark.parametrize("metric", [L2, IP])
def test_packed_refine_on_float_data(metric):
    rs = np.random.RandomState(12)
    xb = rs.randn(3000, 40).astype(np.float32)
    xq = rs.randn(100, 40).astype(np.float32)
    kw = dict(KW, schedule="grid", merge="packed", refine=4, sel="kernel")
    _, I0 = JF.flat_knn_fused(jnp.asarray(xq), jnp.asarray(xb), 10, metric,
                              interpret=True, **kw)
    _, I1 = F.flat_knn_fused(torch.from_numpy(xq), torch.from_numpy(xb), 10,
                             metric, **kw)
    I0, I1 = np.asarray(I0), I1.numpy()
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(I0, I1)]) \
        >= 0.99


def test_packed_reservoir_decodes_to_the_serial_one(ints):
    """On integer data whose shifted scores fit 8 significant bits the
    packed lane keeps the exact score, so the decoded reservoir equals
    K1's plain one."""
    rs = np.random.RandomState(8)
    xb = torch.from_numpy(rs.randint(0, 4, size=(2000, 16)).astype(np.float32))
    xq = torch.from_numpy(rs.randint(0, 4, size=(20, 16)).astype(np.float32))
    data, bias = F.pack_flat_db(xb, L2, R=512)
    qv = (-2.0 * xq).bfloat16()
    C = F.packed_shift(xq, xb, False)
    acc = F.flat_reservoir_packed(qv, data, bias + C, 128)
    v, p = F.decode_packed(acc, 128, C)
    v0, p0 = F.flat_reservoir_reference(qv, data, bias, 128)
    np.testing.assert_array_equal(v.numpy(), v0.numpy())
    np.testing.assert_array_equal(p.numpy(), p0.numpy())


def test_packed_group_guard():
    """The group index has 16 bits: more than 65536 groups of W rows
    raise (the reference asserts the same)."""
    W = 128
    data = torch.zeros((1, 1, 16), dtype=torch.bfloat16).expand(
        65537, W, 16)
    bias = torch.zeros((1, 1, 1)).expand(65537, 1, W)
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="16 bits"):
        F.flat_reservoir_packed(x.bfloat16(), data, bias, W)
    with pytest.raises(ValueError, match="16 bits"):
        F.flat_knn_fused(x, x, 2, R=W, W=W, merge="packed",
                         schedule="grid", packed=(data, bias))
    ok = F.pack_flat_db(torch.zeros((4 * W, 16)), R=W)
    F.flat_knn_fused(x, torch.zeros((4 * W, 16)), 2, R=W, W=W,
                     merge="packed", schedule="grid", packed=ok)
    with pytest.raises(ValueError):
        F.flat_knn_fused(x, x, 2, R=W, W=W, merge="packed", schedule="pipe")


def _probe_reference(merge_fn, qv, bias, data, R, W, Q):
    nq, dp = qv.shape
    ntiles = -(-nq // Q)
    nchunks = data.shape[0]
    qv_t = jnp.pad(qv, ((0, ntiles * Q - nq), (0, 0))).reshape(ntiles, Q, dp)
    outv, outp = pl.pallas_call(
        functools.partial(JF._flat_kernel_grid, R=R, W=W, merge_fn=merge_fn),
        grid=(ntiles, nchunks),
        in_specs=[
            pl.BlockSpec((1, Q, dp), lambda t, c: (t, 0, 0)),
            pl.BlockSpec((1, 1, R), lambda t, c: (c, 0, 0)),
            pl.BlockSpec((1, R, dp), lambda t, c: (c, 0, 0)),
        ],
        out_specs=[pl.BlockSpec((1, Q, W), lambda t, c: (t, 0, 0)),
                   pl.BlockSpec((1, Q, W), lambda t, c: (t, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((ntiles, Q, W), jnp.float32),
                   jax.ShapeDtypeStruct((ntiles, Q, W), jnp.int32)],
        interpret=True,
    )(qv_t, bias, data)
    return (np.asarray(outv).reshape(-1, W)[:nq],
            np.asarray(outp).reshape(-1, W)[:nq])


@pytest.mark.parametrize("fold", ["min1", "minall", "serial"])
def test_probe_folds_equal_the_harness(ints, fold):
    """B1's plain folds against `_flat_kernel_grid` with the harness's
    merges (its pre-scale: bf16 queries times -2, d = 128 so both
    packages pad nothing)."""
    xb, xq = ints
    R, W = 1024, 256
    merge = {"min1": merge_min1, "minall": merge_minall,
             "serial": JF._merge_groups}[fold]
    jdata, jbias = JF.pack_flat_db(jnp.asarray(xb), L2, R=R)
    jqv = jnp.asarray(xq).astype(jnp.bfloat16) * -2.0
    v0, p0 = _probe_reference(merge, jqv, jbias, jdata, R, W, Q=64)
    data, bias = F.pack_flat_db(torch.from_numpy(xb), L2, R=R)
    qv = (-2.0 * torch.from_numpy(xq)).bfloat16()
    v1, p1 = F.flat_probe_scan(qv, data, bias, W, fold)
    np.testing.assert_array_equal(v1.numpy(), v0)
    np.testing.assert_array_equal(p1.numpy(), p0)
    if fold != "serial":
        assert (p1.numpy() == -1).all()


def test_probe_min1_folds_one_group_a_chunk():
    """min1 is the lane-min over groups g % (R / W) == 0 only."""
    rs = np.random.RandomState(9)
    xb = torch.from_numpy(rs.randint(0, 8, size=(3000, 16)).astype(np.float32))
    xq = torch.from_numpy(rs.randint(0, 8, size=(5, 16)).astype(np.float32))
    data, bias = F.pack_flat_db(xb, L2, R=512)
    qv = (-2.0 * xq).bfloat16()
    v, _ = F.flat_probe_scan(qv, data, bias, 128, "min1")
    scores = bias.reshape(-1)[None, :] + qv.float() @ \
        data.reshape(-1, 16).float().T
    s = scores.view(5, -1, 128)[:, ::4]                 # gpc = 512 / 128
    np.testing.assert_array_equal(v.numpy(), s.amin(1).numpy())
    with pytest.raises(ValueError):
        F.flat_probe_scan(qv, data, bias, 128, "median")
