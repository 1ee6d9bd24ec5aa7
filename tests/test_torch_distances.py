"""Port parity: tpu_ann_torch.ops.distances.knn against the JAX package's
exact knn on the same numpy inputs (both on the CPU).

Tolerance: distances within rtol 1e-5 (both sides are f32, but the two
libraries sum the products in different orders); ids equal up to ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import distances as JD
from tpu_ann_torch.ops import distances as TD
from torch_parity import assert_topk_equal

METRICS = [JD.METRIC_L2, JD.METRIC_INNER_PRODUCT]


def _both(xq, xb, k, metric, **kw):
    D0, I0 = JD.knn(jnp.asarray(xq), jnp.asarray(xb), k, metric, **kw)
    D1, I1 = TD.knn(torch.from_numpy(xq), torch.from_numpy(xb), k, metric,
                    **kw)
    return (np.asarray(D0), np.asarray(I0), D1.numpy(), I1.numpy())


@pytest.mark.parametrize("metric", METRICS)
def test_knn_matches_reference(metric):
    rs = np.random.RandomState(0)
    xb = rs.rand(700, 24).astype(np.float32)
    xq = rs.rand(37, 24).astype(np.float32)
    D0, I0, D1, I1 = _both(xq, xb, 7, metric)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_knn_blocked_and_tiled(metric):
    """Several database blocks and query tiles give the unblocked answer."""
    rs = np.random.RandomState(1)
    xb = rs.rand(500, 16).astype(np.float32)
    xq = rs.rand(50, 16).astype(np.float32)
    D0, I0, _, _ = _both(xq, xb, 5, metric)
    D1, I1 = TD.knn(torch.from_numpy(xq), torch.from_numpy(xb), 5, metric,
                    db_block=64, q_block=16)
    assert_topk_equal(D0, I0, D1.numpy(), I1.numpy(), rtol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_knn_valid_n(metric):
    """Rows at or past valid_n never come back."""
    rs = np.random.RandomState(2)
    xb = rs.rand(300, 16).astype(np.float32)
    xq = rs.rand(20, 16).astype(np.float32)
    D0, I0, D1, I1 = _both(xq, xb, 6, metric, valid_n=123)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    assert I1.max() < 123


@pytest.mark.parametrize("metric", METRICS)
def test_knn_k_above_nb(metric):
    """k > nb pads with the metric's worst value and id -1."""
    rs = np.random.RandomState(3)
    xb = rs.rand(5, 8).astype(np.float32)
    xq = rs.rand(4, 8).astype(np.float32)
    D0, I0, D1, I1 = _both(xq, xb, 9, metric)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    assert (I1[:, 5:] == -1).all()
    assert (D1[:, 5:] == TD.worst_value(metric)).all()


def test_knn_integer_data_exact():
    """On integer-valued data both sides compute exact distances."""
    rs = np.random.RandomState(4)
    xb = rs.randint(0, 256, size=(400, 32)).astype(np.float32)
    xq = rs.randint(0, 256, size=(30, 32)).astype(np.float32)
    D0, I0, D1, I1 = _both(xq, xb, 10, JD.METRIC_L2)
    assert_topk_equal(D0, I0, D1, I1)


def test_knn_rejects_unported_modes():
    """bfloat16, approx and refine_factor are ported; any other compute
    type is refused."""
    x = torch.zeros(4, 8)
    for dtype in ("float16", "int8"):
        with pytest.raises(ValueError):
            TD.knn(x, x, 2, compute_dtype=dtype)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("blocks", [1, 3])
def test_knn_bf16_refine_overlap(metric, blocks):
    """compute_dtype='bfloat16' + approx + refine_factor=4 (the IndexFlat
    fast knobs) against the JAX package's, with valid_n and an id_mask:
    ids overlap >= 0.99 (near-ties of the bf16 pass may differ), and the
    re-ranked exact f32 distances of shared ids within rtol 1e-5."""
    rs = np.random.RandomState(5)
    xb = rs.randn(900, 24).astype(np.float32)
    xq = rs.randn(60, 24).astype(np.float32)
    mask = (rs.rand(900) > 0.25).astype(np.uint8)
    kw = dict(compute_dtype="bfloat16", approx=True, refine_factor=4,
              valid_n=850, db_block=900 // blocks + 1)
    D0, I0 = JD.knn(jnp.asarray(xq), jnp.asarray(xb), 10, metric,
                    id_mask=jnp.asarray(mask), **kw)
    D1, I1 = TD.knn(torch.from_numpy(xq), torch.from_numpy(xb), 10, metric,
                    id_mask=torch.from_numpy(mask), **kw)
    D0, I0, D1, I1 = np.asarray(D0), np.asarray(I0), D1.numpy(), I1.numpy()
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(I0, I1)])
    assert overlap >= 0.99, overlap
    same = I0 == I1
    np.testing.assert_allclose(D1[same], D0[same], rtol=1e-5)
    assert (mask[I1] == 1).all() and I1.max() < 850


def test_knn_bf16_integer_data_exact():
    """On integer data the bf16 operands are exact: the bf16 pass without
    refine gives the exact f32 answer."""
    rs = np.random.RandomState(6)
    xb = rs.randint(0, 256, size=(400, 32)).astype(np.float32)
    xq = rs.randint(0, 256, size=(30, 32)).astype(np.float32)
    D0, I0, _, _ = _both(xq, xb, 10, JD.METRIC_L2)
    D1, I1 = TD.knn(torch.from_numpy(xq), torch.from_numpy(xb), 10,
                    compute_dtype="bfloat16")
    assert_topk_equal(D0, I0, D1.numpy(), I1.numpy())


def test_full_f32_matmul_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
