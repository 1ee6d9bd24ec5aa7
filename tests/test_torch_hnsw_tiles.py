"""Port parity: tpu_ann_torch.ops.hnsw_tiles (the fused tile layout and the
graph-accelerated tile search, whose scans go through the fused IVF scan's
plain version on the CPU) against the JAX package, its Pallas scan in
interpret mode, on the same numpy inputs and the same level-0 graph.

Tolerances:
- build_tiles_fused: every integer array and the packed rows byte-equal,
  the tile centroids within rtol 1e-6;
- tile_search_fused on integer data (the SIFT surrogate): every bf16 score
  and the exact re-rank are exact on both sides, so (D, I) are equal up to
  ties at the cut; on float data the ids overlap >= 0.99."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import distances as JD
from tpu_ann.ops import hnsw as JH
from tpu_ann.ops import hnsw_tiles as JT
from tpu_ann_torch.ops import hnsw_tiles as HT
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

L2, IP = JD.METRIC_L2, JD.METRIC_INNER_PRODUCT
CPU = torch.device("cpu")
B = 128


_CACHE = {}


def _setup(xb, metric):
    """The tile layouts of both packages over xb (cached per data and
    metric: the graph build dominates these tests' time)."""
    key = (id(xb), metric)
    if key not in _CACHE:
        _CACHE[key] = _build(xb, metric)
    return _CACHE[key]


def _build(xb, metric):
    levels = JH.random_levels(len(xb), 8, 1234)
    jg, _ = JH.build_graph_knn(jnp.asarray(xb), 8, 40, levels=levels,
                               metric=metric)
    nbr = np.array(jg.neighbors0)
    order = HT.spatial_order(xb, B, device=CPU)
    jt = JT.build_tiles_fused(xb, nbr, order=order, b=B)
    tt = HT.build_tiles_fused(xb, nbr, order=order, b=B, device=CPU)
    return jt, tt


@pytest.fixture(scope="module")
def ints():
    x = sift_surrogate(2660, seed=12, **SIFT1M_CALIBRATED)
    return x[:2600], x[2600:]                        # n % B != 0


@pytest.fixture(scope="module")
def floats():
    rs = np.random.RandomState(3)
    cent = rs.randn(20, 32).astype(np.float32) * 2
    xb = cent[rs.randint(0, 20, 2600)] + rs.randn(2600, 32)
    xq = cent[rs.randint(0, 20, 60)] + rs.randn(60, 32)
    return xb.astype(np.float32), xq.astype(np.float32)


def test_spatial_order_is_a_permutation(ints):
    xb, _ = ints
    order = HT.spatial_order(xb, B, device=CPU)
    np.testing.assert_array_equal(np.sort(order), np.arange(len(xb)))
    assign = np.arange(len(xb)) % 7
    np.testing.assert_array_equal(
        HT.spatial_order(xb, B, assign=assign, device=CPU),
        JT.spatial_order(xb, B, assign=assign))


def test_build_tiles_fused_equal(ints):
    xb, _ = ints
    jt, tt = _setup(xb, L2)
    assert (tt.b, tt.n) == (jt.b, jt.n)
    for name in ("data", "ids", "norms", "list_block_start", "list_nblocks"):
        np.testing.assert_array_equal(getattr(tt.il, name).numpy(),
                                      np.asarray(getattr(jt.il, name)), name)
    np.testing.assert_array_equal(tt.nbr_pos.numpy(), np.asarray(jt.nbr_pos))
    np.testing.assert_array_equal(tt.orig_ids.numpy(),
                                  np.asarray(jt.orig_ids))
    np.testing.assert_allclose(tt.cent.numpy(), np.asarray(jt.cent),
                               rtol=1e-6)


def _search_both(jt, tt, xq, metric, **kw):
    D0, P0, I0 = JT.tile_search_fused(jt, jnp.asarray(xq), 10, metric=metric,
                                      interpret=True, **kw)
    D1, P1, I1 = HT.tile_search_fused(tt, torch.from_numpy(xq), 10,
                                      metric=metric, **kw)
    return (np.asarray(D0), np.asarray(I0), D1.numpy(), I1.numpy(),
            np.asarray(P0), P1.numpy())


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("kw", [dict(nprobe0=4, hops=1, F=4),
                                dict(nprobe0=3, hops=2, F=2, kp=12, rk=24),
                                dict(nprobe0=4, hops=0)])
def test_tile_search_fused_equal_on_integer_data(ints, metric, kw):
    xb, xq = ints
    jt, tt = _setup(xb, metric)
    D0, I0, D1, I1, P0, P1 = _search_both(jt, tt, xq, metric, **kw)
    assert_topk_equal(D0, I0, D1, I1)
    # ids are the tiles' node ids of the returned positions
    np.testing.assert_array_equal(
        I1, np.where(P1 >= 0, tt.orig_ids.numpy()[np.maximum(P1, 0)], -1))


@pytest.mark.parametrize("metric", [L2, IP])
def test_tile_search_fused_on_float_data(floats, metric):
    xb, xq = floats
    jt, tt = _setup(xb, metric)
    _, I0, _, I1, _, _ = _search_both(jt, tt, xq, metric, nprobe0=4, hops=2,
                                      F=4)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(I0, I1)])
    assert overlap >= 0.99
