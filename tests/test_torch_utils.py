"""Port parity for the numpy utilities and pairwise distances of
tpu_ann_torch: the copies must give the JAX package's answers exactly
(integer or identical numpy arithmetic), and the pairwise products within
rtol 1e-5 (f32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import distances as JD
from tpu_ann.utils import datasets as JDS
from tpu_ann.utils import evaluation as JE
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.utils import datasets as TDS
from tpu_ann_torch.utils import evaluation as TE


def test_sift_surrogate_is_the_same_data():
    a = JDS.sift_surrogate(3000, seed=11, **JDS.SIFT1M_CALIBRATED)
    b = TDS.sift_surrogate(3000, seed=11, **TDS.SIFT1M_CALIBRATED)
    np.testing.assert_array_equal(a, b)
    assert (b == np.round(b)).all() and b.min() >= 0 and b.max() <= 255


def test_synthetic_dataset_and_ground_truth():
    j = JDS.SyntheticDataset(16, 300, 1000, 20)
    t = TDS.SyntheticDataset(16, 300, 1000, 20, device="cpu")
    for get in ("get_train", "get_database", "get_queries"):
        np.testing.assert_array_equal(getattr(t, get)(), getattr(j, get)())
    # nearest neighbour ids agree (no ties on this float data)
    np.testing.assert_array_equal(t.get_groundtruth(5),
                                  j.get_groundtruth(5))


def test_evaluation_functions_match():
    rs = np.random.RandomState(0)
    I = rs.randint(0, 50, size=(40, 10))
    gt = rs.randint(0, 50, size=(40, 10))
    assert TE.recall_at_r(I, gt, 5) == JE.recall_at_r(I, gt, 5)
    assert TE.recall_k_at_k(I, gt, 10) == JE.recall_k_at_k(I, gt, 10)
    assert TE.knn_intersection_measure(I, gt) == \
        JE.knn_intersection_measure(I, gt)
    with pytest.raises(ValueError):
        TE.knn_intersection_measure(I, gt[:, :5])


@pytest.mark.parametrize("metric", [JD.METRIC_L2, JD.METRIC_INNER_PRODUCT])
def test_pairwise_distances_match(metric):
    rs = np.random.RandomState(1)
    xq = rs.rand(13, 24).astype(np.float32)
    xb = rs.rand(70, 24).astype(np.float32)
    a = np.asarray(JD.pairwise_distances(jnp.asarray(xq), jnp.asarray(xb),
                                         metric))
    b = TD.pairwise_distances(torch.from_numpy(xq), torch.from_numpy(xb),
                              metric).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TD.l2_norms(torch.from_numpy(xq)).numpy(),
                               np.asarray(JD.l2_norms(jnp.asarray(xq))),
                               rtol=1e-6)
    assert TD.is_similarity_metric(metric) == JD.is_similarity_metric(metric)
    assert TD.worst_value(metric) == float(JD.worst_value(metric))
