"""Port parity: tpu_ann_torch.ops.kmeans against the JAX package's kmeans
on the same numpy data and seed (both on the CPU).

Both start from the same numpy-drawn centroids. Without empty clusters
the runs follow the same path: centroids within 1e-4 (the two libraries
sum in different orders, ~1e-7 apart). An empty-cluster split draws
random signs, which cannot match between jax.random and torch, so with
splits the check is on the outcome: objective within 1% and no empty
cluster left."""

import numpy as np
import pytest
import torch

from tpu_ann.ops import kmeans as JK
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import kmeans as TK


@pytest.mark.parametrize("niter,nredo", [(10, 1), (4, 2)])
def test_kmeans_matches_reference_without_splits(niter, nredo):
    rs = np.random.RandomState(0)
    x = rs.rand(2000, 16).astype(np.float32)
    c0, s0 = JK.kmeans(x, 20, JK.ClusteringParameters(niter=niter,
                                                      nredo=nredo))
    c1, s1 = TK.kmeans(x, 20, TK.ClusteringParameters(niter=niter,
                                                      nredo=nredo),
                       device="cpu")
    assert [s.nsplit for s in s0] == [0] * niter
    assert [s.nsplit for s in s1] == [0] * niter
    np.testing.assert_allclose(c1, c0, rtol=0, atol=1e-4)
    np.testing.assert_allclose([s.obj for s in s1], [s.obj for s in s0],
                               rtol=1e-5)
    np.testing.assert_allclose([s.imbalance_factor for s in s1],
                               [s.imbalance_factor for s in s0], rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_empty_cluster_split(seed):
    """Eight tight blobs, initial centroids with one duplicate and one
    blob uncovered: iteration 0 leaves a cluster empty and splits."""
    rs = np.random.RandomState(seed)
    centers = rs.rand(8, 16).astype(np.float32) * 10
    x = np.repeat(centers, 50, axis=0) + \
        rs.randn(400, 16).astype(np.float32) * 0.1
    init = np.concatenate([centers[:1], centers[:7]])
    c0, s0 = JK.kmeans(x, 8, JK.ClusteringParameters(niter=10, seed=seed),
                       init_centroids=init)
    c1, s1 = TK.kmeans(x, 8, TK.ClusteringParameters(niter=10, seed=seed),
                       init_centroids=init, device="cpu")
    assert s0[0].nsplit >= 1 and s1[0].nsplit >= 1
    np.testing.assert_allclose(s1[-1].obj, s0[-1].obj, rtol=0.01)
    _, a = TD.knn(torch.from_numpy(x), torch.from_numpy(c1), 1)
    assert (np.bincount(a[:, 0].numpy(), minlength=8) > 0).all()


def test_subsample_and_imbalance_match_reference():
    rs = np.random.RandomState(3)
    x = rs.rand(5000, 4).astype(np.float32)
    np.testing.assert_array_equal(
        TK.subsample_training_set(x, 10, 39, 1234),
        JK.subsample_training_set(x, 10, 39, 1234))
    counts = rs.randint(0, 50, size=64)
    assert TK.imbalance_factor(counts) == JK.imbalance_factor(counts)
