"""Evaluation utilities — numpy copy of `tpu_ann/utils/evaluation.py`
(faiss `contrib/evaluation.py`).

recall_at_r follows the reference's 1-recall@R convention
(contrib/evaluation.py:17-37: fraction of queries whose true nearest
neighbor appears in the first R results); knn_intersection_measure is
contrib/evaluation.py:40."""

from __future__ import annotations

import numpy as np


def knn_intersection_measure(I1: np.ndarray, I2: np.ndarray) -> float:
    """Average fraction of common ids between two (nq, k) result sets
    (contrib/evaluation.py:40)."""
    nq, k = I1.shape
    if I2.shape != (nq, k):
        raise ValueError(f"shape mismatch: {I1.shape} vs {I2.shape}")
    ninter = sum(
        np.intersect1d(I1[i], I2[i]).size for i in range(nq)
    )
    return ninter / float(nq * k)


def recall_at_r(I: np.ndarray, gt: np.ndarray, r: int) -> float:
    """1-recall@r: P(gt[:,0] in I[:, :r]) — the headline metric in every
    fork harness (tutorial/python/190-...-test.py:1562-1620)."""
    nq = I.shape[0]
    found = (I[:, :r] == gt[:nq, :1]).any(axis=1)
    return float(found.mean())


def recall_k_at_k(I: np.ndarray, gt: np.ndarray, k: int) -> float:
    """recall@k with k ground-truth neighbors (intersection form): what the
    fork reports as 'Recall@10'."""
    nq = I.shape[0]
    ninter = 0
    for i in range(nq):
        ninter += np.intersect1d(I[i, :k], gt[i, :k]).size
    return ninter / float(nq * k)
