"""Dataset zoo — numpy copy of `tpu_ann/utils/datasets.py` (faiss
`contrib/datasets.py` and the fork's fbin readers).

`SyntheticDataset` reproduces the reference's deterministic test fixture
(contrib/datasets.py:74); `sift_surrogate` generates the SIFT-like
descriptors of the benchmark. Ground truth goes through the port's exact
`IndexFlat` on the device the dataset names."""

from __future__ import annotations

from typing import Optional

import numpy as np


class Dataset:
    """Base dataset: d, metric, nt/nb/nq sizes, lazily computed ground truth."""

    def __init__(self, d: int, nt: int, nb: int, nq: int, metric: str = "L2"):
        self.d, self.nt, self.nb, self.nq = d, nt, nb, nq
        self.metric = metric

    def get_train(self, maxtrain: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def get_database(self) -> np.ndarray:
        raise NotImplementedError

    def get_queries(self) -> np.ndarray:
        raise NotImplementedError

    def get_groundtruth(self, k: int = 100) -> np.ndarray:
        raise NotImplementedError


class SyntheticDataset(Dataset):
    """Deterministic synthetic dataset (contrib/datasets.py:74 equivalent).

    Data is a d2-dim gaussian mixture rotated into d dims, which gives IVF
    clustering structure similar to real descriptor data. Ground truth is
    computed exactly by the Flat index on ``device``."""

    def __init__(self, d, nt, nb, nq, metric: str = "L2", seed: int = 1234,
                 *, device="cuda"):
        super().__init__(d, nt, nb, nq, metric)
        self.device = device
        rs = np.random.RandomState(seed)
        d1 = 10  # intrinsic dim of the mixture centers
        n = nb + nt + nq
        x = rs.normal(size=(n, d1))
        x = np.dot(x, rs.rand(d1, d))
        x = x * (rs.rand(d) * 4 + 0.1)
        x = np.sin(x)  # bounded, non-gaussian — mirrors contrib version
        x = x.astype(np.float32)
        self.xt = x[:nt]
        self.xb = x[nt : nt + nb]
        self.xq = x[nt + nb :]
        self._gt: Optional[np.ndarray] = None
        self._gt_k = 0

    def get_train(self, maxtrain=None):
        return self.xt if maxtrain is None else self.xt[:maxtrain]

    def get_database(self):
        return self.xb

    def get_queries(self):
        return self.xq

    def get_groundtruth(self, k: int = 100) -> np.ndarray:
        if self._gt is None or self._gt_k < k:
            from ..models.flat import IndexFlat
            from ..ops.distances import METRIC_INNER_PRODUCT, METRIC_L2

            metric = METRIC_L2 if self.metric == "L2" else METRIC_INNER_PRODUCT
            idx = IndexFlat(self.d, metric, device=self.device)
            idx.add(self.xb)
            _, I = idx.search(self.xq, k)
            self._gt, self._gt_k = I, k
        return self._gt[:, :k]


# Real-SIFT-difficulty preset for sift_surrogate — measured fit to the
# reference's published SIFT1M IVF recall anchors (RMSE 0.0215; see
# BENCHMARKS.md "surrogate calibration appendix" and sift_surrogate's
# docstring). Usage: sift_surrogate(n, seed, **SIFT1M_CALIBRATED).
SIFT1M_CALIBRATED = {"nproto": 64, "sigma": 1.3}


def sift_surrogate(n: int, seed: int = 0, chunk: int = 200_000,
                   nproto: int = 0, sigma: float = 0.35) -> np.ndarray:
    """SIFT-like 128-d descriptors, generated (no dataset files ship in
    the repository; the real recall gates should rerun on SIFT1M fvecs
    via tpu_ann's `load_sift1m` when available).

    Reproduces the structural properties that set SIFT's ANN difficulty
    rather than any particular file: a bank of prototype gradient
    patterns (4x4 cells x 8 orientation bins, gamma marginals, dominant
    patch orientation, spatially-smooth cell energy — the "image patch"
    manifold real descriptors live on) with per-draw multiplicative
    jitter, then SIFT's 0.2 clipping + L2 renormalization to 512 and
    uint8 saturation.

    Difficulty is set by (nproto, sigma). The DEFAULTS (nproto ~ n/64,
    sigma=0.35) give an easy dataset at IVF scale: with about one
    prototype per k-means cell, a query's true neighbors are
    same-prototype draws that land in the same list, so recall
    saturates near 1.0 at any probe ratio (measured at 500k/7812 lists,
    benchs/logs/r4_calibrate.jsonl). For real-SIFT difficulty pass
    ``**SIFT1M_CALIBRATED`` (nproto=64, sigma=1.3): each prototype's
    jittered cloud then spans many k-means cells, true neighbors
    straddle cell boundaries, and the IVF recall-vs-probe-ratio curve
    matches the reference's published SIFT1M anchors within RMSE 0.0215
    over probe ratios 0.195%-3.3% (BENCHMARKS.md "surrogate calibration
    appendix").

    Split ONE call into train/database/query slices — the prototype bank
    is seeded per call, and slices of the same call share it (queries
    drawn from a different bank are out-of-distribution and much
    harder)."""
    rs = np.random.RandomState(seed)
    if nproto <= 0:
        nproto = int(np.clip(n // 64, 1024, 65536))
    proto = rs.gamma(0.65, 1.0, size=(nproto, 16, 8)).astype(np.float32)
    dom = rs.randint(8, size=(nproto, 1, 1))
    ori = np.arange(8).reshape(1, 1, 8)
    ang = np.minimum(np.abs(ori - dom), 8 - np.abs(ori - dom))
    kappa = rs.gamma(2.0, 1.0, size=(nproto, 1, 1)).astype(np.float32)
    proto *= np.exp(-kappa * (ang.astype(np.float32) ** 2) / 4.0)
    cell = rs.gamma(1.5, 1.0, size=(nproto, 4, 4)).astype(np.float32)
    cell = (cell + np.roll(cell, 1, 1) + np.roll(cell, 1, 2)) / 3.0
    proto *= cell.reshape(nproto, 16, 1)

    out = np.empty((n, 128), np.float32)
    for i0 in range(0, n, chunk):
        m = min(chunk, n - i0)
        which = rs.randint(nproto, size=m)
        g = proto[which] * np.exp(
            sigma * rs.randn(m, 16, 8)).astype(np.float32)
        v = g.reshape(m, 128)
        # SIFT normalization: unit norm, clip at 0.2, renormalize, x512
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
        v = np.minimum(v, 0.2)
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
        # uint8 storage saturation (vecs files store SIFT as bytes)
        out[i0:i0 + m] = np.minimum(np.floor(v * 512.0), 255.0)
    return out

