"""Lloyd's k-means on the device — PyTorch counterpart of
`tpu_ann/ops/kmeans.py` (faiss/Clustering.{h,cpp}).

Each iteration assigns with the exact f32 `knn`, updates centroids with
`index_add_` (the reference's one-hot GEMM exists only because TPU
scatters serialise), and splits empty clusters as Clustering.cpp:232
`split_clusters` does: an empty cluster takes a large cluster's centroid
with a symmetric ±1/1024 relative perturbation.

Random streams: the training subsample and the initial centroids come
from numpy ``RandomState`` exactly as in the reference, so both packages
start from the same centroids. The split signs come from a
``torch.Generator``; they cannot match ``jax.random`` bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from . import distances as D


@dataclasses.dataclass
class ClusteringParameters:
    """Defaults mirror faiss/Clustering.h:21-60 (niter=25; IVF training
    uses niter=10, IndexIVF.cpp:55)."""

    niter: int = 25
    nredo: int = 1
    verbose: bool = False
    spherical: bool = False
    max_points_per_centroid: int = 256
    seed: int = 1234
    # stop once the relative objective improvement drops below this
    # (0 = run all niter iterations, the faiss behaviour)
    early_stop_tol: float = 0.0


@dataclasses.dataclass
class ClusteringIterationStats:
    """Per-iteration stats (faiss/Clustering.h:62-68)."""

    obj: float
    imbalance_factor: float
    nsplit: int


def imbalance_factor(counts: np.ndarray) -> float:
    """Faiss utils::imbalance_factor: n * sum(c^2) / (sum c)^2."""
    counts = np.asarray(counts, np.float64)
    tot = counts.sum()
    if tot == 0:
        return 0.0
    return float(len(counts) * (counts**2).sum() / (tot * tot))


def _kmeans_iter(x: torch.Tensor, centroids: torch.Tensor,
                 gen: torch.Generator, k: int, metric: int, spherical: bool):
    """One Lloyd iteration: assign, update, split empties.
    Returns (new_centroids, stats tensor [obj, imbalance, nsplit])."""
    d = x.shape[1]
    dis, assign = D.knn(x, centroids, 1, metric)
    assign = assign[:, 0]
    obj = dis[:, 0].sum()

    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    sums.index_add_(0, assign, x)
    counts = torch.bincount(assign, minlength=k).float()
    new_c = sums / torch.clamp(counts, min=1.0)[:, None]
    tot = torch.clamp(counts.sum(), min=1.0)
    imb = k * (counts * counts).sum() / (tot * tot)

    # split_clusters (Clustering.cpp:232): empty cluster <- a big cluster's
    # centroid * (1 +- eps), big clusters first
    empty = counts == 0
    nsplit = empty.sum()
    order = torch.argsort(-counts, stable=True)
    rank_among_empty = torch.cumsum(empty.int(), 0) - 1
    donor = order[torch.clamp(rank_among_empty, 0, k - 1) % k]
    sign = torch.randint(0, 2, (k, d), generator=gen, device=x.device,
                         dtype=torch.int32).float() * 2.0 - 1.0
    donated = new_c[donor] * (1.0 + sign / 1024.0)
    new_c = torch.where(empty[:, None], donated, new_c)

    if spherical:
        new_c = new_c / torch.clamp(new_c.norm(dim=1, keepdim=True),
                                    min=1e-12)
    return new_c, torch.stack([obj, imb, nsplit.float()])


def subsample_training_set(x: np.ndarray, k: int, max_ppc: int, seed: int,
                           verbose: bool = False) -> np.ndarray:
    """Clustering.cpp:330 — cap training points at k * max_points_per_centroid
    with a seeded random permutation."""
    n = len(x)
    cap = k * max_ppc
    if n <= cap:
        return x
    rs = np.random.RandomState(seed)
    perm = rs.choice(n, size=cap, replace=False)
    return x[perm]


def kmeans(
    x,
    k: int,
    params: Optional[ClusteringParameters] = None,
    metric: int = D.METRIC_L2,
    init_centroids: Optional[np.ndarray] = None,
    checkpoint: Optional[str] = None,
    *,
    device="cuda",
) -> Tuple[np.ndarray, list]:
    """Train k-means on ``device``; returns (centroids (k, d) float32
    numpy, iteration stats). nredo restarts keep the run with the best
    final objective (min for L2, max for IP).

    ``checkpoint``: a file that redo 0 rewrites after every iteration
    (atomically, through ``checkpoint + ".tmp"``) with the reference's
    pickle, {"centroids", "iter", "key": None}; a run that finds it
    resumes at iteration ``iter + 1`` from those centroids, its random
    stream seeded with seed + 1000 + that iteration (the reference's
    rule), so either package resumes from the other's file.
    `InterruptCallback.check()` runs before every iteration."""
    # imported here: utils/__init__ imports the models, which import this
    from ..utils.interrupt import InterruptCallback

    cp = params or ClusteringParameters()
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    if n < k:
        raise ValueError(f"nx={n} < k={k}: not enough training points")
    xt = subsample_training_set(x, k, cp.max_points_per_centroid, cp.seed,
                                cp.verbose)
    if cp.verbose and len(xt) < len(x):
        print(f"kmeans: subsampled {len(x)} -> {len(xt)} points")
    xt_dev = torch.from_numpy(xt).to(device)
    best = None
    for redo in range(max(cp.nredo, 1)):
        rs = np.random.RandomState(cp.seed + redo)
        if init_centroids is not None and redo == 0:
            cent = torch.as_tensor(np.asarray(init_centroids, np.float32),
                                   device=device)
            if cent.shape != (k, d):
                raise ValueError(f"init_centroids must be ({k}, {d})")
        else:
            perm = rs.choice(len(xt), size=k, replace=False)
            cent = xt_dev[torch.from_numpy(perm).to(device)]
        if cp.spherical:
            cent = cent / torch.clamp(cent.norm(dim=1, keepdim=True),
                                      min=1e-12)
        gen = torch.Generator(device=device)
        gen.manual_seed(cp.seed + 31 * redo)
        stats = []
        obj = np.inf
        it0 = 0
        if checkpoint is not None and redo == 0 and \
                os.path.exists(checkpoint):
            with open(checkpoint, "rb") as f:
                st = pickle.load(f)
            cent = torch.as_tensor(np.asarray(st["centroids"], np.float32),
                                   device=device)
            it0 = int(st["iter"]) + 1
            gen.manual_seed(cp.seed + 1000 + it0)
            if cp.verbose:
                print(f"kmeans: resuming at iter {it0}")
        for it in range(it0, cp.niter):
            InterruptCallback.check()
            cent, stats_vec = _kmeans_iter(xt_dev, cent, gen, k, metric,
                                           cp.spherical)
            sv = stats_vec.cpu().numpy()        # one sync per iteration
            obj = float(sv[0])
            st = ClusteringIterationStats(
                obj=obj, imbalance_factor=float(sv[1]), nsplit=int(sv[2]))
            stats.append(st)
            if checkpoint is not None and redo == 0:
                tmp = checkpoint + ".tmp"
                with open(tmp, "wb") as f:
                    pickle.dump({"centroids": cent.cpu().numpy(),
                                 "iter": it, "key": None}, f)
                os.replace(tmp, checkpoint)
            if cp.verbose:
                print(f"  iter {it}: obj={st.obj:.4g} "
                      f"imbalance={st.imbalance_factor:.3f} "
                      f"nsplit={st.nsplit}")
            if (cp.early_stop_tol > 0 and len(stats) >= 2
                    and np.isfinite(stats[-2].obj) and stats[-2].obj != 0):
                rel = abs(stats[-2].obj - obj) / abs(stats[-2].obj)
                if rel < cp.early_stop_tol:
                    break
        better = (obj > best[0] if D.is_similarity_metric(metric)
                  else obj < best[0]) if best is not None else True
        if better:
            best = (obj, cent.cpu().numpy(), stats)
    return best[1], best[2]


def progressive_dim_clustering(
    x,
    k: int,
    params: Optional[ClusteringParameters] = None,
    metric: int = D.METRIC_L2,
    levels: int = 4,
    *,
    device="cuda",
) -> Tuple[np.ndarray, list]:
    """ProgressiveDimClustering (faiss/Clustering.h:174; reference
    :259-296): k-means on nested prefixes of the PCA-rotated rows (host
    numpy, as the reference), each level started from the last level's
    centroids padded with zeros; the centroids are rotated back."""
    cp = params or ClusteringParameters()
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    mean = x.mean(axis=0)
    xc = x - mean
    w, v = np.linalg.eigh((xc.T @ xc) / n)
    rot = v[:, np.argsort(-w)].astype(np.float32)
    xr = xc @ rot
    dims = [max(1, d >> (levels - 1 - i)) for i in range(levels)]
    dims[-1] = d
    cent: Optional[np.ndarray] = None
    stats: list = []
    for dd in dims:
        init = None
        if cent is not None:
            init = np.zeros((k, dd), np.float32)
            init[:, :cent.shape[1]] = cent
        cent, st = kmeans(np.ascontiguousarray(xr[:, :dd]), k, cp, metric,
                          init_centroids=init, device=device)
        stats.extend(st)
    return (cent @ rot.T + mean).astype(np.float32), stats


class Kmeans:
    """The object wrapper of faiss.Kmeans (python/extra_wrappers.py:443;
    reference :299-328): ``Kmeans(d, k, niter=..., ...)`` takes the
    ClusteringParameters fields and ``metric``; ``gpu`` is accepted and
    ignored, the device is ``device``."""

    def __init__(self, d: int, k: int, *, device="cuda", **kwargs):
        self.d, self.k = d, k
        self.device = device
        kwargs.pop("gpu", None)
        self.metric = kwargs.pop("metric", D.METRIC_L2)
        self.cp = ClusteringParameters(
            **{f.name: kwargs.pop(f.name) for f in
               dataclasses.fields(ClusteringParameters) if f.name in kwargs})
        if kwargs:
            raise TypeError(f"unknown Kmeans args: {sorted(kwargs)}")
        self.centroids: Optional[np.ndarray] = None
        self.obj: Optional[np.ndarray] = None
        self.iteration_stats: list = []

    def train(self, x, init_centroids=None) -> float:
        self.centroids, self.iteration_stats = kmeans(
            x, self.k, self.cp, self.metric, init_centroids=init_centroids,
            device=self.device)
        self.obj = np.array([s.obj for s in self.iteration_stats])
        return float(self.obj[-1]) if len(self.obj) else 0.0

    def assign(self, x):
        """(distance, centroid) of each row's nearest centroid, numpy."""
        xq = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)
        dis, ids = D.knn(xq, torch.from_numpy(self.centroids).to(
            self.device), 1, self.metric)
        return dis[:, 0].cpu().numpy(), ids[:, 0].cpu().numpy()


def kmeans1d(x: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact 1-D k-means (faiss impl/kmeans1d.{h,cpp}; reference
    :331-381): the O(n k) dynamic program over the sorted values with
    prefix sums, a host copy of the reference's. Returns (centroids (k,)
    f32, assignment (n,) int64)."""
    x = np.asarray(x, np.float64).ravel()
    n = len(x)
    if n < k:
        raise ValueError(f"n={n} < k={k}")
    order = np.argsort(x)
    xs = x[order]
    ps = np.concatenate([[0.0], np.cumsum(xs)])
    ps2 = np.concatenate([[0.0], np.cumsum(xs * xs)])

    def seg_cost(i, j):
        s = ps[j] - ps[i]
        return ps2[j] - ps2[i] - s * s / (j - i)

    dp = np.full((k + 1, n + 1), np.inf)
    arg = np.zeros((k + 1, n + 1), np.int64)
    dp[0, 0] = 0.0
    for c in range(1, k + 1):
        for j in range(c, n - (k - c) + 1):
            best, bi = np.inf, c - 1
            for i in range(c - 1, j):
                v = dp[c - 1, i] + seg_cost(i, j)
                if v < best:
                    best, bi = v, i
            dp[c, j] = best
            arg[c, j] = bi
    bounds = [n]
    j = n
    for c in range(k, 0, -1):
        j = int(arg[c, j])
        bounds.append(j)
    bounds = bounds[::-1]
    cent = np.zeros(k, np.float32)
    assign_sorted = np.zeros(n, np.int64)
    for c in range(k):
        i, j = bounds[c], bounds[c + 1]
        cent[c] = xs[i:j].mean()
        assign_sorted[i:j] = c
    assign = np.zeros(n, np.int64)
    assign[order] = assign_sorted
    return cent, assign
