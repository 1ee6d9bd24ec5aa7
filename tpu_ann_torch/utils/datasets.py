"""Dataset zoo — numpy copy of `tpu_ann/utils/datasets.py` (faiss
`contrib/datasets.py`, `contrib/vecs_io.py` and the fork's fbin readers).

`SyntheticDataset` reproduces the reference's deterministic test fixture
(contrib/datasets.py:74); `sift_surrogate` and `deep_surrogate` generate
the SIFT-like and Deep1B-like descriptors of the benchmarks, bit-equal to
the reference at the same seed. The fvecs / ivecs / bvecs / fbin / ibin
files are read and written byte for byte as the reference does, and each
loader reads only what its root directory holds. Ground truth that is not
in a file goes through the port's exact `IndexFlat` on the device the
dataset names."""

from __future__ import annotations

import os
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



# Hard-difficulty presets for deep_surrogate (reference :147-160): the
# invariant that sets IVF difficulty is the cells a prototype cloud spans,
# ~244 as in the SIFT1M-calibrated recipe.
DEEP10M_CALIBRATED = {"nproto": 64, "sigma": 1.3}
DEEP100M_CALIBRATED = {"nproto": 256, "sigma": 1.3}


def deep_surrogate(n: int, seed: int = 0, chunk: int = 200_000,
                   d: int = 96, nproto: int = 0,
                   sigma: float = 1.3,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """Deep1B-like 96-d unit-norm float descriptors (the reference's
    Deep10M / Deep1B workload class, contrib/datasets.py DatasetDeep1B):
    dense gaussian prototypes, multiplicative log-normal jitter per group
    of 8 dims, additive noise, then L2 normalization.

    ``out``: an optional preallocated (n, d) float32 destination (e.g. a
    np.memmap) written chunk by chunk, so a Deep100M-size set never sits in
    RAM. The draws depend only on (seed, chunk): out-of-core and in-RAM
    calls give the same data."""
    rs = np.random.RandomState(seed)
    if nproto <= 0:
        nproto = max(n // 1562, 64)
    g = 8
    if d % g:
        raise ValueError(f"d must be a multiple of {g}")
    proto = rs.randn(nproto, d).astype(np.float32)
    if out is None:
        out = np.empty((n, d), np.float32)
    elif out.shape != (n, d) or out.dtype != np.float32:
        raise ValueError(f"out must be a ({n}, {d}) float32 array")
    for i0 in range(0, n, chunk):
        m = min(chunk, n - i0)
        which = rs.randint(nproto, size=m)
        jit = np.exp(sigma * rs.randn(m, d // g)).astype(np.float32)
        v = proto[which] * np.repeat(jit, g, axis=1)
        v += 0.25 * rs.randn(m, d).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
        out[i0:i0 + m] = v
    return out


class SiftSurrogateDataset(Dataset):
    """Benchmark dataset with SIFT-like structure (see sift_surrogate);
    its ground truth is exact on ``device``."""

    def __init__(self, nt: int, nb: int, nq: int, seed: int = 7, *,
                 device="cuda"):
        super().__init__(128, nt, nb, nq, "L2")
        self.device = device
        x = sift_surrogate(nt + nb + nq, seed=seed)
        self.xt, self.xb, self.xq = x[:nt], x[nt:nt + nb], x[nt + nb:]
        self._gt, self._gt_k = None, 0

    get_train = SyntheticDataset.get_train
    get_database = SyntheticDataset.get_database
    get_queries = SyntheticDataset.get_queries
    get_groundtruth = SyntheticDataset.get_groundtruth


# ---------------------------------------------------------------------------
# File formats: fvecs / ivecs / bvecs (contrib/vecs_io.py) and the fork's
# fbin / ibin ([nvecs:i32][dim:i32][data]); reference :225-304
# ---------------------------------------------------------------------------

def ivecs_read(fname: str, maxn: Optional[int] = None) -> np.ndarray:
    """``maxn`` bounds the read through a memmap (a Deep1B-size base file
    is not read whole to take a slice)."""
    if maxn is None:
        a = np.fromfile(fname, dtype=np.int32)
        d = a[0]
        return a.reshape(-1, d + 1)[:, 1:].copy()
    mm = np.memmap(fname, dtype=np.int32, mode="r")
    d = int(mm[0])
    n = min(len(mm) // (d + 1), maxn)
    return np.array(mm[: n * (d + 1)].reshape(n, d + 1)[:, 1:])


def fvecs_read(fname: str, maxn: Optional[int] = None) -> np.ndarray:
    return ivecs_read(fname, maxn).view(np.float32)


def ivecs_write(fname: str, m: np.ndarray) -> None:
    m = np.ascontiguousarray(m, dtype=np.int32)
    n, d = m.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = m
    out.tofile(fname)


def fvecs_write(fname: str, m: np.ndarray) -> None:
    ivecs_write(fname,
                np.ascontiguousarray(m, dtype=np.float32).view(np.int32))


def bvecs_read(fname: str, maxn: Optional[int] = None) -> np.ndarray:
    """.bvecs: [d:int32][d uint8 bytes] a row (the BigANN format,
    contrib/vecs_io.py bvecs_mmap)."""
    with open(fname, "rb") as f:
        d = int(np.fromfile(f, count=1, dtype=np.int32)[0])
    rec = 4 + d
    a = np.memmap(fname, dtype=np.uint8, mode="r")
    n = len(a) // rec
    if maxn is not None:
        n = min(n, maxn)
    return np.array(a[: n * rec].reshape(n, rec)[:, 4:])


def bvecs_write(fname: str, m: np.ndarray) -> None:
    m = np.ascontiguousarray(m, dtype=np.uint8)
    n, d = m.shape
    out = np.empty((n, 4 + d), np.uint8)
    out[:, :4] = np.frombuffer(
        np.full(n, d, np.int32).tobytes(), np.uint8).reshape(n, 4)
    out[:, 4:] = m
    out.tofile(fname)


def read_fbin(fname: str, start_idx: int = 0,
              chunk_size: Optional[int] = None) -> np.ndarray:
    """.fbin: [nvecs:int32][dim:int32][float32 data] (the fork's format,
    tutorial/python/191-hnsw-ivf-qps.py:25-43)."""
    with open(fname, "rb") as f:
        nvecs, dim = np.fromfile(f, count=2, dtype=np.int32)
        nvecs = int(nvecs) - start_idx
        if chunk_size is not None:
            nvecs = min(nvecs, chunk_size)
        f.seek(4 + 4 + start_idx * 4 * int(dim))
        arr = np.fromfile(f, count=nvecs * int(dim), dtype=np.float32)
    return arr.reshape(nvecs, int(dim))


def write_fbin(fname: str, m: np.ndarray) -> None:
    m = np.ascontiguousarray(m, dtype=np.float32)
    with open(fname, "wb") as f:
        np.asarray(m.shape, dtype=np.int32).tofile(f)
        m.tofile(f)


def read_ibin(fname: str) -> np.ndarray:
    with open(fname, "rb") as f:
        nvecs, dim = np.fromfile(f, count=2, dtype=np.int32)
        arr = np.fromfile(f, count=int(nvecs) * int(dim), dtype=np.int32)
    return arr.reshape(int(nvecs), int(dim))


# ---------------------------------------------------------------------------
# Loaders over a root directory (contrib/datasets.py; reference :306-437)
# ---------------------------------------------------------------------------

class _FvecsDataset(Dataset):
    """File-backed dataset over <prefix>_{base,learn,query}.fvecs and
    <prefix>_groundtruth.ivecs under ``root`` (the SIFT1M, GIST1M and
    Deep1B layouts)."""

    def __init__(self, root: str, prefix: str, nt: int, nb: int):
        self.root, self.prefix = root, prefix
        xq = fvecs_read(os.path.join(root, f"{prefix}_query.fvecs"))
        super().__init__(xq.shape[1], nt, nb, xq.shape[0])
        self.xq = xq

    def get_train(self, maxtrain: Optional[int] = None) -> np.ndarray:
        return fvecs_read(
            os.path.join(self.root, f"{self.prefix}_learn.fvecs"),
            maxn=maxtrain)

    def get_database(self) -> np.ndarray:
        return fvecs_read(
            os.path.join(self.root, f"{self.prefix}_base.fvecs"),
            maxn=self.nb)

    def get_queries(self) -> np.ndarray:
        return self.xq

    def get_groundtruth(self, k: int = 100) -> np.ndarray:
        return ivecs_read(os.path.join(
            self.root, f"{self.prefix}_groundtruth.ivecs"))[:, :k]


def load_sift1m(root: str) -> Dataset:
    """SIFT1M from its fvecs files under ``root`` (DatasetSIFT1M); raises
    FileNotFoundError where they are absent."""
    return _FvecsDataset(root, "sift", 100000, 1000000)


def load_gist1m(root: str) -> Dataset:
    """GIST1M (960-d fvecs, DatasetGIST1M)."""
    return _FvecsDataset(root, "gist", 500000, 1000000)


def load_deep1b(root: str, nb: int = 10**9) -> Dataset:
    """Deep1B / Deep10M / ... fvecs slices (DatasetDeep1B; the ground
    truth file must match the slice)."""
    return _FvecsDataset(root, "deep", 10**7, nb)


class DatasetBigANN(Dataset):
    """BigANN uint8 SIFT vectors in bvecs files (contrib/datasets.py:171):
    base, learn and queries are .bvecs, the ground truth an ivecs file a
    slice (gnd/idx_{nb_M}M.ivecs)."""

    def __init__(self, root: str, nb_M: int = 1000):
        self.root, self.nb_M = root, int(nb_M)
        xq = bvecs_read(os.path.join(root, "bigann_query.bvecs"))
        super().__init__(xq.shape[1], 10**8, self.nb_M * 10**6, xq.shape[0])
        self.xq = xq.astype(np.float32)

    def get_train(self, maxtrain: Optional[int] = None) -> np.ndarray:
        mt = maxtrain or self.nt
        return bvecs_read(os.path.join(self.root, "bigann_learn.bvecs"),
                          maxn=mt).astype(np.float32)

    def get_database(self) -> np.ndarray:
        return bvecs_read(os.path.join(self.root, "bigann_base.bvecs"),
                          maxn=self.nb).astype(np.float32)

    def database_iterator(self, bs: int = 10**6):
        """The base file in chunks of ``bs`` rows (for ground truth and
        out-of-core adds)."""
        path = os.path.join(self.root, "bigann_base.bvecs")
        with open(path, "rb") as f:
            d = int(np.fromfile(f, count=1, dtype=np.int32)[0])
        rec = 4 + d
        a = np.memmap(path, dtype=np.uint8, mode="r")
        n = min(len(a) // rec, self.nb)
        for i0 in range(0, n, bs):
            i1 = min(i0 + bs, n)
            yield np.array(a[i0 * rec:i1 * rec].reshape(i1 - i0, rec)
                           [:, 4:]).astype(np.float32)

    def get_queries(self) -> np.ndarray:
        return self.xq

    def get_groundtruth(self, k: int = 100) -> np.ndarray:
        return ivecs_read(os.path.join(
            self.root, "gnd", f"idx_{self.nb_M}M.ivecs"))[:, :k]


def dataset_from_name(name: str = "synthetic-64-10000-50000-500",
                      basedir: Optional[str] = None, *,
                      device="cuda") -> Dataset:
    """A dataset by name (contrib/datasets.py:352):

    - ``synthetic[-d-nt-nb-nq]``: the deterministic SyntheticDataset;
    - ``sift-surrogate[-nt-nb-nq]``: the SIFT-like surrogate;
    - ``sift1M``: the SIFT1M fvecs files under ``basedir``.

    ``device`` is where a generated dataset computes its ground truth."""
    parts = name.split("-")
    if parts[0] == "synthetic":
        d, nt, nb, nq = (int(p) for p in parts[1:5]) if len(parts) >= 5 \
            else (64, 10000, 50000, 500)
        return SyntheticDataset(d=d, nt=nt, nb=nb, nq=nq, device=device)
    if name.startswith("sift-surrogate"):
        if len(parts) >= 4:
            nt, nb, nq = int(parts[-3]), int(parts[-2]), int(parts[-1])
        else:
            nt, nb, nq = 100000, 1000000, 10000
        return SiftSurrogateDataset(nt=nt, nb=nb, nq=nq, device=device)
    if name.lower() == "sift1m":
        if basedir is None:
            raise ValueError("sift1M needs basedir with the fvecs files")
        return load_sift1m(basedir)
    raise ValueError(f"unknown dataset {name!r}")
