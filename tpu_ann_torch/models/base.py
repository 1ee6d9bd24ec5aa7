"""Index base API — PyTorch counterpart of `tpu_ann/models/base.py`
(faiss/Index.h:77-317).

Indexes hold tensors on one explicit device (``device=``, default
``"cuda"``); the public ``search`` takes and returns numpy arrays like the
reference's SWIG wrappers. Per-search timing stats mirror the fork's
`QueryLatencyStats` split (faiss/IndexIVF.h:28-32).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..ops.distances import METRIC_INNER_PRODUCT, METRIC_L2, is_similarity_metric


@dataclasses.dataclass
class SearchParameters:
    """Base per-call search parameters (faiss/Index.h:64-69)."""

    sel: Optional[Any] = None   # IDSelector


@dataclasses.dataclass
class QueryLatencyStats:
    """Per-query latency/work arrays, all (nq,) — the fork's
    `QueryLatencyStats {total_us, quantization_us, list_scan_us}`
    (faiss/IndexIVF.h:28-32) plus the scanned-code count."""

    total_us: np.ndarray = None
    quantization_us: np.ndarray = None
    list_scan_us: np.ndarray = None
    ndis: np.ndarray = None

    def percentiles(self, field: str = "total_us",
                    qs=(50.0, 99.0, 99.9)) -> dict:
        a = getattr(self, field)
        return {f"p{q:g}": float(np.percentile(a, q)) for q in qs}


@dataclasses.dataclass
class SearchStats:
    """Per-search timing and counters (fork's QueryLatencyStats +
    IndexIVFStats). Times are microseconds for the whole batch. The
    fork's three:

    - ``quantization_us``: the coarse step, on the host clock fenced by
      device syncs at both edges (`Timer`'s clock);
    - ``list_scan_us``: the same clock around the list scan, plus
      ``output_us``: so it also holds the copy of the results to the host
      and the map to user ids;
    - ``total_us``: the two summed (the input checks and the upload are
      not in it, as in the fork).

    `IndexIVF.search_stats` fills these from the spans of its steps
    (`tpu_ann_torch.trace`), and six more:

    - ``input_us``: the checks and parameters (``_ready``,
      ``_check_input``, ``_effective_params``, ``_sel_mask``), fenced host
      clock;
    - ``upload_us``: the queries' copy to the device, fenced host clock;
    - ``plan_us``, ``merge_us``: the fused scan's pair plan, and its merge
      and re-rank, on the device's clock (a CUDA event pair each, read
      after the list scan's closing sync; the host clock on a CPU device);
      zero where the query-major scan runs;
    - ``output_us``: the copy out and the map to user ids, host clock (it
      starts after the list scan's closing sync, and ends after the sync
      that waits for the copy: on a CUDA device, of the stream, once the
      copies into page-locked memory are issued);
    - ``pinned_bytes``: the bytes of the search's host <-> device copies
      that went through page-locked host memory (the queries up and the
      results down: ``nq*d*4 + nq*k*(4 + 8)`` on a CUDA device, 0 on the
      CPU), counted by `tpu_ann_torch.trace.count`.

    ``extra`` holds an index's own counters (the paged scan's windows and
    times); like ``per_query`` it is not summed, listed or reset with the
    rest."""

    nq: int = 0
    total_us: float = 0.0
    quantization_us: float = 0.0
    list_scan_us: float = 0.0
    ndis: int = 0           # number of distances evaluated
    nlist_visited: int = 0  # number of invlists scanned
    input_us: float = 0.0
    upload_us: float = 0.0
    plan_us: float = 0.0
    merge_us: float = 0.0
    output_us: float = 0.0
    pinned_bytes: int = 0
    per_query: Optional[QueryLatencyStats] = None
    extra: Optional[dict] = None

    _NOT_SUMMED = ("per_query", "extra")

    def as_dict(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name not in self._NOT_SUMMED}

    def accumulate(self, other: "SearchStats") -> None:
        for f in dataclasses.fields(self):
            if f.name in self._NOT_SUMMED:
                continue
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            if f.name in self._NOT_SUMMED:
                setattr(self, f.name, None)
                continue
            setattr(self, f.name, type(getattr(self, f.name))(0))


# Global cumulative counters, the role of faiss's `indexIVF_stats`
# singleton (IndexIVF.h:567-583). Every *_stats search accumulates into it.
indexIVF_stats = SearchStats()


class Timer:
    """Context-manager wall timer in microseconds (fork's Timer struct,
    faiss/IndexIVF.cpp:32). On a CUDA device it synchronises at both edges,
    so the interval covers the device work queued inside it."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.us = (time.perf_counter() - self.t0) * 1e6
        return False


def _as_f32(x):
    """(n, d) float32 rows: a C-contiguous numpy array, or a contiguous
    tensor where a tensor was given (it stays on its device)."""
    if isinstance(x, torch.Tensor):
        x = x.float()
    else:
        x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"expected (n, d) array, got shape {tuple(x.shape)}")
    return x.contiguous() if isinstance(x, torch.Tensor) \
        else np.ascontiguousarray(x)


class Index:
    """Abstract base (faiss/Index.h:77): `d`, `ntotal`, `metric_type`,
    `is_trained`, the numpy-facing `search(x, k) -> (D, I)`, and the
    device its tensors live on."""

    def __init__(self, d: int, metric: int = METRIC_L2, *, device="cuda"):
        if d <= 0:
            raise ValueError("d must be positive")
        self.d = int(d)
        self.metric_type = int(metric)
        self.metric_arg = 0.0   # Lp exponent (faiss Index::metric_arg)
        self.ntotal = 0
        self.is_trained = True
        self.device = torch.device(device)

    def train(self, x) -> None:  # noqa: D401 - faiss parity
        """Default: no training needed (faiss Index::train)."""

    def add(self, x) -> None:
        raise NotImplementedError

    def add_with_ids(self, x, ids) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support add_with_ids")

    def search(self, x, k: int, *, params: Optional[Any] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def search_stats(self, x, k: int, *, params: Optional[Any] = None):
        """search() + SearchStats (faiss/IndexIVF.h:329-337). Default: the
        whole search is timed as list_scan."""
        with Timer(self.device) as t:
            D, I = self.search(x, k, params=params)
        stats = SearchStats(nq=len(np.atleast_2d(x)), total_us=t.us,
                            list_scan_us=t.us)
        indexIVF_stats.accumulate(stats)
        return D, I, stats

    def search_stats_per_query(self, x, k: int, *,
                               params: Optional[Any] = None):
        """search + per-query QueryLatencyStats (the fork's per-query stats
        array, faiss/IndexIVF.h:28-32). This generic version times batch-1
        searches, each fenced by device syncs, and fills total_us only;
        IndexIVF overrides it with the quantization / list-scan split."""
        x = self._check_input(x)
        nq = len(x)
        tot = np.zeros(nq, np.float64)
        outs = []
        self.search(x[:1], k, params=params)    # warm the batch-1 shapes
        for q in range(nq):
            with Timer(self.device) as t:
                outs.append(self.search(x[q:q + 1], k, params=params))
            tot[q] = t.us
        Dv = np.concatenate([o[0] for o in outs])
        Iv = np.concatenate([o[1] for o in outs])
        pq = QueryLatencyStats(
            total_us=tot, quantization_us=np.zeros(nq),
            list_scan_us=tot.copy(), ndis=np.zeros(nq, np.int64))
        stats = SearchStats(nq=nq, total_us=float(tot.sum()),
                            list_scan_us=float(tot.sum()), per_query=pq)
        indexIVF_stats.accumulate(stats)
        return Dv, Iv, stats

    def assign(self, x, k: int = 1) -> np.ndarray:
        """Labels only (faiss Index::assign)."""
        _, labels = self.search(x, k)
        return labels

    def reset(self) -> None:
        raise NotImplementedError

    def reconstruct(self, key: int) -> np.ndarray:
        raise NotImplementedError

    def reconstruct_n(self, i0: int, ni: int) -> np.ndarray:
        return np.stack([self.reconstruct(i) for i in range(i0, i0 + ni)])

    def reconstruct_batch(self, keys) -> np.ndarray:
        """Reconstruct arbitrary keys (faiss/Index.h:231) by looping
        reconstruct(), as the reference's fallback does."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        if len(keys) == 0:
            return np.zeros((0, self.d), np.float32)
        return np.stack([self.reconstruct(int(kk)) for kk in keys])

    def compute_residual(self, x, key: int) -> np.ndarray:
        """x - reconstruct(key) (faiss Index::compute_residual)."""
        return np.asarray(x, np.float32) - self.reconstruct(int(key))

    def compute_residual_n(self, x, keys) -> np.ndarray:
        """Batched residuals (faiss Index::compute_residual_n)."""
        return np.asarray(x, np.float32) - self.reconstruct_batch(keys)

    def search_and_reconstruct(self, x, k: int):
        """(D, I, R) with R (nq, k, d) the result vectors; rows of -1
        labels are zero (faiss/Index.h:244)."""
        D_, I_ = self.search(x, k)
        flat = np.asarray(I_, np.int64).reshape(-1)
        ok = flat >= 0
        R = np.zeros((len(flat), self.d), np.float32)
        if ok.any():
            R[ok] = self.reconstruct_batch(flat[ok])
        return D_, I_, R.reshape(len(I_), k, self.d)

    def merge_from(self, other, add_id: int = 0) -> None:
        """Move other's vectors into self (faiss Index::merge_from) by
        reconstructing them and adding them again; IVF indexes override it
        with a merge of their lists."""
        if type(other) is not type(self):
            raise ValueError("merge_from: index types differ")
        if other.ntotal:
            x = other.reconstruct_n(0, other.ntotal)
            if add_id:
                self.add_with_ids(
                    x, np.arange(add_id, add_id + len(x), dtype=np.int64))
            else:
                self.add(x)
        other.reset()

    # --- codec API (faiss/Index.h:217-244) ------------------------------
    def sa_code_size(self) -> int:
        raise NotImplementedError

    def sa_encode(self, x) -> np.ndarray:
        raise NotImplementedError

    def sa_decode(self, codes) -> np.ndarray:
        raise NotImplementedError

    @property
    def is_similarity(self) -> bool:
        return is_similarity_metric(self.metric_type)

    def _check_input(self, x) -> np.ndarray:
        x = _as_f32(x)
        if x.shape[1] != self.d:
            raise ValueError(f"input dim {x.shape[1]} != index dim {self.d}")
        return x

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        if not x.flags.writeable:         # e.g. a view of a jax array
            x = x.copy()
        return torch.from_numpy(x).to(self.device)

    def __repr__(self):
        m = "IP" if self.metric_type == METRIC_INNER_PRODUCT else "L2"
        return (f"{type(self).__name__}(d={self.d}, ntotal={self.ntotal}, "
                f"metric={m}, device={self.device})")


__all__ = [
    "Index",
    "SearchParameters",
    "SearchStats",
    "QueryLatencyStats",
    "Timer",
    "indexIVF_stats",
    "METRIC_L2",
    "METRIC_INNER_PRODUCT",
]
