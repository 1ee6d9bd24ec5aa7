"""IndexIVF / IndexIVFFlat — PyTorch counterpart of `tpu_ann/models/ivf.py`
(faiss/IndexIVF.{h,cpp} + IndexIVFFlat.{h,cpp}).

Training runs k-means on the index's device (`Level1Quantizer::train_q1`,
faiss/IndexIVF.cpp:66-130). Adding assigns each new chunk once with the
exact coarse product, keeps a chunked host store, and repacks the
block-packed invlists (`ops.ivf_scan`). Search is exact coarse
quantization (one f32 product + top-nprobe over the centroids) followed by
the list-major fused scan (`ops.ivf_scan_fused`): on a CUDA device every
search is one launch of the hand-written kernel, with no size gate and no
fallback to another scan. `search_stats` reports the fork's
quantization / list-scan split (faiss/IndexIVF.h:28-32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import ivf_scan
from ..ops.ivf_scan_fused import scan_invlists_fused
from ..ops.kmeans import ClusteringParameters, kmeans
from . import base
from .base import Index, SearchStats, Timer
from .flat import IndexFlat


@dataclasses.dataclass
class SearchParametersIVF:
    """faiss SearchParametersIVF (faiss/IndexIVF.h:77-88)."""

    nprobe: int = 0          # 0 = use index default
    max_codes: int = 0       # 0 = unlimited
    sel: object = None       # IDSelector


class IndexIVF(Index):
    """Base IVF index: coarse quantizer + packed invlists (Flat storage)."""

    def __init__(self, quantizer: Index, d: int, nlist: int,
                 metric: int = D.METRIC_L2, block_size: int = 128, *,
                 device="cuda"):
        super().__init__(d, metric, device=device)
        if quantizer.d != d:
            raise ValueError("quantizer dimension mismatch")
        if quantizer.device != self.device:
            raise ValueError("quantizer must live on the index's device")
        self.quantizer = quantizer
        self.nlist = int(nlist)
        self.nprobe = 1
        self.block_size = int(block_size)
        self.is_trained = False
        # quantizer_trains_alone (faiss Level1Quantizer): 0 = k-means on
        # this level; 1 = the quantizer is used (and trained) as it is
        self.quantizer_trains_alone = 0
        self.cp = ClusteringParameters(niter=10)
        self.clustering_stats: list = []
        # host store, one entry per add() chunk: rows, user ids and their
        # cached coarse assignment (None = not yet computed)
        self._xb_host: list = []
        self._ids_host: list = []
        self._assign_host: list = []
        # packed invlists store int32 ROW indices; user ids are int64 on
        # the host (`_ids_flat`) and results are remapped on exit
        self._ids_flat: Optional[np.ndarray] = None
        self._ids_trivial = True
        self.invlists: Optional[ivf_scan.PackedInvLists] = None
        self._list_sizes_dev: Optional[torch.Tensor] = None
        self._dirty = False

    # --- training ---------------------------------------------------------
    def train(self, x) -> None:
        x = self._check_input(x)
        self.train_q1(x)
        self.train_encoder(x)
        self.is_trained = True

    def train_q1(self, x: np.ndarray) -> None:
        """Level1Quantizer::train_q1 (faiss/IndexIVF.cpp:66-130)."""
        if self.quantizer_trains_alone == 1:
            if self.quantizer.ntotal != self.nlist:
                self.quantizer.train(x)
                if self.quantizer.ntotal != self.nlist:
                    raise ValueError(
                        "quantizer_trains_alone=1 requires a pre-built "
                        f"quantizer with ntotal == nlist ({self.nlist})")
            return
        if self.quantizer_trains_alone != 0:
            raise NotImplementedError(
                "quantizer_trains_alone=2 is not ported yet")
        centroids, self.clustering_stats = kmeans(
            x, self.nlist, self.cp, self.metric_type, device=self.device)
        self.quantizer.reset()
        self.quantizer.train(centroids)
        self.quantizer.add(centroids)

    def train_encoder(self, x: np.ndarray) -> None:
        """No-op for Flat storage (faiss IndexIVF::train_encoder default);
        codec subclasses train their codec here."""

    # --- add ----------------------------------------------------------------
    def add(self, x) -> None:
        x = self._check_input(x)
        ids = np.arange(self.ntotal, self.ntotal + len(x), dtype=np.int64)
        self.add_with_ids(x, ids)

    def add_with_ids(self, x, ids, *, repack: bool = True) -> None:
        if not self.is_trained:
            raise RuntimeError("train() before add()")
        x = self._check_input(x)
        ids = np.asarray(ids, np.int64)
        if len(ids) != len(x):
            raise ValueError("ids / x length mismatch")
        self._check_mutable()
        self._xb_host.append(x.copy())
        self._ids_host.append(ids.copy())
        self._assign_host.append(None)
        self.ntotal += len(x)
        self._dirty = True
        if repack:
            self._repack()

    def _check_mutable(self) -> None:
        """An index carried over without its host store (see
        utils.convert) is search-only: a repack would drop its rows."""
        if self.ntotal and sum(len(c) for c in self._xb_host) != self.ntotal:
            raise RuntimeError(
                "index is search-only (no host vector store); "
                "add is unavailable")

    def _maybe_repack(self) -> None:
        if self._dirty:
            self._repack()

    # --- coarse quantization ----------------------------------------------
    # 'auto' and 'flat' use the exact product over the centroid table (an
    # IndexFlat's rows, or an HNSW quantizer's storage); 'quantizer'
    # searches an HNSW quantizer's graph (reference :195-256). The graph
    # search of other quantizers is not ported.
    coarse_mode = "auto"
    # a beam of ef candidates ranks at most ~ef lists: ask the HNSW
    # quantizer for ef = max(efSearch, coarse_ef_factor * nprobe)
    coarse_ef_factor = 2

    def _centroid_table(self) -> torch.Tensor:
        q = self.quantizer
        vecs = getattr(q, "vectors", None)
        if vecs is None and hasattr(q, "storage"):
            vecs = q.storage.vectors
        if vecs is None:
            raise NotImplementedError(
                "coarse quantization needs a quantizer with a centroid "
                "table (IndexFlat, IndexHNSWFlat); other quantizers are not "
                "ported yet")
        return vecs

    def _use_exact_coarse(self) -> bool:
        """'auto' takes the exact product up to this many lists, where one
        product over the table is cheaper than a graph traversal."""
        if self.coarse_mode == "quantizer":
            return False
        return self.coarse_mode == "flat" or \
            self.nlist <= self._COARSE_EXACT_MAX_NLIST or \
            not hasattr(self.quantizer, "hnsw")

    _COARSE_EXACT_MAX_NLIST = 262144

    def _coarse_search_device(self, xq_dev: torch.Tensor, nprobe: int):
        if self._use_exact_coarse():
            return D.knn(xq_dev, self._centroid_table(), nprobe,
                         self.metric_type)
        q = self.quantizer
        if not hasattr(q, "hnsw"):
            raise NotImplementedError(
                "coarse_mode='quantizer' is ported for HNSW quantizers only")
        from .hnsw import SearchParametersHNSW

        ef = max(q.hnsw.efSearch, self.coarse_ef_factor * nprobe)
        return q.search_device(xq_dev, nprobe,
                               params=SearchParametersHNSW(efSearch=ef))

    def _assign(self, x: np.ndarray) -> np.ndarray:
        if self._use_exact_coarse():
            _, a = self._coarse_search_device(self._to_device(x), 1)
            return a[:, 0].cpu().numpy()
        if not hasattr(self.quantizer, "hnsw"):
            raise NotImplementedError(
                "coarse_mode='quantizer' is ported for HNSW quantizers only")
        _, a = self.quantizer.search(x, 1)
        return np.asarray(a)[:, 0]

    def _repack(self) -> None:
        """Rebuild the packed device invlists from the host store; only
        chunks without a cached assignment are assigned (O(new rows) device
        work, like InvertedLists::add_entries)."""
        self._dirty = False
        if not self._xb_host:
            self.invlists = None
            self._ids_flat = None
            self._ids_trivial = True
            self._list_sizes_dev = None
            return
        for j, a in enumerate(self._assign_host):
            if a is None:
                self._assign_host[j] = np.asarray(
                    self._assign(self._xb_host[j]), np.int64)
        ids = np.concatenate(self._ids_host)
        assign = np.concatenate(self._assign_host)
        n = len(ids)
        self._ids_flat = ids
        self._ids_trivial = bool(
            n == 0 or (ids[0] == 0 and ids[-1] == n - 1
                       and np.array_equal(ids, np.arange(n, dtype=np.int64))))
        x = np.concatenate(self._xb_host)
        self.invlists = self._pack(x, np.arange(n, dtype=np.int64), assign)
        self._list_sizes_dev = None

    def _pack(self, x: np.ndarray, ids: np.ndarray, assign: np.ndarray):
        """The device invlists of rows ``x`` (stored ids ``ids``, lists
        ``assign``): raw f32 storage and its bf16 stream for Flat; codec
        subclasses pack their codes."""
        return ivf_scan.pack_invlists(x, ids, assign, self.nlist,
                                      self.block_size, device=self.device)

    def _map_ids(self, I) -> np.ndarray:
        """Map stored row indices back to user int64 ids (-1 preserved)."""
        I = np.asarray(I, np.int64)
        if self._ids_trivial or self._ids_flat is None:
            return I
        out = self._ids_flat[np.clip(I, 0, len(self._ids_flat) - 1)]
        out[I < 0] = -1
        return out

    # --- search -------------------------------------------------------------
    def _effective_params(self, params) -> int:
        """The nprobe of this call. Selectors and max_codes need the
        query-major scan, which is not ported yet."""
        nprobe = self.nprobe
        if params is not None:
            if getattr(params, "sel", None) is not None or \
                    getattr(params, "max_codes", 0):
                raise NotImplementedError(
                    "selectors and max_codes need the query-major scan, "
                    "which is not ported yet")
            if params.nprobe:
                nprobe = params.nprobe
        return min(max(int(nprobe), 1), self.nlist)

    def _search_device(self, xq_dev: torch.Tensor, k: int, nprobe: int):
        """Coarse quantization + fused invlist scan, all on the device.
        Returns (D, I) tensors; I holds stored row indices."""
        _, probes = self._coarse_search_device(xq_dev, nprobe)
        return self._scan_probes(xq_dev, probes, k)

    def _scan_probes(self, xq_dev: torch.Tensor, probes: torch.Tensor,
                     k: int):
        """The invlist scan of the probed lists: one kernel launch."""
        Dv, Iv, _ = scan_invlists_fused(xq_dev, probes, self.invlists, k,
                                        self.metric_type)
        return Dv, Iv

    def _ready(self) -> None:
        self._maybe_repack()
        if self.invlists is None:
            raise RuntimeError("empty index")

    def search(self, x, k: int, *,
               params: Optional[SearchParametersIVF] = None):
        """Both phases on the device, one sync at the end."""
        self._ready()
        x = self._check_input(x)
        nprobe = self._effective_params(params)
        Dv, Iv = self._search_device(self._to_device(x), k, nprobe)
        return Dv.cpu().numpy(), self._map_ids(Iv.cpu().numpy())

    def search_device(self, xq_dev: torch.Tensor, k: int):
        """Device-in/device-out search with the index's current settings;
        map the returned row indices with `_map_ids` after copying."""
        self._ready()
        return self._search_device(xq_dev, k, self._effective_params(None))

    def search_stats(self, x, k: int, *,
                     params: Optional[SearchParametersIVF] = None):
        """search + the QueryLatencyStats split (fork's
        IndexIVF::search_stats, faiss/IndexIVF.cpp:727-860); the phases
        are fenced by device syncs, so use search() for throughput.
        ``ndis`` counts the entries of the probed lists (faiss
        IndexIVFStats.ndis); the scan itself also reads block padding."""
        self._ready()
        x = self._check_input(x)
        nprobe = self._effective_params(params)
        xq_dev = self._to_device(x)
        with Timer(self.device) as t_q:
            _, probes = self._coarse_search_device(xq_dev, nprobe)
        with Timer(self.device) as t_s:
            Dv, Iv = self._scan_probes(xq_dev, probes, k)
            Dv = Dv.cpu().numpy()
            Iv = self._map_ids(Iv.cpu().numpy())
        sizes = self._list_sizes_device()
        ndis = int(torch.where(probes >= 0, sizes[probes.clamp(min=0)],
                               0).sum())
        stats = SearchStats(
            nq=len(x), total_us=t_q.us + t_s.us, quantization_us=t_q.us,
            list_scan_us=t_s.us, ndis=ndis, nlist_visited=len(x) * nprobe)
        base.indexIVF_stats.accumulate(stats)
        return Dv, Iv, stats

    def _list_sizes_device(self) -> torch.Tensor:
        if self._list_sizes_dev is None:
            self._list_sizes_dev = torch.as_tensor(
                self.list_sizes, device=self.device)
        return self._list_sizes_dev

    @property
    def list_sizes(self) -> np.ndarray:
        """Per-list entry counts (InvertedLists::list_size for all lists),
        from the packed ids: lists own contiguous block ranges."""
        self._maybe_repack()
        if self.invlists is None:
            return np.zeros(self.nlist, np.int64)
        ids = self.invlists.ids[:-1].cpu().numpy()
        valid_per_block = (ids >= 0).sum(axis=1).astype(np.int64)
        csum = np.concatenate([[0], np.cumsum(valid_per_block)])
        starts = self.invlists.list_block_start.cpu().numpy().astype(np.int64)
        nblk = self.invlists.list_nblocks.cpu().numpy().astype(np.int64)
        # empty lists point their start at the dummy block with nblk == 0
        lo = np.minimum(starts, len(valid_per_block))
        hi = np.minimum(starts + nblk, len(valid_per_block))
        return csum[hi] - csum[lo]

    def imbalance_factor(self) -> float:
        from ..ops.kmeans import imbalance_factor

        return imbalance_factor(self.list_sizes)

    def reset(self) -> None:
        self._xb_host, self._ids_host, self._assign_host = [], [], []
        self.invlists = None
        self._ids_flat = None
        self._ids_trivial = True
        self._list_sizes_dev = None
        self._dirty = False
        self.ntotal = 0


class IndexIVFFlat(IndexIVF):
    """IVF with raw float storage (faiss/IndexIVFFlat.{h,cpp})."""


def make_ivf_flat(d: int, nlist: int, metric: int = D.METRIC_L2, *,
                  device="cuda") -> IndexIVFFlat:
    """IVF with a flat coarse quantizer (= factory "IVFx,Flat")."""
    quant = IndexFlat(d, metric, device=device)
    return IndexIVFFlat(quant, d, nlist, metric, device=device)
