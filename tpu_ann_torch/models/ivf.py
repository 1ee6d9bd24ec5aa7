"""IndexIVF / IndexIVFFlat / IndexIVFFlatDedup — PyTorch counterpart of
`tpu_ann/models/ivf.py` (faiss/IndexIVF.{h,cpp} + IndexIVFFlat.{h,cpp}).

Training runs k-means on the index's device (`Level1Quantizer::train_q1`,
faiss/IndexIVF.cpp:66-130). A quantizer without a centroid table (an
additive coarse quantizer) searches itself on the device, and codecs of
residuals take its decoded centroids. Adding assigns each new chunk once with the
exact coarse product, keeps a chunked host store, and repacks the
block-packed invlists (`ops.ivf_scan`). Search is exact coarse
quantization (one f32 product + top-nprobe over the centroids) followed by
the list-major fused scan (`ops.ivf_scan_fused`): on a CUDA device every
search is one launch of the hand-written kernel, with no size gate and no
fallback to another scan. The reference's rule sends a search to the
query-major scan (`ops.ivf_scan.scan_invlists`, plain torch) instead: an
IDSelector, an explicit max_codes below the default cap, or
``scan_mode="query"``. `search_stats` reports the fork's quantization /
list-scan split (faiss/IndexIVF.h:28-32) and the split of its steps, from
the spans that `search` runs them in (`tpu_ann_torch.trace`).

The DirectMap (invlists/DirectMap.h; row -> packed slot, built at each
repack) lets remove_ids and update_vectors edit the device invlists in
place, O(affected): a removed slot's id becomes -1 (every scan masks it),
the host store is compacted at the next full repack. Unlike the reference,
the port keeps no device mirror of the host chunks: a repack uploads the
packed layout once, from the host.
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
from ..ops.range_search import range_search_ivf
from ..trace import collect, fence, span
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
        # quantizer_trains_alone (faiss Level1Quantizer): 1 = the quantizer
        # is used (and trained) as it is; any other value = k-means on this
        # level, as the reference's train_q1 treats it
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
        # "auto" / "fused" / "grouped": the fused scan (K3; the reference's
        # grouped scan is not ported); "query": the query-major scan
        self.scan_mode = "auto"

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
        self._append_chunk(x.copy(), ids.copy())
        if repack:
            self._repack()

    def _pending_removals(self) -> int:
        """Removed rows still in the host store (compacted at the next full
        repack)."""
        m = self._removed_mask
        return int(m.sum()) if m is not None else 0

    def _check_mutable(self) -> None:
        """An index carried over or read without its host store (see
        utils.convert) is search-only: a repack would drop its rows."""
        if self.ntotal and sum(len(c) for c in self._xb_host) \
                - self._pending_removals() != self.ntotal:
            raise RuntimeError(
                "index is search-only (no host vector store); "
                "add / remove / update are unavailable")

    def _append_chunk(self, x: np.ndarray, ids: np.ndarray,
                      assign: Optional[np.ndarray] = None) -> None:
        """Append one host chunk (with its coarse assignment if known) and
        mark the device invlists stale."""
        self._check_mutable()
        self._xb_host.append(x)
        self._ids_host.append(np.asarray(ids, np.int64))
        self._assign_host.append(
            None if assign is None else np.asarray(assign, np.int64))
        if self._removed_mask is not None:
            # keep the deferred-removal mask aligned with the host store
            self._removed_mask = np.concatenate(
                [self._removed_mask, np.zeros(len(x), bool)])
        self.ntotal += len(x)
        self._dirty = True

    def invalidate_assign(self) -> None:
        """Drop the cached coarse assignments (after the quantizer's
        centroids change)."""
        self._assign_host = [None] * len(self._xb_host)

    def _maybe_repack(self) -> None:
        if self._dirty:
            self._repack()

    # --- coarse quantization ----------------------------------------------
    # 'auto' and 'flat' use the exact product over the centroid table (an
    # IndexFlat's rows, or an HNSW quantizer's storage); 'quantizer' asks
    # the quantizer itself: an HNSW quantizer's graph with a widened beam,
    # any other through its search_device or search (reference :228-256).
    coarse_mode = "auto"
    # a beam of ef candidates ranks at most ~ef lists: ask the HNSW
    # quantizer for ef = max(efSearch, coarse_ef_factor * nprobe)
    coarse_ef_factor = 2

    def _centroid_table(self) -> Optional[torch.Tensor]:
        """The quantizer's centroid rows (an IndexFlat's, or an HNSW
        quantizer's storage), or None for a quantizer without a table (an
        additive coarse quantizer, whose centroids are implicit)."""
        q = self.quantizer
        vecs = getattr(q, "vectors", None)
        if vecs is None and hasattr(q, "storage"):
            vecs = q.storage.vectors
        return vecs

    def _coarse_centroids(self) -> torch.Tensor:
        """(nlist, d) f32 centroids: the table, or a virtual quantizer's
        centroids, enumerated once and kept by the quantizer (reference
        models/ivf_pq.py:66-78)."""
        vecs = self._centroid_table()
        if vecs is not None:
            return vecs.float()
        return self.quantizer._all_centroids()

    def _use_exact_coarse(self) -> bool:
        """'auto' takes the exact product over the centroid table, where
        the quantizer has one, up to this many lists (or always when it is
        not a graph); a quantizer without a table searches itself (the
        reference's rule, :213-219). 'flat' forces the product, over the
        decoded centroids if need be."""
        if self.coarse_mode == "quantizer":
            return False
        if self.coarse_mode == "flat":
            return True
        return self._centroid_table() is not None and (
            self.nlist <= self._COARSE_EXACT_MAX_NLIST
            or not hasattr(self.quantizer, "hnsw"))

    _COARSE_EXACT_MAX_NLIST = 262144

    def _coarse_search_device(self, xq_dev: torch.Tensor, nprobe: int):
        if self._use_exact_coarse():
            return D.knn(xq_dev, self._coarse_centroids(), nprobe,
                         self.metric_type)
        q = self.quantizer
        if hasattr(q, "hnsw"):
            from .hnsw import SearchParametersHNSW

            ef = max(q.hnsw.efSearch, self.coarse_ef_factor * nprobe)
            return q.search_device(xq_dev, nprobe,
                                   params=SearchParametersHNSW(efSearch=ef))
        if hasattr(q, "search_device"):
            return q.search_device(xq_dev, nprobe)
        cd, probes = q.search(xq_dev.cpu().numpy(), nprobe)
        return (torch.as_tensor(cd, device=self.device),
                torch.as_tensor(np.asarray(probes, np.int64),
                                device=self.device))

    def _assign(self, x: np.ndarray) -> np.ndarray:
        if self._use_exact_coarse():
            _, a = self._coarse_search_device(self._to_device(x), 1)
            return a[:, 0].cpu().numpy()
        _, a = self.quantizer.search(x, 1)
        return np.asarray(a)[:, 0]

    def _repack(self) -> None:
        """Rebuild the packed device invlists from the host store; only
        chunks without a cached assignment are assigned (O(new rows) device
        work, like InvertedLists::add_entries). Pending removals are
        dropped from the host store first."""
        self._dirty = False
        for j, a in enumerate(self._assign_host):
            if a is None:
                self._assign_host[j] = np.asarray(
                    self._assign(self._xb_host[j]), np.int64)
        if self._pending_removals():
            mask, off = self._removed_mask, 0
            nx, ni, na = [], [], []
            for xs, ids_c, a in zip(self._xb_host, self._ids_host,
                                    self._assign_host):
                keep = ~mask[off:off + len(xs)]
                off += len(xs)
                if keep.all():
                    nx.append(xs)
                    ni.append(ids_c)
                    na.append(a)
                elif keep.any():
                    nx.append(xs[keep])
                    ni.append(ids_c[keep])
                    na.append(a[keep])
            self._xb_host, self._ids_host, self._assign_host = nx, ni, na
        self._removed_mask = None
        self._lists_changed()
        if self._xb_host:
            ids = np.concatenate(self._ids_host)
            assign = np.concatenate(self._assign_host)
            x = np.concatenate(self._xb_host)
        else:
            # no rows: an empty stream, which every search answers with
            # ids -1 and the metric's worst value, as faiss does
            ids = assign = np.zeros(0, np.int64)
            x = np.zeros((0, self.d), np.float32)
        n = len(ids)
        self._ids_flat = ids
        self._ids_trivial = bool(
            n == 0 or (ids[0] == 0 and ids[-1] == n - 1
                       and np.array_equal(ids, np.arange(n, dtype=np.int64))))
        self.invlists = self._pack(x, np.arange(n, dtype=np.int64), assign)
        self._build_direct_map(assign)

    def _pack(self, x: np.ndarray, ids: np.ndarray, assign: np.ndarray):
        """The device invlists of rows ``x`` (stored ids ``ids``, lists
        ``assign``): raw f32 storage and its bf16 stream for Flat; codec
        subclasses pack their codes."""
        return ivf_scan.pack_invlists(x, ids, assign, self.nlist,
                                      self.block_size, device=self.device)

    def _lists_changed(self) -> None:
        """Drop what is derived from the invlists' id plane and list ranges
        (after a repack, or an in-place edit by remove_ids /
        update_vectors): the cached list sizes and the longest list."""
        self._list_sizes_dev = None
        self._lsizes = self._lsizes_for = None
        self._max_nb = None

    # --- DirectMap (invlists/DirectMap.h): row -> packed slot --------------
    # Built at each repack from the assignment (reference :363-424); gives
    # O(affected) edits of the device invlists instead of a full repack.
    _row_slot: Optional[np.ndarray] = None      # row -> flat slot
    _row_list: Optional[np.ndarray] = None      # row -> owning list
    _list_fill: Optional[np.ndarray] = None     # list -> used slots
    _id_order: Optional[np.ndarray] = None      # argsort(_ids_flat)
    _removed_mask: Optional[np.ndarray] = None  # row -> removed (deferred)
    _holes = 0

    def _build_direct_map(self, assign: Optional[np.ndarray]) -> None:
        il = self.invlists
        if il is None or assign is None:
            self._row_slot = self._row_list = self._list_fill = None
            self._id_order = self._removed_mask = None
            self._holes = 0
            return
        n = len(assign)
        starts = il.list_block_start.cpu().numpy().astype(np.int64)
        sizes = np.bincount(assign, minlength=self.nlist)
        order = np.argsort(assign, kind="stable")
        src_starts = np.zeros(self.nlist + 1, np.int64)
        np.cumsum(sizes, out=src_starts[1:])
        rank = np.arange(n, dtype=np.int64) - src_starts[assign[order]]
        self._row_slot = np.empty(n, np.int64)
        self._row_slot[order] = starts[assign[order]] * self.block_size \
            + rank
        self._row_list = np.asarray(assign, np.int64).copy()
        self._list_fill = sizes.astype(np.int64)
        self._id_order = np.argsort(self._ids_flat, kind="stable")
        self._removed_mask = np.zeros(n, bool)
        self._holes = 0

    def _rows_of_ids(self, ids: np.ndarray) -> np.ndarray:
        """User ids -> packed rows through the sorted-id index (missing ->
        -1): the DirectMap lookup, vectorized, O(affected log n)."""
        ids = np.asarray(ids, np.int64)
        if self._ids_trivial:
            rows = ids.copy()
            rows[(rows < 0) | (rows >= len(self._ids_flat))] = -1
            return rows
        so = self._id_order
        sids = self._ids_flat[so]
        pos = np.searchsorted(sids, ids)
        pos_c = np.minimum(pos, len(sids) - 1)
        hit = (pos < len(sids)) & (sids[pos_c] == ids)
        return np.where(hit, so[pos_c], -1)

    def _chunk_positions(self, rows: np.ndarray):
        """rows -> (chunk index, offset) in the host store."""
        lens = np.asarray([len(c) for c in self._xb_host], np.int64)
        bounds = np.concatenate([[0], np.cumsum(lens)])
        cj = np.searchsorted(bounds, rows, side="right") - 1
        return cj, rows - bounds[cj]

    def _incremental_capable(self) -> bool:
        return (self._row_slot is not None and self.invlists is not None
                and not self._dirty)

    def _map_ids(self, I) -> np.ndarray:
        """Map stored row indices back to user int64 ids (-1 preserved)."""
        I = np.asarray(I, np.int64)
        if self._ids_trivial or self._ids_flat is None:
            return I
        out = self._ids_flat[np.clip(I, 0, len(self._ids_flat) - 1)]
        out[I < 0] = -1
        return out

    # --- search parameters --------------------------------------------------
    # index-level scan budget (IndexIVF.h:79 max_codes; 0 = unlimited);
    # SearchParametersIVF.max_codes overrides it per call
    max_codes = 0
    # per-list scan cap of the query-major and range routes, as a multiple
    # of the average list length (0 = none, the default). The reference
    # defaults to 16, a TPU-watchdog workaround (reference :444-463) that
    # makes those routes read only part of a long list; the port keeps the
    # attribute but reads whole lists unless a caller sets it
    max_list_scan_factor = 0
    # query batches above this many rows are searched in pages (0 = off)
    search_chunk = 0
    _max_nb = None

    def _longest_list_blocks(self) -> int:
        """The longest list's block count, cached until the lists change."""
        if self._max_nb is None:
            self._max_nb = self.invlists.max_nblocks_per_list
        return self._max_nb

    def _default_capped_mnb(self) -> int:
        """Blocks read per list by the query-major and range routes without
        an explicit max_codes: the longest list, capped at max(64,
        max_list_scan_factor x the average list's blocks) where the factor
        is set. K3 reads whole lists (in both packages)."""
        mnb = self._longest_list_blocks()
        if self.max_list_scan_factor:
            avg_nb = max(1, -(-self.ntotal // (self.nlist * self.block_size)))
            mnb = min(mnb, max(64, self.max_list_scan_factor * avg_nb))
        return mnb

    def _effective_params(self, params):
        """(nprobe, blocks read per list) of this call (reference
        :465-477)."""
        nprobe = self.nprobe
        max_codes = self.max_codes
        if params is not None:
            if params.nprobe:
                nprobe = params.nprobe
            if getattr(params, "max_codes", 0):
                max_codes = params.max_codes
        nprobe = min(max(int(nprobe), 1), self.nlist)
        mnb = self._default_capped_mnb()
        if max_codes:
            mnb = min(mnb, max(1, -(-int(max_codes) // self.block_size)))
        return nprobe, mnb

    def _sel_mask(self, params) -> Optional[torch.Tensor]:
        """params.sel (an IDSelector) as a uint8 bitmap over stored ROWS on
        the device: membership is taken at each row's user id on the host
        (reference :479-490)."""
        sel = getattr(params, "sel", None) if params is not None else None
        if sel is None or self._ids_flat is None or not len(self._ids_flat):
            return None
        return torch.from_numpy(
            sel.member_array(self._ids_flat).astype(np.uint8)).to(
                self.device)

    def coarse_assign(self, x, nprobe: int) -> np.ndarray:
        """(nq, nprobe) probed list ids of each query: the coarse phase
        alone (faiss Index::assign on the quantizer)."""
        x = self._check_input(x)
        _, probes = self._coarse_search_device(self._to_device(x), nprobe)
        return probes.cpu().numpy()

    def list_of_ids(self, ids) -> np.ndarray:
        """The inverted list each stored id lives in (-1 if absent or
        removed): the DirectMap id -> list lookup."""
        self._maybe_repack()
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if self.invlists is None or self._row_list is None:
            return np.full(len(ids), -1, np.int64)
        rows = self._rows_of_ids(ids)
        safe = np.maximum(rows, 0)
        out = np.where(rows >= 0, self._row_list[safe], -1)
        return np.where(self._removed_mask[safe] & (rows >= 0), -1, out)

    # --- search -------------------------------------------------------------
    def _query_major(self, mnb: Optional[int], id_mask) -> bool:
        """The reference's route rule (:549-586): a selector, a cap below
        the longest list (an explicit max_codes, or a max_list_scan_factor
        a caller set), or scan_mode "query" takes the query-major scan;
        everything else the fused scan."""
        return (id_mask is not None or self.scan_mode == "query"
                or (mnb is not None and mnb < self._longest_list_blocks()))

    def _search_device(self, xq_dev: torch.Tensor, k: int, nprobe: int,
                       mnb: Optional[int] = None, id_mask=None):
        """Coarse quantization + invlist scan, all on the device, the
        coarse step in its span and the scan in ``list_scan_us``'s fence
        (`tpu_ann_torch.trace`). Returns (D, I, probes, ndis); I holds
        stored row indices, ndis is `_scan_probes`'."""
        with span("ivf.coarse"):
            _, probes = self._coarse_search_device(xq_dev, nprobe)
        with fence("list_scan_us"):
            Dv, Iv, ndis = self._scan_probes(xq_dev, probes, k, mnb, id_mask)
        return Dv, Iv, probes, ndis

    def _scan_probes(self, xq_dev: torch.Tensor, probes: torch.Tensor,
                     k: int, mnb: Optional[int] = None, id_mask=None):
        """The invlist scan of the probed lists: one kernel launch, or the
        query-major scan where `_query_major` says so. Returns (D, I,
        ndis): the query-major scan's count of rows scored, None after the
        fused scan (the caller counts the probed lists' entries)."""
        if self._query_major(mnb, id_mask):
            return ivf_scan.scan_invlists(
                xq_dev, probes, self.invlists, k, self.metric_type,
                max_nblocks=mnb or self._default_capped_mnb(),
                id_mask=id_mask)
        Dv, Iv, _ = scan_invlists_fused(xq_dev, probes, self.invlists, k,
                                        self.metric_type)
        return Dv, Iv, None

    def _ready(self) -> None:
        self._maybe_repack()
        if self.invlists is None:
            if not self.is_trained:
                raise RuntimeError("empty index")
            self._repack()          # trained, no rows: the empty stream

    def search(self, x, k: int, *,
               params: Optional[SearchParametersIVF] = None):
        """Both phases on the device, one sync at the end (the copy out).
        Each step runs in its span (`tpu_ann_torch.trace`)."""
        with span("ivf.search"):
            x, *setting = self._search_input(x, params)
            step = self.search_chunk
            if not step or len(x) <= step:
                return self._search_steps(x, k, *setting)[:2]
            outs = [self._search_steps(x[i:i + step], k, *setting)
                    for i in range(0, len(x), step)]
            return (np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[1] for o in outs]))

    def _search_input(self, x, params):
        """The input step of a search, in its span: (the checked rows,
        nprobe, blocks read per list, the selector's row mask or None)."""
        with span("ivf.input"):
            self._ready()
            x = self._check_input(x)
            nprobe, mnb = self._effective_params(params)
            return x, nprobe, mnb, self._sel_mask(params)

    def _search_steps(self, x: np.ndarray, k: int, nprobe: int,
                      mnb: Optional[int], id_mask):
        """The search after its input step, each step in its span: the
        upload, `_search_device`, the copy out with the map to user ids.
        Returns (D, I user ids, probes, ndis)."""
        with span("ivf.upload"):
            xq_dev = self._to_device(x)
        Dv, Iv, probes, ndis = self._search_device(xq_dev, k, nprobe, mnb,
                                                   id_mask)
        with span("ivf.output"):
            Dv, Iv = Dv.cpu().numpy(), self._map_ids(Iv.cpu().numpy())
        return Dv, Iv, probes, ndis

    def search_device(self, xq_dev: torch.Tensor, k: int):
        """Device-in/device-out search with the index's current settings;
        map the returned row indices with `_map_ids` after copying."""
        self._ready()
        return self._search_device(xq_dev, k,
                                   *self._effective_params(None))[:2]

    def search_stats(self, x, k: int, *,
                     params: Optional[SearchParametersIVF] = None):
        """search + the QueryLatencyStats split (fork's
        IndexIVF::search_stats, faiss/IndexIVF.cpp:727-860), filled by the
        spans of search's steps (`tpu_ann_torch.trace`), whose fields,
        each in microseconds for the batch, are:

        - ``quantization_us``: the coarse step, host clock, fenced by
          device syncs at both edges;
        - ``list_scan_us``: the list scan on the same clock, plus
          ``output_us`` (the copy of the results to the host and the map
          to user ids);
        - ``total_us``: the two summed;
        - ``input_us`` (checks and parameters), ``upload_us`` (the
          queries' copy to the device): fenced host clock;
        - ``plan_us``, ``merge_us``: the fused scan's pair plan, and its
          merge and re-rank, on the device's clock (CUDA events read after
          the list scan's closing sync; the host clock on a CPU device),
          zero where the query-major scan runs;
        - ``output_us``: the copy out and the map to user ids, host clock
          (it starts after the scan's closing sync and the copy blocks).

        The fences sync the device, so use search() for throughput (search
        runs the same spans without the fences or the events, and they
        cost nothing unless the profiler is on). ``ndis`` is the
        query-major scan's count where that scan runs, else the entries of
        the probed lists (faiss IndexIVFStats.ndis; the fused scan also
        reads block padding). Unlike the reference's, this applies
        ``params.sel``, as search() does."""
        stats = SearchStats()
        with collect(stats, self.device), span("ivf.search"):
            x, nprobe, mnb, id_mask = self._search_input(x, params)
            Dv, Iv, probes, ndis = self._search_steps(x, k, nprobe, mnb,
                                                      id_mask)
        if ndis is None:
            sizes = self._list_sizes_device()
            ndis = torch.where(probes >= 0, sizes[probes.clamp(min=0)],
                               0).sum()
        stats.nq, stats.ndis = len(x), int(ndis)
        stats.nlist_visited = len(x) * nprobe
        stats.total_us = stats.quantization_us + stats.list_scan_us
        base.indexIVF_stats.accumulate(stats)
        return Dv, Iv, stats

    def _list_sizes_device(self) -> torch.Tensor:
        if self._list_sizes_dev is None:
            self._list_sizes_dev = torch.as_tensor(
                self._list_sizes_host(), device=self.device)
        return self._list_sizes_dev

    _lsizes = None
    _lsizes_for = None

    def _list_sizes_host(self) -> np.ndarray:
        """(nlist,) int64 per-list entry counts (the reference's
        InvertedLists::list_size), cached against the invlists object and
        dropped by `_lists_changed`."""
        if self._lsizes is None or self._lsizes_for is not self.invlists:
            self._lsizes = self.list_sizes
            self._lsizes_for = self.invlists
        return self._lsizes

    def search_stats_per_query(self, x, k: int, *,
                               params: Optional[SearchParametersIVF] = None):
        """search + per-query QueryLatencyStats, the fork's central
        addition (faiss/IndexIVF.h:28-32, filled at IndexIVF.cpp:1064-1105;
        reference tpu_ann/models/ivf.py:696-754).

        Each query runs at batch 1: the coarse search, a sync (the probes'
        copy to the host), then the scan of its probes (one kernel launch
        on a CUDA device, or the query-major scan under a selector or an
        explicit max_codes), each phase fenced by device syncs, so the
        arrays are per-query wall-clock times. ``ndis`` is the exact entry
        count of the probed lists. The batch-1 shapes are warmed up outside
        the timed loop. Use search() for throughput; this is the
        tail-latency surface."""
        self._ready()
        x = self._check_input(x)
        nprobe, mnb = self._effective_params(params)
        id_mask = self._sel_mask(params)
        nq = len(x)
        xq_dev = self._to_device(x)
        lsizes = self._list_sizes_host()
        q_us = np.zeros(nq, np.float64)
        s_us = np.zeros(nq, np.float64)
        ndis = np.zeros(nq, np.int64)
        Ds, Is = [], []
        _, probes = self._coarse_search_device(xq_dev[:1], nprobe)
        self._scan_probes(xq_dev[:1], probes, k, mnb, id_mask)[0].cpu()
        for q in range(nq):
            xq1 = xq_dev[q:q + 1]
            with Timer(self.device) as t_q:
                _, probes = self._coarse_search_device(xq1, nprobe)
                probes_h = probes.cpu().numpy()
            with Timer(self.device) as t_s:
                Dq, Iq, _ = self._scan_probes(xq1, probes, k, mnb, id_mask)
                Ds.append(Dq.cpu().numpy())
                Is.append(Iq.cpu().numpy())
            q_us[q], s_us[q] = t_q.us, t_s.us
            valid = probes_h[(probes_h >= 0) & (probes_h < self.nlist)]
            ndis[q] = int(lsizes[valid].sum())
        Dv = np.concatenate(Ds)
        Iv = self._map_ids(np.concatenate(Is))
        pq = base.QueryLatencyStats(total_us=q_us + s_us,
                                    quantization_us=q_us,
                                    list_scan_us=s_us, ndis=ndis)
        stats = SearchStats(
            nq=nq, total_us=float((q_us + s_us).sum()),
            quantization_us=float(q_us.sum()),
            list_scan_us=float(s_us.sum()), ndis=int(ndis.sum()),
            nlist_visited=nq * nprobe, per_query=pq)
        base.indexIVF_stats.accumulate(stats)
        return Dv, Iv, stats

    def search_preassigned(self, x, k: int, probes):
        """Scan the given coarse assignment, (nq, nprobe) list ids (numpy or
        a tensor) with -1 skipped (faiss/IndexIVF.cpp:399,
        contrib/ivf_tools)."""
        Dv, Iv, _ = self.search_preassigned_stats(x, k, probes)
        return Dv, Iv

    def search_preassigned_stats(self, x, k: int, probes):
        """search_preassigned + SearchStats (the fork's
        IndexIVF::search_preassigned_stats, faiss/IndexIVF.h:306-317): the
        quantization is the caller's, so only the scan is timed."""
        self._ready()
        x = self._check_input(x)
        probes_dev = probes.to(self.device) if isinstance(
            probes, torch.Tensor) else torch.as_tensor(
                np.asarray(probes, np.int64), device=self.device)
        with Timer(self.device) as t_s:
            Dv, Iv, _ = self._scan_probes(self._to_device(x), probes_dev, k)
            Dv = Dv.cpu().numpy()
            Iv = self._map_ids(Iv.cpu().numpy())
        stats = SearchStats(nq=len(x), total_us=t_s.us, list_scan_us=t_s.us,
                            nlist_visited=len(x) * probes_dev.shape[1])
        base.indexIVF_stats.accumulate(stats)
        return Dv, Iv, stats

    def _range_lists(self):
        """The raw invlists that range_search scans (codec subclasses
        decode theirs)."""
        return self.invlists

    def range_search(self, x, radius: float):
        """faiss IndexIVF::range_search over the probed lists, with the
        coarse quantization of search() and the blocks a list of its
        query-major route: (lims, D, I), L2 keeping dis < radius and IP
        dis > radius (reference :756-772)."""
        self._ready()
        x = self._check_input(x)
        nprobe, mnb = self._effective_params(None)
        _, probes = self._coarse_search_device(self._to_device(x), nprobe)
        res = range_search_ivf(x, probes, self._range_lists(), radius,
                               self.metric_type, max_nblocks=mnb)
        return res.lims, res.distances, self._map_ids(res.labels)

    # --- mutation (reference :814-976) --------------------------------------
    def merge_from(self, other, add_id: int = 0) -> None:
        """List-level merge (IndexIVF::merge_from): moves other's host
        chunks, with their coarse assignments, into self and repacks once;
        both must share the trained quantizer. add_id is not supported at
        the list level (re-add with offset ids instead)."""
        if add_id:
            raise ValueError("IndexIVF.merge_from: add_id unsupported; "
                             "use add_with_ids with offset ids")
        from ..utils.contrib import merge_indexes

        merge_indexes(self, [other])
        other.reset()

    def remove_ids(self, sel) -> int:
        """Remove the stored ids an IDSelector matches (IndexIVF::
        remove_ids via the DirectMap). An id selector is looked up in the
        sorted-id index (O(affected log n)), a predicate selector takes one
        host scan of the ids. The removed slots' ids become -1 on the
        device, in place (every scan masks them); the host store is
        compacted at the next full repack, which more than max(1024,
        ntotal // 4) holes trigger. Returns the number removed."""
        self._check_mutable()
        self._maybe_repack()
        if self.invlists is None:
            return 0
        sel_ids = getattr(sel, "ids", None)
        if sel_ids is not None and self._incremental_capable():
            rows = np.unique(self._rows_of_ids(np.asarray(sel_ids,
                                                          np.int64)))
            rows = rows[rows >= 0]
            rows = rows[~self._removed_mask[rows]]
        else:
            member = sel.member_array(self._ids_flat)
            if self._removed_mask is not None:
                member &= ~self._removed_mask
            rows = np.nonzero(member)[0]
        removed = len(rows)
        if removed == 0:
            return 0
        if not self._incremental_capable():
            # no DirectMap (a read index): filter the host store and repack
            self._removed_mask = member
            self.ntotal -= removed
            if self.ntotal:
                self._repack()
            else:
                self.reset()
            return removed
        slots = torch.from_numpy(self._row_slot[rows]).to(self.device)
        self.invlists.ids.view(-1)[slots] = -1
        self._lists_changed()
        self._removed_mask[rows] = True
        self._holes += removed
        self.ntotal -= removed
        if self.ntotal == 0:
            self.reset()
        elif self._holes > max(1024, self.ntotal // 4):
            self._dirty = True               # amortized compaction
        return removed

    def update_vectors(self, ids, x) -> None:
        """Replace stored vectors (IndexIVF::update_vectors): same ids, new
        data, reassigned to their new lists. Flat storage edits the device
        invlists in place: a same-list update overwrites its slot; a move
        to another list appends into that list's block padding (the old
        slot becomes a hole). A move into a full list, and any update of
        coded storage, repacks. Ids that are absent or removed are
        skipped; an id given more than once takes its last vector, as
        faiss's sequential DirectMap update ends up (the reference stores
        each occurrence)."""
        self._check_mutable()
        self._maybe_repack()
        x = self._check_input(x)
        ids = np.asarray(ids, np.int64)
        if len(ids) != len(x):
            raise ValueError("ids / x length mismatch")
        _, last = np.unique(ids[::-1], return_index=True)
        if len(last) < len(ids):
            keep = np.sort(len(ids) - 1 - last)
            ids, x = ids[keep], x[keep]
        if self.invlists is None:
            return
        rows = self._rows_of_ids(ids)
        ok = rows >= 0
        if self._removed_mask is not None:
            ok &= ~self._removed_mask[np.maximum(rows, 0)]
        if not ok.any():
            return
        rows_u, x_u = rows[ok], x[ok]
        cj, off = self._chunk_positions(rows_u)
        for j in np.unique(cj):
            m = cj == j
            if not self._xb_host[j].flags.writeable:     # a read-only map
                self._xb_host[j] = np.array(self._xb_host[j])
            self._xb_host[j][off[m]] = x_u[m]

        il = self.invlists
        if not (self._incremental_capable() and hasattr(il, "data")):
            for j in np.unique(cj):
                self._assign_host[j] = None
            self._repack()
            return
        new_assign = np.asarray(self._assign(x_u), np.int64)
        B = self.block_size
        same = new_assign == self._row_list[rows_u]
        cross = np.nonzero(~same)[0]
        dst_slot = np.empty(len(rows_u), np.int64)
        dst_slot[same] = self._row_slot[rows_u[same]]
        starts = il.list_block_start.cpu().numpy().astype(np.int64)
        nblk = il.list_nblocks.cpu().numpy().astype(np.int64)
        fill = self._list_fill.copy()
        for i in cross:
            lst = new_assign[i]
            if fill[lst] >= nblk[lst] * B:
                # the target list is full: repack
                for j in np.unique(cj):
                    self._assign_host[j] = None
                self._repack()
                return
            dst_slot[i] = starts[lst] * B + fill[lst]
            fill[lst] += 1
        # the old slots of moved rows become mid-list holes (fill tracks
        # the append end, so they are not handed out again)
        self._list_fill = fill
        self._holes += len(cross)
        d = self.d
        xd = torch.from_numpy(np.ascontiguousarray(x_u)).to(self.device)
        sl = torch.from_numpy(dst_slot).to(self.device)
        il.data.view(-1, d)[sl] = xd
        il.data_bf16.view(-1, d)[sl] = xd.to(torch.bfloat16)
        il.norms.view(-1)[sl] = (xd * xd).sum(1)
        flat_ids = il.ids.view(-1)
        if len(cross):
            flat_ids[torch.from_numpy(self._row_slot[rows_u[cross]]).to(
                self.device)] = -1
        flat_ids[sl] = torch.from_numpy(rows_u.astype(np.int32)).to(
            self.device)
        self._lists_changed()
        self._row_slot[rows_u] = dst_slot
        self._row_list[rows_u] = new_assign
        for j in np.unique(cj):
            m = cj == j
            a = self._assign_host[j]
            if a is not None:
                a[off[m]] = new_assign[m]

    # --- misc ---------------------------------------------------------------
    def reset(self) -> None:
        self._xb_host, self._ids_host, self._assign_host = [], [], []
        self.invlists = None
        self._ids_flat = None
        self._ids_trivial = True
        self._lists_changed()
        self._build_direct_map(None)
        self._dirty = False
        self.ntotal = 0

    def reconstruct(self, key: int) -> np.ndarray:
        """The stored vector of user id ``key`` from the host store (a
        removed id raises KeyError, as an absent one does)."""
        self._maybe_repack()
        off = 0
        for xs, ids in zip(self._xb_host, self._ids_host):
            hit = np.nonzero(ids == key)[0]
            if self._removed_mask is not None:
                hit = hit[~self._removed_mask[off + hit]]
            if hit.size:
                return xs[hit[0]]
            off += len(xs)
        raise KeyError(key)

    # --- standalone codec (faiss/IndexIVF.cpp sa_encode / sa_decode): a
    #     code is the list id in coarse_code_size little-endian bytes, then
    #     the subclass's payload (reference :1002-1054) ----------------------
    def coarse_code_size(self) -> int:
        """Bytes needed to store a list id (IndexIVF::coarse_code_size)."""
        nl, nbyte = self.nlist - 1, 0
        while nl > 0:
            nbyte += 1
            nl >>= 8
        return nbyte

    def encode_listno(self, listnos) -> np.ndarray:
        listnos = np.asarray(listnos, np.int64)
        nbyte = self.coarse_code_size()
        out = np.zeros((len(listnos), nbyte), np.uint8)
        for b in range(nbyte):
            out[:, b] = (listnos >> (8 * b)) & 0xFF
        return out

    def decode_listno(self, codes) -> np.ndarray:
        codes = np.asarray(codes, np.uint8)
        out = np.zeros(len(codes), np.int64)
        for b in range(codes.shape[1]):
            out |= codes[:, b].astype(np.int64) << (8 * b)
        return out

    def _sa_payload_size(self) -> int:
        # Flat storage: raw little-endian f32 rows (IndexIVFFlat's
        # code_size = 4 d)
        return 4 * self.d

    def _sa_encode_payload(self, x: np.ndarray,
                           assign: np.ndarray) -> np.ndarray:
        raw = np.ascontiguousarray(np.asarray(x, dtype="<f4"))
        return raw.view(np.uint8).reshape(len(x), 4 * self.d)

    def _sa_decode_payload(self, payload: np.ndarray,
                           listno: np.ndarray) -> np.ndarray:
        raw = np.ascontiguousarray(payload).view("<f4")
        return raw.reshape(len(payload), self.d).astype(np.float32)

    def sa_code_size(self) -> int:
        return self.coarse_code_size() + self._sa_payload_size()

    def sa_encode(self, x) -> np.ndarray:
        x = self._check_input(x)
        assign = self.coarse_assign(x, 1)[:, 0]
        return np.concatenate([self.encode_listno(assign),
                               self._sa_encode_payload(x, assign)], axis=1)

    def sa_decode(self, codes) -> np.ndarray:
        codes = np.ascontiguousarray(np.asarray(codes, np.uint8))
        cs = self.coarse_code_size()
        return self._sa_decode_payload(codes[:, cs:],
                                       self.decode_listno(codes[:, :cs]))

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


class IndexIVFFlat(IndexIVF):
    """IVF with raw float storage (faiss/IndexIVFFlat.{h,cpp})."""


class IndexIVFFlatDedup(IndexIVFFlat):
    """IVF-Flat that stores each distinct vector once (faiss
    IndexIVFFlatDedup, IndexIVFFlat.h:57; reference :1088-1227): an exact
    duplicate of a stored vector in the same list is recorded in
    ``instances`` (stored id -> duplicate ids) instead of stored; search
    expands the duplicates into the ranked lists (IndexIVFFlat.cpp:346-400)
    and remove_ids promotes a surviving duplicate when its stored
    representative goes. Duplicates key on (coarse list, vector bytes)."""

    def __init__(self, quantizer: Index, d: int, nlist: int,
                 metric: int = D.METRIC_L2, block_size: int = 128, *,
                 device="cuda"):
        super().__init__(quantizer, d, nlist, metric, block_size,
                         device=device)
        self.instances: dict = {}
        self._keys: Optional[dict] = None

    def _ensure_keys(self) -> dict:
        """(list, vector bytes) -> stored id, rebuilt from the host store
        (derived state; survives load and merge)."""
        if self._keys is None:
            keys: dict = {}
            for j, (xs, ids) in enumerate(zip(self._xb_host,
                                              self._ids_host)):
                a = self._assign_host[j]
                if a is None:
                    a = np.asarray(self._assign(xs), np.int64)
                    self._assign_host[j] = a
                for i in range(len(xs)):
                    keys[(int(a[i]), xs[i].tobytes())] = int(ids[i])
            self._keys = keys
        return self._keys

    def train(self, x) -> None:
        # the reference also dedups the training set
        super().train(np.unique(self._check_input(x), axis=0))

    def add_with_ids(self, x, ids, *, repack: bool = True) -> None:
        if not self.is_trained:
            raise RuntimeError("train() before add()")
        x = self._check_input(x)
        ids = np.asarray(ids, np.int64)
        if len(ids) != len(x):
            raise ValueError("ids / x length mismatch")
        keys = self._ensure_keys()
        assign = np.asarray(self._assign(x), np.int64)
        keep = np.ones(len(x), bool)
        for i in range(len(x)):
            key = (int(assign[i]), x[i].tobytes())
            rep = keys.get(key)
            if rep is None:
                keys[key] = int(ids[i])
            else:
                self.instances.setdefault(rep, []).append(int(ids[i]))
                keep[i] = False
        if keep.any():
            self._append_chunk(x[keep].copy(), ids[keep].copy(),
                               assign[keep])
        if repack:
            self._repack()

    def search(self, x, k: int, *,
               params: Optional[SearchParametersIVF] = None):
        Dv, Iv = super().search(x, k, params=params)
        if not self.instances:
            return Dv, Iv
        # each duplicate follows its representative at the same distance,
        # truncated at k (IndexIVFFlat.cpp:360-400)
        for q in range(len(Iv)):
            if not any(int(i) in self.instances for i in Iv[q] if i >= 0):
                continue
            dd, ii = [], []
            for dist, i in zip(Dv[q], Iv[q]):
                dd.append(dist)
                ii.append(i)
                for dup in self.instances.get(int(i), ()):
                    dd.append(dist)
                    ii.append(dup)
                if len(ii) >= k:
                    break
            Dv[q] = dd[:k]
            Iv[q] = ii[:k]
        return Dv, Iv

    def remove_ids(self, sel) -> int:
        self._check_mutable()
        self._maybe_repack()
        removed = 0
        new_instances: dict = {}
        promote: dict = {}
        for rep, dups in self.instances.items():
            da = np.asarray(dups, np.int64)
            gone = sel.member_array(da)
            keep_dups = [int(v) for v in da[~gone]]
            removed += int(gone.sum())
            if bool(sel.member_array(np.asarray([rep], np.int64))[0]):
                # with no duplicate left the row itself goes, and the base
                # removal counts it (the reference counts it here too)
                if keep_dups:
                    # the stored row survives under a duplicate's id
                    removed += 1
                    promote[int(rep)] = keep_dups[0]
                    if keep_dups[1:]:
                        new_instances[keep_dups[0]] = keep_dups[1:]
            elif keep_dups:
                new_instances[int(rep)] = keep_dups
        self.instances = new_instances
        if promote:
            pk = np.asarray(list(promote), np.int64)
            for j, ids in enumerate(self._ids_host):
                m = np.isin(ids, pk)
                if m.any():
                    ids = ids.copy()
                    ids[m] = [promote[int(v)] for v in ids[m]]
                    self._ids_host[j] = ids
            # promoted ids change the row -> id map: repack before the
            # base removal looks ids up
            self._dirty = True
        removed += super().remove_ids(sel)
        self._keys = None
        return removed

    def update_vectors(self, ids, x) -> None:
        raise RuntimeError(
            "update_vectors not implemented for IndexIVFFlatDedup "
            "(faiss parity, IndexIVFFlat.cpp:484)")

    def range_search(self, x, radius: float):
        raise RuntimeError(
            "range_search not implemented for IndexIVFFlatDedup "
            "(faiss parity)")

    def reset(self) -> None:
        super().reset()
        self.instances = {}
        self._keys = None


def make_ivf_flat(d: int, nlist: int, metric: int = D.METRIC_L2, *,
                  device="cuda") -> IndexIVFFlat:
    """IVF with a flat coarse quantizer (= factory "IVFx,Flat")."""
    quant = IndexFlat(d, metric, device=device)
    return IndexIVFFlat(quant, d, nlist, metric, device=device)
