"""IndexHNSW — PyTorch counterpart of `tpu_ann/models/hnsw.py`
(faiss/IndexHNSW.{h,cpp}): a graph index over an owned flat storage.

Adding builds the graph over every stored vector with the batch kNN-graph
build (`ops.hnsw.build_graph_knn`); a later add of more than
``incremental_frac`` of the built rows rebuilds it over all of them, as the
reference does. Search takes one of two routes:

* below ``hnsw.tile_threshold`` vectors, the per-node route: greedy
  descent through the upper levels and the lockstep level-0 beam
  (`ops.hnsw.hnsw_search`);
* at or above it, the fused-tile route (`ops.hnsw_tiles.tile_search_fused`):
  hop-0 centroid routing plus graph hops, each scan one launch of the fused
  IVF scan kernel (K3) on a CUDA device. ``tile_mode="fused"`` takes it for
  either metric; ``"auto"`` for L2 only, as the reference's does off the
  CPU (the reference's CPU route is its tile beam; the port's CPU route is
  the fused tiles, its plain version). There is no fallback to another
  route.

Not ported yet (they raise NotImplementedError): wave insertion
(``build_mode="insert"``) and the incremental add of at most
``incremental_frac`` of the built rows (`extend_graph`), the XLA beam over
tiles (`tile_search`: ``tile_mode="beam"``, and an IP search in
``"auto"``), the SQ / PQ / 2-level storages and range_search.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import hnsw as H
from ..ops import hnsw_tiles as HT
from . import base
from .base import Index, SearchStats, Timer
from .flat import IndexFlat


@dataclasses.dataclass
class SearchParametersHNSW:
    """faiss SearchParametersHNSW (IndexHNSW.h)."""

    efSearch: int = 0    # 0 = use index default
    expand: int = 0      # nodes expanded per hop (0 = default)
    sel: object = None   # IDSelector, applied at result extraction


class HNSWParams:
    """Knob bag of faiss `HNSW`'s public fields (impl/HNSW.h:152-170) plus
    the batched build and traversal knobs (the reference's names and
    defaults)."""

    def __init__(self, M: int = 32):
        self.M = int(M)
        self.efConstruction = 40
        self.efSearch = 16
        self.expand = 2              # per-node beam: nodes expanded per hop
        self.build_mode = "auto"     # "auto" / "knn": build_graph_knn
        self.tile_threshold = 8192   # fused-tile route from this ntotal on
        self.tile_mode = "auto"      # "auto" / "fused": the fused tiles
        self.expand_tiles = 4        # the tile hops expand 2x this many
        self.fused_hops = 1          # graph hops after the hop-0 route
        self.fused_F = 4             # fresh tiles scanned per graph hop
        self.fused_kp = 8            # per-(query, tile) width
        # cap of the wide-k (coarse-quantizer) kp scaling (above the K3
        # kernel's KP_MAX the tiles are scanned as sub-tiles)
        self.fused_kp_max = 64
        self.fused_tile_size = 128


class IndexHNSW(Index):
    """HNSW over an owned flat storage index."""

    # queries per search call of the graph routes (the per-node beam's
    # visited table is (chunk, ntotal) booleans)
    search_chunk = 8192
    # an add of at most this share of the built rows extends the graph
    # (extend_graph, not ported yet); a larger one rebuilds it
    incremental_frac = 0.5

    def __init__(self, d: int, M: int = 32, metric: int = D.METRIC_L2,
                 storage: Optional[IndexFlat] = None, *, device="cuda"):
        super().__init__(d, metric, device=device)
        self.hnsw = HNSWParams(M)
        self.storage = storage if storage is not None else \
            IndexFlat(d, metric, device=self.device)
        self.graph: Optional[H.HNSWGraph] = None
        self._built_n = 0
        self._level_seed = 1234
        self._coarse_assign = None
        self._tiles_fused: Optional[HT.FusedTileGraph] = None
        self.verbose = False
        # seconds of the last build (graph) and tile layout, for reports
        self.build_seconds = {}

    # --- add / build ------------------------------------------------------
    def add(self, x) -> None:
        x = self._check_input(x)
        n, built = self.ntotal + len(x), self._built_n
        if self.graph is not None and 0 < built < n and \
                n - built <= self.incremental_frac * built:
            # the reference's incremental branch; raised before the rows
            # are stored, so the index stays as it was
            raise NotImplementedError(
                "adding at most incremental_frac of the built rows extends "
                "the graph by wave insertion (extend_graph), which is not "
                "ported yet; add more rows at once, or reset() and add all "
                "rows")
        self.storage.add(x)
        self.ntotal = self.storage.ntotal
        self._build_pending()

    def _vectors(self) -> torch.Tensor:
        return self.storage.vectors[:self.ntotal]

    def _build_pending(self) -> None:
        """Build the graph over all stored vectors (batch kNN graph): the
        first build, or the rebuild after an add of more than
        incremental_frac of the built rows (reference :137-175)."""
        n = self.storage.ntotal
        if n == self._built_n:
            return
        if self.hnsw.build_mode not in ("auto", "knn"):
            raise NotImplementedError(
                f"build_mode={self.hnsw.build_mode!r} (wave insertion) is "
                "not ported yet")
        self._tiles_fused = None
        with Timer(self.device) as t:
            levels = H.random_levels(n, self.hnsw.M, self._level_seed)
            self.graph, self._coarse_assign = H.build_graph_knn(
                self._vectors(), self.hnsw.M, self.hnsw.efConstruction,
                levels=levels, metric=self.metric_type,
                verbose=self.verbose, device=self.device)
        self.build_seconds = {"graph": t.us / 1e6}
        self._built_n = n

    def reset(self) -> None:
        self.storage.reset()
        self.graph = None
        self.ntotal = 0
        self._built_n = 0
        self._tiles_fused = None
        self._coarse_assign = None

    # --- search -----------------------------------------------------------
    def _effective(self, k: int, params):
        ef, expand = self.hnsw.efSearch, self.hnsw.expand
        if params is not None:
            if params.efSearch:
                ef = params.efSearch
            if params.expand:
                expand = params.expand
        return max(int(ef), int(k)), expand

    def _use_tiles(self) -> bool:
        return self.graph is not None and \
            self.ntotal >= self.hnsw.tile_threshold

    def _ensure_tiles_fused(self) -> HT.FusedTileGraph:
        if self._tiles_fused is not None:
            return self._tiles_fused
        with Timer(self.device) as t:
            x = self._vectors().cpu().numpy()
            assign = self._coarse_assign \
                if self._coarse_assign is not None and \
                len(self._coarse_assign) == self.ntotal else None
            b = self.hnsw.fused_tile_size
            order = HT.spatial_order(x, b, assign=assign,
                                     seed=self._level_seed,
                                     device=self.device)
            self._tiles_fused = HT.build_tiles_fused(
                x, self.graph.neighbors0, order=order, b=b,
                device=self.device)
        self.build_seconds["tiles"] = t.us / 1e6
        return self._tiles_fused

    def _fused_search_chunk(self, xq_dev, k: int, ef: int):
        """The fused tile route (reference :293): efSearch sets the hop-0
        tile budget and the merge width; kp grows with k up to
        fused_kp_max."""
        ftg = self._ensure_tiles_fused()
        hp = self.hnsw
        nprobe0 = max(8, ef // 2)
        rk = max(2 * k, min(ef, 64))
        kp = max(hp.fused_kp, min(ftg.b, k, hp.fused_kp_max))
        Dv, _, Iv = HT.tile_search_fused(
            ftg, xq_dev, k, nprobe0=nprobe0, hops=hp.fused_hops,
            expand=hp.expand_tiles * 2, F=hp.fused_F, kp=kp, rk=rk,
            metric=self.metric_type)
        ndis = (nprobe0 + hp.fused_hops * hp.fused_F) * ftg.b
        return Dv, Iv, {"nhops": hp.fused_hops,
                        "ndis": xq_dev.shape[0] * ndis}

    def _search_device_stats(self, xq_dev, k: int, ef: int, expand: int):
        """(D, I, {nhops, ndis}) on the device: at or above tile_threshold
        the fused tiles (tile_mode "fused", or "auto" for L2: the
        reference's choice, :233-241), else the per-node beam."""
        if self._use_tiles():
            mode = self.hnsw.tile_mode
            if mode not in ("auto", "fused"):
                raise NotImplementedError(
                    f"tile_mode={mode!r} (the XLA beam over tiles, "
                    "tile_search) is not ported yet")
            if mode == "auto" and self.is_similarity:
                raise NotImplementedError(
                    "an inner-product search at or above tile_threshold "
                    "takes the XLA beam over tiles (tile_search) in "
                    "tile_mode='auto', which is not ported yet; "
                    "tile_mode='fused' takes the fused tiles")
            return self._fused_search_chunk(xq_dev, k, ef)
        Dv, Iv, st = H.hnsw_search(self._vectors(), self.graph, xq_dev,
                                   ef=ef, k=k, expand=expand,
                                   metric=self.metric_type)
        return Dv, Iv.long(), st

    def search_device(self, xq_dev: torch.Tensor, k: int,
                      params: Optional[SearchParametersHNSW] = None):
        """Device-in / device-out search (no host sync on the tile
        route)."""
        ef, expand = self._effective(k, params)
        outs = [self._search_device_stats(xq_dev[i:i + self.search_chunk],
                                          k, ef, expand)[:2]
                for i in range(0, xq_dev.shape[0], self.search_chunk)]
        if len(outs) == 1:
            return outs[0]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def search(self, x, k: int, *,
               params: Optional[SearchParametersHNSW] = None):
        Dv, Iv, _ = self.search_stats(x, k, params=params)
        return Dv, Iv

    def search_stats(self, x, k: int, *,
                     params: Optional[SearchParametersHNSW] = None):
        """search + HNSWStats / QueryLatencyStats (fork's
        IndexHNSW::search_stats, faiss/IndexHNSW.h:68-76)."""
        x = self._check_input(x)
        nq = x.shape[0]
        if self.graph is None:
            bad = -np.inf if self.is_similarity else np.inf
            return (np.full((nq, k), bad, np.float32),
                    np.full((nq, k), -1, np.int64), SearchStats(nq=nq))
        ef, expand = self._effective(k, params)
        sel = getattr(params, "sel", None) if params is not None else None
        with Timer(self.device) as t:
            # with a selector: traverse unfiltered, fetch ef results and
            # filter at extraction (the reference's behaviour)
            kk = ef if sel is not None else k
            xq_all = self._to_device(x)
            parts, ndis, nhops = [], 0, 0
            for i0 in range(0, nq, self.search_chunk):
                Dc, Ic, st = self._search_device_stats(
                    xq_all[i0:i0 + self.search_chunk], kk, max(ef, kk),
                    expand)
                parts.append((Dc, Ic))
                ndis += int(st["ndis"])
                nhops += int(st["nhops"])
            Dv = torch.cat([p[0] for p in parts]).cpu().numpy()
            Iv = torch.cat([p[1] for p in parts]).cpu().numpy().astype(
                np.int64)
            if sel is not None:
                allow = sel.make_bitmap(self.ntotal)
                bad = -np.inf if self.is_similarity else np.inf
                ok = (Iv >= 0) & (allow[np.clip(Iv, 0, self.ntotal - 1)] > 0)
                Dv = np.where(ok, Dv, bad)
                Iv = np.where(ok, Iv, -1)
                order = np.argsort(-Dv if self.is_similarity else Dv,
                                   axis=1, kind="stable")[:, :k]
                Dv = np.take_along_axis(Dv, order, axis=1)
                Iv = np.take_along_axis(Iv, order, axis=1)
        stats = SearchStats(nq=nq, total_us=t.us, quantization_us=0.0,
                            list_scan_us=t.us, ndis=ndis,
                            nlist_visited=nhops)
        base.indexIVF_stats.accumulate(stats)
        return Dv, Iv, stats

    def range_search(self, x, radius: float):
        raise NotImplementedError("IndexHNSW.range_search is not ported yet")

    def reconstruct(self, key: int) -> np.ndarray:
        return self.storage.reconstruct(key)

    def reconstruct_n(self, i0: int, ni: int) -> np.ndarray:
        return self.storage.reconstruct_n(i0, ni)

    # --- introspection -----------------------------------------------------
    def degree_histogram(self) -> np.ndarray:
        """Level-0 out-degree histogram (graph quality diagnostic)."""
        nb = self.graph.neighbors0.cpu().numpy()
        return np.bincount((nb >= 0).sum(1), minlength=nb.shape[1] + 1)


class IndexHNSWFlat(IndexHNSW):
    """faiss IndexHNSWFlat(d, M, metric) — raw-vector storage."""

    def __init__(self, d: int, M: int = 32, metric: int = D.METRIC_L2, *,
                 device="cuda"):
        super().__init__(d, M, metric, device=device)
