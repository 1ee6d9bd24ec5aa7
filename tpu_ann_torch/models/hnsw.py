"""IndexHNSW — PyTorch counterpart of `tpu_ann/models/hnsw.py`
(faiss/IndexHNSW.{h,cpp}): a graph index over an owned flat storage, and
the storage variants IndexHNSWFlat, IndexHNSWSQ, IndexHNSW2Level and
IndexHNSWPQ.

Adding builds the graph over every stored vector: the batch kNN-graph build
(`ops.hnsw.build_graph_knn`, ``build_mode`` "auto" / "knn") or wave
insertion (`ops.hnsw.build_graph`, "insert"). A later add of at most
``incremental_frac`` of the built rows wave-inserts the new rows into the
graph (`ops.hnsw.extend_graph`); a larger one rebuilds, as the reference
does. Search takes one of three routes:

* below ``hnsw.tile_threshold`` vectors, the per-node route: greedy
  descent through the upper levels and the lockstep level-0 beam
  (`ops.hnsw.hnsw_search`), over the storage (bf16 / fp16 copies for
  IndexHNSWSQ);
* at or above it, the fused tiles (`ops.hnsw_tiles.tile_search_fused`):
  hop-0 centroid routing plus graph hops, each scan one launch of the
  fused IVF scan kernel (K3 on bf16 / fp16 / f32 tiles, K3-SQ8 on SQ8
  tiles) on a CUDA device. ``tile_mode`` "fused" takes them for either
  metric, "auto" for L2, as the reference does off the CPU;
* or the tile beam (`ops.hnsw_tiles.tile_search`): ``tile_mode`` "beam",
  or an inner-product search in "auto". Plain torch, as the reference's
  is XLA.

The route is chosen by the mode and the metric; a failure raises (the
reference's "auto" falls back to its beam on any exception of the fused
route; the port does not). IndexHNSWPQ searches its PQ code tiles
(`ops.hnsw_tiles.tile_search_pq`) from its own threshold on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import hnsw as H
from ..ops import hnsw_tiles as HT
from ..ops import pq as PQ
from ..ops.ivf_scan import sq8_requantize_invlists
from ..ops.range_search import csr_from_hits
from ..ops.topk import chunk_starts
from . import base
from .base import Index, SearchStats, Timer
from .extra import Index2Layer
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
    defaults, :39-82)."""

    def __init__(self, M: int = 32):
        self.M = int(M)
        self.efConstruction = 40
        self.efSearch = 16
        self.expand = 2              # per-node beam: nodes expanded per hop
        self.wave_size = 1024        # points a wave of insertion
        # "auto" / "knn": build_graph_knn; "insert": wave insertion
        self.build_mode = "auto"
        self.tile_threshold = 8192   # tile routes from this ntotal on
        self.tile_size = 32          # the tile beam's rows a tile
        self.expand_tiles = 4        # vectors expanded a hop (beam); the
                                     # fused hops expand 2x this many
        self.scan_tiles = 0          # beam: fresh tiles a hop (0 = auto)
        self.tile_max_hops = 0       # beam: 0 = scaled from ef / expand
        # beam: entry tiles (0 = max(2 expand_tiles, 8, efSearch / 2); the
        # reference's rule is max(2 expand_tiles, 8), see _tile_search_chunk)
        self.tile_seeds = 0
        self.stop_frac = 0.15        # beam: slack on the stop rule
        self.tile_refine = True      # beam: exact f32 re-score of ef
        # "auto": the fused tiles for L2, the beam for IP; "fused" /
        # "beam" force one
        self.tile_mode = "auto"
        self.fused_hops = 1          # graph hops after the hop-0 route
        self.fused_F = 4             # fresh tiles scanned per graph hop
        self.fused_kp = 8            # per-(query, tile) width
        self.fused_kp_max = 64       # cap of the wide-k (quantizer) kp
        self.fused_tile_size = 128


class IndexHNSW(Index):
    """HNSW over an owned flat storage index."""

    # queries per search call of the graph routes (the per-node beam's
    # visited table is (chunk, ntotal) booleans, the tile beam's (chunk,
    # ntiles))
    search_chunk = 8192
    # an add of at most this share of the built rows extends the graph by
    # wave insertion (extend_graph); a larger one rebuilds it
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
        self._tiles: Optional[HT.TileGraph] = None
        self._tiles_fused: Optional[HT.FusedTileGraph] = None
        # reduced-precision storage (IndexHNSWSQ, IndexHNSW2Level): None =
        # f32, "bfloat16" / "float16", or "sq8" (coded fused tiles)
        self.storage_dtype: Optional[str] = None
        self._vec_dev: Optional[torch.Tensor] = None
        # the fused tiles' order and the "sq8" tiles' (bias, scale) when a
        # file fixed them
        self._tile_order: Optional[np.ndarray] = None
        self._sq8_affine = None
        self.verbose = False
        # seconds of the last graph build ("graph") or extension
        # ("extend") and of the tile layouts ("tiles", "beam_tiles")
        self.build_seconds = {}

    # --- add / build ------------------------------------------------------
    def add(self, x) -> None:
        x = self._check_input(x)
        self.storage.add(x)
        self.ntotal = self.storage.ntotal
        self._build_pending()

    def _vectors(self) -> torch.Tensor:
        """The stored rows (ntotal, d) f32, in id order."""
        return self.storage.vectors[:self.ntotal]

    def _storage_dropped(self) -> bool:
        """The raw rows are gone (IndexHNSWSQ's "sq8" tiles or IndexHNSWPQ's
        codes hold the index): the storage holds fewer rows than the
        index."""
        return self.ntotal > 0 and self.storage.ntotal != self.ntotal

    def _search_vectors(self) -> torch.Tensor:
        """The per-node beam's rows: the storage, at the storage type
        (bf16 for the "sq8" tiles, as the reference's)."""
        if self.storage_dtype is None:
            return self._vectors()
        if self._vec_dev is None or self._vec_dev.shape[0] != self.ntotal:
            dt = torch.float16 if self.storage_dtype == "float16" \
                else torch.bfloat16
            self._vec_dev = self._vectors().to(dt)
        return self._vec_dev

    def _build_pending(self) -> None:
        """Cover every stored row with the graph (reference :122-175): an
        add of at most incremental_frac of the built rows wave-inserts the
        new rows (extend_graph); otherwise the graph is built anew, by the
        batch kNN graph ("auto" / "knn") or by wave insertion
        ("insert")."""
        n = self.storage.ntotal
        if n == self._built_n:
            return
        hp = self.hnsw
        if hp.build_mode not in ("auto", "knn", "insert"):
            raise ValueError(f"unknown build_mode {hp.build_mode!r}")
        self._tiles = self._tiles_fused = self._vec_dev = None
        self._tile_order = None
        built = self._built_n
        with Timer(self.device) as t:
            if self.graph is not None and 0 < built < n and \
                    n - built <= self.incremental_frac * built:
                key = "extend"
                self.graph = H.extend_graph(
                    self._vectors(), self.graph, built, m=hp.M,
                    ef_construction=hp.efConstruction, seed=self._level_seed,
                    wave_size=hp.wave_size, metric=self.metric_type,
                    verbose=self.verbose, device=self.device)
                self._coarse_assign, self._tile_order = \
                    self._extended_cells(built)
            elif hp.build_mode == "insert":
                key = "graph"
                self.graph = H.build_graph(
                    self._vectors(), hp.M, hp.efConstruction,
                    levels=H.random_levels(n, hp.M, self._level_seed),
                    wave_size=hp.wave_size, metric=self.metric_type,
                    verbose=self.verbose, device=self.device)
                self._coarse_assign = None
            else:
                key = "graph"
                self.graph, self._coarse_assign = H.build_graph_knn(
                    self._vectors(), hp.M, hp.efConstruction,
                    levels=H.random_levels(n, hp.M, self._level_seed),
                    metric=self.metric_type, verbose=self.verbose,
                    device=self.device)
        self.build_seconds = {key: t.us / 1e6}
        self._built_n = n

    def _extended_cells(self, built: int):
        """The build's coarse assignment (the tiles' spatial order) carried
        to rows built..ntotal-1, and the tile order it gives: each added
        row joins the cell whose mean of built rows is nearest, and the
        rows of a cell are ordered by their distance to that mean. In id
        order (the build's own rule) the added rows would close every
        cell, and a cell's last rows spill into a tile it shares with the
        next cell, where the fused route finds them less often (75 against
        31 of 1000 rows searched back at 1M, `chip_smoke.py` phase 17g).
        The reference drops the assignment here, and its tiles then take a
        fresh k-means order, which there reads 0.08 less recall@10 at
        efSearch 64. (None, None) if the build left no assignment."""
        ca = self._coarse_assign
        if ca is None or len(ca) != built:
            return None, None
        x = self._vectors()
        ca = np.asarray(ca, np.int64)
        ids, cells = np.unique(ca, return_inverse=True)
        cells = torch.from_numpy(cells).to(self.device)
        sums = torch.zeros((len(ids), self.d), device=self.device)
        sums.index_add_(0, cells, x[:built])
        means = sums / torch.bincount(cells)[:, None].float()
        _, near = D.knn(x[built:], means, 1)
        cell_all = torch.cat([cells, near[:, 0]])
        dist = ((x - means[cell_all]) ** 2).sum(1).cpu().numpy()
        ca = np.concatenate([ca, ids[near[:, 0].cpu().numpy()]])
        return ca, np.lexsort((dist, ca)).astype(np.int64)

    def reset(self) -> None:
        self.storage.reset()
        self.graph = None
        self.ntotal = 0
        self._built_n = 0
        self._tiles = self._tiles_fused = self._vec_dev = None
        self._coarse_assign = self._tile_order = self._sq8_affine = None

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

    def _use_fused_tiles(self) -> bool:
        """"fused" / "beam" force a tile route; "auto" takes the fused
        tiles for L2 and the beam for IP (reference :233-241, off the
        CPU)."""
        mode = self.hnsw.tile_mode
        if mode not in ("auto", "fused", "beam"):
            raise ValueError(f"unknown tile_mode {mode!r}")
        return mode == "fused" or (mode == "auto" and not self.is_similarity)

    def _spatial_order(self, x: np.ndarray, b: int) -> np.ndarray:
        """The tiles' node order: by the coarse assignment, in the order an
        extension (or a file) fixed for it if there is one, else by a fresh
        k-means of cells about ``b`` rows."""
        n = self.ntotal
        if self._coarse_assign is None or len(self._coarse_assign) != n:
            return HT.spatial_order(x, b, seed=self._level_seed,
                                    device=self.device)
        if self._tile_order is not None and len(self._tile_order) == n:
            return self._tile_order
        return HT.spatial_order(x, b, assign=self._coarse_assign,
                                device=self.device)

    def _ensure_tiles(self) -> HT.TileGraph:
        """The tile beam's layout (reference :177-199), built on first
        use."""
        if self._tiles is not None:
            return self._tiles
        with Timer(self.device) as t:
            x = self._vectors().cpu().numpy()
            b = self.hnsw.tile_size
            self._tiles = HT.build_tiles(
                x, self.graph.neighbors0, order=self._spatial_order(x, b),
                b=b, device=self.device)
        self.build_seconds["beam_tiles"] = t.us / 1e6
        return self._tiles

    def _ensure_tiles_fused(self) -> HT.FusedTileGraph:
        """The fused tiles (reference :243-289), built on first use, at the
        storage's precision: bf16 / fp16 rows with norms recomputed from
        the stored values (K3 reads the bf16 rows, a bf16 twin of fp16
        rows made here once; the exact re-rank reads the stored rows), or
        "sq8" codes requantized from the rows (K3-SQ8), after which the
        raw storage is dropped: the codes are the rows from then on."""
        if self._tiles_fused is not None:
            return self._tiles_fused
        with Timer(self.device) as t:
            x = self._vectors().cpu().numpy()
            b = self.hnsw.fused_tile_size
            order = self._tile_order
            if order is None or len(order) != self.ntotal:
                order = self._spatial_order(x, b)
            ftg = HT.build_tiles_fused(x, self.graph.neighbors0, order=order,
                                       b=b, device=self.device)
            il = ftg.il
            if self.storage_dtype == "sq8":
                ftg.il = sq8_requantize_invlists(il, affine=self._sq8_affine)
                self.storage.reset()
            elif self.storage_dtype is not None:
                data = il.data.to(getattr(torch, self.storage_dtype))
                il.data = data
                il.data_bf16 = data if data.dtype == torch.bfloat16 \
                    else data.to(torch.bfloat16)
                il.norms = (data.float() ** 2).sum(-1)
            self._tiles_fused = ftg
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

    def _tile_search_chunk(self, xq_dev, k: int, ef: int):
        """One tile-route search (reference :326): the fused tiles, or the
        tile beam with its exact f32 re-score over the stored rows."""
        if self._use_fused_tiles():
            return self._fused_search_chunk(xq_dev, k, ef)
        hp = self.hnsw
        tg = self._ensure_tiles()
        # the entry tiles stand in for the upper levels' descent: at 1M rows
        # the reference's 8 of 31,250 tiles leave the beam below the
        # per-node beam on L2, and ef / 2 of them above it (`chip_smoke.py`
        # phase 17e); at efSearch <= 16 this is the reference's 8
        seeds = hp.tile_seeds or min(max(2 * hp.expand_tiles, 8, ef // 2),
                                     tg.ntiles)
        return HT.tile_search(
            tg, xq_dev, k, ef=ef, expand=hp.expand_tiles,
            scan_tiles=hp.scan_tiles, max_hops=hp.tile_max_hops,
            seed_count=seeds, metric=self.metric_type,
            stop_frac=hp.stop_frac,
            refine_vectors=self._vectors() if hp.tile_refine else None)

    def _search_device_stats(self, xq_dev, k: int, ef: int, expand: int):
        """(D, I, {nhops, ndis}) on the device: a tile route at or above
        tile_threshold, else the per-node beam."""
        if self._use_tiles():
            return self._tile_search_chunk(xq_dev, k, ef)
        Dv, Iv, st = H.hnsw_search(self._search_vectors(), self.graph,
                                   xq_dev, ef=ef, k=k, expand=expand,
                                   metric=self.metric_type)
        return Dv, Iv.long(), st

    def search_device(self, xq_dev: torch.Tensor, k: int,
                      params: Optional[SearchParametersHNSW] = None):
        """Device-in / device-out search (no host sync on the tile
        route)."""
        ef, expand = self._effective(k, params)
        outs = [self._search_device_stats(xq_dev[i:i + self.search_chunk],
                                          k, ef, expand)[:2]
                for i in chunk_starts(xq_dev.shape[0], self.search_chunk)]
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
            for i0 in chunk_starts(nq, self.search_chunk):
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
        """Approximate range search (faiss IndexHNSW::range_search,
        reference :435): the top max(efSearch, 16) results of each query's
        search, filtered by the radius (L2 keeps D < radius, IP D >
        radius); hits beyond them are missed, as in the reference. Returns
        the (lims, D, I) CSR triple."""
        x = self._check_input(x)
        nq = len(x)
        hits = ([], [], [])
        if self.graph is not None and self.ntotal:
            ef, expand = self._effective(1, None)
            kk = min(max(ef, 16), self.ntotal)
            xq_all = self._to_device(x)
            for i0 in chunk_starts(nq, self.search_chunk):
                Dc, Ic, _ = self._search_device_stats(
                    xq_all[i0:i0 + self.search_chunk], kk, ef, expand)
                ok = (Ic >= 0) & (Dc > radius if self.is_similarity
                                  else Dc < radius)
                nz = torch.nonzero(ok, as_tuple=True)
                hits[0].append(nz[0] + i0)
                hits[1].append(Dc[nz])
                hits[2].append(Ic[nz])
        res = csr_from_hits(nq, *hits)
        return res.lims, res.distances, res.labels

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


class IndexHNSWSQ(IndexHNSW):
    """faiss IndexHNSWSQ(d, qtype, M): the graph over compressed storage
    (reference :487) — "bfloat16" / "float16" rows (half the bytes of
    Flat), or "sq8" ("int8" / "uint8" accepted): uint8 code tiles and a
    per-dim affine, a quarter of the bytes, scanned by K3-SQ8; the raw
    storage is dropped once the coded tiles exist, and `reconstruct` and a
    later add dequantize from the codes."""

    def __init__(self, d: int, qtype: str = "bfloat16", M: int = 32,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, M, metric, device=device)
        if qtype in ("int8", "uint8"):
            qtype = "sq8"
        if qtype not in ("bfloat16", "float16", "sq8"):
            raise ValueError(
                "IndexHNSWSQ supports bfloat16/float16/int8 storage")
        self.storage_dtype = qtype

    def _vectors(self) -> torch.Tensor:
        if self._storage_dropped():
            return self._sq8_rows()
        return super()._vectors()

    def _sq8_rows(self) -> torch.Tensor:
        """(ntotal, d) f32 rows dequantized from the SQ8 tiles
        (code * scale + bias), in id order (reference :509)."""
        ftg = self._tiles_fused
        il = ftg.il
        pos = il.ids.reshape(-1).long()
        valid = pos >= 0
        rows = torch.empty((self.ntotal, self.d), device=self.device)
        rows[ftg.orig_ids.long()[pos[valid]]] = \
            il.rows_at(torch.nonzero(valid).squeeze(1))[0]
        return rows

    def add(self, x) -> None:
        if self.storage_dtype == "sq8" and self._storage_dropped():
            # the graph is rebuilt over every row: the old ones dequantized
            dec = self._sq8_rows()
            self.storage.reset()
            self.storage.add(dec.cpu().numpy())
            self._built_n = 0
            self._sq8_affine = None
        super().add(x)

    def reconstruct(self, key: int) -> np.ndarray:
        if self._storage_dropped():
            if not 0 <= key < self.ntotal:
                raise IndexError(key)
            ftg = self._tiles_fused
            pos = torch.nonzero(ftg.orig_ids == key)[0]
            slot = torch.nonzero(ftg.il.ids.reshape(-1) == pos)[0]
            return ftg.il.rows_at(slot)[0][0].cpu().numpy()
        return super().reconstruct(key)

    def reconstruct_n(self, i0: int, ni: int) -> np.ndarray:
        if not (0 <= i0 and i0 + ni <= self.ntotal):
            raise IndexError((i0, ni))
        return self._vectors()[i0:i0 + ni].cpu().numpy()


class IndexHNSW2Level(IndexHNSW):
    """faiss IndexHNSW2Level(quantizer, nlist, pq_m, M): the graph over
    Index2Layer codes (a coarse id and a PQ residual, reference :550). The
    codes are the index's stored form (sa_encode / sa_decode, files); the
    graph and the searches run over their decoded rows, which the fused
    tiles hold in bf16 (the reference's design: a bf16 tile reads as many
    bytes as a code tile's gathers would)."""

    def __init__(self, d: int, nlist: int, pq_m: int, M: int = 32,
                 nbits: int = 8, metric: int = D.METRIC_L2, *,
                 device="cuda"):
        super().__init__(d, M, metric, device=device)
        self.codec = Index2Layer(IndexFlat(d, metric, device=self.device),
                                 nlist, pq_m, nbits)
        self.storage_dtype = "bfloat16"
        self.is_trained = False

    def train(self, x) -> None:
        self.codec.train(self._check_input(x))
        self.is_trained = True

    def add(self, x) -> None:
        if not self.is_trained:
            raise RuntimeError("train first (IndexHNSW2Level)")
        x = self._check_input(x)
        self.codec.add(x)
        # the graph and the searches see the codes' rows
        super().add(self.codec.sa_decode(self.codec.sa_encode(x)))

    def sa_encode(self, x) -> np.ndarray:
        return self.codec.sa_encode(x)

    def sa_decode(self, codes) -> np.ndarray:
        return self.codec.sa_decode(codes)

    def reset(self) -> None:
        super().reset()
        self.codec.reset()


class IndexHNSWPQ(IndexHNSW):
    """faiss IndexHNSWPQ(d, pq_m, M): the graph over PQ-coded storage
    (reference :591). The graph is built from the exact rows passed to add;
    from tile_threshold (4096) on, the codes are laid out as PQ tiles
    (`ops.hnsw_tiles.build_tiles_pq`) and the raw rows dropped, so the
    device holds pq_m bytes a vector; searches return ADC distances.
    Below it, a search decodes every code and runs the per-node beam."""

    def __init__(self, d: int, pq_m: int, M: int = 32, nbits: int = 8,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, M, metric, device=device)
        self.pq_m = int(pq_m)
        self.nbits = int(nbits)
        self.pq: Optional[PQ.PQCodec] = None
        self._cent: Optional[torch.Tensor] = None
        self._codes = torch.zeros((0, self.pq_m), dtype=torch.uint8,
                                  device=self.device)
        self._ptiles: Optional[HT.PQTileGraph] = None
        # a reopened index's tile layout: (position -> id order, tile
        # centroids of the raw rows), or None (a fresh order)
        self._tile_layout = None
        self.is_trained = False
        self.hnsw.tile_threshold = 4096

    def _set_codec(self, centroids) -> None:
        self.pq = PQ.PQCodec(centroids=np.asarray(centroids, np.float32),
                             d=self.d, M=self.pq_m, nbits=self.nbits)
        self._cent = PQ.as_centroids(self.pq.centroids, self.device)
        self.is_trained = True

    def train(self, x) -> None:
        x = self._check_input(x)
        self._set_codec(PQ.train_pq(x, self.pq_m, self.nbits,
                                    verbose=self.verbose,
                                    device=self.device).centroids)

    def add(self, x) -> None:
        if not self.is_trained:
            raise RuntimeError("train first (IndexHNSWPQ)")
        x = self._check_input(x)
        codes = PQ.pq_encode_chunked(x, self._cent)
        if self._storage_dropped():
            # the raw rows are gone: the rebuild sees the old rows decoded
            dec = PQ.pq_decode(self._codes, self._cent)
            self.storage.reset()
            self.storage.add(dec.cpu().numpy())
            self._built_n = 0
        self._codes = torch.cat([self._codes, codes])
        self.storage.add(x)
        self.ntotal = self.storage.ntotal
        self._build_pending()
        self._ptiles = None
        self._tile_layout = None
        if self._use_tiles():
            x_all = self._vectors().cpu().numpy()
            b = self.hnsw.fused_tile_size
            self._ptiles = HT.build_tiles_pq(
                x_all, self._codes, self.pq.centroids, self.graph.neighbors0,
                order=self._spatial_order(x_all, b), b=b, device=self.device)
            self.storage.reset()           # search runs on the codes

    def reset(self) -> None:
        super().reset()
        self._codes = self._codes[:0]
        self._ptiles = None
        self._tile_layout = None

    def reconstruct(self, key: int) -> np.ndarray:
        if not 0 <= key < self.ntotal:
            raise IndexError(key)
        return PQ.pq_decode(self._codes[key:key + 1], self._cent)[0] \
            .cpu().numpy()

    def reconstruct_n(self, i0: int, ni: int) -> np.ndarray:
        if not (0 <= i0 and i0 + ni <= self.ntotal):
            raise IndexError((i0, ni))
        return PQ.pq_decode(self._codes[i0:i0 + ni], self._cent).cpu().numpy()

    def _search_device_stats(self, xq_dev, k: int, ef: int, expand: int):
        if self._ptiles is None and self._use_tiles():
            # a reopened index: the tiles from the decoded codes, in the
            # file's layout if it has one, else a fresh spatial order
            dec = PQ.pq_decode(self._codes, self._cent).cpu().numpy()
            b = self.hnsw.fused_tile_size
            order, cent = self._tile_layout or (
                HT.spatial_order(dec, b, seed=self._level_seed,
                                 device=self.device), None)
            self._ptiles = HT.build_tiles_pq(
                dec, self._codes, self.pq.centroids, self.graph.neighbors0,
                order=order, b=b, cent=cent, device=self.device)
        if self._ptiles is not None:
            hp = self.hnsw
            Dv, _, Iv = HT.tile_search_pq(
                self._ptiles, xq_dev, k, nprobe0=max(4, ef // 8),
                hops=hp.fused_hops, expand=hp.expand_tiles * 2, F=hp.fused_F,
                rk=max(2 * k, min(ef, 64)), metric=self.metric_type)
            return Dv, Iv, {"nhops": hp.fused_hops, "ndis": 0}
        Dv, Iv, st = H.hnsw_search(PQ.pq_decode(self._codes, self._cent),
                                   self.graph, xq_dev, ef=ef, k=k,
                                   expand=expand, metric=self.metric_type)
        return Dv, Iv.long(), st
