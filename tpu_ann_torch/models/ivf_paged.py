"""IndexIVFFlatPaged — PyTorch counterpart of `tpu_ann/models/ivf_paged.py`:
IVF search over inverted lists bigger than device memory (the fork's
build, save, mmap-load, search workflow: faiss/invlists/
OnDiskInvertedLists.h, impl/index_read.cpp:214-226 IO_FLAG_MMAP).

The index lives in a directory: the block-stream memmaps of
`ops.ivf_scan_paged.PagedInvLists` plus the trained centroids and a meta
file, in the reference's format, so each package loads the other's
directories. Device memory holds the centroids, two scan windows and the
results, whatever ntotal is. Search = exact coarse product on the device
-> out-of-core window scan (K4, see ops/ivf_scan_paged).

The build streams in two passes and never holds the dataset in memory:
  pass 1: chunked assignment on the device (upload chunk -> coarse
          product -> download the assignment; list sizes from the counts);
  pass 2: host scatter of each chunk into the on-disk layout with the
          cached assignment (no second upload).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops import distances as D
from ..ops import ivf_scan_paged as PS
from ..ops.kmeans import ClusteringParameters, kmeans
from .base import Index, SearchStats, Timer


def _chunks(x, chunk: int) -> Iterator[Tuple[int, np.ndarray]]:
    for a in range(0, len(x), chunk):
        yield a, np.asarray(x[a:a + chunk], np.float32)


class IndexIVFFlatPaged(Index):
    """IVF,Flat with host/disk-resident invlists and windowed search.

    Usage::

        idx = IndexIVFFlatPaged(d, nlist, path="/big/index.paged")
        idx.train(xt)                    # k-means on the device
        idx.add(x_memmap)                # streaming two-pass build
        ...
        idx = IndexIVFFlatPaged.load(path)    # mmap, O(MB) resident
        idx.nprobe = 32
        D_, I = idx.search(xq, 10)
    """

    def __init__(self, d: int, nlist: int, path: str,
                 metric: int = D.METRIC_L2, block_size: int = 128,
                 keep_f32: bool = True, *, device="cuda"):
        super().__init__(d, metric, device=device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("IndexIVFFlatPaged: no CUDA device (pass "
                               "device='cpu' to run on the CPU)")
        self.nlist = int(nlist)
        self.path = path
        self.block_size = int(block_size)
        self.keep_f32 = bool(keep_f32)
        self.nprobe = 8
        self.verbose = False
        self.centroids: Optional[np.ndarray] = None
        self._cent_dev: Optional[torch.Tensor] = None
        self.invlists: Optional[PS.PagedInvLists] = None
        self.is_trained = False
        # scan knobs (scan_invlists_paged kwargs). tile_batch (tiles per K4
        # launch) does not change results; the reference's 64 would leave
        # most of the card's SMs idle, so a launch takes up to 4096 tiles.
        self.window_blocks = 8192
        self.tile_batch = 4096
        self.refine = 4
        # hot tier: the first `resident_blocks` of the stream go to the
        # device once and serve the windows inside them (GpuIndex.h:70+
        # minPagedSize role)
        self.resident_blocks = 0
        self._resident: Optional[PS.Window] = None
        # build knobs
        self.assign_chunk = 1_000_000
        self.cp_niter = 10

    # --- training ----------------------------------------------------------
    def train(self, x) -> None:
        x = self._check_input(x)
        cp = ClusteringParameters(niter=self.cp_niter, verbose=self.verbose)
        cents, _ = kmeans(x, self.nlist, cp, self.metric_type,
                          device=self.device)
        self.centroids = np.asarray(cents, np.float32)
        self._cent_dev = torch.from_numpy(self.centroids).to(self.device)
        self.is_trained = True

    # --- streaming build ---------------------------------------------------
    def add(self, x, ids: Optional[np.ndarray] = None,
            assign: Optional[np.ndarray] = None) -> None:
        """Two-pass streaming build. `x` may be a np.memmap; rows are read
        in `assign_chunk` chunks. A paged index is built once (the on-disk
        layout is sized from the full assignment)."""
        if not self.is_trained:
            raise RuntimeError("train() before add()")
        if self.invlists is not None and self.ntotal:
            raise RuntimeError(
                "IndexIVFFlatPaged.add builds once from the full set; "
                "for incremental mutation use IndexIVFFlat or rebuild")
        if len(np.shape(x)) != 2 or np.shape(x)[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) rows, got shape "
                             f"{np.shape(x)}")
        n = len(x)
        if assign is None:
            assign = np.empty(n, np.int32)
            for a, xc in _chunks(x, self.assign_chunk):
                _, aa = D.knn(torch.from_numpy(xc).to(self.device),
                              self._cent_dev, 1, self.metric_type)
                assign[a:a + len(xc)] = aa[:, 0].cpu().numpy()
                if self.verbose:
                    print(f"[paged add] assigned {a + len(xc)}/{n}",
                          flush=True)
        else:
            assign = np.asarray(assign, np.int32)
        sizes = np.bincount(assign.astype(np.int64), minlength=self.nlist)
        pil = PS.create_paged_invlists(
            self.path, self.nlist, sizes, self.d,
            block_size=self.block_size, keep_f32=self.keep_f32)
        fill = np.zeros(self.nlist, np.int64)
        for a, xc in _chunks(x, self.assign_chunk):
            cid = (np.arange(a, a + len(xc), dtype=np.int64)
                   if ids is None else np.asarray(ids[a:a + len(xc)]))
            PS.paged_add_chunk(pil, fill, xc, cid, assign[a:a + len(xc)])
            if self.verbose:
                print(f"[paged add] packed {a + len(xc)}/{n}", flush=True)
        self.invlists = pil
        self._resident = None
        self.ntotal = n
        self.save()

    # --- persistence -------------------------------------------------------
    def save(self) -> None:
        meta = {
            "d": self.d, "nlist": self.nlist, "metric": self.metric_type,
            "ntotal": self.ntotal, "nprobe": self.nprobe,
            "block_size": self.block_size,
        }
        with open(os.path.join(self.path, "index_meta.json"), "w") as f:
            json.dump(meta, f)
        if self.centroids is not None:
            np.save(os.path.join(self.path, "centroids.npy"),
                    self.centroids)

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "IndexIVFFlatPaged":
        """mmap-load: resident cost = centroids + list metadata only."""
        with open(os.path.join(path, "index_meta.json")) as f:
            meta = json.load(f)
        idx = cls(int(meta["d"]), int(meta["nlist"]), path,
                  int(meta["metric"]), int(meta["block_size"]),
                  device=device)
        idx.centroids = np.load(os.path.join(path, "centroids.npy"))
        idx._cent_dev = torch.from_numpy(idx.centroids).to(idx.device)
        idx.invlists = PS.open_paged_invlists(path)
        idx.keep_f32 = idx.invlists.data_f32 is not None
        idx.ntotal = int(meta["ntotal"])
        idx.nprobe = int(meta["nprobe"])
        idx.is_trained = True
        return idx

    # --- search ------------------------------------------------------------
    def search(self, x, k: int, *, params=None):
        D_, I, _ = self.search_stats(x, k, params=params)
        return D_, I

    def search_stats(self, x, k: int, *, params=None):
        """search + the QueryLatencyStats split; the scan's counters and
        times (`scan_invlists_paged`'s stats) are on ``extra``."""
        if self.invlists is None and not self.is_trained:
            raise RuntimeError("empty index")
        x = self._check_input(x)
        if self.invlists is None:      # trained, no rows: ids -1 (faiss)
            return (np.full((len(x), k), D.worst_value(self.metric_type),
                            np.float32),
                    np.full((len(x), k), -1, np.int64), SearchStats(nq=len(x)))
        nprobe = min(getattr(params, "nprobe", 0) or self.nprobe, self.nlist)
        with Timer(self.device) as t_q:
            _, probes = D.knn(self._to_device(x), self._cent_dev, nprobe,
                              self.metric_type)
        stats_d: dict = {}
        with Timer(self.device) as t_s:
            if self.resident_blocks and self._resident is None:
                self._resident = PS.upload_resident(
                    self.invlists, self.resident_blocks, self.device)
            Dv, Iv, ndis = PS.scan_invlists_paged(
                x, probes, self.invlists, k, self.metric_type,
                window_blocks=self.window_blocks, TB=self.tile_batch,
                refine=self.refine, resident=self._resident, stats=stats_d,
                device=self.device)
        st = SearchStats(
            nq=len(x), ndis=int(ndis),
            nlist_visited=int((probes >= 0).sum()),
            quantization_us=t_q.us, list_scan_us=t_s.us,
            total_us=t_q.us + t_s.us, extra=stats_d)
        return Dv, Iv.astype(np.int64), st

    def reset(self) -> None:
        self.invlists = None
        self._resident = None
        self.ntotal = 0

    def reconstruct(self, key: int) -> np.ndarray:
        """The stored row of id `key` (a linear scan of the id store)."""
        pil = self.invlists
        if pil is None or pil.data_f32 is None:
            raise RuntimeError("reconstruct needs the f32 store")
        pos = np.nonzero(np.asarray(pil.ids).reshape(-1) == key)[0]
        if not len(pos):
            raise KeyError(key)
        B = pil.block_size
        return np.asarray(pil.data_f32[pos[0] // B, pos[0] % B], np.float32)
