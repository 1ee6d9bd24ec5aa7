"""IndexIVFHNSW — PyTorch counterpart of `tpu_ann/models/ivf_hnsw.py`: the
fork's namesake hybrid, an IVF-Flat index whose coarse quantizer is an
HNSW graph over the centroids (tutorial/cpp/archive/IndexIVFHNSW.h:26-126).

Training runs k-means with exact assignment and builds the graph over the
final centroids once (the quantizer's add). Adds go in chunks of
``add_chunk_size`` rows with one repack at the end. ``coarse_mode``
"auto" quantizes with the exact product over the centroid table (the
graph's storage); "quantizer" searches the graph with ef = max(efSearch,
coarse_ef_factor * nprobe). Saving and loading, with the reference's disk
knobs (index_file_path, auto_save), wait for the io slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops import distances as D
from .hnsw import IndexHNSWFlat
from .ivf import IndexIVF


class IndexIVFHNSW(IndexIVF):
    """IVF-Flat with an HNSW coarse quantizer (archive/IndexIVFHNSW.h)."""

    def __init__(self, d: int, nlist: int, metric: int = D.METRIC_L2,
                 M: int = 32, block_size: int = 128, *, device="cuda"):
        quantizer = IndexHNSWFlat(d, M, metric, device=device)
        super().__init__(quantizer, d, nlist, metric, block_size,
                         device=device)
        self.add_chunk_size = 100000

    def set_hnsw_parameters(self, M: int = 0, efConstruction: int = 0,
                            efSearch: int = 0) -> None:
        if M:
            self.quantizer.hnsw.M = int(M)
        if efConstruction:
            self.quantizer.hnsw.efConstruction = int(efConstruction)
        if efSearch:
            self.quantizer.hnsw.efSearch = int(efSearch)

    @property
    def efSearch(self) -> int:
        return self.quantizer.hnsw.efSearch

    @efSearch.setter
    def efSearch(self, v: int) -> None:
        self.quantizer.hnsw.efSearch = int(v)

    def add(self, x) -> None:
        """Chunked add (archive .h add_chunk_size), one repack at the
        end."""
        x = self._check_input(x)
        n0 = self.ntotal
        for i0 in range(0, len(x), self.add_chunk_size):
            chunk = x[i0:i0 + self.add_chunk_size]
            ids = np.arange(n0 + i0, n0 + i0 + len(chunk), dtype=np.int64)
            self.add_with_ids(chunk, ids, repack=False)
        self._maybe_repack()

    def save_to_disk(self, path: Optional[str] = None) -> None:
        raise NotImplementedError("IndexIVFHNSW.save_to_disk waits for the "
                                  "io slice")

    def load_from_disk(self, path: Optional[str] = None) -> None:
        raise NotImplementedError("IndexIVFHNSW.load_from_disk waits for "
                                  "the io slice")

    @staticmethod
    def load(path: str) -> "IndexIVFHNSW":
        raise NotImplementedError("IndexIVFHNSW.load waits for the io slice")
