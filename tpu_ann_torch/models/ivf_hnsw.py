"""IndexIVFHNSW — PyTorch counterpart of `tpu_ann/models/ivf_hnsw.py`: the
fork's namesake hybrid, an IVF-Flat index whose coarse quantizer is an
HNSW graph over the centroids (tutorial/cpp/archive/IndexIVFHNSW.h:26-126).

Training runs k-means with exact assignment and builds the graph over the
final centroids once (the quantizer's add). Adds go in chunks of
``add_chunk_size`` rows with one repack at the end. ``coarse_mode``
"auto" quantizes with the exact product over the centroid table (the
graph's storage); "quantizer" searches the graph with ef = max(efSearch,
coarse_ef_factor * nprobe). The disk lifecycle is the reference's
(archive/IndexIVFHNSW.h:32-95): ``index_file_path``, ``auto_save`` (save at
the end of each add), ``save_to_disk`` / ``load_from_disk`` and the static
``load``, in the file format of `utils.index_io`.
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
        # disk lifecycle (archive/IndexIVFHNSW.h:32-95)
        self.index_file_path: Optional[str] = None
        self.add_chunk_size = 100000
        self.auto_save = False

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
        if self.auto_save and self.index_file_path:
            self.save_to_disk(self.index_file_path)

    # --- persistence -------------------------------------------------------
    def save_to_disk(self, path: Optional[str] = None) -> None:
        from ..utils import index_io

        path = path or self.index_file_path
        if not path:
            raise ValueError("no index_file_path set")
        index_io.write_index(self, path)

    def load_from_disk(self, path: Optional[str] = None) -> None:
        """Replace this index's state with the file's, on this index's
        device (the reference's: the file's disk knobs come along too)."""
        from ..utils import index_io

        path = path or self.index_file_path
        if not path:
            raise ValueError("no index_file_path set")
        loaded = index_io.read_index(path, device=self.device)
        self.__dict__.update(loaded.__dict__)

    @staticmethod
    def load(path: str, *, device="cuda") -> "IndexIVFHNSW":
        from ..utils import index_io

        idx = index_io.read_index(path, device=device)
        if not isinstance(idx, IndexIVFHNSW):
            raise TypeError(f"{path} is not an IndexIVFHNSW")
        return idx
