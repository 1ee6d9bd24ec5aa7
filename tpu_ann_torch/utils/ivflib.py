"""IVF surgery and online rebalancing — PyTorch counterpart of
`tpu_ann/utils/ivflib.py`: faiss `IVFlib.{h,cpp}` plus the fork's
`ClusterManager` balance / split experiment
(tutorial/python/20-hnsw-ivf-balance.py:69-186).

IVFlib: `extract_index_ivf` (unwrap IndexPreTransform / IndexIDMap /
IndexRefine), `replace_ivf_quantizer` (contrib/ivf_tools.py:98) and
`SlidingIndexWindow` (streaming day slices, IVFlib.h:85). All of them edit
the IVF index's host store (`_xb_host` / `_ids_host` / `_assign_host`,
one entry an added chunk) and repack its device lists.

ClusterManager: when a list holds more than ``max_cell_size`` rows, split
it with a small k-means on the device and add the new centroids to the
coarse quantizer (an HNSW quantizer's graph is rebuilt over them); every
row is then reassigned and the lists repacked.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..models.idmap import IndexIDMap
from ..models.ivf import IndexIVF
from ..models.refine import IndexRefine
from ..models.transforms import IndexPreTransform
from ..ops.kmeans import ClusteringParameters, kmeans
from .contrib import get_invlist


def extract_index_ivf(index) -> IndexIVF:
    """Unwrap composite layers down to the IndexIVF (IVFlib.h
    extract_index_ivf)."""
    while True:
        if isinstance(index, IndexIVF):
            return index
        if isinstance(index, (IndexPreTransform, IndexIDMap)):
            index = index.index
        elif isinstance(index, IndexRefine):
            index = index.base_index
        else:
            raise TypeError(f"no IndexIVF inside {type(index).__name__}")


def replace_ivf_quantizer(index_ivf: IndexIVF, new_quantizer) -> None:
    """Swap the coarse quantizer, then reassign and repack every row
    (contrib/ivf_tools.py:98)."""
    if new_quantizer.ntotal != index_ivf.nlist:
        raise ValueError("new quantizer must hold exactly nlist centroids")
    if new_quantizer.device != index_ivf.device:
        raise ValueError("quantizer must live on the index's device")
    index_ivf.quantizer = new_quantizer
    index_ivf.invalidate_assign()      # centroids changed: reassign all
    if index_ivf.ntotal:
        index_ivf._repack()


class SlidingIndexWindow:
    """Streaming day-slice window over an IVF index (IVFlib.h:85):
    ``step(new_slice)`` appends a slice and drops the oldest once more
    than ``nslice`` are live. Default ids count the rows the window ever
    added (the reference's ``arange(ntotal, ...)`` hands a new slice the
    ids of live rows once a slice has been dropped)."""

    def __init__(self, index_ivf: IndexIVF, nslice: int):
        self.index = index_ivf
        self.nslice = int(nslice)
        self._slices: List[int] = []   # host chunks of each live slice
        self._next_id = int(index_ivf.ntotal)

    def step(self, x: Optional[np.ndarray],
             ids: Optional[np.ndarray] = None) -> None:
        idx = self.index
        if x is not None and len(x):
            x = np.ascontiguousarray(x, np.float32)
            if ids is None:
                ids = np.arange(self._next_id, self._next_id + len(x),
                                dtype=np.int64)
            self._next_id += len(x)
            idx._append_chunk(x, np.asarray(ids, np.int64))
            self._slices.append(1)
        ndrop = 0
        while len(self._slices) > self.nslice:
            ndrop += self._slices.pop(0)
        if ndrop:
            if idx._pending_removals():
                idx._repack()          # compact first: chunks stay whole
            for _ in range(ndrop):
                idx.ntotal -= len(idx._xb_host.pop(0))
                idx._ids_host.pop(0)
                idx._assign_host.pop(0)
            idx._removed_mask = None
        idx._repack()


class ClusterManager:
    """Online IVF list rebalancing (the fork's ClusterManager,
    20-hnsw-ivf-balance.py:69-186): split any list over ``max_cell_size``
    into ``split_k`` sub-lists and grow the quantizer. Needs raw f32 lists
    (IndexIVFFlat, IndexIVFHNSW)."""

    def __init__(self, index_ivf: IndexIVF, max_cell_size: int,
                 split_k: int = 2):
        self.index = index_ivf
        self.max_cell_size = int(max_cell_size)
        self.split_k = int(split_k)

    def oversized_lists(self) -> np.ndarray:
        return np.nonzero(self.index.list_sizes > self.max_cell_size)[0]

    def split_partition(self, list_no: int) -> int:
        """Split one list: a k-means over its rows (on the device), its
        centroid replaced by the first sub-centroid, the others appended
        to the quantizer, every row reassigned. Returns the number of new
        lists."""
        idx = self.index
        idx._check_mutable()
        idx._maybe_repack()
        if not hasattr(idx.invlists, "data"):
            raise TypeError("ClusterManager needs raw f32 inverted lists")
        _, vecs = get_invlist(idx, int(list_no))
        if len(vecs) < self.split_k * 2:
            return 0
        cp = ClusteringParameters(niter=8, seed=1234)
        sub_cent, _ = kmeans(np.asarray(vecs, np.float32), self.split_k, cp,
                             device=idx.device)
        cents = idx._centroid_table().cpu().numpy().copy()
        cents[list_no] = sub_cent[0]
        cents = np.concatenate([cents, sub_cent[1:]], axis=0)
        q = idx.quantizer
        q.reset()
        q.add(cents)                   # an HNSW quantizer rebuilds its graph
        idx.nlist = len(cents)
        idx.invalidate_assign()        # the centroid set changed
        idx._repack()
        return self.split_k - 1

    def balance(self, max_rounds: int = 8) -> int:
        """Split the oversized lists, largest first, until none remains or
        after max_rounds rounds. Returns the number of new lists."""
        created = 0
        for _ in range(max_rounds):
            over = self.oversized_lists()
            if len(over) == 0:
                break
            sizes = self.index.list_sizes
            for lst in sorted(over, key=lambda i: -sizes[i]):
                created += self.split_partition(int(lst))
        return created
