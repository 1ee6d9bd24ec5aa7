"""Composite wrappers — PyTorch counterpart of `tpu_ann/models/idmap.py`:
faiss `IndexIDMap{,2}` (IndexIDMap.{h,cpp}), `IndexShards`
(IndexShards.cpp) and `IndexReplicas` (IndexReplicas.cpp).

The shards and replicas are containers of indexes in one process on one
device (the reference runs a thread a sub-index and heap-merges); the
results of the shards merge on the device with `ops.topk.merge_topk_axis`.

Three repairs of the reference:
- a search selector of an IDMap names EXTERNAL ids, so it reaches the
  sub-index as the bitmap of the internal rows whose external id it
  selects (the reference hands it over untranslated, :52-54);
- a sub-index that keeps its own ids and does not renumber on removal (the
  IVF family) is given fresh internal ids at each add and its id map is
  never compacted; the reference compacts both sides (:62-84), which maps
  every later row of an IVF to another row's id after a removal;
- IndexShards with ``successive_ids`` numbers the rows in the order they
  were added: each add gives its batch the next ids, and each shard keeps
  the first id of every run of rows an add gave it. A shard added full is
  one run that starts at the ntotal of the shards before it, as faiss's
  search-time bases do, and a single add gives shard i the ntotal of the
  shards before it too. The reference keeps one base a shard, overwritten
  by the last add (:176, 187); faiss refuses a second add.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import distances as D
from ..ops import extra_distances as XD
from ..ops import topk as TK
from .base import Index
from .selectors import IDSelectorBatch, IDSelectorBitmap


def _inner(index):
    """The index under any IndexPreTransform layers."""
    from .transforms import IndexPreTransform

    while isinstance(index, IndexPreTransform):
        index = index.index
    return index


def _keeps_ids(index) -> bool:
    """True for sub-indexes that store the ids they are given and do not
    renumber on removal (the IVF family)."""
    from .ivf import IndexIVF

    return isinstance(_inner(index), IndexIVF)


def _renumbers(index) -> bool:
    """True for sub-indexes whose remove_ids renumbers the rest in order
    (faiss IndexFlatCodes::remove_ids)."""
    from .flat import IndexFlat
    from .pq import IndexPQ, IndexScalarQuantizer

    return isinstance(_inner(index), (IndexFlat, IndexPQ,
                                      IndexScalarQuantizer))


def _similarity(metric: int) -> bool:
    return D.is_similarity_metric(metric) or XD.is_similarity_extra(metric)


class IndexIDMap(Index):
    """Arbitrary int64 ids on top of a sub-index (faiss IndexIDMap):
    ``id_map[j]`` is the external id of internal id j. ``reconstruct`` by
    external id is IndexIDMap2's (faiss parity). ``id_map`` is an int64
    numpy array (the reference keeps a list)."""

    def __init__(self, index: Index):
        super().__init__(index.d, index.metric_type, device=index.device)
        self.index = index
        self.id_map = np.zeros(0, np.int64)
        # internal ids removed from a sub-index that keeps its ids (None:
        # every entry of id_map is live)
        self._gone: Optional[np.ndarray] = None
        self.is_trained = index.is_trained

    def train(self, x) -> None:
        self.index.train(x)
        self.is_trained = True

    def add(self, x) -> None:
        raise RuntimeError("use add_with_ids on IndexIDMap (faiss parity)")

    def add_with_ids(self, x, ids) -> None:
        x = self._check_input(x)
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(ids) != len(x):
            raise ValueError("ids / x length mismatch")
        n0 = len(self.id_map)
        if _keeps_ids(self.index):
            # fresh internal ids: never one a removed row had
            self.index.add_with_ids(
                x, np.arange(n0, n0 + len(x), dtype=np.int64))
        else:
            self.index.add(x)
        self.id_map = np.concatenate([self.id_map, ids])
        if self._gone is not None:
            self._gone = np.concatenate([self._gone,
                                         np.zeros(len(ids), bool)])
        self.ntotal = self.index.ntotal

    def _remap(self, Iv) -> np.ndarray:
        Iv = np.asarray(Iv, np.int64)
        if len(self.id_map) == 0:
            return np.full(Iv.shape, -1, np.int64)
        out = self.id_map[np.clip(Iv, 0, len(self.id_map) - 1)]
        return np.where(Iv >= 0, out, -1)

    def _selected(self, sel) -> np.ndarray:
        """(len(id_map),) bool: internal ids whose external id ``sel``
        selects (removed ones excluded)."""
        hit = np.asarray(sel.member_array(self.id_map), bool)
        return hit & ~self._gone if self._gone is not None else hit

    def _sub_params(self, params):
        """params with the selector translated to a bitmap over internal
        ids."""
        sel = getattr(params, "sel", None) if params is not None else None
        if sel is None:
            return params
        p = copy.copy(params)
        p.sel = IDSelectorBitmap(np.packbits(self._selected(sel),
                                             bitorder="little"))
        return p

    def search(self, x, k: int, *, params=None):
        Dv, Iv = self.index.search(x, k, params=self._sub_params(params))
        return Dv, self._remap(Iv)

    def range_search(self, x, radius: float, *, params=None):
        """Forwarded range search, labels mapped to external ids (faiss
        IndexIDMap::range_search, IndexIDMap.h:53); a selector in
        ``params`` keeps the hits whose external id it selects."""
        lims, dd, labels = self.index.range_search(x, radius)
        labels = np.asarray(labels, np.int64)
        sel = getattr(params, "sel", None) if params is not None else None
        if sel is not None and len(labels):
            keep = self._selected(sel)[labels]
            q = np.repeat(np.arange(len(lims) - 1), np.diff(lims))
            lims = np.concatenate([[0], np.cumsum(np.bincount(
                q[keep], minlength=len(lims) - 1))]).astype(np.int64)
            dd, labels = np.asarray(dd)[keep], labels[keep]
        return lims, dd, self._remap(labels)

    def remove_ids(self, sel) -> int:
        """Remove the vectors whose EXTERNAL id the selector matches (faiss
        IndexIDMap::remove_ids). A sub-index that renumbers stably
        (IndexFlat, IndexPQ, IndexScalarQuantizer) is compacted with the
        id map, as the reference does; one that keeps its ids (the IVF
        family) removes its internal ids and the id map keeps its
        entries. Any other sub-index raises."""
        keeps = _keeps_ids(self.index)
        if not (keeps or _renumbers(self.index)):
            raise TypeError(
                f"IndexIDMap.remove_ids: a {type(_inner(self.index)).__name__}"
                " sub-index neither keeps its ids nor renumbers stably")
        hit = self._selected(sel)
        nremove = int(hit.sum())
        if nremove == 0:
            return 0
        inner = self.index.remove_ids(IDSelectorBatch(np.nonzero(hit)[0]))
        if inner != nremove:
            raise RuntimeError(f"sub-index removed {inner} rows, selector "
                               f"matched {nremove}")
        if keeps:
            if self._gone is None:
                self._gone = np.zeros(len(self.id_map), bool)
            self._gone |= hit
        else:
            self.id_map = self.id_map[~hit]
        self.ntotal = self.index.ntotal
        return nremove

    def reset(self) -> None:
        self.index.reset()
        self.id_map = np.zeros(0, np.int64)
        self._gone = None
        self.ntotal = 0

    def reconstruct(self, key: int) -> np.ndarray:
        raise RuntimeError("IndexIDMap cannot reconstruct by external id "
                           "(faiss parity); use IndexIDMap2")


class IndexIDMap2(IndexIDMap):
    """IndexIDMap with a reverse map for ``reconstruct`` by external id
    (faiss IndexIDMap2, IndexIDMap.h rev_map)."""

    def __init__(self, index: Index):
        super().__init__(index)
        self.rev_map: dict = {}

    def construct_rev_map(self) -> None:
        """Rebuild external id -> internal id over the live entries
        (IndexIDMap2Template::construct_rev_map)."""
        live = np.arange(len(self.id_map)) if self._gone is None \
            else np.nonzero(~self._gone)[0]
        self.rev_map = dict(zip(self.id_map[live].tolist(), live.tolist()))

    def add_with_ids(self, x, ids) -> None:
        n0 = len(self.id_map)
        super().add_with_ids(x, ids)
        self.rev_map.update(zip(self.id_map[n0:].tolist(),
                                range(n0, len(self.id_map))))

    def remove_ids(self, sel) -> int:
        n = super().remove_ids(sel)
        if n:
            self.construct_rev_map()
        return n

    def reset(self) -> None:
        super().reset()
        self.rev_map = {}

    def reconstruct(self, key: int) -> np.ndarray:
        try:
            pos = self.rev_map[int(key)]
        except KeyError:
            raise KeyError(f"id {key} not found") from None
        return self.index.reconstruct(pos)


class IndexShards(Index):
    """Database-sharded composite (faiss IndexShards): an add splits the
    batch evenly over the shards in order; a search asks every shard and
    merges their top-k on the device."""

    def __init__(self, d: int, metric=None, *, successive_ids: bool = True,
                 device="cuda"):
        super().__init__(d, D.METRIC_L2 if metric is None else metric,
                         device=device)
        self.shard_indexes: List[Index] = []
        self.successive_ids = successive_ids
        # a shard's runs of rows: (first row, its id, rows), one an add
        self.id_runs: List[List[Tuple[int, int, int]]] = []

    def add_shard(self, index: Index) -> None:
        """Append a shard; rows it already holds take the next ids."""
        if index.d != self.d:
            raise ValueError("shard dimension mismatch")
        self.shard_indexes.append(index)
        self.id_runs.append([(0, self.ntotal, index.ntotal)]
                            if index.ntotal else [])
        self.ntotal += index.ntotal

    @property
    def count(self) -> int:
        return len(self.shard_indexes)

    def train(self, x) -> None:
        for idx in self.shard_indexes:
            idx.train(x)
        self.is_trained = True

    def add(self, x) -> None:
        """Shard i gets the i-th contiguous part of the batch, under the
        ids that part has in the order of all adds
        (IndexShards::add_with_ids, successive_ids)."""
        x = self._check_input(x)
        if self.count == 0:
            raise RuntimeError("no shards")
        per = -(-len(x) // self.count)
        for i, idx in enumerate(self.shard_indexes):
            chunk = x[i * per:(i + 1) * per]
            if len(chunk):
                self.id_runs[i].append((idx.ntotal, self.ntotal + i * per,
                                        len(chunk)))
                idx.add(chunk)
        self.ntotal += len(x)

    def _global_ids(self, i: int, Iv: np.ndarray) -> np.ndarray:
        """Shard i's row numbers -> the container's ids."""
        runs = np.asarray(self.id_runs[i], np.int64).reshape(-1, 3)
        if self.shard_indexes[i].ntotal != runs[:, 2].sum():
            raise RuntimeError(f"shard {i} was changed outside IndexShards")
        if len(runs) == 0:
            return np.full(Iv.shape, -1, np.int64)
        r = np.maximum(np.searchsorted(runs[:, 0], Iv, side="right") - 1, 0)
        return np.where(Iv >= 0, runs[r, 1] + Iv - runs[r, 0], -1)

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        parts_d, parts_i = [], []
        for i, idx in enumerate(self.shard_indexes):
            Dv, Iv = idx.search(x, k, params=params)
            Iv = np.asarray(Iv, np.int64)
            if self.successive_ids:
                Iv = self._global_ids(i, Iv)
            parts_d.append(torch.as_tensor(np.asarray(Dv, np.float32)))
            parts_i.append(torch.as_tensor(Iv))
        Dm, Im = TK.merge_topk_axis(
            torch.stack(parts_d).to(self.device),
            torch.stack(parts_i).to(self.device), k,
            similarity=_similarity(self.metric_type))
        return Dm.cpu().numpy(), Im.cpu().numpy()

    def reset(self) -> None:
        for idx in self.shard_indexes:
            idx.reset()
        self.id_runs = [[] for _ in self.shard_indexes]
        self.ntotal = 0


class IndexReplicas(Index):
    """Replicated composite (faiss IndexReplicas): every replica holds the
    whole database; a query batch is split evenly over the replicas."""

    def __init__(self, d: int, metric=None, *, device="cuda"):
        super().__init__(d, D.METRIC_L2 if metric is None else metric,
                         device=device)
        self.replicas: List[Index] = []

    def add_replica(self, index: Index) -> None:
        if index.d != self.d:
            raise ValueError("replica dimension mismatch")
        self.replicas.append(index)
        self.ntotal = index.ntotal

    def train(self, x) -> None:
        for idx in self.replicas:
            idx.train(x)
        self.is_trained = True

    def add(self, x) -> None:
        for idx in self.replicas:
            idx.add(x)
        self.ntotal = self.replicas[0].ntotal if self.replicas else 0

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        if not self.replicas:
            raise RuntimeError("no replicas")
        per = max(-(-len(x) // len(self.replicas)), 1)
        # the first replica answers an empty batch too: (0, k) results
        outs = [idx.search(x[i * per:(i + 1) * per], k, params=params)
                for i, idx in enumerate(self.replicas)
                if i == 0 or len(x[i * per:(i + 1) * per])]
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))

    def reset(self) -> None:
        for idx in self.replicas:
            idx.reset()
        self.ntotal = 0
