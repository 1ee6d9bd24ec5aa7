"""IndexRefine — PyTorch counterpart of `tpu_ann/models/refine.py`
(faiss `IndexRefine.{h,cpp}`): search k * k_factor candidates on a base
index, then re-score them with a finer codec and keep the k best.

Each re-rank is one gather of the candidates' rows, one batched f32
product and a stable sort on the device (on equal distances the lower
candidate position wins, as ``lax.top_k`` in the reference); there is no
per-query loop. `IndexRefineFlat` re-scores against the exact rows of an
`IndexFlat`; `IndexRefineSQ8Tier` against 8-bit SQ codes kept as one
(n, code size) uint8 device tensor (the reference's `AlignedByteTier` is a
TPU relayout workaround, not ported).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import sq as SQ
from ..ops import topk as TK
from .base import Index
from .flat import IndexFlat


def _rerank(xq: torch.Tensor, cand: torch.Tensor, vecs: torch.Tensor,
            k: int, metric: int, diff: bool = False):
    """The k best of candidate ids ``cand`` (nq, kk) (-1 = none) whose rows
    are ``vecs`` (nq, kk, d), in full f32: IP <q, x>; L2 max(||q||^2 +
    ||x||^2 - 2 <q, x>, 0), or with ``diff`` the summed squared difference
    (the generic IndexRefine's formula). Empty slots get the metric's
    worst value and id -1; fewer than k candidates are padded to (nq, k)
    with such slots, as faiss does."""
    similarity = D.is_similarity_metric(metric)
    xq = xq.float()
    if similarity:
        dis = torch.bmm(vecs, xq[:, :, None])[:, :, 0]
    elif diff:
        dif = vecs - xq[:, None, :]
        dis = (dif * dif).sum(2)
    else:
        ip = torch.bmm(vecs, xq[:, :, None])[:, :, 0]
        dis = torch.clamp((xq * xq).sum(1, keepdim=True)
                          + (vecs * vecs).sum(2) - 2.0 * ip, min=0.0)
    valid = cand >= 0
    dis = torch.where(valid, dis, D.worst_value(metric))
    nq, kk = cand.shape
    if kk < k:
        dis = torch.cat([dis, dis.new_full((nq, k - kk),
                                           D.worst_value(metric))], 1)
        cand = torch.cat([cand, cand.new_full((nq, k - kk), -1)], 1)
        valid = cand >= 0
    Dv, Iv = TK.topk_with_ids(dis, torch.where(valid, cand, -1), k,
                              similarity=similarity)
    return Dv, torch.where(torch.isfinite(Dv), Iv, -1)


def _empty_result(metric: int, nq: int, k: int):
    return (np.full((nq, k), D.worst_value(metric), np.float32),
            np.full((nq, k), -1, np.int64))


class IndexRefine(Index):
    """Generic refine wrapper (faiss IndexRefine: base + refine_index); the
    candidates' rows come from ``refine_index.reconstruct_batch``."""

    def __init__(self, base_index: Index, refine_index: Index):
        super().__init__(base_index.d, base_index.metric_type,
                         device=base_index.device)
        self.base_index = base_index
        self.refine_index = refine_index
        self.k_factor = 4  # faiss default is 1; harnesses usually sweep it
        self.is_trained = base_index.is_trained and refine_index.is_trained

    def train(self, x) -> None:
        self.base_index.train(x)
        self.refine_index.train(x)
        self.is_trained = True

    def _check_trained(self, what: str) -> None:
        if not self.is_trained:
            raise RuntimeError(f"train() before {what}()")

    def add(self, x) -> None:
        self._check_trained("add")
        self.base_index.add(x)
        self.refine_index.add(x)
        self.ntotal = self.base_index.ntotal

    def reset(self) -> None:
        self.base_index.reset()
        self.refine_index.reset()
        self.ntotal = 0

    def _kk(self, k: int) -> int:
        return min(max(int(k * self.k_factor), k), max(self.ntotal, 1))

    def search(self, x, k: int, *, params=None):
        self._check_trained("search")
        x = self._check_input(x)
        if self.ntotal == 0:
            return _empty_result(self.metric_type, len(x), k)
        _, I = self.base_index.search(x, self._kk(k), params=params)
        Dv, Iv = self._refine(self._to_device(x),
                              torch.as_tensor(I, device=self.device), k)
        return Dv.cpu().numpy(), Iv.cpu().numpy().astype(np.int64)

    def _rows(self, ids: np.ndarray) -> torch.Tensor:
        """The refine codec's f32 rows of ids (>= 0) on the device."""
        return torch.as_tensor(
            np.asarray(self.refine_index.reconstruct_batch(ids), np.float32),
            device=self.device)

    def _refine(self, xq: torch.Tensor, cand: torch.Tensor, k: int):
        nq, kk = cand.shape
        cand = cand.long()
        valid = cand >= 0
        vecs = torch.zeros((nq, kk, self.d), device=self.device)
        if valid.any():
            vecs[valid] = self._rows(cand[valid].cpu().numpy())
        return _rerank(xq, cand, vecs, k, self.metric_type, diff=True)

    def range_search(self, x, radius: float):
        """faiss IndexRefine::range_search (IndexRefine.h:57): the base
        index proposes the hits within the radius; each is re-scored with
        the refine codec and filtered again (L2 summed squared difference
        < radius, IP > radius), in the base's order. The base's misses
        stay missed."""
        x = self._check_input(x)
        lims, _, labels = self.base_index.range_search(x, radius)
        labels = np.asarray(labels, np.int64)
        if len(labels) == 0:
            return lims, np.zeros(0, np.float32), labels
        q = torch.as_tensor(np.repeat(np.arange(len(x)), np.diff(lims)),
                            device=self.device)
        xq = self._to_device(x)[q]
        vecs = self._rows(labels)
        if self.is_similarity:
            dis = (vecs * xq).sum(1)
            ok = dis > radius
        else:
            dif = vecs - xq
            dis = (dif * dif).sum(1)
            ok = dis < radius
        new_lims = np.zeros(len(x) + 1, np.int64)
        np.cumsum(torch.bincount(q[ok], minlength=len(x)).cpu().numpy(),
                  out=new_lims[1:])
        return (new_lims, dis[ok].cpu().numpy(),
                labels[ok.cpu().numpy()])

    def reconstruct(self, key: int) -> np.ndarray:
        return self.refine_index.reconstruct(key)


class IndexRefineFlat(IndexRefine):
    """faiss IndexRefineFlat: the exact re-rank against the raw rows of an
    `IndexFlat` refine index, on the device."""

    def __init__(self, base_index: Index,
                 refine_index: Optional[IndexFlat] = None):
        refine = refine_index or IndexFlat(base_index.d,
                                           base_index.metric_type,
                                           device=base_index.device)
        super().__init__(base_index, refine)

    def _rows(self, ids: np.ndarray) -> torch.Tensor:
        return self.refine_index.vectors[torch.as_tensor(
            ids, device=self.device)].float()

    def _refine(self, xq: torch.Tensor, cand: torch.Tensor, k: int):
        cand = cand.long()
        vecs = self.refine_index.vectors[cand.clamp(min=0)].float()
        return _rerank(xq, cand, vecs, k, self.metric_type)

    def search_device(self, xq_dev: torch.Tensor, k: int):
        """Device-in / device-out refine search: the base index's
        search_device candidates and the exact re-rank (base rows and
        refine rows coincide: add appends to both in the same order)."""
        _, Ib = self.base_index.search_device(xq_dev, self._kk(k))
        return self._refine(xq_dev, Ib, k)


class IndexRefineSQ8Tier(Index):
    """Re-rank base-index candidates against SQ8 codes on the device (the
    role of faiss IndexRefine with a ScalarQuantizer refine index,
    faiss/IndexRefine.h:22). The codes are one (n, code size) uint8 tensor;
    the re-rank decodes the candidates with the codec's own qtype and
    scores them in full f32."""

    def __init__(self, base_index: Index):
        super().__init__(base_index.d, base_index.metric_type,
                         device=base_index.device)
        self.base_index = base_index
        self.k_factor = 4
        self.codec: Optional[SQ.SQCodec] = None
        self._codes: Optional[torch.Tensor] = None
        self.is_trained = False

    def train(self, x) -> None:
        x = self._check_input(x)
        self.base_index.train(x)
        self.codec = SQ.train_sq(x, SQ.QT_8BIT)
        self.is_trained = True

    def _check_trained(self, what: str) -> None:
        if not self.is_trained:
            raise RuntimeError(f"train() before {what}()")

    def add(self, x) -> None:
        self._check_trained("add")
        x = self._check_input(x)
        self.base_index.add(x)
        codes = SQ.sq_encode(self._to_device(x), self.codec)
        self._codes = codes if self._codes is None else torch.cat(
            [self._codes, codes])
        self.ntotal = self.base_index.ntotal

    def reset(self) -> None:
        self.base_index.reset()
        self._codes = None
        self.ntotal = 0

    def search(self, x, k: int, *, params=None):
        self._check_trained("search")
        x = self._check_input(x)
        if self.ntotal == 0:
            return _empty_result(self.metric_type, len(x), k)
        kk = min(max(int(k * self.k_factor), k), self.ntotal)
        _, I = self.base_index.search(x, kk, params=params)
        cand = torch.as_tensor(np.asarray(I, np.int64), device=self.device)
        vecs = SQ.sq_decode(self._codes[cand.clamp(min=0)], self.codec)
        Dv, Iv = _rerank(self._to_device(x), cand, vecs, k,
                         self.metric_type)
        return Dv.cpu().numpy(), Iv.cpu().numpy().astype(np.int64)

    def reconstruct(self, key: int) -> np.ndarray:
        if not 0 <= key < self.ntotal:
            raise KeyError(key)
        return SQ.sq_decode(self._codes[key:key + 1], self.codec)[0] \
            .cpu().numpy()
