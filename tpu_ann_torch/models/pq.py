"""Flat codec indexes — PyTorch counterpart of `tpu_ann/models/pq.py`
(faiss `IndexScalarQuantizer.{h,cpp}`).

`IndexScalarQuantizer` keeps its codes as one device tensor; a search
decodes them with the codec (`ops.sq.sq_decode`) and runs the exact blocked
k-NN (`ops.distances.knn`) on the decoded rows, and a range search the
blocked radius scan of `ops.range_search` on them. The module's other class
in the reference, `IndexPQ`, waits for the PQ slice (ROADMAP queue 1, item
5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import sq as SQ
from .base import Index


class IndexScalarQuantizer(Index):
    """faiss IndexScalarQuantizer(d, qtype): flat SQ codes."""

    def __init__(self, d: int, qtype: int = SQ.QT_8BIT,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, metric, device=device)
        self.qtype = int(qtype)
        self.sq: Optional[SQ.SQCodec] = None
        self._codes: Optional[torch.Tensor] = None
        self.is_trained = self.qtype in SQ.QT_UNTRAINED
        if self.is_trained:
            self.sq = SQ.SQCodec(qtype=self.qtype, d=d)

    def train(self, x) -> None:
        x = self._check_input(x)
        self.sq = SQ.train_sq(x, self.qtype)
        self.is_trained = True

    def add(self, x) -> None:
        if not self.is_trained:
            raise RuntimeError("train() before add()")
        x = self._check_input(x)
        codes = SQ.sq_encode(self._to_device(x), self.sq)
        self._codes = codes if self._codes is None else torch.cat(
            [self._codes, codes])
        self.ntotal += len(x)

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        if self.ntotal == 0:
            bad = -np.inf if self.is_similarity else np.inf
            return (np.full((len(x), k), bad, np.float32),
                    np.full((len(x), k), -1, np.int64))
        xb = SQ.sq_decode(self._codes, self.sq)
        Dv, Iv = D.knn(self._to_device(x), xb, k, self.metric_type)
        return Dv.cpu().numpy(), Iv.cpu().numpy().astype(np.int64)

    def range_search(self, x, radius: float):
        """Exact codec-distance range scan (the IndexFlatCodes::range_search
        role, faiss/IndexFlatCodes.h:65): decode block by block on the
        device, keep the hits within the radius."""
        from ..ops.range_search import range_search_decoded

        x = self._check_input(x)
        if self.ntotal == 0:
            return (np.zeros(len(x) + 1, np.int64), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        res = range_search_decoded(
            x, lambda i0, i1: SQ.sq_decode(self._codes[i0:i1], self.sq),
            self.ntotal, radius, self.metric_type)
        return res.lims, res.distances, res.labels

    def reset(self) -> None:
        self._codes, self.ntotal = None, 0

    def sa_code_size(self) -> int:
        # known at construction (ScalarQuantizer.cpp set_derived_sizes)
        return (self.sq or SQ.SQCodec(qtype=self.qtype, d=self.d)).code_size

    def sa_encode(self, x) -> np.ndarray:
        """(n, d) vectors -> (n, code bytes) uint8; fp16 / bf16 codes are
        their raw little-endian bytes."""
        x = self._check_input(x)
        codes = SQ.sq_encode(self._to_device(x), self.sq)
        return codes.view(torch.uint8).cpu().numpy()

    def sa_decode(self, codes) -> np.ndarray:
        codes = torch.tensor(np.ascontiguousarray(codes), device=self.device)
        if codes.dtype == torch.uint8 and self.qtype in (SQ.QT_FP16,
                                                         SQ.QT_BF16):
            codes = codes.view(self.sq.code_dtype)
        return SQ.sq_decode(codes, self.sq).cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        return SQ.sq_decode(self._codes[key:key + 1], self.sq)[0].cpu() \
            .numpy()
