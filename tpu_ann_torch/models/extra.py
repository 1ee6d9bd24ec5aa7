"""Long-tail index types — PyTorch counterpart of `tpu_ann/models/extra.py`.
Only `Index2Layer` (faiss Index2Layer.{h,cpp}) is ported: IndexHNSW2Level
stores its codes. The rest of the module (IndexLSH, IndexRowwiseMinMax,
MultiIndexQuantizer, IndexSplitVectors, IndexRandom) waits for ROADMAP
queue 1, item 9.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import pq as PQ
from ..ops.kmeans import ClusteringParameters, kmeans
from ..ops.range_search import range_search_decoded
from .base import Index


class Index2Layer(Index):
    """A coarse id and a PQ code of the residual a vector, stored flat
    (faiss Index2Layer; reference :216): no inverted lists, convertible to
    an IndexIVFPQ. A search decodes every stored code and runs the exact
    k-NN over the rows, as the reference's (a brute force over sa_decode).
    The codes live on the quantizer's device: ``_list_ids`` (ntotal,)
    int32 and ``_codes`` (ntotal, M) uint8."""

    def __init__(self, quantizer: Index, nlist: int, M: int,
                 nbits: int = 8):
        super().__init__(quantizer.d, quantizer.metric_type,
                         device=quantizer.device)
        self.q1 = quantizer
        self.nlist = int(nlist)
        self.M = int(M)
        self.nbits = int(nbits)
        self.pq: Optional[PQ.PQCodec] = None
        self._cent: Optional[torch.Tensor] = None
        self._list_ids = torch.zeros(0, dtype=torch.int32, device=self.device)
        self._codes = torch.zeros((0, self.M), dtype=torch.uint8,
                                  device=self.device)
        self.is_trained = False

    def _set_codec(self, centroids) -> None:
        self.pq = PQ.PQCodec(centroids=np.asarray(centroids, np.float32),
                             d=self.d, M=self.M, nbits=self.nbits)
        self._cent = PQ.as_centroids(self.pq.centroids, self.device)
        self.is_trained = True

    def train(self, x) -> None:
        """k-means (10 iterations) for the coarse centroids unless the
        quantizer already holds nlist of them, then the PQ of the
        residuals to each row's nearest centroid."""
        x = self._check_input(x)
        if self.q1.ntotal != self.nlist:
            cent, _ = kmeans(x, self.nlist, ClusteringParameters(niter=10),
                             device=self.device)
            self.q1.reset()
            self.q1.add(cent)
        a, _ = self._assign(x)
        resid = x - self.q1.vectors[a].cpu().numpy()
        self._set_codec(PQ.train_pq(resid, self.M, self.nbits,
                                    device=self.device).centroids)

    def _assign(self, x: np.ndarray):
        """(nearest centroid (n,) int64 device tensor, the residual codes
        (n, M) uint8)."""
        _, a = self.q1.search(x, 1)
        a = torch.from_numpy(np.ascontiguousarray(a[:, 0])).to(self.device)
        if self._cent is None:
            return a, None
        resid = x - self.q1.vectors[a].cpu().numpy()
        return a, PQ.pq_encode_chunked(resid, self._cent)

    def add(self, x) -> None:
        x = self._check_input(x)
        a, codes = self._assign(x)
        self._list_ids = torch.cat([self._list_ids, a.to(torch.int32)])
        self._codes = torch.cat([self._codes, codes])
        self.ntotal += len(x)

    def _decode(self, list_ids: torch.Tensor,
                codes: torch.Tensor) -> torch.Tensor:
        return self.q1.vectors[list_ids.long()] + PQ.pq_decode(codes,
                                                               self._cent)

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        Dv, Iv = D.knn(self._to_device(x),
                       self._decode(self._list_ids, self._codes), k,
                       self.metric_type)
        return Dv.cpu().numpy(), Iv.cpu().numpy().astype(np.int64)

    def range_search(self, x, radius: float):
        """Exact codec-distance range scan over the decoded rows (the
        IndexFlatCodes::range_search role)."""
        x = self._check_input(x)
        res = range_search_decoded(
            x, lambda i0, i1: self._decode(self._list_ids[i0:i1],
                                           self._codes[i0:i1]),
            self.ntotal, radius, self.metric_type)
        return res.lims, res.distances, res.labels

    def sa_code_size(self) -> int:
        return 4 + self.M     # int32 list id + M bytes (the reference's)

    def sa_encode(self, x) -> np.ndarray:
        """[list id: little-endian int32][M residual PQ bytes] a row (the
        reference's layout of Index2Layer::sa_encode)."""
        x = self._check_input(x)
        a, codes = self._assign(x)
        out = np.empty((len(x), 4 + self.M), np.uint8)
        out[:, :4] = a.cpu().numpy().astype("<i4").reshape(-1, 1) \
            .view(np.uint8)
        out[:, 4:] = codes.cpu().numpy()
        return out

    def sa_decode(self, codes) -> np.ndarray:
        codes = np.asarray(codes, np.uint8)
        a = codes[:, :4].copy().view("<i4")[:, 0]
        sub = torch.from_numpy(np.ascontiguousarray(codes[:, 4:])).to(
            self.device)
        return self._decode(torch.from_numpy(a.astype(np.int64)).to(
            self.device), sub).cpu().numpy()

    def reset(self) -> None:
        self._list_ids = self._list_ids[:0]
        self._codes = self._codes[:0]
        self.ntotal = 0

    def to_ivfpq(self):
        """An IndexIVFPQ over the same quantizer and codebook holding the
        decoded rows (the reference's conversion)."""
        from .ivf_pq import IndexIVFPQ

        idx = IndexIVFPQ(self.q1, self.d, self.nlist, self.M, self.nbits,
                         self.metric_type, device=self.device)
        idx._set_codec(self.pq.centroids)
        idx.is_trained = True
        if self.ntotal:
            idx.add(self._decode(self._list_ids, self._codes).cpu().numpy())
        return idx
