"""Long-tail index types — PyTorch counterpart of `tpu_ann/models/extra.py`:
faiss `IndexLSH` (IndexLSH.{h,cpp}), `IndexRowwiseMinMax`
(IndexRowwiseMinMax.{h,cpp}), `MultiIndexQuantizer` (IndexPQ.h),
`Index2Layer` (Index2Layer.{h,cpp}), `IndexSplitVectors` and `IndexRandom`
(MetaIndexes.{h,cpp}).

Where the reference draws numbers (IndexLSH's projection, IndexRandom's
results) the port makes the same numpy ``RandomState`` draws, so the
numbers are equal. `MultiIndexQuantizer.search` is exact for M = 2 (the
reference keeps too few cells a subspace and can miss; see its
docstring).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import hamming as H
from ..ops import pq as PQ
from ..ops.kmeans import ClusteringParameters, kmeans
from ..ops.range_search import range_search_decoded
from ..ops.topk import chunk_starts
from .base import Index
from .binary import IndexBinaryFlat


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


class IndexLSH(Index):
    """Random-projection binary hashing (faiss IndexLSH): nbits projections
    of each row (a random orthonormal P, or the first nbits dims without
    ``rotate_data``), a bit for each above its threshold (0, or the
    training projections' median with ``train_thresholds``), codes held
    in an IndexBinaryFlat. P is the reference's numpy draw
    (``RandomState(1234)``, ``np.linalg.qr``; :33-44); the projection is
    one f32 product on the device (TF32 off)."""

    def __init__(self, d: int, nbits: int, rotate_data: bool = True,
                 train_thresholds: bool = False, *, device="cuda"):
        super().__init__(d, D.METRIC_L2, device=device)
        if nbits % 8:
            raise ValueError("nbits must be a multiple of 8")
        self.nbits = int(nbits)
        self.rotate_data = rotate_data
        self.train_thresholds = train_thresholds
        rs = np.random.RandomState(1234)
        q, _ = np.linalg.qr(rs.randn(d, d))
        cols = []
        for r in range(-(-nbits // d)):
            if r > 0:
                q, _ = np.linalg.qr(rs.randn(d, d))
            cols.append(q[:, :min(d, nbits - r * d)])
        self.P = np.concatenate(cols, axis=1).astype(np.float32)
        self.thresholds = np.zeros(nbits, np.float32)
        self._bin = IndexBinaryFlat(nbits, device=device)
        self.is_trained = not train_thresholds

    def _project(self, x) -> torch.Tensor:
        xd = self._to_device(x)
        if not self.rotate_data:
            return xd[:, :self.nbits]
        return xd @ torch.as_tensor(self.P, device=self.device)

    def train(self, x) -> None:
        x = self._check_input(x)
        if self.train_thresholds:
            self.thresholds = np.median(self._project(x).cpu().numpy(),
                                        axis=0).astype(np.float32)
        self.is_trained = True

    def encode_device(self, x) -> torch.Tensor:
        """(n, nbits / 8) uint8 codes on the device."""
        thr = torch.as_tensor(self.thresholds, device=self.device)
        return H.pack_bits(self._project(self._check_input(x)) > thr)

    def sa_encode(self, x) -> np.ndarray:
        return self.encode_device(x).cpu().numpy()

    def add(self, x) -> None:
        self._bin.add(self.encode_device(x))
        self.ntotal = self._bin.ntotal

    def search(self, x, k: int, *, params=None):
        Dv, Iv = self._bin.search(self.encode_device(x), k)
        return Dv.astype(np.float32), Iv

    def range_search(self, x, radius: float):
        """Hamming-radius range search over the codes (IndexLSH inherits
        IndexFlatCodes::range_search): {ham < r} = {ham < ceil(r)} on
        integer distances, returned as float like search()."""
        lims, dd, ii = self._bin.range_search(self.encode_device(x),
                                              math.ceil(radius))
        return lims, dd.astype(np.float32), ii

    def reset(self) -> None:
        self._bin.reset()
        self.ntotal = 0

    def sa_code_size(self) -> int:
        return self.nbits // 8


class IndexRowwiseMinMax(Index):
    """Per-row min / max normalization around a sub-index (faiss
    IndexRowwiseMinMax): each row is stored as (x - min) / scale with
    scale = max(max - min, 1e-12), its (min, scale) kept beside the
    sub-index's codes. The normalization is the reference's f32
    arithmetic on the device, so the normalized rows are equal."""

    def __init__(self, index: Index):
        super().__init__(index.d, index.metric_type, device=index.device)
        self.index = index
        self.is_trained = index.is_trained
        self._mins = torch.zeros(0, device=self.device)
        self._scales = torch.zeros(0, device=self.device)

    def _normalize(self, x):
        """(normalized rows, mins, scales) of (n, d) rows, on the
        device."""
        x = self._to_device(self._check_input(x))
        mn = x.min(1, keepdim=True).values
        scale = torch.clamp(x.max(1, keepdim=True).values - mn, min=1e-12)
        return (x - mn) / scale, mn[:, 0], scale[:, 0]

    def train(self, x) -> None:
        self.index.train(self._normalize(x)[0].cpu().numpy())
        self.is_trained = True

    def add(self, x) -> None:
        xn, mn, sc = self._normalize(x)
        self.index.add(xn.cpu().numpy())
        self._mins = torch.cat([self._mins, mn])
        self._scales = torch.cat([self._scales, sc])
        self.ntotal = self.index.ntotal

    def search(self, x, k: int, *, params=None):
        return self.index.search(self._normalize(x)[0], k, params=params)

    def range_search(self, x, radius: float):
        """Normalize, then the sub-index's range search (the radius is in
        the normalized space, as the reference reads it)."""
        return self.index.range_search(self._normalize(x)[0], radius)

    def reconstruct(self, key: int) -> np.ndarray:
        return (self.index.reconstruct(key) * float(self._scales[key])
                + float(self._mins[key])).astype(np.float32)

    def reset(self) -> None:
        self.index.reset()
        self._mins = self._mins[:0]
        self._scales = self._scales[:0]
        self.ntotal = 0


class MultiIndexQuantizer(Index):
    """IMI product-space quantizer (faiss MultiIndexQuantizer, IndexPQ.h):
    its virtual database is the cross product of M sub-codebooks (cell id
    i0 * ksub^(M-1) + i1 * ksub^(M-2) + ...). For M = 2 a search keeps the
    top min(ksub, k) cells of each subspace and ranks their outer sum,
    which holds the exact top k (a cell outside a subspace's top k has k
    better cells beside it); the reference keeps ceil(sqrt(4k)) and misses
    cells (extra.py:183). Past the second subspace the reference's greedy
    rule stays: each adds its best cell. Ties of equal sums are in
    (subspace 0 rank, subspace 1 rank) order."""

    def __init__(self, d: int, M: int = 2, nbits: int = 8, *,
                 device="cuda"):
        super().__init__(d, D.METRIC_L2, device=device)
        self.M = int(M)
        self.nbits = int(nbits)
        self.pq: Optional[PQ.PQCodec] = None
        self._cent: Optional[torch.Tensor] = None
        self.is_trained = False

    def _set_codec(self, centroids) -> None:
        self.pq = PQ.PQCodec(centroids=np.asarray(centroids, np.float32),
                             d=self.d, M=self.M, nbits=self.nbits)
        self._cent = PQ.as_centroids(self.pq.centroids, self.device)
        self.ntotal = self.pq.ksub ** self.M
        self.is_trained = True

    def train(self, x) -> None:
        self._set_codec(PQ.train_pq(self._check_input(x), self.M,
                                    self.nbits,
                                    device=self.device).centroids)

    def add(self, x) -> None:
        raise RuntimeError("MultiIndexQuantizer has a virtual database "
                           "(faiss: add not implemented)")

    def tables(self, x) -> torch.Tensor:
        """(nq, M, ksub) f32 distances of each query's subvectors to the
        sub-centroids."""
        return PQ.query_tables(self._to_device(self._check_input(x)),
                               self._cent)

    def search_device(self, xq: torch.Tensor, k: int):
        """(nq, k) at every k: the slots past the cells a search ranks
        (ksub^M at M <= 2, the first two subspaces' T * T cells past them)
        hold id -1 and +inf, faiss's contract."""
        out_d, out_i = self._ranked_cells(xq, k)
        short = k - out_d.shape[1]
        if short > 0:
            out_d = torch.cat([out_d, out_d.new_full((len(xq), short),
                                                     np.inf)], 1)
            out_i = torch.cat([out_i, out_i.new_full((len(xq), short),
                                                     -1)], 1)
        return out_d, out_i

    def _ranked_cells(self, xq: torch.Tensor, k: int):
        tabs = PQ.query_tables(xq, self._cent)
        nq, M, ksub = tabs.shape
        if M == 1:
            d0, o0 = torch.sort(tabs[:, 0], dim=1, stable=True)
            return d0[:, :k], o0[:, :k]
        T = min(ksub, k)
        d0, o0 = torch.sort(tabs[:, 0], dim=1, stable=True)
        d1, o1 = torch.sort(tabs[:, 1], dim=1, stable=True)
        d0, o0, d1, o1 = d0[:, :T], o0[:, :T], d1[:, :T], o1[:, :T]
        comb = (d0[:, :, None] + d1[:, None, :]).reshape(nq, T * T)
        out_d, order = torch.sort(comb, dim=1, stable=True)
        out_d, order = out_d[:, :k], order[:, :k]
        out_i = torch.gather(o0, 1, order // T) * ksub + \
            torch.gather(o1, 1, order % T)
        if M > 2:
            rest_d, rest_i = tabs[:, 2:].min(2)
            out_d = out_d + rest_d.sum(1, keepdim=True)
            hi = torch.zeros(nq, dtype=torch.long, device=xq.device)
            for m in range(M - 2):
                hi = hi * ksub + rest_i[:, m]
            out_i = out_i * ksub ** (M - 2) + hi[:, None]
        return out_d, out_i

    def search(self, x, k: int, *, params=None):
        Dv, Iv = self.search_device(self._to_device(self._check_input(x)),
                                    k)
        return Dv.cpu().numpy(), Iv.cpu().numpy()

    def reset(self) -> None:
        pass


class IndexSplitVectors(Index):
    """Dimension-split concatenation (faiss IndexSplitVectors): sub-index
    i holds dims [sum of the earlier widths, + its d) of every row, and a
    row's distance is the sum of its sub-distances. A search asks each
    sub-index for every row (k = ntotal), as the reference does, and sums
    the (queries, ntotal) table on the device in query chunks of at most
    ``SPLIT_BUDGET`` entries."""

    SPLIT_BUDGET = 1 << 28

    def __init__(self, d: int, *, device="cuda"):
        super().__init__(d, D.METRIC_L2, device=device)
        self.sub_indexes: List[Index] = []
        self._dims: List[int] = []

    def add_sub_index(self, index: Index) -> None:
        self.sub_indexes.append(index)
        self._dims.append(index.d)
        if sum(self._dims) > self.d:
            raise ValueError("sub-index dims exceed d")

    def add(self, x) -> None:
        x = self._to_device(self._check_input(x))
        off = 0
        for idx, dd in zip(self.sub_indexes, self._dims):
            idx.add(x[:, off:off + dd])
            off += dd
        self.ntotal = self.sub_indexes[0].ntotal

    def _sub_search(self, idx: Index, xq: torch.Tensor):
        if hasattr(idx, "search_device"):
            Dv, Iv = idx.search_device(xq.contiguous(), self.ntotal)
            return Dv.float(), Iv.long()
        Dv, Iv = idx.search(xq, self.ntotal)
        return (torch.as_tensor(Dv, device=self.device),
                torch.as_tensor(Iv, device=self.device))

    def search(self, x, k: int, *, params=None):
        xq = self._to_device(self._check_input(x))
        n = self.ntotal
        chunk = max(1, self.SPLIT_BUDGET // max(n, 1))
        outs = []
        for q0 in chunk_starts(len(xq), chunk):
            q = xq[q0:q0 + chunk]
            total = torch.zeros((len(q), n), device=self.device)
            off = 0
            for idx, dd in zip(self.sub_indexes, self._dims):
                Dv, Iv = self._sub_search(idx, q[:, off:off + dd])
                # each row once a query (-1 slots add 0.0): the sum of
                # the reference's order, 0 + part 0 + part 1 + ...
                total.scatter_add_(1, Iv.clamp(min=0),
                                   torch.where(Iv >= 0, Dv, 0.0))
                off += dd
            outs.append(torch.sort(total, dim=1, stable=True))
        Dv = torch.cat([o[0][:, :k] for o in outs])
        Iv = torch.cat([o[1][:, :k] for o in outs])
        if n < k:   # pad to (nq, k) with (inf, -1)
            Dv = torch.cat([Dv, Dv.new_full((len(xq), k - n), np.inf)], 1)
            Iv = torch.cat([Iv, Iv.new_full((len(xq), k - n), -1)], 1)
        return Dv.cpu().numpy(), Iv.cpu().numpy()

    def reset(self) -> None:
        for idx in self.sub_indexes:
            idx.reset()
        self.ntotal = 0


class IndexRandom(Index):
    """A deterministic pseudo-random index (faiss IndexRandom, a
    benchmarking stub): the reference's ``RandomState(seed)`` draws, so
    the results are the reference's."""

    def __init__(self, d: int, ntotal: int = 0, seed: int = 1234, *,
                 device="cuda"):
        super().__init__(d, D.METRIC_L2, device=device)
        self.ntotal = int(ntotal)
        self.seed = seed

    def add(self, x) -> None:
        self.ntotal += len(self._check_input(x))

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        rs = np.random.RandomState(self.seed)
        Iv = rs.randint(0, max(self.ntotal, 1), size=(len(x), k))
        Dv = np.sort(rs.rand(len(x), k).astype(np.float32), axis=1)
        return Dv, Iv.astype(np.int64)

    def reset(self) -> None:
        self.ntotal = 0
