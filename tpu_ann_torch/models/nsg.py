"""Graph indexes — PyTorch counterpart of `tpu_ann/models/nsg.py` (faiss
`IndexNSG{,Flat,PQ,SQ}` (IndexNSG.{h,cpp}) and `IndexNNDescentFlat`
(IndexNNDescent.{h,cpp})).

Flat storage under a single-level graph: NN-descent's k-NN graph
(`ops.nndescent.nn_descent`), pruned into an NSG rooted at the medoid
(`build_nsg`). A search is `ops.hnsw.beam_search_level0` in query chunks
of ``IndexHNSW.search_chunk`` (its visited table is (chunk, ntotal + 1)
booleans) from the medoid, or, for the raw NN-descent graph, from the
first four ids, as the reference does (:46-50; faiss draws random
entries). ``efSearch`` comes from ``params`` where it is set.

The coded NSGs keep their codes as the index's content and build the
graph, and search it, over the decoded rows, which they rebuild at every
add, as the reference does (:146-166).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import nndescent as ND
from ..ops import pq as PQ
from ..ops import sq as SQ
from ..ops.hnsw import beam_search_level0
from ..ops.topk import chunk_starts
from .base import Index
from .flat import IndexFlat
from .hnsw import IndexHNSW


class _GraphIndex(Index):
    """Flat storage and a level-0 graph searched by the batched beam."""

    search_chunk = IndexHNSW.search_chunk

    def __init__(self, d: int, metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, metric, device=device)
        self.nnd_iters = 10
        self.efSearch = 16
        self.verbose = False
        self.storage = IndexFlat(d, metric, device=device)
        self.graph: Optional[torch.Tensor] = None

    def _entries(self, nq: int) -> torch.Tensor:
        raise NotImplementedError

    def search_device(self, xq: torch.Tensor, k: int, params=None):
        """(D, I) tensors of a device query batch."""
        ef = max(getattr(params, "efSearch", 0) or self.efSearch, k)
        outs = []
        for i in chunk_starts(xq.shape[0], self.search_chunk):
            q = xq[i:i + self.search_chunk]
            Dv, Iv, _ = beam_search_level0(
                self.storage.vectors, self.graph, q,
                self._entries(q.shape[0]), ef=ef, k=k,
                metric=self.metric_type)
            outs.append((Dv, Iv))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]).long())

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        if self.graph is None:
            return (np.full((len(x), k), D.worst_value(self.metric_type),
                            np.float32), np.full((len(x), k), -1, np.int64))
        Dv, Iv = self.search_device(self._to_device(x), k, params)
        return Dv.cpu().numpy(), Iv.cpu().numpy()

    def reset(self) -> None:
        self.storage.reset()
        self.graph = None
        self.ntotal = 0

    def reconstruct(self, key: int) -> np.ndarray:
        return self.storage.reconstruct(key)


class IndexNNDescentFlat(_GraphIndex):
    """Flat storage and an NN-descent K-NN graph (faiss
    IndexNNDescentFlat), rebuilt at every add."""

    def __init__(self, d: int, K: int = 32, metric: int = D.METRIC_L2, *,
                 device="cuda"):
        super().__init__(d, metric, device=device)
        self.K = int(K)

    def add(self, x) -> None:
        self.storage.add(self._check_input(x))
        self.ntotal = self.storage.ntotal
        self.graph, _ = ND.nn_descent(self.storage.vectors, self.K,
                                      iters=self.nnd_iters,
                                      verbose=self.verbose)

    def _entries(self, nq: int) -> torch.Tensor:
        e = min(4, self.ntotal)
        return torch.arange(e, dtype=torch.int32,
                            device=self.device).expand(nq, e)


class IndexNSGFlat(_GraphIndex):
    """Flat storage and an NSG (faiss IndexNSGFlat): NN-descent's GK-NN
    graph pruned to degree R by the MRNG rule, searched from the
    medoid."""

    def __init__(self, d: int, R: int = 32, metric: int = D.METRIC_L2, *,
                 device="cuda"):
        super().__init__(d, metric, device=device)
        self.R = int(R)
        self.GK = max(2 * R, 32)     # the k-NN degree fed to the pruner
        self.medoid = 0
        # seconds of the last build's two steps
        self.build_seconds = {}

    def _build(self) -> torch.Tensor:
        """Build the graph over ``storage``; return NN-descent's GK-NN
        graph, before the prune."""
        x = self.storage.vectors
        t0 = time.perf_counter()
        knn_g, knn_d = ND.nn_descent(x, self.GK, iters=self.nnd_iters,
                                     verbose=self.verbose)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t1 = time.perf_counter()
        self.graph, self.medoid = ND.build_nsg(x, knn_g, knn_d, self.R,
                                               metric=self.metric_type)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        self.build_seconds = {"nn_descent": t1 - t0,
                              "prune": time.perf_counter() - t1}
        return knn_g

    def build(self, x) -> torch.Tensor:
        """``add``, returning NN-descent's GK-NN graph over every row
        before the prune (faiss IndexNSG::build's ``knn_graph``): its
        recall measures the build."""
        self.storage.add(self._check_input(x))
        self.ntotal = self.storage.ntotal
        return self._build()

    def add(self, x) -> None:
        self.build(x)

    def _entries(self, nq: int) -> torch.Tensor:
        return torch.full((nq, 1), self.medoid, dtype=torch.int32,
                          device=self.device)


class _IndexNSGCoded(IndexNSGFlat):
    """An NSG over coded storage (faiss IndexNSGPQ / IndexNSGSQ,
    IndexNSG.h:91-110): the codes (``_codes``, on the device) are the
    index's content; the graph is built, and searched, over their decoded
    rows, which ``storage`` holds."""

    def __init__(self, d: int, R: int = 32, metric: int = D.METRIC_L2, *,
                 device="cuda"):
        super().__init__(d, R, metric, device=device)
        self.is_trained = False
        self._codes: Optional[torch.Tensor] = None

    def _encode(self, x) -> torch.Tensor:
        raise NotImplementedError

    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sa_encode(self, x) -> np.ndarray:
        return self._encode(self._check_input(x)).cpu().numpy()

    def sa_decode(self, codes) -> np.ndarray:
        c = torch.as_tensor(np.asarray(codes)).to(self.device)
        return self._decode(c).cpu().numpy()

    def _set_codes(self, codes: torch.Tensor) -> None:
        """Hold ``codes`` and their decoded rows (no graph build)."""
        self._codes = codes
        self.storage.reset()
        self.storage.add(self._decode(codes))
        self.ntotal = self.storage.ntotal

    def build(self, x) -> torch.Tensor:
        if not self.is_trained:
            raise RuntimeError("train() before add() (IndexNSG coded)")
        codes = self._encode(self._check_input(x))
        if self._codes is not None:
            codes = torch.cat([self._codes, codes])
        self._set_codes(codes)
        return self._build()

    def reset(self) -> None:
        super().reset()
        self._codes = None

    def reconstruct(self, key: int) -> np.ndarray:
        return self._decode(self._codes[key:key + 1])[0].cpu().numpy()


class IndexNSGPQ(_IndexNSGCoded):
    """faiss IndexNSGPQ(d, pq_m, M, pq_nbits) (IndexNSG.h:91-96): PQ codes
    under an NSG; ``R`` is the graph degree (the reference's M)."""

    def __init__(self, d: int, pq_m: int, R: int = 32, nbits: int = 8,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, R, metric, device=device)
        self.pq_m = int(pq_m)
        self.nbits = int(nbits)
        self.pq: Optional[PQ.PQCodec] = None
        self._cent: Optional[torch.Tensor] = None

    def _set_codec(self, centroids) -> None:
        self.pq = PQ.PQCodec(centroids=np.asarray(centroids, np.float32),
                             d=self.d, M=self.pq_m, nbits=self.nbits)
        self._cent = PQ.as_centroids(self.pq.centroids, self.device)
        self.is_trained = True

    def train(self, x) -> None:
        self._set_codec(PQ.train_pq(self._check_input(x), self.pq_m,
                                    self.nbits, verbose=self.verbose,
                                    device=self.device).centroids)

    def _encode(self, x) -> torch.Tensor:
        return PQ.pq_encode_chunked(x, self._cent)

    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        return PQ.pq_decode(codes, self._cent)

    def sa_code_size(self) -> int:
        return self.pq_m * self.nbits // 8


class IndexNSGSQ(_IndexNSGCoded):
    """faiss IndexNSGSQ(d, qtype, M, metric) (IndexNSG.h:101-110):
    scalar-quantizer codes under an NSG."""

    def __init__(self, d: int, qtype: Optional[int] = None, R: int = 32,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, R, metric, device=device)
        self.qtype = SQ.QT_8BIT if qtype is None else int(qtype)
        self.sq: Optional[SQ.SQCodec] = None
        if self.qtype in SQ.QT_UNTRAINED:
            self.sq = SQ.SQCodec(qtype=self.qtype, d=d)
            self.is_trained = True

    def train(self, x) -> None:
        self.sq = SQ.train_sq(self._check_input(x), self.qtype)
        self.is_trained = True

    def _encode(self, x) -> torch.Tensor:
        return SQ.sq_encode(self._to_device(x), self.sq)

    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        return SQ.sq_decode(codes, self.sq).float()

    def sa_code_size(self) -> int:
        return (self.sq or SQ.SQCodec(qtype=self.qtype, d=self.d)).code_size
