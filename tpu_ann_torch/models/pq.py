"""Flat codec indexes — PyTorch counterpart of `tpu_ann/models/pq.py`
(faiss `IndexPQ.{h,cpp}`, `IndexScalarQuantizer.{h,cpp}`).

`IndexPQ` keeps its PQ codes as one device tensor. An 8-bit codec (ksub >
16) within the byte budget also keeps the decoded rows in bf16 (the
"decoded cache", maintained as rows are added), and ST_PQ searches them
with the blocked bf16 k-NN product of `ops.distances.knn` (a plain product
outside any kernel in the reference too); otherwise ST_PQ and ST_SDC sum
per-query look-up tables over the codes (`ops.pq.adc_scan_db`, plain torch
as the reference's XLA). ST_POLYSEMOUS filters the codes by their Hamming
distance to the query's code and sums only those that pass
(`ops.polysemous`), after ``do_polysemous_training`` permuted the
codebook. `IndexScalarQuantizer` decodes its codes with
the codec (`ops.sq.sq_decode`) and runs the exact blocked k-NN on the
decoded rows. A range search of either takes the blocked radius scan of
`ops.range_search` over decoded rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import pq as PQ
from ..ops import sq as SQ
from ..ops import topk as TK
from ..ops.polysemous import optimize_pq_for_hamming, polysemous_knn
from .base import Index


def _lut_knn(lut: torch.Tensor, codes: torch.Tensor, k: int, metric: int,
             valid_n: int, db_block: int = 65536, packed4: bool = False,
             id_mask: Optional[torch.Tensor] = None):
    """Blocked table-sum k-NN over a flat code array given per-query
    (M, ksub) tables (reference :27-61), shared by ADC (`query_tables`)
    and SDC (`sdc_query_tables`): each block's sums merge into a running
    top-k, rows at or past ``valid_n`` and rows an ``id_mask`` (a
    selector's uint8 bitmap) leaves out get the metric's worst value, and
    slots left at it get id -1."""
    nq = lut.shape[0]
    similarity = D.is_similarity_metric(metric)
    bad = D.worst_value(metric)
    dev = lut.device
    bd = torch.full((nq, k), bad, device=dev)
    bi = torch.full((nq, k), -1, dtype=torch.long, device=dev)
    for b0 in range(0, max(codes.shape[0], 1), db_block):
        raw = codes[b0:b0 + db_block]
        if packed4:
            raw = PQ.unpack_codes_4bit(raw)
        dis = PQ.adc_scan_db(lut, raw)
        ids = torch.arange(b0, b0 + raw.shape[0], device=dev)
        ok = ids < valid_n
        if id_mask is not None:
            ok = ok & (id_mask[b0:b0 + raw.shape[0]] != 0)
        dis = torch.where(ok, dis, bad)
        bd, bi = TK.merge_topk(bd, bi, dis, ids.expand(nq, -1), k,
                               similarity=similarity)
    return bd, torch.where(torch.isfinite(bd), bi, -1)


def _sel_mask(params, n: int, device) -> Optional[torch.Tensor]:
    """params.sel (an IDSelector) as a uint8 bitmap over the n stored rows
    on ``device``, or None. The reference's IndexPQ and
    IndexScalarQuantizer ignore the selector (:183, :312); faiss filters
    their scans by it."""
    sel = getattr(params, "sel", None) if params is not None else None
    if sel is None:
        return None
    return torch.from_numpy(sel.make_bitmap(n)).to(device)


def _kept(sel, n: int, device) -> Optional[torch.Tensor]:
    """The bool mask of the n stored rows an IDSelector does not match, or
    None if it matches none."""
    hit = sel.make_bitmap(n) != 0
    if not hit.any():
        return None
    return torch.from_numpy(~hit).to(device)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class IndexPQ(Index):
    """faiss IndexPQ(d, M, nbits): flat PQ codes, ADC search.

    ``search_type``: ST_PQ (asymmetric, default), ST_SDC (the encoded
    query's symmetric tables) or ST_POLYSEMOUS (L2: the Hamming filter on
    codes at ``polysemous_ht`` before ADC, `ops.polysemous`; 0 means
    M * nbits + 1, the filter off; ``last_hamming_pass`` counts the
    (query, code) pairs that passed the last such search).
    ``do_polysemous_training`` permutes the trained centroids for Hamming
    (``polysemous_iters`` annealing steps a sub-quantizer)."""

    ST_PQ = 0
    ST_POLYSEMOUS = 1
    ST_SDC = 2

    def __init__(self, d: int, M: int, nbits: int = 8,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, metric, device=device)
        self.M = int(M)
        self.nbits = int(nbits)
        self.pq: Optional[PQ.PQCodec] = None
        self._cent: Optional[torch.Tensor] = None
        self._codes: Optional[torch.Tensor] = None
        # the reference's storage capacity (a power of two, at least 1024):
        # the decoded cache's byte rule counts it
        self._capacity = 0
        self.is_trained = False
        self.search_type = self.ST_PQ
        self.do_polysemous_training = False
        self.polysemous_ht = 0
        self.polysemous_iters = 20000
        self.last_hamming_pass = 0
        self._sdc: Optional[torch.Tensor] = None
        # the decoded cache: None = auto (on for ksub > 16 when capacity * d
        # * 2 bytes fit decoded_cache_max_bytes, reference :161-167);
        # True / False force it
        self.use_decoded_cache: Optional[bool] = None
        self.decoded_cache_max_bytes: int = 2 << 30
        self._dec: Optional[torch.Tensor] = None

    def _set_codec(self, centroids: np.ndarray) -> None:
        self.pq = PQ.PQCodec(centroids=np.asarray(centroids, np.float32),
                             d=self.d, M=self.M, nbits=self.nbits)
        self._cent = PQ.as_centroids(self.pq.centroids, self.device)
        self._sdc = None          # SDC tables belong to the old codebook
        self._dec = None
        self.is_trained = True

    def train(self, x) -> None:
        x = self._check_input(x)
        cents = PQ.train_pq(x, self.M, self.nbits,
                            device=self.device).centroids
        if self.do_polysemous_training:
            cents = optimize_pq_for_hamming(cents,
                                            n_iter=self.polysemous_iters)
        self._set_codec(cents)

    @property
    def _packed4(self) -> bool:
        return self.nbits == 4

    def _encode(self, x) -> torch.Tensor:
        codes = PQ.pq_encode_chunked(x, self._cent)
        return PQ.pack_codes_4bit(codes) if self._packed4 else codes

    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        if self._packed4:
            codes = PQ.unpack_codes_4bit(codes)
        return PQ.pq_decode(codes, self._cent)

    def add(self, x) -> None:
        if not self.is_trained:
            raise RuntimeError("train() before add()")
        x = self._check_input(x)
        codes = self._encode(x)
        need = self.ntotal + len(x)
        if need > self._capacity:
            self._capacity = max(_next_pow2(need), 1024)
        if self._cache_enabled():
            self._ensure_dec()
            self._dec = torch.cat([self._dec,
                                   self._decode(codes).to(torch.bfloat16)])
        self._codes = codes if self._codes is None else torch.cat(
            [self._codes, codes])
        self.ntotal = need

    def _cache_enabled(self) -> bool:
        if self.use_decoded_cache is not None:
            return bool(self.use_decoded_cache)
        if (1 << self.nbits) <= 16:
            return False
        return self._capacity * self.d * 2 <= self.decoded_cache_max_bytes

    def _ensure_dec(self) -> torch.Tensor:
        """The bf16 decoded rows of every stored code, rebuilt when missing
        (rows added before the cache was on, an index read from a file)."""
        if self._dec is None or self._dec.shape[0] != self.ntotal:
            self._dec = torch.empty((0, self.d), dtype=torch.bfloat16,
                                    device=self.device)
            for i in range(0, self.ntotal, 1 << 18):
                self._dec = torch.cat([self._dec, self._decode(
                    self._codes[i:i + (1 << 18)]).to(torch.bfloat16)])
        return self._dec

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        if self.ntotal == 0:
            bad = D.worst_value(self.metric_type)
            return (np.full((len(x), k), bad, np.float32),
                    np.full((len(x), k), -1, np.int64))
        xq = self._to_device(x)
        id_mask = _sel_mask(params, self.ntotal, self.device)
        if self.search_type == self.ST_POLYSEMOUS:
            if self.is_similarity:
                raise ValueError("IndexPQ: ST_POLYSEMOUS is L2 only")
            # 0 maps to M * nbits + 1: every code passes (IndexPQ.cpp:330)
            ht = self.polysemous_ht or (self.M * self.nbits + 1)
            Dv, Iv, npass = polysemous_knn(
                xq, self._codes, self._cent, k, ht, self.ntotal,
                packed4=self._packed4, id_mask=id_mask)
            self.last_hamming_pass = int(npass.sum())
            return Dv.cpu().numpy(), Iv.cpu().numpy()
        if self.search_type == self.ST_SDC:
            if self._sdc is None:
                self._sdc = PQ.sdc_tables(self._cent)
            lut = PQ.sdc_query_tables(PQ.pq_encode(xq, self._cent),
                                      self._sdc)
        elif self._cache_enabled():
            Dv, Iv = D.knn(xq, self._ensure_dec(), k, self.metric_type,
                           compute_dtype="bfloat16", valid_n=self.ntotal,
                           id_mask=id_mask)
            return Dv.cpu().numpy(), Iv.cpu().numpy().astype(np.int64)
        else:
            lut = PQ.query_tables(xq, self._cent, self.metric_type)
        Dv, Iv = _lut_knn(lut, self._codes, k, self.metric_type,
                          self.ntotal, packed4=self._packed4,
                          id_mask=id_mask)
        return Dv.cpu().numpy(), Iv.cpu().numpy().astype(np.int64)

    def range_search(self, x, radius: float):
        """faiss IndexFlatCodes::range_search (IndexFlatCodes.h:65): the
        exact distance to the decoded rows, block by block."""
        from ..ops.range_search import range_search_decoded

        x = self._check_input(x)
        if self.ntotal == 0:
            return (np.zeros(len(x) + 1, np.int64), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        res = range_search_decoded(
            x, lambda i0, i1: self._decode(self._codes[i0:i1]), self.ntotal,
            radius, self.metric_type)
        return res.lims, res.distances, res.labels

    def reset(self) -> None:
        self._codes, self._capacity, self.ntotal = None, 0, 0
        self._sdc = None
        self._dec = None

    def remove_ids(self, sel) -> int:
        """Remove the rows an IDSelector matches; the rest are renumbered
        in order (faiss IndexFlatCodes::remove_ids). The reference's
        IndexPQ has none."""
        keep = _kept(sel, self.ntotal, self.device)
        if keep is None:
            return 0
        self._codes = self._codes[keep]
        self._dec = None
        removed = self.ntotal - len(self._codes)
        self.ntotal = len(self._codes)
        return removed

    # --- codec API --------------------------------------------------------
    def sa_code_size(self) -> int:
        # known at construction (ProductQuantizer.h code_size)
        return (self.M + 1) // 2 if self._packed4 else self.M

    def sa_encode(self, x) -> np.ndarray:
        return self._encode(self._check_input(x)).cpu().numpy()

    def sa_decode(self, codes) -> np.ndarray:
        codes = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(
            self.device)
        return self._decode(codes).cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        if not 0 <= key < self.ntotal:
            raise KeyError(key)
        return self._decode(self._codes[key:key + 1])[0].cpu().numpy()


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
        Dv, Iv = D.knn(self._to_device(x), xb, k, self.metric_type,
                       id_mask=_sel_mask(params, self.ntotal, self.device))
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

    def remove_ids(self, sel) -> int:
        """As IndexPQ.remove_ids (the reference's IndexScalarQuantizer has
        none)."""
        keep = _kept(sel, self.ntotal, self.device)
        if keep is None:
            return 0
        self._codes = self._codes[keep]
        removed = self.ntotal - len(self._codes)
        self.ntotal = len(self._codes)
        return removed

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
