"""IVF + codec indexes — PyTorch counterpart of `tpu_ann/models/ivf_pq.py`
(faiss `IndexIVFPQ.{h,cpp}`, `IndexIVFPQR.cpp`, and
`IndexIVFScalarQuantizer` in `IndexScalarQuantizer.{h,cpp}`).

Invlists store the codec's codes in the block-packed layout
(`ops.ivf_scan.PackedCodeInvLists`).

IndexIVFPQ codes residuals (by_residual on L2). An 8-bit codec within the
byte budget searches its "decoded cache": the codes decoded once into a
raw layout (bf16 or f32 rows, or the SQ8 stream requantized from the bf16
rows), scanned by the fused scan — one launch of the hand-written K3, or
K3-SQ8 for "sq8", a search — which computes the ADC distance itself. A
4-bit codec, ``use_decoded_cache=False`` or a cache over budget takes the
query-major table scan `scan_invlists_pq` (plain torch, as the
reference's is XLA); a cached index under a selector or a cap takes the
query-major `scan_invlists` over its cache. The route follows the
reference's rule and nothing else: no size gate, no fallback.
IndexIVFPQR re-ranks k * k_factor candidates of that scan over the two-
level reconstructions (coarse + PQ + refine PQ) in exact f32.

IndexIVFScalarQuantizer's 8-bit qtypes search through the fused scan's
SQ8 stream: a zero-copy `PackedInvListsSQ8` view of the codes with the
codec's dequant affine, scanned by K3-SQ8. The other qtypes (4-bit, 6-bit,
fp16, bf16), and every qtype under an IDSelector or an explicit
max_codes, take the query-major `scan_invlists_sq`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import ivf_scan
from ..ops import pq as PQ
from ..ops import sq as SQ
from ..ops import topk as TK
from ..ops.topk import chunk_starts
from ..ops.ivf_scan_fused import scan_invlists_fused
from .ivf import IndexIVF

# rows encoded per device call while packing
_ENCODE_ROWS = 1 << 18

# the decoded cache's dtypes: (torch dtype of the decode, the reference's
# item size that its byte budget counts)
_CACHE_DTYPES = {"bfloat16": (torch.bfloat16, 2),
                 "float32": (torch.float32, 4),
                 "sq8": (torch.bfloat16, 1)}


class DecodedCacheIVF(IndexIVF):
    """An IVF over 8-bit code lists with a "decoded cache" (reference
    models/ivf_pq.py:106-172, models/rq.py:299-331): the codes decoded once
    into a raw layout the fused scan reads, rows rounded to bf16 / f32 (K3)
    or requantized to the SQ8 stream (K3-SQ8) for ``decoded_cache_dtype``
    "sq8". ``use_decoded_cache`` None (auto) caches a codec with ksub > 16
    when (nblocks + 1) * block_size * d * item size bytes fit
    ``decoded_cache_max_bytes``; True / False force it. The cache is
    derived state: dropped whenever the lists change (the port's
    remove_ids / update_vectors edit them in place, and an SQ8 cache's
    affine spans the rows), rebuilt at the next search, never written to a
    file. Subclasses give ``nbits``, ``_decode_lists(dtype)`` and
    ``_table_scan``, the route without a cache."""

    def _cache_init(self) -> None:
        self.use_decoded_cache: Optional[bool] = None
        self.decoded_cache_max_bytes: int = 8 << 30
        self.decoded_cache_dtype = "bfloat16"
        self._decoded = None

    def _lists_changed(self) -> None:
        super()._lists_changed()
        self._decoded = None

    def _cache_enabled(self) -> bool:
        if self.use_decoded_cache is not None:
            return bool(self.use_decoded_cache)
        if self.invlists is None or (1 << self.nbits) <= 16:
            return False
        isize = _CACHE_DTYPES[self.decoded_cache_dtype][1]
        nbytes = ((self.invlists.nblocks + 1) * self.block_size * self.d
                  * isize)
        return nbytes <= self.decoded_cache_max_bytes

    def _decoded_cache(self):
        """The decoded cache of the current lists (None where the route has
        none), built at first use: a PackedInvLists of the rows rounded to
        the cache dtype (K3), or for "sq8" the SQ8 stream requantized from
        the bf16-rounded rows (K3-SQ8), as the reference requantizes its
        bf16 cache."""
        if not self._cache_enabled():
            return None
        if self._decoded is None:
            dtype = _CACHE_DTYPES[self.decoded_cache_dtype][0]
            dec = self._decode_lists(dtype)
            if self.decoded_cache_dtype == "sq8":
                dec = ivf_scan.sq8_requantize_invlists(dec)
            self._decoded = dec
        return self._decoded

    def _ready(self) -> None:
        super()._ready()
        self._decoded_cache()

    def _scan_probes(self, xq_dev: torch.Tensor, probes: torch.Tensor,
                     k: int, mnb: Optional[int] = None, id_mask=None):
        """With a decoded cache: one fused scan (K3, or K3-SQ8 for "sq8"),
        or the query-major `scan_invlists` over the cache where the base
        class's rule picks it; without: the subclass's table scan."""
        dl = self._decoded_cache()
        if dl is not None and not self._query_major(mnb, id_mask):
            Dv, Iv, _ = scan_invlists_fused(xq_dev, probes, dl, k,
                                            self.metric_type)
            return Dv, Iv, None
        mnb = mnb or self._default_capped_mnb()
        if dl is not None:
            return ivf_scan.scan_invlists(xq_dev, probes, dl, k,
                                          self.metric_type, max_nblocks=mnb,
                                          id_mask=id_mask)
        return self._table_scan(xq_dev, probes, k, mnb, id_mask)

    def reset(self) -> None:
        super().reset()
        self._decoded = None


class IndexIVFPQ(DecodedCacheIVF):
    """IVF with PQ-coded residual invlists (faiss IndexIVFPQ); the decoded
    cache of `DecodedCacheIVF`, "bfloat16", "float32" or "sq8"."""

    def __init__(self, quantizer, d: int, nlist: int, M: int,
                 nbits: int = 8, metric: int = D.METRIC_L2,
                 block_size: int = 128, *, device="cuda"):
        super().__init__(quantizer, d, nlist, metric, block_size,
                         device=device)
        self.M = int(M)
        self.nbits = int(nbits)
        self.pq: Optional[PQ.PQCodec] = None
        self._cent: Optional[torch.Tensor] = None
        self.by_residual = True
        self._cache_init()

    def _set_codec(self, centroids: np.ndarray) -> None:
        self.pq = PQ.PQCodec(centroids=np.asarray(centroids, np.float32),
                             d=self.d, M=self.M, nbits=self.nbits)
        self._cent = PQ.as_centroids(self.pq.centroids, self.device)

    def _residual(self) -> bool:
        return self.by_residual and self.metric_type == D.METRIC_L2

    # --- training ---------------------------------------------------------
    def _residuals(self, x, assign) -> torch.Tensor:
        """Device rows x - c(assign) (the raw rows where the codes are not
        of residuals)."""
        xd = torch.from_numpy(np.array(x, np.float32)).to(self.device)
        if not self._residual():
            return xd
        a = torch.as_tensor(np.asarray(assign, np.int64)).to(self.device)
        return xd - self._coarse_centroids()[a]

    def train_encoder(self, x: np.ndarray) -> None:
        """PQ on the residuals (IndexIVFPQ::train_encoder)."""
        assign = self._assign(x) if self._residual() else None
        xt = self._residuals(x, assign).cpu().numpy()
        self._set_codec(PQ.train_pq(xt, self.M, self.nbits,
                                    device=self.device).centroids)

    # --- encoding / packing -----------------------------------------------
    def _residual_rows(self, x, assign):
        """rows(i, j) -> the device rows x[i:j] - c(assign[i:j]) (the raw
        rows where the codes are not of residuals), for
        `PQ.pq_encode_chunked`."""
        return lambda i, j: self._residuals(
            x[i:j], None if assign is None else assign[i:j])

    def _encode(self, x, assign) -> torch.Tensor:
        """(n, code width) uint8 device codes of x's residuals, packed two
        a byte at 4 bits."""
        codes = PQ.pq_encode_chunked(x, self._cent,
                                     rows=self._residual_rows(x, assign))
        return PQ.pack_codes_4bit(codes) if self.nbits == 4 else codes

    def _pack(self, x, ids, assign) -> ivf_scan.PackedCodeInvLists:
        self._decoded = None
        return ivf_scan.pack_code_invlists(self._encode(x, assign), ids,
                                           assign, self.nlist,
                                           self.block_size,
                                           device=self.device)

    # --- decoded cache ----------------------------------------------------
    def _decode_lists(self, dtype) -> ivf_scan.PackedInvLists:
        return ivf_scan.decode_code_invlists(
            self.invlists, self._cent,
            self._coarse_centroids() if self._residual() else None,
            packed4=self.nbits == 4, dtype=dtype)

    # --- search -----------------------------------------------------------
    def _table_scan(self, xq_dev, probes, k, mnb, id_mask):
        """`scan_invlists_pq` (reference :139-172)."""
        return ivf_scan.scan_invlists_pq(
            xq_dev, probes, self.invlists, self._cent,
            self._coarse_centroids() if self._residual() else None, k,
            self.metric_type, by_residual=self.by_residual, max_nblocks=mnb,
            id_mask=id_mask, packed4=self.nbits == 4)

    def _range_lists(self) -> ivf_scan.PackedInvLists:
        """The probed codes decoded to f32 rows: the exact ADC distance
        (reference :220-250)."""
        return self._decode_lists(torch.float32)

    # --- standalone codec: list id, then the PQ codes of the (residual)
    #     vector (IndexIVFPQ::encode_vectors / sa_decode) -----------------
    def _sa_payload_size(self) -> int:
        return (self.M + 1) // 2 if self.nbits == 4 else self.M

    def _sa_encode_payload(self, x, assign) -> np.ndarray:
        return self._encode(np.asarray(x, np.float32),
                            np.asarray(assign)).cpu().numpy()

    def _sa_decode_payload(self, payload, listno) -> np.ndarray:
        codes = torch.from_numpy(np.ascontiguousarray(payload)).to(
            self.device)
        if self.nbits == 4:
            codes = PQ.unpack_codes_4bit(codes)[:, :self.M]
        x = PQ.pq_decode(codes, self._cent)
        if self._residual():
            x = x + self._coarse_centroids()[
                torch.as_tensor(np.asarray(listno, np.int64),
                                device=self.device)]
        return x.cpu().numpy()


class IndexIVFPQR(IndexIVFPQ):
    """IVFPQ with a refinement PQ (faiss IndexIVFPQR, IndexIVFPQR.cpp): a
    ``refine_pq`` codes the residual left after the first PQ; a search
    scans for k * k_factor candidates, reconstructs them through both
    codebooks (+ the coarse centroid) and re-ranks them in exact f32, the
    lower candidate position first on ties. The re-rank sits in
    `_scan_probes`, so every entry point (search, search_stats,
    search_preassigned, search_stats_per_query) re-ranks; the reference's
    search_preassigned and per-query paths skip it. The base codes,
    refine codes and lists are also kept as row-indexed device tables (rows
    of the packed stream); a repack rebuilds them, and in-place removals
    leave rows where they are."""

    def __init__(self, quantizer, d: int, nlist: int, M: int,
                 nbits: int = 8, M_refine: int = 8, nbits_refine: int = 8,
                 metric: int = D.METRIC_L2, block_size: int = 128, *,
                 device="cuda"):
        super().__init__(quantizer, d, nlist, M, nbits, metric, block_size,
                         device=device)
        self.M_refine = int(M_refine)
        self.nbits_refine = int(nbits_refine)
        self.refine_pq: Optional[PQ.PQCodec] = None
        self._rcent: Optional[torch.Tensor] = None
        self.k_factor = 4          # faiss IndexIVFPQR::k_factor default
        self._row_codes: Optional[torch.Tensor] = None   # (n, M) uint8
        self._row_refine: Optional[torch.Tensor] = None  # (n, M_refine)
        self._row_assign: Optional[torch.Tensor] = None  # (n,) int32

    def _set_refine_codec(self, centroids: np.ndarray) -> None:
        self.refine_pq = PQ.PQCodec(
            centroids=np.asarray(centroids, np.float32), d=self.d,
            M=self.M_refine, nbits=self.nbits_refine)
        self._rcent = PQ.as_centroids(self.refine_pq.centroids, self.device)

    def _left_rows(self, x, assign, codes):
        """rows(i, j) -> what the base PQ leaves of rows x[i:j]'s residuals,
        given their base ``codes`` (what the refine PQ codes)."""
        res = self._residual_rows(x, assign)
        return lambda i, j: res(i, j) - PQ.pq_decode(codes[i:j], self._cent)

    def train_encoder(self, x: np.ndarray) -> None:
        super().train_encoder(x)
        assign = self._assign(x)
        codes = PQ.pq_encode_chunked(x, self._cent,
                                     rows=self._residual_rows(x, assign))
        r2 = self._left_rows(x, assign, codes)(0, len(x))
        self._set_refine_codec(PQ.train_pq(
            r2.cpu().numpy(), self.M_refine, self.nbits_refine,
            device=self.device).centroids)

    def _pack(self, x, ids, assign) -> ivf_scan.PackedCodeInvLists:
        self._decoded = None
        codes = PQ.pq_encode_chunked(x, self._cent,
                                     rows=self._residual_rows(x, assign))
        refine = PQ.pq_encode_chunked(x, self._rcent,
                                      rows=self._left_rows(x, assign, codes))
        self._row_codes, self._row_refine = codes, refine
        self._row_assign = torch.as_tensor(
            np.asarray(assign, np.int32)).to(self.device)
        packed = PQ.pack_codes_4bit(codes) if self.nbits == 4 else codes
        return ivf_scan.pack_code_invlists(packed, ids, assign, self.nlist,
                                           self.block_size,
                                           device=self.device)

    def _rerank(self, xq_dev: torch.Tensor, rows: torch.Tensor, k: int):
        """Exact f32 re-rank of candidate rows (nq, kk) (-1 = none) over
        coarse + pq + refine reconstructions (IndexIVFPQR::
        search_preassigned's second pass; reference :349-378)."""
        rows = rows.long()
        safe = rows.clamp(0, self._row_codes.shape[0] - 1)
        nq, kk = rows.shape
        rec = (PQ.pq_decode(self._row_codes[safe].view(-1, self.M),
                            self._cent)
               + PQ.pq_decode(self._row_refine[safe].view(-1, self.M_refine),
                              self._rcent)).view(nq, kk, self.d)
        if self._residual():
            rec = rec + self._coarse_centroids()[
                self._row_assign[safe].long()]
        xq = xq_dev.float()
        ip = torch.bmm(rec, xq[:, :, None])[:, :, 0]
        if self.is_similarity:
            sc = -ip
        else:
            sc = torch.clamp((xq * xq).sum(1, keepdim=True)
                             + (rec * rec).sum(2) - 2.0 * ip, min=0.0)
        sc = torch.where(rows >= 0, sc, float("inf"))
        out_d, out_i = TK.topk_with_ids(sc, rows, k)
        return (-out_d if self.is_similarity else out_d), out_i

    def _scan_probes(self, xq_dev: torch.Tensor, probes: torch.Tensor,
                     k: int, mnb: Optional[int] = None, id_mask=None):
        kk = min(int(k * max(self.k_factor, 1)), max(int(self.ntotal), k))
        Dv, Iv, ndis = super()._scan_probes(xq_dev, probes, kk, mnb, id_mask)
        Dv, Iv = self._rerank(xq_dev, Iv, k)
        return Dv, Iv, ndis


class IndexIVFScalarQuantizer(IndexIVF):
    """IVF with SQ-coded invlists (faiss IndexIVFScalarQuantizer). Codes
    are of the raw vectors, not of residuals, as the reference stores them.

    The 8-bit qtypes (QT_8BIT, QT_8BIT_UNIFORM, QT_8BIT_DIRECT,
    QT_8BIT_DIRECT_SIGNED) search through K3-SQ8; the others through the
    query-major `scan_invlists_sq`. ``search_stats`` times the scan that
    ``search`` serves: for the 8-bit qtypes that is K3-SQ8, where the
    reference times its query-major scan. ``update_vectors`` re-encodes
    through a repack, as the reference's does for coded storage."""

    def __init__(self, quantizer, d: int, nlist: int,
                 qtype: int = SQ.QT_8BIT, metric: int = D.METRIC_L2,
                 block_size: int = 128, *, device="cuda"):
        super().__init__(quantizer, d, nlist, metric, block_size,
                         device=device)
        self.qtype = int(qtype)
        self.sq: Optional[SQ.SQCodec] = None
        self._sq8: Optional[ivf_scan.PackedInvListsSQ8] = None
        self._sq8_for = None

    def train_encoder(self, x: np.ndarray) -> None:
        self.sq = SQ.train_sq(x, self.qtype)

    def _codec_or_default(self) -> SQ.SQCodec:
        return self.sq or SQ.SQCodec(qtype=self.qtype, d=self.d)

    def _pack(self, x, ids, assign) -> ivf_scan.PackedCodeInvLists:
        self._sq8 = self._sq8_for = None
        codes = torch.cat([
            SQ.sq_encode(self._to_device(x[i:i + _ENCODE_ROWS]), self.sq)
            for i in chunk_starts(len(x), _ENCODE_ROWS)])
        return ivf_scan.pack_code_invlists(codes, ids, assign, self.nlist,
                                           self.block_size,
                                           device=self.device)

    def _lists_changed(self) -> None:
        super()._lists_changed()
        # the SQ8 view shares the id plane that remove_ids edits in place;
        # point it at the current one all the same
        if self._sq8 is not None and self._sq8_for is self.invlists:
            self._sq8.ids = self.invlists.ids

    def _sq8_view(self) -> ivf_scan.PackedInvListsSQ8:
        """The SQ8 stream over the packed codes of an 8-bit qtype
        (zero-copy, cached against the invlists object) with the codec's
        dequant affine x = (vmin + 0.5 vdiff/2^8) + code * vdiff/2^8;
        direct codes are x = code (signed: code - 128)."""
        if self._sq8 is not None and self._sq8_for is self.invlists:
            return self._sq8
        d, dev = self.d, self.device
        if self.qtype == SQ.QT_8BIT_DIRECT:
            bias = torch.zeros(d, device=dev)
            scale = torch.ones(d, device=dev)
        elif self.qtype == SQ.QT_8BIT_DIRECT_SIGNED:
            bias = torch.full((d,), -128.0, device=dev)
            scale = torch.ones(d, device=dev)
        else:
            vmin, vdiff = SQ.codec_range(self.sq, dev)
            scale = (vdiff / 256.0).broadcast_to((d,))
            bias = vmin.broadcast_to((d,)) + 0.5 * scale
        self._sq8 = ivf_scan.sq8_view_from_codes(self.invlists, bias, scale)
        self._sq8_for = self.invlists
        return self._sq8

    def _fused(self) -> bool:
        return self.qtype in SQ.QT_8BIT_FAMILY

    def _ready(self) -> None:
        super()._ready()
        if self._fused():
            self._sq8_view()

    def _scan_probes(self, xq_dev: torch.Tensor, probes: torch.Tensor,
                     k: int, mnb: Optional[int] = None, id_mask=None):
        """K3-SQ8 for the 8-bit qtypes; `scan_invlists_sq` for the others,
        and for any qtype where the base class's rule picks the query-major
        scan (reference :486-513)."""
        if self._fused() and not self._query_major(mnb, id_mask):
            Dv, Iv, _ = scan_invlists_fused(xq_dev, probes, self._sq8_view(),
                                            k, self.metric_type)
            return Dv, Iv, None
        vmin, vdiff = SQ.codec_range(self._codec_or_default(), self.device)
        return ivf_scan.scan_invlists_sq(
            xq_dev, probes, self.invlists, vmin, vdiff, k, self.metric_type,
            qtype=self.qtype, max_nblocks=mnb or self._default_capped_mnb(),
            id_mask=id_mask)

    def _range_lists(self) -> ivf_scan.PackedInvLists:
        """The probed codes decoded through the codec (exact codec
        distances; reference :515-535)."""
        codec = self._codec_or_default()
        return ivf_scan.decode_code_invlists_generic(
            self.invlists, lambda codes: SQ.sq_decode(codes, codec), self.d)

    # --- standalone codec: list id, then the SQ codes of the raw vector;
    #     fp16 / bf16 codes are their raw bytes (reference :462-484) -------
    def _sa_payload_size(self) -> int:
        return self._codec_or_default().code_size

    def _sa_encode_payload(self, x, assign) -> np.ndarray:
        codes = SQ.sq_encode(self._to_device(np.asarray(x, np.float32)),
                             self.sq)
        return codes.contiguous().view(torch.uint8).cpu().numpy() \
            .reshape(len(x), -1)

    def _sa_decode_payload(self, payload, listno) -> np.ndarray:
        codec = self._codec_or_default()
        codes = torch.from_numpy(np.ascontiguousarray(payload)).to(
            self.device)
        if codec.qtype in (SQ.QT_FP16, SQ.QT_BF16):
            codes = codes.view(codec.code_dtype)
        return SQ.sq_decode(codes, codec).cpu().numpy()

    def reset(self) -> None:
        super().reset()
        self._sq8 = self._sq8_for = None


def make_ivf_pq(d: int, nlist: int, M: int, nbits: int = 8,
                metric: int = D.METRIC_L2, *, device="cuda") -> IndexIVFPQ:
    """IVF-PQ over a flat coarse quantizer (= factory "IVFx,PQMxN")."""
    from .flat import IndexFlat

    return IndexIVFPQ(IndexFlat(d, metric, device=device), d, nlist, M,
                      nbits, metric, device=device)
