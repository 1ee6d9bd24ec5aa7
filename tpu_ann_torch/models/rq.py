"""Additive-quantizer indexes — PyTorch counterpart of
`tpu_ann/models/rq.py` (faiss `IndexAdditiveQuantizer.{h,cpp}`,
`IndexIVFAdditiveQuantizer.{h,cpp}`).

A code is M stage indices plus the f32 norm of its reconstruction
(ST_norm_float: M bytes, then 4). The flat classes search by the blocked
additive ADC scan (`ops.rq.rq_adc_scan`, plain torch, in query and row
blocks that bound its column gathers) and honour ``params.sel``; the
reference ignores selectors there.

The IVF classes put their codec in `_scan_probes`, so every entry point
scans it (search, search_stats, search_preassigned, the per-query stats,
selectors and max_codes); the reference overrides `search` only and its
other entry points fail on code lists. An 8-bit codec's lists are decoded
once into a cache, bf16 rows scanned by K3 or (``decoded_cache_dtype=
"sq8"``) the SQ8 stream scanned by K3-SQ8, dropped whenever the lists
change; without the cache they take the table scan
(`ops.rq.scan_invlists_rq`). Residuals against a quantizer with no
centroid table (an additive coarse quantizer) come from its decoded
centroids, as faiss's, so `IVF<n>(RCQ...),RQ...` trains where the
reference's `train_encoder` fails; `reconstruct` returns the decoded
vector, as faiss's does (the reference's returns the raw row).

`AdditiveCoarseQuantizer` is a virtual database of all ksub^M codeword
sums, ids in mixed radix (stage 0 most significant): its search is the
beam search to the k best centroids (`ops.rq.rq_encode_topk`), or an exact
product over all of them (at most 2^22, ``beam_factor < 0``), both on the
device (`search_device`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import ivf_scan
from ..ops import lsq as LSQ
from ..ops import rq as RQ
from ..ops import topk as TK
from ..ops.topk import chunk_starts
from .base import Index
from .ivf_pq import DecodedCacheIVF
from .pq import _sel_mask

# rows encoded a device call while packing an IVF
_ENCODE_ROWS = 1 << 18
# f32 elements of an ADC block (query rows x database rows)
_ADC_BUDGET = 1 << 26


def _aq_knn(xq: torch.Tensor, codes: torch.Tensor, norms: torch.Tensor,
            books: torch.Tensor, k: int, id_mask=None,
            db_block: int = 65536):
    """Blocked additive ADC k-NN over flat codes (reference `_rq_knn`,
    :27-55): query blocks of at most _ADC_BUDGET / db_block rows, each
    database block's distances merged into a running top-k (the earlier
    block wins a tie); rows an ``id_mask`` leaves out score +inf, and
    slots left at +inf get id -1."""
    nq = xq.shape[0]
    nb = codes.shape[0]
    dev = books.device
    xq = xq.float()
    lut = RQ.rq_query_tables(xq, books)
    qn = (xq * xq).sum(1)
    qb = max(1, _ADC_BUDGET // db_block)
    out_d, out_i = [], []
    for q0 in chunk_starts(nq, qb):
        q1 = min(q0 + qb, nq)
        bd = torch.full((q1 - q0, k), float("inf"), device=dev)
        bi = torch.full((q1 - q0, k), -1, dtype=torch.long, device=dev)
        for b0 in range(0, nb, db_block):
            b1 = min(b0 + db_block, nb)
            dis = RQ.rq_adc_scan(lut[q0:q1], codes[b0:b1], norms[b0:b1],
                                 qn[q0:q1])
            if id_mask is not None:
                dis = torch.where(id_mask[b0:b1] != 0, dis, float("inf"))
            ids = torch.arange(b0, b1, device=dev).expand(q1 - q0, -1)
            bd, bi = TK.merge_topk(bd, bi, dis, ids, k)
        out_d.append(bd)
        out_i.append(torch.where(torch.isfinite(bd), bi, -1))
    return torch.cat(out_d), torch.cat(out_i)


class IndexResidualQuantizer(Index):
    """faiss IndexResidualQuantizer(d, M, nbits): flat RQ codes and their
    norms on the device, additive ADC search (L2 only, as the
    reference)."""

    def __init__(self, d: int, M: int, nbits: int = 8,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, metric, device=device)
        if metric != D.METRIC_L2:
            raise ValueError("RQ search implemented for L2 (ST_norm_float)")
        self.M = int(M)
        self.nbits = int(nbits)
        self.beam_size = 5
        self.rq: Optional[RQ.RQCodec] = None
        self._books: Optional[torch.Tensor] = None
        self._codes: Optional[torch.Tensor] = None      # (n, M) uint8
        self._norms: Optional[torch.Tensor] = None      # (n,) f32
        self.is_trained = False
        self.verbose = False

    def _set_codec(self, codebooks) -> None:
        books = np.asarray(codebooks, np.float32)
        self.rq = RQ.RQCodec(codebooks=books, d=self.d, M=books.shape[0],
                             nbits=self.nbits)
        self.M = self.rq.M      # product AQs expand M to nsplits * Msub
        self._books = RQ.as_codebooks(books, self.device)
        self.is_trained = True

    def _train_codec(self, x: np.ndarray) -> RQ.RQCodec:
        return RQ.train_rq(x, self.M, self.nbits, verbose=self.verbose,
                           device=self.device)

    def _encode(self, x) -> torch.Tensor:
        return RQ.rq_encode(x, self._books, beam=self.beam_size)

    def train(self, x) -> None:
        self._set_codec(self._train_codec(self._check_input(x)).codebooks)

    def add(self, x) -> None:
        if not self.is_trained:
            raise RuntimeError("train() before add()")
        x = self._check_input(x)
        codes = self._encode(x)
        recon = RQ.rq_decode(codes, self._books)
        norms = (recon * recon).sum(1)
        if self._codes is None:
            self._codes, self._norms = codes, norms
        else:
            self._codes = torch.cat([self._codes, codes])
            self._norms = torch.cat([self._norms, norms])
        self.ntotal += len(x)

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        if self.ntotal == 0:
            return (np.full((len(x), k), np.inf, np.float32),
                    np.full((len(x), k), -1, np.int64))
        Dv, Iv = _aq_knn(self._to_device(x), self._codes, self._norms,
                         self._books, k,
                         _sel_mask(params, self.ntotal, self.device))
        return Dv.cpu().numpy(), Iv.cpu().numpy()

    def reset(self) -> None:
        self._codes = self._norms = None
        self.ntotal = 0

    def sa_code_size(self) -> int:
        return self.rq.code_size if self.rq is not None else self.M + 4

    def sa_encode(self, x) -> np.ndarray:
        """(n, d) -> (n, M + 4) uint8: the stage codes, then the
        reconstruction's norm as f32 bytes."""
        codes = self._encode(self._check_input(x))
        return RQ.with_norms(codes, RQ.rq_decode(codes, self._books)) \
            .cpu().numpy()

    def sa_decode(self, codes) -> np.ndarray:
        codes = torch.from_numpy(np.ascontiguousarray(codes, np.uint8))
        return RQ.rq_decode(codes[:, :self.M], self._books).cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        if not 0 <= key < self.ntotal:
            raise KeyError(key)
        return RQ.rq_decode(self._codes[key:key + 1], self._books)[0] \
            .cpu().numpy()

    def range_search(self, x, radius: float):
        """The exact distance to the decoded rows, block by block (faiss
        IndexFlatCodes::range_search, IndexFlatCodes.h:65)."""
        from ..ops.range_search import range_search_decoded

        x = self._check_input(x)
        if self.ntotal == 0:
            return (np.zeros(len(x) + 1, np.int64), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        res = range_search_decoded(
            x, lambda i0, i1: RQ.rq_decode(self._codes[i0:i1], self._books),
            self.ntotal, radius, self.metric_type)
        return res.lims, res.distances, res.labels


IndexAdditiveQuantizer = IndexResidualQuantizer     # the family's alias


class _LSQParams:
    """The LSQ knobs (LocalSearchQuantizer.h:48-59) and the encode's
    perturbation stream: each encode draws from a generator seeded with a
    counter, as the reference keys each encode."""

    def _lsq_init(self) -> None:
        self.train_iters = 8
        self.icm_iters = 4
        self.nperts = 4
        self.lambd = 1e-2
        self._enc_seed = 0

    def _lsq_params(self) -> dict:
        return dict(train_iters=self.train_iters, icm_iters=self.icm_iters,
                    nperts=self.nperts, lambd=self.lambd)

    def _lsq_encode(self, x) -> torch.Tensor:
        self._enc_seed += 1
        gen = torch.Generator(device=self._books.device)
        gen.manual_seed(self._enc_seed)
        return LSQ.lsq_encode(x, self._books, gen, icm_iters=self.icm_iters,
                              nperts=self.nperts)


class IndexLocalSearchQuantizer(_LSQParams, IndexResidualQuantizer):
    """faiss IndexLocalSearchQuantizer: additive codes encoded by the ICM
    encode of `ops.lsq`, searched by the shared additive ADC scan."""

    def __init__(self, d: int, M: int, nbits: int = 8,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, M, nbits, metric, device=device)
        self._lsq_init()

    def _train_codec(self, x: np.ndarray) -> RQ.RQCodec:
        return LSQ.train_lsq(x, self.M, self.nbits, verbose=self.verbose,
                             device=self.device, **self._lsq_params())

    def _encode(self, x) -> torch.Tensor:
        return self._lsq_encode(x)


class IndexProductResidualQuantizer(IndexResidualQuantizer):
    """faiss IndexProductResidualQuantizer: d split into nsplits slices,
    each coded by its own RQ, kept as one additive codec of block-diagonal
    codebooks so every scan is shared."""

    _paq_kind = "rq"

    def __init__(self, d: int, nsplits: int, Msub: int, nbits: int = 8,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, nsplits * Msub, nbits, metric, device=device)
        self.nsplits = int(nsplits)
        self.Msub = int(Msub)

    def _train_codec(self, x: np.ndarray) -> RQ.RQCodec:
        extra = self._lsq_params() if self._paq_kind == "lsq" else {}
        return LSQ.train_product_aq(x, self.nsplits, self.Msub, self.nbits,
                                    kind=self._paq_kind,
                                    verbose=self.verbose,
                                    device=self.device, **extra)


class IndexProductLocalSearchQuantizer(_LSQParams,
                                       IndexProductResidualQuantizer):
    """faiss IndexProductLocalSearchQuantizer: a product of LSQs. The
    splits are encoded by the beam search of the block-diagonal codec, as
    the reference's are."""

    _paq_kind = "lsq"

    def __init__(self, d: int, nsplits: int, Msub: int, nbits: int = 8,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, nsplits, Msub, nbits, metric, device=device)
        self._lsq_init()


# ---------------------------------------------------------------------------
# IVF
# ---------------------------------------------------------------------------

class IndexIVFResidualQuantizer(DecodedCacheIVF):
    """faiss IndexIVFResidualQuantizer: the lists hold RQ codes of the
    residuals x - c(list) and the f32 norm of the full reconstruction;
    the decoded cache of `DecodedCacheIVF` ("bfloat16", "float32" or
    "sq8"), the table scan `ops.rq.scan_invlists_rq` without it."""

    def __init__(self, quantizer, d: int, nlist: int, M: int,
                 nbits: int = 8, metric: int = D.METRIC_L2,
                 block_size: int = 128, *, device="cuda"):
        super().__init__(quantizer, d, nlist, metric, block_size,
                         device=device)
        if metric != D.METRIC_L2:
            raise ValueError("RQ search implemented for L2 (ST_norm_float)")
        self.M = int(M)
        self.nbits = int(nbits)
        self.beam_size = 5
        self.rq: Optional[RQ.RQCodec] = None
        self._books: Optional[torch.Tensor] = None
        self._cache_init()
        self.verbose = False

    _set_codec = IndexResidualQuantizer._set_codec

    def _train_codec(self, resid: np.ndarray) -> RQ.RQCodec:
        return RQ.train_rq(resid, self.M, self.nbits, verbose=self.verbose,
                           device=self.device)

    def _encode_residuals(self, resid: torch.Tensor) -> torch.Tensor:
        return RQ.rq_encode(resid, self._books, beam=self.beam_size)

    def _coarse_of(self, assign) -> torch.Tensor:
        """The f32 centroids of lists ``assign`` (host ints): the table's
        rows, or a virtual quantizer's decoded centroids."""
        a = torch.as_tensor(np.asarray(assign, np.int64)).to(self.device)
        return self._coarse_centroids()[a]

    def train_encoder(self, x: np.ndarray) -> None:
        """The codec on the residuals of the training rows (reference
        :278-283)."""
        resid = self._to_device(x) - self._coarse_of(self._assign(x))
        self._set_codec(self._train_codec(resid.cpu().numpy()).codebooks)

    def _payload(self, x, assign) -> torch.Tensor:
        """(n, M + 4) uint8 device rows: the residual codes, then the norm
        of the full reconstruction (decoded residual + centroid)."""
        outs = []
        for i in chunk_starts(len(x), _ENCODE_ROWS):
            cent = self._coarse_of(assign[i:i + _ENCODE_ROWS])
            codes = self._encode_residuals(
                self._to_device(np.asarray(x[i:i + _ENCODE_ROWS],
                                           np.float32)) - cent)
            outs.append(RQ.with_norms(
                codes, RQ.rq_decode(codes, self._books) + cent))
        return torch.cat(outs)

    def _pack(self, x, ids, assign) -> ivf_scan.PackedCodeInvLists:
        return ivf_scan.pack_code_invlists(self._payload(x, assign), ids,
                                           assign, self.nlist,
                                           self.block_size,
                                           device=self.device)

    # --- the decoded cache and the table scan -----------------------------
    def _decode_lists(self, dtype) -> ivf_scan.PackedInvLists:
        M, books = self.M, self._books
        return ivf_scan.decode_code_invlists_generic(
            self.invlists, lambda p: RQ.rq_decode(p[:, :M], books), self.d,
            self._coarse_centroids(), dtype=dtype)

    def _table_scan(self, xq_dev, probes, k, mnb, id_mask):
        """The table scan (reference :325-361, `_ivf_rq_search`)."""
        return RQ.scan_invlists_rq(xq_dev, probes, self.invlists,
                                   self._books, self._coarse_centroids(), k,
                                   max_nblocks=mnb, id_mask=id_mask)

    def _range_lists(self) -> ivf_scan.PackedInvLists:
        """The probed codes decoded to f32 rows: exact codec distances."""
        return self._decode_lists(torch.float32)

    # --- standalone codec: list id, then the residual's stage bytes and
    #     the reconstruction's f32 norm ------------------------------------
    def _sa_payload_size(self) -> int:
        return self.rq.code_size if self.rq is not None else self.M + 4

    def _sa_encode_payload(self, x, assign) -> np.ndarray:
        return self._payload(np.asarray(x, np.float32),
                             np.asarray(assign)).cpu().numpy()

    def _sa_decode_payload(self, payload, listno) -> np.ndarray:
        codes = torch.from_numpy(np.ascontiguousarray(payload[:, :self.M]))
        return (RQ.rq_decode(codes, self._books)
                + self._coarse_of(listno)).cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        """The decoded vector of user id ``key`` (its code in the lists
        plus its list's centroid), as faiss's; an absent or removed id
        raises KeyError."""
        self._maybe_repack()
        rows = np.nonzero(self._ids_flat == key)[0] \
            if self._ids_flat is not None else []
        il = self.invlists
        for row in rows:
            flat = il.ids.view(-1)
            slot = torch.nonzero(flat == int(row))
            if len(slot):
                slot = int(slot[0, 0])
                blk = slot // self.block_size
                lbs = il.list_block_start.long()
                lst = torch.nonzero((lbs <= blk) & (
                    blk < lbs + il.list_nblocks.long()))[0, 0]
                payload = il.codes.view(-1, il.codes.shape[-1])[slot]
                return self._sa_decode_payload(
                    payload[None].cpu().numpy(), [int(lst)])[0]
        raise KeyError(key)


class IndexIVFLocalSearchQuantizer(_LSQParams, IndexIVFResidualQuantizer):
    """faiss IndexIVFLocalSearchQuantizer: IVF with ICM-encoded additive
    codes of the residuals."""

    def __init__(self, quantizer, d: int, nlist: int, M: int,
                 nbits: int = 8, metric: int = D.METRIC_L2,
                 block_size: int = 128, *, device="cuda"):
        super().__init__(quantizer, d, nlist, M, nbits, metric, block_size,
                         device=device)
        self._lsq_init()

    def _train_codec(self, resid: np.ndarray) -> RQ.RQCodec:
        return LSQ.train_lsq(resid, self.M, self.nbits, verbose=self.verbose,
                             device=self.device, **self._lsq_params())

    def _encode_residuals(self, resid: torch.Tensor) -> torch.Tensor:
        return self._lsq_encode(resid)


class IndexIVFProductResidualQuantizer(IndexIVFResidualQuantizer):
    """faiss IndexIVFProductResidualQuantizer: the block-diagonal additive
    codec over d / nsplits slices; the scans are IVF-RQ's."""

    _paq_kind = "rq"

    def __init__(self, quantizer, d: int, nlist: int, nsplits: int,
                 Msub: int, nbits: int = 8, metric: int = D.METRIC_L2,
                 block_size: int = 128, *, device="cuda"):
        super().__init__(quantizer, d, nlist, nsplits * Msub, nbits, metric,
                         block_size, device=device)
        self.nsplits = int(nsplits)
        self.Msub = int(Msub)

    _train_codec = IndexProductResidualQuantizer._train_codec


class IndexIVFProductLocalSearchQuantizer(_LSQParams,
                                          IndexIVFProductResidualQuantizer):
    """faiss IndexIVFProductLocalSearchQuantizer."""

    _paq_kind = "lsq"

    def __init__(self, quantizer, d: int, nlist: int, nsplits: int,
                 Msub: int, nbits: int = 8, metric: int = D.METRIC_L2,
                 block_size: int = 128, *, device="cuda"):
        super().__init__(quantizer, d, nlist, nsplits, Msub, nbits, metric,
                         block_size, device=device)
        self._lsq_init()


# ---------------------------------------------------------------------------
# additive coarse quantizers
# ---------------------------------------------------------------------------

# f32 elements of the beam's error table a chunk of rows
_BEAM_BUDGET = 1 << 28


class AdditiveCoarseQuantizer(Index):
    """An additive quantizer as a coarse quantizer
    (IndexAdditiveQuantizer.h:150-193): its database is the implicit set
    of all ksub^M codeword sums, nothing is added, ntotal = ksub^M after
    training. search returns mixed-radix centroid ids; reconstruct decodes
    an id. Lets an IVF reach a huge nlist with M codebooks of memory."""

    def __init__(self, d: int, M: int, nbits: int,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        if metric != D.METRIC_L2:
            raise ValueError("additive coarse quantizers are L2-only")
        super().__init__(d, metric, device=device)
        self.M, self.nbits = int(M), int(nbits)
        self.ksub = 1 << self.nbits
        self.beam_factor: float = 4.0
        self.rq: Optional[RQ.RQCodec] = None
        self._books: Optional[torch.Tensor] = None
        self._cents: Optional[torch.Tensor] = None
        self.is_trained = False
        self.verbose = False

    def _train_codec(self, x) -> RQ.RQCodec:
        raise NotImplementedError

    def set_codebooks(self, codebooks) -> None:
        """Install trained codebooks (M, ksub, d)."""
        books = np.asarray(codebooks, np.float32)
        self.rq = RQ.RQCodec(codebooks=books, d=self.d, M=self.M,
                             nbits=self.nbits)
        self._books = RQ.as_codebooks(books, self.device)
        self._cents = None
        self.ntotal = self.ksub ** self.M
        self.is_trained = True

    def train(self, x) -> None:
        self.set_codebooks(self._train_codec(self._check_input(x))
                           .codebooks)

    # --- ids <-> stage codes (mixed radix, stage 0 most significant) ------
    def _codes_to_ids(self, codes: torch.Tensor) -> torch.Tensor:
        ids = torch.zeros(codes.shape[:-1], dtype=torch.long,
                          device=codes.device)
        for m in range(self.M):
            ids = ids * self.ksub + codes[..., m].long()
        return ids

    def _ids_to_codes(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        codes = torch.zeros(ids.shape + (self.M,), dtype=torch.uint8,
                            device=ids.device)
        for m in range(self.M - 1, -1, -1):
            codes[..., m] = (ids % self.ksub).to(torch.uint8)
            ids = ids // self.ksub
        return codes

    def add(self, x) -> None:
        raise RuntimeError(
            "AdditiveCoarseQuantizer is a virtual database: nothing to add "
            "(reconstruct / search only)")

    def reset(self) -> None:
        pass

    def reconstruct_device(self, keys: torch.Tensor) -> torch.Tensor:
        """(n,) centroid ids on the device -> (n, d) f32 centroids."""
        return RQ.rq_decode(self._ids_to_codes(keys.to(self.device)),
                            self._books)

    def reconstruct(self, key: int) -> np.ndarray:
        return self.reconstruct_batch(np.array([key]))[0]

    def reconstruct_batch(self, keys) -> np.ndarray:
        keys = torch.as_tensor(np.asarray(keys, np.int64).reshape(-1))
        return self.reconstruct_device(keys).cpu().numpy()

    def _all_centroids(self) -> torch.Tensor:
        """Every centroid, enumerated once and kept (at most 2^22)."""
        if self.ntotal > (1 << 22):
            raise ValueError(
                f"exact centroid enumeration of {self.ntotal} is too large; "
                "use beam search (beam_factor >= 0)")
        if self._cents is None:
            self._cents = self.reconstruct_device(
                torch.arange(self.ntotal, device=self.device))
        return self._cents

    def search_device(self, xq_dev: torch.Tensor, k: int, *, params=None):
        """The k nearest implicit centroids of device queries: beam search
        with beam max(beam_factor * k, k) (ResidualCoarseQuantizer::search),
        or for ``beam_factor < 0`` the exact product over every centroid.
        Returns (D (nq, k) f32 L2^2, I (nq, k) int64), (inf, -1) past the
        candidates the beam holds."""
        if not self.is_trained:
            raise RuntimeError("train() first")
        xq = xq_dev.to(self.device).float()
        if self.beam_factor < 0:
            return D.knn(xq, self._all_centroids(), k)
        beam = max(int(self.beam_factor * k), k)
        chunk = max(1, min(RQ.ENCODE_ROWS,
                           _BEAM_BUDGET // (beam * self.ksub)))
        errs, codes = RQ.rq_encode_topk(xq, self._books, k, beam,
                                        chunk=chunk)
        Dv = torch.clamp(errs, min=0.0)
        Iv = self._codes_to_ids(codes)
        if Dv.shape[1] < k:       # a beam narrower than k (tiny codebooks)
            pad = k - Dv.shape[1]
            Dv = torch.cat([Dv, Dv.new_full((len(Dv), pad), float("inf"))],
                           1)
            Iv = torch.cat([Iv, Iv.new_full((len(Iv), pad), -1)], 1)
        return Dv, Iv

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        Dv, Iv = self.search_device(self._to_device(x), k)
        return Dv.cpu().numpy(), Iv.cpu().numpy()

    def set_beam_factor(self, bf: float) -> None:
        self.beam_factor = float(bf)


class ResidualCoarseQuantizer(AdditiveCoarseQuantizer):
    """An RQ-trained coarse quantizer (IndexAdditiveQuantizer.h:198)."""

    def _train_codec(self, x) -> RQ.RQCodec:
        return RQ.train_rq(x, self.M, self.nbits, verbose=self.verbose,
                           device=self.device)


class LocalSearchCoarseQuantizer(AdditiveCoarseQuantizer):
    """An LSQ-trained coarse quantizer (IndexAdditiveQuantizer.h:241). LSQ
    codebooks are not residual-hierarchical, so its search defaults to
    the exact enumeration."""

    def __init__(self, d: int, M: int, nbits: int,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, M, nbits, metric, device=device)
        self.beam_factor = -1.0

    def _train_codec(self, x) -> RQ.RQCodec:
        return LSQ.train_lsq(x, self.M, self.nbits, verbose=self.verbose,
                             device=self.device)
