"""IVF + codec indexes — PyTorch counterpart of `tpu_ann/models/ivf_pq.py`
(`IndexIVFScalarQuantizer` in faiss IndexScalarQuantizer.{h,cpp}).

Invlists store the codec's codes in the block-packed layout
(`ops.ivf_scan.PackedCodeInvLists`). The 8-bit qtypes search through the
fused scan's SQ8 stream: a zero-copy `PackedInvListsSQ8` view of the codes
with the codec's dequant affine, scanned by the hand-written kernel K3-SQ8
(one launch per search, no size gate, no fallback). The other qtypes
(4-bit, 6-bit, fp16, bf16), and every qtype under an IDSelector or an
explicit max_codes, take the query-major `scan_invlists_sq` (plain torch,
as the reference's is XLA). `IndexIVFPQ` waits for the PQ slice (ROADMAP
queue 1, item 5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import ivf_scan
from ..ops import sq as SQ
from ..ops.ivf_scan_fused import scan_invlists_fused
from .ivf import IndexIVF

# rows encoded per device call while packing
_ENCODE_ROWS = 1 << 18


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
            for i in range(0, len(x), _ENCODE_ROWS)])
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
