"""IVF + codec indexes — PyTorch counterpart of `tpu_ann/models/ivf_pq.py`
(`IndexIVFScalarQuantizer` in faiss IndexScalarQuantizer.{h,cpp}).

Invlists store the codec's codes in the block-packed layout
(`ops.ivf_scan.PackedCodeInvLists`). The 8-bit qtypes search through the
fused scan's SQ8 stream: a zero-copy `PackedInvListsSQ8` view of the codes
with the codec's dequant affine, scanned by the hand-written kernel K3-SQ8
(one launch per search, no size gate, no fallback). `IndexIVFPQ` waits for
the PQ slice (ROADMAP queue 1, item 10).
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
    QT_8BIT_DIRECT_SIGNED) search through K3-SQ8. The other qtypes (4-bit,
    6-bit, fp16, bf16) train, add and encode, but their search needs the
    query-major `scan_invlists_sq`, which is not ported yet: it raises
    NotImplementedError. ``search_stats`` times the same K3-SQ8 scan as
    ``search`` (the reference's times its query-major scan instead)."""

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

    def _pack(self, x, ids, assign) -> ivf_scan.PackedCodeInvLists:
        self._sq8 = self._sq8_for = None
        codes = torch.cat([
            SQ.sq_encode(self._to_device(x[i:i + _ENCODE_ROWS]), self.sq)
            for i in range(0, len(x), _ENCODE_ROWS)])
        return ivf_scan.pack_code_invlists(codes, ids, assign, self.nlist,
                                           self.block_size,
                                           device=self.device)

    def _sq8_view(self) -> ivf_scan.PackedInvListsSQ8:
        """The SQ8 stream over the packed codes (zero-copy, cached against
        the invlists object) with the codec's dequant affine
        x = (vmin + 0.5 vdiff/2^8) + code * vdiff/2^8; direct codes are
        x = code (signed: code - 128)."""
        if self.qtype not in SQ.QT_8BIT_FAMILY:
            raise NotImplementedError(
                f"IVF-SQ search with qtype {self.qtype} needs the "
                "query-major scan_invlists_sq, which is not ported yet; "
                "the 8-bit qtypes search through the fused scan")
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

    def _ready(self) -> None:
        super()._ready()
        self._sq8_view()

    def _scan_probes(self, xq_dev: torch.Tensor, probes: torch.Tensor,
                     k: int):
        Dv, Iv, _ = scan_invlists_fused(xq_dev, probes, self._sq8_view(), k,
                                        self.metric_type)
        return Dv, Iv

    def reset(self) -> None:
        super().reset()
        self._sq8 = self._sq8_for = None
