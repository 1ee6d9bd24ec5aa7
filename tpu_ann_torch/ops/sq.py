"""Scalar quantization — PyTorch counterpart of `tpu_ann/ops/sq.py` (faiss
`impl/ScalarQuantizer.{h,cpp}`: QT_8bit / QT_4bit / QT_6bit, uniform and
per-dim trained, QT_fp16 / QT_bf16 / QT_8bit_direct codecs, RangeStat
training modes).

Codecs are plain encode / decode functions on torch tensors, with the
reference's arithmetic step for step, so both packages give byte-equal
codes on the same input:

  QT_4bit  — two dims per byte (Codec4bit), low nibble first
  QT_6bit  — four dims per three bytes (Codec6bit bit packing)
  QT_8bit  — one byte per dim
  fp16/bf16 — two bytes per dim

The 8-bit stream of the IVF scan (``PackedInvListsSQ8`` in
`ops.ivf_scan`) keeps these codes as they are and folds the dequant affine
into the queries. The reference's ``AlignedByteTier`` (a workaround for an
XLA relayout copy on the TPU) is not ported: a plain row gather replaces
it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Quantizer types (faiss ScalarQuantizer::QuantizerType,
# impl/ScalarQuantizer.h:27-38)
QT_8BIT = 0          # per-dim trained min/range
QT_8BIT_UNIFORM = 1  # single min/range over all dims
QT_FP16 = 2
QT_BF16 = 3
QT_4BIT = 4
QT_4BIT_UNIFORM = 5
QT_6BIT = 6
QT_8BIT_DIRECT = 7          # codes stored as-is (data already uint8)
QT_8BIT_DIRECT_SIGNED = 8   # decode = code - 128

# RangeStat (impl/ScalarQuantizer.h RangeStat): how train() derives ranges
RS_MINMAX = 0     # [min, max] of the training data
RS_MEANSTD = 1    # mean ± rs_arg * std
RS_QUANTILES = 2  # rs_arg/1-rs_arg quantiles

_NBITS = {QT_8BIT: 8, QT_8BIT_UNIFORM: 8, QT_4BIT: 4, QT_4BIT_UNIFORM: 4,
          QT_6BIT: 6}
# qtypes whose codes are one byte per dim (the uint8 stream of the IVF scan)
QT_8BIT_FAMILY = (QT_8BIT, QT_8BIT_UNIFORM, QT_8BIT_DIRECT,
                  QT_8BIT_DIRECT_SIGNED)
# qtypes that need no training
QT_UNTRAINED = (QT_FP16, QT_BF16, QT_8BIT_DIRECT, QT_8BIT_DIRECT_SIGNED)


@dataclasses.dataclass
class SQCodec:
    qtype: int
    d: int
    vmin: Optional[np.ndarray] = None    # (d,) f32, None for untrained types
    vdiff: Optional[np.ndarray] = None

    @property
    def code_size(self) -> int:
        if self.qtype in (QT_4BIT, QT_4BIT_UNIFORM):
            return (self.d + 1) // 2
        if self.qtype == QT_6BIT:
            return (self.d * 6 + 7) // 8
        if self.qtype in (QT_FP16, QT_BF16):
            return 2 * self.d
        return self.d  # 8-bit family

    @property
    def code_dtype(self) -> torch.dtype:
        if self.qtype == QT_FP16:
            return torch.float16
        if self.qtype == QT_BF16:
            return torch.bfloat16
        return torch.uint8


def train_sq(x: np.ndarray, qtype: int, rs_arg: float = 0.0,
             rangestat: int = RS_MINMAX) -> SQCodec:
    """Train ranges (ScalarQuantizer::train, train_Uniform/NonUniform) on
    the host. rangestat selects how the [vmin, vmax] window is derived;
    rs_arg is the std multiplier (RS_meanstd, default 3) or quantile
    (RS_quantiles, default 0.01)."""
    x = np.ascontiguousarray(x, np.float32)
    d = x.shape[1]
    if qtype in QT_UNTRAINED:
        return SQCodec(qtype=qtype, d=d)
    uniform = qtype in (QT_8BIT_UNIFORM, QT_4BIT_UNIFORM)
    xs = x.reshape(-1, 1) if uniform else x
    if rangestat == RS_MEANSTD:
        arg = rs_arg or 3.0
        mean, std = xs.mean(axis=0), xs.std(axis=0)
        vmin, vmax = mean - arg * std, mean + arg * std
    elif rangestat == RS_QUANTILES:
        arg = rs_arg or 0.01
        vmin = np.quantile(xs, arg, axis=0)
        vmax = np.quantile(xs, 1.0 - arg, axis=0)
    else:
        vmin, vmax = xs.min(axis=0), xs.max(axis=0)
    if uniform:
        vmin = np.full(d, vmin[0], np.float32)
        vmax = np.full(d, vmax[0], np.float32)
    vdiff = np.maximum(vmax - vmin, 1e-12).astype(np.float32)
    return SQCodec(qtype=qtype, d=d, vmin=vmin.astype(np.float32),
                   vdiff=vdiff)


# --- bit packing -----------------------------------------------------------

def _pad_last(q: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return q
    return torch.cat([q, q.new_zeros(q.shape[:-1] + (pad,))], dim=-1)


def pack_4bit(q: torch.Tensor) -> torch.Tensor:
    """(..., d) values < 16 -> (..., ceil(d/2)) bytes, low nibble first."""
    q = _pad_last(q.to(torch.uint8), q.shape[-1] % 2)
    q = q.reshape(q.shape[:-1] + (q.shape[-1] // 2, 2))
    return q[..., 0] | (q[..., 1] << 4)


def unpack_4bit(b: torch.Tensor, d: int) -> torch.Tensor:
    lo = b & 0x0F
    hi = b >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(b.shape[:-1] + (-1,))
    return out[..., :d]


def pack_6bit(q: torch.Tensor) -> torch.Tensor:
    """(..., d) values < 64 -> (..., 3 ceil(d/4)) bytes (Codec6bit layout:
    4 values per 3 bytes, little-endian bit stream)."""
    q = _pad_last(q.to(torch.int32), (-q.shape[-1]) % 4)
    q = q.reshape(q.shape[:-1] + (-1, 4))
    v0, v1, v2, v3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    b0 = (v0 | (v1 << 6)) & 0xFF
    b1 = ((v1 >> 2) | (v2 << 4)) & 0xFF
    b2 = ((v2 >> 4) | (v3 << 2)) & 0xFF
    out = torch.stack([b0, b1, b2], dim=-1).to(torch.uint8)
    return out.reshape(out.shape[:-2] + (-1,))


def unpack_6bit(b: torch.Tensor, d: int) -> torch.Tensor:
    g = b.reshape(b.shape[:-1] + (-1, 3)).to(torch.int32)
    b0, b1, b2 = g[..., 0], g[..., 1], g[..., 2]
    v0 = b0 & 0x3F
    v1 = ((b0 >> 6) | (b1 << 2)) & 0x3F
    v2 = ((b1 >> 4) | (b2 << 4)) & 0x3F
    v3 = (b2 >> 2) & 0x3F
    out = torch.stack([v0, v1, v2, v3], dim=-1).to(torch.uint8)
    return out.reshape(out.shape[:-2] + (-1,))[..., :d]


# --- encode / decode --------------------------------------------------------

def codec_range(codec: SQCodec, device):
    """The codec's (vmin, vdiff) as f32 tensors on ``device`` (0 and 1 for
    untrained qtypes)."""
    vmin = (np.zeros(codec.d, np.float32) if codec.vmin is None
            else codec.vmin)
    vdiff = (np.ones(codec.d, np.float32) if codec.vdiff is None
             else codec.vdiff)
    return (torch.as_tensor(np.asarray(vmin, np.float32), device=device),
            torch.as_tensor(np.asarray(vdiff, np.float32), device=device))


def sq_encode(x: torch.Tensor, codec: SQCodec) -> torch.Tensor:
    """(n, d) vectors -> (n, code width) codes in ``codec.code_dtype``, on
    x's device. ``torch.round`` rounds half to even, as ``jnp.round``."""
    x = x.float()
    qt = codec.qtype
    if qt == QT_FP16:
        return x.to(torch.float16)
    if qt == QT_BF16:
        return x.to(torch.bfloat16)
    if qt == QT_8BIT_DIRECT:
        return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
    if qt == QT_8BIT_DIRECT_SIGNED:
        return torch.clamp(torch.round(x) + 128, 0, 255).to(torch.uint8)
    levels = (1 << _NBITS[qt]) - 1
    vmin, vdiff = codec_range(codec, x.device)
    q = torch.clamp((x - vmin) / vdiff, 0.0, 1.0)
    q = torch.round(q * levels).to(torch.uint8)
    if qt in (QT_4BIT, QT_4BIT_UNIFORM):
        return pack_4bit(q)
    if qt == QT_6BIT:
        return pack_6bit(q)
    return q


def sq_dequant_codes(codes: torch.Tensor, qtype: int, d: int,
                     vmin: torch.Tensor, vdiff: torch.Tensor) -> torch.Tensor:
    """Dequantize packed codes (any leading shape) -> float32 (..., d).
    Reference decode is (code + 0.5) / 2^bits * vdiff + vmin
    (Codec*::decode_component)."""
    if qtype in (QT_FP16, QT_BF16, QT_8BIT_DIRECT):
        return codes.float()
    if qtype == QT_8BIT_DIRECT_SIGNED:
        return codes.float() - 128.0
    if qtype in (QT_4BIT, QT_4BIT_UNIFORM):
        q = unpack_4bit(codes, d)
        scale = 16.0
    elif qtype == QT_6BIT:
        q = unpack_6bit(codes, d)
        scale = 64.0
    else:
        q = codes
        scale = 256.0
    return vmin + (q.float() + 0.5) / scale * vdiff


def sq_decode(codes: torch.Tensor, codec: SQCodec) -> torch.Tensor:
    vmin, vdiff = codec_range(codec, codes.device)
    return sq_dequant_codes(codes, codec.qtype, codec.d, vmin, vdiff)
