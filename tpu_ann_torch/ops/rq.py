"""Residual (additive) quantization — PyTorch counterpart of
`tpu_ann/ops/rq.py` (faiss `impl/AdditiveQuantizer.{h,cpp}`,
`impl/ResidualQuantizer.{h,cpp}`, `impl/residual_quantizer_encode_steps.cpp`).

A vector is coded as a SUM of M full-dimensional codebook entries, one a
stage. Training is stage-wise k-means on the running residuals
(`ops.kmeans`, the reference's seed and sample cap); encoding is the
reference's beam search, one batched (n, beam, ksub) error table a stage
and a stable top-beam (the lower position wins a tie, as ``lax.top_k``).
The encode runs in row chunks: at 1M rows the beam's table alone would be
5 GB.

Search uses ST_norm_float: the inner product with the query decomposes
into a per-query (M, ksub) table, summed over a code's stages, and the
stored norm of the reconstruction completes the L2 distance
(AdditiveQuantizer.h search_type). Every product here is f32 with TF32 off
(`ops.distances` sets it), what the reference computes on the CPU; its
``Precision.DEFAULT`` einsums are bf16 on a TPU, which the port does not
copy. `scan_invlists_rq` is the IVF table scan (the reference's
`_ivf_rq_search`) on the port's query-major loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import distances as D
from . import ivf_scan
from . import pq as PQ
from . import topk as TK
from .kmeans import ClusteringParameters, kmeans

# rows a chunk of the beam encode: (chunk, beam, ksub) f32 errors and
# (chunk, beam, d) residuals stay a few hundred MB at beam 5, ksub 256
ENCODE_ROWS = 1 << 16


@dataclasses.dataclass
class RQCodec:
    """Trained additive quantizer: codebooks (M, ksub, d) float32 (a numpy
    array, full-dimensional, unlike PQ's subspaces)."""

    codebooks: np.ndarray
    d: int
    M: int
    nbits: int

    @property
    def ksub(self) -> int:
        return 1 << self.nbits

    @property
    def code_size(self) -> int:
        return self.M + 4   # M uint8 stage codes + the f32 norm


def as_codebooks(codebooks, device) -> torch.Tensor:
    return torch.tensor(np.asarray(codebooks, np.float32), device=device)


def train_rq(x: np.ndarray, M: int, nbits: int = 8, *, niter: int = 15,
             seed: int = 1234, verbose: bool = False,
             device="cuda") -> RQCodec:
    """Stage-wise residual k-means (ResidualQuantizer::train; reference
    :50-75): each stage clusters the residuals left by the stages before,
    each row takes its nearest codeword."""
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    ksub = 1 << nbits
    if n < ksub:
        raise ValueError(f"need >= {ksub} training points, got {n}")
    cp = ClusteringParameters(niter=niter, seed=seed,
                              max_points_per_centroid=256)
    books = np.zeros((M, ksub, d), np.float32)
    resid = torch.from_numpy(x.copy()).to(device)
    for m in range(M):
        books[m], _ = kmeans(resid.cpu().numpy(), ksub, cp, device=device)
        cb = torch.from_numpy(books[m]).to(device)
        _, a = D.knn(resid, cb, 1)
        resid = resid - cb[a[:, 0]]
        if verbose:
            print(f"rq train stage {m + 1}/{M}: "
                  f"residual var {float(resid.var()):.4g}")
    return RQCodec(codebooks=books, d=d, M=M, nbits=nbits)


def _beam(x: torch.Tensor, books: torch.Tensor, beam: int):
    """The beam search of one chunk (beam_search_encode_step): each stage
    scores every (candidate, codeword) extension by the new residual's
    energy ||r||^2 - 2 <r, c> + ||c||^2 and keeps the ``beam`` best.
    Returns (errs (n, kept), codes (n, kept, M) uint8), best first."""
    n, d = x.shape
    M, ksub, _ = books.shape
    resid = x.float()[:, None, :]
    codes = torch.zeros((n, 1, M), dtype=torch.uint8, device=x.device)
    cn = (books * books).sum(2)
    rows = torch.arange(n, device=x.device)[:, None]
    errs = None
    for m in range(M):
        cb = books[m]
        ip = torch.matmul(resid, cb.T)                       # (n, b, ksub)
        rn = (resid * resid).sum(2)
        err = rn[:, :, None] - 2.0 * ip + cn[m][None, None, :]
        b = err.shape[1]
        keep = min(beam, b * ksub)
        errs, pos = TK.topk(err.reshape(n, b * ksub), keep)
        src_b, src_k = pos // ksub, pos % ksub
        resid = resid[rows, src_b] - cb[src_k]
        codes = codes[rows, src_b]
        codes[:, :, m] = src_k.to(torch.uint8)
    return errs, codes


def _chunked(x, books: torch.Tensor, fn, rows: int):
    """fn over row chunks of x (numpy or tensor) moved to the codebooks'
    device; outputs concatenated."""
    dev = books.device
    outs = []
    for i in TK.chunk_starts(len(x), rows):
        xi = x[i:i + rows]
        xi = xi.to(dev) if isinstance(xi, torch.Tensor) else \
            torch.from_numpy(np.array(xi, np.float32)).to(dev)
        outs.append(fn(xi))
    return outs


def rq_encode(x, books: torch.Tensor, beam: int = 5,
              chunk: int = ENCODE_ROWS) -> torch.Tensor:
    """Beam-search encode (reference :78-111): (n, d) -> (n, M) uint8, the
    best candidate's codes, in chunks of ``chunk`` rows."""
    outs = _chunked(x, books, lambda xi: _beam(xi, books, beam)[1][:, 0],
                    chunk)
    return torch.cat(outs) if outs else torch.zeros(
        (0, books.shape[0]), dtype=torch.uint8, device=books.device)


def rq_encode_topk(x, books: torch.Tensor, k: int, beam: int,
                   chunk: int = ENCODE_ROWS):
    """The k nearest implicit centroids by beam search (the
    ResidualCoarseQuantizer search primitive, reference :114-150): the same
    stage loop with beam >= k, returning (errs (n, kk) f32 residual
    energies, the L2^2 to each centroid; codes (n, kk, M) uint8), kk =
    min(k, candidates the last stage kept)."""
    beam = max(int(beam), int(k))
    outs = _chunked(x, books, lambda xi: _beam(xi, books, beam), chunk)
    errs = torch.cat([o[0] for o in outs])
    codes = torch.cat([o[1] for o in outs])
    kk = min(int(k), codes.shape[1])
    return errs[:, :kk], codes[:, :kk]


def rq_decode(codes: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """(n, M) codes -> (n, d) f32: the sum of the stages' codewords, added
    stage by stage in order as the reference does."""
    out = torch.zeros((codes.shape[0], books.shape[2]), dtype=torch.float32,
                      device=books.device)
    codes = codes.to(books.device).long()
    for m in range(books.shape[0]):
        out = out + books[m][codes[:, m]]
    return out


def rq_query_tables(xq: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """(nq, M, ksub) inner products <q, c_mk>, the additive ADC table."""
    M, ksub, d = books.shape
    return (xq.float() @ books.reshape(M * ksub, d).T).reshape(-1, M, ksub)


def rq_adc_scan(lut: torch.Tensor, codes: torch.Tensor, norms: torch.Tensor,
                qn: torch.Tensor) -> torch.Tensor:
    """L2 by ST_norm_float (reference :164-187): ||q - y||^2 = ||q||^2 +
    ||y||^2 - 2 sum_m <q, c_m,code_m>, the sum PQ's `adc_scan_db` (one
    column gather a stage, no (nq, C, M) tensor). lut (nq, M, ksub), codes
    (C, M), norms (C,), qn (nq,) -> (nq, C)."""
    return qn[:, None] + norms[None, :] - 2.0 * PQ.adc_scan_db(lut, codes)


def split_payload(payload: torch.Tensor, M: int):
    """An invlist payload row (M stage bytes, then the f32 norm as 4
    little-endian bytes) -> (codes (..., M) uint8, norms (...) f32)."""
    norms = payload[..., M:M + 4].contiguous().view(torch.float32)[..., 0]
    return payload[..., :M], norms


def with_norms(codes: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """(n, M) codes and their (n, d) reconstructions -> (n, M + 4) uint8
    rows: the codes, then ||recon||^2 as f32 bytes (the ST_norm_float
    layout of a code)."""
    norms = (recon * recon).sum(1).contiguous()
    return torch.cat([codes.to(torch.uint8),
                      norms[:, None].view(torch.uint8)], 1)


def scan_invlists_rq(xq: torch.Tensor, probes: torch.Tensor,
                     invlists: ivf_scan.PackedCodeInvLists,
                     books: torch.Tensor, coarse_centroids: torch.Tensor,
                     k: int, *, max_nblocks: int, chunk_blocks: int = 8,
                     id_mask=None):
    """The IVF-RQ table scan (reference `_ivf_rq_search`, models/rq.py
    :431-484) on the query-major loop (`ivf_scan._scan_compacted`):
    a row's distance is ||q||^2 + its stored norm - 2 (sum of the query's
    residual tables over its codes + <q, c_list>), the list's centroid
    product taken per probed block. The reference's static padding is for
    XLA and is not copied. Same returns as `ivf_scan.scan_invlists`."""
    M, ksub, d = books.shape
    dev = invlists.codes.device
    cent = coarse_centroids.float()
    block2list = ivf_scan.block_lists(invlists)
    moffs = torch.arange(M, device=dev) * ksub

    def score(q, bids):
        qt, cb = bids.shape
        stage, nf = split_payload(invlists.codes[bids], M)  # (qt,cb,B,M)
        B = stage.shape[2]
        lut = rq_query_tables(q, books).reshape(qt, 1, M * ksub)
        idx = (stage.long() + moffs).view(qt, cb * B * M)
        ip = torch.gather(lut[:, 0], 1, idx).view(qt, cb, B, M).sum(3)
        qc = torch.bmm(cent[block2list[bids]], q[:, :, None])    # (qt,cb,1)
        dis = (q * q).sum(1)[:, None, None] + nf - 2.0 * (ip + qc)
        return dis, invlists.ids[bids]

    return ivf_scan._scan_compacted(xq, probes, invlists, score, k, False,
                                    max_nblocks=max_nblocks,
                                    chunk_blocks=chunk_blocks,
                                    id_mask=id_mask)
