"""Product quantization — PyTorch counterpart of `tpu_ann/ops/pq.py`
(faiss `impl/ProductQuantizer.{h,cpp}` and the ADC scan's look-up tables).

M per-subspace codebooks (M, ksub, dsub) are trained with Lloyd iterations
of all subspaces at once; a vector is encoded as its M nearest sub-
centroids and searched by ADC: a per-query (M, ksub) table of distances to
the sub-centroids, summed over a code's sub-indices.

Everything here is plain torch in full f32, as the reference computes it
in XLA (no Pallas): per-subspace `torch.bmm` products where the reference
builds a block-diagonal codebook (a TPU lane-padding workaround,
reference :135-145), `index_add_` sums where it takes one-hot bf16
products (an MXU workaround, :84-87), and gathers where it multiplies by
one-hot matrices. Encoding argmins ``||c||^2 - 2 <x, c>`` (the reference's
expression, not the full distance, which rounds differently), the lowest
index winning a tie as ``jnp.argmin`` does; decoding gathers
``centroids[m, code]``, exact as the reference's one-hot product is.

IVFPQ's residual decomposition (IndexIVFPQ.cpp ``precompute_table``):
d(q, c_l + y) = ||q - c_l||^2 + (||y||^2 + 2 <c_l, y>) - 2 <q, y>;
`precomputed_tables` is the middle term and `query_tables_ip` the last.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import distances as D


@dataclasses.dataclass
class PQCodec:
    """Trained product quantizer: centroids (M, ksub, dsub) float32 (a
    numpy array, as the reference keeps it)."""

    centroids: np.ndarray
    d: int
    M: int
    nbits: int

    @property
    def ksub(self) -> int:
        return 1 << self.nbits

    @property
    def dsub(self) -> int:
        return self.d // self.M

    @property
    def code_size(self) -> int:
        """Stored bytes a vector: nbits=4 packs two sub-indices a byte (the
        pq4 fast-scan layout), nbits <= 8 one."""
        if self.nbits == 4:
            return (self.M + 1) // 2
        return self.M


def _assign(xs: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """(M, n, dsub) x (M, ksub, dsub) -> (M, n) nearest sub-centroid by
    ``||c||^2 - 2 <x, c>``, the first index winning a tie."""
    ip = torch.bmm(xs, cents.transpose(1, 2))
    cn = (cents * cents).sum(2)
    return torch.argmin(cn[:, None, :] - 2.0 * ip, dim=2)


def _lloyd(xs: torch.Tensor, cents: torch.Tensor, niter: int) -> torch.Tensor:
    """All M subspaces' Lloyd iterations at once (reference :43-61): f32
    assignment, `index_add_` sums, and the empty-cell split rule — an
    empty cell takes a perturbed copy of the largest cell's centroid,
    c * (1e-3 * (1 + j / ksub)) + c for cell j."""
    M, n, dsub = xs.shape
    ksub = cents.shape[1]
    dev = xs.device
    flat_x = xs.reshape(M * n, dsub)
    moff = (torch.arange(M, device=dev) * ksub)[:, None]
    eps = 1e-3 * (1.0 + torch.arange(ksub, device=dev,
                                     dtype=torch.float32) / ksub)
    for _ in range(niter):
        a = (_assign(xs, cents) + moff).reshape(-1)
        sums = torch.zeros(M * ksub, dsub, device=dev)
        sums.index_add_(0, a, flat_x)
        counts = torch.bincount(a, minlength=M * ksub).float()
        sums, counts = sums.view(M, ksub, dsub), counts.view(M, ksub)
        newc = sums / torch.clamp(counts, min=1.0)[:, :, None]
        big = torch.argmax(counts, dim=1)
        bigc = newc[torch.arange(M, device=dev), big][:, None, :]
        repl = bigc * eps[None, :, None] + bigc
        cents = torch.where(counts[:, :, None] == 0, repl, newc)
    return cents


def train_pq(x: np.ndarray, M: int, nbits: int = 8, *, niter: int = 25,
             seed: int = 1234, verbose: bool = False,
             device="cuda") -> PQCodec:
    """Per-subspace codebooks (ProductQuantizer::train; reference :64-133):
    the reference's `RandomState(seed)` sample of at most 256 * ksub
    points and its initial draw, then Lloyd over all subspaces at once on
    ``device``."""
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    if d % M:
        raise ValueError(f"d={d} not divisible by M={M}")
    dsub = d // M
    ksub = 1 << nbits
    if n < ksub:
        raise ValueError(f"need >= {ksub} training points, got {n}")
    rs = np.random.RandomState(seed)
    cap = 256 * ksub                      # max_train_points_per_PQ policy
    if n > cap:
        x = x[rs.choice(n, cap, replace=False)]
        n = cap
    xs = np.ascontiguousarray(np.transpose(x.reshape(n, M, dsub), (1, 0, 2)))
    init = rs.choice(n, ksub, replace=False)
    xs_dev = torch.from_numpy(xs).to(device)
    cents = _lloyd(xs_dev, xs_dev[:, torch.from_numpy(init).to(device)],
                   niter)
    if verbose:
        print(f"pq train: {M} subspaces x {niter} iters")
    return PQCodec(centroids=cents.cpu().numpy(), d=d, M=M, nbits=nbits)


def as_centroids(centroids, device) -> torch.Tensor:
    """A codec's (M, ksub, dsub) numpy centroids as an f32 tensor on
    ``device``."""
    return torch.tensor(np.asarray(centroids, np.float32), device=device)


def pq_encode(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, M) uint8 sub-indices (compute_codes; reference
    :147-156)."""
    M, ksub, dsub = centroids.shape
    xs = x.float().reshape(-1, M, dsub).transpose(0, 1)
    return _assign(xs, centroids).T.to(torch.uint8)


def pq_encode_chunked(x, centroids: torch.Tensor, chunk: int = 0, *,
                      rows=None) -> torch.Tensor:
    """`pq_encode` in row chunks that bound the (chunk, M * ksub) product
    to about 2 GB (reference :159-175); ``x`` is a numpy array or a
    tensor, the codes stay on the centroids' device. ``rows(i, j)``, if
    given, makes the device rows of x[i:j] to encode (residuals, say)."""
    M, ksub, _ = centroids.shape
    if not chunk:
        chunk = max(65536, min(1_000_000, (2 << 30) // (M * ksub * 4)))
    dev = centroids.device

    def raw(i, j):
        if isinstance(x, torch.Tensor):
            return x[i:j].to(dev)
        return torch.from_numpy(np.array(x[i:j], np.float32)).to(dev)

    rows = rows or raw
    outs = [pq_encode(rows(i, i + chunk), centroids)
            for i in range(0, len(x), chunk)]
    return torch.cat(outs) if outs else torch.zeros(
        (0, M), dtype=torch.uint8, device=dev)


def pq_decode(codes: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(n, M) sub-indices -> (n, d) f32 reconstructions (decode): a gather
    of ``centroids[m, code_m]``."""
    M, ksub, dsub = centroids.shape
    m = torch.arange(M, device=codes.device)
    return centroids[m, codes.long()].reshape(codes.shape[0], M * dsub)


def query_tables(xq: torch.Tensor, centroids: torch.Tensor,
                 metric: int = D.METRIC_L2) -> torch.Tensor:
    """Per-query ADC tables (compute_distance_table): (nq, M, ksub) — L2
    ``||q_m||^2 + ||y_mj||^2 - 2 <q_m, y_mj>``, IP ``<q_m, y_mj>``."""
    M, ksub, dsub = centroids.shape
    xs = xq.float().reshape(-1, M, dsub)
    ip = torch.einsum("nmd,mkd->nmk", xs, centroids)
    if D.is_similarity_metric(metric):
        return ip
    qn = (xs * xs).sum(2)
    cn = (centroids * centroids).sum(2)
    return qn[:, :, None] + cn[None] - 2.0 * ip


def query_tables_ip(xq: torch.Tensor, centroids: torch.Tensor
                    ) -> torch.Tensor:
    """The ``-2 <q_m, y_mj>`` term of the residual decomposition:
    (nq, M, ksub)."""
    M, ksub, dsub = centroids.shape
    xs = xq.float().reshape(-1, M, dsub)
    return -2.0 * torch.einsum("nmd,mkd->nmk", xs, centroids)


def precomputed_tables(coarse_centroids: torch.Tensor,
                       centroids: torch.Tensor) -> torch.Tensor:
    """(nlist, M, ksub): ``||y_mj||^2 + 2 <c_l_m, y_mj>``
    (IndexIVFPQ::precompute_table's term 2)."""
    M, ksub, dsub = centroids.shape
    cl = coarse_centroids.float().reshape(-1, M, dsub)
    ip = torch.einsum("lmd,mkd->lmk", cl, centroids)
    cn = (centroids * centroids).sum(2)
    return cn[None] + 2.0 * ip


def pack_codes_4bit(codes: torch.Tensor) -> torch.Tensor:
    """(n, M) sub-indices < 16 -> (n, M / 2) uint8, low nibble first."""
    n, M = codes.shape
    if M % 2:
        raise ValueError("pack_codes_4bit: M must be even")
    c = codes.to(torch.uint8).reshape(n, M // 2, 2)
    return c[:, :, 0] | (c[:, :, 1] << 4)


def unpack_codes_4bit(packed: torch.Tensor) -> torch.Tensor:
    """(..., M / 2) uint8 -> (..., M) sub-indices."""
    out = torch.stack([packed & 0x0F, packed >> 4], dim=-1)
    return out.reshape(packed.shape[:-1] + (packed.shape[-1] * 2,))


def sdc_tables(centroids: torch.Tensor) -> torch.Tensor:
    """(M, ksub, ksub) symmetric tables ``||c_mi - c_mj||^2``, clamped at 0
    (ProductQuantizer::compute_sdc_table)."""
    ip = torch.bmm(centroids, centroids.transpose(1, 2))
    cn = (centroids * centroids).sum(2)
    return torch.clamp(cn[:, :, None] + cn[:, None, :] - 2.0 * ip, min=0.0)


def sdc_query_tables(qcodes: torch.Tensor, sdc: torch.Tensor) -> torch.Tensor:
    """Per-query SDC table (nq, M, ksub) = ``sdc[m, qcode_m, :]``: fed to
    `adc_scan_db`, it gives code-to-code search (IndexPQ ST_SDC)."""
    M = sdc.shape[0]
    return sdc[torch.arange(M, device=sdc.device)[None, :], qcodes.long()]


def adc_scan(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Sum table entries over sub-codes: lut (nq, M, ksub) x codes
    (nq, C, M) -> (nq, C) f32, each query its own codes."""
    nq, M, ksub = lut.shape
    C = codes.shape[1]
    idx = codes.long() + torch.arange(M, device=lut.device) * ksub
    g = torch.gather(lut.reshape(nq, M * ksub), 1, idx.reshape(nq, C * M))
    return g.reshape(nq, C, M).sum(2)


def adc_scan_db(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC over codes shared by all queries: lut (nq, M, ksub) x codes
    (C, M) -> (nq, C) f32, the sub-quantizers' entries added in order m =
    0, 1, ... (the reference's loop order; its one-hot product per
    sub-quantizer is an MXU workaround for the same gather)."""
    nq, M, ksub = lut.shape
    cl = codes.long()
    acc = torch.zeros((nq, codes.shape[0]), dtype=torch.float32,
                      device=lut.device)
    for m in range(M):
        acc += lut[:, m, :][:, cl[:, m]]
    return acc
