"""Local-search (additive) quantization — PyTorch counterpart of
`tpu_ann/ops/lsq.py` (faiss `impl/LocalSearchQuantizer.{h,cpp}`: ICM
encoding with perturbations, least-squares codebook refits) and the
product additive quantizers (`impl/ProductAdditiveQuantizer.cpp`).

An LSQ code is, like RQ's, a sum of M codewords; it is encoded by iterated
conditional modes (ICM) from the beam-4 RQ encode: with every other stage
fixed, a stage's best code is the argmin over unary (n, M, ksub) and
binary (M, M, ksub, ksub) terms, one batched sweep over all rows. Between
sweeps ``nperts`` random stages of each row get random codes, and a row
keeps a sweep's code only where it lowers the true reconstruction error.
The perturbations draw from an explicit `torch.Generator`: the
reference's `jax.random` stream cannot be reproduced, so the two packages
agree bit for bit only without them (``nperts=0``) and by MSE otherwise.

Training (LocalSearchQuantizer::train) starts from stage-wise RQ and
alternates the ICM encode with a ridge least-squares refit of the stacked
codebooks. Its normal equations are built on the device in f64 (the
co-occurrence counts by one `bincount`, the right side by `index_add_`)
and solved in f64, as the reference's host `np.add.at` and solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .rq import ENCODE_ROWS, RQCodec, as_codebooks, rq_decode, rq_encode, \
    train_rq


def _binary_terms(books: torch.Tensor) -> torch.Tensor:
    """(M, M, ksub, ksub) cross terms 2 <c_mk, c_m'k'>
    (compute_binary_terms); the diagonal blocks are not read."""
    return 2.0 * torch.einsum("mkd,nld->mnkl", books, books)


def _unary_terms(x: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """(n, M, ksub): ||c_mk||^2 - 2 <x, c_mk> (compute_unary_terms)."""
    M, ksub, d = books.shape
    ip = (x @ books.reshape(M * ksub, d).T).reshape(-1, M, ksub)
    cn = (books * books).sum(2)
    return cn[None] - 2.0 * ip


def _recon_err(x: torch.Tensor, codes: torch.Tensor,
               books: torch.Tensor) -> torch.Tensor:
    diff = x - rq_decode(codes, books)
    return (diff * diff).sum(1)


def _lsq_chunk(x: torch.Tensor, books: torch.Tensor, binary: torch.Tensor,
               gen: Optional[torch.Generator], icm_iters: int,
               nperts: int) -> torch.Tensor:
    n = x.shape[0]
    M, ksub, _ = books.shape
    unary = _unary_terms(x, books)
    codes = rq_encode(x, books, beam=4).long()
    best_err = _recon_err(x, codes, books)
    best = codes
    rows = torch.arange(n, device=x.device)[:, None]
    for it in range(icm_iters):
        codes = codes.clone()
        for m in range(M):
            cost = unary[:, m, :]
            for mp in range(M):
                if mp != m:
                    cost = cost + binary[m, mp][:, codes[:, mp]].T
            codes[:, m] = torch.argmin(cost, dim=1)
        err = _recon_err(x, codes, books)
        better = err < best_err
        best = torch.where(better[:, None], codes, best)
        best_err = torch.minimum(err, best_err)
        if it + 1 < icm_iters and nperts:
            pm = torch.randint(0, M, (n, nperts), generator=gen,
                               device=x.device)
            pk = torch.randint(0, ksub, (n, nperts), generator=gen,
                               device=x.device)
            codes = best.clone()
            codes[rows, pm] = pk
    return best.to(torch.uint8)


def lsq_encode(x, books: torch.Tensor, gen: Optional[torch.Generator] = None,
               icm_iters: int = 4, nperts: int = 4,
               chunk: int = ENCODE_ROWS) -> torch.Tensor:
    """Batched ICM encode (icm_encode_impl; reference :73-127), in chunks
    of ``chunk`` rows: (n, d) -> (n, M) uint8. ``gen`` (a generator on the
    codebooks' device) draws the perturbations; ``nperts`` is capped at M,
    and 0 turns them off."""
    M = books.shape[0]
    nperts = min(int(nperts), M)
    if nperts and gen is None:
        gen = torch.Generator(device=books.device)
        gen.manual_seed(0)
    binary = _binary_terms(books)
    dev = books.device
    outs = []
    for i in range(0, len(x), chunk):
        xi = x[i:i + chunk]
        xi = xi.to(dev).float() if isinstance(xi, torch.Tensor) else \
            torch.from_numpy(np.array(xi, np.float32)).to(dev)
        outs.append(_lsq_chunk(xi, books, binary, gen, icm_iters, nperts))
    return torch.cat(outs) if outs else torch.zeros(
        (0, M), dtype=torch.uint8, device=dev)


def update_codebooks(x: torch.Tensor, codes: torch.Tensor, M: int, ksub: int,
                     lambd: float) -> torch.Tensor:
    """Ridge least-squares codebook refit (update_codebooks; reference
    :130-146): the codebooks C minimizing ||X - B C||^2 + lambd ||C||^2,
    B the (n, M ksub) one-hot indicator of the codes. B^T B is the
    co-occurrence count of (stage, code) pairs and B^T X a scatter-add of
    the rows, both in f64 on x's device; the solve is f64. Returns
    (M, ksub, d) f32."""
    n, d = x.shape
    MK = M * ksub
    dev = x.device
    cols = codes.long() + torch.arange(M, device=dev) * ksub     # (n, M)
    pairs = (cols[:, :, None] * MK + cols[:, None, :]).reshape(-1)
    btb = torch.bincount(pairs, minlength=MK * MK).to(torch.float64) \
        .reshape(MK, MK)
    btb.diagonal().add_(lambd)
    btx = torch.zeros((MK, d), dtype=torch.float64, device=dev)
    xd = x.double()
    for m in range(M):
        btx.index_add_(0, cols[:, m], xd)
    sol = torch.linalg.solve(btb, btx)
    return sol.reshape(M, ksub, d).float()


def train_lsq(x: np.ndarray, M: int, nbits: int = 8, *, train_iters: int = 8,
              icm_iters: int = 4, nperts: int = 4, lambd: float = 1e-2,
              seed: int = 1234, verbose: bool = False,
              device="cuda") -> RQCodec:
    """LocalSearchQuantizer::train (reference :149-186): the RQ warm start,
    then ``train_iters`` rounds of the ICM encode (perturbations from a
    generator seeded with ``seed``) and the codebook refit."""
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    ksub = 1 << nbits
    books = as_codebooks(train_rq(x, M, nbits, seed=seed,
                                  device=device).codebooks, device)
    x_dev = torch.from_numpy(x).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for it in range(train_iters):
        codes = lsq_encode(x_dev, books, gen, icm_iters=icm_iters,
                           nperts=nperts)
        books = update_codebooks(x_dev, codes, M, ksub, lambd)
        if verbose:
            err = float(_recon_err(x_dev, codes, books).mean())
            print(f"lsq train iter {it + 1}/{train_iters}: mse {err:.5g}")
    return RQCodec(codebooks=books.cpu().numpy(), d=d, M=M, nbits=nbits)


def train_product_aq(x: np.ndarray, nsplits: int, Msub: int, nbits: int = 8,
                     *, kind: str = "rq", seed: int = 1234,
                     verbose: bool = False, device="cuda",
                     **lsq_params) -> RQCodec:
    """A product additive quantizer (PRQ: RQs, PLSQ: LSQs over d / nsplits
    slices; reference :189-215) as ONE additive codec of M = nsplits Msub
    block-diagonal full-d codebooks (zero outside each split's slice), so
    decode, tables and scans are RQ's. Split s trains with seed + s;
    ``lsq_params`` go to `train_lsq`."""
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    if d % nsplits:
        raise ValueError(f"d={d} not divisible by nsplits={nsplits}")
    dsub = d // nsplits
    books = np.zeros((nsplits * Msub, 1 << nbits, d), np.float32)
    for s in range(nsplits):
        xs = np.ascontiguousarray(x[:, s * dsub:(s + 1) * dsub])
        if kind == "rq":
            sub = train_rq(xs, Msub, nbits, seed=seed + s, verbose=verbose,
                           device=device)
        elif kind == "lsq":
            sub = train_lsq(xs, Msub, nbits, seed=seed + s, verbose=verbose,
                            device=device, **lsq_params)
        else:
            raise ValueError(kind)
        books[s * Msub:(s + 1) * Msub, :, s * dsub:(s + 1) * dsub] = \
            sub.codebooks
    return RQCodec(codebooks=books, d=d, M=nsplits * Msub, nbits=nbits)
