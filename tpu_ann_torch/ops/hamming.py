"""Hamming-space operators — PyTorch counterpart of `tpu_ann/ops/hamming.py`
(faiss `utils/hamming.{h,cpp}`).

Binary vectors are uint8 code rows (d bits = d / 8 bytes, least
significant bit first, faiss's IndexBinary convention). The distance is
popcount(xor), computed exactly as |a| + |b| - 2 |a AND b| with one
product of the 0/1 bit matrices: the same integers as the reference's ±1
bf16 product, without its TPU tile padding. Where each query meets its own
rows (an inverted list's blocks, a hash bucket's candidates) the distance
is the popcount of the XOR, byte by byte (`popcount_u8`, `hamming_rows`).
"""

from __future__ import annotations

import torch

from . import topk as TK

# rows of a database block of knn_hamming
DB_BLOCK = 8192


def hamming_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(nq, nbytes) x (nb, nbytes) uint8 -> (nq, nb) int32 Hamming
    distances: |a| + |b| - 2 |a AND b| over the unpacked 0/1 bits, the AND
    counts one product. Its sums are integers up to the bit count, exact in
    any summation order: in f16 up to 2048 bits on the card (the tensor
    cores), in f32 otherwise."""
    ba, bb = unpack_bits(a), unpack_bits(b)
    dt = torch.float16 if ba.is_cuda and ba.shape[1] <= 2048 else \
        torch.float32
    both = (ba.to(dt) @ bb.to(dt).T).float()
    return (ba.sum(1)[:, None] + bb.sum(1)[None, :] - 2 * both).to(
        torch.int32)


def knn_hamming(xq: torch.Tensor, xb: torch.Tensor, k: int, *,
                valid_n=None, db_block: int = DB_BLOCK):
    """Exact Hamming k-NN (faiss hammings_knn; reference :33-93): blocked
    over the database with a running top-k; on equal distances the lower
    id wins. Rows at or past ``valid_n`` are skipped. Returns (D int32
    ascending, I int64), (32767, -1) on empty slots, the reference's
    sentinel."""
    nq = xq.shape[0]
    nb = xb.shape[0]
    valid_n = nb if valid_n is None else int(valid_n)
    big = 32767
    dev = xq.device
    bd = torch.full((nq, k), big, dtype=torch.int32, device=dev)
    bi = torch.full((nq, k), -1, dtype=torch.long, device=dev)
    for b0 in range(0, min(nb, valid_n), db_block):
        b1 = min(b0 + db_block, nb, valid_n)
        dis = hamming_distances(xq, xb[b0:b1])
        ids = torch.arange(b0, b1, device=dev).expand(nq, -1)
        bd, bi = TK.merge_topk(bd, bi, dis, ids, k)
    return bd, torch.where(bd < big, bi, -1)


def popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each byte of a uint8 tensor (uint8 out), by the SWAR
    steps on the bytes themselves: no table, no widening."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def hamming_rows(q: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Hamming distances of query bytes ``q`` (..., nbytes) to the code rows
    ``codes`` (..., nbytes) they broadcast against: int32 popcount(q XOR
    c) summed over the bytes."""
    return popcount_u8(torch.bitwise_xor(codes, q)).sum(-1,
                                                        dtype=torch.int32)


def pack_bits(x01: torch.Tensor) -> torch.Tensor:
    """(n, d) 0/1 -> (n, d / 8) uint8, least significant bit first."""
    n, d = x01.shape
    if d % 8:
        raise ValueError(f"d={d} is not a multiple of 8")
    bits = x01.reshape(n, d // 8, 8).to(torch.int32)
    w = 1 << torch.arange(8, device=x01.device, dtype=torch.int32)
    return (bits * w).sum(-1).to(torch.uint8)


def unpack_bits(codes: torch.Tensor) -> torch.Tensor:
    """(n, nbytes) uint8 -> (n, nbytes * 8) f32 0/1."""
    n, nbytes = codes.shape
    shifts = torch.arange(8, device=codes.device, dtype=torch.int32)
    bits = (codes.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(n, nbytes * 8).float()
