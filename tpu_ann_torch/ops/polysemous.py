"""Polysemous PQ training and Hamming-filtered search — PyTorch
counterpart of `tpu_ann/ops/polysemous.py` (faiss
`impl/PolysemousTraining.{h,cpp}` and IndexPQ's `search_core_polysemous`).

Training permutes each sub-quantizer's centroid ids so that the Hamming
distance between two codes follows the distance between their
reconstructions: simulated annealing over permutations, on the host in
numpy. It is the reference's code with its `RandomState` draws in the same
order, so both packages return the same permutation.

Search computes every Hamming distance between the query's own code and
the stored codes (`ops.hamming`, exact integers, one product a block),
gathers the (query, code) pairs within the threshold ``ht``, scores only
those by ADC and keeps the best k of them (a block where most pairs pass
is scored densely), with the count of pairs that passed each database
block (summed on the host in int64).
"""

from __future__ import annotations

import numpy as np
import torch

from . import hamming as H
from . import pq as PQ
from . import topk as TK


def _hamming_table(nbits: int) -> np.ndarray:
    """(ksub, ksub) bit-Hamming distances between sub-code ids."""
    ksub = 1 << nbits
    ids = np.arange(ksub)
    x = ids[:, None] ^ ids[None, :]
    return np.vectorize(lambda v: bin(v).count("1"))(x).astype(np.float64)


def optimize_pq_for_hamming(
    centroids: np.ndarray,
    *,
    n_iter: int = 20000,
    t0: float = 0.7,
    t_decay: float = 0.9995,
    seed: int = 123,
    dis_weight_factor: float = 0.6931471805599453,   # ln 2
) -> np.ndarray:
    """Per-subspace simulated annealing over centroid permutations
    (PolysemousTraining::optimize_pq_for_hamming; reference :48-112).
    Returns the centroids (M, ksub, dsub) reordered: codes encoded with
    them are polysemous."""
    M, ksub, dsub = centroids.shape
    nbits = int(np.log2(ksub))
    ham = _hamming_table(nbits)
    out = centroids.copy()
    rs = np.random.RandomState(seed)
    for m in range(M):
        c = centroids[m].astype(np.float64)
        d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        # real distances on the Hamming scale; the objective weighs near
        # neighbours more (ReproduceDistancesObjective::dis_weight)
        d2 = d2 / max(d2.mean(), 1e-12) * ham.mean()
        w = np.exp(-dis_weight_factor * ham)
        perm = np.arange(ksub)
        dp = d2[np.ix_(perm, perm)]
        cost = (w * (dp - ham) ** 2).sum()
        T = t0 * cost / (ksub * ksub)
        for it in range(n_iter):
            i, j = rs.randint(ksub), rs.randint(ksub)
            if i == j:
                continue
            np2 = perm.copy()
            np2[i], np2[j] = perm[j], perm[i]
            # only rows and columns i and j change
            rows = np.array([i, j])
            old = (w[rows] * (d2[np.ix_(perm[rows], perm)] - ham[rows]) ** 2
                   ).sum() + (w[:, rows] * (
                       d2[np.ix_(perm, perm[rows])] - ham[:, rows]) ** 2
                   ).sum()
            new = (w[rows] * (d2[np.ix_(np2[rows], np2)] - ham[rows]) ** 2
                   ).sum() + (w[:, rows] * (
                       d2[np.ix_(np2, np2[rows])] - ham[:, rows]) ** 2
                   ).sum()
            delta = new - old
            if delta < 0 or rs.rand() < np.exp(-delta / max(T, 1e-12)):
                perm = np2
                cost += delta
            T *= t_decay
        # code k now denotes the centroid that stood at perm[k]
        out[m] = centroids[m][perm]
    return out


def code_hamming(qcodes: torch.Tensor, dbcodes: torch.Tensor) -> torch.Tensor:
    """(nq, M) x (C, M) uint8 codes -> (nq, C) int32 bit-Hamming distances
    between code words (the HammingComputer sweep, vectorized)."""
    return H.hamming_distances(qcodes, dbcodes)


# (query, code) pairs a step of the pair ADC
PAIR_CHUNK = 1 << 22
# (query, code) entries of a database block's Hamming table: the block
# holds BLOCK_BUDGET / nq codes (at least MIN_DB_BLOCK), so a batch runs few
# blocks and few launches
BLOCK_BUDGET = 1 << 27
MIN_DB_BLOCK = 32768
# a block whose pairs pass at a higher share than this is scored densely:
# one ADC over every code and one merge cost less than the pair gathers
# and their sorts there (the same sums, so the same results)
DENSE_SHARE = 0.2


def _pair_adc(lut: torch.Tensor, raw: torch.Tensor, qi: torch.Tensor,
              ci: torch.Tensor) -> torch.Tensor:
    """ADC of the (query qi, code ci) pairs only: lut (nq, M, ksub), raw
    (C, M) codes -> (npairs,) f32, the sub-quantizers' entries added in
    order m = 0, 1, ... as `ops.pq.adc_scan_db` adds them, so each sum
    equals the dense scan's bit for bit."""
    nq, M, ksub = lut.shape
    flat = lut.reshape(-1)
    out = torch.empty(qi.numel(), dtype=torch.float32, device=lut.device)
    for p0 in range(0, qi.numel(), PAIR_CHUNK):
        base = qi[p0:p0 + PAIR_CHUNK] * (M * ksub)
        rows = raw[ci[p0:p0 + PAIR_CHUNK]]
        acc = torch.zeros(base.numel(), dtype=torch.float32,
                          device=lut.device)
        for m in range(M):
            acc += flat[base + (m * ksub) + rows[:, m].long()]
        out[p0:p0 + PAIR_CHUNK] = acc
    return out


def _merge_pairs(bd, bi, qi, dis, ids, k: int):
    """Merge scored pairs (query qi, distance dis, id ids) into the running
    (nq, k) best: each query's candidates (its running entries first, then
    its pairs in id order) sorted stably by distance, the first k kept; so
    on equal distances the running entry, then the lower id, wins, as
    `ops.topk.merge_topk` does on the dense block."""
    nq = bd.shape[0]
    cq = torch.cat([torch.arange(nq, device=bd.device).repeat_interleave(k),
                    qi])
    cd = torch.cat([bd.reshape(-1), dis])
    ci = torch.cat([bi.reshape(-1), ids])
    o = torch.sort(cd, stable=True).indices
    o = o[torch.sort(cq[o], stable=True).indices]
    sq = cq[o]
    count = torch.bincount(cq, minlength=nq)
    rank = torch.arange(sq.numel(), device=bd.device) - (
        torch.cumsum(count, 0) - count)[sq]
    keep = rank < k
    bd, bi = torch.empty_like(bd), torch.empty_like(bi)
    bd[sq[keep], rank[keep]] = cd[o][keep]
    bi[sq[keep], rank[keep]] = ci[o][keep]
    return bd, bi


def polysemous_knn(xq: torch.Tensor, codes: torch.Tensor,
                   centroids: torch.Tensor, k: int, ht: int, valid_n=None,
                   *, db_block=None, packed4: bool = False, id_mask=None):
    """Two-phase polysemous search (reference :121-182): the Hamming
    filter, then L2 ADC over the codes with ham <= ``ht`` only, exact among
    them. A block's passing (query, code) pairs are gathered (``nonzero``)
    and only they are scored, and only those under their query's running
    k-th distance are merged; a block where more than DENSE_SHARE of the
    pairs pass is scored densely instead. A threshold of M * nbits or more
    rejects nothing, and no Hamming distance is computed. ``packed4`` codes
    hold two 4-bit sub-indices a byte; the query's code is packed alike for
    the filter. Rows at or past ``valid_n``, and rows an ``id_mask``
    (uint8) leaves out, do not pass. ``db_block`` defaults to
    BLOCK_BUDGET / nq codes. Returns (D (nq, k) f32, I (nq, k) int64 with
    -1 on empty slots, n_pass (nblocks,) int64 on the host: the (query,
    code) pairs that passed, block by block)."""
    nq = xq.shape[0]
    nb = codes.shape[0]
    valid_n = nb if valid_n is None else int(valid_n)
    db_block = db_block or max(MIN_DB_BLOCK, BLOCK_BUDGET // max(nq, 1))
    dev = codes.device
    xq = xq.float()
    lut = PQ.query_tables(xq, centroids)
    M, ksub = lut.shape[1], lut.shape[2]
    filter_off = int(ht) >= M * (ksub.bit_length() - 1)
    qcodes = PQ.pq_encode(xq, centroids)
    if packed4:
        qcodes = PQ.pack_codes_4bit(qcodes)
    bd = torch.full((nq, k), float("inf"), device=dev)
    bi = torch.full((nq, k), -1, dtype=torch.long, device=dev)
    npass = []
    for b0 in range(0, max(nb, 1), db_block):
        blk = codes[b0:b0 + db_block]
        ids = torch.arange(b0, b0 + blk.shape[0], device=dev)
        ok = ids < valid_n
        if id_mask is not None:
            ok &= id_mask[b0:b0 + blk.shape[0]] != 0
        ok = ok.expand(nq, -1) if filter_off else \
            (H.hamming_distances(qcodes, blk) <= int(ht)) & ok
        npass.append(int(ok.sum()))
        raw = PQ.unpack_codes_4bit(blk) if packed4 else blk
        if npass[-1] > DENSE_SHARE * ok.numel():
            dis = torch.where(ok, PQ.adc_scan_db(lut, raw), float("inf"))
            bd, bi = TK.merge_topk(bd, bi, dis, ids.expand(nq, -1), k)
        elif npass[-1]:
            qi, ci = ok.nonzero(as_tuple=True)
            dis = _pair_adc(lut, raw, qi, ci)
            # a pair at or over its query's k-th distance cannot enter (the
            # running entry wins a tie)
            near = dis < bd[qi, k - 1]
            bd, bi = _merge_pairs(bd, bi, qi[near], dis[near],
                                  ci[near] + b0, k)
    return (bd, torch.where(torch.isfinite(bd), bi, -1),
            np.asarray(npass, np.int64))
