"""Range search — PyTorch counterpart of `tpu_ann/ops/range_search.py`
(faiss `Index::range_search` + `RangeSearchResult`,
impl/AuxIndexStructures.h:30-131).

Each chunk of the distance work is masked on the device (L2 keeps
dis < radius, IP keeps dis > radius, the faiss convention) and compacted
there with `torch.nonzero`; one stable sort by query over all chunks then
gives the (lims, D, I) CSR triple. Per query the hits come in chunk order,
and inside a chunk in the order of the chunk's own axes (database row, or
probe block then slot), the reference's order: its per-query host loop
appends the same hits in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import distances as D
from .ivf_scan import SCAN_BUDGET, _compact_block_table


@dataclasses.dataclass
class RangeSearchResult:
    """CSR result triple (faiss RangeSearchResult: lims/labels/distances)."""

    lims: np.ndarray       # (nq+1,) int64
    distances: np.ndarray  # (lims[-1],) float32
    labels: np.ndarray     # (lims[-1],) int64

    @property
    def nq(self) -> int:
        return len(self.lims) - 1


def _empty(nq: int) -> RangeSearchResult:
    return RangeSearchResult(lims=np.zeros(nq + 1, np.int64),
                             distances=np.zeros(0, np.float32),
                             labels=np.zeros(0, np.int64))


def csr_from_hits(nq: int, hits_q, hits_d, hits_i) -> RangeSearchResult:
    """The CSR triple of per-chunk hits (the BufferList ->
    RangeSearchResult step): ``hits_q`` / ``hits_d`` / ``hits_i`` are lists
    of equally long 1-D tensors, one entry per chunk in scan order, of each
    hit's query, distance and label. A stable sort by query keeps each
    query's hits in chunk order."""
    if not hits_q:
        return _empty(nq)
    q = torch.cat(hits_q)
    order = torch.argsort(q, stable=True)
    lims = np.zeros(nq + 1, np.int64)
    np.cumsum(torch.bincount(q, minlength=nq).cpu().numpy(), out=lims[1:])
    return RangeSearchResult(
        lims=lims,
        distances=torch.cat(hits_d)[order].float().cpu().numpy(),
        labels=torch.cat(hits_i)[order].long().cpu().numpy())


def _keep(dis: torch.Tensor, radius: float, keep_gt: bool) -> torch.Tensor:
    return dis > radius if keep_gt else dis < radius


def _collect(mask: torch.Tensor, dis: torch.Tensor, labels, q0: int,
             hits: tuple) -> None:
    """Append the hits of one chunk: ``mask`` / ``dis`` (qb, ...) over the
    chunk's slots, ``labels`` a function of the nonzero index tuple."""
    nz = torch.nonzero(mask, as_tuple=True)
    hits[0].append(nz[0] + q0)
    hits[1].append(dis[nz])
    hits[2].append(labels(nz))


def range_search_blocked(xq: np.ndarray, xb_dev: torch.Tensor, radius: float,
                         metric: int = D.METRIC_L2, *, valid_n: int,
                         db_block: int = 65536,
                         q_block: int = 4096) -> RangeSearchResult:
    """Blocked exact range search against the first ``valid_n`` rows of a
    device-resident database (query blocks outer, database blocks inner,
    as the reference)."""
    nq = len(xq)
    keep_gt = D.is_similarity_metric(metric)
    hits = ([], [], [])
    for q0 in range(0, nq, q_block):
        xq_dev = torch.as_tensor(np.ascontiguousarray(xq[q0:q0 + q_block]),
                                 device=xb_dev.device)
        for b0 in range(0, valid_n, db_block):
            b1 = min(b0 + db_block, valid_n)
            dis = D.pairwise_distances(xq_dev, xb_dev[b0:b1], metric)
            _collect(_keep(dis, radius, keep_gt), dis,
                     lambda nz, b0=b0: nz[1] + b0, q0, hits)
    return csr_from_hits(nq, *hits)


def range_search_decoded(xq: np.ndarray, decode_block, n: int,
                         radius: float, metric: int = D.METRIC_L2, *,
                         db_block: int = 65536,
                         q_block: int = 4096) -> RangeSearchResult:
    """Blocked range search over a coded database (the
    `IndexFlatCodes::range_search` role, faiss/IndexFlatCodes.h:65):
    ``decode_block(i0, i1)`` returns the decoded f32 rows [i0, i1) as a
    device tensor, and the exact distance to them is the codec's distance
    (database blocks outer, query blocks inner, as the reference)."""
    nq = len(xq)
    keep_gt = D.is_similarity_metric(metric)
    hits = ([], [], [])
    for b0 in range(0, n, db_block):
        xb = decode_block(b0, min(b0 + db_block, n))
        for q0 in range(0, nq, q_block):
            xq_dev = torch.as_tensor(
                np.ascontiguousarray(xq[q0:q0 + q_block]), device=xb.device)
            dis = D.pairwise_distances(xq_dev, xb, metric)
            _collect(_keep(dis, radius, keep_gt), dis,
                     lambda nz, b0=b0: nz[1] + b0, q0, hits)
    return csr_from_hits(nq, *hits)


def range_search_flatcodes(index, x, radius: float, codes=None) -> tuple:
    """Coded-flat range search of any index with ``sa_decode`` over its
    stored codes (numpy uint8 rows, ``index._codes`` by default; the
    IndexFlatCodes default, faiss/IndexFlatCodes.h:65). Returns the
    (lims, D, I) tuple."""
    x = index._check_input(x)
    if index.ntotal == 0:
        r = _empty(len(x))
        return r.lims, r.distances, r.labels
    codes = np.asarray(index._codes if codes is None else codes)

    def decode_block(i0, i1):
        return torch.as_tensor(index.sa_decode(codes[i0:i1]),
                               device=index.device)

    res = range_search_decoded(x, decode_block, index.ntotal, radius,
                               index.metric_type)
    return res.lims, res.distances, res.labels


def range_search_ivf(xq: np.ndarray, probes, invlists, radius: float,
                     metric: int = D.METRIC_L2, *, max_nblocks: int,
                     chunk_blocks: int = 16) -> RangeSearchResult:
    """IVF range search (IndexIVF::range_search): every real row of the
    probed lists (at most ``max_nblocks`` blocks a list) within the radius,
    scored in exact f32 against the stored rows and norms of raw
    ``invlists``. The reference walks the per-query compacted block table
    in chunks of ``chunk_blocks`` blocks for all queries at once; here the
    queries also go in tiles of at most SCAN_BUDGET gathered f32 elements,
    which changes no hit and no order."""
    nq, d = xq.shape
    if nq == 0:
        return _empty(0)
    keep_gt = D.is_similarity_metric(metric)
    dev = invlists.data.device
    B = invlists.block_size
    probes = torch.as_tensor(probes, device=dev)
    buffer, total = _compact_block_table(
        probes, invlists.list_block_start, invlists.list_nblocks,
        max_nblocks, invlists.nblocks)
    W = buffer.shape[1]
    xq_dev = torch.as_tensor(np.ascontiguousarray(xq, np.float32),
                             device=dev)
    qn = (xq_dev * xq_dev).sum(1)
    qt = max(1, min(nq, SCAN_BUDGET // max(chunk_blocks * B * d, 1)))
    hits = ([], [], [])
    for c0 in range(0, min(int(total.max()), W), chunk_blocks):
        for q0 in range(0, nq, qt):
            bids = buffer[q0:q0 + qt, c0:c0 + chunk_blocks]
            vecs = invlists.data[bids]                   # (qt, cb, B, d)
            vids = invlists.ids[bids]
            n, cb = bids.shape
            ip = torch.bmm(vecs.view(n, -1, d),
                           xq_dev[q0:q0 + n, :, None]).view(n, cb, B)
            if keep_gt:
                dis = ip
            else:
                dis = torch.clamp(qn[q0:q0 + n, None, None]
                                  + invlists.norms[bids] - 2.0 * ip,
                                  min=0.0)
            mask = (vids >= 0) & _keep(dis, radius, keep_gt)
            _collect(mask, dis, lambda nz, vids=vids: vids[nz], q0, hits)
    # chunks went query tile by query tile inside each block chunk: per
    # query that is still the reference's chunk order
    return csr_from_hits(nq, *hits)
