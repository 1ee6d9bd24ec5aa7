"""Extra metrics beyond L2 / IP — PyTorch counterpart of
`tpu_ann/ops/extra_distances.py` (faiss `utils/extra_distances.{h,cpp}`,
`extra_distances-inl.h`): L1, Linf, Lp, Canberra, BrayCurtis,
JensenShannon, Jaccard, NaNEuclidean and ABS_INNER_PRODUCT.

None of them has a product form, so, like the reference's XLA (and faiss's
scalar loops), each is a broadcast reduction over d: a (query block x base
block) tile materializes the per-dimension terms and reduces them. This is
plain torch on the index's device; the tile is sized to a byte budget
(``TILE_BYTES`` of the (qb, bb, d) f32 term tensor) instead of the
reference's fixed 1024 x 4096 queries x rows, which is 2 GB at d 128.
Distances (lower is better) keep a running best-k; Jaccard, the one
similarity, keeps the largest. Every selection is a stable sort, so on
equal values the lower row id wins, as ``lax.top_k`` does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import topk as TK

# numeric values match faiss MetricType.h:23-40
METRIC_L1 = 2
METRIC_Linf = 3
METRIC_Lp = 4
METRIC_Canberra = 20
METRIC_BrayCurtis = 21
METRIC_JensenShannon = 22
METRIC_Jaccard = 23
METRIC_NaNEuclidean = 24
METRIC_ABS_INNER_PRODUCT = 25

EXTRA_METRICS = (METRIC_L1, METRIC_Linf, METRIC_Lp, METRIC_Canberra,
                 METRIC_BrayCurtis, METRIC_JensenShannon, METRIC_Jaccard,
                 METRIC_NaNEuclidean, METRIC_ABS_INNER_PRODUCT)

# bytes of one tile's (qb, bb, d) f32 term tensor; a metric holds two or
# three such temporaries at once
TILE_BYTES = 256 << 20
_TINY = 1e-38


def is_similarity_extra(metric: int) -> bool:
    """Jaccard is the one extra similarity metric (MetricType.h:49
    is_similarity_metric)."""
    return metric == METRIC_Jaccard


def tile_distances(xq: torch.Tensor, xb: torch.Tensor, metric: int,
                   metric_arg: float = 0.0) -> torch.Tensor:
    """(nq, d) x (nb, d) -> (nq, nb) in the inputs' dtype; the formulas
    of the reference's `_tile_distances` (:43-85)."""
    x = xq[:, None, :]
    y = xb[None, :, :]
    if metric == METRIC_L1:
        return (x - y).abs().sum(-1)
    if metric == METRIC_Linf:
        return (x - y).abs().amax(-1)
    if metric == METRIC_Lp:
        return ((x - y).abs() ** metric_arg).sum(-1)
    if metric == METRIC_Canberra:
        den = x.abs() + y.abs()
        term = (x - y).abs() / den.clamp(min=_TINY)
        return torch.where(den > 0, term, 0.0).sum(-1)
    if metric == METRIC_BrayCurtis:
        num = (x - y).abs().sum(-1)
        den = (x + y).abs().sum(-1)
        return num / den.clamp(min=_TINY)
    if metric == METRIC_JensenShannon:
        m = (0.5 * (x + y)).clamp(min=_TINY)
        kl1 = torch.where(x > 0, -x * torch.log(m / x.clamp(min=_TINY)), 0.0)
        kl2 = torch.where(y > 0, -y * torch.log(m / y.clamp(min=_TINY)), 0.0)
        return 0.5 * (kl1 + kl2).sum(-1)
    if metric == METRIC_Jaccard:
        # non-negative inputs only, like the reference
        num = torch.minimum(x, y).sum(-1)
        den = torch.maximum(x, y).sum(-1)
        return num / den.clamp(min=_TINY)
    if metric == METRIC_NaNEuclidean:
        ok = ~(torch.isnan(x) | torch.isnan(y))
        diff = torch.where(ok, x - y, 0.0)
        accu = (diff * diff).sum(-1)
        present = ok.sum(-1)
        d = xq.shape[1]
        return torch.where(present > 0,
                           d / present.clamp(min=1).to(accu.dtype) * accu,
                           float("nan"))
    if metric == METRIC_ABS_INNER_PRODUCT:
        return (x * y).abs().sum(-1)
    raise ValueError(f"unknown extra metric {metric}")


def _blocks(nq: int, nb: int, d: int):
    """(query block, base block) whose f32 term tensor fits TILE_BYTES."""
    qb = max(1, min(nq, 256))
    bb = max(1, min(max(nb, 1), TILE_BYTES // (4 * qb * max(d, 1))))
    return qb, bb


def _as_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def pairwise_extra_distances(xq, xb, metric: int, metric_arg: float = 0.0,
                             *, device="cuda"):
    """(nq, nb) distance / similarity matrix (extra_distances.h
    pairwise_extra_distances; reference :94-111). Tensors stay on their
    device and a tensor comes back; numpy inputs go to ``device`` and a
    numpy array comes back."""
    host = not isinstance(xq, torch.Tensor)
    q, b = _as_device(xq, device), _as_device(xb, device)
    qb, bb = _blocks(len(q), len(b), q.shape[1])
    out = torch.empty((len(q), len(b)), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, len(q), qb):
        for b0 in range(0, len(b), bb):
            out[q0:q0 + qb, b0:b0 + bb] = tile_distances(
                q[q0:q0 + qb], b[b0:b0 + bb], metric, metric_arg)
    return out.cpu().numpy() if host else out


def knn_extra_metrics(xq, xb, k: int, metric: int, metric_arg: float = 0.0,
                      *, valid_n: Optional[int] = None,
                      id_mask: Optional[torch.Tensor] = None,
                      device="cuda"):
    """Exact k-NN under an extra metric (extra_distances.h
    knn_extra_metrics; reference :114-147): tiles of base rows, each
    tile's best k merged into a running best k. Rows at or past
    ``valid_n``, and rows an ``id_mask`` (an IDSelector's (nb,) uint8
    bitmap) leaves out, get the worst value. Returns (D, I) tensors: D
    ascending for distances, descending for Jaccard; slots left at the
    worst value (or NaN) get id -1. Numpy inputs go to ``device``."""
    sim = is_similarity_extra(metric)
    q, b = _as_device(xq, device), _as_device(xb, device)
    dev = q.device
    nq, nb = len(q), len(b)
    valid_n = nb if valid_n is None else min(int(valid_n), nb)
    bad = -float("inf") if sim else float("inf")
    qb, bb = _blocks(nq, valid_n, q.shape[1])
    outs_d, outs_i = [], []
    for q0 in range(0, nq, qb):
        qt = q[q0:q0 + qb]
        bd = torch.full((len(qt), 0), bad, device=dev)
        bi = torch.full((len(qt), 0), -1, dtype=torch.long, device=dev)
        for b0 in range(0, valid_n, bb):
            b1 = min(b0 + bb, valid_n)
            dis = tile_distances(qt, b[b0:b1], metric, metric_arg)
            ids = torch.arange(b0, b1, device=dev)
            if id_mask is not None:
                dis = torch.where(id_mask[b0:b1] != 0, dis, bad)
            v, pos = TK.topk(dis, k, similarity=sim)
            bd, bi = TK.merge_topk(bd, bi, v, ids[pos], k, similarity=sim)
        if bd.shape[1] < k:                       # k > rows: pad
            pad = k - bd.shape[1]
            bd = torch.cat([bd, bd.new_full((len(qt), pad), bad)], 1)
            bi = torch.cat([bi, bi.new_full((len(qt), pad), -1)], 1)
        outs_d.append(bd)
        outs_i.append(torch.where(torch.isfinite(bd), bi, -1))
    if not outs_d:
        return (torch.zeros((0, k), device=dev),
                torch.zeros((0, k), dtype=torch.long, device=dev))
    return torch.cat(outs_d), torch.cat(outs_i)
