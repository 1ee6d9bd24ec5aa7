"""L0 distance substrate — PyTorch counterpart of `tpu_ann/ops/distances.py`.

Exact k-NN is the ``||x||^2 + ||y||^2 - 2<x,y>`` expansion: one matrix
product per (query tile x database block) and a running per-query top-k
merge, the same blocking as the reference (faiss utils/distances.cpp:272).
It is a plain large product outside any kernel, so it stays
``torch.matmul``; ``compute_dtype="bfloat16"`` rounds its operands to bf16
and keeps the f32 product, with an optional exact f32 re-rank.

Precision: every product here runs in full float32. Importing this module
sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.set_float32_matmul_precision("highest")`` — these paths are the
exact ones (ground truth, coarse quantization, k-means assignment, the
re-rank), and TF32 keeps only about three decimal digits.
"""

from __future__ import annotations

from typing import Optional

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# Metric identifiers (subset of faiss MetricType, faiss/MetricType.h).
METRIC_INNER_PRODUCT = 0
METRIC_L2 = 1

_METRICS = (METRIC_INNER_PRODUCT, METRIC_L2)


def _check_metric(metric: int) -> None:
    if metric not in _METRICS:
        raise ValueError(f"unsupported metric {metric!r}")


def is_similarity_metric(metric: int) -> bool:
    return metric == METRIC_INNER_PRODUCT


def worst_value(metric: int) -> float:
    """Sentinel 'infinitely bad' distance for the metric."""
    return -float("inf") if is_similarity_metric(metric) else float("inf")


def l2_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms (= faiss `fvec_norms_L2sqr`)."""
    x = x.float()
    return (x * x).sum(dim=1)


def pairwise_inner_product(xq: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """(nq, nb) inner products."""
    return xq.float() @ xb.float().T


def pairwise_l2sqr(xq: torch.Tensor, xb: torch.Tensor, *,
                   xb_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(nq, nb) squared L2 distances via the norm expansion, clamped at 0."""
    ip = pairwise_inner_product(xq, xb)
    bn = l2_norms(xb) if xb_norms is None else xb_norms
    return torch.clamp(l2_norms(xq)[:, None] + bn[None, :] - 2.0 * ip, min=0.0)


def pairwise_distances(xq: torch.Tensor, xb: torch.Tensor,
                       metric: int = METRIC_L2, *,
                       xb_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise distance matrix. For IP the values are similarities."""
    _check_metric(metric)
    if metric == METRIC_L2:
        return pairwise_l2sqr(xq, xb, xb_norms=xb_norms)
    return pairwise_inner_product(xq, xb)


def _topk_best(dis: torch.Tensor, k: int, metric: int):
    """Per-row best-k of a distance block, best first."""
    return torch.topk(dis, k, dim=1, largest=is_similarity_metric(metric))


def knn(
    xq: torch.Tensor,
    xb: torch.Tensor,
    k: int,
    metric: int = METRIC_L2,
    *,
    xb_norms: Optional[torch.Tensor] = None,
    valid_n: Optional[int] = None,
    id_mask: Optional[torch.Tensor] = None,
    db_block: int = 131072,
    q_block: int = 4096,
    compute_dtype: str = "float32",
    approx: bool = False,
    refine_factor: int = 1,
):
    """Blocked k-NN: one product per database block + running top-k merge.

    Args:
      xq: (nq, d) queries. xb: (nb, d) database; rows >= ``valid_n`` get
        the metric's worst value.
      k: neighbours to return; k > nb pads with (worst, -1).
      id_mask: optional (nb,) uint8/bool allow-mask (an IDSelector's
        bitmap); masked-out rows get the worst value.
      compute_dtype: "float32" (exact) or "bfloat16": the product takes
        bf16-rounded operands, still multiplied and summed in f32 (a bf16
        product on CUDA would round the scores themselves).
      approx: accepted for the reference's signature; its
        ``lax.approx_max_k`` has no torch counterpart, so the per-block
        top-k stays exact (recall >= the reference's).
      refine_factor: > 1 keeps refine_factor * k candidates from the fast
        pass and re-ranks them in exact f32.
    Returns:
      (D, I): (nq, k) distances (L2 ascending, clamped at 0; IP
      descending similarities) and int64 row ids, -1 on empty slots.
    """
    del approx
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
    _check_metric(metric)
    nq, d = xq.shape
    if nq > q_block:
        outs = [knn(xq[i:i + q_block], xb, k, metric, xb_norms=xb_norms,
                    valid_n=valid_n, id_mask=id_mask, db_block=db_block,
                    q_block=q_block, compute_dtype=compute_dtype,
                    refine_factor=refine_factor)
                for i in range(0, nq, q_block)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))
    nb = xb.shape[0]
    valid_n = nb if valid_n is None else int(valid_n)
    xq = xq.float()
    bad = worst_value(metric)
    qn = l2_norms(xq) if metric == METRIC_L2 else None
    bf16 = compute_dtype == "bfloat16"
    xq_c = xq.bfloat16().float() if bf16 else xq
    ksel = k if refine_factor <= 1 else min(refine_factor * k, nb)

    best_d = torch.empty((nq, 0), dtype=torch.float32, device=xq.device)
    best_i = torch.empty((nq, 0), dtype=torch.int64, device=xq.device)
    for b0 in range(0, min(nb, valid_n), db_block):
        yb = xb[b0:b0 + db_block]
        yb_c = yb.bfloat16().float() if bf16 else yb.float()
        ip = xq_c @ yb_c.T
        ok = torch.arange(b0, b0 + yb.shape[0], device=xq.device) < valid_n
        if id_mask is not None:
            ok = ok & (id_mask[b0:b0 + yb.shape[0]] != 0)
        if metric == METRIC_L2:
            bn = l2_norms(yb) if xb_norms is None else \
                xb_norms[b0:b0 + yb.shape[0]]
            bn = torch.where(ok, bn, float("inf"))
            dis = qn[:, None] + (bn[None, :] - 2.0 * ip)
        else:
            dis = ip + torch.where(ok, 0.0, -float("inf"))[None, :]
        v, pos = _topk_best(dis, min(ksel, dis.shape[1]), metric)
        cd = torch.cat([best_d, v], dim=1)
        ci = torch.cat([best_i, pos + b0], dim=1)
        best_d, sel = _topk_best(cd, min(ksel, cd.shape[1]), metric)
        best_i = torch.gather(ci, 1, sel)

    if ksel > k and best_d.shape[1] > 0:
        # exact f32 re-rank of the fast pass's candidates
        ok = torch.isfinite(best_d)
        vecs = xb[torch.where(ok, best_i, 0)].float()      # (nq, ksel, d)
        ip = torch.bmm(vecs, xq[:, :, None])[:, :, 0]
        if metric == METRIC_L2:
            rdis = torch.clamp(qn[:, None] + (vecs * vecs).sum(2) - 2.0 * ip,
                               min=0.0)
        else:
            rdis = ip
        rdis = torch.where(ok, rdis, bad)
        best_d, pos = _topk_best(rdis, min(k, rdis.shape[1]), metric)
        best_i = torch.gather(best_i, 1, pos)

    if best_d.shape[1] < k:                     # k > nb: pad with sentinels
        extra = k - best_d.shape[1]
        best_d = torch.cat([best_d, best_d.new_full((nq, extra), bad)], 1)
        best_i = torch.cat([best_i, best_i.new_full((nq, extra), -1)], 1)
    if metric == METRIC_L2:
        # the norm expansion can give tiny negatives; clamp only the result
        best_d = torch.clamp(best_d, min=0.0)
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return best_d, best_i


def knn_l2sqr(xq, xb, k, **kw):
    """`knn` with METRIC_L2 (faiss knn_L2sqr)."""
    return knn(xq, xb, k, METRIC_L2, **kw)


def knn_inner_product(xq, xb, k, **kw):
    """`knn` with METRIC_INNER_PRODUCT (faiss knn_inner_product)."""
    return knn(xq, xb, k, METRIC_INNER_PRODUCT, **kw)
