"""k-selection primitives — PyTorch counterpart of `tpu_ann/ops/topk.py`
(the role of faiss's heaps, `utils/Heap.h`, and of the python `ResultHeap`
merge, python/extra_wrappers.py:219).

Scores are better-is-bigger if ``similarity=True`` (inner product),
better-is-smaller otherwise (L2). Every selection is a stable sort, so on
equal scores the lower index wins, as ``lax.top_k`` does in the reference;
in `merge_topk` that means the first operand's entry wins a tie.
"""

from __future__ import annotations

import torch


def chunk_starts(n: int, size: int) -> range:
    """The starts of the [i, i + size) chunks of n query rows, and one
    empty chunk when n is 0, so that a chunked search of no queries
    returns (0, k) results as faiss does."""
    return range(0, max(n, 1), size)


def topk(scores: torch.Tensor, k: int, *, similarity: bool = False):
    """Best-k along the last axis, best first. Returns (vals, idx)."""
    vals, idx = torch.sort(scores, dim=-1, descending=similarity, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_with_ids(scores: torch.Tensor, ids: torch.Tensor, k: int, *,
                  similarity: bool = False):
    """Best-k along the last axis, carrying an id array along."""
    v, pos = topk(scores, k, similarity=similarity)
    return v, torch.gather(ids, -1, pos)


def merge_topk(d1: torch.Tensor, i1: torch.Tensor, d2: torch.Tensor,
               i2: torch.Tensor, k: int, *, similarity: bool = False):
    """Merge two partial top-k result sets into one (..., k) set; on equal
    scores the entries of (d1, i1) come first."""
    return topk_with_ids(torch.cat([d1, d2], -1), torch.cat([i1, i2], -1), k,
                         similarity=similarity)


def merge_topk_axis(dis: torch.Tensor, ids: torch.Tensor, k: int, *,
                    similarity: bool = False):
    """Merge S partial top-k sets laid out along a leading axis (reference
    :64-81): (S, nq, kk) -> (nq, k). The merge is stable in the order
    shard 0's entries, then shard 1's, ..., so on equal scores the lower
    shard wins (IndexShards' heap merge, impl/ThreadedIndex-inl.h)."""
    s, nq, kk = dis.shape
    cd = dis.permute(1, 0, 2).reshape(nq, s * kk)
    ci = ids.permute(1, 0, 2).reshape(nq, s * kk)
    return topk_with_ids(cd, ci, k, similarity=similarity)
