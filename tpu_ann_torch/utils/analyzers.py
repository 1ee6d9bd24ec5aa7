"""Offline IVF analyzers — PyTorch counterpart of
`tpu_ann/utils/analyzers.py`, the role of the fork's analysis tooling
(tutorial/python/ivf-analyzer.py partition-stats plots,
nprobe-analyzer.py search-coverage distributions,
point_analyzer.py per-point diagnostics).

The fork's scripts read CSV/txt dumps and render matplotlib charts; here
the same statistics are computed programmatically from a live (or
reloaded) index, returned as plain dicts/arrays so they feed reports,
tests, and autotune alike. CSV export keeps the fork's file formats for
anyone with existing downstream tooling. The probes and searches run on
the index's device (its coarse step and its K3 list scan); the
statistics are numpy on the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def ivf_partition_stats(index_ivf) -> Dict:
    """Partition-size distribution (= ivf-analyzer.py's statistics
    section over the `_ivf_stats.csv` dump: mean/median/percentiles,
    imbalance, emptiness)."""
    sizes = np.asarray(index_ivf.list_sizes, np.int64)
    nlist = sizes.size
    ntotal = int(sizes.sum())
    mean = ntotal / max(nlist, 1)
    # Gini coefficient of the size distribution (the fork plots a
    # Lorenz-style skew view; one number captures it)
    if ntotal:
        s = np.sort(sizes)
        cum = np.cumsum(s, dtype=np.float64)
        gini = float(1.0 - 2.0 * (cum.sum() / cum[-1] - 0.5) / nlist)
    else:
        gini = 0.0
    return {
        "nlist": nlist,
        "ntotal": ntotal,
        "mean_size": mean,
        "min_size": int(sizes.min(initial=0)),
        "max_size": int(sizes.max(initial=0)),
        "median_size": float(np.median(sizes)) if nlist else 0.0,
        "p95_size": float(np.percentile(sizes, 95)) if nlist else 0.0,
        "p99_size": float(np.percentile(sizes, 99)) if nlist else 0.0,
        "empty_lists": int((sizes == 0).sum()),
        # faiss imbalance_factor: sum(s^2) * nlist / ntotal^2
        "imbalance": (float((sizes.astype(np.float64) ** 2).sum()
                            * nlist / ntotal ** 2) if ntotal else 0.0),
        "gini": gini,
        "cv": (float(sizes.std() / mean) if mean else 0.0),
        "sizes": sizes,
    }


def export_partition_csv(index_ivf, path: str) -> None:
    """Write the fork's `_ivf_stats.csv` format
    (partition_id,vector_count)."""
    sizes = np.asarray(index_ivf.list_sizes, np.int64)
    with open(path, "w") as f:
        f.write("partition_id,vector_count\n")
        for i, s in enumerate(sizes):
            f.write(f"{i},{s}\n")


def probe_coverage(index_ivf, xq: np.ndarray, nprobe: int) -> Dict:
    """Per-query scanned fraction of the database (= nprobe-analyzer.py
    over `search_partition_ratios.txt`): what share of ntotal the probed
    lists hold, as a distribution over queries."""
    probes = np.asarray(index_ivf.coarse_assign(xq, nprobe))
    sizes = np.asarray(index_ivf.list_sizes, np.int64)
    ntotal = max(int(sizes.sum()), 1)
    per_q = np.where(probes >= 0,
                     sizes[np.maximum(probes, 0)], 0).sum(axis=1)
    ratios = per_q / ntotal
    return {
        "nprobe": nprobe,
        "mean_ratio": float(ratios.mean()),
        "median_ratio": float(np.median(ratios)),
        "p95_ratio": float(np.percentile(ratios, 95)),
        "max_ratio": float(ratios.max()),
        "ratios": ratios,
    }


def recall_attribution(index_ivf, xq: np.ndarray, gt: np.ndarray,
                       k: int, nprobe: int,
                       I: Optional[np.ndarray] = None) -> Dict:
    """Attribute recall loss to ROUTING (the true neighbor's list was
    never probed) vs RANKING/codec (list probed, neighbor still missed)
    — the point_analyzer.py role, done exactly instead of by plotting.

    Needs a direct map from ids to their list: uses the index's host
    assignment of each stored row.
    """
    probes = np.asarray(index_ivf.coarse_assign(xq, nprobe))
    if I is None:
        _, I = index_ivf.search(
            xq, k, params=_params_with_nprobe(index_ivf, nprobe))
        I = np.asarray(I)
    gt = np.asarray(gt)[:, :k]
    nq = gt.shape[0]
    # list of each ground-truth id
    gt_list = index_ivf.list_of_ids(gt.reshape(-1)).reshape(nq, k)
    probed = np.zeros((nq, k), bool)
    for j in range(probes.shape[1]):
        probed |= gt_list == probes[:, j:j + 1]
    found = (I[:, :, None] == gt[:, None, :]).any(axis=1)
    n = nq * k
    n_found = int(found.sum())
    n_missed_routing = int((~probed & ~found).sum())
    n_missed_ranking = int((probed & ~found).sum())
    return {
        "recall": n_found / n,
        "routing_loss": n_missed_routing / n,   # raise nprobe to fix
        "ranking_loss": n_missed_ranking / n,   # better codec/refine
        "probed_frac": float(probed.mean()),
        "n": n,
    }


def _params_with_nprobe(index_ivf, nprobe: int):
    from ..models.ivf import SearchParametersIVF
    return SearchParametersIVF(nprobe=nprobe)


def report(index_ivf, xq: np.ndarray, gt: Optional[np.ndarray] = None,
           k: int = 10, nprobe: int = 16) -> str:
    """Human-readable roll-up of all three analyzers."""
    ps = ivf_partition_stats(index_ivf)
    cov = probe_coverage(index_ivf, xq, nprobe)
    lines = [
        f"IVF partitions: nlist={ps['nlist']} ntotal={ps['ntotal']} "
        f"mean={ps['mean_size']:.1f} max={ps['max_size']} "
        f"empty={ps['empty_lists']}",
        f"  imbalance={ps['imbalance']:.2f} gini={ps['gini']:.3f} "
        f"cv={ps['cv']:.2f} p99={ps['p99_size']:.0f}",
        f"probe coverage @ nprobe={nprobe}: mean={cov['mean_ratio']:.4f} "
        f"median={cov['median_ratio']:.4f} p95={cov['p95_ratio']:.4f}",
    ]
    if gt is not None:
        att = recall_attribution(index_ivf, xq, gt, k, nprobe)
        lines.append(
            f"recall@{k}={att['recall']:.4f}  loss: "
            f"routing={att['routing_loss']:.4f} (raise nprobe) "
            f"ranking={att['ranking_loss']:.4f} (codec/refine)")
    return "\n".join(lines)
