"""Evaluation utilities — numpy copy of `tpu_ann/utils/evaluation.py`
(faiss `contrib/evaluation.py`).

recall_at_r follows the reference's 1-recall@R convention
(contrib/evaluation.py:17-37: fraction of queries whose true nearest
neighbor appears in the first R results); knn_intersection_measure is
contrib/evaluation.py:40; the range-search precision / recall helpers and
the tie-aware result checks are contrib/evaluation.py:30-292."""

from __future__ import annotations

import numpy as np


def knn_intersection_measure(I1: np.ndarray, I2: np.ndarray) -> float:
    """Average fraction of common ids between two (nq, k) result sets
    (contrib/evaluation.py:40)."""
    nq, k = I1.shape
    if I2.shape != (nq, k):
        raise ValueError(f"shape mismatch: {I1.shape} vs {I2.shape}")
    ninter = sum(
        np.intersect1d(I1[i], I2[i]).size for i in range(nq)
    )
    return ninter / float(nq * k)


def recall_at_r(I: np.ndarray, gt: np.ndarray, r: int) -> float:
    """1-recall@r: P(gt[:,0] in I[:, :r]) — the headline metric in every
    fork harness (tutorial/python/190-...-test.py:1562-1620)."""
    nq = I.shape[0]
    found = (I[:, :r] == gt[:nq, :1]).any(axis=1)
    return float(found.mean())


def recall_k_at_k(I: np.ndarray, gt: np.ndarray, k: int) -> float:
    """recall@k with k ground-truth neighbors (intersection form): what the
    fork reports as 'Recall@10'."""
    nq = I.shape[0]
    ninter = 0
    for i in range(nq):
        ninter += np.intersect1d(I[i, :k], gt[i, :k]).size
    return ninter / float(nq * k)


def check_self_search(index, xb: np.ndarray, n: int = 5, tol: float = 1e-4):
    """Sanity check from the fork (tutorial/python/12-IVFHNSW.py:75-84):
    the first n database vectors must return themselves at distance ~0."""
    D, I = index.search(xb[:n], 1)
    ok_id = (I[:, 0] == np.arange(n)).all()
    ok_d = (np.abs(D[:, 0]) < tol).all()
    return bool(ok_id and ok_d)


# ---------------------------------------------------------------------------
# Range-search evaluation (contrib/evaluation.py:30-292): results are the
# (lims, D, I) CSR triple; precision/recall vs a reference result set.
# ---------------------------------------------------------------------------

def filter_range_results(lims, D, I, thresh):
    """Keep range-search hits with distance < thresh
    (contrib/evaluation.py:30)."""
    keep = D < thresh
    nl = np.zeros(len(lims), np.int64)
    for i in range(len(lims) - 1):
        nl[i + 1] = nl[i] + int(keep[lims[i]: lims[i + 1]].sum())
    return nl, D[keep], I[keep]


def counts_to_PR(ngt, nres, ninter, mode="overall"):
    """Convert per-query (ngt, nres, ninter) counts to precision/recall
    (contrib/evaluation.py:80). mode='overall' pools counts across
    queries; mode='average' macro-averages per-query ratios (empty
    result/GT counts as perfect)."""
    ngt = np.asarray(ngt, np.float64)
    nres = np.asarray(nres, np.float64)
    ninter = np.asarray(ninter, np.float64)
    # the reference's exact edge conventions (contrib/evaluation.py:80):
    # an empty result set has precision 1.0 (it asserted nothing wrong);
    # an empty GT has recall 1.0 only if the result is also empty.
    if mode == "overall":
        ngt_s, nres_s, ninter_s = ngt.sum(), nres.sum(), ninter.sum()
        precision = ninter_s / nres_s if nres_s > 0 else 1.0
        recall = ninter_s / ngt_s if ngt_s > 0 else float(nres_s == 0)
        return float(precision), float(recall)
    if mode == "average":
        precision = np.where(nres > 0, ninter / np.maximum(nres, 1), 1.0)
        recall = np.where(ngt > 0, ninter / np.maximum(ngt, 1),
                          (nres == 0).astype(np.float64))
        return float(precision.mean()), float(recall.mean())
    raise ValueError(f"unknown mode {mode!r}")


def range_PR(lims_ref, Iref, lims_new, Inew, mode="overall"):
    """Precision/recall of a range-search result vs a reference result
    (contrib/evaluation.py:40)."""
    nq = len(lims_ref) - 1
    if len(lims_new) - 1 != nq:
        raise ValueError("the two results have different query counts")
    ngt = np.empty(nq, np.int64)
    nres = np.empty(nq, np.int64)
    ninter = np.empty(nq, np.int64)
    for i in range(nq):
        gt = Iref[lims_ref[i]: lims_ref[i + 1]]
        res = Inew[lims_new[i]: lims_new[i + 1]]
        ngt[i], nres[i] = len(gt), len(res)
        ninter[i] = np.intersect1d(gt, res).size
    return counts_to_PR(ngt, nres, ninter, mode)


def range_PR_multiple_thresholds(lims_ref, Iref, lims_new, Dnew, Inew,
                                 thresholds, mode="overall"):
    """Precision/recall of a range result at several distance thresholds
    (contrib/evaluation.py:151): the new result is filtered to D < t for
    each t; returns (len(thresholds), 2) [precision, recall] rows."""
    out = np.zeros((len(thresholds), 2))
    for j, t in enumerate(thresholds):
        nl, _, ni = filter_range_results(lims_new, Dnew, Inew, t)
        out[j] = range_PR(lims_ref, Iref, nl, ni, mode)
    return out


def sort_range_res_1(lims, I):
    """Sort each query's range hits by id (contrib/evaluation.py:141)."""
    I = np.array(I)
    for i in range(len(lims) - 1):
        I[lims[i]: lims[i + 1]] = np.sort(I[lims[i]: lims[i + 1]])
    return I


def sort_range_res_2(lims, D, I):
    """Sort each query's range hits by (distance, id)
    (contrib/evaluation.py:126)."""
    D, I = np.array(D), np.array(I)
    for i in range(len(lims) - 1):
        sl = slice(lims[i], lims[i + 1])
        order = np.lexsort((I[sl], D[sl]))
        D[sl], I[sl] = D[sl][order], I[sl][order]
    return D, I


def check_ref_knn_with_draws(Dref, Iref, Dnew, Inew, rtol=1e-5):
    """Assert two kNN results are identical up to ties
    (contrib/evaluation.py:243): distances must match; within a group of
    equal distances the id *sets* must match (any order)."""
    np.testing.assert_allclose(Dref, Dnew, rtol=rtol)
    for q in range(len(Dref)):
        row_d, ri, ni = Dref[q], Iref[q], Inew[q]
        j = 0
        while j < len(row_d):
            j2 = j + 1
            while j2 < len(row_d) and np.isclose(
                    row_d[j2], row_d[j], rtol=rtol):
                j2 += 1
            if not set(ri[j:j2]) == set(ni[j:j2]):
                raise AssertionError(
                    f"query {q}: tie group [{j}:{j2}] ids differ: "
                    f"{ri[j:j2]} vs {ni[j:j2]}")
            j = j2


def check_ref_range_results(Lref, Dref, Iref, Lnew, Dnew, Inew):
    """Assert two range-search results are identical up to per-query hit
    order (contrib/evaluation.py:265)."""
    np.testing.assert_array_equal(Lref, Lnew)
    Dr, Ir = sort_range_res_2(Lref, Dref, Iref)
    Dn, In = sort_range_res_2(Lnew, Dnew, Inew)
    np.testing.assert_allclose(Dr, Dn, rtol=1e-5)
    np.testing.assert_array_equal(Ir, In)
