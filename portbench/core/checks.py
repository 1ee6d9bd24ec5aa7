"""The comparison that decides ``correct``, and recall.

The program's answers (the last full pass over the query pool, and the
rows sampled from every batch of the window) are held against the plain
reference's IVF answers to the same queries. Three numbers are compared,
each against the limit that ``limits/<cell>.json`` gives it:

- ``kmeans_gain``: the relative drop of the k-means objective on the
  training rows that one more Lloyd step from the centroids of the
  program's own ``train`` gives (the check of the training stage; the
  window's index searches the benchmark's centroids, which the reference
  makes and takes too);
- ``wrong_answers``: the number of compared answers whose k distances
  lie, at any rank, outside the reference's over the lists it probes
  itself (coarse quantization, the list scan and the top k), as far as
  float32's ties in the coarse step allow (``Answers`` of the reference).
  A count, not a share, so that one wrong answer a batch reads the same
  however many answers a window compares;
- ``bad_slots``: the share of returned (id, distance) slots whose id is
  not a base row, is repeated in its answer, or lies at another distance
  from the query than reported (the re-rank and the map to user ids).

Distances are equal within 1e-6 of the expansion's terms ||q||^2 + ||x||^2,
a bound far above float32's round-off of them (2^-24 each) and, on
integer-valued data, far below the smallest real difference (1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

REL_TOL = 1e-6


@dataclasses.dataclass
class Compared:
    rows: np.ndarray      # (n,) pool rows of the answers
    d: np.ndarray         # (n, k) reported distances
    i: np.ndarray         # (n, k) reported ids
    n_last: int           # the first n_last answers are the last full pass


def collect(runs: list, k: int) -> Compared:
    """The answers to compare: the latest answer to each pool batch in the
    last run (its last full pass, once the window has gone round the pool),
    then the rows sampled from every batch of every run."""
    last = runs[-1]
    b = last.batch
    rows, d, i = [], [], []
    for j, ans in enumerate(last.last):
        if ans is not None:
            rows.append(np.arange(j * b, (j + 1) * b))
            d.append(ans[0])
            i.append(ans[1])
    n_last = sum(len(r) for r in rows)
    for run in runs:
        rows += run.sample_rows
        d += run.sample_d
        i += run.sample_i
    if not rows:
        empty = np.zeros((0, k))
        return Compared(np.zeros(0, np.int64), empty, empty, 0)
    return Compared(np.concatenate(rows), _stack(d, k), _stack(i, k), n_last)


def _stack(parts: list, k: int) -> np.ndarray:
    """Answers as one (n, k) float64 array; an answer of another shape
    becomes a row of NaN, which compares as wrong."""
    out = []
    for p in parts:
        p = np.asarray(p)
        if p.ndim != 2 or p.shape[1] != k:
            p = np.full((len(p), k), np.nan)
        out.append(p.astype(np.float64))
    return np.concatenate(out)


def compare(cmp: Compared, ref_answers, pool: torch.Tensor,
            xb: torch.Tensor, row_distances, block: int = 8192) -> dict:
    """``wrong_answers`` (a count), ``bad_slots`` and ``recall`` (over the
    last full pass) of the compared answers, and the pool rows of the wrong answers
    (``wrong_rows``); ``ref_answers`` are the reference's answers to the
    whole pool, ``row_distances`` its direct distance of a query to the
    base rows it names."""
    dev = xb.device
    n, k = cmp.d.shape
    wrong = bad = hits = 0
    wrong_rows = []
    xbn = (xb.double() ** 2).sum(1)
    xbmax = float(xbn.max())
    for i0 in range(0, n, block):
        rows = torch.from_numpy(cmp.rows[i0:i0 + block]).to(dev)
        d = torch.from_numpy(cmp.d[i0:i0 + block]).to(dev)
        ids_f = torch.from_numpy(cmp.i[i0:i0 + block]).to(dev)
        fin = torch.isfinite(d) & torch.isfinite(ids_f)
        ids = torch.nan_to_num(ids_f, nan=-1.0).long()
        q = pool[rows]
        qn = (q.double() ** 2).sum(1, keepdim=True)
        exact = row_distances(q, xb, ids)
        valid = torch.isfinite(exact)
        xn = torch.where(valid, xbn[ids.clamp(0, xb.shape[0] - 1)], 0.0)
        srt, order = torch.sort(ids, dim=1)
        dup_sorted = torch.zeros_like(srt, dtype=torch.bool)
        dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
        dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
        same = (d - exact).abs() <= REL_TOL * (qn + xn)
        slot_ok = valid & ~dup & same & fin
        bad += int((~slot_ok).sum())

        low = ref_answers.low_d[rows]
        high = ref_answers.high_d[rows]
        tol = REL_TOL * (qn + xbmax)
        rank_ok = ((d >= low - tol) & (d <= high + tol)) | (
            torch.isinf(d) & torch.isinf(high))
        miss = ~rank_ok.all(1)
        wrong += int(miss.sum())
        wrong_rows.append(rows[miss].cpu().numpy())

        last = torch.arange(i0, i0 + len(rows), device=dev) < cmp.n_last
        kth = ref_answers.exact_kth[rows][:, None]
        hit = slot_ok & (exact <= kth * (1 + 1e-9)) & last[:, None]
        hits += int(hit.sum())
    return {"wrong_answers": wrong,
            "bad_slots": bad / max(n * k, 1),
            "recall": hits / max(cmp.n_last * k, 1),
            "wrong_rows": np.concatenate(wrong_rows) if wrong_rows
            else np.zeros(0, np.int64)}
