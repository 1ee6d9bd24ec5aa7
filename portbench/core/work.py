"""The yardstick's peak and the work a search needs, from its shapes.

The peak is NVIDIA's data sheet figure for one H100 SXM, at the card's
full 700 W; a run states the card's power limit beside every share it
reports.
"""

from __future__ import annotations

import numpy as np

PEAK_HBM_BYTES_S = 3.35e12


def per_pair_width(k: int) -> int:
    """The per-(query, list) top list the scan keeps before the exact
    re-rank, a bit wider than k: max(k, min(2k, k + 6))."""
    return max(k, min(2 * k, k + 6))


def ivf_scan_bytes(probes: np.ndarray, list_sizes: np.ndarray, d: int,
                   k: int, row_bytes_a_dim: int = 2) -> float:
    """The least bytes one batch's list scan moves, from its probes and the
    lists' sizes, whatever kernel does it: each distinct probed list's
    valid rows read once (bf16: 2 B a dimension), the queries read once
    (bf16), and each (query, probe) pair's top ``per_pair_width(k)`` written
    once (an f32 distance and an int32 position each)."""
    p = probes[probes >= 0]
    rows = int(np.asarray(list_sizes, np.int64)[np.unique(p)].sum())
    nq = probes.shape[0]
    return float(rows * d * row_bytes_a_dim + nq * d * 2
                 + len(p) * per_pair_width(k) * 8)
