"""Operators: distances, k-selection, k-means, packed invlists, the fused
IVF scan, the out-of-core paged IVF scan and the fused flat scan."""

from . import (  # noqa: F401
    distances,
    flat_knn_fused,
    ivf_scan,
    ivf_scan_fused,
    ivf_scan_paged,
    kmeans,
    topk,
)
