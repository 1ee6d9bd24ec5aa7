"""Operators: distances, k-selection, k-means, scalar quantization, packed
invlists (raw, coded and SQ8), the fused IVF scan, the out-of-core paged
IVF scan and the fused flat scan."""

from . import (  # noqa: F401
    distances,
    flat_knn_fused,
    ivf_scan,
    ivf_scan_fused,
    ivf_scan_paged,
    kmeans,
    sq,
    topk,
)
