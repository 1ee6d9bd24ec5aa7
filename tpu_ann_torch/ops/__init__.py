"""Operators: distances, k-selection, k-means, scalar quantization, packed
invlists (raw, coded and SQ8) and the query-major scan, the fused IVF scan,
the out-of-core paged IVF scan, the fused flat scan and its variants, the
HNSW graph and its fused tiles, and the row-copy issue probe."""

from . import (  # noqa: F401
    distances,
    flat_knn_fused,
    hnsw,
    hnsw_tiles,
    ivf_scan,
    ivf_scan_fused,
    ivf_scan_paged,
    kmeans,
    row_copy_probe,
    sq,
    topk,
)
