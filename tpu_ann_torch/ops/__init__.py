"""Operators: distances and the extra metrics, k-selection, k-means,
scalar, product, additive (RQ / LSQ), neural (QINCo) and lattice
quantization, Hamming distances and polysemous search, packed invlists (raw, coded and SQ8) and the
query-major scan, the fused IVF scan,
the out-of-core paged IVF scan, the fused flat scan and its variants, the
HNSW graph and its fused tiles, and the row-copy issue probe."""

from . import (  # noqa: F401
    distances,
    extra_distances,
    flat_knn_fused,
    hamming,
    hnsw,
    hnsw_tiles,
    ivf_scan,
    ivf_scan_fused,
    ivf_scan_paged,
    kmeans,
    lattice,
    lsq,
    polysemous,
    qinco,
    row_copy_probe,
    rq,
    sq,
    topk,
)
