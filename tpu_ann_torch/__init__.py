"""tpu_ann_torch — the PyTorch / CUDA port of tpu_ann for NVIDIA Hopper.

It mirrors tpu_ann's layout and names (ops/, models/, utils/) and adds
csrc/ (hand-written CUDA kernels) and kernels/ (their build and ctypes
binding). Indexes hold tensors on one explicit device, ``device="cuda"``
by default; nothing falls back to the CPU. This package never imports
jax or tpu_ann: only the tests import both.

Covered today:
- the IVF-Flat search path — make_ivf_flat -> train (k-means) -> add
  (assign + block-packed invlists) -> search / search_stats, through the
  hand-written fused invlist scan (K3);
- the fused flat search path — an IndexFlat opted into bf16 search
  (compute_dtype="bfloat16", approx_topk=True) on a CUDA device searches
  through flat_knn_fused: the reservoir scan (K1), reservoir_topk (K2)
  and the exact f32 re-rank; IDSelectors filter flat searches;
- the out-of-core IVF search — IndexIVFFlatPaged: train -> streaming add
  into an on-disk directory (the JAX package's format) -> load (mmap) ->
  search, through a pinned, double-buffered host-to-device window pipeline
  and the hand-written window scan (K4);
- the scalar-quantizer slice — the SQ codecs (ops.sq), IndexScalarQuantizer,
  and IndexIVFScalarQuantizer, whose 8-bit qtypes search the uint8 codes
  through the hand-written SQ8 scan (K3-SQ8); and K3g
  (scan_invlists_fused_grid), served by K3 and K3-SQ8 on a cut plan;
- the HNSW graph path — IndexHNSWFlat (batch kNN-graph build, per-node
  beam below tile_threshold, fused tiles searched through K3 above it) and
  IndexIVFHNSW, the IVF-Flat index with an HNSW coarse quantizer;
- the flat-scan variants and probes — flat_knn_fused(merge="packed")
  through the packed reservoir kernel (K1p), the ceiling-probe folds
  (flat_probe_scan, B1) and the row-copy issue probe (row_copy_probe, B2).
"""

from .models import (  # noqa: F401
    Index,
    IDSelector,
    IDSelectorAll,
    IDSelectorAnd,
    IDSelectorArray,
    IDSelectorBatch,
    IDSelectorBitmap,
    IDSelectorNot,
    IDSelectorOr,
    IDSelectorRange,
    IDSelectorXOr,
    IndexFlat,
    IndexFlat1D,
    IndexFlatIP,
    IndexFlatL2,
    IndexHNSW,
    IndexHNSWFlat,
    IndexIVF,
    IndexIVFFlat,
    IndexIVFFlatPaged,
    IndexIVFHNSW,
    IndexIVFScalarQuantizer,
    IndexScalarQuantizer,
    QueryLatencyStats,
    SearchParameters,
    SearchParametersHNSW,
    SearchParametersIVF,
    SearchStats,
    Timer,
    indexIVF_stats,
    make_ivf_flat,
)
from .ops.distances import (  # noqa: F401
    METRIC_INNER_PRODUCT,
    METRIC_L2,
    knn,
)
from .ops.flat_knn_fused import (  # noqa: F401
    flat_knn_fused,
    flat_probe_scan,
    pack_flat_db,
    reservoir_topk,
)
from .ops.hnsw import HNSWGraph, build_graph_knn, hnsw_search  # noqa: F401
from .ops.hnsw_tiles import (  # noqa: F401
    FusedTileGraph,
    build_tiles_fused,
    tile_search_fused,
)
from .ops.ivf_scan import (  # noqa: F401
    PackedCodeInvLists,
    PackedInvLists,
    PackedInvListsSQ8,
    pack_code_invlists,
    pack_invlists,
    pack_invlists_device,
    scan_invlists,
    sq8_requantize_invlists,
    sq8_view_from_codes,
)
from .ops.ivf_scan_fused import (  # noqa: F401
    grid2d_maxc,
    scan_invlists_fused,
    scan_invlists_fused_grid,
    scan_invlists_fused_reference,
)
from .ops.ivf_scan_paged import (  # noqa: F401
    PagedInvLists,
    create_paged_invlists,
    open_paged_invlists,
    scan_invlists_paged,
)
from .ops.kmeans import ClusteringParameters, kmeans  # noqa: F401
from .ops.row_copy_probe import row_copy_probe  # noqa: F401
from .ops.sq import (  # noqa: F401
    QT_4BIT,
    QT_4BIT_UNIFORM,
    QT_6BIT,
    QT_8BIT,
    QT_8BIT_DIRECT,
    QT_8BIT_DIRECT_SIGNED,
    QT_8BIT_UNIFORM,
    QT_BF16,
    QT_FP16,
    SQCodec,
    train_sq,
)
from .ops.topk import merge_topk, topk_with_ids  # noqa: F401
from .utils.convert import (  # noqa: F401
    flat_from_reference,
    hnsw_from_reference,
    ivf_flat_from_reference,
    ivf_hnsw_from_reference,
    ivf_sq_from_reference,
    sq_from_reference,
)
from .utils.datasets import (  # noqa: F401
    SIFT1M_CALIBRATED,
    SyntheticDataset,
    sift_surrogate,
)
from .utils.evaluation import (  # noqa: F401
    knn_intersection_measure,
    recall_at_r,
    recall_k_at_k,
)
