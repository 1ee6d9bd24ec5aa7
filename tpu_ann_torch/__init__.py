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
- the HNSW graph path — IndexHNSWFlat (batch kNN-graph build or wave
  insertion, extend_graph for small adds, per-node beam below
  tile_threshold, above it the fused tiles searched through K3 or the
  tile beam, range_search), the storages IndexHNSWSQ (bf16 / fp16 tiles
  through K3, "sq8" code tiles through K3-SQ8), IndexHNSW2Level (over
  Index2Layer codes) and IndexHNSWPQ (PQ code tiles), and IndexIVFHNSW,
  the IVF-Flat index with an HNSW coarse quantizer;
- the flat-scan variants and probes — flat_knn_fused(merge="packed")
  through the packed reservoir kernel (K1p), the ceiling-probe folds
  (flat_probe_scan, B1) and the row-copy issue probe (row_copy_probe, B2);
- the IVF API — IDSelectors and max_codes on IVF search (the query-major
  scan_invlists), IVF-SQ at every qtype (scan_invlists_sq), range_search
  of IndexFlat, IndexScalarQuantizer and the IVF indexes (ops.range_search),
  remove_ids / update_vectors / merge_from / reconstruct / list_of_ids /
  sa_encode over the DirectMap, and IndexIVFFlatDedup;
- the PQ and refine slice — the PQ codec (ops.pq), IndexPQ, IndexIVFPQ
  (its 8-bit codes decoded once into a cache that K3, or K3-SQ8 for an
  "sq8" cache, scans; the query-major table scan scan_invlists_pq
  otherwise), IndexIVFPQR, and IndexRefine / IndexRefineFlat /
  IndexRefineSQ8Tier;
- the index API breadth — IndexIDMap / IndexIDMap2 (selectors by
  external id), IndexShards / IndexReplicas (containers on one device),
  the VectorTransform family (PCA, OPQ, random rotation, ITQ, L2norm,
  centering, dimension remap) and IndexPreTransform, IndexFlat's extra
  metrics (ops.extra_distances), autotune (ParameterSpace) and ivflib
  (extract_index_ivf, replace_ivf_quantizer, SlidingIndexWindow, the
  fork's ClusterManager);
- the codecs — the additive quantizers (ops.rq, ops.lsq: RQ, LSQ and
  their products) as flat indexes and as IVF codes, whose decoded cache
  K3 / K3-SQ8 scan, and as coarse quantizers (ResidualCoarseQuantizer,
  LocalSearchCoarseQuantizer); IndexQINCo (ops.qinco, nn.Modules that load
  the reference's state dicts), IndexLattice (ops.lattice), and IndexPQ's
  polysemous training and Hamming-filtered search (ops.hamming,
  ops.polysemous);
- the fork's workflow around them — index files in the JAX package's
  format (utils.index_io: write_index, read_index with mmap, clone,
  serialize; IndexIVFHNSW.save_to_disk / load), on-disk inverted lists and
  merge_ondisk (utils.invlists_io), index_factory (utils.factory), the
  per-query latency stats (search_stats_per_query, search_preassigned)
  and the benchmark grid with its P50 / P99 / P99.9 (utils.benchmark);
- the IVF search's spans (trace): each step of IndexIVF.search (input,
  upload, coarse, plan, kernel, merge, output) in a range of the
  profiler's trace, and all but the kernel in search_stats' fields, free
  when neither is on.
"""

from .models import (  # noqa: F401
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
    Index,
    Index2Layer,
    IndexAdditiveQuantizer,
    IndexBinary,
    IndexBinaryFlat,
    IndexBinaryFromFloat,
    IndexBinaryHNSW,
    IndexBinaryHash,
    IndexBinaryIVF,
    IndexBinaryMultiHash,
    IndexFlat,
    IndexFlat1D,
    IndexFlatIP,
    IndexFlatL2,
    IndexHNSW,
    IndexHNSW2Level,
    IndexHNSWFlat,
    IndexHNSWPQ,
    IndexHNSWSQ,
    IndexIDMap,
    IndexIDMap2,
    IndexIVF,
    IndexIVFFlat,
    IndexIVFFlatDedup,
    IndexIVFFlatPaged,
    IndexIVFHNSW,
    IndexIVFIndependentQuantizer,
    IndexIVFLocalSearchQuantizer,
    IndexIVFPQ,
    IndexIVFPQR,
    IndexIVFProductLocalSearchQuantizer,
    IndexIVFProductResidualQuantizer,
    IndexIVFResidualQuantizer,
    IndexIVFScalarQuantizer,
    IndexIVFSpectralHash,
    IndexLSH,
    IndexLattice,
    IndexLocalSearchQuantizer,
    IndexNNDescentFlat,
    IndexNSGFlat,
    IndexNSGPQ,
    IndexNSGSQ,
    IndexPQ,
    IndexPreTransform,
    IndexProductLocalSearchQuantizer,
    IndexProductResidualQuantizer,
    IndexQINCo,
    IndexRandom,
    IndexRefine,
    IndexRefineFlat,
    IndexRefineSQ8Tier,
    IndexReplicas,
    IndexResidualQuantizer,
    IndexRowwiseMinMax,
    IndexScalarQuantizer,
    IndexShards,
    IndexSplitVectors,
    LocalSearchCoarseQuantizer,
    MultiIndexQuantizer,
    OPQMatrix,
    PCAMatrix,
    QueryLatencyStats,
    RandomRotationMatrix,
    ResidualCoarseQuantizer,
    SearchParameters,
    SearchParametersHNSW,
    SearchParametersIVF,
    SearchStats,
    Timer,
    indexIVF_stats,
    make_ivf_flat,
    make_ivf_pq,
)
from .models.qinco import IndexNeuralNetCodec  # noqa: F401
from .ops.distances import (  # noqa: F401
    METRIC_INNER_PRODUCT,
    METRIC_L2,
    knn,
    knn_inner_product,
    knn_l2sqr,
    pairwise_distances,
)
from .ops.extra_distances import (  # noqa: F401
    METRIC_ABS_INNER_PRODUCT,
    METRIC_BrayCurtis,
    METRIC_Canberra,
    METRIC_JensenShannon,
    METRIC_Jaccard,
    METRIC_L1,
    METRIC_Linf,
    METRIC_Lp,
    METRIC_NaNEuclidean,
    knn_extra_metrics,
    pairwise_extra_distances,
)
from .ops.flat_knn_fused import (  # noqa: F401
    flat_knn_fused,
    flat_probe_scan,
    pack_flat_db,
    reservoir_topk,
)
from .ops.hnsw import (  # noqa: F401
    HNSWGraph,
    build_graph,
    build_graph_knn,
    extend_graph,
    hnsw_search,
)
from .ops.hnsw_tiles import (  # noqa: F401
    FusedTileGraph,
    PQTileGraph,
    TileGraph,
    build_tiles,
    build_tiles_fused,
    build_tiles_pq,
    tile_search,
    tile_search_fused,
    tile_search_pq,
)
from .ops.ivf_scan import (  # noqa: F401
    PackedCodeInvLists,
    PackedInvLists,
    PackedInvListsSQ8,
    decode_code_invlists,
    decode_code_invlists_generic,
    pack_code_invlists,
    pack_invlists,
    pack_invlists_device,
    scan_invlists,
    scan_invlists_pq,
    scan_invlists_sq,
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
from .ops.kmeans import (  # noqa: F401
    ClusteringParameters,
    Kmeans,
    kmeans,
    kmeans1d,
    progressive_dim_clustering,
)
from .ops.nndescent import build_nsg, nn_descent  # noqa: F401
from .ops.pq import PQCodec, train_pq  # noqa: F401
from .ops.qinco import QINCo, QINCoStep  # noqa: F401
from .ops.rq import RQCodec, train_rq  # noqa: F401
from .ops.range_search import (  # noqa: F401
    RangeSearchResult,
    csr_from_hits,
    range_search_blocked,
    range_search_decoded,
    range_search_flatcodes,
    range_search_ivf,
)
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
from .ops.topk import merge_topk, merge_topk_axis, topk_with_ids  # noqa: F401,E501
from .utils.convert import (  # noqa: F401
    aq_from_reference,
    binary_flat_from_reference,
    binary_from_float_from_reference,
    binary_hash_from_reference,
    binary_hnsw_from_reference,
    binary_ivf_from_reference,
    imi_from_reference,
    ivf_independent_from_reference,
    ivf_spectral_hash_from_reference,
    lsh_from_reference,
    nnd_from_reference,
    nsg_from_reference,
    random_from_reference,
    rowwise_minmax_from_reference,
    split_vectors_from_reference,
    coarse_aq_from_reference,
    flat_from_reference,
    hnsw_2level_from_reference,
    hnsw_from_reference,
    hnsw_pq_from_reference,
    hnsw_sq_from_reference,
    idmap_from_reference,
    ivf_flat_from_reference,
    ivf_hnsw_from_reference,
    ivf_pq_from_reference,
    ivf_aq_from_reference,
    ivf_pqr_from_reference,
    ivf_sq_from_reference,
    lattice_from_reference,
    pq_from_reference,
    pretransform_from_reference,
    qinco_from_reference,
    refine_from_reference,
    replicas_from_reference,
    shards_from_reference,
    sq_from_reference,
    transform_from_reference,
)
from .utils.autotune import (  # noqa: F401
    IntersectionCriterion,
    OneRecallAtRCriterion,
    OperatingPoints,
    ParameterSpace,
)
from .utils.benchmark import per_query_latency  # noqa: F401
from .utils.contrib import add_preassigned, merge_indexes  # noqa: F401
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
from .utils.factory import (  # noqa: F401
    get_code_size,
    index_binary_factory,
    index_factory,
    reverse_index_factory,
)
from .utils.index_io import (  # noqa: F401
    clone_index,
    deserialize_index,
    read_index,
    serialize_index,
    write_index,
)
from .utils.interrupt import InterruptCallback, TimeoutGuard  # noqa: F401
from .utils.invlists_io import (  # noqa: F401
    FileInvlistSource,
    OnDiskInvertedLists,
    merge_ondisk,
)

__version__ = "0.1.0"
