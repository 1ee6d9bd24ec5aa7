"""Index types (counterparts of tpu_ann/models/)."""

from .base import (  # noqa: F401
    Index,
    QueryLatencyStats,
    SearchParameters,
    SearchStats,
    Timer,
    indexIVF_stats,
)
from .flat import (  # noqa: F401
    IndexFlat,
    IndexFlat1D,
    IndexFlatIP,
    IndexFlatL2,
)
from .binary import (  # noqa: F401
    IndexBinary,
    IndexBinaryFlat,
    IndexBinaryFromFloat,
    IndexBinaryHash,
    IndexBinaryHNSW,
    IndexBinaryIVF,
    IndexBinaryMultiHash,
)
from .extra import (  # noqa: F401
    Index2Layer,
    IndexLSH,
    IndexRandom,
    IndexRowwiseMinMax,
    IndexSplitVectors,
    MultiIndexQuantizer,
)
from .hnsw import (  # noqa: F401
    HNSWParams,
    IndexHNSW,
    IndexHNSW2Level,
    IndexHNSWFlat,
    IndexHNSWPQ,
    IndexHNSWSQ,
    SearchParametersHNSW,
)
from .idmap import (  # noqa: F401
    IndexIDMap,
    IndexIDMap2,
    IndexReplicas,
    IndexShards,
)
from .ivf import (  # noqa: F401
    IndexIVF,
    IndexIVFFlat,
    IndexIVFFlatDedup,
    SearchParametersIVF,
    make_ivf_flat,
)
from .ivf_extra import (  # noqa: F401
    IndexIVFIndependentQuantizer,
    IndexIVFSpectralHash,
)
from .ivf_hnsw import IndexIVFHNSW  # noqa: F401
from .ivf_paged import IndexIVFFlatPaged  # noqa: F401
from .ivf_pq import (  # noqa: F401
    IndexIVFPQ,
    IndexIVFPQR,
    IndexIVFScalarQuantizer,
    make_ivf_pq,
)
from .lattice import IndexLattice  # noqa: F401
from .nsg import (  # noqa: F401
    IndexNNDescentFlat,
    IndexNSGFlat,
    IndexNSGPQ,
    IndexNSGSQ,
)
from .pq import IndexPQ, IndexScalarQuantizer  # noqa: F401
from .qinco import IndexQINCo  # noqa: F401
from .refine import (  # noqa: F401
    IndexRefine,
    IndexRefineFlat,
    IndexRefineSQ8Tier,
)
from .rq import (  # noqa: F401
    IndexAdditiveQuantizer,
    IndexIVFLocalSearchQuantizer,
    IndexIVFProductLocalSearchQuantizer,
    IndexIVFProductResidualQuantizer,
    IndexIVFResidualQuantizer,
    IndexLocalSearchQuantizer,
    IndexProductLocalSearchQuantizer,
    IndexProductResidualQuantizer,
    IndexResidualQuantizer,
    LocalSearchCoarseQuantizer,
    ResidualCoarseQuantizer,
)
from .selectors import (  # noqa: F401
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
)
from .transforms import (  # noqa: F401
    CenteringTransform,
    IndexPreTransform,
    ITQMatrix,
    LinearTransform,
    NormalizationTransform,
    OPQMatrix,
    PCAMatrix,
    RandomRotationMatrix,
    RemapDimensionsTransform,
    VectorTransform,
)
