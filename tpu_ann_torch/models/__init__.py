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
from .hnsw import (  # noqa: F401
    HNSWParams,
    IndexHNSW,
    IndexHNSWFlat,
    SearchParametersHNSW,
)
from .ivf import (  # noqa: F401
    IndexIVF,
    IndexIVFFlat,
    SearchParametersIVF,
    make_ivf_flat,
)
from .ivf_hnsw import IndexIVFHNSW  # noqa: F401
from .ivf_paged import IndexIVFFlatPaged  # noqa: F401
from .ivf_pq import IndexIVFScalarQuantizer  # noqa: F401
from .pq import IndexScalarQuantizer  # noqa: F401
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
