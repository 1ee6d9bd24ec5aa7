"""Index types (counterparts of tpu_ann/models/)."""

from .base import (  # noqa: F401
    Index,
    QueryLatencyStats,
    SearchParameters,
    SearchStats,
    Timer,
    indexIVF_stats,
)
from .flat import IndexFlat, IndexFlatIP, IndexFlatL2  # noqa: F401
from .ivf import (  # noqa: F401
    IndexIVF,
    IndexIVFFlat,
    SearchParametersIVF,
    make_ivf_flat,
)
