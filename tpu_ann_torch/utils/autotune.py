"""Auto-tuning — the port's copy of `tpu_ann/utils/autotune.py` (faiss
`AutoTune.{h,cpp}`): `AutoTuneCriterion` (OneRecallAtRCriterion /
IntersectionCriterion), the `OperatingPoints` Pareto set, and
`ParameterSpace` (named runtime parameters and a grid exploration).
It is host code: each explored point is one `search` of the index on its
device, numpy in and out, timed on the host clock.

`ParameterSpace` knows the same parameter names the reference exposes
(`nprobe`, `efSearch`, `k_factor`, `max_codes` — AutoTune.cpp
ParameterSpace::initialize) and applies them via
`set_index_parameters(index, "nprobe=16,efSearch=64")`.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# criteria (AutoTuneCriterion hierarchy, AutoTune.h:25-100)
# ---------------------------------------------------------------------------

class AutoTuneCriterion:
    def __init__(self, nq: int, nnn: int):
        self.nq, self.nnn = nq, nnn
        self.gt_I: Optional[np.ndarray] = None

    def set_groundtruth(self, gt_D, gt_I) -> None:
        self.gt_I = np.asarray(gt_I)

    def evaluate(self, D: np.ndarray, I: np.ndarray) -> float:
        raise NotImplementedError


class OneRecallAtRCriterion(AutoTuneCriterion):
    """P(gt[0] in first R results) (AutoTune.h OneRecallAtRCriterion)."""

    def __init__(self, nq: int, R: int):
        super().__init__(nq, R)
        self.R = R

    def evaluate(self, D, I) -> float:
        found = (I[:, : self.R] == self.gt_I[: len(I), :1]).any(axis=1)
        return float(found.mean())


class IntersectionCriterion(AutoTuneCriterion):
    """|result ∩ gt| / (nq*R) (AutoTune.h IntersectionCriterion)."""

    def __init__(self, nq: int, R: int):
        super().__init__(nq, R)
        self.R = R

    def evaluate(self, D, I) -> float:
        inter = 0
        for i in range(len(I)):
            inter += np.intersect1d(I[i, : self.R],
                                    self.gt_I[i, : self.R]).size
        return inter / float(len(I) * self.R)


# ---------------------------------------------------------------------------
# operating points (AutoTune.h:77-130)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OperatingPoint:
    perf: float    # criterion value (higher better)
    t: float       # seconds per batch (lower better)
    key: str       # parameter-set string


class OperatingPoints:
    """Pareto-optimal (perf, time) set."""

    def __init__(self):
        self.all_pts: List[OperatingPoint] = []

    def add(self, perf: float, t: float, key: str) -> bool:
        self.all_pts.append(OperatingPoint(perf, t, key))
        return self.is_pareto(perf, t)

    def is_pareto(self, perf: float, t: float) -> bool:
        return not any(p.perf >= perf and p.t <= t and
                       (p.perf > perf or p.t < t) for p in self.all_pts)

    def optimal_pts(self) -> List[OperatingPoint]:
        pts = sorted(self.all_pts, key=lambda p: (p.t, -p.perf))
        out: List[OperatingPoint] = []
        best = -1.0
        for p in pts:
            if p.perf > best:
                out.append(p)
                best = p.perf
        return out


class OperatingPointsWithRanges(OperatingPoints):
    """Operating points over named parameter ranges, experiments indexed
    by an integer combination number (contrib/evaluation.py:357
    ``OperatingPointsWithRanges``): keys are per-parameter value-index
    tuples, dominance is elementwise (search parameters are assumed
    monotone — larger value => higher perf, higher cost), and
    ``predict_bounds`` gives (max-perf, min-time) bounds from already
    measured dominating/dominated points for sweep pruning."""

    def __init__(self):
        super().__init__()
        self.ranges: List[tuple] = []   # (name, [values...])

    def add_range(self, name: str, values) -> None:
        self.ranges.append((name, list(values)))

    def restrict_range(self, name: str, max_val) -> None:
        """Drop values >= max_val from a range
        (contrib OperatingPointsWithRanges.restrict_range)."""
        for i, (n, vals) in enumerate(self.ranges):
            if n == name:
                self.ranges[i] = (n, [v for v in vals if v < max_val])
                return
        raise ValueError(f"unknown parameter {name!r}")

    def num_experiments(self) -> int:
        n = 1
        for _, vals in self.ranges:
            n *= len(vals)
        return n

    def cno_to_key(self, cno: int):
        """Mixed-radix decode: combination number -> per-parameter value
        indices (first range varies fastest)."""
        key = []
        for _, vals in self.ranges:
            key.append(cno % len(vals))
            cno //= len(vals)
        return tuple(key)

    def get_parameters(self, key) -> Dict[str, float]:
        return {name: vals[k]
                for (name, vals), k in zip(self.ranges, key)}

    @staticmethod
    def compare_keys(k1, k2) -> int:
        """1 if k1 dominates k2 (>= elementwise), -1 if dominated,
        0 if incomparable or equal."""
        ge = all(a >= b for a, b in zip(k1, k2))
        le = all(a <= b for a, b in zip(k1, k2))
        if ge and not le:
            return 1
        if le and not ge:
            return -1
        return 0

    def predict_bounds(self, key):
        """(max_perf, min_time) bounds for an unmeasured key from the
        monotonicity assumption over measured points."""
        max_perf, min_time = 1.0, 0.0
        for p in self.all_pts:
            cmp = self.compare_keys(p.key, key)
            if cmp > 0:       # p dominates key
                max_perf = min(max_perf, p.perf)
            elif cmp < 0:     # key dominates p
                min_time = max(min_time, p.t)
        return max_perf, min_time


# ---------------------------------------------------------------------------
# parameter space (AutoTune.h:131-205)
# ---------------------------------------------------------------------------

def set_index_parameter(index, name: str, value) -> None:
    """Apply one named runtime parameter
    (ParameterSpace::set_index_parameter, AutoTune.cpp)."""
    from ..models.idmap import IndexIDMap
    from ..models.refine import IndexRefine
    from ..models.transforms import IndexPreTransform

    if isinstance(index, IndexPreTransform):
        return set_index_parameter(index.index, name, value)
    if isinstance(index, IndexIDMap):
        return set_index_parameter(index.index, name, value)
    if name == "k_factor" and isinstance(index, IndexRefine):
        index.k_factor = int(value)
        return
    if isinstance(index, IndexRefine):
        return set_index_parameter(index.base_index, name, value)
    if name == "nprobe":
        index.nprobe = int(value)
        return
    if name == "ht" and hasattr(index, "polysemous_ht"):
        # polysemous Hamming threshold (AutoTune.cpp knows 'ht')
        index.polysemous_ht = int(value)
        return
    if name == "max_codes" and hasattr(index, "max_codes"):
        index.max_codes = int(value)
        return
    if name == "efSearch":
        if hasattr(index, "quantizer") and hasattr(index.quantizer, "hnsw"):
            index.quantizer.hnsw.efSearch = int(value)
            return
        if hasattr(index, "hnsw"):
            index.hnsw.efSearch = int(value)
            return
    raise ValueError(f"cannot set parameter {name} on {type(index).__name__}")


class ParameterSpace:
    """Grid of runtime parameters + exploration
    (ParameterSpace::explore, AutoTune.cpp)."""

    def __init__(self):
        self.parameter_ranges: Dict[str, List] = {}
        self.verbose = False

    def initialize(self, index) -> None:
        """Infer tunable parameters (ParameterSpace::initialize)."""
        from ..models.idmap import IndexIDMap
        from ..models.ivf import IndexIVF
        from ..models.hnsw import IndexHNSW
        from ..models.refine import IndexRefine
        from ..models.transforms import IndexPreTransform

        if isinstance(index, (IndexPreTransform, IndexIDMap)):
            return self.initialize(index.index)
        if isinstance(index, IndexRefine):
            self.parameter_ranges["k_factor"] = [1, 2, 4, 8, 16]
            return self.initialize(index.base_index)
        if isinstance(index, IndexIVF):
            nlist = index.nlist
            rng = [1]
            while rng[-1] * 2 <= max(nlist // 2, 1):
                rng.append(rng[-1] * 2)
            self.parameter_ranges["nprobe"] = rng
            if hasattr(index.quantizer, "hnsw"):
                self.parameter_ranges["efSearch"] = [16, 32, 64, 128, 256]
        elif isinstance(index, IndexHNSW):
            self.parameter_ranges["efSearch"] = [8, 16, 32, 64, 128, 256]

    def set_index_parameters(self, index, spec: str) -> None:
        """Apply "name=value,name=value" (AutoTune.cpp)."""
        for part in spec.split(","):
            if not part:
                continue
            name, value = part.split("=")
            set_index_parameter(index, name.strip(), float(value))

    def combinations(self) -> List[Dict[str, float]]:
        names = sorted(self.parameter_ranges)
        out = []
        for combo in itertools.product(
                *(self.parameter_ranges[n] for n in names)):
            out.append(dict(zip(names, combo)))
        return out

    def explore(self, index, xq: np.ndarray, crit: AutoTuneCriterion,
                *, batchsize: Optional[int] = None) -> OperatingPoints:
        """Evaluate every combination of the grid (one warm-up search of
        8 queries, then one timed search of xq) and collect the operating
        points; ``optimal_pts()`` is the Pareto set. Like the reference,
        no combination is pruned (faiss ParameterSpace::explore skips
        those its measured points dominate)."""
        ops = OperatingPoints()
        k = crit.nnn
        for combo in self.combinations():
            key = ",".join(f"{n}={v}" for n, v in sorted(combo.items()))
            for n, v in combo.items():
                set_index_parameter(index, n, v)
            index.search(xq[:8], k)  # warm-up / compile
            t0 = time.perf_counter()
            D, I = index.search(xq, k)
            t = time.perf_counter() - t0
            perf = crit.evaluate(D, I)
            ops.add(perf, t, key)
            if self.verbose:
                print(f"  {key}: perf={perf:.4f} t={t*1000:.1f}ms")
        return ops
