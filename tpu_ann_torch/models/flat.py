"""IndexFlat — exact brute-force search (faiss/IndexFlat.{h,cpp});
PyTorch counterpart of `tpu_ann/models/flat.py`.

The database is one float32 tensor on the index's device, with cached
squared norms (IndexFlatL2's `cached_l2norms`, faiss/IndexFlat.h:108);
search is the blocked exact f32 product + top-k of `ops.distances.knn`.
This index is the ground-truth oracle and the IVF coarse quantizer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import distances as D
from .base import Index, METRIC_INNER_PRODUCT, METRIC_L2


class IndexFlat(Index):
    """Exact index over raw float32 vectors on one device."""

    def __init__(self, d: int, metric: int = METRIC_L2, *, device="cuda"):
        super().__init__(d, metric, device=device)
        self._xb = torch.zeros((0, self.d), dtype=torch.float32,
                               device=self.device)
        self._norms = torch.zeros((0,), dtype=torch.float32,
                                  device=self.device)

    def add(self, x) -> None:
        x = self._check_input(x)
        if len(x) == 0:
            return
        xt = self._to_device(x)
        self._xb = torch.cat([self._xb, xt])
        self._norms = torch.cat([self._norms, D.l2_norms(xt)])
        self.ntotal += len(x)

    def reset(self) -> None:
        self._xb = self._xb[:0]
        self._norms = self._norms[:0]
        self.ntotal = 0

    def search_device(self, xq_dev: torch.Tensor, k: int):
        """Device-in/device-out search (no host sync): (D, I) tensors."""
        return D.knn(
            xq_dev, self._xb, k, self.metric_type,
            xb_norms=self._norms if self.metric_type == METRIC_L2 else None)

    def search(self, x, k: int, *, params=None):
        if params is not None and getattr(params, "sel", None) is not None:
            raise NotImplementedError("IndexFlat: selectors are not ported yet")
        x = self._check_input(x)
        if self.ntotal == 0:
            bad = D.worst_value(self.metric_type)
            return (np.full((len(x), k), bad, np.float32),
                    np.full((len(x), k), -1, np.int64))
        Dv, Iv = self.search_device(self._to_device(x), k)
        return Dv.cpu().numpy(), Iv.cpu().numpy()

    @property
    def vectors(self) -> torch.Tensor:
        """(ntotal, d) stored rows (device tensor)."""
        return self._xb

    def state_dict(self) -> dict:
        return {
            "d": self.d,
            "metric": self.metric_type,
            "ntotal": self.ntotal,
            "xb": self._xb.cpu().numpy(),
        }

    @classmethod
    def from_state(cls, st: dict, *, device="cuda") -> "IndexFlat":
        idx = IndexFlat(int(st["d"]), int(st["metric"]), device=device)
        if st["ntotal"]:
            idx.add(np.asarray(st["xb"])[: int(st["ntotal"])])
        return idx


class IndexFlatL2(IndexFlat):
    def __init__(self, d: int, *, device="cuda"):
        super().__init__(d, METRIC_L2, device=device)


class IndexFlatIP(IndexFlat):
    def __init__(self, d: int, *, device="cuda"):
        super().__init__(d, METRIC_INNER_PRODUCT, device=device)
