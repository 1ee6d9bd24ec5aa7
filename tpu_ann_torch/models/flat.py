"""IndexFlat — exact brute-force search (faiss/IndexFlat.{h,cpp});
PyTorch counterpart of `tpu_ann/models/flat.py`.

The database is one float32 tensor on the index's device, with cached
squared norms (IndexFlatL2's `cached_l2norms`, faiss/IndexFlat.h:108).
By default search is the blocked exact f32 product + top-k of
`ops.distances.knn`: this index is the ground-truth oracle and the IVF
coarse quantizer. An index that opts into bf16 search
(``compute_dtype="bfloat16"``, ``approx_topk=True``) on a CUDA device runs
large searches through the fused scan of `ops.flat_knn_fused` (kernels K1
and K2) instead. The extra metrics (L1, Linf, Lp, ..., faiss
MetricType.h:23-40) search through the tiled reductions of
`ops.extra_distances`; their range search raises, as the reference's does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import extra_distances as XD
from ..ops import flat_knn_fused as FK
from .base import Index, METRIC_INNER_PRODUCT, METRIC_L2


def _int_exact_stats(x: torch.Tensor):
    """(all non-negative integers?, max value): one device pass and one
    host sync, feeding the integer-exactness gate of the fused path."""
    if x.numel() == 0:
        return True, 0.0
    ints = ((x == torch.round(x)).all() & (x >= 0).all()).float()
    ok, mx = torch.stack([ints, x.max().float()]).tolist()
    return bool(ok), float(mx)


class IndexFlat(Index):
    """Exact index over raw float32 vectors on one device."""

    # reservoir width of the integer-exact refine-0 route (the reference's
    # default: W=2048 halves the lane-collision loss of W=1024)
    fused_W_exact = 2048

    def __init__(self, d: int, metric: int = METRIC_L2, *, device="cuda"):
        super().__init__(d, metric, device=device)
        self._xb = torch.zeros((0, self.d), dtype=torch.float32,
                               device=self.device)
        self._norms = torch.zeros((0,), dtype=torch.float32,
                                  device=self.device)
        # cached pack_flat_db layout of the fused scan; rebuilt lazily
        # after any mutation
        self._fused_packed = None
        # bf16 search knobs (the default stays exact f32)
        self.compute_dtype = "float32"
        self.approx_topk = False
        self.refine_factor = 1   # > 1: fast-pass candidates re-scored in f32
        # "auto": large opted-in searches on a CUDA device take the fused
        # scan; "xla": always the blocked product (the reference's name);
        # "fused": always the fused scan
        self.scan_mode = "auto"
        # the reference's chunk-loop strategy; one K1 kernel serves all
        self.fused_schedule = "grid"
        # integer-exact route: None = detect (one host sync per call),
        # True = the caller guarantees integer-exact data, False = always
        # the bf16 + refine route
        self.exact_kernel: Optional[bool] = None
        self._db_int_max: Optional[float] = None  # None = not integer

    # --- storage ----------------------------------------------------------
    def add(self, x) -> None:
        x = self._check_input(x)
        if len(x) == 0:
            return
        xt = self._to_device(x)
        self._xb = torch.cat([self._xb, xt])
        self._norms = torch.cat([self._norms, D.l2_norms(xt)])
        self.ntotal += len(x)
        self._fused_packed = None

    def reset(self) -> None:
        self._xb = self._xb[:0]
        self._norms = self._norms[:0]
        self.ntotal = 0
        self._fused_packed = None

    # --- search -----------------------------------------------------------
    def _use_fused(self, k: int) -> bool:
        """The fused scan runs only on the opted-in bf16 path, on a CUDA
        device, at sizes where the blocked product's score traffic
        dominates; the exact default never takes it."""
        if self.scan_mode == "fused":
            return True
        if self.scan_mode != "auto":
            return False
        if not (self.approx_topk and self.compute_dtype == "bfloat16"):
            return False
        if self.ntotal < 65536 or k > 256:
            return False
        return self.device.type == "cuda"

    def _use_exact_kernel(self, xq_dev: torch.Tensor) -> bool:
        """True when both sides are integer-valued in a range where the
        bf16 scores are exact: non-negative integers, <= 256 (lossless in
        bf16), and 2 * d * max_q * max_x <= 2^24 (every f32 partial sum an
        exact integer)."""
        if self.exact_kernel is not None:
            return bool(self.exact_kernel)
        if self.metric_type != METRIC_L2 or self._db_int_max is None:
            return False
        q_int, q_max = _int_exact_stats(xq_dev)
        return (q_int and q_max <= 256.0
                and 2.0 * self.d * q_max * self._db_int_max <= 2.0 ** 24)

    def _fused_search_device(self, xq_dev: torch.Tensor, k: int,
                             id_mask: Optional[torch.Tensor] = None):
        if self._fused_packed is None:
            self._fused_packed = FK.pack_flat_db(
                self._xb, self.metric_type,
                xb_norms=(self._norms if self.metric_type == METRIC_L2
                          else None),
                valid_n=self.ntotal, R=8192)
            db_int, db_max = _int_exact_stats(self._xb)
            self._db_int_max = db_max if db_int and db_max <= 256.0 else None
        if k <= 128 and self._use_exact_kernel(xq_dev):
            # exact scores: no re-rank, select in K2, a wider reservoir
            return FK.flat_knn_fused(
                xq_dev, self._xb, k, self.metric_type, id_mask=id_mask,
                packed=self._fused_packed, Q=512, R=8192,
                W=self.fused_W_exact, refine=0, sel="kernel",
                schedule=self.fused_schedule)
        Q = 1024 if xq_dev.shape[0] >= 2048 else 512
        return FK.flat_knn_fused(
            xq_dev, self._xb, k, self.metric_type, id_mask=id_mask,
            packed=self._fused_packed, Q=Q, R=8192, W=1024,
            refine=max(4, self.refine_factor),
            sel="kernel" if 4 * k <= 128 else "approx",
            schedule=self.fused_schedule)

    def _search_device(self, xq_dev: torch.Tensor, k: int,
                       id_mask: Optional[torch.Tensor] = None):
        if self._use_fused(k):
            return self._fused_search_device(xq_dev, k, id_mask=id_mask)
        return D.knn(
            xq_dev, self._xb, k, self.metric_type,
            xb_norms=self._norms if self.metric_type == METRIC_L2 else None,
            valid_n=self.ntotal, id_mask=id_mask,
            compute_dtype=self.compute_dtype, approx=self.approx_topk,
            refine_factor=self.refine_factor)

    def search_device(self, xq_dev: torch.Tensor, k: int):
        """Device-in/device-out search (no host sync on the exact path):
        (D, I) tensors."""
        return self._search_device(xq_dev, k)

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        if self.ntotal == 0:
            bad = D.worst_value(self.metric_type)
            return (np.full((len(x), k), bad, np.float32),
                    np.full((len(x), k), -1, np.int64))
        id_mask = None
        sel = getattr(params, "sel", None) if params is not None else None
        if sel is not None:
            id_mask = torch.from_numpy(sel.make_bitmap(self.ntotal)).to(
                self.device)
        if self.metric_type in XD.EXTRA_METRICS:
            # no product form: the tiled reduction of knn_extra_metrics,
            # which (unlike the reference :246-253) reads the selector
            Dv, Iv = XD.knn_extra_metrics(
                self._to_device(x), self._xb, k, self.metric_type,
                self.metric_arg, valid_n=self.ntotal, id_mask=id_mask)
        else:
            Dv, Iv = self._search_device(self._to_device(x), k,
                                         id_mask=id_mask)
        return Dv.cpu().numpy(), Iv.cpu().numpy().astype(np.int64)

    def range_search(self, x, radius: float):
        """faiss Index::range_search -> the (lims, D, I) CSR triple, exact
        f32 (L2 keeps dis < radius, IP dis > radius)."""
        from ..ops.range_search import range_search_blocked

        x = self._check_input(x)
        if self.ntotal == 0:
            return (np.zeros(len(x) + 1, np.int64), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        res = range_search_blocked(x, self._xb, radius, self.metric_type,
                                   valid_n=self.ntotal)
        return res.lims, res.distances, res.labels

    def remove_ids(self, sel) -> int:
        """Remove the vectors an IDSelector matches (faiss
        Index::remove_ids); the rest are renumbered in order, like
        IndexFlatCodes::remove_ids."""
        if self.ntotal == 0:
            return 0
        keep = torch.from_numpy(sel.make_bitmap(self.ntotal) == 0).to(
            self.device)
        kept = self._xb[keep].cpu().numpy()
        removed = self.ntotal - len(kept)
        self.reset()
        if len(kept):
            self.add(kept)
        return removed

    # --- reconstruction / codec -------------------------------------------
    def reconstruct(self, key: int) -> np.ndarray:
        if not 0 <= key < self.ntotal:
            raise IndexError(key)
        return self._xb[key].cpu().numpy()

    def reconstruct_n(self, i0: int, ni: int) -> np.ndarray:
        if not (0 <= i0 and i0 + ni <= self.ntotal):
            raise IndexError((i0, ni))
        return self._xb[i0:i0 + ni].cpu().numpy()

    def sa_code_size(self) -> int:
        return 4 * self.d

    def sa_encode(self, x) -> np.ndarray:
        return self._check_input(x).view(np.uint8).reshape(len(x), -1)

    def sa_decode(self, codes) -> np.ndarray:
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        return codes.view(np.float32).reshape(len(codes), self.d)

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


class IndexFlat1D(IndexFlat):
    """1-D specialization (faiss IndexFlat1D): search by binary search in
    the sorted values (on the host) instead of a product."""

    def __init__(self, *, device="cuda"):
        super().__init__(1, METRIC_L2, device=device)
        self._sorted: Optional[np.ndarray] = None
        self._perm: Optional[np.ndarray] = None

    def update_permutation(self) -> None:
        vals = self._xb[:, 0].cpu().numpy()
        self._perm = np.argsort(vals)
        self._sorted = vals[self._perm]

    def add(self, x) -> None:
        super().add(x)
        self.update_permutation()

    def search(self, x, k: int, *, params=None):
        x = np.asarray(x, np.float32).reshape(-1)
        if self.ntotal == 0:
            return (np.full((len(x), k), np.inf, np.float32),
                    np.full((len(x), k), -1, np.int64))
        pos = np.searchsorted(self._sorted, x)
        n = self.ntotal
        kk = min(k, n)
        # expand a window around the insertion point
        offs = np.arange(-kk, kk + 1)
        cand = np.clip(pos[:, None] + offs[None, :], 0, n - 1)
        dis = (self._sorted[cand] - x[:, None]) ** 2
        # clipping at the array ends duplicates candidates; candidates are
        # sorted, so mask adjacent repeats
        dup = np.zeros_like(dis, dtype=bool)
        dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
        dis[dup] = np.inf
        order = np.argsort(dis, axis=1)[:, :k]
        Dv = np.take_along_axis(dis, order, axis=1).astype(np.float32)
        Iv = self._perm[np.take_along_axis(cand, order, axis=1)]
        if kk < k:
            Dv[:, kk:] = np.inf
            Iv = Iv.astype(np.int64)
            Iv[:, kk:] = -1
        return Dv, Iv.astype(np.int64)
