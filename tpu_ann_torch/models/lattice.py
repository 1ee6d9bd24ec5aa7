"""IndexLattice — PyTorch counterpart of `tpu_ann/models/lattice.py`
(faiss `IndexLattice.{h,cpp}`).

Each d / nsq-dim sub-vector is coded as its norm, uniform in ``scale_nbit``
bits over the trained [min, max] range of sub-vector norms, and its
direction, the nearest Zn-sphere lattice point coded enumeratively
(`ops.lattice`). Encoding runs on the host (the codec is host numpy, as
the reference's). Decoding runs on the device: the lattice ids index a
table of every sphere point (at most ``_TABLE_MAX`` of them, decoded once
by the codec), and the norm is rebuilt in f64 as the reference's numpy
does, so the rows are the reference's. Search is `IndexNeuralNetCodec`'s:
block-wise decode and exact f32 k-NN.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import distances as D
from ..ops.lattice import ZnSphereCodec
from .qinco import IndexNeuralNetCodec

# sphere points a device decode table may hold
_TABLE_MAX = 1 << 22


class IndexLattice(IndexNeuralNetCodec):
    """faiss IndexLattice(d, nsq, scale_nbit, r2)."""

    def __init__(self, d: int, nsq: int, scale_nbit: int, r2: int,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        if d % nsq:
            raise ValueError("d must be a multiple of nsq")
        self.nsq = int(nsq)
        self.dsq = d // nsq
        self.scale_nbit = int(scale_nbit)
        self.zn = ZnSphereCodec(self.dsq, int(r2))
        self.lattice_nbit = self.zn.nbits
        super().__init__(d, M=nsq, nbits=self.scale_nbit + self.lattice_nbit,
                         metric=metric, device=device)
        self.trained = None        # (2, nsq) f32: min / max sub-norms
        self.is_trained = False
        self._table = None

    def train(self, x) -> None:
        """The per-sub-vector norm range (IndexLattice::train)."""
        x = self._check_input(x)
        sub = x.reshape(len(x), self.nsq, self.dsq)
        norms = np.sqrt((sub.astype(np.float64) ** 2).sum(-1))
        self.trained = np.stack([norms.min(0), norms.max(0)]).astype(
            np.float32)
        self.is_trained = True

    def net_encode(self, x: np.ndarray) -> np.ndarray:
        """(n, d) -> (n, nsq) uint64: lattice id << scale_nbit | scale."""
        if not self.is_trained:
            raise RuntimeError("train first")
        n = len(x)
        sub = x.reshape(n, self.nsq, self.dsq)
        norms = np.sqrt((sub.astype(np.float64) ** 2).sum(-1)).astype(
            np.float32)
        mins, maxs = self.trained
        sc = 1 << self.scale_nbit
        span = np.maximum(maxs - mins, 1e-10)
        q = np.clip(((norms - mins) * sc / span).astype(np.int64), 0,
                    sc - 1)
        codes = np.zeros((n, self.nsq), np.uint64)
        for j in range(self.nsq):
            lat = self.zn.encode(self.zn.search(sub[:, j, :]))
            codes[:, j] = (lat << np.uint64(self.scale_nbit)) | \
                q[:, j].astype(np.uint64)
        return codes

    def _points(self, lat: torch.Tensor) -> torch.Tensor:
        """(n,) lattice ids (device int64) -> (n, dsq) f32 sphere
        points."""
        if self.zn.nv <= _TABLE_MAX:
            if self._table is None:
                self._table = torch.from_numpy(self.zn.decode(np.arange(
                    self.zn.nv, dtype=np.uint64))).to(self.device)
            return self._table[lat].float()
        pts = self.zn.decode(lat.cpu().numpy().astype(np.uint64))
        return torch.from_numpy(pts).to(self.device).float()

    def net_decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(n, nsq) int64 device codes -> (n, d) f32 (IndexLattice::
        sa_decode; the norm in f64 as the reference's numpy computes it)."""
        n = codes.shape[0]
        mins, maxs = self.trained
        span = torch.from_numpy(maxs - mins).to(self.device).double()
        mins = torch.from_numpy(mins).to(self.device).double()
        sc = float(1 << self.scale_nbit)
        r = np.sqrt(float(self.zn.r2))
        qj = (codes & ((1 << self.scale_nbit) - 1)).double()
        norm = ((qj + 0.5) * span / sc + mins) / r
        c = self._points((codes >> self.scale_nbit).reshape(-1))
        out = c.view(n, self.nsq, self.dsq) * norm.float()[:, :, None]
        return out.reshape(n, self.d)
