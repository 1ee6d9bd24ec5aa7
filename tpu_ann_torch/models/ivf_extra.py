"""IVF indexes with other couplings — PyTorch counterpart of
`tpu_ann/models/ivf_extra.py`:

* IndexIVFSpectralHash (faiss/IndexIVFSpectralHash.{h,cpp}): the list
  codes are periodic binarizations of a projection of each vector against
  its list's thresholds; a search binarizes the query against each
  probed list's thresholds and ranks by Hamming distance
  (`ops.ivf_scan.scan_invlists_hash`, plain torch on the device). The scan
  sits in `_scan_probes`, so search, search_stats, search_preassigned,
  search_stats_per_query, selectors and max_codes all scan the codes.
* IndexIVFIndependentQuantizer (faiss/IndexIVFIndependentQuantizer.
  {h,cpp}): the coarse quantizer sees the raw vectors, the payload IVF a
  transformed view (a PCA, say); a search is the payload's
  search_preassigned on the quantizer's probes, so an IVF-Flat payload
  runs K3.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import hamming as H
from ..ops import ivf_scan
from ..ops.kmeans import kmeans
from .base import Index
from .ivf import IndexIVF
from .transforms import RandomRotationMatrix, VectorTransform

THRESH_GLOBAL = "global"
THRESH_CENTROID = "centroid"
THRESH_CENTROID_HALF = "centroid_half"
THRESH_MEDIAN = "median"


class IndexIVFSpectralHash(IndexIVF):
    """IVF over spectral-hash codes (faiss IndexIVFSpectralHash): bit i of
    a vector x in list l is floor((vt(x)_i - c_li) * 2 / period) & 1, the
    thresholds c by ``threshold_type``: zero ("global"), the list
    centroid's projection ("centroid", less period / 4 for
    "centroid_half"), or the median projection of the list's training
    rows ("median"). Distances are the Hamming distances, as f32."""

    def __init__(self, quantizer, d: int, nlist: int, nbit: int,
                 period: float = 10.0, metric: int = D.METRIC_L2,
                 block_size: int = 128, *, device="cuda"):
        super().__init__(quantizer, d, nlist, metric, block_size,
                         device=device)
        if nbit % 8:
            raise ValueError("nbit must be a multiple of 8")
        self.nbit = int(nbit)
        self.period = float(period)
        self.threshold_type = THRESH_GLOBAL
        self.vt: VectorTransform = RandomRotationMatrix(d, nbit,
                                                        device=device)
        self.trained: Optional[np.ndarray] = None     # (nlist, nbit)
        self.by_residual = False

    def replace_vt(self, vt: VectorTransform) -> None:
        """faiss IndexIVFSpectralHash::replace_vt."""
        if vt.d_out != self.nbit or vt.d_in != self.d:
            raise ValueError("vt shape mismatch")
        self.vt = vt

    def train_encoder(self, x: np.ndarray) -> None:
        if not self.vt.is_trained:
            self.vt.train(x)
        tt = self.threshold_type
        if tt == THRESH_GLOBAL:
            self.trained = np.zeros((self.nlist, self.nbit), np.float32)
            return
        if tt in (THRESH_CENTROID, THRESH_CENTROID_HALF):
            tr = self.vt.apply(self._coarse_centroids()).cpu().numpy()
            if tt == THRESH_CENTROID_HALF:
                tr = tr - 0.25 * self.period
            self.trained = tr.astype(np.float32)
            return
        if tt != THRESH_MEDIAN:
            raise ValueError(f"bad threshold_type {tt!r}")
        assign = np.asarray(self._assign(x), np.int64)
        z = np.asarray(self.vt.apply(x), np.float32)
        tr = np.zeros((self.nlist, self.nbit), np.float32)
        order = np.argsort(assign, kind="stable")
        a_s, z_s = assign[order], z[order]
        starts = np.searchsorted(a_s, np.arange(self.nlist))
        ends = np.searchsorted(a_s, np.arange(self.nlist) + 1)
        for lst in range(self.nlist):
            if ends[lst] > starts[lst]:
                tr[lst] = np.median(z_s[starts[lst]:ends[lst]], axis=0)
        self.trained = tr

    def _trained_dev(self) -> torch.Tensor:
        return torch.as_tensor(self.trained, device=self.device)

    def _encode(self, x, assign) -> torch.Tensor:
        """(n, nbit / 8) uint8 codes of rows x in lists ``assign``."""
        z = self.vt.apply(self._to_device(np.asarray(x, np.float32)))
        a = torch.as_tensor(np.asarray(assign, np.int64), device=self.device)
        return H.pack_bits(ivf_scan.hash_bits(z, self._trained_dev()[a],
                                              self.period))

    def _pack(self, x, ids, assign):
        return ivf_scan.pack_code_invlists(
            self._encode(x, assign), ids, assign, self.nlist,
            self.block_size, device=self.device)

    def _scan_probes(self, xq_dev: torch.Tensor, probes: torch.Tensor,
                     k: int, mnb: Optional[int] = None, id_mask=None):
        """The Hamming scan of the probed lists' codes (every entry point's
        scan). Returns (D, I, ndis)."""
        return ivf_scan.scan_invlists_hash(
            self.vt.apply(xq_dev), probes, self.invlists,
            self._trained_dev(), self.period, k,
            max_nblocks=mnb or self._default_capped_mnb(), id_mask=id_mask)

    def _range_lists(self):
        raise NotImplementedError(
            "IndexIVFSpectralHash has no range search (as the reference)")

    # standalone codec: the list number, then the binarized code (the
    # reference's encode_vectors(include_listnos)); the binarization is not
    # invertible, so decoding raises, as there (:113-115)
    def _sa_payload_size(self) -> int:
        return (self.nbit + 7) // 8

    def _sa_encode_payload(self, x, assign) -> np.ndarray:
        return self._encode(x, assign).cpu().numpy()

    def _sa_decode_payload(self, payload, listno) -> np.ndarray:
        raise NotImplementedError(
            "IndexIVFSpectralHash codes cannot be decoded")


class IndexIVFIndependentQuantizer(Index):
    """The coarse quantization on the raw vectors, the payload IVF on a
    transformed view (faiss IndexIVFIndependentQuantizer): the lists are
    the quantizer's, the codes the payload's, so a small code need not
    cost the assignment its quality."""

    def __init__(self, quantizer: Index, index_ivf: IndexIVF,
                 vt: Optional[VectorTransform] = None):
        super().__init__(quantizer.d, index_ivf.metric_type,
                         device=index_ivf.device)
        if vt is not None and (vt.d_in != quantizer.d
                               or vt.d_out != index_ivf.d):
            raise ValueError("vt dimensions inconsistent")
        if vt is None and quantizer.d != index_ivf.d:
            raise ValueError("need a vt when dimensions differ")
        self.quantizer = quantizer
        self.index_ivf = index_ivf
        self.vt = vt
        self.is_trained = False

    @property
    def nprobe(self) -> int:
        return self.index_ivf.nprobe

    @nprobe.setter
    def nprobe(self, v: int) -> None:
        self.index_ivf.nprobe = v

    def _transform(self, x):
        return x if self.vt is None else self.vt.apply(x)

    def _probes(self, x, n: int) -> torch.Tensor:
        """The quantizer's n nearest lists of each row, on the device."""
        if hasattr(self.quantizer, "search_device"):
            return self.quantizer.search_device(self._to_device(x), n)[1]
        _, a = self.quantizer.search(x, n)
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def train(self, x) -> None:
        """The quantizer's k-means on the raw rows (unless it holds
        centroids), then the transform, then the payload's encoder on the
        transformed rows (IndexIVFIndependentQuantizer::train). The
        payload's own quantizer gets a k-means of the transformed rows, as
        the reference's does; only preassigned adds and searches use it."""
        x = self._check_input(x)
        ivf = self.index_ivf
        ivf.quantizer_trains_alone = 1
        if self.quantizer.ntotal == 0:
            cents, _ = kmeans(x, ivf.nlist, ivf.cp, self.metric_type,
                              device=self.device)
            self.quantizer.train(cents)
            self.quantizer.add(cents)
        if self.vt is not None and not self.vt.is_trained:
            self.vt.train(x)
        xt = np.asarray(self._transform(x), np.float32)
        ivf.quantizer.reset()
        c2, _ = kmeans(xt, ivf.nlist, ivf.cp, self.metric_type,
                       device=self.device)
        ivf.quantizer.train(c2)
        ivf.quantizer.add(c2)
        ivf.train_encoder(xt)
        ivf.is_trained = True
        self.is_trained = True

    def add(self, x) -> None:
        from ..utils.contrib import add_preassigned

        x = self._check_input(x)
        a = self._probes(x, 1)[:, 0].cpu().numpy()
        add_preassigned(self.index_ivf,
                        np.asarray(self._transform(x), np.float32), a)
        self.ntotal = self.index_ivf.ntotal

    def search(self, x, k: int, *, params=None):
        x = self._to_device(self._check_input(x))
        probes = self._probes(x, self.index_ivf.nprobe)
        return self.index_ivf.search_preassigned(self._transform(x), k,
                                                 probes)

    def reset(self) -> None:
        self.index_ivf.reset()
        self.ntotal = 0
