"""Neural-codec indexes — PyTorch counterpart of `tpu_ann/models/qinco.py`
(faiss `IndexNeuralNetCodec.{h,cpp}`: IndexNeuralNetCodec, IndexQINCo).

The codes are bit-packed (M codes of nbits each, `ops.qinco.pack_codes`,
byte-equal to the reference's) and kept as one uint8 tensor on the device.
Search decodes them in blocks on the device (`unpack_codes_device`, then
the codec's `net_decode`) and merges each block's exact f32 k-NN
(`ops.distances.knn`) into a running top-k: the asymmetric distance to the
decoded vectors, IndexFlatCodes::search's semantics. An empty index
returns ids -1 at the metric's worst value (the reference raises), and
``params.sel`` filters the rows (the reference ignores it).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import distances as D
from ..ops import qinco as Q
from ..ops import topk as TK
from .base import Index
from .pq import _sel_mask


class IndexNeuralNetCodec(Index):
    """A flat index over a neural codec (IndexNeuralNetCodec.h).
    Subclasses provide ``net_encode`` (host rows -> (n, M) integer codes)
    and ``net_decode`` ((n, M) int64 device codes -> (n, d) f32 device
    rows), and ``M`` / ``nbits``."""

    def __init__(self, d: int, M: int, nbits: int,
                 metric: int = D.METRIC_L2, *, device="cuda"):
        super().__init__(d, metric, device=device)
        self.M = int(M)
        self.nbits = int(nbits)
        self.decode_block = 65536
        self.reset()

    def net_encode(self, x: np.ndarray):
        raise NotImplementedError

    def net_decode(self, codes: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # --- codec API --------------------------------------------------------
    def sa_code_size(self) -> int:
        return -(-self.M * self.nbits // 8)

    def sa_encode(self, x) -> np.ndarray:
        codes = self.net_encode(self._check_input(x))
        if isinstance(codes, torch.Tensor):
            codes = codes.cpu().numpy()
        return Q.pack_codes(codes, self.nbits)

    def _decode_packed(self, packed: torch.Tensor) -> torch.Tensor:
        return self.net_decode(Q.unpack_codes_device(
            packed.to(self.device), self.M, self.nbits))

    def sa_decode(self, codes) -> np.ndarray:
        packed = torch.from_numpy(np.ascontiguousarray(codes, np.uint8))
        return self._decode_packed(packed).cpu().numpy()

    # --- index API --------------------------------------------------------
    def add(self, x) -> None:
        if not self.is_trained:
            raise RuntimeError("codec not ready")
        codes = torch.from_numpy(self.sa_encode(x)).to(self.device)
        self._codes = torch.cat([self._codes, codes])
        self.ntotal = len(self._codes)

    def reset(self) -> None:
        self._codes = torch.zeros((0, self.sa_code_size()),
                                  dtype=torch.uint8, device=self.device)
        self.ntotal = 0

    def reconstruct_n(self, i0: int, ni: int) -> np.ndarray:
        return self._decode_packed(self._codes[i0:i0 + ni]).cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        if not 0 <= key < self.ntotal:
            raise KeyError(key)
        return self.reconstruct_n(int(key), 1)[0]

    def range_search(self, x, radius: float):
        """The exact distance to the decoded rows (IndexFlatCodes.h:65)."""
        from ..ops.range_search import range_search_decoded

        x = self._check_input(x)
        if self.ntotal == 0:
            return (np.zeros(len(x) + 1, np.int64), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        res = range_search_decoded(
            x, lambda i0, i1: self._decode_packed(self._codes[i0:i1]),
            self.ntotal, radius, self.metric_type,
            db_block=self.decode_block)
        return res.lims, res.distances, res.labels

    def search(self, x, k: int, *, params: Optional[object] = None):
        """Block-wise decode and exact f32 k-NN merge (reference
        :80-104)."""
        x = self._check_input(x)
        bad = D.worst_value(self.metric_type)
        nq = len(x)
        if self.ntotal == 0:
            return (np.full((nq, k), bad, np.float32),
                    np.full((nq, k), -1, np.int64))
        xq = self._to_device(x)
        id_mask = _sel_mask(params, self.ntotal, self.device)
        sim = self.is_similarity
        bd = torch.full((nq, k), bad, device=self.device)
        bi = torch.full((nq, k), -1, dtype=torch.long, device=self.device)
        for i0 in range(0, self.ntotal, self.decode_block):
            xb = self._decode_packed(self._codes[i0:i0 + self.decode_block])
            dis, idx = D.knn(xq, xb, k, self.metric_type,
                             id_mask=None if id_mask is None
                             else id_mask[i0:i0 + len(xb)])
            idx = torch.where(idx >= 0, idx + i0, -1)
            bd, bi = TK.merge_topk(bd, bi, dis, idx, k, similarity=sim)
        return bd.cpu().numpy(), bi.cpu().numpy()


class IndexQINCo(IndexNeuralNetCodec):
    """faiss IndexQINCo (IndexNeuralNetCodec.h:37-56): the QINCo codec of
    M - 1 refinement steps. ``qinco`` is an `ops.qinco.QINCo` module
    (`QINCo.random` by default, the reference's deterministic init; load
    trained weights with ``qinco.load_state_dict``); it is moved to the
    index's device."""

    def __init__(self, d: int, K: int, L: int, M: int, h: int,
                 metric: int = D.METRIC_L2,
                 qinco: Optional[Q.QINCo] = None, *, device="cuda"):
        nbits = int(np.ceil(np.log2(K)))
        super().__init__(d, M, nbits, metric, device=device)
        self.K, self.L, self.h = int(K), int(L), int(h)
        self.qinco = (qinco or Q.QINCo.random(d, K, L, M, h)).to(
            self.device)
        self.encode_chunk = 4096

    def net_encode(self, x: np.ndarray) -> torch.Tensor:
        return Q.encode_chunked(self.qinco, x, chunk=self.encode_chunk)

    def net_decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.qinco.decode(codes)
