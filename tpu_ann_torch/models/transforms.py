"""VectorTransform family and IndexPreTransform — PyTorch counterpart of
`tpu_ann/models/transforms.py` (faiss `VectorTransform.{h,cpp}`:
RandomRotation, PCAMatrix, OPQMatrix, ITQMatrix, NormalizationTransform,
CenteringTransform, RemapDimensionsTransform; `IndexPreTransform.{h,cpp}`).

Training stays where the reference has it: host numpy (float64 ``eigh``
for PCA, ``qr`` / ``svd`` with the same ``RandomState`` seeds), so a
trained ``A`` equals the reference's. OPQ's inner PQ fits run on the
device through `ops.pq`. ``apply`` / ``reverse_transform`` take numpy
arrays or tensors: a tensor is transformed on its own device (one f32
``torch.matmul`` for the linear ones, TF32 off, see `ops.distances`) and
a tensor comes back; a numpy array goes to the transform's ``device`` and
comes back as numpy. `IndexPreTransform` moves the queries to its device
once and keeps the transformed queries there for the sub-indexes that
take device queries (IndexFlat, the IVF family, IndexPQ,
IndexScalarQuantizer).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops import distances as D  # noqa: F401  (sets the f32 matmul mode)
from .base import Index


class VectorTransform:
    """Base: y = apply(x), d_in -> d_out."""

    def __init__(self, d_in: int, d_out: int, *, device="cuda"):
        self.d_in, self.d_out = int(d_in), int(d_out)
        self.is_trained = False
        self.device = torch.device(device)

    def train(self, x: np.ndarray) -> None:
        self.is_trained = True

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _backward(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} has no reverse transform")

    def _run(self, fn, x):
        if isinstance(x, torch.Tensor):
            return fn(x.float())
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return fn(t.to(self.device)).cpu().numpy()

    def apply(self, x):
        return self._run(self._forward, x)

    def reverse_transform(self, y):
        return self._run(self._backward, y)


class LinearTransform(VectorTransform):
    """y = x @ A.T + b (faiss LinearTransform, row-major A (d_out, d_in))."""

    def __init__(self, d_in: int, d_out: int, *, device="cuda"):
        super().__init__(d_in, d_out, device=device)
        self.A: Optional[np.ndarray] = None   # (d_out, d_in)
        self.b: Optional[np.ndarray] = None   # (d_out,)
        self.is_orthonormal = False

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ torch.as_tensor(self.A, device=x.device).T
        if self.b is not None:
            y = y + torch.as_tensor(self.b, device=x.device)
        return y

    def _backward(self, y: torch.Tensor) -> torch.Tensor:
        if not self.is_orthonormal:
            raise NotImplementedError("reverse only for orthonormal A")
        if self.b is not None:
            y = y - torch.as_tensor(self.b, device=y.device)
        return y @ torch.as_tensor(self.A, device=y.device)


class RandomRotationMatrix(LinearTransform):
    """Orthonormal random rotation (faiss RandomRotationMatrix)."""

    def __init__(self, d_in: int, d_out: int, seed: int = 1234, *,
                 device="cuda"):
        super().__init__(d_in, d_out, device=device)
        self.seed = seed

    def train(self, x: Optional[np.ndarray] = None) -> None:
        rs = np.random.RandomState(self.seed)
        # d_out > d_in embeds into the larger space then rotates there
        # (faiss RandomRotationMatrix::init with d_out > d_in)
        dd = max(self.d_in, self.d_out)
        q, _ = np.linalg.qr(rs.randn(dd, dd))   # orthogonal (dd, dd)
        self.A = q.T[: self.d_out, : self.d_in].astype(np.float32)
        self.is_orthonormal = self.d_out <= self.d_in
        self.is_trained = True


class PCAMatrix(LinearTransform):
    """PCA with optional whitening / random rotation in PCA space (faiss
    PCAMatrix: eigen_power, random_rotation)."""

    def __init__(self, d_in: int, d_out: int, eigen_power: float = 0.0,
                 random_rotation: bool = False, *, device="cuda"):
        super().__init__(d_in, d_out, device=device)
        self.eigen_power = float(eigen_power)
        self.random_rotation = bool(random_rotation)
        self.mean: Optional[np.ndarray] = None
        self.eigenvalues: Optional[np.ndarray] = None

    def train(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, np.float64)
        self.mean = x.mean(axis=0)
        xc = x - self.mean
        cov = xc.T @ xc / len(x)
        w, v = np.linalg.eigh(cov)             # ascending
        order = np.argsort(-w)
        w = np.maximum(w[order], 1e-12)
        v = v[:, order]                        # columns = PCs
        A = v[:, : self.d_out].T               # (d_out, d_in)
        if self.eigen_power != 0.0:
            # eigen_power=-0.5 -> whitening: scale component i by w_i^-0.5
            A = A * (w[: self.d_out, None] ** self.eigen_power)
        if self.random_rotation:
            rr = RandomRotationMatrix(self.d_out, self.d_out)
            rr.train()
            A = rr.A @ A
        self.A = A.astype(np.float32)
        self.b = (-(self.mean @ A.T)).astype(np.float32)
        self.eigenvalues = w.astype(np.float32)
        self.is_orthonormal = (self.eigen_power == 0.0
                               and not self.random_rotation)
        self.is_trained = True


class CenteringTransform(VectorTransform):
    """Subtract the mean (faiss CenteringTransform)."""

    def __init__(self, d: int, *, device="cuda"):
        super().__init__(d, d, device=device)
        self.mean: Optional[np.ndarray] = None

    def train(self, x: np.ndarray) -> None:
        self.mean = np.ascontiguousarray(x, np.float32).mean(axis=0)
        self.is_trained = True

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return x - torch.as_tensor(self.mean, device=x.device)

    def _backward(self, y: torch.Tensor) -> torch.Tensor:
        return y + torch.as_tensor(self.mean, device=y.device)


class NormalizationTransform(VectorTransform):
    """L_norm row normalization (faiss NormalizationTransform, norm=2)."""

    def __init__(self, d: int, norm: float = 2.0, *, device="cuda"):
        super().__init__(d, d, device=device)
        self.norm = norm
        self.is_trained = True

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        n = torch.linalg.vector_norm(x, ord=self.norm, dim=1, keepdim=True)
        return x / n.clamp(min=1e-12)


class RemapDimensionsTransform(VectorTransform):
    """Remap dimensions (faiss RemapDimensionsTransform): a uniform spread
    of d_in over d_out (uniform=True) or the first d_out."""

    def __init__(self, d_in: int, d_out: int, uniform: bool = True, *,
                 device="cuda"):
        super().__init__(d_in, d_out, device=device)
        if uniform:
            self.map = (np.arange(d_out) * d_in // d_out).astype(np.int64)
        else:
            self.map = np.minimum(np.arange(d_out), d_in - 1).astype(np.int64)
        self.is_trained = True

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, torch.as_tensor(self.map, device=x.device)]


class ITQMatrix(LinearTransform):
    """ITQ rotation (faiss ITQMatrix::train): alternate {binarize the
    rotated data, Procrustes to the sign matrix} (Gong & Lazebnik)."""

    def __init__(self, d: int, niter: int = 50, seed: int = 1234, *,
                 device="cuda"):
        super().__init__(d, d, device=device)
        self.niter = niter
        self.seed = seed

    def train(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, np.float32)
        x = x - x.mean(axis=0)
        rs = np.random.RandomState(self.seed)
        q, _ = np.linalg.qr(rs.randn(self.d_in, self.d_in))
        R = q.astype(np.float32)
        for _ in range(self.niter):
            b = np.sign(x @ R)
            b[b == 0] = 1
            u, _, vt = np.linalg.svd(b.T @ x, full_matrices=False)
            R = ((u @ vt).T).astype(np.float32)
        self.A = R.T
        self.is_orthonormal = True
        self.is_trained = True


class OPQMatrix(LinearTransform):
    """OPQ rotation (faiss OPQMatrix::train): alternate {fit a PQ on the
    rotated data, solve the orthogonal Procrustes problem to its
    reconstruction}. The PQ fits, encodes and decodes run on ``device``
    (`ops.pq`); the Procrustes SVDs on the host, as in the reference."""

    def __init__(self, d_in: int, M: int, d_out: int = 0, *, device="cuda"):
        d_out = d_out or d_in
        super().__init__(d_in, d_out, device=device)
        self.M = int(M)
        self.niter = 10       # faiss default 50; the reference's 10
        self.niter_pq = 4
        self.seed = 1234

    def train(self, x: np.ndarray) -> None:
        from ..ops.pq import as_centroids, pq_decode, pq_encode, train_pq

        x = np.ascontiguousarray(x, np.float32)
        n = len(x)
        rs = np.random.RandomState(self.seed)
        # OPQMatrix caps its training set (faiss max_train_points =
        # 256 * 256)
        if n > 65536:
            x = x[rs.choice(n, 65536, replace=False)]
        # init: random orthonormal (d_out, d_in)
        u, _, vt = np.linalg.svd(rs.randn(self.d_out, self.d_in),
                                 full_matrices=False)
        A = (u @ vt).astype(np.float32)
        xd = torch.from_numpy(x).to(self.device)
        for it in range(self.niter):
            xr = xd @ torch.from_numpy(A).to(self.device).T   # (n, d_out)
            codec = train_pq(xr.cpu().numpy(), self.M, 8,
                             niter=self.niter_pq, seed=self.seed + it,
                             device=self.device)
            cent = as_centroids(codec.centroids, self.device)
            recon = pq_decode(pq_encode(xr, cent), cent).cpu().numpy()
            # Procrustes: min_R ||x R^T - recon||, R orthogonal
            u, _, vt = np.linalg.svd(recon.T @ x, full_matrices=False)
            A = (u @ vt).astype(np.float32)
        self.A = A
        self.is_orthonormal = True
        self.is_trained = True


def _takes_device_queries(index) -> bool:
    """The sub-indexes whose search reads a device tensor as it is."""
    from .flat import IndexFlat, IndexFlat1D
    from .ivf import IndexIVF
    from .pq import IndexPQ, IndexScalarQuantizer

    return (isinstance(index, (IndexFlat, IndexIVF, IndexPQ,
                               IndexScalarQuantizer))
            and not isinstance(index, IndexFlat1D))


class IndexPreTransform(Index):
    """A chain of transforms before an index (faiss IndexPreTransform),
    on the sub-index's device."""

    def __init__(self, *args):
        # faiss allows (vt, ..., index) or (index)
        chain: List[VectorTransform] = []
        index: Optional[Index] = None
        for a in args:
            if isinstance(a, VectorTransform):
                chain.append(a)
            else:
                index = a
        if index is None:
            raise ValueError("IndexPreTransform needs a sub-index")
        super().__init__(chain[0].d_in if chain else index.d,
                         index.metric_type, device=index.device)
        self.chain = chain
        self.index = index
        self.ntotal = index.ntotal
        self.is_trained = all(t.is_trained for t in chain) and \
            index.is_trained

    def prepend_transform(self, vt: VectorTransform) -> None:
        self.chain.insert(0, vt)
        self.d = vt.d_in

    def apply_chain(self, x) -> torch.Tensor:
        """The chain applied to x (numpy or a tensor) on the index's
        device."""
        x = self._to_device(self._check_input(x))
        for t in self.chain:
            x = t.apply(x)
        return x

    def train(self, x) -> None:
        x = self._to_device(self._check_input(x))
        for t in self.chain:
            if not t.is_trained:
                t.train(x.cpu().numpy())
            x = t.apply(x)
        self.index.train(x.cpu().numpy())
        self.is_trained = True

    def add(self, x) -> None:
        self.index.add(self.apply_chain(x).cpu().numpy())
        self.ntotal = self.index.ntotal

    def add_with_ids(self, x, ids) -> None:
        """Transform, then the sub-index's add_with_ids (faiss
        IndexPreTransform::add_with_ids)."""
        self.index.add_with_ids(self.apply_chain(x).cpu().numpy(), ids)
        self.ntotal = self.index.ntotal

    def remove_ids(self, sel) -> int:
        n = self.index.remove_ids(sel)
        self.ntotal = self.index.ntotal
        return n

    def search(self, x, k: int, *, params=None):
        """The transformed queries stay on the device for the sub-indexes
        that search device tensors."""
        xt = self.apply_chain(x)
        if not _takes_device_queries(self.index):
            xt = xt.cpu().numpy()
        return self.index.search(xt, k, params=params)

    def range_search(self, x, radius: float):
        """Transform then forward with the radius unchanged, as the
        reference (faiss/IndexPreTransform.h:61: the radius is read in the
        transformed space)."""
        return self.index.range_search(self.apply_chain(x).cpu().numpy(),
                                       radius)

    def reset(self) -> None:
        self.index.reset()
        self.ntotal = 0

    def reconstruct(self, key: int) -> np.ndarray:
        y = torch.from_numpy(np.asarray(self.index.reconstruct(key),
                                        np.float32)[None]).to(self.device)
        for t in reversed(self.chain):
            y = t.reverse_transform(y)
        return y[0].cpu().numpy()
