"""Port parity: tpu_ann_torch.models.transforms against the JAX package,
on the CPU.

Training runs the reference's host numpy code with the same seeds, so A
(and b) of PCA / PCAR / PCAW / RR / ITQ must be within 1e-6 of the
reference's; apply / reverse_transform (one f32 product in either
package) within rtol 1e-5. OPQ fits its PQs with the port's ops.pq, so
its rotation differs: the quantization MSE of the data rotated by each
package's A (one PQ fit, the same code, for both) must be within 1%, at
niter 2. IndexPreTransform over the same chain and the same rows returns
the reference's (D, I) within rtol / atol 1e-4 (the transformed rows
differ in the last bits, and a squared distance adds 32 of them), ids
equal up to ties, and hands its sub-index the transformed queries as a
device tensor."""

import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from torch_parity import assert_topk_equal
from tpu_ann.models import transforms as JT
from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann_torch.models import transforms as TT
from tpu_ann_torch.utils import convert

D, NT, NB, NQ, K = 32, 3000, 2000, 50, 10


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(7)
    basis = rs.randn(D, D).astype(np.float32)
    scale = np.linspace(3.0, 0.1, D).astype(np.float32)
    xt = (rs.randn(NT, D).astype(np.float32) * scale) @ basis + 1.5
    xb = (rs.randn(NB, D).astype(np.float32) * scale) @ basis + 1.5
    xq = (rs.randn(NQ, D).astype(np.float32) * scale) @ basis + 1.5
    return xt, xb, xq


LINEAR = {
    "PCA16": lambda m: m.PCAMatrix(D, 16),
    "PCAR16": lambda m: m.PCAMatrix(D, 16, random_rotation=True),
    "PCAW16": lambda m: m.PCAMatrix(D, 16, eigen_power=-0.5),
    "PCA32": lambda m: m.PCAMatrix(D, 32),
    "RR32": lambda m: m.RandomRotationMatrix(D, D),
    "RR16": lambda m: m.RandomRotationMatrix(D, 16),
    "RR48": lambda m: m.RandomRotationMatrix(D, 48),
    "ITQ": lambda m: m.ITQMatrix(D, niter=5),
}


def _pair(name, xt):
    j, t = LINEAR[name](JT), LINEAR[name](TT)
    t.device = torch.device("cpu")
    j.train(xt)
    t.train(xt)
    return j, t


@pytest.mark.parametrize("name", sorted(LINEAR))
def test_linear_matrix_equals_reference(name, data):
    xt, xb, _ = data
    j, t = _pair(name, xt)
    np.testing.assert_allclose(t.A, j.A, atol=1e-6, rtol=0)
    if j.b is None:
        assert t.b is None
    else:
        np.testing.assert_allclose(t.b, j.b, atol=1e-6, rtol=1e-6)
    assert t.is_orthonormal == j.is_orthonormal
    assert (t.d_in, t.d_out) == (j.d_in, j.d_out)
    y0, y1 = j.apply(xb), t.apply(xb)
    assert isinstance(y1, np.ndarray) and y1.dtype == np.float32
    np.testing.assert_allclose(y1, y0, rtol=1e-5, atol=1e-5)
    # a tensor stays a tensor, with the same values
    yt = t.apply(torch.from_numpy(xb))
    np.testing.assert_array_equal(yt.numpy(), y1)
    if j.is_orthonormal:
        r0, r1 = j.reverse_transform(y0), t.reverse_transform(y1)
        np.testing.assert_allclose(r1, r0, rtol=1e-5, atol=1e-4)
    else:
        for vt in (j, t):
            with pytest.raises(NotImplementedError):
                vt.reverse_transform(y0)


def test_pca_eigenvalues_and_mean(data):
    xt, _, _ = data
    j, t = _pair("PCAW16", xt)
    np.testing.assert_allclose(t.eigenvalues, j.eigenvalues, rtol=1e-6)
    np.testing.assert_allclose(t.mean, j.mean, rtol=1e-12)


@pytest.mark.parametrize("name", ["center", "l2norm", "l1norm", "remap",
                                  "remap_first"])
def test_nonlinear_transforms(name, data):
    xt, xb, _ = data
    make = {"center": lambda m: m.CenteringTransform(D),
            "l2norm": lambda m: m.NormalizationTransform(D),
            "l1norm": lambda m: m.NormalizationTransform(D, 1.0),
            "remap": lambda m: m.RemapDimensionsTransform(D, 20),
            "remap_first": lambda m: m.RemapDimensionsTransform(
                D, 40, uniform=False)}[name]
    j, t = make(JT), make(TT)
    t.device = torch.device("cpu")
    j.train(xt)
    t.train(xt)
    np.testing.assert_allclose(t.apply(xb), j.apply(xb), rtol=1e-5,
                               atol=1e-6)
    if name == "center":
        np.testing.assert_allclose(t.reverse_transform(t.apply(xb)), xb,
                                   rtol=1e-5, atol=1e-5)


def _pq_mse(A, x, M):
    """Quantization MSE of x rotated by A under one PQ fit (the port's)."""
    from tpu_ann_torch.ops import pq as PQ

    xr = torch.from_numpy(x @ A.T)
    codec = PQ.train_pq(xr.numpy(), M, 8, niter=4, device="cpu")
    cent = PQ.as_centroids(codec.centroids, "cpu")
    rec = PQ.pq_decode(PQ.pq_encode(xr, cent), cent)
    return float(((rec - xr) ** 2).sum(1).mean())


@pytest.mark.parametrize("d_out", [0, 16])
def test_opq_rotation_quality(d_out, data):
    xt, _, _ = data
    j, t = JT.OPQMatrix(D, 4, d_out), TT.OPQMatrix(D, 4, d_out, device="cpu")
    j.niter = t.niter = 2
    j.train(xt)
    t.train(xt)
    assert t.A.shape == j.A.shape == (d_out or D, D)
    np.testing.assert_allclose(t.A @ t.A.T, np.eye(d_out or D), atol=1e-5)
    m0, m1 = _pq_mse(j.A, xt, 4), _pq_mse(t.A, xt, 4)
    assert abs(m1 - m0) <= 0.01 * m0, (m0, m1)
    if not d_out:
        # a rotation keeps the energy: it beats the random start it began
        # from (a projection to fewer dimensions drops some, and its MSE
        # is not comparable)
        rs = np.random.RandomState(1234)
        u, _, vt = np.linalg.svd(rs.randn(D, D), full_matrices=False)
        assert m1 < _pq_mse((u @ vt).astype(np.float32), xt, 4)


def _chain_state(jidx):
    return [(type(vt).__name__, vars(vt)) for vt in jidx.chain]


@pytest.mark.parametrize("chain", ["PCA16", "PCAW16", "RR32", "ITQ",
                                   "PCA16+RR16"])
def test_pretransform_search_equals_reference(chain, data):
    xt, xb, xq = data
    names = chain.split("+")
    jchain = [LINEAR[names[0]](JT)]
    if len(names) > 1:
        jchain.append(JT.RandomRotationMatrix(16, 16))
    jidx = JT.IndexPreTransform(*jchain, JFlat(jchain[-1].d_out))
    jidx.train(xt)
    jidx.add(xb)
    # the port trains the same chain itself ...
    tchain = [LINEAR[names[0]](TT)]
    if len(names) > 1:
        tchain.append(TT.RandomRotationMatrix(16, 16))
    tidx = TT.IndexPreTransform(
        *tchain, T.IndexFlat(tchain[-1].d_out, device="cpu"))
    tidx.train(xt)
    tidx.add(xb)
    for a, b in zip(tidx.chain, jidx.chain):
        np.testing.assert_allclose(a.A, b.A, atol=1e-6)
    D0, I0 = jidx.search(xq, K)
    D1, I1 = tidx.search(xq, K)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1, rtol=1e-4,
                      atol=1e-4)
    # ... and carries the reference's chain over, bit for bit in A
    flat = T.IndexFlat(tchain[-1].d_out, device="cpu")
    flat.add(jidx._apply_chain(xb))
    cidx = convert.pretransform_from_reference(_chain_state(jidx), flat)
    assert [type(t).__name__ for t in cidx.chain] == \
        [type(t).__name__ for t in jidx.chain]
    for a, b in zip(cidx.chain, jidx.chain):
        np.testing.assert_array_equal(a.A, b.A)
    D2, I2 = cidx.search(xq, K)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D2, I2, rtol=1e-4,
                      atol=1e-4)


def test_pretransform_keeps_queries_on_device(data, monkeypatch):
    """The transformed queries reach an IndexFlat / IVF sub-index as a
    tensor on the index's device; other sub-indexes get numpy."""
    xt, xb, xq = data
    seen = []
    for sub in (T.IndexFlat(16, device="cpu"),
                T.IndexHNSWFlat(16, 8, device="cpu")):
        idx = TT.IndexPreTransform(TT.PCAMatrix(D, 16, device="cpu"), sub)
        idx.train(xt)
        idx.add(xb)
        orig = type(sub).search

        def spy(self, x, k, *, params=None, orig=orig):
            seen.append(type(x))
            return orig(self, x, k, params=params)

        monkeypatch.setattr(type(sub), "search", spy)
        idx.search(xq, K)
        monkeypatch.undo()
    assert seen == [torch.Tensor, np.ndarray]


def test_pretransform_api(data):
    """add_with_ids / remove_ids / range_search / reconstruct / reset
    forward through the chain (an orthonormal chain reconstructs the
    rows)."""
    xt, xb, xq = data
    ivf = T.IndexIVFFlat(T.IndexFlat(D, device="cpu"), D, 8, device="cpu")
    ivf.cp.niter = 4
    idx = TT.IndexPreTransform(TT.RandomRotationMatrix(D, D, device="cpu"),
                               ivf)
    idx.train(xt)
    idx.add_with_ids(xb, np.arange(100, 100 + NB))
    assert idx.ntotal == NB
    np.testing.assert_allclose(idx.reconstruct(105), xb[5], atol=1e-4)
    assert idx.remove_ids(T.IDSelectorRange(100, 150)) == 50
    assert idx.ntotal == NB - 50
    ivf.nprobe = 8
    lims, Dr, Ir = idx.range_search(xq[:5], 5000.0)
    assert len(lims) == 6 and ((Ir >= 150) & (Ir < 100 + NB)).all()
    jt = JT.RandomRotationMatrix(D, D)
    jt.train()
    jf = JFlat(D)
    jf.add(jt.apply(xb[50:]))
    lims0, D0, _ = jf.range_search(jt.apply(xq[:5]), 5000.0)
    np.testing.assert_array_equal(lims, np.asarray(lims0))
    idx.reset()
    assert idx.ntotal == 0 and ivf.ntotal == 0
