"""Port twin of tests/test_io_sweep.py for tpu_ann_torch.utils.index_io:
every index class the port registers round-trips through write_index /
read_index (and read_index(mmap=True)) and searches identically after the
reload, on the CPU; every index class the port exports is registered."""

import os

import numpy as np
import pytest

import tpu_ann_torch as T
from tpu_ann_torch.utils import index_io

D_, NB, NQ, NT = 32, 600, 20, 800


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(5)
    xt = rs.randn(NT, D_).astype(np.float32)
    xb = rs.randn(NB, D_).astype(np.float32)
    xq = rs.randn(NQ, D_).astype(np.float32)
    return xt, xb, xq


def _build(name, xt, xb, path):
    """One representative instance per registered class name."""
    dev = "cpu"
    flat = T.IndexFlat(D_, device=dev)
    if name == "IndexFlat1D":
        idx = T.IndexFlat1D(device=dev)
        idx.add(xb[:, :1].copy())
        return idx
    if name == "IndexFlat":
        idx = flat
    elif name in ("IndexFlatL2", "IndexFlatIP"):
        idx = getattr(T, name)(D_, device=dev)
    elif name in ("IndexHNSW", "IndexHNSWFlat"):
        idx = getattr(T, name)(D_, 8, device=dev)
    elif name in ("IndexIVF", "IndexIVFFlat"):
        idx = getattr(T, name)(flat, D_, 8, device=dev)
    elif name == "IndexIVFFlatDedup":
        idx = T.IndexIVFFlatDedup(flat, D_, 8, device=dev)
        xb = np.concatenate([xb, xb[:50]])          # 50 duplicates
    elif name == "IndexIVFHNSW":
        idx = T.IndexIVFHNSW(D_, 8, M=8, device=dev)
    elif name == "IndexIVFFlatPaged":
        idx = T.IndexIVFFlatPaged(D_, 8, path, device=dev)
        idx.cp_niter = 4
    elif name == "IndexScalarQuantizer":
        idx = T.IndexScalarQuantizer(D_, T.QT_8BIT, device=dev)
    elif name == "IndexIVFScalarQuantizer":
        idx = T.IndexIVFScalarQuantizer(flat, D_, 8, T.QT_8BIT, device=dev)
    else:
        raise KeyError(name)
    if hasattr(idx, "cp"):
        idx.cp.niter = 4
    if hasattr(idx, "nprobe"):
        idx.nprobe = 4
    idx.train(xt)
    idx.add(xb)
    return idx


_ALL = sorted(index_io._DUMPERS)


def test_every_model_class_is_registered():
    """Every index class tpu_ann_torch.models exports has a serializer."""
    import tpu_ann_torch.models as M

    missing = [name for name in dir(M)
               if isinstance(getattr(M, name), type)
               and issubclass(getattr(M, name), M.Index)
               and name != "Index" and name not in index_io._DUMPERS]
    assert not missing, f"unserializable index classes: {missing}"


@pytest.mark.parametrize("mmap", [False, True])
@pytest.mark.parametrize("name", _ALL)
def test_roundtrip(name, mmap, data, tmp_path):
    xt, xb, xq = data
    idx = _build(name, xt, xb, str(tmp_path / "paged"))
    p = os.path.join(tmp_path, f"{name}.tann")
    index_io.write_index(idx, p)
    idx2 = index_io.read_index(p, mmap=mmap, device="cpu")
    assert idx2.metric_type == idx.metric_type
    assert idx2.ntotal == idx.ntotal
    q = xq[:, :1].copy() if name == "IndexFlat1D" else xq
    D1, I1 = idx.search(q, 4)
    D2, I2 = idx2.search(q, 4)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)
    if hasattr(idx, "instances"):
        assert idx.instances and idx2.instances == idx.instances
