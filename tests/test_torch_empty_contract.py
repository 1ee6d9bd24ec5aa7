"""The port's empty-result contract (faiss's): a search of no queries
returns (0, k) arrays; a search for more neighbours than the index holds
returns (nq, k), the empty slots padded with id -1 and the metric's worst
value; an IVF that holds no rows (never added to, added zero rows, or
reset) answers every query with such slots.

The reference raises at most of these points (ROADMAP, "Faults of the
reference, not copied"), so the contract itself is the oracle here. Every
index class the port serializes is built as `test_torch_io_sweep` builds
it (d 32, 600 rows, on the CPU), and some factory strings besides."""

import numpy as np
import pytest
import torch

import tpu_ann_torch as T
import test_torch_io_sweep as S

D_ = S.D_
_SPECS = ["Flat", "IVF8,Flat", "IVF8,SQ8", "IVF8,SQ4", "IVF8,SQfp16",
          "IVF8,SQ6", "IVF8,PQ4", "IVF8,PQ4x4", "IVF8,PQ4x4fs", "PQ4", "SQ4",
          "HNSW8", "HNSW8,Flat", "HNSW8,SQ8", "HNSW8,PQ4", "NSG8,Flat",
          "NSG8,PQ4", "NSG8,SQ8", "RQ4x8", "LSQ4x8", "PRQ2x2x8", "PLSQ2x2x8",
          "IVF8,RQ2x8", "IVF8,Flat,RFlat", "IVF8,PQ4,RFlat", "LSH",
          "PCA16,IVF8,Flat", "IVF8_HNSW8,Flat", "IVF8,FlatDedup"]
_REFINE = ["IndexRefine", "IndexRefineFlat", "IndexRefineSQ8Tier"]
_IVF_SPECS = ["IVF8,Flat", "IVF8,SQ8", "IVF8,SQ4", "IVF8,SQfp16", "IVF8,PQ4",
              "IVF8,PQ4x4", "IVF8,RQ2x8", "IVF8,LSQ2x8", "IVF8,PRQ2x2x4",
              "IVF8,FlatDedup", "IVF8_HNSW8,Flat", "PCA16,IVF8,Flat",
              "IVF8,Flat,RFlat", "IVF8,PQ4,RFlat"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # many small torch ops beside other test workers: one thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(5)
    return (rs.randn(S.NT, D_).astype(np.float32),
            rs.randn(S.NB, D_).astype(np.float32),
            rs.randn(S.NQ, D_).astype(np.float32))


def _factory(spec, xt):
    idx = T.index_factory(D_, spec, device="cpu")
    if hasattr(idx, "cp"):
        idx.cp.niter = 4
    if hasattr(idx, "nnd_iters"):
        idx.nnd_iters = 3
    if not idx.is_trained:
        idx.train(xt)
    return idx


def _assert_empty_slots(Dv, Iv, nq, k, worst):
    assert Dv.shape == Iv.shape == (nq, k)
    assert Iv.dtype == np.int64
    assert (Iv == -1).all()
    np.testing.assert_array_equal(Dv, np.full((nq, k), worst, Dv.dtype))


@pytest.mark.parametrize("name", [f"class:{n}" for n in S._ALL]
                         + [f"spec:{s}" for s in _SPECS])
def test_empty_query_batch(name, data, tmp_path):
    """search(x[:0], k) gives (0, k) arrays: float32 distances (int32 for
    the binary indexes) and int64 ids."""
    xt, xb, xq = data
    kind, what = name.split(":")
    if kind == "class":
        idx = S._build(what, xt, xb, str(tmp_path / "p"))
        q = S._queries(what, xq)
    else:
        idx = _factory(what, xt)
        idx.add(xb)
        q = xq
    Dv, Iv = idx.search(q[:0], 10)[:2]
    binary = what.startswith("IndexBinary")
    assert Dv.shape == Iv.shape == (0, 10)
    assert Dv.dtype == (np.int32 if binary else np.float32)
    assert Iv.dtype == np.int64


@pytest.mark.parametrize("name", _REFINE + ["IVF8,Flat,RFlat",
                                            "IVF8,PQ4,RFlat",
                                            "IndexSplitVectors"])
def test_refine_pads_to_k(name, data, tmp_path):
    """The refine indexes (and IndexSplitVectors) at k above ntotal: (nq,
    k), the real rows first (the exact top of all of them), then id -1 at
    the worst value."""
    xt, xb, xq = data
    if name in _REFINE or name == "IndexSplitVectors":
        idx = S._build(name, xt, xb, str(tmp_path / "p"))
    else:
        idx = _factory(name, xt)
        idx.add(xb[:40])
        idx.base_index.nprobe = 8
    n = idx.ntotal
    k = n + 20
    Dv, Iv = idx.search(xq[:5], k)
    assert Dv.shape == Iv.shape == (5, k)
    assert Dv.dtype == np.float32 and Iv.dtype == np.int64
    _assert_empty_slots(Dv[:, n:], Iv[:, n:], 5, k - n, np.inf)
    assert (Iv[:, :n] >= 0).all()
    assert (np.sort(Iv[:, :n], 1) == np.arange(n)).all()
    assert (np.diff(Dv[:, :n], axis=1) >= 0).all()


@pytest.mark.parametrize("mode", ["never", "zero", "reset"])
@pytest.mark.parametrize("spec", _IVF_SPECS)
def test_ivf_without_rows(spec, mode, data):
    """A trained IVF that holds no rows (never added to, add(x[:0]), or
    reset) answers ids -1 at the worst value, then searches as usual
    once rows are added."""
    xt, xb, xq = data
    idx = _factory(spec, xt)
    if mode == "zero":
        idx.add(xb[:0])
        assert idx.ntotal == 0
    elif mode == "reset":
        idx.add(xb)
        idx.reset()
    Dv, Iv = idx.search(xq, 10)
    _assert_empty_slots(Dv, Iv, len(xq), 10, np.inf)
    idx.add(xb)
    Dv, Iv = idx.search(xq, 10)
    assert (Iv >= 0).any()


@pytest.mark.parametrize("mode", ["never", "zero"])
@pytest.mark.parametrize("name", ["IndexBinaryIVF", "IndexIVFFlatPaged"])
def test_own_store_ivf_without_rows(name, mode, data, tmp_path):
    """The binary IVF and the out-of-core IVF, which keep their own
    stores, answer the same empty result without rows."""
    xt, xb, xq = data
    if name == "IndexBinaryIVF":
        f = S._codes
        idx = T.IndexBinaryIVF(None, D_, 4, device="cpu")
        idx.cp.niter = 4
        idx.train(f(xt))
        worst = 32767
    else:
        def f(x):
            return x
        idx = T.IndexIVFFlatPaged(D_, 8, str(tmp_path / "p"), device="cpu")
        idx.cp_niter = 4
        idx.train(xt)
        worst = np.inf
    if mode == "zero":
        idx.add(f(xb[:0]))
    Dv, Iv = idx.search(f(xq), 10)
    _assert_empty_slots(Dv, Iv, len(xq), 10, worst)
