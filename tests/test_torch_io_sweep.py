"""Port twin of tests/test_io_sweep.py for tpu_ann_torch.utils.index_io:
every index class the port registers round-trips through write_index /
read_index (and read_index(mmap=True)) and searches identically after the
reload, on the CPU (the HNSW storages on their tile routes); every index
class the port exports is registered;
and the PQ / refine files (IxPQ, IwPQ, IwPR, IxRF, IxRT) and the codec
files (IxRQ, IwRQ, IxCQ, IxQN, IxLt) that one package writes, the other
reads and searches alike."""

import os

import numpy as np
import pytest

import tpu_ann_torch as T
from tpu_ann_torch.utils import index_io
from torch_parity import assert_topk_equal

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
    elif name == "IndexPQ":
        idx = T.IndexPQ(D_, 4, 6, device=dev)
    elif name == "IndexIVFPQ":
        idx = T.IndexIVFPQ(flat, D_, 8, 4, 6, device=dev)
    elif name == "IndexIVFPQR":
        idx = T.IndexIVFPQR(flat, D_, 8, 4, 6, 4, 6, device=dev)
    elif name in ("IndexRefine", "IndexRefineFlat"):
        idx = T.IndexRefineFlat(T.IndexPQ(D_, 4, 6, device=dev))
    elif name == "IndexRefineSQ8Tier":
        idx = T.IndexRefineSQ8Tier(T.IndexPQ(D_, 4, 6, device=dev))
    elif name == "IndexHNSWSQ":
        # the "sq8" tiles (built at the first search)
        idx = T.IndexHNSWSQ(D_, "sq8", 8, device=dev)
        idx.hnsw.tile_threshold = 100
    elif name == "IndexHNSWPQ":
        # the PQ tiles, built at the add: the raw rows dropped
        idx = T.IndexHNSWPQ(D_, 4, 8, 6, device=dev)
        idx.hnsw.tile_threshold = 100
    elif name == "IndexHNSW2Level":
        idx = T.IndexHNSW2Level(D_, 8, 4, 8, 6, device=dev)
    elif name == "Index2Layer":
        idx = T.Index2Layer(flat, 8, 4, 6)
    elif name == "IndexPreTransform":
        idx = T.IndexPreTransform(T.RandomRotationMatrix(D_, D_, device=dev),
                                  flat)
    elif name in ("IndexIDMap", "IndexIDMap2"):
        idx = getattr(T, name)(flat)
        idx.add_with_ids(xb, np.arange(len(xb)) * 7 + 3)
        return idx
    elif name in _AQ:
        # a random codec of 6-bit stages stands in for training (the
        # k-means and ICM passes are tested in test_torch_rq.py)
        books = np.random.RandomState(1).randn(
            4 if "Product" in name else 3, 64, D_).astype(np.float32) * 0.4
        if "IVF" in name:
            flat.add(xt[:8])
            shape = (2, 2) if "Product" in name else (3,)
            idx = getattr(T, name)(flat, D_, 8, *shape, 6, device=dev)
            idx.quantizer_trains_alone = 1
            idx.nprobe = 4
        elif name.endswith("CoarseQuantizer"):
            idx = getattr(T, name)(D_, 2, 3, device=dev)
            idx.set_codebooks(books[:2, :8])
            return idx              # a virtual database: nothing to add
        else:
            shape = (2, 2) if "Product" in name else (3,)
            idx = getattr(T, name)(D_, *shape, 6, device=dev)
        idx._set_codec(books)
        idx.is_trained = True
        idx.add(xb)
        return idx
    elif name == "IndexQINCo":
        idx = T.IndexQINCo(D_, 16, 1, 3, 16, device=dev)
    elif name == "IndexLattice":
        idx = T.IndexLattice(D_, 4, 4, 6, device=dev)
    elif name in ("IndexShards", "IndexReplicas"):
        idx = getattr(T, name)(D_, device=dev)
        for _ in range(2):
            (idx.add_shard if name == "IndexShards" else idx.add_replica)(
                T.IndexFlat(D_, device=dev))
        idx.add(xb)
        return idx
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
_AQ = [n for n in _ALL if n.endswith(("Quantizer", "QuantizerR"))
       and ("Residual" in n or "LocalSearch" in n or "Additive" in n)]


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
    if hasattr(idx, "hnsw"):             # search knobs are not in the file
        idx2.hnsw.__dict__.update(idx.hnsw.__dict__)
    q = xq[:, :1].copy() if name == "IndexFlat1D" else xq
    D1, I1 = idx.search(q, 4)
    D2, I2 = idx2.search(q, 4)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)
    if hasattr(idx, "instances"):
        assert idx.instances and idx2.instances == idx.instances


# -- the PQ / refine tags across the two packages -----------------------------

CROSS = {"IxPQ": "IndexPQ", "IwPQ": "IndexIVFPQ", "IwPR": "IndexIVFPQR",
         "IxRF": "IndexRefineFlat", "IxRT": "IndexRefineSQ8Tier",
         "IxRQ": "IndexResidualQuantizer",
         "IwRQ": "IndexIVFResidualQuantizer",
         "IxCQ": "ResidualCoarseQuantizer", "IxQN": "IndexQINCo",
         "IxLt": "IndexLattice"}


def _jax_build(name, xt, xb):
    from tpu_ann import models as JM
    from tpu_ann.models import lattice as JL
    from tpu_ann.models import qinco as JQ
    from tpu_ann.models import rq as JRQ
    from tpu_ann.models.flat import IndexFlat as JFlat

    if name == "IndexPQ":
        idx = JM.IndexPQ(D_, 4, 6)
    elif name == "IndexIVFPQ":
        idx = JM.IndexIVFPQ(JFlat(D_), D_, 8, 4, 6)
    elif name == "IndexIVFPQR":
        idx = JM.IndexIVFPQR(JFlat(D_), D_, 8, 4, 6, 4, 6)
    elif name == "IndexRefineFlat":
        idx = JM.IndexRefineFlat(JM.IndexPQ(D_, 4, 6))
    elif name == "IndexRefineSQ8Tier":
        idx = JM.IndexRefineSQ8Tier(JM.IndexPQ(D_, 4, 6))
    elif name == "IndexResidualQuantizer":
        idx = JRQ.IndexResidualQuantizer(D_, 3, 6)
    elif name == "IndexIVFResidualQuantizer":
        idx = JRQ.IndexIVFResidualQuantizer(JFlat(D_), D_, 8, 3, 6)
    elif name == "ResidualCoarseQuantizer":
        idx = JRQ.ResidualCoarseQuantizer(D_, 2, 3)
        idx.train(xt)
        return idx
    elif name == "IndexQINCo":
        idx = JQ.IndexQINCo(D_, 16, 1, 3, 16)
        idx.add(xb)
        return idx
    else:
        idx = JL.IndexLattice(D_, 4, 4, 6)
    if hasattr(idx, "cp"):
        idx.cp.niter = 4
    if hasattr(idx, "nprobe"):
        idx.nprobe = 4
        idx.max_list_scan_factor = 0
    idx.train(xt)
    idx.add(xb)
    return idx


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("tag", sorted(CROSS))
def test_pq_refine_files_cross_packages(tag, writer, data, tmp_path):
    """A file one package writes, the other reads (the codec tags too):
    the same class, codes and codebooks, and the same search (ids overlapping >= 0.95, the
    distances of common ids within rtol 1e-5: the JAX index scans its
    decoded cache query-major on the CPU, the port through K3's plain
    version, and each rounds its own way near a tie)."""
    from tpu_ann.utils import index_io as jio

    xt, xb, xq = data
    name = CROSS[tag]
    p = str(tmp_path / f"{tag}.tann")
    if writer == "jax":
        src = _jax_build(name, xt, xb)
        jio.write_index(src, p)
        dst = index_io.read_index(p, device="cpu")
        jidx, tidx = src, dst
    else:
        src = _build(name, xt, xb, None)
        index_io.write_index(src, p)
        dst = jio.read_index(p)
        jidx, tidx = dst, src
    assert index_io._read_container(p)[0]["tag"] == tag
    assert type(dst).__name__ == type(src).__name__
    assert dst.ntotal == src.ntotal == (64 if tag == "IxCQ" else NB)
    if hasattr(jidx, "max_list_scan_factor"):
        jidx.max_list_scan_factor = 0
    D0, I0 = jidx.search(xq, 10)
    D1, I1 = tidx.search(xq, 10)
    if tag in ("IxQN", "IxLt", "IxCQ"):
        # small codebooks decode many rows alike: ids equal up to ties
        assert_topk_equal(D0, I0, D1, I1, rtol=1e-5, atol=1e-5)
        return
    ov = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(I0, I1)])
    assert ov >= 0.95, ov
    for q in range(NQ):
        m0 = dict(zip(I0[q], D0[q]))
        for i, dd in zip(I1[q], D1[q]):
            if i in m0:
                np.testing.assert_allclose(dd, m0[i], rtol=1e-5)
