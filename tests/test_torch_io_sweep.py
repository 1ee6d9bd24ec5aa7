"""Port twin of tests/test_io_sweep.py for tpu_ann_torch.utils.index_io:
every index class the port registers round-trips through write_index /
read_index (and read_index(mmap=True)) and searches identically after the
reload, on the CPU (the HNSW storages on their tile routes); every index
class the port exports is registered;
and the PQ / refine files (IxPQ, IwPQ, IwPR, IxRF, IxRT), the codec files
(IxRQ, IwRQ, IxCQ, IxQN, IxLt) and the 17 files of the binary, graph,
long-tail and IVF-coupling indexes (BxFl ... IwIQ) that one package
writes, the other reads and searches alike."""

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
    elif name in _FAMILIES:
        return _build_family(name, xt, xb)
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


def _codes(x):
    """Binary codes of float rows: their signs, D_ / 8 bytes a row."""
    return np.packbits(x > 0, axis=1)[:, :D_ // 8]


def _build_family(name, xt, xb):
    """The binary, graph, long-tail and IVF-coupling indexes (the JAX
    sweep's instances)."""
    dev = "cpu"
    codes = _codes(xb)
    if name == "IndexBinaryFlat":
        idx = T.IndexBinaryFlat(D_, device=dev)
    elif name == "IndexBinaryIVF":
        idx = T.IndexBinaryIVF(None, D_, 4, device=dev)
        idx.cp.niter = 4
        idx.train(codes[:NT // 2])
    elif name == "IndexBinaryHNSW":
        idx = T.IndexBinaryHNSW(D_, 8, device=dev)
        codes = codes[:200]
    elif name == "IndexBinaryHash":
        idx = T.IndexBinaryHash(D_, 8, device=dev)
    elif name == "IndexBinaryMultiHash":
        idx = T.IndexBinaryMultiHash(D_, 2, 8, device=dev)
    elif name == "IndexBinaryFromFloat":
        idx = T.IndexBinaryFromFloat(T.IndexFlat(D_, device=dev))
    if name.startswith("IndexBinary"):
        idx.add(codes)
        return idx
    if name == "MultiIndexQuantizer":
        idx = T.MultiIndexQuantizer(D_, 2, 4, device=dev)
        idx.train(xt)
        return idx
    if name == "IndexRandom":
        return T.IndexRandom(D_, 100, device=dev)
    if name == "IndexSplitVectors":
        idx = T.IndexSplitVectors(D_, device=dev)
        for _ in range(2):
            idx.add_sub_index(T.IndexFlat(D_ // 2, device=dev))
        idx.add(xb[:100])
        return idx
    if name == "IndexLSH":
        idx = T.IndexLSH(D_, 16, device=dev)
    elif name == "IndexRowwiseMinMax":
        idx = T.IndexRowwiseMinMax(T.IndexFlat(D_, device=dev))
    elif name == "IndexNSGFlat":
        idx = T.IndexNSGFlat(D_, 8, device=dev)
    elif name == "IndexNNDescentFlat":
        idx = T.IndexNNDescentFlat(D_, 8, device=dev)
    elif name == "IndexNSGPQ":
        idx = T.IndexNSGPQ(D_, 4, 8, device=dev)
    elif name == "IndexNSGSQ":
        idx = T.IndexNSGSQ(D_, R=8, device=dev)
    elif name == "IndexIVFSpectralHash":
        idx = T.IndexIVFSpectralHash(T.IndexFlat(D_, device=dev), D_, 8, 16,
                                     device=dev)
        idx.cp.niter = 4
    else:
        payload = T.IndexIVFFlat(T.IndexFlat(16, device=dev), 16, 8,
                                 device=dev)
        payload.cp.niter = 4
        idx = T.IndexIVFIndependentQuantizer(
            T.IndexFlat(D_, device=dev), payload, T.PCAMatrix(D_, 16,
                                                              device=dev))
    if hasattr(idx, "nnd_iters"):
        idx.nnd_iters = 3
    if not idx.is_trained:
        idx.train(xt)
    idx.add(xb)
    return idx


_FAMILY_TAGS = {"BxFl": "IndexBinaryFlat", "BwFl": "IndexBinaryIVF",
                "BxHN": "IndexBinaryHNSW", "BxHs": "IndexBinaryHash",
                "BxMH": "IndexBinaryMultiHash",
                "BxFF": "IndexBinaryFromFloat", "IxLs": "IndexLSH",
                "IxMM": "IndexRowwiseMinMax", "IxMI": "MultiIndexQuantizer",
                "IxSV": "IndexSplitVectors", "IxRn": "IndexRandom",
                "IxNS": "IndexNSGFlat", "IxNP": "IndexNSGPQ",
                "IxNQ": "IndexNSGSQ", "IxND": "IndexNNDescentFlat",
                "IwSH": "IndexIVFSpectralHash",
                "IwIQ": "IndexIVFIndependentQuantizer"}
_FAMILIES = set(_FAMILY_TAGS.values())


def _queries(name, xq):
    if name == "IndexFlat1D":
        return xq[:, :1].copy()
    return _codes(xq) if name.startswith("IndexBinary") else xq


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
    assert getattr(idx2, "metric_type", 0) == getattr(idx, "metric_type", 0)
    assert idx2.ntotal == idx.ntotal
    if hasattr(idx, "hnsw"):             # search knobs are not in the file
        idx2.hnsw.__dict__.update(idx.hnsw.__dict__)
    q = _queries(name, xq)
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


# -- the 17 tags of the binary, graph, long-tail and IVF-coupling indexes
#    across the two packages ------------------------------------------------

_EXACT = {"BxFl", "BwFl", "BxHN", "BxHs", "BxMH", "BxFF", "IxLs", "IwSH",
          "IxRn"}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("tag", sorted(_FAMILY_TAGS))
def test_family_files_cross_packages(tag, writer, data, tmp_path):
    """A file one package writes, the other reads (mmap on the port's
    side) as the same class, and both search it alike: the Hamming codes
    and IxRn bit for bit, ids up to ties; the float ones with ids
    overlapping >= 0.95 and a shared id's distance within rtol 1e-5 (the
    f32 products of the two packages round apart near a tie); the IMI's
    codebook bit for bit (its reference search is not exact)."""
    from test_io_sweep import _build as jax_build
    from tpu_ann.utils import index_io as jio

    xt, xb, xq = data
    name = _FAMILY_TAGS[tag]
    p = str(tmp_path / f"{tag}.tann")
    if writer == "jax":
        src = jax_build(name, xt, xb)
        jio.write_index(src, p)
        dst = index_io.read_index(p, mmap=True, device="cpu")
        jidx, tidx = src, dst
    else:
        src = _build(name, xt, xb, None)
        index_io.write_index(src, p)
        dst = jio.read_index(p)
        jidx, tidx = dst, src
    assert index_io._read_container(p)[0]["tag"] == tag
    assert type(dst).__name__ == type(src).__name__
    assert dst.ntotal == src.ntotal
    if tag == "IxMI":
        np.testing.assert_array_equal(tidx.pq.centroids,
                                      np.asarray(jidx.pq.centroids))
        return
    if hasattr(jidx, "max_list_scan_factor"):
        jidx.max_list_scan_factor = 0
    q = _queries(name, xq)
    D0, I0 = jidx.search(q, 10)
    D1, I1 = tidx.search(q, 10)
    if tag in _EXACT:
        assert_topk_equal(D0, I0, D1, I1)
        return
    ov = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(I0, I1)])
    assert ov >= 0.95, ov
    for r in range(len(q)):
        m0 = dict(zip(I0[r], D0[r]))
        for i, dd in zip(I1[r], D1[r]):
            if i in m0:
                np.testing.assert_allclose(dd, m0[i], rtol=1e-5, atol=1e-5)
