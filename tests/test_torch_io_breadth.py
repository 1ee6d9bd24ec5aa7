"""Port twin of tests/test_io_sweep.py for the tags of the index API
breadth (IxPT, IxMp, IxM2, IxSh, IxRp), with the factory's prefixes, on
the CPU.

Files: a file one package writes, the other reads, and both search it
alike (integer rows: D bit for bit, ids up to ties; a PCA or OPQ chain:
rtol 1e-4, the transformed rows differ in their last bits). A port file
reopens as the same transform classes, so reverse_index_factory still
names the chain; the reference reloads every transform as a bare
LinearTransform (tpu_ann/utils/index_io.py:641-656). An L2norm chain is a
file only the port writes (the reference's _dump_pretransform raises on
it, :627-630) and reads. An IxSh file carries the shards' cumulative sizes
as ``id_bases``, the reference's one base a shard, and the port's runs of
ids, one an add, as ``id_runs``.

Factory: each prefix (IDMap, IDMap2, PCA, PCAR, PCAW, OPQ, RR, L2norm)
builds the reference's nesting and classes, get_code_size agrees, and
reverse_index_factory writes the spec back (the reference writes PCA<d>
for PCAR / PCAW and IDMap for IDMap2, and raises on L2norm,
tpu_ann/utils/factory.py:455-460); ITQ is no token in either."""

import re

import numpy as np
import pytest

import tpu_ann_torch as T
from torch_parity import assert_topk_equal
from tpu_ann.models import idmap as JM
from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.utils import factory as JF
from tpu_ann.utils import index_io as jio
from tpu_ann_torch.utils import factory as TF
from tpu_ann_torch.utils import index_io as tio

D, NT, NB, NQ, K = 32, 2000, 1500, 30, 10


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(41)
    xt = rs.randint(0, 64, size=(NT, D)).astype(np.float32)
    xb = rs.randint(0, 64, size=(NB, D)).astype(np.float32)
    xq = rs.randint(0, 64, size=(NQ, D)).astype(np.float32)
    return xt, xb, xq


SPECS = {
    "IxPT_pca": "PCA16,Flat",
    "IxPT_rr_ivf": "RR32,IVF8,Flat",
    "IxPT_opq": "OPQ4_16,IVF8,PQ4",
    "IxMp": "IDMap,Flat",
    "IxM2": "IDMap2,IVF8,Flat",
}


def _build(pkg, case, xt, xb):
    if case in ("IxSh", "IxRp"):
        if pkg == "jax":
            idx = (JM.IndexShards if case == "IxSh" else JM.IndexReplicas)(D)
            subs = [JFlat(D), JFlat(D), JFlat(D)]
        else:
            idx = (T.IndexShards if case == "IxSh" else T.IndexReplicas)(
                D, device="cpu")
            subs = [T.IndexFlat(D, device="cpu") for _ in range(3)]
        for s in subs:
            (idx.add_shard if case == "IxSh" else idx.add_replica)(s)
        idx.add(xb)
        return idx
    spec = SPECS[case]
    idx = JF.index_factory(D, spec) if pkg == "jax" else \
        TF.index_factory(D, spec, device="cpu")
    inner = idx
    while hasattr(inner, "index") or hasattr(inner, "chain"):
        if hasattr(inner, "chain"):
            for vt in inner.chain:
                if hasattr(vt, "niter_pq"):
                    vt.niter = 2
        inner = inner.index
    if hasattr(inner, "cp"):
        inner.cp.niter = 4
    if hasattr(inner, "nprobe"):
        inner.nprobe = 8
        inner.max_list_scan_factor = 0
    idx.train(xt)
    if case.startswith("IxM"):
        idx.add_with_ids(xb, np.arange(NB, dtype=np.int64) * 11 + (1 << 35))
    else:
        idx.add(xb)
    return idx


CASES = sorted(SPECS) + ["IxSh", "IxRp"]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", CASES)
def test_files_cross_packages(case, writer, data, tmp_path):
    xt, xb, xq = data
    path = str(tmp_path / f"{case}.tann")
    src = _build(writer if writer == "jax" else "torch", case, xt, xb)
    if writer == "jax":
        jio.write_index(src, path)
        dst = tio.read_index(path, device="cpu")
        jidx, tidx = src, dst
    else:
        tio.write_index(src, path)
        dst = jio.read_index(path)
        jidx, tidx = dst, src
    assert tio._read_container(path)[0]["tag"] == case.split("_")[0]
    assert type(dst).__name__ == type(src).__name__
    assert dst.ntotal == src.ntotal == NB
    D0, I0 = jidx.search(xq, K)
    D1, I1 = tidx.search(xq, K)
    tol = 1e-4 if case.startswith("IxPT") else 0.0
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1, rtol=tol,
                      atol=tol * 10)
    # the port's own reload searches as the written index
    again = tio.read_index(path, mmap=True, device="cpu")
    D2, I2 = again.search(xq, K)
    assert_topk_equal(D1, I1, D2, I2, rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("spec", ["PCA16,Flat", "PCAR16,IVF8,Flat",
                                  "PCAW16,Flat", "OPQ4_16,IVF8,PQ4",
                                  "RR32,IVF8,Flat", "L2norm,IVF8,Flat",
                                  "IDMap2,PCAR16,IVF8,Flat"])
def test_port_file_keeps_transform_classes(spec, data, tmp_path):
    """A port file reopens as the same classes with the same state: the
    reverse spec survives the file, and the search is bit-equal. The
    reference's reload of its own OPQ / PCA file is a bare
    LinearTransform, whose reverse raises."""
    xt, xb, xq = data
    idx = TF.index_factory(D, spec, device="cpu")
    pre = idx.index if spec.startswith("IDMap") else idx
    for vt in pre.chain:
        if hasattr(vt, "niter_pq"):
            vt.niter = 2
    if hasattr(pre.index, "cp"):
        pre.index.cp.niter = 4
    idx.train(xt)
    if spec.startswith("IDMap"):
        idx.add_with_ids(xb, np.arange(NB) + 7)
    else:
        idx.add(xb)
    path = str(tmp_path / "chain.tann")
    tio.write_index(idx, path)
    back = tio.read_index(path, device="cpu")
    rev = TF.reverse_index_factory(back)
    assert rev == TF.reverse_index_factory(idx)
    assert rev == _with_bits(spec)
    bpre = back.index if spec.startswith("IDMap") else back
    for a, b in zip(bpre.chain, pre.chain):
        assert type(a) is type(b)
        for name in ("A", "b", "mean", "eigenvalues"):
            if getattr(b, name, None) is not None:
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
    D1, I1 = idx.search(xq, K)
    D2, I2 = back.search(xq, K)
    np.testing.assert_array_equal(D1, D2)
    np.testing.assert_array_equal(I1, I2)
    if spec.startswith("L2norm"):
        with pytest.raises(KeyError):
            jio.read_index(path)            # a file only the port reads
        j = JF.index_factory(D, spec)
        j.train(xt)
        with pytest.raises(TypeError):
            jio.write_index(j, path)        # the reference cannot write it
    if spec.startswith(("OPQ", "PCA16")):
        j = JF.index_factory(D, spec)
        for vt in j.chain:
            vt.niter = 2
        if hasattr(j.index, "cp"):
            j.index.cp.niter = 4
        j.train(xt)
        jio.write_index(j, path)
        with pytest.raises(ValueError):     # the reference's fault
            JF.reverse_index_factory(jio.read_index(path))
        # the port reads the reference's file as linear transforms
        assert [type(t).__name__ for t in
                tio.read_index(path, device="cpu").chain] == \
            ["LinearTransform"]


def test_shards_file_after_two_adds(data, tmp_path):
    """A port IxSh written after two adds reopens in the port with its ids
    in the order of the adds (equal to one IndexFlat over the rows in that
    order). The reference reads the cumulative ``id_bases``, one base a
    shard, which numbers the same rows shard-major: its (D, I) is the
    port's with each id mapped to the row's shard-major position."""
    _, xb, xq = data
    idx = T.IndexShards(D, device="cpu")
    for _ in range(2):
        idx.add_shard(T.IndexFlat(D, device="cpu"))
    idx.add(xb[:700])
    idx.add(xb[700:])
    path = str(tmp_path / "sh.tann")
    tio.write_index(idx, path)
    meta = tio._read_container(path)[0]
    assert meta["id_bases"] == [0, 750]
    D1, I1 = idx.search(xq, K)
    Dr, Ir = tio.read_index(path, device="cpu").search(xq, K)
    np.testing.assert_array_equal(Dr, D1)
    np.testing.assert_array_equal(Ir, I1)
    flat = T.IndexFlat(D, device="cpu")
    flat.add(xb)
    assert_topk_equal(*flat.search(xq, K), D1, I1)
    shard_major = np.empty(NB, np.int64)
    for base, runs in zip(meta["id_bases"], meta["id_runs"]):
        for row, first, n in runs:
            shard_major[first:first + n] = base + np.arange(row, row + n)
    D0, I0 = jio.read_index(path).search(xq, K)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, shard_major[I1])


def test_idmap_ivf_file_after_removal(data, tmp_path):
    """An IDMap2 over IVF after a removal keeps its id map and the removed
    marks through a file; the reference reads it and finds the same
    rows."""
    xt, xb, xq = data
    idx = TF.index_factory(D, "IDMap2,IVF8,Flat", device="cpu")
    idx.index.cp.niter = 4
    idx.index.nprobe = 8
    idx.train(xt)
    ids = np.arange(NB, dtype=np.int64) + 100
    idx.add_with_ids(xb, ids)
    assert idx.remove_ids(T.IDSelectorRange(100, 400)) == 300
    path = str(tmp_path / "m2.tann")
    tio.write_index(idx, path)
    back = tio.read_index(path, device="cpu")
    assert back.ntotal == NB - 300
    D1, I1 = idx.search(xq, K)
    D2, I2 = back.search(xq, K)
    np.testing.assert_array_equal(D1, D2)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(back.reconstruct(700), xb[600])
    j = jio.read_index(path)
    j.index.max_list_scan_factor = 0
    D0, I0 = j.search(xq, K)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1)


# -- the factory's prefixes ---------------------------------------------------

FACTORY = ["IDMap,Flat", "IDMap2,IVF64,Flat", "PCA16,IVF64,Flat",
           "PCAR16,Flat", "PCAW16,Flat", "OPQ8_16,IVF64,PQ8", "OPQ8,PQ8",
           "RR32,Flat", "RR16,HNSW8", "IDMap,PCA16,IVF64,PQ8,RFlat",
           "PCA16,RR16,IVF64,SQ8", "IDMap2,OPQ4_16,IVF64_HNSW8,PQ4"]


def _tree(idx) -> list:
    """Class names and parameters from the outside in."""
    out = []
    while idx is not None:
        row = [type(idx).__name__, idx.d, idx.metric_type]
        for vt in getattr(idx, "chain", ()):
            row.append((type(vt).__name__, vt.d_in, vt.d_out,
                        getattr(vt, "M", None),
                        getattr(vt, "eigen_power", None),
                        getattr(vt, "random_rotation", None)))
        for name in ("nlist", "M", "nbits", "qtype", "k_factor"):
            if isinstance(getattr(idx, name, None), int):
                row.append((name, getattr(idx, name)))
        out.append(row)
        idx = getattr(idx, "index", None) or getattr(idx, "base_index", None)
    return out


def _with_bits(spec: str) -> str:
    """The spec with each PQ code's bit count written out."""
    return re.sub(r"(^|,)PQ(\d+)(?=,|$)", r"\1PQ\2x8", spec)


@pytest.mark.parametrize("spec", FACTORY + ["L2norm,IVF64,Flat"])
def test_factory_prefixes(spec):
    t = TF.index_factory(D, spec, device="cpu")
    j = JF.index_factory(D, spec)
    assert _tree(t) == _tree(j)
    assert TF.get_code_size(D, spec) == JF.get_code_size(D, spec)
    rev = TF.reverse_index_factory(t)
    assert rev == _with_bits(spec)
    assert _tree(TF.index_factory(D, rev, device="cpu")) == _tree(t)
    if not any(p in spec for p in ("PCAR", "PCAW", "IDMap2", "L2norm")):
        assert rev == JF.reverse_index_factory(j)


@pytest.mark.parametrize("spec", ["IDMap,Flat", "IDMap2,IVF4096,Flat",
                                  "PCA64,IVF4096,Flat", "PCAR64,Flat",
                                  "PCAW64,Flat", "OPQ16_64,IVF4096,PQ16",
                                  "RR128,Flat", "L2norm,IVF4096,Flat"])
def test_factory_deployment_specs(spec):
    """The specs of the chip's phase 18 and of faiss's OPQ-IVF-PQ
    deployments at d 128: built, and reversed to the same spec (a PQ code
    gets its explicit 8 bits, as the reference writes it)."""
    idx = TF.index_factory(128, spec, device="cpu")
    assert TF.reverse_index_factory(idx) == _with_bits(spec)


@pytest.mark.parametrize("spec", ["ITQ,Flat", "ITQ64,IVF64,Flat",
                                  "PCA16", "IDMap", "Flat,IDMap"])
def test_factory_unknown_prefixes_raise(spec):
    for f in (JF.index_factory, lambda d, s: TF.index_factory(
            d, s, device="cpu")):
        with pytest.raises(ValueError):
            f(D, spec)
