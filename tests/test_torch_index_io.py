"""Port parity: tpu_ann_torch.utils.index_io against the JAX package's
index_io, on the CPU. The file format is the reference's, so for each of
the eight ported tags a file written by either package is read by the
other, and both search it alike: on integer-valued data (every distance an
exact f32 integer) the ids are equal up to ties and the distances bit for
bit. The SQ8 codes of IxSQ decode to floats, and both packages take the
norm expansion ||q||^2 + ||x||^2 - 2<q, x>, summed in their own orders:
distances agree to 4 ulps of the largest norm (SQ_ATOL). The
out-of-core IwPG file names a directory, whose JAX search keeps its RW=512
reservoir: there the ids overlap >= 0.99 and a shared id carries the same
distance (as tests/test_torch_ivf_paged.py holds the directories).

Also: mmap reopens, clone_index, serialize_index / deserialize_index, a
bf16 array through the container with no ml_dtypes loaded, five of the
tags ROADMAP item 9 ported in both directions (the rest in
test_torch_io_sweep.py), an unknown tag, and IndexIVFHNSW's disk
lifecycle."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.flat import IndexFlat1D as JFlat1D
from tpu_ann.models.hnsw import IndexHNSWFlat as JHNSW
from tpu_ann.models.ivf import make_ivf_flat as jmake_ivf_flat
from tpu_ann.models.ivf_hnsw import IndexIVFHNSW as JIVFHNSW
from tpu_ann.models.ivf_paged import IndexIVFFlatPaged as JPaged
from tpu_ann.models.ivf_pq import IndexIVFScalarQuantizer as JIVFSQ
from tpu_ann.models.pq import IndexScalarQuantizer as JSQ
from tpu_ann.ops import sq as JSQC
from tpu_ann.utils import index_io as jio
from tpu_ann_torch.utils import index_io as tio
from torch_parity import assert_topk_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NT, NQ, D, K, NLIST, NPROBE = 3000, 1000, 40, 32, 10, 16, 4
TAGS = ("IxFl", "IxF1", "IHNf", "IwFl", "IwHn", "IwPG", "IxSQ", "IwSQ")
SQ_ATOL = 4 * float(np.spacing(np.float32(D * 255.0 ** 2)))


@pytest.fixture(scope="module")
def data():
    """Integer-valued rows in [0, 255]: 24 clusters plus integer noise."""
    rs = np.random.RandomState(5)
    n = N + NT + NQ
    cents = rs.randint(20, 230, (24, D))
    x = cents[rs.randint(24, size=n)] + rs.randint(-15, 16, (n, D))
    x = np.clip(x, 0, 255).astype(np.float32)
    return x[:N], x[N:N + NT], x[N + NT:]


def _queries(tag, xq):
    return xq[:, :1] if tag == "IxF1" else xq


def _jax_index(tag, data, path):
    xb, xt, _ = data
    if tag == "IxFl":
        idx = JFlat(D)
    elif tag == "IxF1":
        idx = JFlat1D()
        idx.add(xb[:, :1])
        return idx
    elif tag == "IHNf":
        idx = JHNSW(D, 8)
    elif tag == "IwFl":
        idx = jmake_ivf_flat(D, NLIST)
    elif tag == "IwHn":
        idx = JIVFHNSW(D, NLIST, M=8)
    elif tag == "IwPG":
        idx = JPaged(D, NLIST, path)
        idx.scan_interpret = True
        idx.cp_niter = 4
    elif tag == "IxSQ":
        idx = JSQ(D, JSQC.QT_8BIT)
    else:
        idx = JIVFSQ(JFlat(D), D, NLIST, JSQC.QT_8BIT_DIRECT)
    if hasattr(idx, "cp"):
        idx.cp.niter = 4
    idx.train(xt)
    idx.add(xb)
    if hasattr(idx, "nprobe"):
        idx.nprobe = NPROBE
    return idx


def _port_index(tag, data, path):
    xb, xt, _ = data
    dev = "cpu"
    if tag == "IxFl":
        idx = T.IndexFlat(D, device=dev)
    elif tag == "IxF1":
        idx = T.IndexFlat1D(device=dev)
        idx.add(xb[:, :1])
        return idx
    elif tag == "IHNf":
        idx = T.IndexHNSWFlat(D, 8, device=dev)
    elif tag == "IwFl":
        idx = T.make_ivf_flat(D, NLIST, device=dev)
    elif tag == "IwHn":
        idx = T.IndexIVFHNSW(D, NLIST, M=8, device=dev)
    elif tag == "IwPG":
        idx = T.IndexIVFFlatPaged(D, NLIST, path, device=dev)
        idx.cp_niter = 4
    elif tag == "IxSQ":
        idx = T.IndexScalarQuantizer(D, T.QT_8BIT, device=dev)
    else:
        idx = T.IndexIVFScalarQuantizer(T.IndexFlat(D, device=dev), D, NLIST,
                                        T.QT_8BIT_DIRECT, device=dev)
    if hasattr(idx, "cp"):
        idx.cp.niter = 4
    idx.train(xt)
    idx.add(xb)
    if hasattr(idx, "nprobe"):
        idx.nprobe = NPROBE
    return idx


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """Per tag and package, a built index and the path of its file; built
    on first use."""
    root = tmp_path_factory.mktemp("index_io")
    cache = {}

    def get(tag, pkg):
        if (tag, pkg) not in cache:
            build = _jax_index if pkg == "jax" else _port_index
            idx = build(tag, data, str(root / f"{pkg}_{tag}_dir"))
            path = str(root / f"{pkg}_{tag}.tann")
            (jio if pkg == "jax" else tio).write_index(idx, path)
            cache[tag, pkg] = (idx, path)
        return cache[tag, pkg]

    return get


def _assert_same(tag, D0, I0, D1, I1):
    if tag == "IwPG":
        overlap = np.mean([len(set(a) & set(b)) / K for a, b in zip(I0, I1)])
        assert overlap >= 0.99, overlap
        for q in range(len(I0)):
            for j, i in enumerate(I1[q]):
                hit = np.nonzero(I0[q] == i)[0]
                if i >= 0 and len(hit):
                    assert D1[q, j] == D0[q, hit[0]]
        return
    assert_topk_equal(D0, I0, D1, I1, atol=SQ_ATOL if tag == "IxSQ" else 0.0)


@pytest.mark.parametrize("tag", TAGS)
def test_jax_writes_port_reads(tag, data, indexes):
    jidx, path = indexes(tag, "jax")
    meta, _ = tio._read_container(path)
    assert meta["tag"] == tag
    tidx = T.read_index(path, device="cpu")
    assert type(tidx).__name__ == type(jidx).__name__
    assert tidx.ntotal == jidx.ntotal
    xq = _queries(tag, data[2])
    D0, I0 = jidx.search(xq, K)
    D1, I1 = tidx.search(xq, K)
    _assert_same(tag, D0, I0, D1, I1)


@pytest.mark.parametrize("tag", TAGS)
def test_port_writes_jax_reads(tag, data, indexes):
    tidx, path = indexes(tag, "port")
    jidx = jio.read_index(path)
    assert type(jidx).__name__ == type(tidx).__name__
    assert jidx.ntotal == tidx.ntotal
    if tag == "IwPG":
        jidx.scan_interpret = True
    xq = _queries(tag, data[2])
    D0, I0 = jidx.search(xq, K)
    D1, I1 = tidx.search(xq, K)
    _assert_same(tag, D0, I0, D1, I1)


@pytest.mark.parametrize("tag", ["IwFl", "IwHn", "IHNf"])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_mmap_reopen(tag, pkg, data, indexes):
    """mmap=True maps the file's blobs; the reopened index searches
    exactly like the one read into memory (an IVF file's host store
    stays a memmap until the first search repacks it)."""
    _, path = indexes(tag, pkg)
    _, arrays = tio._read_container(path, mmap=True)
    assert all(isinstance(a, np.memmap) for a in arrays.values()
               if a.size)
    mapped = T.read_index(path, mmap=True, device="cpu")
    if tag != "IHNf":
        assert mapped.invlists is None
        assert isinstance(mapped._xb_host[0], np.memmap)
    loaded = T.read_index(path, device="cpu")
    xq = data[2]
    D0, I0 = loaded.search(xq, K)
    D1, I1 = mapped.search(xq, K)
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(D0, D1)


@pytest.mark.parametrize("tag", TAGS)
def test_clone_index_is_independent(tag, data, indexes):
    idx, _ = indexes(tag, "port")
    xq = _queries(tag, data[2])
    D0, I0 = idx.search(xq, K)
    clone = T.clone_index(idx)
    assert type(clone) is type(idx) and clone is not idx
    assert clone.device == idx.device
    D1, I1 = clone.search(xq, K)
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(D0, D1)
    # no array is shared: emptying a clone leaves the original as it was
    clone.reset()
    D2, I2 = idx.search(xq, K)
    np.testing.assert_array_equal(I0, I2)
    np.testing.assert_array_equal(D0, D2)


@pytest.mark.parametrize("tag", TAGS)
def test_serialize_roundtrip(tag, data, indexes):
    idx, path = indexes(tag, "port")
    buf = T.serialize_index(idx)
    assert buf.dtype == np.uint8
    with open(path, "rb") as f:
        assert buf.tobytes() == f.read()      # the container's bytes
    back = T.deserialize_index(buf, device="cpu")
    xq = _queries(tag, data[2])
    D0, I0 = idx.search(xq, K)
    D1, I1 = back.search(xq, K)
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(D0, D1)


def test_bf16_container_roundtrip_without_ml_dtypes(tmp_path):
    """A torch bf16 tensor goes through the container under the dtype name
    "bfloat16" and comes back bit for bit, in a process that loads neither
    jax nor ml_dtypes."""
    code = (
        "import sys, torch\n"
        "from tpu_ann_torch.utils import index_io as io\n"
        "t = torch.randn(5, 7).to(torch.bfloat16)\n"
        f"p = {str(tmp_path / 'bf16.tann')!r}\n"
        "io._write_container(p, {'tag': 'x'}, {'a': t})\n"
        "for mm in (False, True):\n"
        "    meta, arrays = io._read_container(p, mmap=mm)\n"
        "    a = arrays['a']\n"
        "    assert isinstance(a, io.Bf16Array) and a.dtype.name == 'uint16'\n"
        "    b = io.to_tensor(a, 'cpu')\n"
        "    assert b.dtype == torch.bfloat16 and torch.equal(b, t)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'ml_dtypes', 'tpu_ann')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bf16_codes_cross_package(direction, data, tmp_path):
    """QT_BF16 codes: the reference writes them as ml_dtypes bfloat16 and
    the port reads the same bits as torch.bfloat16, and back."""
    import ml_dtypes

    xb, _, xq = data
    path = str(tmp_path / "sq_bf16.tann")
    jidx = JSQ(D, JSQC.QT_BF16)
    jidx.train(xb)
    jidx.add(xb / 7.0)
    tidx = T.IndexScalarQuantizer(D, T.QT_BF16, device="cpu")
    tidx.train(xb)
    tidx.add(xb / 7.0)
    if direction == "jax_to_port":
        jio.write_index(jidx, path)
        back = T.read_index(path, device="cpu")
        ref = np.asarray(jidx._codes).view(np.uint16)
        got = back._codes.view(torch.int16).numpy().view(np.uint16)
        D0, I0 = jidx.search(xq / 7.0, K)
    else:
        T.write_index(tidx, path)
        back = jio.read_index(path)
        assert np.asarray(back._codes).dtype == ml_dtypes.bfloat16
        ref = tidx._codes.view(torch.int16).numpy().view(np.uint16)
        got = np.asarray(back._codes).view(np.uint16)
        D0, I0 = tidx.search(xq / 7.0, K)
    np.testing.assert_array_equal(got, ref)
    D1, I1 = back.search(xq / 7.0, K)
    # the decoded rows are floats: 4 ulps of the largest norm, as SQ_ATOL
    atol = 4 * float(np.spacing(np.float32(((xb / 7.0) ** 2).sum(1).max())))
    assert_topk_equal(D0, I0, D1, I1, atol=atol)


@pytest.mark.parametrize("tag", ["IwFl", "IwHn", "IwSQ"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pending_removals_cross_package(tag, writer, data, tmp_path):
    """An IVF index written with removals pending stores its device lists
    (holes included), since its host store still holds the removed rows;
    the other package reads it and returns the writer's (D, I), with no
    removed id."""
    from tpu_ann.models.selectors import IDSelectorRange as JRange
    from tpu_ann_torch.models.selectors import IDSelectorRange as TRange

    _, _, xq = data
    if writer == "jax":
        idx = _jax_index(tag, data, None)
        idx.remove_ids(JRange(100, 900))
        path = str(tmp_path / "j.tann")
        jio.write_index(idx, path)
        other = T.read_index(path, device="cpu")
    else:
        idx = _port_index(tag, data, None)
        idx.remove_ids(TRange(100, 900))
        path = str(tmp_path / "t.tann")
        tio.write_index(idx, path)
        other = jio.read_index(path)
    meta, _ = tio._read_container(path)
    assert meta["il_from_host"] is False and meta["ntotal"] == N - 800
    assert other.ntotal == N - 800
    D0, I0 = idx.search(xq, K)
    D1, I1 = other.search(xq, K)
    _assert_same(tag, D0, I0, D1, I1)
    assert not ((I1 >= 100) & (I1 < 900)).any()


def _family_pair(tag, data):
    """(the JAX index, the port's) of a tag that ROADMAP queue 1's item 9
    ported, over the same data: the port's IVF spectral hash takes the
    reference's quantizer and projection."""
    from tpu_ann.models import binary as JB
    from tpu_ann.models import extra as JX
    from tpu_ann.models import nsg as JN
    from tpu_ann.models.ivf_extra import IndexIVFSpectralHash as JSH

    xb, xt, _ = data
    if tag == "BxFl":
        j, t = JB.IndexBinaryFlat(D), T.IndexBinaryFlat(D, device="cpu")
        for idx in (j, t):
            idx.add(np.packbits(xb > 128, axis=1)[:, :D // 8])
        return j, t
    if tag == "IxLs":
        j, t = JX.IndexLSH(D, 64, True, True), T.IndexLSH(D, 64, True, True,
                                                            device="cpu")
    elif tag == "IxMM":
        j = JX.IndexRowwiseMinMax(JFlat(D))
        t = T.IndexRowwiseMinMax(T.IndexFlat(D, device="cpu"))
    elif tag == "IxNS":
        j, t = JN.IndexNSGFlat(D, 8), T.IndexNSGFlat(D, 8, device="cpu")
        j.nnd_iters = t.nnd_iters = 2
    else:
        j = JSH(JFlat(D), D, NLIST, 32)
        j.cp.niter = 3
        j.train(xt)
        q = T.IndexFlat(D, device="cpu")
        q.add(np.asarray(j.quantizer.vectors))
        t = T.IndexIVFSpectralHash(q, D, NLIST, 32, device="cpu")
        t.quantizer_trains_alone = 1
        t.vt.A, t.vt.is_trained = np.asarray(j.vt.A), True
        j.nprobe = t.nprobe = NPROBE
        j.max_list_scan_factor = 0
    for idx in (j, t):
        idx.train(xt)
        idx.add(xb[:1000])
    return j, t


@pytest.mark.parametrize("tag,item", [("IxLs", "item 9"), ("IwSH", "item 9"),
                                      ("IxMM", "item 9"), ("IxNS", "item 9"),
                                      ("BxFl", "item 9")])
def test_unported_tag_raises(tag, item, data, tmp_path):
    """No longer a refusal test: it keeps the name it had while the port
    refused these tags, and now checks round trips. The tags that ROADMAP
    queue 1's ``item`` ported round-trip in both directions: the JAX index's file reopens in the
    port (mmap) and the port's in the JAX package, each searching as the
    index that wrote it: distances within rtol 1e-5, ids up to ties;
    IxMM's rows are normalized to [0, 1], whose norm expansion (norms ~10)
    the two packages round apart by up to ~1e-5: atol 2e-5 there."""
    j, t = _family_pair(tag, data)
    xq = data[2]
    if tag == "BxFl":
        xq = np.packbits(xq > 128, axis=1)[:, :D // 8]
    for writer, reader in ((j, "port"), (t, "jax")):
        path = str(tmp_path / f"{tag}_{reader}.tann")
        if reader == "port":
            jio.write_index(writer, path)
            other = T.read_index(path, mmap=True, device="cpu")
        else:
            tio.write_index(writer, path)
            other = jio.read_index(path)
            if hasattr(other, "max_list_scan_factor"):
                other.max_list_scan_factor = 0
        assert tio._read_container(path)[0]["tag"] == tag
        assert type(other).__name__ == type(writer).__name__
        D0, I0 = writer.search(xq, K)
        D1, I1 = other.search(xq, K)
        assert_topk_equal(D0, I0, D1, I1, rtol=1e-5,
                          atol=2e-5 if tag == "IxMM" else 0.0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ivf_rq_file_both_directions(data, writer, tmp_path):
    """IwRQ: an IVF-RQ file written by either package reopens in the other
    (mmap) with the same code lists, codebooks and quantizer, and searches
    alike through the table scan (integer data: exact up to ties)."""
    import jax.numpy as jnp

    from tpu_ann.models.rq import IndexIVFResidualQuantizer as JIVFRQ

    xb, xt, xq = data
    path = str(tmp_path / "ivfrq.tann")
    cent = xt[:NLIST]
    j = JIVFRQ(JFlat(D), D, NLIST, 3, 6)
    j.quantizer.add(cent)
    j.quantizer_trains_alone = 1
    j.max_list_scan_factor = 0
    j.use_decoded_cache = False
    j.train(xt)
    books = np.round(np.asarray(j.rq.codebooks)).astype(np.float32)
    j.rq.codebooks, j._books = books, jnp.asarray(books)
    j.add(xb)
    if writer == "jax":
        jio.write_index(j, path)
        other = T.read_index(path, mmap=True, device="cpu")
        jidx, tidx = j, other
    else:
        t = T.IndexIVFResidualQuantizer(T.IndexFlat(D, device="cpu"), D,
                                        NLIST, 3, 6, device="cpu")
        t.quantizer.add(cent)
        t.quantizer_trains_alone = 1
        t._set_codec(books)
        t.is_trained = True
        t.add(xb)
        tio.write_index(t, path)
        other = jio.read_index(path, mmap=True)
        other.max_list_scan_factor = 0
        jidx, tidx = other, t
    meta, _ = tio._read_container(path)
    assert meta["tag"] == "IwRQ" and meta["cls"] == "IndexIVFResidualQuantizer"
    assert other.ntotal == N
    np.testing.assert_array_equal(np.asarray(jidx.rq.codebooks),
                                  tidx.rq.codebooks)
    np.testing.assert_array_equal(np.asarray(jidx.invlists.codes),
                                  tidx.invlists.codes.numpy())
    jidx.use_decoded_cache = tidx.use_decoded_cache = False
    jidx.nprobe = tidx.nprobe = NPROBE
    D0, I0 = jidx.search(xq, K)
    D1, I1 = tidx.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


def test_unported_tag_from_a_jax_file(data, tmp_path):
    """No longer a refusal test (the name is kept from when the port
    refused this tag): a JAX IndexRowwiseMinMax file reopens in the
    port and searches alike (atol 2e-5: the normalized rows' norm
    expansion, as in test_unported_tag_raises); an unknown tag still
    raises ValueError."""
    from tpu_ann.models.extra import IndexRowwiseMinMax

    xb, _, xq = data
    idx = IndexRowwiseMinMax(JFlat(D))
    idx.add(xb[:100])
    path = str(tmp_path / "minmax.tann")
    jio.write_index(idx, path)
    other = T.read_index(path, device="cpu")
    assert isinstance(other, T.IndexRowwiseMinMax) and other.ntotal == 100
    assert_topk_equal(*idx.search(xq, K), *other.search(xq, K), rtol=1e-5,
                      atol=2e-5)
    np.testing.assert_allclose(other.reconstruct(7), idx.reconstruct(7),
                               rtol=1e-6)
    tio._write_container(path, {"tag": "Zzzz"}, {})
    with pytest.raises(ValueError, match="unknown index tag"):
        T.read_index(path, device="cpu")


def test_ivf_hnsw_disk_lifecycle(data, tmp_path):
    """index_file_path + auto_save (a save at the end of each add),
    save_to_disk / load_from_disk / the static load."""
    xb, xt, xq = data
    path = str(tmp_path / "lifecycle.tann")
    idx = T.IndexIVFHNSW(D, NLIST, M=8, device="cpu")
    idx.cp.niter = 4
    idx.add_chunk_size = 1000
    idx.nprobe = NPROBE
    idx.train(xt)
    idx.index_file_path, idx.auto_save = path, True
    idx.add(xb[:2000])
    first = os.path.getmtime(path)
    assert T.IndexIVFHNSW.load(path, device="cpu").ntotal == 2000
    idx.add(xb[2000:])
    assert os.path.getmtime(path) >= first
    back = T.IndexIVFHNSW.load(path, device="cpu")
    assert back.ntotal == N and back.nprobe == NPROBE
    assert back.add_chunk_size == 1000
    D0, I0 = idx.search(xq, K)
    D1, I1 = back.search(xq, K)
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(D0, D1)
    other = T.IndexIVFHNSW(D, NLIST, device="cpu")
    other.load_from_disk(path)
    D2, I2 = other.search(xq, K)
    np.testing.assert_array_equal(I0, I2)
    with pytest.raises(ValueError):
        T.IndexIVFHNSW(D, NLIST, device="cpu").save_to_disk()
    flat_path = str(tmp_path / "flat.tann")
    T.write_index(T.IndexFlat(D, device="cpu"), flat_path)
    with pytest.raises(TypeError):
        T.IndexIVFHNSW.load(flat_path, device="cpu")


def test_read_index_defaults_to_cuda(data, indexes):
    """read_index builds on the GPU unless asked for the CPU; without a
    GPU it fails instead of quietly running on the CPU."""
    _, path = indexes("IwFl", "port")
    if torch.cuda.is_available():
        assert T.read_index(path).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            T.read_index(path).search(data[2], K)


# -- the HNSW storages (IHNs, IHNq, IHN2) across the two packages ---------------

def _hnsw_storage(pkg, tag, xb, xt):
    from tpu_ann.models import hnsw as JM

    mod = JM if pkg == "jax" else T
    kw = {} if pkg == "jax" else {"device": "cpu"}
    if tag == "IHNs":
        idx = mod.IndexHNSWSQ(D, "bfloat16", 8, **kw)
    elif tag == "IHNq":
        idx = mod.IndexHNSWPQ(D, 8, 8, **kw)
    else:
        idx = mod.IndexHNSW2Level(D, NLIST, 8, 8, **kw)
    idx.train(xt) if tag != "IHNs" else None
    idx.add(xb)
    return idx


def _stored_rows(idx):
    rows = idx.storage.vectors
    return rows.numpy() if isinstance(rows, torch.Tensor) else \
        np.asarray(rows)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("tag", ["IHNs", "IHNq", "IHN2"])
def test_hnsw_storage_files_cross_package(tag, writer, data, tmp_path):
    """An IndexHNSWSQ (bf16) / IndexHNSWPQ / IndexHNSW2Level file one
    package writes, the other reads: the same class, graph, stored rows,
    codes and codebooks. Searches (the per-node route, below the tile
    thresholds): IHNq's over the decoded codes equal up to ties, D within
    SQ_ATOL (4 ulps of the largest norm: the decoded rows are floats);
    over bf16 rows the reference rounds the norms to bf16 and the port
    does not (tests/test_torch_hnsw_storage.py): on these rows (norms near
    1e6, a bf16 ulp of 4096 above the distances) the port's D are the
    exact distances to the stored rows (within SQ_ATOL) and its recall@10
    against exact search over them is at least the reference's."""
    xb, xt, xq = data
    p = str(tmp_path / f"{tag}.tann")
    src = _hnsw_storage(writer, tag, xb, xt)
    (jio if writer == "jax" else tio).write_index(src, p)
    dst = T.read_index(p, device="cpu") if writer == "jax" else \
        jio.read_index(p)
    assert tio._read_container(p)[0]["tag"] == tag
    assert type(dst).__name__ == type(src).__name__
    assert dst.ntotal == src.ntotal == N
    tidx, jidx = (dst, src) if writer == "jax" else (src, dst)
    for name in ("neighbors0", "upper_ids", "upper_neighbors", "levels"):
        np.testing.assert_array_equal(
            getattr(tidx.graph, name).numpy(),
            np.asarray(getattr(jidx.graph, name)), name)
    if tag == "IHNq":
        np.testing.assert_array_equal(tidx._codes.numpy(),
                                      np.asarray(jidx._codes))
        np.testing.assert_array_equal(tidx.pq.centroids,
                                      np.asarray(jidx.pq.centroids))
    else:
        np.testing.assert_array_equal(_stored_rows(tidx),
                                      _stored_rows(jidx))
    if tag == "IHN2":
        np.testing.assert_array_equal(tidx.codec._codes.numpy(),
                                      np.concatenate(jidx.codec._codes))
        np.testing.assert_array_equal(tidx.sa_encode(xq), jidx.sa_encode(xq))
    D0, I0 = jidx.search(xq, K)
    D1, I1 = tidx.search(xq, K)
    if tag == "IHNq":
        assert_topk_equal(D0, I0, D1, I1, atol=SQ_ATOL)
        return
    rows = torch.from_numpy(_stored_rows(tidx)).bfloat16().float()
    np.testing.assert_allclose(
        D1, ((rows.numpy()[I1] - xq[:, None]) ** 2).sum(-1), rtol=0,
        atol=SQ_ATOL)
    _, gt = T.knn(torch.from_numpy(xq), rows, K)
    gt = gt.numpy()
    assert T.recall_k_at_k(I1, gt, K) >= T.recall_k_at_k(
        np.asarray(I0), gt, K)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hnsw_sq8_dropped_storage_cross_package(writer, data, tmp_path,
                                                monkeypatch):
    """An "sq8" IndexHNSWSQ whose coded tiles dropped the raw rows: the
    file holds the dequantized rows (either package reads the other's).
    The port's own file also holds the tiles' affine and coarse order, so
    a reopened port index lays out the same tiles and returns the same
    (D, I) bit for bit."""
    import functools

    from tpu_ann.models import hnsw as JM
    from tpu_ann.ops import hnsw_tiles as JT

    monkeypatch.setattr(JT, "tile_search_fused", functools.partial(
        JT.tile_search_fused, interpret=True))
    xb, _, xq = data
    if writer == "jax":
        src = JM.IndexHNSWSQ(D, "sq8", 8)
    else:
        src = T.IndexHNSWSQ(D, "sq8", 8, device="cpu")
    src.hnsw.tile_threshold = 1000
    src.hnsw.tile_mode = "fused"
    src.add(xb)
    D0, I0 = src.search(xq, K)
    assert src._storage_dropped()
    rows = np.asarray(src._sq8_rows())
    p = str(tmp_path / "sq8.tann")
    (jio if writer == "jax" else tio).write_index(src, p)
    other = T.read_index(p, device="cpu") if writer == "jax" else \
        jio.read_index(p)
    np.testing.assert_array_equal(_stored_rows(other), rows)
    if writer == "port":
        back = T.read_index(p, mmap=True, device="cpu")
        back.hnsw.tile_threshold = 1000
        D1, I1 = back.search(xq, K)
        np.testing.assert_array_equal(D1, D0)
        np.testing.assert_array_equal(I1, I0)
        np.testing.assert_array_equal(back._tiles_fused.il.codes.numpy(),
                                      src._tiles_fused.il.codes.numpy())
