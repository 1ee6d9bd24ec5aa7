"""Port twins of tests/test_invlists_io.py for tpu_ann_torch.utils.invlists_io
(invlist sources, the composition views, the on-disk slot allocator and
the streaming merge_ondisk), on the CPU, plus merged files across the two
packages.

The JAX tests' in-RAM oracle (contrib.merge_indexes, not ported) is a
single index with the shards' quantizer and all rows added in order: the
merged file then packs every list in the same row order, so its (D, I) are
the oracle's bit for bit. The coded merge twin merges IVF-SQ8 shards
(QT_8BIT_DIRECT) in place of IVF-PQ ones (PQ is not ported). Across
packages the data is integer-valued (every distance an exact f32
integer): ids equal up to ties, distances bit for bit."""

import os

import numpy as np
import pytest

import tpu_ann_torch as T
from tpu_ann.models.ivf import make_ivf_flat as jmake_ivf_flat
from tpu_ann.utils import index_io as jio
from tpu_ann.utils import invlists_io as jinv
from tpu_ann_torch.utils import index_io as tio
from tpu_ann_torch.utils.invlists_io import (
    ArraySource,
    FileInvlistSource,
    HStackInvlists,
    IndexInvlistSource,
    MaskedInvlists,
    OnDiskInvertedLists,
    SliceInvlists,
    StopWordsInvlists,
    VStackInvlists,
    merge_ondisk,
)
from torch_parity import assert_topk_equal

K = 10


@pytest.fixture(scope="module")
def ds():
    """The JAX tests' small_ds: SyntheticDataset(d=32, nt=2000, nb=4000,
    nq=100), the same rows in both packages."""
    return T.SyntheticDataset(d=32, nt=2000, nb=4000, nq=100, device="cpu")


def _ivf(cls, quantizer, d, nlist, **kw):
    idx = cls(quantizer, d, nlist, device="cpu", **kw)
    idx.is_trained = True
    return idx


def _mk_shards(ds, nshard=3, nlist=32):
    base = T.make_ivf_flat(ds.d, nlist, device="cpu")
    base.cp.niter = 5
    base.train(ds.get_train())
    xb = ds.get_database()
    bounds = np.linspace(0, len(xb), nshard + 1, dtype=int)
    shards = []
    for s in range(nshard):
        ix = _ivf(T.IndexIVFFlat, base.quantizer, ds.d, nlist)
        lo, hi = bounds[s], bounds[s + 1]
        ix.add_with_ids(xb[lo:hi], np.arange(lo, hi, dtype=np.int64))
        shards.append(ix)
    oracle = _ivf(T.IndexIVFFlat, base.quantizer, ds.d, nlist)
    oracle.add_with_ids(xb, np.arange(len(xb), dtype=np.int64))
    return base, shards, oracle, xb


def test_views_semantics():
    p0 = [np.full((2, 4), 1.0, np.float32), np.zeros((0, 4), np.float32)]
    i0 = [np.array([10, 11]), np.array([], np.int64)]
    p1 = [np.full((1, 4), 2.0, np.float32), np.full((3, 4), 3.0, np.float32)]
    i1 = [np.array([20]), np.array([30, 31, 32])]
    a, b = ArraySource(p0, i0), ArraySource(p1, i1)

    h = HStackInvlists([a, b])
    assert h.nlist == 2 and h.list_size(0) == 3 and h.list_size(1) == 3
    assert list(h.get_list(0)[1]) == [10, 11, 20]

    v = VStackInvlists([a, b])
    assert v.nlist == 4
    assert [v.list_size(i) for i in range(4)] == [2, 0, 1, 3]
    assert list(v.get_list(3)[1]) == [30, 31, 32]

    s = SliceInvlists(v, 1, 3)
    assert s.nlist == 2 and s.list_size(1) == 1
    assert list(s.get_list(1)[1]) == [20]

    m = MaskedInvlists(a, b)
    assert m.list_size(0) == 2
    assert list(m.get_list(1)[1]) == [30, 31, 32]

    sw = StopWordsInvlists(b, maxsize=2)
    assert sw.list_size(0) == 1 and sw.list_size(1) == 0
    assert len(sw.get_list(1)[0]) == 0

    with pytest.raises(ValueError):
        HStackInvlists([a, ArraySource([np.zeros((1, 5), np.float32)],
                                       [np.array([1])])])


def test_file_source_host_form(ds, tmp_path):
    """A raw-float IVF file written il_from_host holds no packed lists;
    FileInvlistSource serves each list from the mmapped host store."""
    _, shards, _, _ = _mk_shards(ds, nshard=1)
    sh = shards[0]
    p = str(tmp_path / "hostform.tann")
    T.write_index(sh, p)
    meta, arrays = tio._read_container(p, mmap=True)
    assert meta.get("il_from_host") and "il_data" not in arrays
    src = FileInvlistSource(p)
    assert src.nlist == sh.nlist and src.ntotal == sh.ntotal
    sizes = [src.list_size(i) for i in range(src.nlist)]
    np.testing.assert_array_equal(sizes, sh.list_sizes)
    li = int(np.argmax(sizes))
    payload, ids = src.get_list(li)
    assert payload.shape == (sizes[li], sh.d)
    assert len(set(ids.tolist())) == sizes[li]


def test_merge_ondisk_flat(ds, tmp_path):
    base, shards, oracle, xb = _mk_shards(ds)
    paths = []
    for j, sh in enumerate(shards):
        paths.append(str(tmp_path / f"shard{j}.tann"))
        T.write_index(sh, paths[-1])
    empty = _ivf(T.IndexIVFFlat, base.quantizer, ds.d, base.nlist)
    dst = str(tmp_path / "merged.tann")
    n = merge_ondisk(empty, [FileInvlistSource(p) for p in paths], dst)
    assert n == len(xb)

    loaded = T.read_index(dst, mmap=True, device="cpu")
    assert loaded.ntotal == len(xb) and loaded.invlists is not None
    xq = ds.get_queries()
    loaded.nprobe = oracle.nprobe = 8
    D0, I0 = oracle.search(xq, K)
    D1, I1 = loaded.search(xq, K)
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(D0, D1)
    # a merged raw-float file keeps the host store: still mutable
    loaded.add_with_ids(xb[:5], np.arange(10_000, 10_005, dtype=np.int64))
    assert loaded.ntotal == len(xb) + 5


def test_index_source_matches_file_source(ds, tmp_path):
    _, shards, _, _ = _mk_shards(ds, nshard=1)
    sh = shards[0]
    p = str(tmp_path / "s.tann")
    T.write_index(sh, p)
    a, b = IndexInvlistSource(sh), FileInvlistSource(p)
    assert a.nlist == b.nlist
    for li in range(a.nlist):
        assert a.list_size(li) == b.list_size(li)
        if a.list_size(li):
            pa, ia = a.get_list(li)
            pb, ib = b.get_list(li)
            assert set(ia) == set(ib)
            np.testing.assert_array_equal(pa[np.argsort(ia)],
                                          pb[np.argsort(ib)])


def test_merge_ondisk_coded(ds, tmp_path):
    """IVF-SQ8 shards (packed uint8 codes in their files) merge into a
    search-only IVF-SQ8 file."""
    xt = np.round(ds.get_train() * 60 + 128).clip(0, 255).astype(np.float32)
    xb = np.round(ds.get_database() * 60 + 128).clip(0, 255).astype(
        np.float32)
    nlist = 16
    base = T.make_ivf_flat(ds.d, nlist, device="cpu")
    base.cp.niter = 5
    base.train(xt)

    def sq_index():
        return _ivf(T.IndexIVFScalarQuantizer, base.quantizer, ds.d, nlist,
                    qtype=T.QT_8BIT_DIRECT)

    half = len(xb) // 2
    paths = []
    for j, (lo, hi) in enumerate(((0, half), (half, len(xb)))):
        ix = sq_index()
        ix.train_encoder(xt)
        ix.add_with_ids(xb[lo:hi], np.arange(lo, hi, dtype=np.int64))
        paths.append(str(tmp_path / f"sq{j}.tann"))
        T.write_index(ix, paths[-1])
    srcs = [FileInvlistSource(p) for p in paths]
    assert all(s.coded for s in srcs)
    oracle = sq_index()
    oracle.train_encoder(xt)
    oracle.add_with_ids(xb, np.arange(len(xb), dtype=np.int64))
    empty = sq_index()
    empty.train_encoder(xt)
    dst = str(tmp_path / "sq_merged.tann")
    assert merge_ondisk(empty, srcs, dst) == len(xb)
    with pytest.raises(ValueError, match="expects raw"):
        merge_ondisk(_ivf(T.IndexIVFFlat, base.quantizer, ds.d, nlist), srcs,
                     str(tmp_path / "bad.tann"))

    loaded = T.read_index(dst, mmap=True, device="cpu")
    xq = np.round(ds.get_queries() * 60 + 128).clip(0, 255).astype(
        np.float32)
    loaded.nprobe = oracle.nprobe = 8
    D0, I0 = oracle.search(xq, K)
    D1, I1 = loaded.search(xq, K)
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(D0, D1)
    with pytest.raises(RuntimeError):        # a coded merge is search-only
        loaded.add_with_ids(xb[:3], np.arange(3, dtype=np.int64))


def test_merge_ondisk_coded_pq(ds, tmp_path):
    """The twin of the JAX tests' test_merge_ondisk_coded: IndexIVFPQ
    shards over one quantizer and codebook merge on disk into a
    search-only IVFPQ file, reopened with mmap. Its (D, I) equal the
    in-memory merge's and one index's over all rows bit for bit (the
    reference holds ranks to 90%); the JAX package reads the file too."""
    xt, xb = ds.get_train(), ds.get_database()
    nlist = 16
    base = T.IndexIVFPQ(T.IndexFlat(ds.d, device="cpu"), ds.d, nlist, 4, 8,
                        device="cpu")
    base.cp.niter = 5
    base.train(xt)

    def pq_index():
        ix = _ivf(T.IndexIVFPQ, base.quantizer, ds.d, nlist, M=4, nbits=8)
        ix._set_codec(base.pq.centroids)
        return ix

    half = len(xb) // 2
    shards, paths = [], []
    for j, (lo, hi) in enumerate(((0, half), (half, len(xb)))):
        ix = pq_index()
        ix.add_with_ids(xb[lo:hi], np.arange(lo, hi, dtype=np.int64))
        paths.append(str(tmp_path / f"pq{j}.tann"))
        T.write_index(ix, paths[-1])
        shards.append(ix)
    ram = pq_index()
    T.merge_indexes(ram, shards)
    one = pq_index()
    one.add_with_ids(xb, np.arange(len(xb), dtype=np.int64))
    dst = str(tmp_path / "pq_merged.tann")
    assert merge_ondisk(pq_index(), [FileInvlistSource(p) for p in paths],
                        dst) == len(xb)
    loaded = T.read_index(dst, mmap=True, device="cpu")
    assert isinstance(loaded, T.IndexIVFPQ)
    xq = ds.get_queries()
    for idx in (loaded, ram, one):
        idx.nprobe = 8
    D1, I1 = loaded.search(xq, K)
    for D0, I0 in (ram.search(xq, K), one.search(xq, K)):
        np.testing.assert_array_equal(I1, I0)
        np.testing.assert_array_equal(D1, D0)
    ref = jio.read_index(dst, mmap=True)
    ref.nprobe, ref.max_list_scan_factor = 8, 0
    D2, I2 = ref.search(xq, K)
    assert np.mean([len(set(a) & set(b)) / K for a, b in zip(I2, I1)]) \
        >= 0.99
    with pytest.raises(RuntimeError):        # a coded merge is search-only
        loaded.add_with_ids(xb[:3], np.arange(3, dtype=np.int64))


def test_ondisk_slot_allocator(tmp_path):
    """OnDiskInvertedLists (OnDiskInvertedLists.h:132-133): chunked adds
    fill block padding, then free or new blocks; removals free emptied
    blocks; untouched blocks are never rewritten."""
    p = str(tmp_path / "lists.todl")
    il = OnDiskInvertedLists.create(p, nlist=4, width=8, block_size=4)
    rs = np.random.RandomState(0)

    x0 = rs.randn(6, 8).astype(np.float32)
    il.add_entries(0, x0, np.arange(6))
    assert il.list_size(0) == 6 and il.nblocks == 2
    il.add_entries(0, rs.randn(2, 8).astype(np.float32), np.arange(6, 8))
    assert il.nblocks == 2 and il.list_size(0) == 8

    with open(p, "rb") as f:
        b0_before = f.read(il._block_bytes)
    il.add_entries(1, rs.randn(5, 8).astype(np.float32),
                   np.arange(100, 105))
    with open(p, "rb") as f:
        assert f.read(il._block_bytes) == b0_before
    assert il.nblocks == 4

    assert il.remove_entries(0, np.arange(4, 8)) == 4
    assert len(il.free_blocks) == 1 and il.list_size(0) == 4
    il.add_entries(2, rs.randn(3, 8).astype(np.float32), np.arange(200, 203))
    assert il.nblocks == 4 and not il.free_blocks

    il.flush()
    il2 = OnDiskInvertedLists(p)
    _, ids = il2.get_list(1)
    assert len(ids) == 5 and set(ids) == set(range(100, 105))
    py, i0 = il2.get_list(0)
    assert set(i0) == set(range(4))
    np.testing.assert_array_equal(py, x0[:4])


def test_ondisk_allocator_feeds_merge(ds, tmp_path):
    """The allocator is an InvlistSource: it feeds merge_ondisk directly
    and the result is a searchable mmap index."""
    d = ds.d
    xb = ds.get_database()[:2000]
    trained = T.make_ivf_flat(d, 8, device="cpu")
    trained.cp.niter = 4
    trained.train(ds.get_train())
    p = str(tmp_path / "grow.todl")
    il = OnDiskInvertedLists.create(p, nlist=8, width=d)
    for lo, hi in ((0, 1000), (1000, 2000)):
        a = trained._assign(xb[lo:hi])
        for li in np.unique(a):
            m = a == li
            il.add_entries(int(li), xb[lo:hi][m], np.arange(lo, hi)[m])
    dst = str(tmp_path / "merged.tann")
    assert merge_ondisk(trained, il, dst) == 2000
    idx = T.read_index(dst, mmap=True, device="cpu")
    idx.nprobe = 8
    _, Iv = idx.search(xb[:10], 1)
    np.testing.assert_array_equal(Iv[:, 0], np.arange(10))


def test_ivf_save_skips_invlist_download(ds):
    """Raw-float IVF dumps do not serialize the packed device invlists when
    the host store is complete: the rows, ids and int32 assignments are
    written, and the first use after a load repacks."""
    idx = T.make_ivf_flat(ds.d, 16, device="cpu")
    idx.cp.niter = 4
    idx.train(ds.get_train())
    idx.add(ds.get_database())
    m, a = tio.dump_index(idx)
    assert m["il_from_host"] is True
    assert "il_data" not in a and "il_norms" not in a
    assert a["assign_host"].dtype == np.int32
    idx2 = tio.load_index(m, a, device="cpu")
    assert idx2.invlists is None and idx2._dirty
    idx.nprobe = idx2.nprobe = 4
    xq = ds.get_queries()[:20]
    np.testing.assert_array_equal(idx.search(xq, 5)[1],
                                  idx2.search(xq, 5)[1])


@pytest.fixture(scope="module")
def int_data():
    rs = np.random.RandomState(9)
    cents = rs.randint(20, 230, (20, 32))
    x = cents[rs.randint(20, size=4040)] + rs.randint(-15, 16, (4040, 32))
    x = np.clip(x, 0, 255).astype(np.float32)
    return x[:3000], x[3000:4000], x[4000:]


def test_port_merge_read_by_jax(int_data, tmp_path):
    xb, xt, xq = int_data
    base = T.make_ivf_flat(32, 16, device="cpu")
    base.cp.niter = 4
    base.train(xt)
    srcs = []
    for j, (lo, hi) in enumerate(((0, 1500), (1500, 3000))):
        ix = _ivf(T.IndexIVFFlat, base.quantizer, 32, 16)
        ix.add_with_ids(xb[lo:hi], np.arange(lo, hi, dtype=np.int64))
        p = str(tmp_path / f"t{j}.tann")
        T.write_index(ix, p)
        srcs.append(FileInvlistSource(p))
    dst = str(tmp_path / "t_merged.tann")
    merge_ondisk(_ivf(T.IndexIVFFlat, base.quantizer, 32, 16), srcs, dst)
    port = T.read_index(dst, mmap=True, device="cpu")
    ref = jio.read_index(dst, mmap=True)
    assert ref.ntotal == port.ntotal == len(xb)
    port.nprobe = ref.nprobe = 4
    D0, I0 = ref.search(xq, K)
    D1, I1 = port.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1)


def test_jax_merge_read_by_port(int_data, tmp_path):
    xb, xt, xq = int_data
    base = jmake_ivf_flat(32, 16)
    base.cp.niter = 4
    base.train(xt)
    paths = []
    for j, (lo, hi) in enumerate(((0, 1500), (1500, 3000))):
        ix = jmake_ivf_flat(32, 16)
        ix.quantizer, ix.is_trained = base.quantizer, True
        ix.add_with_ids(xb[lo:hi], np.arange(lo, hi, dtype=np.int64))
        paths.append(str(tmp_path / f"j{j}.tann"))
        jio.write_index(ix, paths[-1])
    dst = str(tmp_path / "j_merged.tann")
    jinv.merge_ondisk(base, [jinv.FileInvlistSource(p) for p in paths], dst)
    ref = jio.read_index(dst, mmap=True)
    port = T.read_index(dst, mmap=True, device="cpu")
    # the port's sources read the JAX package's files too
    assert FileInvlistSource(paths[0]).ntotal == 1500
    assert os.path.getsize(dst) > 0
    port.nprobe = ref.nprobe = 4
    D0, I0 = ref.search(xq, K)
    D1, I1 = port.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1)
