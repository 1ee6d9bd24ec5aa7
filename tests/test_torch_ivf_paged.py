"""Port parity for the out-of-core index (tpu_ann_torch.models.ivf_paged):
build -> save -> mmap-load -> search on the CPU, a JAX-built directory
searched by the port, recall parity with the in-memory IndexIVFFlat, and
the index API around it."""

import numpy as np
import pytest

import tpu_ann_torch as T
from torch_parity import assert_topk_equal

N, D, NLIST, NQ, K = 3000, 32, 16, 30, 10


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(21)
    return (rs.randn(N, D).astype(np.float32),
            rs.randn(NQ, D).astype(np.float32))


def _knobs(idx, nprobe=6):
    idx.window_blocks = 4              # real paging: several windows
    idx.tile_batch = 2
    idx.nprobe = nprobe
    return idx


@pytest.fixture(scope="module")
def port_index(data, tmp_path_factory):
    x, _ = data
    path = str(tmp_path_factory.mktemp("torch_paged"))
    idx = T.IndexIVFFlatPaged(D, NLIST, path, device="cpu")
    idx.assign_chunk = 1000            # 3 chunks in both passes
    idx.cp_niter = 5
    idx.train(x[:2000])
    xm = np.memmap(path + "/xb.f32", mode="w+", dtype=np.float32,
                   shape=x.shape)
    xm[:] = x
    idx.add(xm)
    return idx


def test_build_save_load_search(port_index, data):
    x, xq = data
    assert port_index.ntotal == N
    assert port_index.invlists.ntotal == N
    idx = _knobs(T.IndexIVFFlatPaged.load(port_index.path, device="cpu"))
    assert (idx.d, idx.nlist, idx.ntotal) == (D, NLIST, N)
    np.testing.assert_array_equal(idx.centroids, port_index.centroids)
    D1, I1 = idx.search(xq, K)
    D0, I0 = _knobs(port_index).search(xq, K)
    np.testing.assert_array_equal(I1, I0)
    np.testing.assert_array_equal(D1, D0)
    assert I1.dtype == np.int64 and D1.dtype == np.float32
    # exact f32 re-rank: the returned distances are the true ones
    true = ((x[np.maximum(I1, 0)] - xq[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(D1[I1 >= 0], true[I1 >= 0], rtol=1e-4)


def test_recall_parity_with_in_memory_ivf(port_index, data):
    """The same centroids in an in-memory IndexIVFFlat (K3's path) find
    the same neighbours."""
    x, xq = data
    oracle = T.make_ivf_flat(D, NLIST, device="cpu")
    oracle.quantizer.add(port_index.centroids)
    oracle.is_trained = True
    oracle.add(x)
    Do, Io = oracle.search(xq, K, params=T.SearchParametersIVF(nprobe=8))
    Dp, Ip = _knobs(port_index, nprobe=8).search(xq, K)
    rec = np.mean([len(set(Ip[q]) & set(Io[q])) / K for q in range(NQ)])
    assert rec >= 0.98, rec
    assert_topk_equal(Do, Io, Dp, Ip, rtol=1e-5)


def test_search_jax_built_directory(data, tmp_path):
    """The port loads a directory the JAX package built and finds the JAX
    index's neighbours. The JAX index keeps the RW=512 reservoir, which
    may drop a candidate, hence an overlap bound; matching ids carry
    equal distances."""
    from tpu_ann.models.ivf_paged import IndexIVFFlatPaged as JIndex

    x, xq = data
    path = str(tmp_path / "jax_paged")
    jidx = JIndex(D, NLIST, path)
    jidx.scan_interpret = True
    jidx.assign_chunk = 1000
    jidx.cp_niter = 5
    jidx.train(x[:2000])
    jidx.add(x)
    jidx.window_blocks, jidx.tile_batch, jidx.nprobe = 4, 2, 6
    D0, I0 = jidx.search(xq, K)

    idx = _knobs(T.IndexIVFFlatPaged.load(path, device="cpu"))
    np.testing.assert_array_equal(idx.centroids, jidx.centroids)
    D1, I1 = idx.search(xq, K)
    overlap = np.mean([len(set(I0[q]) & set(I1[q])) / K
                       for q in range(NQ)])
    assert overlap >= 0.99, overlap
    for q in range(NQ):
        for j, i in enumerate(I1[q]):
            hit = np.nonzero(I0[q] == i)[0]
            if i >= 0 and len(hit):
                np.testing.assert_allclose(D1[q, j], D0[q, hit[0]],
                                           rtol=1e-5)


def test_search_stats_fields(port_index, data):
    _, xq = data
    idx = _knobs(port_index)
    Ds, Is, st = idx.search_stats(xq, K)
    Dv, Iv = idx.search(xq, K)
    np.testing.assert_array_equal(Is, Iv)
    np.testing.assert_array_equal(Ds, Dv)
    assert st.nq == NQ and st.ndis > 0 and st.nlist_visited == NQ * 6
    assert st.total_us >= st.quantization_us > 0 and st.list_scan_us > 0
    assert {"windows", "calls", "bytes_uploaded", "windows_resident",
            "stage_ms", "upload_ms", "windows_ms", "gather_ms",
            "rerank_ms"} <= set(st.extra)
    assert st.extra["windows"] >= 2
    assert st.extra["calls"] >= st.extra["windows"]
    assert "extra" not in st.as_dict()
    total = T.SearchStats()
    total.accumulate(st)
    assert total.ndis == st.ndis and total.extra is None
    st.reset()
    assert st.extra is None and st.ndis == 0


def test_results_do_not_depend_on_tile_batch_or_window(port_index, data):
    _, xq = data
    idx = _knobs(port_index)
    D0, I0 = idx.search(xq, K)
    idx.window_blocks, idx.tile_batch = 8192, 4096
    D1, I1 = idx.search(xq, K)
    idx.resident_blocks = idx.invlists.nblocks // 2
    idx.window_blocks, idx.tile_batch = 2, 3
    D2, I2, st = idx.search_stats(xq, K)
    idx.resident_blocks, idx._resident = 0, None
    for Dx, Ix in ((D1, I1), (D2, I2)):
        np.testing.assert_array_equal(Dx, D0)
        np.testing.assert_array_equal(Ix, I0)
    assert st.extra["windows_resident"] >= 1


def test_reconstruct_reset_and_errors(port_index, data, tmp_path):
    x, xq = data
    for key in (0, 17, N - 1):
        np.testing.assert_array_equal(port_index.reconstruct(key), x[key])
    with pytest.raises(KeyError):
        port_index.reconstruct(N + 5)
    with pytest.raises(RuntimeError, match="builds once"):
        port_index.add(x)

    fresh = T.IndexIVFFlatPaged(D, NLIST, str(tmp_path / "p"), device="cpu")
    with pytest.raises(RuntimeError, match="train"):
        fresh.add(x)
    with pytest.raises(RuntimeError, match="empty"):
        fresh.search(xq, K)

    idx = T.IndexIVFFlatPaged.load(port_index.path, device="cpu")
    idx.reset()
    assert idx.ntotal == 0 and idx.invlists is None
    # trained, no rows: faiss's empty result, ids -1 at the worst value
    Dv, Iv = idx.search(xq, K)
    assert Dv.shape == Iv.shape == (len(xq), K)
    assert (Iv == -1).all() and np.isinf(Dv).all()
