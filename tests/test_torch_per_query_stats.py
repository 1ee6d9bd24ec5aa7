"""Port twins of tests/test_per_query_stats.py: the per-query
QueryLatencyStats of tpu_ann_torch (IndexIVF.search_stats_per_query, the
generic Index fallback, search_preassigned and utils.benchmark's
per_query_latency), on the CPU.

The contract: (nq,) arrays, the phase split summing to the total, the
batch aggregates their sums, ndis the exact entry count of each query's
probed lists, and the results of search(). Against the JAX package the
index is carried over through an index file (the JAX package writes, the
port reads), so both search the same lists; the data is integer-valued
(every distance an exact f32 integer): per-query (D, I) and ndis equal the
JAX package's, ids up to ties."""

import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.models.ivf import make_ivf_flat as jmake_ivf_flat
from tpu_ann.utils import index_io as jio
from torch_parity import assert_topk_equal

N, NT, NQ, D, K, NLIST = 3000, 1000, 24, 32, 5, 16


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(13)
    n = N + NT + NQ
    cents = rs.randint(20, 230, (24, D))
    x = cents[rs.randint(24, size=n)] + rs.randint(-15, 16, (n, D))
    x = np.clip(x, 0, 255).astype(np.float32)
    return x[:N], x[N:N + NT], x[N + NT:]


@pytest.fixture(scope="module")
def pair(data, tmp_path_factory):
    """A JAX IVF-Flat index (nprobe 4) and the port's copy of it, read from
    the file the JAX package wrote."""
    xb, xt, _ = data
    j = jmake_ivf_flat(D, NLIST)
    j.cp.niter = 4
    j.train(xt)
    j.add(xb)
    j.nprobe = 4
    path = str(tmp_path_factory.mktemp("pq") / "ivf.tann")
    jio.write_index(j, path)
    return j, T.read_index(path, device="cpu")


def test_per_query_contract(pair, data):
    _, index = pair
    xq = data[2]
    Dv, Iv, st = index.search_stats_per_query(xq, K)
    pq = st.per_query
    assert pq is not None
    for f in ("total_us", "quantization_us", "list_scan_us", "ndis"):
        assert getattr(pq, f).shape == (NQ,), f
    np.testing.assert_allclose(pq.total_us,
                               pq.quantization_us + pq.list_scan_us,
                               rtol=1e-9)
    assert (pq.total_us > 0).all()
    assert st.nq == NQ and st.nlist_visited == NQ * 4
    np.testing.assert_allclose(st.total_us, pq.total_us.sum())
    np.testing.assert_allclose(st.quantization_us, pq.quantization_us.sum())
    assert st.ndis == int(pq.ndis.sum())
    assert Dv.shape == Iv.shape == (NQ, K) and Iv.dtype == np.int64


def test_per_query_ndis_exact(pair, data):
    """ndis[q] is the summed size of q's probed lists, and equals the JAX
    package's per-query ndis on the same index."""
    j, index = pair
    xq = data[2]
    _, _, st = index.search_stats_per_query(xq, K)
    lsizes = index._list_sizes_host()
    assert int(lsizes.sum()) == index.ntotal
    np.testing.assert_array_equal(lsizes, j._list_sizes_host())
    _, probes = index._coarse_search_device(torch.from_numpy(xq), 4)
    np.testing.assert_array_equal(st.per_query.ndis,
                                  lsizes[probes.numpy()].sum(1))
    _, _, jst = j.search_stats_per_query(xq, K)
    np.testing.assert_array_equal(st.per_query.ndis, jst.per_query.ndis)


def test_per_query_results_match_search_and_reference(pair, data):
    j, index = pair
    xq = data[2]
    D1, I1 = index.search(xq, K)
    D2, I2, _ = index.search_stats_per_query(xq, K)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)
    D3, I3, _ = j.search_stats_per_query(xq, K)
    assert_topk_equal(D3, I3, D2, I2)


def test_per_query_params_override(pair, data):
    j, index = pair
    xq = data[2][:8]
    _, _, st = index.search_stats_per_query(
        xq, K, params=T.SearchParametersIVF(nprobe=NLIST))
    assert st.nlist_visited == 8 * NLIST
    assert (st.per_query.ndis == index.ntotal).all()
    assert index.nprobe == 4
    _, _, jst = j.search_stats_per_query(xq, K,
                                         params=JParams(nprobe=NLIST))
    np.testing.assert_array_equal(st.per_query.ndis, jst.per_query.ndis)


def test_per_query_generic_fallback(data):
    """Non-IVF indexes get the generic per-query loop (total only)."""
    xb, _, xq = data
    idx = T.IndexFlat(D, device="cpu")
    idx.add(xb)
    Dv, Iv, st = idx.search_stats_per_query(xq[:8], K)
    pq = st.per_query
    assert pq.total_us.shape == (8,) and (pq.total_us > 0).all()
    np.testing.assert_array_equal(pq.list_scan_us, pq.total_us)
    assert not pq.quantization_us.any() and not pq.ndis.any()
    D1, I1 = idx.search(xq[:8], K)
    np.testing.assert_array_equal(I1, Iv)
    np.testing.assert_array_equal(D1, Dv)


def test_per_query_latency_report(pair, data):
    _, index = pair
    rep = T.per_query_latency(index, data[2], K, sample=16)
    assert rep["nq"] == 16
    for f in ("total_us", "quantization_us", "list_scan_us"):
        assert set(rep[f]) == {"mean", "p50", "p99", "p99.9"}
        assert rep[f]["p99.9"] >= rep[f]["p50"] > 0
    assert rep["ndis"]["mean"] > 0 and rep["ndis"]["max"] <= index.ntotal


@pytest.mark.parametrize("mode", ["auto", "quantizer"])
def test_per_query_hybrid(data, mode):
    """The namesake hybrid reports the split in both coarse modes, and its
    per-query results are search()'s (the HNSW quantizer is deterministic
    per query)."""
    xb, xt, xq = data
    index = T.IndexIVFHNSW(D, 32, M=8, device="cpu")
    index.cp.niter = 4
    index.train(xt)
    index.add(xb)
    index.nprobe = 4
    index.coarse_mode = mode
    Dv, Iv, st = index.search_stats_per_query(xq[:8], K)
    assert (st.per_query.quantization_us > 0).all()
    assert (st.per_query.list_scan_us > 0).all()
    D1, I1 = index.search(xq[:8], K)
    np.testing.assert_array_equal(I1, Iv)
    np.testing.assert_array_equal(D1, Dv)


def test_search_preassigned_matches_reference(pair, data):
    j, index = pair
    xq = data[2]
    rs = np.random.RandomState(3)
    probes = np.stack([rs.choice(NLIST, 3, replace=False)
                       for _ in range(NQ)]).astype(np.int64)
    probes[::4, -1] = -1                       # skipped probes
    D0, I0 = j.search_preassigned(xq, K, probes)
    D1, I1 = index.search_preassigned(xq, K, probes)
    assert_topk_equal(D0, I0, D1, I1)
    D2, I2, st = index.search_preassigned_stats(xq, K, probes)
    np.testing.assert_array_equal(I1, I2)
    assert st.quantization_us == 0 and st.list_scan_us > 0
    assert st.nlist_visited == NQ * 3
    # its own probes give search()'s results
    _, own = index._coarse_search_device(torch.from_numpy(xq), 4)
    D3, I3 = index.search_preassigned(xq, K, own.numpy())
    D4, I4 = index.search(xq, K)
    np.testing.assert_array_equal(I3, I4)
    np.testing.assert_array_equal(D3, D4)


def test_ivf_sq8_per_query_through_its_scan(data):
    """IndexIVFScalarQuantizer overrides the scan, so its per-query path
    scans the SQ8 stream (QT_8BIT_DIRECT on integer data: equal to
    search()'s results)."""
    xb, xt, xq = data
    index = T.IndexIVFScalarQuantizer(T.IndexFlat(D, device="cpu"), D, NLIST,
                                      T.QT_8BIT_DIRECT, device="cpu")
    index.cp.niter = 4
    index.train(xt)
    index.add(xb)
    index.nprobe = 4
    D1, I1 = index.search(xq, K)
    D2, I2, st = index.search_stats_per_query(xq, K)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)
    assert st.ndis == int(st.per_query.ndis.sum()) > 0
