"""The inspect tools and the adaptive range search of tpu_ann_torch
(utils/contrib.py: contrib/inspect_tools.py and
exhaustive_search.range_search_max_results roles) against the JAX
package's, on the CPU.

Indexes built by the JAX package come across through its index file
(`write_index`, read by the port's `read_index(device="cpu")`), so both
hold the same codebooks, codes and graphs. Data: d 24, 3000 rows of small
integers from a numpy seed, so every flat distance is exact in f32 in both
packages. Tolerances: the extracted arrays (PQ centroids, flat rows and
codes, AQ codebooks, NSG neighbours) are bit-equal; a PCA's (A, b) within
1e-6 of the reference's (both train on the host in numpy, in f64);
range_search_max_results equals the reference's radius, lims, distances
and ids exactly."""

import numpy as np
import pytest

from tpu_ann.utils import contrib as JC
from tpu_ann.utils.factory import index_factory as jfactory
from tpu_ann.utils.index_io import write_index as jwrite
from tpu_ann_torch.utils import contrib as TC
from tpu_ann_torch.utils.factory import index_factory as tfactory
from tpu_ann_torch.utils.index_io import read_index as tread

D = 24


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(3)
    return rs.randint(0, 12, (3000, D)).astype(np.float32)


def _carried(j, tmp_path, name):
    path = str(tmp_path / name)
    jwrite(j, path)
    return tread(path, device="cpu")


def test_get_pq_centroids_and_codes(data, tmp_path):
    j = jfactory(D, "PQ4x8")
    j.train(data)
    j.add(data[:500])
    t = _carried(j, tmp_path, "pq.tann")
    np.testing.assert_array_equal(TC.get_pq_centroids(t),
                                  JC.get_pq_centroids(j))
    assert TC.get_pq_centroids(t).shape == (4, 256, 6)
    codes = TC.get_flat_codes(t)
    assert codes.shape == (500, 4) and codes.dtype == np.uint8
    np.testing.assert_array_equal(codes, JC.get_flat_codes(j))
    with pytest.raises(ValueError):
        TC.get_pq_centroids(tfactory(D, "Flat", device="cpu"))


def test_get_linear_transform(data):
    from tpu_ann.models.transforms import PCAMatrix as JPCA
    from tpu_ann_torch.models.transforms import PCAMatrix as TPCA

    vt, vj = TPCA(D, 8, device="cpu"), JPCA(D, 8)
    vt.train(data)
    vj.train(data)
    (At, bt), (Aj, bj) = TC.get_linear_transform(vt), \
        JC.get_linear_transform(vj)
    np.testing.assert_allclose(At, Aj, atol=1e-6)
    np.testing.assert_allclose(bt, bj, atol=1e-6)
    np.testing.assert_allclose(data[:5] @ At.T + bt,
                               np.asarray(vt.apply(data[:5])), rtol=1e-4,
                               atol=1e-4)
    A = np.random.RandomState(0).randn(8, D).astype(np.float32)
    b = np.ones(8, np.float32)
    m = TC.make_LinearTransform_matrix(A, b, device="cpu")
    np.testing.assert_allclose(np.asarray(m.apply(data[:10])),
                               data[:10] @ A.T + b, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(TC.get_linear_transform(m)[0], A)


def test_inspect_tools(data, tmp_path, capsys):
    """Flat rows, AQ codebooks and NSG neighbours of carried-over indexes
    equal the reference's; print_object_fields prints the public scalar
    fields."""
    from tpu_ann.models.nsg import IndexNSGFlat as JNSG
    from tpu_ann.models.rq import IndexResidualQuantizer as JRQ

    jf = jfactory(D, "Flat")
    jf.add(data[:700])
    tf = _carried(jf, tmp_path, "flat.tann")
    np.testing.assert_array_equal(TC.get_flat_data(tf),
                                  JC.get_flat_data(jf))
    jr = JRQ(D, 2, 4)
    jr.train(data[:1500])
    tr = _carried(jr, tmp_path, "rq.tann")
    np.testing.assert_array_equal(
        TC.get_additive_quantizer_codebooks(tr),
        JC.get_additive_quantizer_codebooks(jr))
    assert TC.get_additive_quantizer_codebooks(tr).shape == (2, 16, D)
    jn = JNSG(D, 16)
    jn.add(data[:800])
    tn = _carried(jn, tmp_path, "nsg.tann")
    nb = TC.get_NSG_neighbors(tn)
    assert nb.shape[0] == 800 and nb.dtype == np.int64
    np.testing.assert_array_equal(nb, JC.get_NSG_neighbors(jn))
    TC.print_object_fields(tf)
    out = capsys.readouterr().out
    assert "ntotal = 700" in out and "d = 24" in out
    assert "device = <device>" in out


@pytest.fixture(scope="module")
def flats(data):
    j = jfactory(D, "Flat")
    j.add(data)
    t = tfactory(D, "Flat", device="cpu")
    t.add(data)
    return j, t


@pytest.mark.parametrize("max_results,batch", [(1500, 16), (4000, 64),
                                               (900, 7)])
def test_range_search_max_results(flats, data, max_results, batch):
    """The tightened radius and every kept hit equal the reference's; the
    kept hits are the flat range search at the final radius (L2 keeps d <
    radius, and the tightening keeps d <= the new radius)."""
    j, t = flats
    xq = data[:64]
    big_r = 400.0
    assert len(t.range_search(xq, big_r)[1]) > max_results
    rt = TC.range_search_max_results(t, xq, big_r, max_results=max_results,
                                     batch_size=batch)
    rj = JC.range_search_max_results(j, xq, big_r, max_results=max_results,
                                     batch_size=batch)
    assert rt[0] == rj[0] < big_r
    for a, b in zip(rt[1:], rj[1:]):
        np.testing.assert_array_equal(a, b)
    r, lims, Dv, Iv = rt
    assert len(Dv) <= max_results and lims[0] == 0 and lims[-1] == len(Dv)
    assert len(lims) == len(xq) + 1 and (Dv <= r).all()
    for q in range(len(xq)):
        assert q in Iv[lims[q]:lims[q + 1]]


def test_range_search_max_results_no_tighten(flats, data):
    j, t = flats
    xq = data[:8]
    r, lims, Dv, Iv = TC.range_search_max_results(
        t, xq, 1e-3, max_results=1000, batch_size=4)
    assert r == 1e-3
    l0, d0, i0 = t.range_search(xq, 1e-3)
    np.testing.assert_array_equal(lims, l0)
    np.testing.assert_array_equal(Iv, i0)
    rj = JC.range_search_max_results(j, xq, 1e-3, max_results=1000,
                                     batch_size=4)
    for a, b in zip((r, lims, Dv, Iv), rj):
        np.testing.assert_array_equal(a, b)


def test_index_api_conveniences(data):
    """assign / reconstruct_batch / search_and_reconstruct / merge_from
    (faiss/Index.h:104, 231, 244) as the reference's."""
    t = tfactory(D, "Flat", device="cpu")
    t.add(data[:2000])
    np.testing.assert_array_equal(t.assign(data[:5], k=1)[:, 0],
                                  np.arange(5))
    np.testing.assert_array_equal(t.reconstruct_batch([3, 7, 1]),
                                  data[[3, 7, 1]])
    Dv, Iv, R = t.search_and_reconstruct(data[:4], 2)
    jt = jfactory(D, "Flat")
    jt.add(data[:2000])
    Dj, Ij, Rj = jt.search_and_reconstruct(data[:4], 2)
    np.testing.assert_array_equal(Dv, Dj)
    assert R.shape == (4, 2, D)
    np.testing.assert_array_equal(R[:, 1], data[Iv[:, 1]])
    np.testing.assert_array_equal(R[:, 0], data[:4])
    other = tfactory(D, "Flat", device="cpu")
    other.add(data[2000:2500])
    t.merge_from(other)
    assert t.ntotal == 2500 and other.ntotal == 0
    np.testing.assert_array_equal(t.reconstruct(2400), data[2400])
