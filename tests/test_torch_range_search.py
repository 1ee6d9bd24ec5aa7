"""range_search of tpu_ann_torch against the JAX package's, on the CPU:
IndexFlat, IndexScalarQuantizer, IndexIVFFlat and IndexIVFScalarQuantizer,
L2 and IP, and the ops-level CSR helpers.

The CSR triple must come out in the reference's order: per query, hits in
chunk order and inside a chunk in (database row) or (probe block, slot)
order. On integer data every distance is exact in both packages, so lims,
labels and distances are compared as they are; on float data after
dropping, from both, the hits within rtol 1e-5 of the radius (a hit there
may fall on either side of it)."""

import numpy as np
import pytest
import torch

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import IndexIVFFlat as JIVF
from tpu_ann.models.ivf import IndexIVFFlatDedup as JDedup
from tpu_ann.models.ivf_pq import IndexIVFScalarQuantizer as JIVFSQ
from tpu_ann.models.pq import IndexScalarQuantizer as JSQ
from tpu_ann.ops import range_search as JR
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import IndexIVFFlat as TIVF
from tpu_ann_torch.models.ivf import IndexIVFFlatDedup as TDedup
from tpu_ann_torch.models.ivf_pq import IndexIVFScalarQuantizer as TIVFSQ
from tpu_ann_torch.models.pq import IndexScalarQuantizer as TSQIndex
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import range_search as TR
from tpu_ann_torch.ops import sq as TSQ

D, NLIST = 24, 12
L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT


@pytest.fixture(scope="module")
def idata():
    rs = np.random.RandomState(21)
    xb = rs.randint(0, 32, size=(3000, D)).astype(np.float32)
    xq = rs.randint(0, 32, size=(40, D)).astype(np.float32)
    return xb, xq, xb[rs.choice(len(xb), NLIST, replace=False)]


@pytest.fixture(scope="module")
def fdata():
    rs = np.random.RandomState(22)
    xb = rs.rand(2500, D).astype(np.float32)
    xq = rs.rand(30, D).astype(np.float32)
    return xb, xq, xb[rs.choice(len(xb), NLIST, replace=False)]


def _radius(xb, xq, metric, rank=20):
    """The median over queries of the exact rank-th neighbour's score."""
    dis = TD.pairwise_distances(torch.from_numpy(xq), torch.from_numpy(xb),
                                metric).numpy()
    dis = -np.sort(-dis, 1) if metric == IP else np.sort(dis, 1)
    return float(np.median(dis[:, rank]))


def _strip(lims, Dv, Iv, radius, rtol):
    """Per query (D, I) with the hits within rtol of the radius dropped."""
    out = []
    for q in range(len(lims) - 1):
        d = np.asarray(Dv[lims[q]:lims[q + 1]])
        i = np.asarray(Iv[lims[q]:lims[q + 1]])
        keep = ~np.isclose(d, radius, rtol=rtol, atol=0)
        out.append((d[keep], i[keep]))
    return out


def _same(ref, got, radius, exact):
    l0, d0, i0 = (np.asarray(a) for a in ref)
    l1, d1, i1 = got
    assert l1.dtype == np.int64 and i1.dtype == np.int64
    assert d1.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(l1, l0)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(d1, d0)
        return
    for (a, b), (c, e) in zip(_strip(l0, d0, i0, radius, 1e-5),
                              _strip(l1, d1, i1, radius, 1e-5)):
        np.testing.assert_array_equal(e, b)
        np.testing.assert_allclose(c, a, rtol=1e-5)


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_flat_range_search(idata, fdata, metric, kind):
    xb, xq, _ = idata if kind == "int" else fdata
    r = _radius(xb, xq, metric)
    j, t = JFlat(D, metric), TFlat(D, metric, device="cpu")
    j.add(xb)
    t.add(xb)
    got = t.range_search(xq, r)
    _same(j.range_search(xq, r), got, r, kind == "int")
    assert got[0][-1] > 10 * len(xq)
    # small blocks: more chunks, the same CSR
    res = TR.range_search_blocked(xq, t.vectors, r, metric, valid_n=len(xb),
                                  db_block=700, q_block=16)
    _same(got, (res.lims, res.distances, res.labels), r, True)


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("qtype", [TSQ.QT_8BIT, TSQ.QT_8BIT_DIRECT,
                                   TSQ.QT_4BIT, TSQ.QT_FP16])
def test_sq_range_search(idata, metric, qtype):
    xb, xq, _ = idata
    r = _radius(xb, xq, metric)
    j, t = JSQ(D, qtype, metric), TSQIndex(D, qtype, metric, device="cpu")
    for idx in (j, t):
        idx.train(xb)
        idx.add(xb)
    exact = qtype in (TSQ.QT_8BIT_DIRECT, TSQ.QT_FP16)
    _same(j.range_search(xq, r), t.range_search(xq, r), r, exact)


def _ivf_pair(data, metric, qtype=None):
    xb, _, cent = data
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            q = JFlat(D, metric)
            q.add(cent)
            idx = JIVF(q, D, NLIST, metric, 32) if qtype is None else \
                JIVFSQ(q, D, NLIST, qtype, metric, 32)
            # the reference's per-list cap is a TPU-watchdog workaround
            # that the port does not copy: read whole lists on both sides
            idx.max_list_scan_factor = 0
        else:
            q = TFlat(D, metric, device="cpu")
            q.add(cent)
            idx = TIVF(q, D, NLIST, metric, 32, device="cpu") \
                if qtype is None else \
                TIVFSQ(q, D, NLIST, qtype, metric, 32, device="cpu")
        idx.quantizer_trains_alone = 1
        idx.train(xb)
        idx.add_with_ids(xb, 7 + 2 * np.arange(len(xb), dtype=np.int64))
        idx.nprobe = 4
        out.append(idx)
    return out


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_ivf_flat_range_search(idata, fdata, metric, kind):
    data = idata if kind == "int" else fdata
    xb, xq, _ = data
    r = _radius(xb, xq, metric)
    j, t = _ivf_pair(data, metric)
    got = t.range_search(xq, r)
    _same(j.range_search(xq, r), got, r, kind == "int")
    assert got[0][-1] > 5 * len(xq) and got[2].min() >= 7
    # a removal: the holes are skipped, in both packages
    from tpu_ann.models.selectors import IDSelectorRange as JRange
    from tpu_ann_torch.models.selectors import IDSelectorRange as TRange

    j.remove_ids(JRange(7, 2007))
    t.remove_ids(TRange(7, 2007))
    got = t.range_search(xq, r)
    _same(j.range_search(xq, r), got, r, kind == "int")
    assert got[2].min() >= 2007


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("qtype", [TSQ.QT_8BIT, TSQ.QT_8BIT_DIRECT,
                                   TSQ.QT_6BIT, TSQ.QT_BF16])
def test_ivf_sq_range_search(idata, metric, qtype):
    xb, xq, _ = idata
    r = _radius(xb, xq, metric)
    j, t = _ivf_pair(idata, metric, qtype)
    exact = qtype in (TSQ.QT_8BIT_DIRECT, TSQ.QT_BF16)
    _same(j.range_search(xq, r), t.range_search(xq, r), r, exact)


def test_ivf_range_search_small_chunks_same_csr(idata):
    """range_search_ivf's chunk and query-tile sizes change no hit and no
    order."""
    xb, xq, _ = idata
    _, t = _ivf_pair(idata, L2)
    r = _radius(xb, xq, L2)
    lims, Dv, Iv = t.range_search(xq, r)
    probes = torch.from_numpy(t.coarse_assign(xq, 4))
    mnb = t._effective_params(None)[1]
    import tpu_ann_torch.ops.range_search as mod

    budget = mod.SCAN_BUDGET
    mod.SCAN_BUDGET = 7 * 32 * D      # tiles of 2 queries at 3 blocks
    try:
        res = TR.range_search_ivf(xq, probes, t.invlists, r, L2,
                                  max_nblocks=mnb, chunk_blocks=3)
    finally:
        mod.SCAN_BUDGET = budget
    np.testing.assert_array_equal(res.lims, lims)
    np.testing.assert_array_equal(t._map_ids(res.labels), Iv)
    np.testing.assert_array_equal(res.distances, Dv)


def test_csr_from_hits_and_empty_cases(idata):
    xb, xq, _ = idata
    # hits given out of query order come back grouped by query, each in
    # the order of its chunks
    q = [torch.tensor([2, 0, 2]), torch.tensor([0, 2])]
    d = [torch.tensor([1.0, 2.0, 3.0]), torch.tensor([4.0, 5.0])]
    i = [torch.tensor([10, 11, 12]), torch.tensor([13, 14])]
    res = TR.csr_from_hits(3, q, d, i)
    np.testing.assert_array_equal(res.lims, [0, 2, 2, 5])
    np.testing.assert_array_equal(res.labels, [11, 13, 10, 12, 14])
    np.testing.assert_array_equal(res.distances, [2, 4, 1, 3, 5])
    assert res.nq == 3
    j = JR.csr_from_hits(3, [[np.array([2.0]), np.array([4.0])], [],
                             [np.array([1.0, 3.0]), np.array([5.0])]],
                         [[np.array([11]), np.array([13])], [],
                          [np.array([10, 12]), np.array([14])]])
    np.testing.assert_array_equal(res.lims, j.lims)
    np.testing.assert_array_equal(res.labels, j.labels)
    empty = TR.csr_from_hits(4, [], [], [])
    assert empty.lims.tolist() == [0] * 5 and len(empty.labels) == 0
    for idx in (TFlat(D, device="cpu"), TSQIndex(D, device="cpu")):
        lims, Dv, Iv = idx.range_search(xq[:3], 1.0)
        assert lims.tolist() == [0, 0, 0, 0] and len(Dv) == len(Iv) == 0
    t = TFlat(D, device="cpu")
    t.add(xb)
    lims, _, _ = t.range_search(xq, -1.0)        # nothing below 0
    assert lims[-1] == 0


def test_flatcodes_range_search(idata):
    """range_search_flatcodes over an index's sa_decode, as the
    reference's: SQ8 codes through IndexScalarQuantizer.sa_decode."""
    xb, xq, _ = idata
    r = _radius(xb, xq, L2)
    j, t = JSQ(D, TSQ.QT_8BIT), TSQIndex(D, TSQ.QT_8BIT, device="cpu")
    for idx in (j, t):
        idx.train(xb)
        idx.add(xb)
    codes = t.sa_encode(xb)
    np.testing.assert_array_equal(codes, np.asarray(j.sa_encode(xb)))
    got = TR.range_search_flatcodes(t, xq, r, codes=codes)
    _same(JR.range_search_flatcodes(j, xq, r, codes=codes), got, r, False)


def test_dedup_range_search_raises(idata):
    xb, xq, cent = idata
    for idx in (JDedup(JFlat(D), D, NLIST),
                TDedup(TFlat(D, device="cpu"), D, NLIST, device="cpu")):
        with pytest.raises(RuntimeError):
            idx.range_search(xq, 1.0)
