"""The range tools of tpu_ann_torch (utils/contrib.py:
range_ground_truth, range_search_preassigned) against the JAX package's,
on the CPU, and the range precision / recall of a partial-probe IVF
against the exact result (the range part of the reference's
test_range_breadth.py and test_contrib.py; the range_search of each index
class is held to the reference in its own test file).

Data: d 32, 3000 rows of integers in [0, 256) from a numpy seed, and IVF
indexes of 16 lists over the same integer centroids in both packages, so
every distance is exact in f32 in both. Tolerances: range_ground_truth
equals the reference's CSR triple exactly (lims, distances, ids, in the
same order: by block, then by row); range_search_preassigned equals the
reference's hits as sets per query (`check_ref_range_results`, distances
within rtol 1e-5, here exact)."""

import numpy as np
import pytest
import torch

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import IndexIVFFlat as JIVF
from tpu_ann.utils import contrib as JC
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import IndexIVFFlat as TIVF
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.utils import contrib as TC
from tpu_ann_torch.utils import evaluation as TE

D, NLIST = 32, 16
L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(31)
    xb = rs.randint(0, 256, size=(3000, D)).astype(np.float32)
    xq = rs.randint(0, 256, size=(40, D)).astype(np.float32)
    cent = xb[rs.choice(len(xb), NLIST, replace=False)]
    return xb, xq, cent


def _radius(xb, xq, metric, q=5):
    """A radius with about q hits a query."""
    s = xq @ xb.T
    if metric == IP:
        return float(np.median(np.sort(s, 1)[:, -q]))
    d2 = (xq ** 2).sum(1)[:, None] + (xb ** 2).sum(1)[None] - 2 * s
    return float(np.median(np.sort(d2, 1)[:, q]))


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("block", [700, 3000])
def test_range_ground_truth(data, metric, block):
    xb, xq, _ = data
    r = _radius(xb, xq, metric)
    blocks = [xb[i:i + block] for i in range(0, len(xb), block)]
    Lt, Dt, It = TC.range_ground_truth(xq, iter(blocks), r, metric,
                                       device="cpu")
    Lj, Dj, Ij = JC.range_ground_truth(xq, iter(blocks), r, metric)
    assert Lt[-1] > len(xq)
    assert Lt.dtype == np.int64 and It.dtype == np.int64
    for a, b in zip((Lt, Dt, It), (Lj, Dj, Ij)):
        np.testing.assert_array_equal(a, np.asarray(b))
    flat = TFlat(D, metric, device="cpu")
    flat.add(xb)
    for a, b in zip((Lt, Dt, It), flat.range_search(xq, r)):
        np.testing.assert_array_equal(a, b)


def _pair(data):
    xb, _, cent = data
    out = []
    for q, cls, kw in ((JFlat(D), JIVF, {}),
                       (TFlat(D, device="cpu"), TIVF, {"device": "cpu"})):
        q.add(cent)
        idx = cls(q, D, NLIST, **kw)
        idx.max_list_scan_factor = 0
        idx.quantizer_trains_alone = 1
        idx.train(xb[:100])
        idx.add_with_ids(xb, 100 + 2 * np.arange(len(xb)))
        idx.nprobe = 4
        out.append(idx)
    return out


@pytest.mark.parametrize("nprobe", [1, 4])
def test_range_search_preassigned(data, nprobe):
    """Over the same probes: equal to the reference's hits, and to the
    port's range_search at that nprobe."""
    xb, xq, _ = data
    j, t = _pair(data)
    r = _radius(xb, xq, L2)
    probes = t.coarse_assign(xq, nprobe)
    np.testing.assert_array_equal(probes, j.coarse_assign(xq, nprobe))
    Lt, Dt, It = TC.range_search_preassigned(t, xq, r, probes)
    Lj, Dj, Ij = JC.range_search_preassigned(j, xq, r, probes)
    TE.check_ref_range_results(np.asarray(Lj), np.asarray(Dj),
                               np.asarray(Ij), Lt, Dt, It)
    t.nprobe = nprobe
    TE.check_ref_range_results(*t.range_search(xq, r), Lt, Dt, It)
    with pytest.raises(ValueError):
        TC.range_search_preassigned(t, xq, r, probes[:3])


def test_range_precision_recall(data):
    """A partial-probe IVF's hits are all true hits (precision 1) and some
    of the exact ones (recall in (0.3, 1]); a smaller threshold keeps only
    closer hits (contrib/evaluation.py:30-292)."""
    xb, xq, _ = data
    _, t = _pair(data)
    r = _radius(xb, xq, L2, q=9)
    Lr, Dr, Ir = TC.range_ground_truth(xq, iter([xb]), r, device="cpu")
    Ir = 100 + 2 * Ir
    t.nprobe = 4
    Ln, Dn, In = t.range_search(xq, r)
    for mode in ("overall", "average"):
        p, rec = TE.range_PR(Lr, Ir, Ln, In, mode=mode)
        assert p == 1.0 and 0.3 < rec <= 1.0
    Lf, Df, If = TE.filter_range_results(Ln, Dn, In, r * 0.5)
    assert (Df < r * 0.5).all() and Lf[-1] <= Ln[-1]
    pr = TE.range_PR_multiple_thresholds(Lr, Ir, Ln, Dn, In, [r * 0.5, r])
    assert pr[0, 1] <= pr[1, 1]
    t.nprobe = NLIST
    TE.check_ref_range_results(Lr, Dr, Ir, *t.range_search(xq, r))
