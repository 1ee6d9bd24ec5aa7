"""The IVF analyzers of tpu_ann_torch (utils/analyzers.py: partition
statistics, the partition CSV, probe coverage, recall attribution and the
report) on the CPU, against the JAX package's on the same lists.

Both packages hold an IVF of 32 lists over the same integer centroids and
rows (quantizer_trains_alone=1), d 16, 4000 rows of integers in [0, 256)
from a numpy seed, so every coarse distance is exact in f32 in both.
Tolerances: every statistic, the CSV bytes and the report's text are
equal to the reference's."""

import numpy as np
import pytest
import torch

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import IndexIVFFlat as JIVF
from tpu_ann.utils import analyzers as JA
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import IndexIVFFlat as TIVF
from tpu_ann_torch.utils import analyzers as TA

D, NLIST = 16, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    r = np.random.RandomState(5)
    xb = r.randint(0, 256, (4000, D)).astype(np.float32)
    xq = r.randint(0, 256, (64, D)).astype(np.float32)
    d2 = ((xq[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10].astype(np.int64)
    cent = xb[r.choice(len(xb), NLIST, replace=False)]
    out = []
    for q, cls, kw in ((JFlat(D), JIVF, {}),
                       (TFlat(D, device="cpu"), TIVF, {"device": "cpu"})):
        q.add(cent)
        idx = cls(q, D, NLIST, **kw)
        idx.max_list_scan_factor = 0
        idx.quantizer_trains_alone = 1
        idx.train(xb[:100])
        idx.add(xb)
        out.append(idx)
    return (*out, xq, gt)


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_partition_stats_and_csv(built, tmp_path):
    j, t, _, _ = built
    ps = TA.ivf_partition_stats(t)
    _same(ps, JA.ivf_partition_stats(j))
    assert ps["nlist"] == NLIST and ps["ntotal"] == 4000
    assert ps["imbalance"] >= 1.0 and 0.0 <= ps["gini"] < 1.0
    ft, fj = tmp_path / "t.csv", tmp_path / "j.csv"
    TA.export_partition_csv(t, str(ft))
    JA.export_partition_csv(j, str(fj))
    assert ft.read_bytes() == fj.read_bytes()
    lines = ft.read_text().strip().split("\n")
    assert lines[0] == "partition_id,vector_count" and len(lines) == 33


@pytest.mark.parametrize("nprobe", [4, 16, 32])
def test_probe_coverage(built, nprobe):
    j, t, xq, _ = built
    cov = TA.probe_coverage(t, xq, nprobe)
    _same(cov, JA.probe_coverage(j, xq, nprobe))
    if nprobe == NLIST:
        assert cov["mean_ratio"] == pytest.approx(1.0)


@pytest.mark.parametrize("k,nprobe", [(10, 32), (1, 1), (10, 4)])
def test_recall_attribution(built, k, nprobe):
    """All lists probed: no routing loss, and a flat list scan misses
    nothing; few probes: the misses split into routing and ranking, as
    the reference's."""
    j, t, xq, gt = built
    att = TA.recall_attribution(t, xq, gt, k, nprobe)
    assert att == JA.recall_attribution(j, xq, gt, k, nprobe)
    assert att["routing_loss"] + att["ranking_loss"] == pytest.approx(
        1.0 - att["recall"])
    if nprobe == NLIST:
        assert att["recall"] == pytest.approx(1.0)
        assert att["routing_loss"] == 0.0
    else:
        assert att["routing_loss"] > 0.0


def test_report(built):
    j, t, xq, gt = built
    rep = TA.report(t, xq, gt, k=10, nprobe=4)
    assert rep == JA.report(j, xq, gt, k=10, nprobe=4)
    assert "routing=" in rep and "imbalance=" in rep
    assert TA.report(t, xq) == JA.report(j, xq)
