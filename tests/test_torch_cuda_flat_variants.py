"""The fused flat scan's variants — K1p (`flat_reservoir_packed`) and the B1
probe folds (`flat_probe_scan`), both in csrc/flat_knn_variants.cu —
against their plain torch versions on the card. Without a CUDA device these
tests skip.

Run on a GPU machine (no jax needed, hence --noconftest):
    python -m pytest --noconftest -q tests/test_torch_cuda_flat_variants.py

The data is integer-valued and small enough (values < 64) that every bf16
product and f32 partial sum is exact, so each kernel's output must equal
its plain version's bit for bit."""

import numpy as np
import pytest
import torch

from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import flat_knn_fused as F

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _inputs(dev, d, nb, nq, metric, R, seed=0, valid_n=None):
    rs = np.random.RandomState(seed)
    xb = torch.from_numpy(rs.randint(0, 64, size=(nb, d)).astype(np.float32))
    xq = torch.from_numpy(rs.randint(0, 64, size=(nq, d)).astype(np.float32))
    data, bias = F.pack_flat_db(xb.to(dev), metric, valid_n=valid_n, R=R)
    scale = -1.0 if TD.is_similarity_metric(metric) else -2.0
    qv = torch.zeros((nq, data.shape[-1]), device=dev)
    qv[:, :d] = scale * xq.to(dev)
    return qv.to(torch.bfloat16), data, bias.contiguous()


def _equal(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.shape == b.shape
    assert np.array_equal(a, b), int((a != b).sum())


@pytest.mark.parametrize("d,W,metric,valid_n,nq", [
    (16, 128, TD.METRIC_L2, None, 300),
    (128, 1024, TD.METRIC_L2, 9000, 300),
    (136, 2048, TD.METRIC_INNER_PRODUCT, None, 300),
    # ragged query tiles (64-query CTAs, then two consumers), three lane
    # tiles, dp about the two-consumer cut (384), dp 1008
    (128, 1024, TD.METRIC_L2, None, 1),
    (80, 384, TD.METRIC_L2, 3000, 65),
    (144, 1024, TD.METRIC_INNER_PRODUCT, None, 129),
    (128, 2048, TD.METRIC_L2, None, 577),
    (384, 2048, TD.METRIC_L2, 9000, 700),
    (400, 1024, TD.METRIC_INNER_PRODUCT, None, 1100),
    (512, 384, TD.METRIC_L2, 3000, 129),
    (576, 2048, TD.METRIC_L2, None, 641),
    (1000, 384, TD.METRIC_L2, None, 129),
])
def test_k1p_reservoir_equals_plain(d, W, metric, valid_n, nq):
    dev = _cuda()
    nb = 10 * W + 37
    qv, data, bias = _inputs(dev, d, nb, nq, metric, 2 * W,
                             valid_n=valid_n)
    shifted = (bias + 6.0e5).contiguous()       # every score non-negative
    before = F.LAUNCHES["flat_knn_packed"]
    a1 = F.flat_reservoir_packed(qv, data, shifted, W)
    torch.cuda.synchronize()
    assert F.LAUNCHES["flat_knn_packed"] == before + 1
    _equal(F.flat_reservoir_packed_reference(qv, data, shifted, W), a1)


@pytest.mark.parametrize("fold", F.PROBE_FOLDS)
@pytest.mark.parametrize("d,W,R,nq", [(128, 1024, 8192, 200),
                                      (16, 256, 1024, 200),
                                      (1000, 384, 768, 65),
                                      (72, 128, 512, 1),
                                      (128, 2048, 4096, 600),
                                      (384, 2048, 4096, 700),
                                      (400, 1024, 2048, 129),
                                      (512, 384, 768, 65),
                                      (576, 128, 512, 200)])
def test_b1_folds_equal_plain(fold, d, W, R, nq):
    dev = _cuda()
    qv, data, bias = _inputs(dev, d, 6 * R + 5, nq, TD.METRIC_L2, R)
    before = F.LAUNCHES["flat_probe_" + fold]
    v1, p1 = F.flat_probe_scan(qv, data, bias, W, fold)
    torch.cuda.synchronize()
    assert F.LAUNCHES["flat_probe_" + fold] == before + 1
    v0, p0 = F.flat_probe_scan_reference(qv, data, bias, W, fold)
    _equal(v0, v1)
    _equal(p0, p1)


@pytest.mark.parametrize("nq", [129, 2900])
@pytest.mark.parametrize("kernel", ["packed", *F.PROBE_FOLDS])
@pytest.mark.parametrize("case", ["one_group", "inf_lane_block"])
def test_variant_edges_equal_plain(kernel, case, nq):
    """One group of W rows (n == W), and a bias plane that is +inf on every
    row of one 128-lane block; 129 queries run 64-query CTAs, 2900 two
    consumers."""
    dev = _cuda()
    W, nb, R = (1024, 1000, 1024) if case == "one_group" else (384, 5000, 768)
    qv, data, bias = _inputs(dev, 128, nb, nq, TD.METRIC_L2, R)
    if case == "inf_lane_block":
        lane = torch.arange(bias.numel(), device=dev) % W
        bias = torch.where((lane >= 128) & (lane < 256), float("inf"),
                           bias.reshape(-1)).view(bias.shape).contiguous()
    if kernel == "packed":
        shifted = (bias + 6.0e5).contiguous()
        _equal(F.flat_reservoir_packed_reference(qv, data, shifted, W),
               F.flat_reservoir_packed(qv, data, shifted, W))
        return
    v1, p1 = F.flat_probe_scan(qv, data, bias, W, kernel)
    v0, p0 = F.flat_probe_scan_reference(qv, data, bias, W, kernel)
    _equal(v0, v1)
    _equal(p0, p1)


@pytest.mark.parametrize("metric", [TD.METRIC_L2, TD.METRIC_INNER_PRODUCT])
@pytest.mark.parametrize("kw", [dict(schedule="grid", refine=0, sel="kernel"),
                                dict(schedule="fori", unroll=4, refine=4,
                                     sel="kernel")])
def test_packed_search_cuda_equals_cpu(metric, kw):
    """merge='packed' on the card (K1p + K2) equals it on the CPU."""
    dev = _cuda()
    rs = np.random.RandomState(5)
    xb = rs.randint(0, 64, size=(6000, 72)).astype(np.float32)
    xq = rs.randint(0, 64, size=(150, 72)).astype(np.float32)
    out = []
    for device in (dev, torch.device("cpu")):
        Dv, Iv = F.flat_knn_fused(
            torch.from_numpy(xq).to(device), torch.from_numpy(xb).to(device),
            10, metric, R=2048, W=1024, merge="packed", **kw)
        out.append((Dv.cpu().numpy(), Iv.cpu().numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_variants_reject_unsupported():
    dev = _cuda()
    qv, data, bias = _inputs(dev, 16, 500, 10, TD.METRIC_L2, 512)
    with pytest.raises(ValueError):
        F.flat_reservoir_packed(qv, data, bias, 384)
    with pytest.raises(ValueError):
        F.flat_probe_scan(qv.float(), data, bias, 256, "minall")
