"""The fused flat scan's hand-written CUDA kernels, K1 (`flat_reservoir`,
csrc/flat_knn_fused.cu) and K2 (`reservoir_topk`, csrc/reservoir_topk.cu),
against their plain torch versions on the card. Without a CUDA device these
tests skip.

Run on a GPU machine (no jax needed, hence --noconftest):
    python -m pytest --noconftest -q tests/test_torch_cuda_flat_kernels.py

The data is integer-valued and small enough (values < 64) that every bf16
product and f32 partial sum is exact, so K1's reservoir and K2's top-k must
equal the plain versions' bit for bit, values and positions."""

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


def _inputs(dev, d, nb, nq, metric, W, R, seed=0, valid_n=None,
            mask=False):
    rs = np.random.RandomState(seed)
    xb = torch.from_numpy(rs.randint(0, 64, size=(nb, d)).astype(np.float32))
    xq = torch.from_numpy(rs.randint(0, 64, size=(nq, d)).astype(np.float32))
    data, bias = F.pack_flat_db(xb.to(dev), metric, valid_n=valid_n, R=R)
    if mask:
        keep = torch.from_numpy(rs.rand(bias.numel()) > 0.3).to(dev)
        bias = torch.where(keep, bias.reshape(-1), float("inf")).view(
            bias.shape)
    scale = -1.0 if TD.is_similarity_metric(metric) else -2.0
    qv = torch.zeros((nq, data.shape[-1]), device=dev)
    qv[:, :d] = scale * xq.to(dev)
    return qv.to(torch.bfloat16), data, bias.contiguous(), xq, xb


def _equal(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.shape == b.shape
    assert np.array_equal(a, b), int((a != b).sum())


@pytest.mark.parametrize("d,W,metric,valid_n,mask,nq", [
    (16, 128, TD.METRIC_L2, None, False, 300),
    (128, 1024, TD.METRIC_L2, 9000, False, 300),
    (128, 2048, TD.METRIC_L2, None, True, 300),
    (136, 1024, TD.METRIC_INNER_PRODUCT, 7000, True, 300),
    (136, 2048, TD.METRIC_L2, None, False, 300),
    (128, 128, TD.METRIC_INNER_PRODUCT, None, False, 300),
    (16, 2048, TD.METRIC_INNER_PRODUCT, 3000, False, 300),
    # ragged query tiles of 64-query CTAs (they fill one wave of 132
    # SMs): one query, a second CTA with one query
    (128, 1024, TD.METRIC_L2, None, False, 1),
    (80, 1024, TD.METRIC_L2, 9000, True, 65),
    (144, 2048, TD.METRIC_INNER_PRODUCT, None, False, 129),
    # 128-query CTAs of two consumer warpgroups: the last CTA's second
    # warpgroup with one query, a last CTA of one query (one consumer)
    (80, 2048, TD.METRIC_L2, 9000, True, 577),
    (144, 2048, TD.METRIC_INNER_PRODUCT, None, False, 641),
    # three lane tiles, with one and with two consumers
    (72, 384, TD.METRIC_L2, 3000, True, 129),
    (72, 384, TD.METRIC_L2, 3000, True, 2900),
    # about the widest dp with two consumers (384: the ring holds a whole
    # group) and past it (one consumer); dp 1008 near DP_MAX
    (384, 2048, TD.METRIC_L2, None, False, 700),
    (400, 2048, TD.METRIC_INNER_PRODUCT, 3000, True, 700),
    (512, 2048, TD.METRIC_L2, None, False, 577),
    (576, 1024, TD.METRIC_L2, 9000, True, 1100),
    (1000, 384, TD.METRIC_L2, None, False, 65),
    (1000, 1024, TD.METRIC_INNER_PRODUCT, 9000, True, 300),
])
def test_k1_reservoir_equals_plain(d, W, metric, valid_n, mask, nq):
    dev = _cuda()
    nb = 10 * W + 37 if W < 2048 else 4 * W + 999    # not a multiple of W
    R = 2 * W
    qv, data, bias, _, _ = _inputs(dev, d, nb, nq, metric, W, R,
                                   valid_n=valid_n, mask=mask)
    before = F.LAUNCHES["flat_knn_fused"]
    v1, p1 = F.flat_reservoir(qv, data, bias, W)
    torch.cuda.synchronize()
    assert F.LAUNCHES["flat_knn_fused"] == before + 1
    v0, p0 = F.flat_reservoir_reference(qv, data, bias, W)
    _equal(v0, v1)
    _equal(p0, p1)
    assert (p1 < (valid_n or nb)).all()


@pytest.mark.parametrize("nq", [129, 2900])
@pytest.mark.parametrize("case", ["one_group", "inf_lane_block",
                                  "one_group_dp1008"])
def test_k1_edges_equal_plain(case, nq):
    """One group of W rows (n == W), and a bias plane that is +inf on every
    row of one 128-lane block (those lanes stay (+inf, -1)); 129 queries
    run 64-query CTAs, 2900 two consumers where dp allows."""
    dev = _cuda()
    d, W, nb, R = {"one_group": (128, 1024, 1000, 1024),
                   "inf_lane_block": (128, 384, 5000, 768),
                   "one_group_dp1008": (1000, 256, 256, 256)}[case]
    qv, data, bias, _, _ = _inputs(dev, d, nb, nq, TD.METRIC_L2, W, R)
    if case == "inf_lane_block":
        lane = torch.arange(bias.numel(), device=dev) % W
        bias = torch.where((lane >= 128) & (lane < 256), float("inf"),
                           bias.reshape(-1)).view(bias.shape).contiguous()
    v1, p1 = F.flat_reservoir(qv, data, bias, W)
    v0, p0 = F.flat_reservoir_reference(qv, data, bias, W)
    _equal(v0, v1)
    _equal(p0, p1)
    if case == "inf_lane_block":
        assert torch.isinf(v1[:, 128:256]).all()
        assert (p1[:, 128:256] == -1).all()
    else:
        assert data.shape[0] * data.shape[1] == W


def test_k1_more_query_blocks_than_a_grid_dimension_holds():
    """65536 blocks of 128 queries and a partial one: past the 65535 that
    a grid's y or z dimension takes."""
    dev = _cuda()
    nq = 65536 * 128 + 5
    qv, data, bias, _, _ = _inputs(dev, 16, 300, nq, TD.METRIC_L2, 128, 128,
                                   valid_n=290)
    v1, p1 = F.flat_reservoir(qv, data, bias, 128)
    v0, p0 = F.flat_reservoir_reference(qv, data, bias, 128)
    assert torch.equal(v0, v1) and torch.equal(p0, p1)


def _k2_rows(nq, W, k, seed):
    """Integer values with many ties and +inf lanes; from row 1 on, rows
    r % 8 == 1..7 are all tied, +-0.0 ties, one NaN, dead, fewer than k
    finite, -inf lanes, and descending."""
    rs = np.random.RandomState(seed)
    v = rs.randint(0, 20, size=(nq, W)).astype(np.float32)
    v[rs.rand(nq, W) < 0.2] = np.inf
    r = np.arange(nq)
    v[r % 8 == 1] = 3.0
    z = r % 8 == 2
    v[z] = np.where(rs.rand(int(z.sum()), W) < 0.5, np.float32(-0.0),
                    np.float32(0.0))
    v[z, ::7] = 1.0
    v[r % 8 == 3, rs.randint(W)] = np.nan
    v[r % 8 == 4] = np.inf
    few = r % 8 == 5
    v[few] = np.inf
    v[few, :max(k - 3, 0)] = 2.0
    v[(r % 8 == 6)[:, None] & (rs.rand(nq, W) < 0.1)] = -np.inf
    v[r % 8 == 7] = np.arange(W, 0, -1, dtype=np.float32)
    p = rs.randint(0, 10**6, size=(nq, W)).astype(np.int32)
    return v, p


@pytest.mark.parametrize("nq", [1, 7, 64, 1024, 10000])
@pytest.mark.parametrize("W,k", [(W, k) for W in (100, 1000, 1024, 2048, 4096)
                                 for k in (1, 10, 40, 128) if k <= W]
                         + [(128, 128)])
def test_k2_topk_equals_plain_on_ties(W, k, nq):
    dev = _cuda()
    v, p = _k2_rows(nq, W, k, W + k + nq)
    resv, resp = torch.from_numpy(v).to(dev), torch.from_numpy(p).to(dev)
    before = F.LAUNCHES["reservoir_topk"]
    v1, p1 = F.reservoir_topk(resv, resp, k)
    torch.cuda.synchronize()
    assert F.LAUNCHES["reservoir_topk"] == before + 1
    v0, p0 = F.reservoir_topk_reference(resv, resp, k)
    # bit for bit: -0.0 must come back as -0.0
    _equal(v0.view(torch.int32), v1.view(torch.int32))
    _equal(p0, p1)
    if nq > 4:
        assert (p1[3] == -1).all() and (v1[3] == np.inf).all()  # NaN row
        assert (p1[4] == -1).all()                              # dead row


@pytest.mark.parametrize("metric", [TD.METRIC_L2, TD.METRIC_INNER_PRODUCT])
@pytest.mark.parametrize("refine,sel", [(0, "kernel"), (4, "kernel"),
                                        (0, "exact")])
def test_flat_knn_fused_cuda_equals_cpu(metric, refine, sel):
    """The whole call on the card (kernels) equals it on the CPU (plain
    versions)."""
    dev = _cuda()
    rs = np.random.RandomState(3)
    xb = rs.randint(0, 64, size=(5000, 72)).astype(np.float32)
    xq = rs.randint(0, 64, size=(200, 72)).astype(np.float32)
    mask = (rs.rand(5000) > 0.2).astype(np.uint8)
    kw = dict(R=2048, W=1024, refine=refine, sel=sel, valid_n=4500)
    out = []
    for device in (dev, torch.device("cpu")):
        Dv, Iv = F.flat_knn_fused(
            torch.from_numpy(xq).to(device), torch.from_numpy(xb).to(device),
            10, metric, id_mask=torch.from_numpy(mask).to(device), **kw)
        out.append((Dv.cpu().numpy(), Iv.cpu().numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert (mask[out[0][1][out[0][1] >= 0]] == 1).all()


def test_kernels_reject_unsupported():
    dev = _cuda()
    resv = torch.zeros((4, 256), device=dev)
    resp = torch.zeros((4, 256), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        F.reservoir_topk(resv, resp, 129)
    with pytest.raises(ValueError):
        F.reservoir_topk(resv.double(), resp, 10)
    qv, data, bias, _, _ = _inputs(dev, 16, 500, 10, TD.METRIC_L2, 256, 512)
    with pytest.raises(ValueError):
        F.flat_reservoir(qv, data, bias, 384)       # does not divide rows
    with pytest.raises(ValueError):
        F.flat_reservoir(qv.float(), data, bias, 256)
