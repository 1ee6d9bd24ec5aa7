"""K3-SQ8 (the fused IVF scan over uint8 codes) and the K3g route of
tpu_ann_torch against their plain torch versions, on the card. Without a
CUDA device these tests skip.

Run on a GPU machine (no jax needed, hence --noconftest):
    python -m pytest --noconftest -q tests/test_torch_cuda_sq8_kernels.py

QT_8BIT_DIRECT codes of integer data make every score exact in both the
kernel and the plain version: per-pair outputs equal bit for bit. With
trained QT_8BIT ranges the folded query q * scale is a bf16 and the sums
of its products with the codes run in another order: distances within
rtol 1e-5 (against the largest distance of the call), positions equal
outside groups of near-equal distances. The plan shapes of
torch_parity.PLAN_CASES (sparse hulls, one-pair segments, one-list tiles,
several lists a chunk) run on QT_8BIT_DIRECT codes, and cut by K3g on
both streams."""

import numpy as np
import pytest
import torch

from tpu_ann_torch.models.flat import IndexFlat
from tpu_ann_torch.models.ivf import IndexIVFFlat
from tpu_ann_torch.models.ivf_pq import IndexIVFScalarQuantizer
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan as TS
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops import sq as SQ
from torch_parity import (PLAN_CASES, assert_topk_equal, case_probes,
                          check_plan_case)

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _setup(dev, d, qtype, B=128, nlist=40, n=4000, nq=300, nprobe=6,
           metric=1, seed=0):
    """An SQ8 view over n rows in nlist lists (the last 3 empty), and
    nq x nprobe probes (every 5th query's last probe -1; 1800 pairs, not a
    multiple of 128)."""
    rs = np.random.RandomState(seed)
    if qtype == SQ.QT_8BIT_DIRECT:
        xb = rs.randint(0, 256, size=(n, d)).astype(np.float32)
        xq = rs.randint(0, 256, size=(nq, d)).astype(np.float32)
    else:
        xb = (rs.randn(n, d) * rs.uniform(0.5, 3.0, d)).astype(np.float32)
        xq = (rs.randn(nq, d) * rs.uniform(0.5, 3.0, d)).astype(np.float32)
    codec = SQ.train_sq(xb, qtype)
    cent = torch.from_numpy(xb[rs.choice(n, nlist, replace=False)]).to(dev)
    xb_t = torch.from_numpy(xb).to(dev)
    _, a = TD.knn(xb_t, cent[:nlist - 3], 1)
    pcl = TS.pack_code_invlists(SQ.sq_encode(xb_t, codec), np.arange(n),
                                a[:, 0].cpu().numpy(), nlist, B, device=dev)
    if qtype == SQ.QT_8BIT_DIRECT:
        bias, scale = torch.zeros(d), torch.ones(d)
    else:
        vmin, vdiff = SQ.codec_range(codec, "cpu")
        scale = vdiff / 256.0
        bias = vmin + 0.5 * scale
    view = TS.sq8_view_from_codes(pcl, bias.to(dev), scale.to(dev))
    xq_t = torch.from_numpy(xq).to(dev)
    _, probes = TD.knn(xq_t, cent, nprobe, metric)
    probes[::5, -1] = -1
    return xq_t, probes, view


def _pairs(fn, xq, probes, il, kp, metric, plan=None):
    sim = TD.is_similarity_metric(metric)
    plan = F.plan_pairs(probes, il) if plan is None else plan
    q, qn = F.fold_queries(xq, il, sim)
    d, p = fn(q, qn, plan, il, kp, sim)
    torch.cuda.synchronize()
    return d.cpu().numpy(), p.cpu().numpy()


def _assert_pairs(qtype, d0, p0, d1, p1):
    if qtype == SQ.QT_8BIT_DIRECT:
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(p1, p0)
    else:
        fin = np.isfinite(d0)
        np.testing.assert_array_equal(np.isfinite(d1), fin)
        atol = 1e-5 * float(np.abs(d0[fin]).max()) if fin.any() else 0.0
        assert_topk_equal(d0, p0, d1, p1, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("qtype", [SQ.QT_8BIT_DIRECT, SQ.QT_8BIT])
@pytest.mark.parametrize("metric", [1, 0])
@pytest.mark.parametrize("kp", [1, 10, 16, 32, 33, 64, 65, 106, 1030])
@pytest.mark.parametrize("d", [32, 96, 128])
def test_sq8_pairs_equal_plain(d, kp, metric, qtype):
    dev = _cuda()
    xq, probes, il = _setup(dev, d, qtype, metric=metric)
    before = (F.LAUNCHES, F.LAUNCHES_SQ8)
    d1, p1 = _pairs(F.scan_pairs, xq, probes, il, kp, metric)
    assert (F.LAUNCHES, F.LAUNCHES_SQ8) == (before[0], before[1] + 1)
    d0, p0 = _pairs(F.scan_pairs_reference, xq, probes, il, kp, metric)
    _assert_pairs(qtype, d0, p0, d1, p1)


def plan_case(dev, case, d=128, qtype=SQ.QT_8BIT_DIRECT):
    """Queries, probes and an SQ8 view of one of torch_parity.PLAN_CASES."""
    nlist, B, n = PLAN_CASES[case]
    xq, probes, il = _setup(dev, d, qtype, B=B, nlist=nlist, n=n)
    probes = torch.from_numpy(case_probes(case, probes.cpu().numpy(),
                                          nlist)).to(dev)
    check_plan_case(case, F.plan_pairs(probes, il), B)
    return xq, probes, il


def _bf16_lists(il):
    """The bf16 stream of the same (integer) rows as an SQ8 view's codes."""
    rows = il.codes.view(-1, il.codes.shape[-1]).float()
    return TS.PackedInvLists(
        data=rows.view(il.codes.shape),
        data_bf16=rows.view(il.codes.shape).bfloat16(), ids=il.ids,
        norms=il.norms, list_block_start=il.list_block_start,
        list_nblocks=il.list_nblocks)


@pytest.mark.parametrize("case", ["sparse", "one_pair", "one_list", "b16"])
@pytest.mark.parametrize("d,kp,metric", [(128, 10, 1), (96, 32, 0),
                                         (264, 16, 1)])
def test_sq8_plan_shapes_equal_plain(case, d, kp, metric):
    dev = _cuda()
    xq, probes, il = plan_case(dev, case, d)
    d1, p1 = _pairs(F.scan_pairs, xq, probes, il, kp, metric)
    d0, p0 = _pairs(F.scan_pairs_reference, xq, probes, il, kp, metric)
    _assert_pairs(SQ.QT_8BIT_DIRECT, d0, p0, d1, p1)


@pytest.mark.parametrize("case", ["sparse", "one_pair", "one_list", "b16"])
@pytest.mark.parametrize("stream", ["bf16", "sq8"])
def test_grid_cut_plan_shapes_equal_plain(stream, case):
    """K3g's cut of each plan shape, on both streams: per-pair outputs
    equal the plain version's over the same cut plan."""
    dev = _cuda()
    xq, probes, il = plan_case(dev, case)
    if stream == "bf16":
        il = _bf16_lists(il)
    plan = cut = F.plan_pairs(probes, il)
    mc = F.grid2d_maxc(il, probes)          # cuts nothing: halve it
    while mc > 1 and torch.equal(cut.tile_nb, plan.tile_nb):
        mc //= 2
        cut = F.truncate_plan(plan, mc)
    assert (cut.tile_nb < plan.tile_nb).any()
    d1, p1 = _pairs(F.scan_pairs, xq, probes, il, 16, 1, cut)
    d0, p0 = _pairs(F.scan_pairs_reference, xq, probes, il, 16, 1, cut)
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(p1, p0)


@pytest.mark.parametrize("B", [128, 16])
@pytest.mark.parametrize("metric", [1, 0])
def test_sq8_search_equal_plain(metric, B):
    dev = _cuda()
    xq, probes, il = _setup(dev, 128, SQ.QT_8BIT_DIRECT, B=B, metric=metric)
    D1, I1, n1 = F.scan_invlists_fused(xq, probes, il, 10, metric)
    D0, I0, n0 = F.scan_invlists_fused_reference(xq, probes, il, 10, metric)
    np.testing.assert_array_equal(D1.cpu().numpy(), D0.cpu().numpy())
    np.testing.assert_array_equal(I1.cpu().numpy(), I0.cpu().numpy())
    assert int(n0) == int(n1)


def test_sq8_trained_search_overlap():
    dev = _cuda()
    xq, probes, il = _setup(dev, 128, SQ.QT_8BIT)
    D1, I1, _ = F.scan_invlists_fused(xq, probes, il, 10)
    D0, I0, _ = F.scan_invlists_fused_reference(xq, probes, il, 10)
    I0, I1 = I0.cpu().numpy(), I1.cpu().numpy()
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(I0, I1)])
    assert overlap >= 0.999, overlap


@pytest.mark.parametrize("kp", [16, 106])
@pytest.mark.parametrize("stream", ["bf16", "sq8"])
def test_grid_cut_plan_equal_plain(stream, kp):
    """K3g: per-pair outputs over a cut plan, and the whole route, equal
    the plain version; with grid2d_maxc's bound it equals K3 / K3-SQ8; at
    kp 16 and at kp 106 (the lists in global memory)."""
    dev = _cuda()
    xq, probes, il = _setup(dev, 128, SQ.QT_8BIT_DIRECT, B=16)
    if stream == "bf16":
        il = _bf16_lists(il)
    full = F.grid2d_maxc(il, probes)
    mc = max(full // 4, 1)
    plan = F.truncate_plan(F.plan_pairs(probes, il), mc)
    assert (plan.tile_nb < F.plan_pairs(probes, il).tile_nb).any()
    d1, p1 = _pairs(F.scan_pairs, xq, probes, il, kp, 1, plan)
    d0, p0 = _pairs(F.scan_pairs_reference, xq, probes, il, kp, 1, plan)
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(p1, p0)
    Dg, Ig, _ = F.scan_invlists_fused_grid(xq, probes, il, 10, maxc=mc,
                                           kp=kp)
    Dr, Ir, _ = F.scan_invlists_fused_reference(xq, probes, il, 10, maxc=mc,
                                                kp=kp)
    assert torch.equal(Dg, Dr) and torch.equal(Ig, Ir)
    Dg, Ig, _ = F.scan_invlists_fused_grid(xq, probes, il, 10, maxc=full,
                                           kp=kp)
    D3, I3, _ = F.scan_invlists_fused(xq, probes, il, 10, kp=kp)
    assert torch.equal(Dg, D3) and torch.equal(Ig, I3)


def test_ivf_sq_direct_equals_ivf_flat_on_card():
    """End to end on the card: lossless codes give IndexIVFFlat's (D, I)
    bit for bit; each search is one K3-SQ8 launch and no K3 launch."""
    dev = _cuda()
    rs = np.random.RandomState(3)
    d, nlist = 64, 32
    xb = rs.randint(0, 256, size=(6000, d)).astype(np.float32)
    xq = rs.randint(0, 256, size=(200, d)).astype(np.float32)
    quant = IndexFlat(d, device=dev)
    quant.add(xb[rs.choice(len(xb), nlist, replace=False)])
    flat = IndexIVFFlat(quant, d, nlist, device=dev)
    sq8 = IndexIVFScalarQuantizer(quant, d, nlist, SQ.QT_8BIT_DIRECT,
                                  device=dev)
    for idx in (flat, sq8):
        idx.quantizer_trains_alone = 1
        idx.train(xb[:1000])
        idx.add(xb)
        idx.nprobe = 8
    D0, I0 = flat.search(xq, 10)
    before = (F.LAUNCHES, F.LAUNCHES_SQ8)
    D1, I1 = sq8.search(xq, 10)
    assert (F.LAUNCHES, F.LAUNCHES_SQ8) == (before[0], before[1] + 1)
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)
    D2, I2, _ = sq8.search_stats(xq, 10)
    np.testing.assert_array_equal(D2, D1)
    np.testing.assert_array_equal(I2, I1)


@pytest.mark.parametrize("qtype", [SQ.QT_8BIT_DIRECT, SQ.QT_8BIT])
@pytest.mark.parametrize("metric", [1, 0])
@pytest.mark.parametrize("k", [50, 100])
def test_ivf_sq_wide_k_search_equals_cpu_route(k, metric, qtype):
    """IndexIVFScalarQuantizer.search at k 50 (kp 56, the wide lists) and
    k 100 (kp 106, the lists in shared memory) on the card: one K3-SQ8
    launch of that kernel a search, no K3 launch, and (D, I) equal to the
    same index built on the CPU (the plain route): bit for bit for
    QT_8BIT_DIRECT codes of integer data; for QT_8BIT distances within
    rtol 1e-5 and ids equal outside near-ties."""
    dev = _cuda()
    rs = np.random.RandomState(4)
    d, nlist = 128, 32
    if qtype == SQ.QT_8BIT_DIRECT:
        xb = rs.randint(0, 256, size=(8000, d)).astype(np.float32)
        xq = rs.randint(0, 256, size=(300, d)).astype(np.float32)
    else:
        xb = (rs.randn(8000, d) * rs.uniform(0.5, 3.0, d)).astype(np.float32)
        xq = (rs.randn(300, d) * rs.uniform(0.5, 3.0, d)).astype(np.float32)
    cent = xb[rs.choice(len(xb), nlist, replace=False)]
    out = {}
    for where in ("cuda", "cpu"):
        quant = IndexFlat(d, metric, device=where)
        quant.add(cent)
        idx = IndexIVFScalarQuantizer(quant, d, nlist, qtype, metric,
                                      device=where)
        idx.quantizer_trains_alone = 1
        idx.train(xb[:2000])
        idx.add(xb)
        idx.nprobe = 6
        before = (F.LAUNCHES, F.LAUNCHES_SQ8, F.LAUNCHES_WIDE,
                  F.LAUNCHES_GLOBAL)
        out[where] = idx.search(xq, k)
        got = tuple(a - b for a, b in zip(
            (F.LAUNCHES, F.LAUNCHES_SQ8, F.LAUNCHES_WIDE, F.LAUNCHES_GLOBAL),
            before))
        want = (0, 1, int(k == 50), int(k == 100)) if where == "cuda" \
            else (0, 0, 0, 0)
        assert got == want, (where, got)
    (D1, I1), (D0, I0) = out["cuda"], out["cpu"]
    assert D1.shape == I1.shape == (len(xq), k) and (I1 >= 0).all()
    if qtype == SQ.QT_8BIT_DIRECT:
        np.testing.assert_array_equal(D1, D0)
        np.testing.assert_array_equal(I1, I0)
    else:
        assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


def test_sq8_rejects_unsupported():
    """kp 33 (the wide lists) and kp 106 (the lists in global memory) are
    served, one launch each, equal to the plain version bit for bit; kp
    below 1, a misaligned stream and a d that is not a multiple of 8
    raise."""
    dev = _cuda()
    xq, probes, il = _setup(dev, 128, SQ.QT_8BIT_DIRECT, n=600, nq=10)
    for kp in (33, 106):
        before = F.LAUNCHES_SQ8
        d1, p1 = _pairs(F.scan_pairs, xq, probes, il, kp, 1)
        assert F.LAUNCHES_SQ8 == before + 1
        d0, p0 = _pairs(F.scan_pairs_reference, xq, probes, il, kp, 1)
        assert np.array_equal(d0, d1) and np.array_equal(p0, p1)
    with pytest.raises(ValueError):
        F.scan_invlists_fused(xq, probes, il, 10, kp=-1)
    # a stream that is not 16-byte aligned
    flat = torch.zeros(il.codes.numel() + 16, dtype=torch.uint8, device=dev)
    shifted = flat[1:1 + il.codes.numel()].view(il.codes.shape)
    shifted.copy_(il.codes)
    bad = TS.PackedInvListsSQ8(
        codes=shifted, ids=il.ids, norms=il.norms,
        list_block_start=il.list_block_start, list_nblocks=il.list_nblocks,
        sq_bias=il.sq_bias, sq_scale=il.sq_scale)
    with pytest.raises(ValueError):
        F.scan_invlists_fused(xq, probes, bad, 10)
    xq, probes, il = _setup(dev, 12, SQ.QT_8BIT_DIRECT, n=600, nq=10)
    with pytest.raises(ValueError):
        F.scan_invlists_fused(xq, probes, il, 10)
