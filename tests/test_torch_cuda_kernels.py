"""The hand-written CUDA kernel of tpu_ann_torch against its plain torch
version, on the card. Without a CUDA device these tests skip.

Run on a GPU machine (no jax needed, hence --noconftest):
    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Integer-valued data makes bf16 x bf16 -> f32 scores exact in both, so the
per-pair outputs must be equal: distances bit for bit, positions up to
ties. `plan_case` builds the plan shapes the kernel's segment walk must
handle (torch_parity.PLAN_CASES: sparse hulls, one-pair segments, one-list
tiles, several lists a chunk)."""

import numpy as np
import pytest
import torch

from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops.ivf_scan import pack_invlists
from torch_parity import (PLAN_CASES, assert_topk_equal, case_probes,
                          check_plan_case)

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _setup(dev, d, B, nlist=40, n=4000, nq=300, nprobe=6, metric=1,
           integer=True, seed=0):
    rs = np.random.RandomState(seed)
    if integer:
        xb = rs.randint(0, 256, size=(n, d)).astype(np.float32)
        xq = rs.randint(0, 256, size=(nq, d)).astype(np.float32)
    else:
        xb = rs.randn(n, d).astype(np.float32)
        xq = rs.randn(nq, d).astype(np.float32)
    cent = xb[rs.choice(n, nlist, replace=False)]
    xb_t, cent_t = torch.from_numpy(xb).to(dev), torch.from_numpy(cent).to(dev)
    # the last 3 lists stay empty
    _, a = TD.knn(xb_t, cent_t[:nlist - 3], 1)
    il = pack_invlists(xb, np.arange(n), a[:, 0].cpu().numpy(), nlist, B,
                       device=dev)
    xq_t = torch.from_numpy(xq).to(dev)
    _, probes = TD.knn(xq_t, cent_t, nprobe, metric)
    probes[::5, -1] = -1
    return xq_t, probes, il


def _pairs(fn, xq, probes, il, kp, metric):
    sim = TD.is_similarity_metric(metric)
    plan = F.plan_pairs(probes, il)
    qn = torch.zeros(len(xq), device=xq.device) if sim else TD.l2_norms(xq)
    d, p = fn(xq.bfloat16(), qn, plan, il, kp, sim)
    torch.cuda.synchronize()
    return d.cpu().numpy(), p.cpu().numpy()


@pytest.mark.parametrize("d,B,kp,metric", [
    (128, 128, 16, 1), (128, 16, 16, 1), (128, 128, 32, 1),
    (128, 128, 1, 1), (8, 32, 10, 1), (264, 64, 16, 1),
    (128, 128, 16, 0), (96, 128, 20, 0)])
def test_kernel_pairs_equal_plain(d, B, kp, metric):
    dev = _cuda()
    xq, probes, il = _setup(dev, d, B, metric=metric)
    before = F.LAUNCHES
    d1, p1 = _pairs(F.scan_pairs, xq, probes, il, kp, metric)
    assert F.LAUNCHES == before + 1
    d0, p0 = _pairs(F.scan_pairs_reference, xq, probes, il, kp, metric)
    assert_topk_equal(d0, p0, d1, p1)


def plan_case(dev, case, d=128):
    """Queries, probes and lists of one of torch_parity.PLAN_CASES."""
    nlist, B, n = PLAN_CASES[case]
    xq, probes, il = _setup(dev, d, B, nlist=nlist, n=n)
    probes = torch.from_numpy(case_probes(case, probes.cpu().numpy(),
                                          nlist)).to(dev)
    check_plan_case(case, F.plan_pairs(probes, il), B)
    return xq, probes, il


@pytest.mark.parametrize("case", ["sparse", "one_pair", "one_list", "b16"])
@pytest.mark.parametrize("d,kp,metric", [(128, 10, 1), (96, 32, 0),
                                         (264, 16, 1)])
def test_kernel_plan_shapes_equal_plain(case, d, kp, metric):
    dev = _cuda()
    xq, probes, il = plan_case(dev, case, d)
    d1, p1 = _pairs(F.scan_pairs, xq, probes, il, kp, metric)
    d0, p0 = _pairs(F.scan_pairs_reference, xq, probes, il, kp, metric)
    np.testing.assert_array_equal(d1, d0)
    assert_topk_equal(d0, p0, d1, p1)


@pytest.mark.parametrize("metric", [1, 0])
def test_kernel_search_equal_plain(metric):
    dev = _cuda()
    xq, probes, il = _setup(dev, 128, 128, metric=metric)
    D1, I1, n1 = F.scan_invlists_fused(xq, probes, il, 10, metric)
    D0, I0, n0 = F.scan_invlists_fused_reference(xq, probes, il, 10, metric)
    assert_topk_equal(D0.cpu().numpy(), I0.cpu().numpy(),
                      D1.cpu().numpy(), I1.cpu().numpy())
    assert int(n0) == int(n1)


def test_kernel_float_data_overlap():
    dev = _cuda()
    xq, probes, il = _setup(dev, 128, 128, metric=0, integer=False)
    _, I1, _ = F.scan_invlists_fused(xq, probes, il, 10, 0)
    _, I0, _ = F.scan_invlists_fused_reference(xq, probes, il, 10, 0)
    I0, I1 = I0.cpu().numpy(), I1.cpu().numpy()
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(I0, I1)])
    assert overlap >= 0.999, overlap


def test_kernel_rejects_unsupported():
    dev = _cuda()
    xq, probes, il = _setup(dev, 128, 128, n=500, nq=10)
    with pytest.raises(ValueError):
        F.scan_invlists_fused(xq, probes, il, 10, kp=33)
    xq, probes, il = _setup(dev, 12, 128, n=500, nq=10)
    with pytest.raises(ValueError):
        F.scan_invlists_fused(xq, probes, il, 10)
