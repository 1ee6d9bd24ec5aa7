"""The out-of-core window scan (K4, csrc/ivf_scan_paged.cu) against its
plain torch version, and the pinned double-buffered pipeline against the
synchronous path, on the card. Without a CUDA device these tests skip.

Run on a GPU machine (no jax needed, hence --noconftest):
    python -m pytest --noconftest -q tests/test_torch_cuda_paged_kernels.py

Integer-valued data makes bf16 x bf16 -> f32 scores exact in both, and
both keep the exact per-pair top-kp ordered by (distance, position), so
every running result must be equal bit for bit after every call."""

import numpy as np
import pytest
import torch

from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops import ivf_scan_paged as P

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _paged(path, d, B=128, nlist=40, n=4000, nq=300, nprobe=6, seed=0):
    """An integer-valued paged index with 3 empty lists and queries whose
    probes include the empty lists and some -1."""
    rs = np.random.RandomState(seed)
    xb = rs.randint(0, 256, size=(n, d)).astype(np.float32)
    xq = rs.randint(0, 256, size=(nq, d)).astype(np.float32)
    assign = rs.randint(nlist - 3, size=n)
    sizes = np.bincount(assign, minlength=nlist)
    pil = P.create_paged_invlists(path, nlist, sizes, d, block_size=B)
    P.paged_add_chunk(pil, np.zeros(nlist, np.int64), xb, np.arange(n),
                      assign)
    probes = np.stack([rs.permutation(nlist)[:nprobe] for _ in range(nq)])
    probes[::5, -1] = -1
    probes[::7, 0] = nlist - 1                 # an empty list
    return pil, xq, probes.astype(np.int32)


@pytest.mark.parametrize("metric", [TD.METRIC_L2, TD.METRIC_INNER_PRODUCT])
@pytest.mark.parametrize("W", [1, 3, 1024])
@pytest.mark.parametrize("kp", [1, 10, 16, 32])
@pytest.mark.parametrize("d", [32, 96, 128])
def test_k4_equals_plain_every_call(tmp_path, d, kp, W, metric):
    _k4_every_call(str(tmp_path / "p"), d, kp, W, metric)


@pytest.mark.parametrize("kp", [10, 46, 106, 3105, 3106])
@pytest.mark.parametrize("metric", [TD.METRIC_L2, TD.METRIC_INNER_PRODUCT])
@pytest.mark.parametrize("W", [2, 5])
def test_k4_window_splits_lists(tmp_path, W, metric, kp):
    """Block size 16, lists of about 7 blocks, windows of 2 or 5 blocks:
    window boundaries fall inside probed lists, so one list's segment is
    scanned by two launches; in every kp class (one and two entries a
    lane, lists in shared memory up to kp 3105 at d 96, in the running
    rows above)."""
    plan, entries = _k4_every_call(str(tmp_path / "p"), 96, kp, W, metric,
                                   B=16)
    ps, pe = plan.pstart.cpu().numpy(), plan.pend.cpu().numpy()
    real = pe > ps
    # some probed list has a window start strictly inside it
    assert any(((ps[real] < w0) & (w0 < pe[real])).any()
               for w0, _, _ in entries)


def _k4_every_call(path, d, kp, W, metric, B=128):
    """K4 over every planned call of windows of W blocks equals its plain
    version after every call, and K3's plain version over the whole
    stream at the end; returns the plan and the planned calls."""
    dev = _cuda()
    pil, xq, probes = _paged(path, d, B=B)
    sim = TD.is_similarity_metric(metric)
    xq_t = torch.from_numpy(xq).to(dev)
    plan = F.plan_pairs(torch.from_numpy(probes).long().to(dev), pil)
    qn = torch.zeros(len(xq), device=dev) if sim else TD.l2_norms(xq_t)
    xq_p = torch.zeros((len(xq), pil.dp), device=dev)
    xq_p[:, :d] = xq_t
    q16 = xq_p.bfloat16()
    whole = P.upload_resident(pil, pil.nblocks, dev)
    tbs = plan.tile_bs.long().cpu().numpy()
    tbe = tbs + plan.tile_nb.long().cpu().numpy()
    entries = list(P._plan_windows(tbs, tbe, W, 3))
    assert entries
    rd = torch.full((plan.ntiles * F.PT, kp), float("inf"), device=dev)
    rp = torch.full(rd.shape, -1, dtype=torch.int32, device=dev)
    ref = (rd.clone(), rp.clone())
    before = (P.LAUNCHES, P.LAUNCHES_GLOBAL)
    for w0, ta, tb in entries:
        win = whole.blocks(w0, min(W, pil.nblocks - w0))
        P.scan_window(q16, qn, plan, win, w0, ta, tb, rd, rp, sim)
        P.scan_window_reference(q16, qn, plan, win, w0, ta, tb, *ref, sim)
        torch.cuda.synchronize()
        assert torch.equal(rd, ref[0]), (w0, ta, tb)
        assert torch.equal(rp, ref[1]), (w0, ta, tb)
    assert P.LAUNCHES - before[0] == len(entries)
    assert P.LAUNCHES_GLOBAL - before[1] == \
        (len(entries) if kp > F.KP_MAX else 0)
    assert (rp >= 0).any()
    # the same per-pair result as K3's plain version over the whole stream
    d3, p3 = F.scan_pairs_reference(q16, qn, plan, whole, kp, sim)
    assert torch.equal(rd, d3) and torch.equal(rp, p3)
    return plan, entries


@pytest.mark.parametrize("metric", [TD.METRIC_L2, TD.METRIC_INNER_PRODUCT])
@pytest.mark.parametrize("W,TB", [(1, 1), (3, 2), (4, 4096), (8192, 4096)])
def test_pinned_pipeline_equals_synchronous(tmp_path, metric, W, TB):
    """The pinned, double-buffered pipeline on the card gives the same
    (D, I) as the CPU path (plain copies, the plain version), as the
    resident tier (device views, no copies), and as K3 over the same
    content."""
    dev = _cuda()
    pil, xq, probes = _paged(str(tmp_path / "p"), 96)
    s = {}
    before = P.LAUNCHES
    D1, I1, n1 = P.scan_invlists_paged(xq, probes, pil, 10, metric,
                                       window_blocks=W, TB=TB, stats=s,
                                       device=dev)
    assert P.LAUNCHES - before == s["calls"]
    D0, I0, n0 = P.scan_invlists_paged(xq, probes, pil, 10, metric,
                                       window_blocks=W, TB=TB, device="cpu")
    res = P.upload_resident(pil, pil.nblocks, dev)
    s2 = {}
    D2, I2, _ = P.scan_invlists_paged(xq, probes, pil, 10, metric,
                                      window_blocks=W, TB=TB, resident=res,
                                      stats=s2)
    il = F.PackedInvLists.from_arrays(pil.data_f32, pil.ids, pil.norms,
                                      pil.list_block_start,
                                      pil.list_nblocks, device=dev)
    D3, I3, _ = F.scan_invlists_fused(torch.from_numpy(xq).to(dev),
                                      torch.from_numpy(probes).to(dev), il,
                                      10, metric)
    for Dx, Ix in ((D0, I0), (D2, I2), (D3.cpu().numpy(), I3.cpu().numpy())):
        np.testing.assert_array_equal(D1, Dx)
        np.testing.assert_array_equal(I1, Ix)
    assert n1 == n0
    if W < pil.nblocks:
        assert s["windows"] >= 2 and s["bytes_uploaded"] > 0
    assert s2["bytes_uploaded"] == 0
    assert s2["windows_resident"] == s2["windows"]


@pytest.mark.parametrize("metric", [TD.METRIC_L2, TD.METRIC_INNER_PRODUCT])
@pytest.mark.parametrize("W", [1, 3, 1024])
@pytest.mark.parametrize("kp", [33, 58, 64, 65, 100, 106, 109, 110, 262,
                                553, 554, 1030, 2969, 2970])
def test_k4_wide_kp_equals_plain_every_call(tmp_path, kp, W, metric):
    """Above 32 entries a pair, one launch a planned call: the
    two-entries-a-lane kernel up to kp 64, above it the running lists
    copied into shared memory, merged there and written back (in place in
    the running rows past kp 2969 at d 128); windows of 1 and 3 blocks
    cut lists, so a pair's list is read back partly filled."""
    _k4_every_call(str(tmp_path / "p"), 128, kp, W, metric)


@pytest.mark.parametrize("k", [27, 58, 100])
def test_paged_search_at_wide_k(tmp_path, k):
    """The paged search at k 27, 58 and 100 (kp k + 6, 2k, 2k) equals its
    CPU path and K3 over the same content."""
    dev = _cuda()
    pil, xq, probes = _paged(str(tmp_path / "p"), 96)
    before = P.LAUNCHES
    D1, I1, _ = P.scan_invlists_paged(xq, probes, pil, k, window_blocks=3,
                                      device=dev)
    assert P.LAUNCHES > before
    D0, I0, _ = P.scan_invlists_paged(xq, probes, pil, k, window_blocks=3,
                                      device="cpu")
    il = F.PackedInvLists.from_arrays(pil.data_f32, pil.ids, pil.norms,
                                      pil.list_block_start,
                                      pil.list_nblocks, device=dev)
    D3, I3, _ = F.scan_invlists_fused(torch.from_numpy(xq).to(dev),
                                      torch.from_numpy(probes).to(dev), il, k)
    for Dx, Ix in ((D0, I0), (D3.cpu().numpy(), I3.cpu().numpy())):
        np.testing.assert_array_equal(D1, Dx)
        np.testing.assert_array_equal(I1, Ix)


def test_k4_rejects_unsupported(tmp_path):
    """What K4 still refuses: running results of another shape than
    (ntiles * PT, kp), a tile range outside the plan, and queries of
    another width than the window's."""
    dev = _cuda()
    pil, xq, _ = _paged(str(tmp_path / "p"), 32, n=500, nq=10)
    probes = torch.zeros((10, 2), dtype=torch.long, device=dev)
    plan = F.plan_pairs(probes, pil)
    win = P.upload_resident(pil, pil.nblocks, dev)
    q16 = torch.zeros((10, pil.dp), dtype=torch.bfloat16, device=dev)
    qn = torch.zeros(10, device=dev)
    rd = torch.full((plan.ntiles * F.PT, 10), float("inf"), device=dev)
    rp = torch.full(rd.shape, -1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        P.scan_window(q16, qn, plan, win, 0, 0, plan.ntiles, rd[:, :5], rp,
                      False)
    with pytest.raises(ValueError):
        P.scan_window(q16, qn, plan, win, 0, 0, plan.ntiles + 1, rd, rp,
                      False)
    with pytest.raises(ValueError):
        P.scan_window(q16[:, :64].contiguous(), qn, plan, win, 0, 0,
                      plan.ntiles, rd, rp, False)
