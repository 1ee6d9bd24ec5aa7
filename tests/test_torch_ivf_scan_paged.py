"""Port parity for the out-of-core paged IVF scan
(tpu_ann_torch.ops.ivf_scan_paged): the window planner, the on-disk
directory (byte-identical, and each package opens the other's) and the
scan.

The JAX side runs its Pallas window kernel the way tests/test_ivf_paged.py
runs it on the CPU, in interpret mode, with RW=0: the reference then keeps
an exact per-pair top-kp, which is the port's semantics. On integer data
(the SIFT surrogate) bf16 scores are exact on both sides, so (D, I) must be
equal bit for bit. PT=32 tiles and windows of 2-4 blocks force tiles that
straddle windows, tile batches that split a window, and unprobed gaps."""

import os

import numpy as np
import pytest
import torch

from tpu_ann.ops import distances as JD
from tpu_ann.ops import ivf_scan_paged as JP
from tpu_ann_torch import SIFT1M_CALIBRATED, sift_surrogate
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops import ivf_scan_paged as TP
from tpu_ann_torch.ops.ivf_scan import PackedInvLists
from torch_parity import assert_topk_equal

L2, IP = JD.METRIC_L2, JD.METRIC_INNER_PRODUCT


def _tile_spans(seed, ntiles=40):
    """Span-sorted tiles as plan_pairs makes them: non-decreasing starts,
    some wide (straddling any small window), some empty (0, 0)."""
    rs = np.random.RandomState(seed)
    bs = np.cumsum(rs.randint(0, 4, size=ntiles)).astype(np.int64)
    be = bs + rs.choice([0, 1, 2, 3, 9, 17], size=ntiles)
    empty = be == bs
    bs[empty] = be[empty] = 0
    return bs, be


@pytest.mark.parametrize("TB", [1, 2, 3])
@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_plan_windows_matches_reference(W, TB):
    for seed in range(3):
        bs, be = _tile_spans(seed * 10 + W)
        want = list(JP._plan_windows(bs, be, W, TB))
        assert list(TP._plan_windows(bs, be, W, TB)) == want
        assert want


def _dataset(seed, n, d, nlist, nempty, integer=True):
    rs = np.random.RandomState(seed)
    if integer:
        x = sift_surrogate(n + 24, seed=seed, **SIFT1M_CALIBRATED)[:, :d]
    else:
        x = rs.rand(n + 24, d).astype(np.float32)
    assign = rs.randint(nlist - nempty, size=n)          # last lists empty
    return x[:n], x[n:], assign


def _build(mod, path, x, assign, nlist, keep_f32=True, chunks=3):
    n, d = x.shape
    sizes = np.bincount(assign, minlength=nlist)
    pil = mod.create_paged_invlists(path, nlist, sizes, d,
                                    keep_f32=keep_f32)
    fill = np.zeros(nlist, np.int64)
    bounds = np.linspace(0, n, chunks + 1).astype(int)
    for a, b in zip(bounds[:-1], bounds[1:]):
        mod.paged_add_chunk(pil, fill, x[a:b],
                            np.arange(a, b, dtype=np.int64), assign[a:b])
    assert (fill == sizes).all()
    return pil


@pytest.mark.parametrize("keep_f32", [True, False])
def test_directory_byte_identical_and_opened_by_both(tmp_path, keep_f32):
    """d=32 (streamed as dp=128), 3 chunks, empty lists: the port writes
    the reference's files byte for byte, and each package opens the
    other's directory."""
    x, _, assign = _dataset(0, 900, 32, 12, 3, integer=False)
    _build(JP, str(tmp_path / "jax"), x, assign, 12, keep_f32)
    _build(TP, str(tmp_path / "torch"), x, assign, 12, keep_f32)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert ("data_f32.bin" in names) == keep_f32
    for name in names:
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "torch" / name).read_bytes()
        assert a == b, name
    for mine, other in ((TP, "jax"), (JP, "torch")):
        pil = mine.open_paged_invlists(str(tmp_path / other))
        ref = JP.open_paged_invlists(str(tmp_path / "jax"))
        assert (pil.d, pil.dp, pil.nblocks) == (32, 128, ref.nblocks)
        assert (pil.data_f32 is None) == (not keep_f32)
        for name in ("ids", "norms", "list_block_start", "list_nblocks"):
            np.testing.assert_array_equal(getattr(pil, name),
                                          getattr(ref, name))
        np.testing.assert_array_equal(
            np.asarray(pil.data_bf16).view(np.uint16),
            np.asarray(ref.data_bf16).view(np.uint16))


def test_bf16_bits_round_to_nearest_even():
    """Tensor.to(torch.bfloat16) and ml_dtypes' cast agree, ties and
    specials included."""
    import ml_dtypes

    rs = np.random.RandomState(3)
    x = np.concatenate([
        rs.randn(5000).astype(np.float32) * 100,
        # exact halfway cases between two bf16 values, both parities
        (np.arange(1, 2000, dtype=np.uint32) << 16 | 0x8000).view(
            np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 3.4e38],
                 np.float32)])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(TP.to_bf16_bits(x), want)


@pytest.fixture(scope="module")
def paged_pair(tmp_path_factory):
    """The same integer data in a JAX-written and a port-written
    directory: 2000 rows of the SIFT surrogate, 16 lists (3 empty),
    26 blocks; 24 queries with 6 probes each, some -1."""
    root = tmp_path_factory.mktemp("paged")
    x, xq, assign = _dataset(5, 2000, 128, 16, 3)
    rs = np.random.RandomState(1)
    probes = np.stack([rs.permutation(16)[:6] for _ in range(len(xq))]
                      ).astype(np.int32)
    probes[::4, -1] = -1
    jp = _build(JP, str(root / "jax"), x, assign, 16)
    tp = _build(TP, str(root / "torch"), x, assign, 16)
    return xq, probes, jp, tp


@pytest.mark.parametrize("metric,W,TB", [
    (L2, 2, 2), (L2, 4, 64), (L2, 4096, 64),
    (IP, 2, 64), (IP, 4, 2), (IP, 4096, 2)])
def test_scan_matches_reference_rw0(paged_pair, metric, W, TB):
    xq, probes, jp, tp = paged_pair
    s0, s1 = {}, {}
    D0, I0, n0 = JP.scan_invlists_paged(
        xq, probes, jp, 10, metric, PT=32, window_blocks=W, TB=TB, RW=0,
        interpret=True, stats=s0)
    D1, I1, n1 = TP.scan_invlists_paged(
        xq, probes, tp, 10, metric, PT=32, window_blocks=W, TB=TB,
        stats=s1, device="cpu")
    assert D1.dtype == np.float32 and I1.dtype == np.int32
    assert_topk_equal(D0, I0, D1, I1)
    assert n1 == n0
    assert (s1["windows"], s1["calls"]) == (s0["windows"], s0["calls"])
    if W == 2:
        assert s1["windows"] >= 2


@pytest.mark.parametrize("metric,W,TB", [
    (L2, 2, 2), (L2, 4096, 64), (IP, 4, 2)])
def test_scan_wide_k_matches_reference_rw0(paged_pair, metric, W, TB):
    """k 100 (kp 106: K4's running lists in global memory on the card)
    against the JAX window kernel with RW=0: (D, I) bit for bit, the same
    ndis and windows."""
    xq, probes, jp, tp = paged_pair
    s0, s1 = {}, {}
    D0, I0, n0 = JP.scan_invlists_paged(
        xq, probes, jp, 100, metric, PT=32, window_blocks=W, TB=TB, RW=0,
        interpret=True, stats=s0)
    D1, I1, n1 = TP.scan_invlists_paged(
        xq, probes, tp, 100, metric, PT=32, window_blocks=W, TB=TB,
        stats=s1, device="cpu")
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)
    assert n1 == n0
    assert (s1["windows"], s1["calls"]) == (s0["windows"], s0["calls"])


def test_scan_float_data_matches_reference(tmp_path):
    """On float data both phases sum in another order than the reference
    (the exact f32 re-rank's 64-term dot products of magnitude ~16 differ
    by up to ~1e-5 between XLA's einsum and torch.bmm): distances within
    rtol 1e-5, ids equal up to ties."""
    x, xq, assign = _dataset(9, 1200, 64, 10, 2, integer=False)
    rs = np.random.RandomState(2)
    probes = np.stack([rs.permutation(10)[:4] for _ in range(len(xq))]
                      ).astype(np.int32)
    jp = _build(JP, str(tmp_path / "j"), x, assign, 10)
    tp = _build(TP, str(tmp_path / "t"), x, assign, 10)
    D0, I0, _ = JP.scan_invlists_paged(xq, probes, jp, 5, PT=32,
                                       window_blocks=3, TB=2, RW=0,
                                       interpret=True)
    D1, I1, _ = TP.scan_invlists_paged(xq, probes, tp, 5, PT=32,
                                       window_blocks=3, TB=2, device="cpu")
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


def _packed(pil):
    """A device layout of the same directory's arrays, for K3's scan."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype))

    data = t(pil.data_f32, np.float32)
    return PackedInvLists(
        data=data, data_bf16=data.to(torch.bfloat16),
        ids=t(pil.ids, np.int32), norms=t(pil.norms, np.float32),
        list_block_start=t(pil.list_block_start, np.int32),
        list_nblocks=t(pil.list_nblocks, np.int32))


@pytest.mark.parametrize("d", [128, 96])
@pytest.mark.parametrize("W", [1, 2, 3, 4096])
def test_scan_equals_fused_reference(tmp_path, d, W):
    """For every window width and tile batch the paged scan equals the
    whole-stream scan of the same content bit for bit: a tile straddling
    windows merges to the same per-pair top-kp. d=96 streams padded to
    dp=128."""
    x, xq, assign = _dataset(11, 1500, d, 12, 2)
    rs = np.random.RandomState(4)
    probes = np.stack([rs.permutation(12)[:5] for _ in range(len(xq))]
                      ).astype(np.int32)
    probes[::3, 0] = -1
    pil = _build(TP, str(tmp_path / "t"), x, assign, 12)
    il = _packed(pil)
    xq_t, pr_t = torch.from_numpy(xq), torch.from_numpy(probes)
    for metric in (L2, IP):
        D0, I0, n0 = F.scan_invlists_fused_reference(xq_t, pr_t, il, 10,
                                                     metric, pt=32)
        for TB in (1, 3, 64):
            D1, I1, n1 = TP.scan_invlists_paged(
                xq, probes, pil, 10, metric, PT=32, window_blocks=W, TB=TB,
                device="cpu")
            np.testing.assert_array_equal(D1, D0.numpy())
            np.testing.assert_array_equal(I1, I0.numpy())
            assert n1 == int(n0)


def test_resident_tier_equals_streamed(paged_pair):
    _, _, _, tp = paged_pair
    xq, probes = paged_pair[0], paged_pair[1]
    D0, I0, _ = TP.scan_invlists_paged(xq, probes, tp, 10, PT=32,
                                       window_blocks=2, TB=2, device="cpu")
    res = TP.upload_resident(tp, tp.nblocks // 2, device="cpu")
    assert res.nblocks == tp.nblocks // 2
    s = {}
    D1, I1, _ = TP.scan_invlists_paged(xq, probes, tp, 10, PT=32,
                                       window_blocks=2, TB=2, resident=res,
                                       stats=s)
    np.testing.assert_array_equal(D0, D1)
    np.testing.assert_array_equal(I0, I1)
    assert s["windows_resident"] >= 1
    assert s["windows"] > s["windows_resident"]
    assert 0 < s["bytes_uploaded"] < tp.nbytes_stream()


def test_window_reference_merges_into_running(paged_pair):
    """Two windows scanned one after the other leave the same running
    top-kp as one window over both; the CPU wrapper takes the plain
    version and counts no launch."""
    xq, probes, _, tp = paged_pair
    pr = torch.from_numpy(probes).long()
    plan = F.plan_pairs(pr, tp, 32)
    xq_t = torch.from_numpy(xq)
    q16 = xq_t.to(torch.bfloat16)
    qn = (xq_t * xq_t).sum(1)
    whole = TP.upload_resident(tp, tp.nblocks, device="cpu")
    kp = 16

    def run(cuts):
        rd = torch.full((plan.ntiles * 32, kp), float("inf"))
        rp = torch.full((plan.ntiles * 32, kp), -1, dtype=torch.int32)
        for a, b in zip(cuts[:-1], cuts[1:]):
            TP.scan_window(q16, qn, plan, whole.blocks(a, b - a), a, 0,
                           plan.ntiles, rd, rp, False)
        return rd, rp

    before = TP.LAUNCHES
    one = run([0, tp.nblocks])
    two = run([0, 11, tp.nblocks])
    assert TP.LAUNCHES == before
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    assert (one[1] >= 0).any()


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("kp", [58, 100])
def test_window_at_wide_kp_equals_fused_reference(paged_pair, kp, metric):
    """K4 above its one-entry-a-lane width: the plain version at kp 58 and
    100, over one window or windows cut inside lists, leaves K3's plain
    per-pair top-kp over the whole stream, and so does the wide route
    (`scan_window_wide`, with the plain pair function standing in for
    the kernel's sub-block launch) after every window."""
    xq, probes, _, tp = paged_pair
    sim = metric == IP
    plan = F.plan_pairs(torch.from_numpy(probes).long(), tp, 32)
    xq_t = torch.from_numpy(xq)
    q16 = xq_t.to(torch.bfloat16)
    qn = torch.zeros(len(xq)) if sim else (xq_t * xq_t).sum(1)
    whole = TP.upload_resident(tp, tp.nblocks, device="cpu")
    d3, p3 = F.scan_pairs_reference(q16, qn, plan, whole, kp, sim)
    assert (p3[:, kp - 1] >= 0).any()          # some pair fills kp
    for cuts in ([0, tp.nblocks], [0, 1, 11, tp.nblocks]):
        ref = (torch.full((plan.ntiles * 32, kp), float("inf")),
               torch.full((plan.ntiles * 32, kp), -1, dtype=torch.int32))
        wide = (ref[0].clone(), ref[1].clone())
        for a, b in zip(cuts[:-1], cuts[1:]):
            win = whole.blocks(a, b - a)
            TP.scan_window_reference(q16, qn, plan, win, a, 0, plan.ntiles,
                                     *ref, sim)
            TP.scan_window_wide(q16, qn, plan, win, a, 0, plan.ntiles,
                                *wide, sim, F.scan_pairs_reference)
            assert torch.equal(wide[0], ref[0]), (a, b)
            assert torch.equal(wide[1], ref[1]), (a, b)
        assert torch.equal(ref[0], d3) and torch.equal(ref[1], p3)


@pytest.mark.parametrize("kp", [65, 106, 1030])
def test_card_route_is_one_launch_over_the_plan(paged_pair, kp,
                                                monkeypatch):
    """Above KP_MAX K4's card route is ONE call of the kernel function over
    the plan's tiles and the window as given, merging in place into the
    running lists at the asked kp, and nothing of the sub-block route
    (`scan_window_wide`, `scan_pairs_wide`) runs. Tensors off the CPU
    (here on the meta device, with the launch replaced by a recorder) take
    the card's route."""
    xq, probes, _, tp = paged_pair
    plan = F.plan_pairs(torch.from_numpy(probes).long(), tp, 128)
    win = TP.upload_resident(tp, tp.nblocks, device="cpu").blocks(3, 9)
    q16 = torch.from_numpy(xq).to(torch.bfloat16).to("meta")
    qn = torch.zeros(len(xq), device="meta")
    rd = torch.empty((plan.ntiles * F.PT, kp), device="meta")
    rp = torch.empty(rd.shape, dtype=torch.int32, device="meta")
    calls = []

    def launch(xq_bf16, qn_, plan_, window, w0, nwin, ta, tb, run_d, run_p,
               sim, B):
        calls.append((plan_, window, w0, nwin, ta, tb, B))
        assert run_d is rd and run_p is rp

    def refused(*args, **kw):
        raise AssertionError("the sub-block route ran")

    monkeypatch.setattr(TP, "_launch", launch)
    for name in ("scan_window_wide", "scan_pairs_wide", "_launch_fresh",
                 "scan_window_reference"):
        monkeypatch.setattr(TP, name, refused)
    TP.scan_window(q16, qn, plan, win, 3, 0, plan.ntiles, rd, rp, False)
    assert calls == [(plan, win, 3, 9, 0, plan.ntiles, tp.block_size)]


def test_pipeline_under_thread_switching(paged_pair):
    """Many one-block windows with the interpreter switching threads as
    often as it can: the staging thread and the scan loop still hand the
    two buffers over in order (a lost or reordered hand-off changes the
    result or raises "window plan drift")."""
    import sys

    xq, probes, _, tp = paged_pair
    res = TP.upload_resident(tp, tp.nblocks, device="cpu")
    D0, I0, _ = TP.scan_invlists_paged(xq, probes, tp, 10, PT=32,
                                       window_blocks=1, TB=1, resident=res)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            s = {}
            D1, I1, _ = TP.scan_invlists_paged(
                xq, probes, tp, 10, PT=32, window_blocks=1, TB=1, stats=s,
                device="cpu")
            np.testing.assert_array_equal(D1, D0)
            np.testing.assert_array_equal(I1, I0)
            assert s["windows"] >= tp.nblocks - 2
    finally:
        sys.setswitchinterval(old)


class _FailingReads:
    """A block stream whose reads fail after the first few."""

    def __init__(self, a, ok_reads):
        self.a, self.ok_reads = a, ok_reads
        self.shape = a.shape

    def __getitem__(self, key):
        self.ok_reads -= 1
        if self.ok_reads < 0:
            raise OSError("read failed")
        return self.a[key]


def test_staging_error_raises_and_stops_the_thread(paged_pair):
    import dataclasses
    import threading

    xq, probes, _, tp = paged_pair
    bad = dataclasses.replace(tp, data_bf16=_FailingReads(tp.data_bf16, 3))
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="staging failed"):
        TP.scan_invlists_paged(xq, probes, bad, 10, PT=32, window_blocks=2,
                               TB=2, device="cpu")
    for _ in range(100):                      # threads wind down in < 1 s
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.01)
    assert threading.active_count() <= before
