"""Port parity for the fused IVF scan (tpu_ann_torch.ops.ivf_scan_fused)
and the packed layout it reads (tpu_ann_torch.ops.ivf_scan).

The JAX side runs its Pallas kernel the way tests/test_ivf_pallas.py runs
it on the CPU: interpret mode, block_size 16, PT=32, CB=2. With RW=0 the
reference keeps an exact per-pair top-kp, which is the port's semantics.
On integer-valued data bf16 scores are exact on both sides, so distances
agree to rtol 1e-6 (the exact f32 re-rank sums in another order, exact on
integers too) and ids agree up to ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import distances as JD
from tpu_ann.ops.ivf_scan import pack_invlists as j_pack
from tpu_ann.ops.ivf_scan_pallas import scan_invlists_fused as j_fused
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops.ivf_scan import pack_invlists as t_pack
from torch_parity import assert_topk_equal

B = 16


def _data(seed, n=1500, d=32, nlist=24, nq=48, nempty=4, integer=True):
    """Rows assigned to the first nlist - nempty centroids only, so the
    last nempty lists are empty (and still probed)."""
    rs = np.random.RandomState(seed)
    if integer:
        xb = rs.randint(0, 64, size=(n, d)).astype(np.float32)
        xq = rs.randint(0, 64, size=(nq, d)).astype(np.float32)
    else:
        xb = rs.rand(n, d).astype(np.float32)
        xq = rs.rand(nq, d).astype(np.float32)
    cent = xb[rs.choice(n, nlist, replace=False)]
    _, a = TD.knn(torch.from_numpy(xb), torch.from_numpy(cent[:nlist - nempty]),
                  1)
    return xb, xq, cent, a[:, 0].numpy()


def _probes(xq, cent, nprobe, metric, drop=0):
    _, p = TD.knn(torch.from_numpy(xq), torch.from_numpy(cent), nprobe,
                  metric)
    p = p.numpy().astype(np.int32)
    if drop:
        p[::3, -drop:] = -1          # -1 probes are skipped
    return p


def _pair(xb, assign, nlist):
    ids = np.arange(len(xb))
    return (j_pack(xb, ids, assign, nlist, block_size=B),
            t_pack(xb, ids, assign, nlist, block_size=B, device="cpu"))


def test_pack_matches_reference():
    xb, _, _, assign = _data(0)
    jl, tl = _pair(xb, assign, 24)
    for name in ("data", "ids", "norms", "list_block_start",
                 "list_nblocks"):
        a, b = np.asarray(getattr(jl, name)), getattr(tl, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    nb = tl.list_nblocks.numpy()
    assert (nb[-4:] == 0).all()
    assert (tl.list_block_start.numpy()[-4:] == tl.nblocks).all()
    assert (tl.ids.numpy()[-1] == -1).all()        # the dummy block
    assert torch.equal(tl.data_bf16, tl.data.to(torch.bfloat16))


CASES = [(1, JD.METRIC_L2, 0), (8, JD.METRIC_L2, 0), (8, JD.METRIC_L2, 2),
         (1, JD.METRIC_INNER_PRODUCT, 0), (8, JD.METRIC_INNER_PRODUCT, 2)]


@pytest.mark.parametrize("nprobe,metric,drop", CASES)
def test_fused_scan_matches_reference_rw0(nprobe, metric, drop):
    k = 10
    xb, xq, cent, assign = _data(1 + nprobe)
    jl, tl = _pair(xb, assign, 24)
    probes = _probes(xq, cent, nprobe, metric, drop)
    for refine in (4, 0):
        D0, I0, n0 = j_fused(jnp.asarray(xq), jnp.asarray(probes), jl, k,
                             metric, PT=32, CB=2, RW=0, refine=refine,
                             interpret=True)
        xq_t, pr_t = torch.from_numpy(xq), torch.from_numpy(probes)
        outs = [F.scan_invlists_fused(xq_t, pr_t, tl, k, metric,
                                      refine=refine),
                F.scan_invlists_fused_reference(xq_t, pr_t, tl, k, metric,
                                                refine=refine, pt=32)]
        for D1, I1, n1 in outs:
            assert_topk_equal(np.asarray(D0), np.asarray(I0), D1.numpy(),
                              I1.numpy(), rtol=1e-6)
            assert int(n1) == int(n0)


def test_pairs_exact_topk_and_ties():
    """The plain per-pair output is the exact top-kp with ties to the
    lower stream position, (+inf, -1) on empty slots, independent of the
    tile size."""
    xb, xq, cent, assign = _data(5, n=600, nq=20)
    tl = t_pack(xb, np.arange(len(xb)), assign, 24, block_size=B,
                device="cpu")
    probes = torch.from_numpy(_probes(xq, cent, 4, JD.METRIC_L2, drop=1))
    xq_t = torch.from_numpy(xq)
    qn = TD.l2_norms(xq_t)
    kp = 12
    outs = []
    for pt in (8, 32):
        plan = F.plan_pairs(probes, tl, pt)
        d, p = F.scan_pairs(xq_t.bfloat16(), qn, plan, tl, kp, False)
        npairs = probes.numel()
        pd = torch.empty(npairs, kp)
        pp = torch.empty(npairs, kp, dtype=torch.int32)
        pd[plan.order], pp[plan.order] = d[:npairs], p[:npairs]
        outs.append((pd, pp))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    pd, pp = outs[0]
    # brute force per pair over its list's valid rows
    data = tl.data.view(-1, xb.shape[1])
    ids = tl.ids.view(-1)
    starts, nblk = tl.list_block_start, tl.list_nblocks
    for i, lst in enumerate(probes.reshape(-1).tolist()):
        q = xq_t[i // probes.shape[1]]
        if lst < 0 or nblk[lst] == 0:
            assert torch.isinf(pd[i]).all() and (pp[i] == -1).all()
            continue
        rows = torch.arange(int(starts[lst]) * B,
                            int(starts[lst] + nblk[lst]) * B)
        rows = rows[ids[rows] >= 0]
        dist = ((data[rows] - q) ** 2).sum(1)
        order = sorted(range(len(rows)),
                       key=lambda j: (float(dist[j]), int(rows[j])))[:kp]
        m = len(order)
        assert pp[i, :m].tolist() == [int(rows[j]) for j in order]
        assert pd[i, :m].tolist() == [float(dist[j]) for j in order]
        assert (pp[i, m:] == -1).all() and torch.isinf(pd[i, m:]).all()


@pytest.mark.parametrize("metric", [JD.METRIC_L2, JD.METRIC_INNER_PRODUCT])
def test_recall_not_below_reservoir_reference(metric):
    """Against the reference's default RW=512 lane-min reservoir (which
    can drop candidates), the port's exact per-pair top-kp loses
    nothing: on float data its recall against exact search over the same
    probed lists is not lower."""
    k = 10
    xb, xq, cent, assign = _data(7, n=3000, nq=64, nempty=0, integer=False)
    jl, tl = _pair(xb, assign, 24)
    probes = _probes(xq, cent, 8, metric)
    _, I0, _ = j_fused(jnp.asarray(xq), jnp.asarray(probes), jl, k, metric,
                       PT=32, CB=2, interpret=True)
    _, I1, _ = F.scan_invlists_fused(torch.from_numpy(xq),
                                     torch.from_numpy(probes), tl, k, metric)
    # exact answer over each query's probed rows
    _, gt = TD.knn(torch.from_numpy(xq), torch.from_numpy(xb), len(xb),
                   metric)
    gt = gt.numpy()
    in_probed = np.stack([np.isin(assign[gt[q]], probes[q])
                          for q in range(len(xq))])
    gt_probed = np.stack([gt[q][in_probed[q]][:k] for q in range(len(xq))])

    def rec(I):
        return np.mean([len(set(I[q]) & set(gt_probed[q])) / k
                        for q in range(len(xq))])

    r0, r1 = rec(np.asarray(I0)), rec(I1.numpy())
    assert r1 >= r0, (r1, r0)
    assert r1 >= 0.99, r1


def test_cpu_tensors_take_plain_version_and_count_no_launch():
    xb, xq, cent, assign = _data(9, n=300, nq=8)
    tl = t_pack(xb, np.arange(len(xb)), assign, 24, block_size=B,
                device="cpu")
    before = F.LAUNCHES
    F.scan_invlists_fused(torch.from_numpy(xq),
                          torch.from_numpy(_probes(xq, cent, 2, 1)), tl, 5)
    assert F.LAUNCHES == before
    assert F.default_kp(10) == 16 and F.default_kp(2) == 4


WIDE_CASES = [(16, 33, 1, JD.METRIC_L2, "bf16"),
              (128, 46, 1, JD.METRIC_L2, "bf16"),
              (128, 106, 1, JD.METRIC_L2, "bf16"),
              (128, 46, 3, JD.METRIC_INNER_PRODUCT, "bf16"),
              (48, 106, 3, JD.METRIC_L2, "bf16"),
              (128, 46, 2, JD.METRIC_L2, "sq8"),
              (64, 70, 4, JD.METRIC_INNER_PRODUCT, "sq8")]


@pytest.mark.parametrize("bs,kp,nprobe,metric,stream", WIDE_CASES)
@pytest.mark.parametrize("budget", [0, 640])
def test_wide_kp_equals_per_pair_scan(bs, kp, nprobe, metric, stream,
                                      budget, monkeypatch):
    """kp above the one-entry-a-lane kernel's 32: one pass over sub-blocks
    of at most 32 rows, each kept whole (`scan_pairs_wide`, here over the
    plain version, as the card runs it over one K3 / K3-SQ8 launch above
    KP_MAX), gives the per-pair scan's
    top-kp bit for bit, on data of few values (many ties), probes of -1
    and empty lists included; ``budget`` 640 selects in groups of five
    sub-pairs (a pair wider than a group taken alone)."""
    from tpu_ann_torch.ops.ivf_scan import sq8_requantize_invlists

    if budget:
        monkeypatch.setattr(F, "_PLAIN_BUDGET", budget)
    rs = np.random.RandomState(kp + bs + nprobe)
    xb = rs.randint(0, 3, size=(2500, 16)).astype(np.float32)
    xq = rs.randint(0, 3, size=(20, 16)).astype(np.float32)
    nlist = 10
    assign = rs.choice(nlist - 2, len(xb), p=[.4] + [.6 / 7] * 7)
    il = t_pack(xb, np.arange(len(xb)), assign, nlist, block_size=bs,
                device="cpu")
    if stream == "sq8":
        il = sq8_requantize_invlists(il)
    probes = rs.randint(0, nlist, size=(len(xq), nprobe)).astype(np.int32)
    probes[::4, 0] = -1
    sim = JD.is_similarity_metric(metric)
    q, qn = F.fold_queries(torch.from_numpy(xq), il, sim)
    plan = F.plan_pairs(torch.from_numpy(probes), il)
    want = F.scan_pairs_reference(q, qn, plan, il, kp, sim)
    got = F.scan_pairs_wide(q, qn, plan, il, kp, sim, F.scan_pairs_reference)
    assert F.sub_block_rows(bs) == {16: 16, 128: 32, 48: 24, 64: 32}[bs]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(want[0][:, :kp]).any(1).sum() > 0


@pytest.mark.parametrize("kp", [65, 106])
def test_wide_kp_without_pairs_calls_nothing(kp):
    """`scan_pairs_wide` over a plan whose probes are all -1 (a tile hop
    that found no fresh tile) has no sub-pair: it calls its pair function
    (on the card, the kernel) not at all, and returns the per-pair scan's
    result: empty slots only."""
    rs = np.random.RandomState(0)
    xb = rs.randint(0, 3, size=(600, 16)).astype(np.float32)
    il = t_pack(xb, np.arange(600), rs.randint(0, 5, 600), 5,
                block_size=128, device="cpu")
    q, qn = F.fold_queries(torch.from_numpy(xb[:3]), il, False)
    plan = F.plan_pairs(torch.full((3, 4), -1, dtype=torch.int32), il)
    seen = []

    def pair_fn(*args, **kw):
        seen.append(args[2].ntiles)
        return F.scan_pairs_reference(*args, **kw)

    got = F.scan_pairs_wide(q, qn, plan, il, kp, False, pair_fn)
    want = F.scan_pairs_reference(q, qn, plan, il, kp, False)
    assert seen == []
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1] == -1).all()


@pytest.mark.parametrize("refine", [4, 0])
@pytest.mark.parametrize("nprobe,metric,drop", CASES)
@pytest.mark.parametrize("k", [100, 300])
def test_fused_scan_wide_k_matches_reference_rw0(k, nprobe, metric, drop,
                                                 refine):
    """k 100 and 300 (kp 106 and 306: the kernels' lists in global memory
    on the card) against the JAX kernel with its exact per-chunk epilogue
    (RW=0): the same (D, I) bit for bit and the same ndis, on integer
    data."""
    xb, xq, cent, assign = _data(1 + nprobe)
    jl, tl = _pair(xb, assign, 24)
    probes = _probes(xq, cent, nprobe, metric, drop)
    D0, I0, n0 = j_fused(jnp.asarray(xq), jnp.asarray(probes), jl, k,
                         metric, PT=32, CB=2, RW=0, refine=refine,
                         interpret=True)
    D1, I1, n1 = F.scan_invlists_fused(torch.from_numpy(xq),
                                       torch.from_numpy(probes), tl, k,
                                       metric, refine=refine)
    np.testing.assert_array_equal(D1.numpy(), np.asarray(D0))
    np.testing.assert_array_equal(I1.numpy(), np.asarray(I0))
    assert int(n1) == int(n0)


@pytest.mark.parametrize("kp", [65, 106, 1030])
@pytest.mark.parametrize("stream", ["bf16", "sq8"])
def test_card_route_is_one_launch_over_the_plan(kp, stream, monkeypatch):
    """Above KP_MAX the card's route is ONE call of the kernel function,
    over the plan itself at the asked kp, and nothing of the sub-block
    route (`scan_pairs_wide`) runs. A tensor off the CPU (here on the meta
    device, with the launch replaced by a recorder that answers with the
    plain version) takes the card's route."""
    from tpu_ann_torch.ops.ivf_scan import sq8_requantize_invlists

    xb, xq, cent, assign = _data(5, n=600, nq=20)
    il = t_pack(xb, np.arange(len(xb)), assign, 24, block_size=B,
                device="cpu")
    if stream == "sq8":
        il = sq8_requantize_invlists(il)
    q, qn = F.fold_queries(torch.from_numpy(xq), il, False)
    plan = F.plan_pairs(torch.from_numpy(_probes(xq, cent, 4, 1)), il)
    reference = F.scan_pairs_reference
    calls = []

    def launch(xq_bf16, qn_, plan_, il_, kp_, sim, B=0):
        calls.append((plan_, il_, kp_, B, xq_bf16.device.type))
        return reference(q, qn, plan_, il_, kp_, sim)

    def refused(*args, **kw):
        raise AssertionError("the sub-block route ran")

    monkeypatch.setattr(F, "_launch", launch)
    monkeypatch.setattr(F, "scan_pairs_wide", refused)
    monkeypatch.setattr(F, "sub_block_rows", refused)
    monkeypatch.setattr(F, "scan_pairs_reference", refused)
    got = F.scan_pairs(q.to("meta"), qn.to("meta"), plan, il, kp, False)
    assert len(calls) == 1
    assert calls[0][0] is plan and calls[0][1] is il
    assert calls[0][2:] == (kp, 0, "meta")
    want = reference(q, qn, plan, il, kp, False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
