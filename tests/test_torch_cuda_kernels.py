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

# the largest kp whose lists the kernels above KP_MAX keep in shared memory
# at d 128 on the bf16 and the SQ8 stream (csrc/ivf_scan_core.cuh,
# global_lists: eight pairs a CTA, one CTA an SM); the next kp keeps them
# in the output rows
LIST_SMEM_LAST = {False: 2969, True: 2985}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _setup(dev, d, B, nlist=40, n=4000, nq=300, nprobe=6, metric=1,
           integer=True, seed=0, levels=256):
    rs = np.random.RandomState(seed)
    if integer:
        xb = rs.randint(0, levels, size=(n, d)).astype(np.float32)
        xq = rs.randint(0, levels, size=(nq, d)).astype(np.float32)
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
    """A kp above the one-entry-a-lane 32 no longer goes to that kernel:
    kp 33 is served by the wide lists and kp 65 by the lists in global
    memory, each in one launch equal to the plain version; a kp below 1
    and a d that is not a multiple of 8 still raise."""
    dev = _cuda()
    xq, probes, il = _setup(dev, 128, 128, n=500, nq=10)
    for kp in (33, 65):
        before = F.LAUNCHES
        d1, p1 = _pairs(F.scan_pairs, xq, probes, il, kp, 1)
        assert F.LAUNCHES == before + 1
        d0, p0 = _pairs(F.scan_pairs_reference, xq, probes, il, kp, 1)
        assert np.array_equal(d0, d1) and np.array_equal(p0, p1)
    with pytest.raises(ValueError):
        F.scan_invlists_fused(xq, probes, il, 10, kp=-1)
    xq, probes, il = _setup(dev, 12, 128, n=500, nq=10)
    with pytest.raises(ValueError):
        F.scan_invlists_fused(xq, probes, il, 10)


@pytest.mark.parametrize("d,B,kp,nprobe,metric,sq8", [
    (128, 128, 33, 1, 1, False), (128, 128, 46, 1, 1, False),
    (128, 128, 106, 1, 1, False), (128, 128, 46, 6, 1, False),
    (96, 48, 106, 3, 0, False), (128, 16, 40, 6, 1, False),
    (128, 128, 46, 6, 1, True), (128, 64, 106, 1, 0, True),
    (128, 128, 64, 6, 0, False), (128, 16, 64, 6, 1, True),
    (256, 128, 64, 3, 0, False), (128, 128, 65, 6, 0, False),
    (128, 128, 65, 6, 1, True), (96, 48, 106, 6, 1, False),
    (128, 16, 262, 6, 0, False), (128, 128, 262, 3, 1, True),
    (128, 128, 1030, 6, 1, False), (256, 128, 1030, 2, 0, True),
    (128, 128, 33, 6, 0, True), (128, 128, 109, 6, 1, False),
    (128, 128, 110, 6, 0, False), (128, 128, 257, 6, 1, False),
    (128, 128, 262, 6, 1, True), (128, 128, 553, 6, 0, False),
    (128, 128, 554, 6, 1, False), (128, 128, 1145, 3, 1, False),
    (128, 128, 1146, 3, 0, False), (128, 128, 2969, 2, 1, False),
    (128, 128, 2970, 2, 1, False), (128, 128, 2985, 2, 0, True),
    (128, 128, 2986, 2, 1, True)])
def test_wide_kp_equals_plain(d, B, kp, nprobe, metric, sq8):
    """kp above 32: ONE launch over the plan itself, of the wide-list
    kernel up to KP_MAX (64) or of the kernel whose lists live in shared
    memory above it (in its output rows past LIST_SMEM_LAST), of K3, or
    K3-SQ8 on the SQ8 stream, gives the plain version's per-pair top-kp
    bit for bit, positions included, and the whole scan's (D, I) too; kp
    109 / 110, 257 / 258, 553 / 554 and 1145 / 1146 sit where the pairs
    a CTA change at d 128 (262: on the SQ8 stream)."""
    from tpu_ann_torch.ops.ivf_scan import sq8_requantize_invlists

    dev = _cuda()
    xq, probes, il = _setup(dev, d, B, nprobe=nprobe, metric=metric)
    if sq8:
        il = sq8_requantize_invlists(il)
    sim = TD.is_similarity_metric(metric)
    q, qn = F.fold_queries(xq, il, sim)
    plan = F.plan_pairs(probes, il)
    before = (F.LAUNCHES, F.LAUNCHES_SQ8, F.LAUNCHES_GLOBAL)
    d1, p1 = F.scan_pairs(q, qn, plan, il, kp, sim)
    torch.cuda.synchronize()
    got = (F.LAUNCHES - before[0], F.LAUNCHES_SQ8 - before[1])
    assert got == ((0, 1) if sq8 else (1, 0))
    assert F.LAUNCHES_GLOBAL - before[2] == int(kp > F.KP_MAX)
    d0, p0 = F.scan_pairs_reference(q, qn, plan, il, kp, sim)
    assert torch.equal(d0, d1) and torch.equal(p0, p1)
    k = kp - 6
    D1, I1, _ = F.scan_invlists_fused(xq, probes, il, k, metric, kp=kp)
    D0, I0, _ = F.scan_invlists_fused_reference(xq, probes, il, k, metric,
                                                kp=kp)
    assert torch.equal(D0, D1) and torch.equal(I0, I1)


@pytest.mark.parametrize("kp", [33, 64, 65, 106, 1030, "last", "next"])
@pytest.mark.parametrize("nq,nprobe,nlist,n,levels,holes", [
    (300, 6, 40, 4000, 256, 0.0), (64, 3, 7, 4000, 256, 0.0),
    (32, 2, 5, 8000, 256, 0.0), (64, 3, 7, 4000, 2, 0.0),
    (300, 6, 40, 4000, 256, 0.9)])
@pytest.mark.parametrize("metric", [1, 0])
@pytest.mark.parametrize("sq8", [False, True])
def test_global_lists_equal_plain(sq8, metric, nq, nprobe, nlist, n, levels,
                                  holes, kp):
    """The kernels above 32 entries a pair over lists of ~100 rows (37
    filled lists), of ~1000 (4: many chunks, each list filled to kp and
    merged into again) and of ~4000 (2 lists of 60 chunks, filled even at
    LIST_SMEM_LAST, "last", and the next kp, whose lists live in the
    output rows); rows of 0 / 1 values (distances tie across chunks and
    merges); probes -1 but the first for 90% of the queries and all -1 for
    some: one launch, per-pair top-kp equal to the plain version's bit for
    bit, L2 and IP."""
    from tpu_ann_torch.ops.ivf_scan import sq8_requantize_invlists

    dev = _cuda()
    kp = {"last": LIST_SMEM_LAST[sq8],
          "next": LIST_SMEM_LAST[sq8] + 1}.get(kp, kp)
    xq, probes, il = _setup(dev, 128, 128, nlist=nlist, n=n, nq=nq,
                            nprobe=nprobe, metric=metric, levels=levels)
    if holes:
        rs = np.random.RandomState(1)
        probes[torch.from_numpy(rs.rand(nq) < holes).to(dev), 1:] = -1
        probes[::17] = -1
    if sq8:
        il = sq8_requantize_invlists(il)
    sim = TD.is_similarity_metric(metric)
    q16, qn = F.fold_queries(xq, il, sim)
    plan = F.plan_pairs(probes, il)
    before = (F.LAUNCHES, F.LAUNCHES_SQ8, F.LAUNCHES_GLOBAL)
    d1, p1 = F.scan_pairs(q16, qn, plan, il, kp, sim)
    torch.cuda.synchronize()
    got = (F.LAUNCHES - before[0], F.LAUNCHES_SQ8 - before[1],
           F.LAUNCHES_GLOBAL - before[2])
    assert got == ((0, 1) if sq8 else (1, 0)) + (int(kp > F.KP_MAX),)
    d0, p0 = F.scan_pairs_reference(q16, qn, plan, il, kp, sim)
    assert torch.equal(d0, d1) and torch.equal(p0, p1)


@pytest.mark.parametrize("sq8", [False, True])
def test_wide_kp_without_pairs_launches_once(sq8):
    """A scan above KP_MAX whose probes are all -1 (a tile hop that found
    no fresh tile) is one launch over empty tiles, as at any kp; it
    returns empty slots only, as the plain version."""
    from tpu_ann_torch.ops.ivf_scan import sq8_requantize_invlists

    dev = _cuda()
    xq, probes, il = _setup(dev, 128, 128, nprobe=4)
    if sq8:
        il = sq8_requantize_invlists(il)
    q, qn = F.fold_queries(xq[:1], il, False)
    plan = F.plan_pairs(torch.full_like(probes[:1], -1), il)
    before = (F.LAUNCHES, F.LAUNCHES_SQ8)
    d1, p1 = F.scan_pairs(q, qn, plan, il, 106, False)
    torch.cuda.synchronize()
    assert (F.LAUNCHES - before[0], F.LAUNCHES_SQ8 - before[1]) == \
        ((0, 1) if sq8 else (1, 0))
    d0, p0 = F.scan_pairs_reference(q, qn, plan, il, 106, False)
    assert torch.equal(d0, d1) and torch.equal(p0, p1)
    assert (p1 == -1).all() and torch.isinf(d1).all()


@pytest.mark.parametrize("cache_dtype,k,nprobe", [
    ("bfloat16", 10, 8), ("sq8", 10, 8), ("bfloat16", 40, 8),
    ("bfloat16", 100, 1), ("sq8", 100, 1)])
def test_k3_over_decoded_pq_cache(cache_dtype, k, nprobe):
    """An IndexIVFPQ's decoded cache (integer codebooks: the bf16 rows are
    exact) through K3, or through K3-SQ8 for "sq8": one launch a search,
    (D, I) equal to the plain version at default_kp(k) over the same
    cache, above 32 at k 40 (an IVFPQR's k * k_factor: the wide lists)
    and above KP_MAX at k 100 (the lists in global memory), where nprobe 1
    returns min(k, list size) hits."""
    from tpu_ann_torch.models.flat import IndexFlat
    from tpu_ann_torch.models.ivf import SearchParametersIVF
    from tpu_ann_torch.models.ivf_pq import IndexIVFPQ

    dev = _cuda()
    rs = np.random.RandomState(3)
    xb = rs.randint(0, 128, size=(6000, 64)).astype(np.float32)
    xq = rs.randint(0, 128, size=(500, 64)).astype(np.float32)
    q = IndexFlat(64, device=dev)
    q.add(xb[rs.choice(len(xb), 32, replace=False)])
    idx = IndexIVFPQ(q, 64, 32, 16, 8, device=dev)
    idx.quantizer_trains_alone = 1
    idx.decoded_cache_dtype = cache_dtype
    idx.train(xb[:3000])
    idx._set_codec(np.round(idx.pq.centroids))
    idx.add(xb)
    xq_t = torch.from_numpy(xq).to(dev)
    _, probes = idx._coarse_search_device(xq_t, nprobe)
    before = (F.LAUNCHES, F.LAUNCHES_SQ8)
    D1, I1 = idx.search(xq, k, params=SearchParametersIVF(nprobe=nprobe))
    got = (F.LAUNCHES - before[0], F.LAUNCHES_SQ8 - before[1])
    assert got == ((1, 0) if cache_dtype == "bfloat16" else (0, 1))
    D0, I0, _ = F.scan_invlists_fused_reference(
        xq_t, probes, idx._decoded, k, kp=F.default_kp(k))
    I0 = idx._map_ids(I0.cpu().numpy())
    if cache_dtype == "bfloat16":
        assert_topk_equal(D0.cpu().numpy(), I0, D1, I1, rtol=0)
    else:
        assert_topk_equal(D0.cpu().numpy(), I0, D1, I1, rtol=1e-5)
    if k == 100:
        il = idx.invlists
        ids = il.ids.cpu().numpy()
        size = np.array([(ids[s:s + n] >= 0).sum() for s, n in zip(
            il.list_block_start.cpu().numpy(),
            il.list_nblocks.cpu().numpy())])
        held = np.minimum(size[probes.cpu().numpy()].sum(1), k)
        assert np.array_equal((I1 >= 0).sum(1), held)
