"""Port parity: tpu_ann_torch.utils.autotune and utils.ivflib (with the
inspect tools of utils.contrib) against the JAX package, on the CPU.

autotune: the criteria, OperatingPoints / OperatingPointsWithRanges and
ParameterSpace (initialize through IndexIDMap / IndexPreTransform /
IndexRefine, set_index_parameters, combinations) give the reference's
values; explore over IVF indexes on the same centroids gives the same
keys and criterion values at every point (the times are each package's
own). ivflib: extract_index_ivf and replace_ivf_quantizer give the same
(D, I) as the reference on the same rows (integer data: D bit for bit,
ids up to ties); SlidingIndexWindow equals a fresh index over the live
slices at every step (the reference's only until its first drop);
ClusterManager's split keeps every row in exactly one list, grows nlist
by the splits and matches the reference's lists and results."""

import numpy as np
import pytest

import tpu_ann_torch as T
from torch_parity import assert_topk_equal
from tpu_ann.models import idmap as JM
from tpu_ann.models import transforms as JT
from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import IndexIVFFlat as JIVF
from tpu_ann.models.refine import IndexRefineFlat as JRefine
from tpu_ann.utils import autotune as JA
from tpu_ann.utils import contrib as JC
from tpu_ann.utils import ivflib as JL
from tpu_ann_torch.utils import autotune as TA
from tpu_ann_torch.utils import contrib as TC
from tpu_ann_torch.utils import ivflib as TL

D, NLIST, K = 24, 16, 10


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(31)
    xb = rs.randint(0, 256, size=(3000, D)).astype(np.float32)
    xq = rs.randint(0, 256, size=(50, D)).astype(np.float32)
    cent = xb[rs.choice(len(xb), NLIST, replace=False)]
    flat = T.IndexFlat(D, device="cpu")
    flat.add(xb)
    _, gt = flat.search(xq, K)
    return xb, xq, cent, gt


def _ivf(cent, pkg="torch", nlist=NLIST):
    if pkg == "jax":
        q = JFlat(D)
        q.add(cent)
        idx = JIVF(q, D, nlist)
        idx.max_list_scan_factor = 0
    else:
        q = T.IndexFlat(D, device="cpu")
        q.add(cent)
        idx = T.IndexIVFFlat(q, D, nlist, device="cpu")
    idx.quantizer_trains_alone = 1
    idx.train(cent)
    return idx


def test_criteria_equal_reference(data):
    xb, xq, cent, gt = data
    idx = _ivf(cent)
    idx.add(xb)
    idx.nprobe = 2
    Dv, Iv = idx.search(xq, K)
    for R in (1, 5, 10):
        for name in ("OneRecallAtRCriterion", "IntersectionCriterion"):
            j, t = getattr(JA, name)(len(xq), R), getattr(TA, name)(
                len(xq), R)
            j.set_groundtruth(None, gt)
            t.set_groundtruth(None, gt)
            assert t.evaluate(Dv, Iv) == j.evaluate(Dv, Iv)


def test_operating_points_equal_reference():
    rs = np.random.RandomState(3)
    pts = [(float(rs.rand()), float(rs.rand()), f"k{i}") for i in range(40)]
    j, t = JA.OperatingPoints(), TA.OperatingPoints()
    for p in pts:
        assert t.add(*p) == j.add(*p)
    assert [(p.perf, p.t, p.key) for p in t.optimal_pts()] == \
        [(p.perf, p.t, p.key) for p in j.optimal_pts()]
    jr, tr = JA.OperatingPointsWithRanges(), TA.OperatingPointsWithRanges()
    for o in (jr, tr):
        o.add_range("nprobe", [1, 2, 4, 8, 16])
        o.add_range("efSearch", [16, 32, 64])
        o.restrict_range("nprobe", 16)
    assert tr.num_experiments() == jr.num_experiments() == 12
    for cno in range(12):
        key = tr.cno_to_key(cno)
        assert key == jr.cno_to_key(cno)
        assert tr.get_parameters(key) == jr.get_parameters(key)
        perf = 0.1 * sum(key)
        tr.add(perf, perf, key)
        jr.add(perf, perf, key)
    for cno in range(12):
        key = tr.cno_to_key(cno)
        assert tr.predict_bounds(key) == jr.predict_bounds(key)
    with pytest.raises(ValueError):
        tr.restrict_range("nope", 1)


def _wrapped(pkg, cent):
    """IDMap(PreTransform(RR, Refine(IVF))) in one package."""
    if pkg == "jax":
        rr = JT.RandomRotationMatrix(D, D)
        return JM.IndexIDMap(JT.IndexPreTransform(rr, JRefine(
            _ivf(cent, "jax"), JFlat(D))))
    rr = T.RandomRotationMatrix(D, D, device="cpu")
    return T.IndexIDMap(T.IndexPreTransform(rr, T.IndexRefineFlat(
        _ivf(cent), T.IndexFlat(D, device="cpu"))))


@pytest.mark.parametrize("kind", ["ivf", "wrapped", "ivf_hnsw", "hnsw"])
def test_parameter_space_equal_reference(kind, data):
    xb, xq, cent, gt = data
    if kind == "ivf":
        j, t = _ivf(cent, "jax"), _ivf(cent)
    elif kind == "wrapped":
        j, t = _wrapped("jax", cent), _wrapped("torch", cent)
    elif kind == "ivf_hnsw":
        from tpu_ann.models.ivf_hnsw import IndexIVFHNSW as JH

        j, t = JH(D, 64, M=8), T.IndexIVFHNSW(D, 64, M=8, device="cpu")
    else:
        from tpu_ann.models.hnsw import IndexHNSWFlat as JH

        j, t = JH(D, 8), T.IndexHNSWFlat(D, 8, device="cpu")
    pj, pt = JA.ParameterSpace(), TA.ParameterSpace()
    pj.initialize(j)
    pt.initialize(t)
    assert pt.parameter_ranges == pj.parameter_ranges
    assert pt.combinations() == pj.combinations()
    spec = ",".join(f"{n}={v[-1]}" for n, v in pt.parameter_ranges.items())
    pj.set_index_parameters(j, spec)
    pt.set_index_parameters(t, spec)
    ivf_t = TL.extract_index_ivf(t) if kind != "hnsw" else t
    ivf_j = JL.extract_index_ivf(j) if kind != "hnsw" else j
    for name in ("nprobe", "k_factor"):
        if hasattr(ivf_j, name):
            assert getattr(ivf_t, name) == getattr(ivf_j, name)
    if kind == "wrapped":
        assert t.index.index.k_factor == j.index.index.k_factor == 16
    if hasattr(t, "hnsw") or hasattr(getattr(t, "quantizer", None), "hnsw"):
        h_t = t.hnsw if hasattr(t, "hnsw") else t.quantizer.hnsw
        h_j = j.hnsw if hasattr(j, "hnsw") else j.quantizer.hnsw
        assert h_t.efSearch == h_j.efSearch == 256
    for p in (pj, pt):
        with pytest.raises(ValueError):
            p.set_index_parameters(T.IndexFlat(D, device="cpu") if p is pt
                                   else JFlat(D), "efSearch=4")


def test_explore_equal_reference(data):
    """explore over IVF16 on the same centroids: the same keys, and the
    same recall at every one."""
    xb, xq, cent, gt = data
    j, t = _ivf(cent, "jax"), _ivf(cent)
    j.add(xb)
    t.add(xb)
    out = []
    for mod, idx in ((JA, j), (TA, t)):
        ps = mod.ParameterSpace()
        ps.initialize(idx)
        crit = mod.IntersectionCriterion(len(xq), K)
        crit.set_groundtruth(None, gt)
        ops = ps.explore(idx, xq, crit)
        out.append({p.key: p.perf for p in ops.all_pts})
        assert all(p.t > 0 for p in ops.all_pts)
    assert out[1] == out[0]
    assert sorted(out[1]) == [f"nprobe={v}" for v in (1, 2, 4, 8)]


def test_extract_and_replace_quantizer(data):
    xb, xq, cent, _ = data
    t, j = _wrapped("torch", cent), _wrapped("jax", cent)
    ivf_t, ivf_j = TL.extract_index_ivf(t), JL.extract_index_ivf(j)
    assert isinstance(ivf_t, T.IndexIVF)
    with pytest.raises(TypeError):
        TL.extract_index_ivf(T.IndexFlat(D, device="cpu"))
    ivf_t, ivf_j = _ivf(cent), _ivf(cent, "jax")
    for idx in (ivf_t, ivf_j):
        idx.add(xb)
        idx.nprobe = 3
    new = xb[np.random.RandomState(9).choice(len(xb), NLIST, replace=False)]
    qt, qj = T.IndexFlat(D, device="cpu"), JFlat(D)
    qt.add(new)
    qj.add(new)
    TL.replace_ivf_quantizer(ivf_t, qt)
    JL.replace_ivf_quantizer(ivf_j, qj)
    np.testing.assert_array_equal(ivf_t.list_sizes, ivf_j.list_sizes)
    D0, I0 = ivf_j.search(xq, K)
    D1, I1 = ivf_t.search(xq, K)
    np.testing.assert_array_equal(D1, np.asarray(D0))
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1)
    bad = T.IndexFlat(D, device="cpu")
    bad.add(new[:3])
    with pytest.raises(ValueError):
        TL.replace_ivf_quantizer(ivf_t, bad)


def test_inspect_tools_equal_reference(data):
    xb, _, cent, _ = data
    t, j = _ivf(cent), _ivf(cent, "jax")
    ids = np.arange(len(xb), dtype=np.int64) * 5 + 3
    t.add_with_ids(xb, ids)
    j.add_with_ids(xb, ids)
    np.testing.assert_array_equal(TC.get_invlist_sizes(t),
                                  JC.get_invlist_sizes(j))
    for lst in range(NLIST):
        it, vt = TC.get_invlist(t, lst)
        ij, vj = JC.get_invlist(j, lst)
        assert sorted(it.tolist()) == sorted(np.asarray(ij).tolist())
        np.testing.assert_array_equal(vt[np.argsort(it)],
                                      np.asarray(vj)[np.argsort(ij)])
    A = np.random.RandomState(1).randn(8, D).astype(np.float32)
    vt = TC.make_LinearTransform_matrix(A, np.ones(8), device="cpu")
    for got, want in zip(TC.get_linear_transform(vt),
                         JC.get_linear_transform(
                             JC.make_LinearTransform_matrix(A, np.ones(8)))):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(vt.apply(xb[:5]), xb[:5] @ A.T + 1,
                               rtol=1e-5)


def test_sliding_window(data):
    """10 slices of 300, nslice 4: after each step the window equals an
    IVF over the live slices on the same centroids (D and I bit for bit),
    and equals the reference's window given the same ids until the first
    slice is dropped. From then on the reference's window is wrong: it
    drops the host chunks but not their device copies
    (tpu_ann/utils/ivflib.py:71-76 leaves `_xdev_chunks` as it was, and
    the repack gathers stale rows). Default ids never repeat (the
    reference's arange(ntotal, ...) reuses a dropped slice's ids)."""
    xb, xq, cent, _ = data
    t, j = _ivf(cent), _ivf(cent, "jax")
    for idx in (t, j):
        idx.nprobe = 4
    wt, wj = TL.SlidingIndexWindow(t, 4), JL.SlidingIndexWindow(j, 4)
    for s in range(10):
        x = xb[s * 300:(s + 1) * 300]
        ids = np.arange(s * 300, (s + 1) * 300, dtype=np.int64)
        wt.step(x)
        wj.step(x, ids)
        lo = max(0, s - 3) * 300
        assert t.ntotal == j.ntotal == (s + 1) * 300 - lo
        fresh = _ivf(cent)
        fresh.nprobe = 4
        fresh.add_with_ids(xb[lo:(s + 1) * 300],
                           np.arange(lo, (s + 1) * 300))
        D1, I1 = t.search(xq, K)
        D2, I2 = fresh.search(xq, K)
        np.testing.assert_array_equal(D1, D2)
        np.testing.assert_array_equal(I1, I2)
        D0, I0 = j.search(xq, K)
        if s < 4:
            np.testing.assert_array_equal(D1, np.asarray(D0))
            assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1)
        else:
            assert (np.asarray(I0) != I2).mean() > 0.3   # the reference's
    wt.step(None)
    assert t.ntotal == 1200
    # the reference's default ids collide once a slice is gone
    j2 = _ivf(cent, "jax")
    w2 = JL.SlidingIndexWindow(j2, 1)
    w2.step(xb[:10])
    w2.step(xb[10:20])
    w2.step(xb[20:30])
    assert np.asarray(j2._ids_host[0]).tolist() == list(range(10, 20))


def test_cluster_manager(data):
    """One round over the lists above the 4th-largest size: every split
    adds a list, the sizes still sum to ntotal, every id sits in exactly
    one list, and the split lists and centroids match the reference's."""
    xb, xq, cent, gt = data
    t, j = _ivf(cent), _ivf(cent, "jax")
    for idx in (t, j):
        idx.add(xb)
        idx.nprobe = 4
    sizes = t.list_sizes
    cap = int(np.sort(sizes)[-4])
    mt, mj = TL.ClusterManager(t, cap), JL.ClusterManager(j, cap)
    np.testing.assert_array_equal(mt.oversized_lists(), mj.oversized_lists())
    created = mt.balance(max_rounds=1)
    assert created == 3 == mj.balance(max_rounds=1)
    assert t.nlist == j.nlist == NLIST + 3
    assert t.quantizer.ntotal == NLIST + 3
    np.testing.assert_allclose(t._centroid_table().numpy(),
                               np.asarray(j.quantizer.vectors), atol=1e-4)
    np.testing.assert_array_equal(t.list_sizes, j.list_sizes)
    assert t.list_sizes.sum() == t.ntotal == len(xb)
    seen = np.concatenate([TC.get_invlist(t, lst)[0]
                           for lst in range(t.nlist)])
    np.testing.assert_array_equal(np.sort(seen), np.arange(len(xb)))
    assert t.imbalance_factor() == j.imbalance_factor()
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    np.testing.assert_array_equal(D1, np.asarray(D0))
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1)
