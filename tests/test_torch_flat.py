"""The flat slice as a whole: tpu_ann_torch's IndexFlat (exact default,
bf16 blocked path and fused path) against the JAX package's IndexFlat on
the CPU, plus the selectors, the codec and reconstruction API and
IndexFlat1D.

The JAX fused path runs its Pallas kernels in interpret mode
(`flat_knn_fused(..., interpret=True)`, patched in for the call); the
port's runs the plain versions of K1 and K2, since its tensors lie on the
CPU. On integer-valued data (the calibrated SIFT surrogate) both compute
exact scores and break ties alike, so (D, I) are equal; on float data the
ids overlap >= 0.99 (sums in another order can swap a near-tie)."""

import functools

import numpy as np
import pytest
import torch

import tpu_ann.ops.flat_knn_pallas as JFK
from tpu_ann.models import flat as JFlat
from tpu_ann.models import selectors as JS
from tpu_ann.models.base import SearchParameters as JParams
from tpu_ann_torch.models import flat as TFlat
from tpu_ann_torch.models import selectors as TS
from tpu_ann_torch.models.base import SearchParameters as TParams
from tpu_ann_torch.ops import flat_knn_fused as TFK
from tpu_ann_torch.utils.convert import flat_from_reference
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate

D, K = 128, 10


@pytest.fixture(scope="module")
def data():
    x = sift_surrogate(3200, seed=9, **SIFT1M_CALIBRATED)
    return x[:3000], x[3000:]                      # xb, xq


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX IndexFlat's fused route, with its kernels in interpret
    mode (the CPU has no Mosaic)."""
    monkeypatch.setattr(JFK, "flat_knn_fused",
                        functools.partial(JFK.flat_knn_fused,
                                          interpret=True))


def _fused_pair(xb, metric=1, exact_kernel=None):
    j = JFlat.IndexFlat(xb.shape[1], metric)
    t = TFlat.IndexFlat(xb.shape[1], metric, device="cpu")
    for idx in (j, t):
        idx.add(xb)
        idx.compute_dtype, idx.approx_topk = "bfloat16", True
        idx.scan_mode = "fused"
        idx.exact_kernel = exact_kernel
    return j, t


def _overlap(I0, I1):
    return float(np.mean([len(set(a) & set(b)) / len(a)
                          for a, b in zip(I0, I1)]))


@pytest.mark.parametrize("route", ["exact", "refine"])
@pytest.mark.parametrize("with_sel", [False, True])
def test_fused_index_equals_reference(data, jax_interpret, route,
                                      with_sel):
    """Exact route (detected on integer data): W=2048, refine 0, K2.
    Refine route (exact_kernel=False): W=1024, refine 4, K2. Both equal the
    JAX index's, through its own _fused_search_device."""
    xb, xq = data
    j, t = _fused_pair(xb, exact_kernel=None if route == "exact" else False)
    jp = tp = None
    if with_sel:
        jp = JParams(sel=JS.IDSelectorNot(JS.IDSelectorRange(100, 1700)))
        tp = TParams(sel=TS.IDSelectorNot(TS.IDSelectorRange(100, 1700)))
    D0, I0 = j.search(xq, K, params=jp)
    D1, I1 = t.search(xq, K, params=tp)
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)
    assert I1.dtype == np.int64
    assert t._use_exact_kernel(torch.from_numpy(xq)) == (route == "exact")
    if with_sel:
        assert not ((I1 >= 100) & (I1 < 1700)).any()


def test_fused_ip_float_overlap(jax_interpret):
    rs = np.random.RandomState(2)
    xb = rs.rand(3000, 48).astype(np.float32)
    xq = rs.rand(150, 48).astype(np.float32)
    j, t = _fused_pair(xb, metric=0)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert _overlap(I0, I1) >= 0.99
    assert not t._use_exact_kernel(torch.from_numpy(xq))   # IP: refine
    same = I0 == I1
    np.testing.assert_allclose(D1[same], D0[same], rtol=1e-5)


def test_flat_from_reference_fused_search(data, jax_interpret):
    """A JAX IndexFlat's state carried across and searched through the
    fused path gives the JAX package's fused result."""
    xb, xq = data
    j, _ = _fused_pair(xb)
    t = flat_from_reference(j.state_dict(), device="cpu")
    t.compute_dtype, t.approx_topk, t.scan_mode = "bfloat16", True, "fused"
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)


def test_packed_cache_invalidation(data):
    xb, xq = data
    _, t = _fused_pair(xb[:2000])
    t.search(xq, K)
    cached = t._fused_packed
    assert cached is not None
    t.search(xq, K)
    assert t._fused_packed is cached
    for mutate in (lambda: t.add(xb[2000:2100]),
                   lambda: t.remove_ids(TS.IDSelectorRange(0, 10)),
                   t.reset):
        mutate()
        assert t._fused_packed is None
        if t.ntotal:
            t.search(xq, K)
            assert t._fused_packed is not None


def test_default_index_never_takes_the_fused_path(data, monkeypatch):
    """The default IndexFlat is the ground truth and the IVF quantizer:
    its knobs never reach flat_knn_fused, whatever the size or device."""
    xb, xq = data
    t = TFlat.IndexFlat(4, device="cpu")
    t.add(np.zeros((70000, 4), np.float32))
    t.device = torch.device("cuda")          # only the gate reads it
    assert not t._use_fused(K)
    t.compute_dtype, t.approx_topk = "bfloat16", True
    assert t._use_fused(K)                   # the opted-in path would
    assert not t._use_fused(300)             # k > 256
    t.device = torch.device("cpu")
    assert not t._use_fused(K)               # auto: CUDA only

    def boom(*a, **kw):
        raise AssertionError("the fused path ran")

    monkeypatch.setattr(TFK, "flat_knn_fused", boom)
    flat = TFlat.IndexFlat(D, device="cpu")
    flat.add(xb)
    D1, I1 = flat.search(xq, K)
    D0, I0 = _jax_flat(xb).search(xq, K)
    np.testing.assert_array_equal(I1, I0)


def _jax_flat(xb):
    j = JFlat.IndexFlat(xb.shape[1])
    j.add(xb)
    return j


@pytest.mark.parametrize("metric", [1, 0])
def test_bf16_blocked_path_overlap(metric):
    """scan_mode='xla' with the bf16 knobs: the blocked bf16 product with
    an f32 re-rank (refine_factor 4), against the JAX index's."""
    rs = np.random.RandomState(4)
    xb = rs.randn(2500, 32).astype(np.float32)
    xq = rs.randn(80, 32).astype(np.float32)
    out = []
    for idx in (JFlat.IndexFlat(32, metric),
                TFlat.IndexFlat(32, metric, device="cpu")):
        idx.add(xb)
        idx.compute_dtype, idx.approx_topk = "bfloat16", True
        idx.refine_factor, idx.scan_mode = 4, "xla"
        out.append(idx.search(xq, K))
    (D0, I0), (D1, I1) = out
    assert _overlap(I0, I1) >= 0.99
    same = I0 == I1
    np.testing.assert_allclose(D1[same], D0[same], rtol=1e-5)


def test_selectors_make_the_same_bitmaps():
    rs = np.random.RandomState(7)
    bits = rs.randint(0, 256, size=40).astype(np.uint8)
    ids = rs.randint(-5, 400, size=60)

    def build(S):
        rng, arr = S.IDSelectorRange(30, 250), S.IDSelectorArray(ids)
        bm = S.IDSelectorBitmap(bits)
        return [rng, arr, S.IDSelectorBatch(ids), bm, S.IDSelectorAll(),
                S.IDSelectorNot(rng), S.IDSelectorAnd(rng, bm),
                S.IDSelectorOr(arr, bm), S.IDSelectorXOr(rng, arr)]

    probe = np.arange(-3, 330)
    for js, ts in zip(build(JS), build(TS)):
        np.testing.assert_array_equal(ts.make_bitmap(300),
                                      js.make_bitmap(300))
        np.testing.assert_array_equal(ts.member_array(probe),
                                      js.member_array(probe))
        assert ts.is_member(42) == js.is_member(42)


def test_remove_reconstruct_and_codec(data):
    xb, xq = data
    j, t = _jax_flat(xb[:500]), TFlat.IndexFlat(D, device="cpu")
    t.add(xb[:500])
    sel = (JS.IDSelectorArray([0, 7, 99, 499]), TS.IDSelectorArray(
        [0, 7, 99, 499]))
    assert t.remove_ids(sel[1]) == j.remove_ids(sel[0]) == 4
    assert t.ntotal == j.ntotal == 496
    np.testing.assert_array_equal(t.reconstruct(5), j.reconstruct(5))
    np.testing.assert_array_equal(t.reconstruct_n(10, 20),
                                  j.reconstruct_n(10, 20))
    for bad in (-1, 496):
        with pytest.raises(IndexError):
            t.reconstruct(bad)
    with pytest.raises(IndexError):
        t.reconstruct_n(490, 10)
    assert t.sa_code_size() == j.sa_code_size() == 4 * D
    codes = t.sa_encode(xq[:5])
    np.testing.assert_array_equal(codes, j.sa_encode(xq[:5]))
    np.testing.assert_array_equal(t.sa_decode(codes), j.sa_decode(codes))
    np.testing.assert_array_equal(t.sa_decode(codes), xq[:5])
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    np.testing.assert_array_equal(I1, I0)


def test_index_flat_1d():
    rs = np.random.RandomState(8)
    xb = rs.randint(0, 50, size=(300, 1)).astype(np.float32)  # many ties
    xq = rs.rand(40, 1).astype(np.float32) * 60 - 5
    j, t = JFlat.IndexFlat1D(), TFlat.IndexFlat1D(device="cpu")
    for idx in (j, t):
        idx.add(xb)
    for k in (1, 7, 400):
        D0, I0 = j.search(xq, k)
        D1, I1 = t.search(xq, k)
        np.testing.assert_array_equal(D1, D0)
        np.testing.assert_array_equal(I1, I0)


def test_unported_entry_points_raise(data):
    # range_search is ported: the reference's CSR triple
    from tpu_ann.models.flat import IndexFlat as JFlatIndex

    t = TFlat.IndexFlat(D, device="cpu")
    t.add(data[0][:10])
    j = JFlatIndex(D)
    j.add(data[0][:10])
    radius = float(np.median(t.search(data[1], 5)[0][:, 4]))
    for a, b in zip(t.range_search(data[1], radius),
                    j.range_search(data[1], radius)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # faiss METRIC_Linf: an extra metric, searched as the reference does
    # (tests/test_torch_extra_distances.py holds all nine)
    odd = TFlat.IndexFlat(D, 3, device="cpu")
    odd.add(data[0][:10])
    jodd = JFlatIndex(D, 3)
    jodd.add(data[0][:10])
    D0, I0 = jodd.search(data[1], K)
    D1, I1 = odd.search(data[1], K)
    np.testing.assert_allclose(D1, np.asarray(D0), rtol=1e-6)
    np.testing.assert_array_equal(D1 == np.inf, I1 == -1)
