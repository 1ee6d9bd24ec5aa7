"""The query-major scan of SQ code lists (scan_invlists_sq) and the IVF-SQ
routes that take it, against the JAX package's on the CPU, for all nine
qtypes; and the IVF-SQ8 fused route (K3-SQ8's plain version) after
remove_ids.

D within rtol 1e-5 and ids up to ties (the dequantized rows are floats),
ndis exact. Both packages pack the same codes, so they scan the same
lists."""

import numpy as np
import pytest
import torch

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.models.ivf_pq import IndexIVFScalarQuantizer as JIVFSQ
from tpu_ann.models.selectors import IDSelectorBatch as JBatch
from tpu_ann.models.selectors import IDSelectorRange as JRange
from tpu_ann.ops import ivf_scan as JScan
from tpu_ann.ops import sq as JSQ
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import SearchParametersIVF as TParams
from tpu_ann_torch.models.ivf_pq import IndexIVFScalarQuantizer as TIVFSQ
from tpu_ann_torch.models.selectors import IDSelectorBatch as TBatch
from tpu_ann_torch.models.selectors import IDSelectorRange as TRange
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan as TScan
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops import sq as TSQ
from torch_parity import assert_topk_equal

D, NLIST, K, B = 24, 12, 10, 32
L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT
QTYPES = [TSQ.QT_8BIT, TSQ.QT_8BIT_UNIFORM, TSQ.QT_FP16, TSQ.QT_BF16,
          TSQ.QT_4BIT, TSQ.QT_4BIT_UNIFORM, TSQ.QT_6BIT, TSQ.QT_8BIT_DIRECT,
          TSQ.QT_8BIT_DIRECT_SIGNED]


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(31)
    xb = rs.randint(0, 200, size=(2500, D)).astype(np.float32)
    xq = rs.randint(0, 200, size=(40, D)).astype(np.float32)
    return xb, xq, xb[rs.choice(len(xb), NLIST, replace=False)]


def _pair(data, qtype, metric=L2):
    xb, _, cent = data
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            q = JFlat(D, metric)
            q.add(cent)
            idx = JIVFSQ(q, D, NLIST, qtype, metric, B)
            # the reference's per-list cap is a TPU-watchdog workaround
            # that the port does not copy: read whole lists on both sides
            idx.max_list_scan_factor = 0
        else:
            q = TFlat(D, metric, device="cpu")
            q.add(cent)
            idx = TIVFSQ(q, D, NLIST, qtype, metric, B, device="cpu")
        idx.quantizer_trains_alone = 1
        idx.train(xb)
        idx.add_with_ids(xb, 100 + np.arange(len(xb), dtype=np.int64))
        out.append(idx)
    return out


def _codec_range(j):
    vmin = np.zeros(D, np.float32) if j.sq.vmin is None else j.sq.vmin
    vdiff = np.ones(D, np.float32) if j.sq.vdiff is None else j.sq.vdiff
    return vmin, vdiff


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("qtype", QTYPES)
def test_scan_invlists_sq_matches_reference(data, qtype, metric):
    xb, xq, _ = data
    j, t = _pair(data, qtype, metric)
    np.testing.assert_array_equal(
        t.invlists.codes.contiguous().view(torch.uint8).numpy(),
        np.ascontiguousarray(np.asarray(j.invlists.codes)).view(np.uint8))
    rs = np.random.RandomState(5)
    probes = np.stack([rs.choice(NLIST, 4, replace=False)
                       for _ in range(len(xq))]).astype(np.int32)
    probes[::6, -1] = -1
    vmin, vdiff = _codec_range(j)
    mask = (rs.rand(len(xb)) < 0.5).astype(np.uint8)
    for mnb, m in ((t.invlists.max_nblocks_per_list, None), (2, mask)):
        D0, I0, n0 = JScan.scan_invlists_sq(
            xq, probes, j.invlists, vmin, vdiff, K, metric, qtype=qtype,
            max_nblocks=mnb, id_mask=m)
        D1, I1, n1 = TScan.scan_invlists_sq(
            torch.from_numpy(xq), torch.from_numpy(probes), t.invlists,
            torch.from_numpy(vmin), torch.from_numpy(vdiff), K, metric,
            qtype=qtype, max_nblocks=mnb,
            id_mask=None if m is None else torch.from_numpy(m))
        assert_topk_equal(np.asarray(D0), np.asarray(I0), D1.numpy(),
                          I1.numpy(), rtol=1e-5)
        assert int(n1) == int(n0)


@pytest.mark.parametrize("qtype", QTYPES)
def test_ivf_sq_search_routes_match_reference(data, qtype):
    """search and search_stats: K3-SQ8's plain version for the 8-bit
    qtypes (the reference scans query-major on the CPU), scan_invlists_sq
    for the others and for every qtype under a selector or a max_codes
    cap; the non-8-bit search_stats count the scan's ndis, as the
    reference's."""
    _, xq, _ = data
    j, t = _pair(data, qtype)
    before = (F.LAUNCHES, F.LAUNCHES_SQ8)
    D0, I0, s0 = j.search_stats(xq, K, params=JParams(nprobe=4))
    D1, I1, s1 = t.search_stats(xq, K, params=TParams(nprobe=4))
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    assert s1.ndis == s0.ndis
    D2, I2 = t.search(xq, K, params=TParams(nprobe=4))
    np.testing.assert_array_equal(D2, D1)
    np.testing.assert_array_equal(I2, I1)
    sel_j, sel_t = JRange(100, 1300), TRange(100, 1300)
    D0, I0 = j.search(xq, K, params=JParams(nprobe=4, sel=sel_j))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=4, sel=sel_t))
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    assert ((I1 == -1) | ((I1 >= 100) & (I1 < 1300))).all()
    D0, I0, s0 = j.search_stats(xq, K, params=JParams(nprobe=4,
                                                      max_codes=B))
    D1, I1, s1 = t.search_stats(xq, K, params=TParams(nprobe=4,
                                                      max_codes=B))
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    assert s1.ndis == s0.ndis
    assert (F.LAUNCHES, F.LAUNCHES_SQ8) == before     # CPU: plain version


@pytest.mark.parametrize("qtype", [TSQ.QT_8BIT, TSQ.QT_8BIT_DIRECT])
def test_ivf_sq8_remove_ids_through_fused_route(data, qtype):
    """After remove_ids the SQ8 view sees the holes: the fused route (K3-
    SQ8's plain version) returns no removed id, equals the reference's
    query-major result and the port's own query-major scan, and the list
    sizes shrink."""
    xb, xq, _ = data
    j, t = _pair(data, qtype)
    t.search(xq[:2], K)
    view = t._sq8
    gone = 100 + np.arange(0, 2500, 3)
    assert t.remove_ids(TBatch(gone)) == j.remove_ids(JBatch(gone))
    assert t._sq8 is view and t._sq8.ids is t.invlists.ids
    D1, I1 = t.search(xq, K, params=TParams(nprobe=5))
    assert not np.isin(I1, gone).any()
    D0, I0 = j.search(xq, K, params=JParams(nprobe=5))
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    t.scan_mode = "query"
    D2, I2 = t.search(xq, K, params=TParams(nprobe=5))
    assert_topk_equal(D0, I0, D2, I2, rtol=1e-5)
    np.testing.assert_array_equal(t.list_sizes, j.list_sizes)
    # the exact re-rank itself: the removed rows' own vectors find no
    # removed id at distance 0
    _, Ig = t.search(xb[::3][:50], 1, params=TParams(nprobe=NLIST))
    assert not np.isin(Ig, gone).any()


@pytest.mark.parametrize("qtype", [TSQ.QT_8BIT, TSQ.QT_4BIT, TSQ.QT_FP16,
                                   TSQ.QT_BF16, TSQ.QT_6BIT])
def test_ivf_sq_sa_codec_and_update(data, qtype):
    """sa_encode bytes equal the reference's, sa_decode equals its decode;
    update_vectors re-encodes through a repack, as the reference's."""
    xb, xq, cent = data
    j, t = _pair(data, qtype)
    assert t.sa_code_size() == j.sa_code_size()
    ct = t.sa_encode(xq)
    np.testing.assert_array_equal(ct, np.asarray(j.sa_encode(xq)))
    np.testing.assert_array_equal(t.sa_decode(ct), j.sa_decode(ct))
    upd = 100 + np.arange(0, 2500, 97)
    xnew = cent[np.arange(len(upd)) % NLIST] + 1.0
    j.update_vectors(upd, xnew)
    t.update_vectors(upd, xnew)
    np.testing.assert_array_equal(t.list_sizes, j.list_sizes)
    D0, I0 = j.search(xq, K, params=JParams(nprobe=4))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=4))
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    np.testing.assert_array_equal(t.reconstruct(int(upd[0])), xnew[0])


def test_decode_code_invlists_generic(data):
    """The decoded raw lists equal the reference's (rows and norms), also
    with coarse centroids added per list (the residual codecs' form)."""
    xb, _, cent = data
    j, t = _pair(data, TSQ.QT_8BIT)
    vmin, vdiff = _codec_range(j)
    codec_j = JSQ.SQCodec(qtype=TSQ.QT_8BIT, d=D, vmin=vmin, vdiff=vdiff)
    codec_t = TSQ.SQCodec(qtype=TSQ.QT_8BIT, d=D, vmin=vmin, vdiff=vdiff)
    for cc in (None, cent):
        dj = JScan.decode_code_invlists_generic(
            j.invlists, lambda c: JSQ.sq_decode(c, codec_j), D,
            coarse_centroids=cc, chunk_blocks=16)
        dt = TScan.decode_code_invlists_generic(
            t.invlists, lambda c: TSQ.sq_decode(c, codec_t), D,
            coarse_centroids=None if cc is None else torch.from_numpy(cc),
            chunk_blocks=16)
        np.testing.assert_allclose(dt.data.numpy(), np.asarray(dj.data),
                                   rtol=1e-6)
        np.testing.assert_allclose(dt.norms.numpy(), np.asarray(dj.norms),
                                   rtol=1e-5)
        assert dt.ids is t.invlists.ids
        assert torch.equal(dt.data_bf16, dt.data.bfloat16())
