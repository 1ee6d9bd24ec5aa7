"""The refine indexes of tpu_ann_torch on the CPU: IndexRefineFlat and the
generic IndexRefine against the JAX package's over the same base index
(an IVFPQ with the reference's codebook), IndexRefineSQ8Tier against the
JAX one and against exact f32, range_search, search_device, and the five
refine faults the reference has, each held to exact f32 or to a clear
error: the tier re-rank in full f32, an untrained add / search, a search
of an empty index, reconstruct of a key out of range, and a decode with
the codec's own qtype."""

import numpy as np
import pytest
import torch

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf_pq import IndexIVFPQ as JIVFPQ
from tpu_ann.models.pq import IndexScalarQuantizer as JSQIndex
from tpu_ann.models.refine import IndexRefine as JRefine
from tpu_ann.models.refine import IndexRefineFlat as JRFlat
from tpu_ann.models.refine import IndexRefineSQ8Tier as JTier
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf_pq import IndexIVFPQ as TIVFPQ
from tpu_ann_torch.models.pq import IndexScalarQuantizer as TSQIndex
from tpu_ann_torch.models.refine import IndexRefine as TRefine
from tpu_ann_torch.models.refine import IndexRefineFlat as TRFlat
from tpu_ann_torch.models.refine import IndexRefineSQ8Tier as TTier
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import sq as TSQ
from tpu_ann_torch.utils.convert import refine_from_reference
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

D, NLIST, K = 32, 16, 10
L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT


@pytest.fixture(scope="module")
def data():
    x = sift_surrogate(3300, seed=41, **SIFT1M_CALIBRATED)[:, :D].copy()
    xb, xt, xq = x[:2500], x[2500:3200], x[3200:]
    cent = xt[np.random.RandomState(3).choice(len(xt), NLIST, replace=False)]
    return xb, xt, xq, cent


def _bases(data, metric=L2):
    """(JAX, port) IVFPQ bases (M 4, 8 bits: a coarse codec, so the
    re-rank matters) with the same centroids and codebook, nprobe 4,
    trained and empty."""
    _, xt, _, cent = data
    jq, tq = JFlat(D, metric), TFlat(D, metric, device="cpu")
    jq.add(cent)
    tq.add(cent)
    j = JIVFPQ(jq, D, NLIST, 4, 8, metric, 32)
    t = TIVFPQ(tq, D, NLIST, 4, 8, metric, 32, device="cpu")
    for idx in (j, t):
        idx.quantizer_trains_alone = 1
        idx.max_list_scan_factor = 0
        idx.nprobe = 4
        idx.train(xt)
    t._set_codec(j.pq.centroids)
    return j, t


@pytest.mark.parametrize("metric", [L2, IP])
def test_refine_flat_matches_reference(data, metric):
    xb, _, xq, _ = data
    jb, tb = _bases(data, metric)
    j, t = JRFlat(jb), TRFlat(tb)
    assert t.is_trained and t.k_factor == 4
    j.add(xb)
    t.add(xb)
    assert t.ntotal == len(xb)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=0 if metric == L2 else 1e-6)
    # the distances are exact f32 over the base rows
    rec = xb[I1]
    exact = ((rec - xq[:, None]) ** 2).sum(-1) if metric == L2 else \
        (rec * xq[:, None]).sum(-1)
    np.testing.assert_allclose(D1, exact, rtol=1e-6)
    Dd, Id = t.search_device(torch.from_numpy(xq), K)
    np.testing.assert_array_equal(Dd.numpy(), D1)
    np.testing.assert_array_equal(Id.numpy(), I1)
    # refine_from_reference over the port's base
    c = refine_from_reference({"xb": xb, "k_factor": 4}, tb, device="cpu")
    np.testing.assert_array_equal(c.search(xq, K)[1], I1)


def test_refine_range_and_generic(data):
    xb, _, xq, _ = data
    jb, tb = _bases(data)
    j, t = JRFlat(jb), TRFlat(tb)
    j.add(xb)
    t.add(xb)
    r = float(np.median(t.search(xq, K)[0][:, 5]))
    l0, d0, i0 = j.range_search(xq, r)
    l1, d1, i1 = t.range_search(xq, r)
    np.testing.assert_array_equal(l1, l0)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(d1, d0, rtol=1e-6)
    # generic IndexRefine: the refine codec's reconstructions (an SQ8
    # direct index, exact on this data)
    jb, tb = _bases(data)
    jg = JRefine(jb, JSQIndex(D, TSQ.QT_8BIT_DIRECT))
    tg = TRefine(tb, TSQIndex(D, TSQ.QT_8BIT_DIRECT, device="cpu"))
    jg.add(xb)
    tg.add(xb)
    D0, I0 = jg.search(xq[:20], K)
    D1, I1 = tg.search(xq[:20], K)
    assert_topk_equal(D0, I0, D1, I1, rtol=0)
    np.testing.assert_array_equal(tg.reconstruct(5), xb[5])


def test_refine_sq8_tier(data):
    xb, xt, xq, _ = data
    jb, tb = _bases(data)
    j, t = JTier(jb), TTier(tb)
    for idx in (j, t):
        idx.train(xt)
    np.testing.assert_array_equal(t.codec.vmin, j.codec.vmin)
    np.testing.assert_array_equal(t.codec.vdiff, j.codec.vdiff)
    tb._set_codec(jb.pq.centroids)    # train() retrained the base codec
    j.add(xb)
    t.add(xb)
    np.testing.assert_array_equal(t._codes.numpy(),
                                  np.concatenate(j._host_codes))
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    ov = np.mean([len(set(a) & set(b)) / K for a, b in zip(I0, I1)])
    assert ov >= 0.99
    # fault :184 — the re-rank is full f32: within f32 rounding of the
    # norm expansion (a few ulps of ||q||^2 + ||x||^2; bf16 products would
    # miss by ~1e-3 of <q, x>) of an f64 recomputation over the decoded
    # codes
    dec = TSQ.sq_decode(t._codes, t.codec).numpy().astype(np.float64)
    q64 = xq[:, None].astype(np.float64)
    ex = ((dec[I1] - q64) ** 2).sum(-1)
    scale = (q64 ** 2).sum(-1) + (dec[I1] ** 2).sum(-1)
    assert (np.abs(D1 - ex) <= 1e-6 * scale).all()
    np.testing.assert_allclose(t.reconstruct(7), dec[7], rtol=0)
    # fault :267 — a key out of range raises
    for key in (-1, t.ntotal):
        with pytest.raises(KeyError):
            t.reconstruct(key)
    c = refine_from_reference({"qtype": t.codec.qtype, "vmin": t.codec.vmin,
                               "vdiff": t.codec.vdiff,
                               "codes": t._codes.numpy()}, tb, device="cpu")
    np.testing.assert_array_equal(c.search(xq, K)[1], I1)


def test_refine_faults_raise_or_answer(data):
    xb, xt, xq, _ = data
    # fault :229 — untrained add / search raise a clear error
    for idx in (TTier(TFlat(D, device="cpu")),
                TRFlat(TIVFPQ(TFlat(D, device="cpu"), D, NLIST, 4,
                              device="cpu"))):
        assert not idx.is_trained
        with pytest.raises(RuntimeError, match="train\\(\\) before add"):
            idx.add(xb)
        with pytest.raises(RuntimeError, match="train\\(\\) before search"):
            idx.search(xq, K)
    # fault :249 — an empty index answers -1 and the metric's worst value
    for metric in (L2, IP):
        for idx in (TTier(TFlat(D, metric, device="cpu")),
                    TRFlat(TFlat(D, metric, device="cpu"))):
            idx.train(xt)
            Dv, Iv = idx.search(xq, K)
            assert (Iv == -1).all()
            assert (Dv == TD.worst_value(metric)).all()
    # fault :183 — the decode takes the codec's own qtype
    t = TTier(TFlat(D, device="cpu"))
    t.train(xt)
    t.codec = TSQ.SQCodec(qtype=TSQ.QT_8BIT_DIRECT, d=D)
    t.add(xb)
    D1, I1 = t.search(xq, K)
    exact = TFlat(D, device="cpu")
    exact.add(xb)
    assert_topk_equal(*exact.search(xq, K), D1, I1, rtol=0)
