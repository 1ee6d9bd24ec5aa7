"""Port parity at wide k: the searches that reach the wide-list kernels of
K3 / K3-SQ8 (kp 33-64, two list entries a lane) and the global-list ones
(kp >= 65), on the CPU, where the port runs their plain versions, against
the JAX package on the same numpy inputs.

- IVF-SQ8 (IndexIVFScalarQuantizer, the fixtures of test_torch_ivf_sq) at
  k 27 / 58 / 59 / 100, kp = default_kp(k) = 33 / 64 / 65 / 106, nprobe 4
  and 8: QT_8BIT_DIRECT on the integer SIFT surrogate is lossless, so
  (D, I) equal up to ties at rtol 0; QT_8BIT ids overlap >= 0.99 and the
  distances of shared ids agree to rtol 1e-5 (the JAX index scans
  query-major on the CPU and decodes with its own offset order).
- HNSW16,SQ8's "sq8" tiles (the fixtures of test_torch_hnsw_storage, the
  reference's Pallas scan in interpret mode) at (k 40, efSearch 64), kp 40,
  and (k 100, efSearch 128), kp 64: D within rtol 1e-5, ids equal outside
  near-ties.
- IndexIVFHNSW carried over from the JAX index, coarse_mode "auto", at
  k 100 (kp 106): ids equal up to ties, D within rtol 1e-5."""

import numpy as np
import pytest

import tpu_ann_torch as T
from tpu_ann.models import hnsw as JM
from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.models.ivf_hnsw import IndexIVFHNSW as JIVFHNSW
from tpu_ann_torch.models.ivf import SearchParametersIVF as TParams
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops import sq as TSQ
from tpu_ann_torch.utils.convert import ivf_hnsw_from_reference
from test_torch_hnsw_storage import _fused_mode, _sq_pair, ints, interpret
from test_torch_ivf_hnsw import _export
from test_torch_ivf_sq import IP, L2, _build, _overlap, data
from torch_parity import assert_topk_equal

__all__ = ["data", "ints", "interpret"]      # fixtures used by the tests

_IVF_SQ = {}


def _ivf_sq_pair(data, qtype, metric):
    """The JAX and the port's IVF-SQ index over the same centroids and
    rows, built once a (qtype, metric)."""
    key = (qtype, metric)
    if key not in _IVF_SQ:
        _IVF_SQ[key] = (_build("jax", data, qtype, metric),
                        _build("torch", data, qtype, metric))
    return _IVF_SQ[key]


@pytest.mark.parametrize("qtype,metric", [(TSQ.QT_8BIT_DIRECT, L2),
                                          (TSQ.QT_8BIT_DIRECT, IP),
                                          (TSQ.QT_8BIT, L2)])
@pytest.mark.parametrize("k", [27, 58, 59, 100])
def test_ivf_sq8_wide_k_matches_reference(data, k, qtype, metric):
    _, _, xq, _ = data
    j, t = _ivf_sq_pair(data, qtype, metric)
    assert F.default_kp(k) == {27: 33, 58: 64, 59: 65, 100: 106}[k]
    before = (F.LAUNCHES, F.LAUNCHES_SQ8)
    for nprobe in (4, 8):
        D0, I0 = j.search(xq, k, params=JParams(nprobe=nprobe))
        D1, I1 = t.search(xq, k, params=TParams(nprobe=nprobe))
        assert D1.shape == I1.shape == (len(xq), k)
        assert (I1 >= 500).all()                # user ids, every slot full
        if qtype == TSQ.QT_8BIT_DIRECT:
            assert_topk_equal(D0, I0, D1, I1, rtol=0)
        else:
            assert _overlap(I0, I1) >= 0.99
            for q in range(len(xq)):
                m0, m1 = dict(zip(I0[q], D0[q])), dict(zip(I1[q], D1[q]))
                for i in set(m0) & set(m1):
                    np.testing.assert_allclose(m1[i], m0[i], rtol=1e-5)
    assert (F.LAUNCHES, F.LAUNCHES_SQ8) == before     # CPU: plain version


@pytest.mark.parametrize("k,ef", [(40, 64), (100, 128)])
def test_hnsw_sq8_tiles_wide_k_match_reference(ints, interpret, k, ef):
    xb, xq = ints
    j, t = _sq_pair(xb, "sq8", L2)
    _fused_mode(j, t)
    b = t.hnsw.fused_tile_size
    assert max(t.hnsw.fused_kp, min(b, k, t.hnsw.fused_kp_max)) == min(k, 64)
    D0, I0 = j.search(xq, k, params=JM.SearchParametersHNSW(efSearch=ef))
    D1, I1 = t.search(xq, k, params=T.SearchParametersHNSW(efSearch=ef))
    assert D1.shape == (len(xq), k)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


@pytest.fixture(scope="module")
def ivf_hnsw(data):
    """A JAX IndexIVFHNSW (32 lists of about 125 rows, M 16) on the IVF-SQ
    fixture's rows, and the port's carried over from it."""
    xb, xt, _, _ = data
    j = JIVFHNSW(128, 32, M=16)
    j.cp.niter = 4
    j.train(xt)
    j.add(xb)
    return j, ivf_hnsw_from_reference(_export(j), device="cpu")


def test_ivf_hnsw_k100_matches_reference(data, ivf_hnsw):
    _, _, xq, _ = data
    j, t = ivf_hnsw
    assert t.coarse_mode == "auto" and F.default_kp(100) == 106
    D0, I0 = j.search(xq, 100, params=JParams(nprobe=6))
    D1, I1 = t.search(xq, 100, params=TParams(nprobe=6))
    assert (I1 >= 0).all()
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
