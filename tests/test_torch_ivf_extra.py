"""The IVF couplings of tpu_ann_torch (models/ivf_extra.py:
IndexIVFSpectralHash, IndexIVFIndependentQuantizer; ops/ivf_scan.
scan_invlists_hash; utils/contrib.add_preassigned) against the JAX
package's, on the CPU.

Data: integer-valued rows (0..15, d 32, 2000 rows, a numpy seed), nlist
16, codes of 64 bits. The reference's quantizer and projection are carried
across, so both packages binarize the same f32 projections in the same
order of operations: the codes are equal bit for bit on this data (a
projection within an f32 rounding of a bit boundary could flip one), and
the Hamming distances too; ids are compared up to ties (the two scans
visit a list's blocks in different orders). The independent quantizer's
PCA payload is f32: distances within rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ann_torch as T
import tpu_ann.models as JM
from tpu_ann.models import ivf_extra as JIE
from tpu_ann.models.selectors import IDSelectorRange as JRange
from tpu_ann.models.transforms import PCAMatrix as JPCA
from tpu_ann.ops import ivf_scan as JS
from tpu_ann_torch.ops import ivf_scan as TS
from tpu_ann_torch.utils.contrib import add_preassigned
from torch_parity import assert_topk_equal

D, N, NT, NQ, NLIST, NBIT, K = 32, 2000, 1000, 40, 16, 64, 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(11)
    xt = rs.randint(0, 16, (NT, D)).astype(np.float32)
    xb = rs.randint(0, 16, (N, D)).astype(np.float32)
    xq = rs.randint(0, 16, (NQ, D)).astype(np.float32)
    return xt, xb, xq


def _pair(data, tt, period=10.0):
    """The reference's IndexIVFSpectralHash and the port's over its
    quantizer and projection."""
    xt, xb, _ = data
    j = JIE.IndexIVFSpectralHash(JM.IndexFlat(D), D, NLIST, NBIT, period)
    j.threshold_type = tt
    j.cp.niter = 3
    j.max_list_scan_factor = 0
    j.train(xt)
    j.add(xb)
    q = T.IndexFlat(D, device="cpu")
    q.add(np.asarray(j.quantizer.vectors))
    t = T.IndexIVFSpectralHash(q, D, NLIST, NBIT, period, device="cpu")
    t.threshold_type = tt
    t.quantizer_trains_alone = 1
    t.vt.A, t.vt.is_trained = np.asarray(j.vt.A), True
    t.train(xt)
    t.add(xb)
    j.nprobe = t.nprobe = 4
    return j, t


@pytest.mark.parametrize("tt", ["global", "centroid", "centroid_half",
                                "median"])
def test_spectral_hash_codes_and_search(data, tt):
    xt, xb, xq = data
    j, t = _pair(data, tt, 10.0 if tt != "median" else 40.0)
    np.testing.assert_array_equal(t.trained, j.trained)
    a = np.asarray(j._assign(xb))
    np.testing.assert_array_equal(t._sa_encode_payload(xb, a),
                                  j._sa_encode_payload(xb, a))
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1)
    np.testing.assert_array_equal(t.sa_encode(xb[:5]), j.sa_encode(xb[:5]))
    with pytest.raises(NotImplementedError):
        t.sa_decode(t.sa_encode(xb[:2]))
    assert t.sa_code_size() == j.sa_code_size()


def test_scan_invlists_hash(data):
    """The scan against the reference's on the same lists, thresholds,
    projections and probes, with and without an id mask: the same
    distances, ids up to ties, the same ndis."""
    _, xb, xq = data
    j, t = _pair(data, "centroid")
    zq = xq @ np.asarray(j.vt.A).T
    probes = np.asarray(t.coarse_assign(xq, 4), np.int32)
    il = j.invlists
    mask = np.zeros(N, np.uint8)
    mask[::3] = 1
    for m in (None, mask):
        D0, I0, n0 = JS.scan_invlists_hash(
            jnp.asarray(zq), jnp.asarray(probes), il, jnp.asarray(j.trained),
            j.period, K, nbit=NBIT, max_nblocks=il.max_nblocks_per_list,
            id_mask=None if m is None else jnp.asarray(m))
        D1, I1, n1 = TS.scan_invlists_hash(
            torch.from_numpy(zq), torch.from_numpy(probes.copy()),
            t.invlists,
            torch.from_numpy(t.trained), t.period, K,
            max_nblocks=t.invlists.max_nblocks_per_list,
            id_mask=None if m is None else torch.from_numpy(m))
        assert_topk_equal(np.asarray(D0), np.asarray(I0), D1.numpy(),
                          I1.numpy())
        assert int(n0) == int(n1)


def test_spectral_hash_entry_points(data):
    """search_stats, search_preassigned, search_stats_per_query and a
    max_codes cap all scan the codes; a selector equals a search of the
    kept rows; the carried index equals the reference."""
    xt, xb, xq = data
    j, t = _pair(data, "global")
    D0, I0 = t.search(xq, K)
    D1, I1, st = t.search_stats(xq, K)
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)
    assert st.ndis == int(t.list_sizes[t.coarse_assign(xq, 4)].sum())
    D2, I2 = t.search_preassigned(xq, K, t.coarse_assign(xq, 4))
    np.testing.assert_array_equal(D2, D0)
    np.testing.assert_array_equal(I2, I0)
    D3, I3, _ = t.search_stats_per_query(xq[:5], K)
    np.testing.assert_array_equal(D3, D0[:5])
    capped = t.search(xq, K, params=T.SearchParametersIVF(max_codes=128))
    assert capped[0].shape == (NQ, K)
    sel = T.SearchParametersIVF(sel=T.IDSelectorRange(0, N // 2))
    Ds, Is = t.search(xq, K, params=sel)
    kept = T.IndexIVFSpectralHash(t.quantizer, D, NLIST, NBIT,
                                  device="cpu")
    kept.quantizer_trains_alone = 1
    kept.vt, kept.trained, kept.is_trained = t.vt, t.trained, True
    kept.add(xb[:N // 2])
    kept.nprobe = 4
    Dk, Ik = kept.search(xq, K)
    np.testing.assert_array_equal(Ds, Dk)
    np.testing.assert_array_equal(Is, Ik)
    Dj, Ij = j.search(xq, K, params=JM.SearchParametersIVF(
        sel=JRange(0, N // 2)))
    assert_topk_equal(Dj, Ij, Ds, Is)
    il = j.invlists
    c = T.ivf_spectral_hash_from_reference(
        {"d": D, "metric": T.METRIC_L2, "nlist": NLIST, "ntotal": N,
         "vectors": np.asarray(j.quantizer.vectors),
         "codes": np.asarray(il.codes), "ids": np.asarray(il.ids),
         "list_block_start": np.asarray(il.list_block_start),
         "list_nblocks": np.asarray(il.list_nblocks),
         "ids_flat": np.arange(N), "nbit": NBIT, "period": j.period,
         "threshold_type": j.threshold_type, "trained": j.trained,
         "vt_A": np.asarray(j.vt.A)}, device="cpu")
    c.nprobe = 4
    assert_topk_equal(*j.search(xq, K), *c.search(xq, K))


@pytest.fixture(scope="module")
def jiq(data):
    xt, xb, _ = data
    payload = JM.IndexIVFFlat(JM.IndexFlat(16), 16, NLIST)
    payload.cp.niter = 3
    j = JIE.IndexIVFIndependentQuantizer(JM.IndexFlat(D), payload,
                                         JPCA(D, 16))
    j.train(xt)
    j.add(xb)
    j.nprobe = 4
    payload.max_list_scan_factor = 0
    return j


def test_independent_quantizer(data, jiq):
    """With both quantizers carried across (the raw one and the payload's
    own), the port's training gives the reference's PCA, its adds the
    same lists, its search the same results; the carried index too."""
    xt, xb, xq = data
    q = T.IndexFlat(D, device="cpu")
    q.add(np.asarray(jiq.quantizer.vectors))
    pq = T.IndexFlat(16, device="cpu")
    payload = T.IndexIVFFlat(pq, 16, NLIST, device="cpu")
    t = T.IndexIVFIndependentQuantizer(q, payload,
                                       T.PCAMatrix(D, 16, device="cpu"))
    t.train(xt)
    np.testing.assert_allclose(t.vt.A, np.asarray(jiq.vt.A), atol=1e-6)
    pq.reset()
    pq.add(np.asarray(jiq.index_ivf.quantizer.vectors))
    t.add(xb)
    t.nprobe = 4
    assert t.ntotal == jiq.ntotal == N
    np.testing.assert_array_equal(t.index_ivf.list_sizes,
                                  np.asarray(jiq.index_ivf.list_sizes))
    D0, I0 = jiq.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5, atol=1e-4)
    c = T.ivf_independent_from_reference(q, t.index_ivf, t.vt)
    assert_topk_equal(D0, I0, *c.search(xq, K), rtol=1e-5, atol=1e-4)


def test_add_preassigned(data):
    """Rows added with their lists given land in those lists, unassigned
    by the quantizer; ids default to the next ones."""
    xt, xb, xq = data
    idx = T.make_ivf_flat(D, NLIST, device="cpu")
    idx.cp.niter = 3
    idx.train(xt)
    a = np.arange(100) % NLIST
    add_preassigned(idx, xb[:100], a)
    add_preassigned(idx, xb[100:150], np.zeros(50, np.int64),
                    ids=np.arange(1000, 1050))
    assert idx.ntotal == 150
    np.testing.assert_array_equal(idx.list_of_ids(np.arange(100)), a)
    np.testing.assert_array_equal(idx.list_of_ids(np.arange(1000, 1050)),
                                  np.zeros(50))
    p = T.make_ivf_pq(D, NLIST, 4, 6, device="cpu")
    assert (p.M, p.nbits, p.nlist) == (4, 6, NLIST)
