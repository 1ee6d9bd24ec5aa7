"""QINCo (ops/qinco.py, models/qinco.py) and the Zn-sphere lattice codec
(ops/lattice.py, models/lattice.py) of tpu_ann_torch against the JAX
package's, on the CPU.

QINCo: `QINCo.random` equals `QINCoParams.random` array for array; a state
dict in the exported PyTorch reference's key layout loads as it is; codes
equal on >= 99% of the rows (an f32 near-tie in the greedy argmin may flip
one), decodes within rtol 1e-5; the bit packing byte-equal. The lattice
codecs' codes are byte-equal. Searches equal up to ties (rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.models import lattice as JLM
from tpu_ann.models import qinco as JQM
from tpu_ann.ops import lattice as JL
from tpu_ann.ops import qinco as JQ
from tpu_ann_torch.models import lattice as TLM
from tpu_ann_torch.models import qinco as TQM
from tpu_ann_torch.models.base import SearchParameters
from tpu_ann_torch.models.selectors import IDSelectorRange as TRange
from tpu_ann_torch.ops import lattice as TL
from tpu_ann_torch.ops import qinco as TQ
from tpu_ann_torch.utils.convert import (lattice_from_reference,
                                         qinco_from_reference)
from torch_parity import assert_topk_equal

D, K_, L, M, H, K = 16, 16, 2, 3, 24, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small torch ops on the CPU: one intra-op thread
    keeps them from oversubscribing the cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(4)
    return (rs.randn(1500, D).astype(np.float32),
            rs.randn(40, D).astype(np.float32))


def _ref_state(p):
    """The exported PyTorch reference's state dict of a QINCoParams."""
    st = {"codebook0.weight": np.asarray(p.codebook0)}
    for i, s in enumerate(p.steps):
        st[f"steps.{i}.codebook.weight"] = np.asarray(s.codebook)
        st[f"steps.{i}.MLPconcat.weight"] = np.concatenate(
            [np.asarray(s.w_cb).T, np.asarray(s.w_xh).T], axis=1)
        st[f"steps.{i}.MLPconcat.bias"] = np.asarray(s.b)
        for j in range(s.ffn_w1.shape[0]):
            st[f"steps.{i}.residual_blocks.{j}.linear1.weight"] = \
                np.asarray(s.ffn_w1[j]).T
            st[f"steps.{i}.residual_blocks.{j}.linear2.weight"] = \
                np.asarray(s.ffn_w2[j]).T
    return st


def test_random_weights_equal_reference():
    p = JQ.QINCoParams.random(D, K_, L, M, H, seed=7)
    net = TQ.QINCo.random(D, K_, L, M, H, seed=7)
    st = net.state_dict()
    ref = _ref_state(p)
    assert set(st) == set(ref)
    for key, v in ref.items():
        np.testing.assert_array_equal(st[key].numpy(), v, err_msg=key)


def test_state_dict_round_trip_and_from_arrays():
    p = JQ.QINCoParams.random(D, K_, L, M, H, seed=3)
    ref = _ref_state(p)
    net = TQ.QINCo(D, K_, L, M, H)
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in ref.items()})
    other = TQ.QINCo.from_arrays(ref)
    assert (other.d, other.K, other.L, other.M, other.h) == (D, K_, L, M, H)
    again = TQ.QINCo(D, K_, L, M, H)
    again.load_state_dict(net.state_dict())
    for a, b, c in zip(net.state_dict().values(),
                       other.state_dict().values(),
                       again.state_dict().values()):
        assert torch.equal(a, b) and torch.equal(a, c)
    # the reference's from_arrays reads the same layout
    back = JQ.QINCoParams.from_arrays(ref)
    np.testing.assert_array_equal(np.asarray(back.steps[1].ffn_w2),
                                  np.asarray(p.steps[1].ffn_w2))


def test_encode_decode_pack_match_reference(data):
    xb, _ = data
    p = JQ.QINCoParams.random(D, K_, L, M, H)
    net = TQ.QINCo.random(D, K_, L, M, H)
    j_codes = JQ.encode_chunked(p, xb, chunk=500)
    t_codes = TQ.encode_chunked(net, xb, chunk=700).numpy()
    assert (t_codes == j_codes).all(1).mean() >= 0.99
    dj = np.asarray(JQ.qinco_decode(p, jnp.asarray(j_codes)))
    dt = net.decode(torch.from_numpy(j_codes.astype(np.int64))).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    for nbits in (4, 13, 40):
        codes = np.random.RandomState(nbits).randint(
            0, 1 << min(nbits, 31), size=(50, 5)).astype(np.int64)
        pj = JQ.pack_codes(codes, nbits)
        np.testing.assert_array_equal(TQ.pack_codes(codes, nbits), pj)
        np.testing.assert_array_equal(TQ.unpack_codes(pj, 5, nbits),
                                      JQ.unpack_codes(pj, 5, nbits))
        np.testing.assert_array_equal(
            TQ.unpack_codes_device(torch.from_numpy(pj), 5, nbits).numpy(),
            codes)


def test_index_qinco_search_matches_reference(data):
    xb, xq = data
    j = JQM.IndexQINCo(D, K_, L, M, H)
    t = TQM.IndexQINCo(D, K_, L, M, H, device="cpu")
    Dv, Iv = t.search(xq, K)              # empty: worst value, ids -1
    assert np.isinf(Dv).all() and (Iv == -1).all()
    with pytest.raises(RuntimeError):
        j.search(xq, K)                   # the reference raises
    j.add(xb)
    t.add(xb)
    assert t.sa_code_size() == j.sa_code_size() == 2
    same = (t._codes.numpy() == j._codes).all(1)
    assert same.mean() >= 0.99
    t._codes = torch.from_numpy(j._codes.copy())     # the same codes
    t.decode_block = 400
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5, atol=1e-5)
    Ds, Is = t.search(xq, K, params=SearchParameters(sel=TRange(0, 500)))
    assert ((Is >= 0) & (Is < 500)).all()
    # carried over with its weights and codes
    c = qinco_from_reference(
        {"d": D, "K": K_, "L": L, "M": M, "h": H, "codes": j._codes,
         "codebook0": np.asarray(j.qinco.codebook0),
         "steps": [{n: np.asarray(getattr(s, n)) for n in
                    ("codebook", "w_cb", "w_xh", "b", "ffn_w1", "ffn_w2")}
                   for s in j.qinco.steps]}, device="cpu")
    D2, I2 = c.search(xq, K)
    assert_topk_equal(D0, I0, D2, I2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim,r2", [(8, 10), (4, 6), (3, 5), (16, 4)])
def test_lattice_codes_equal_reference(dim, r2):
    x = np.random.RandomState(dim * r2).randn(400, dim).astype(np.float32)
    j, t = JL.ZnSphereCodec(dim, r2), TL.ZnSphereCodec(dim, r2)
    assert (t.nv, t.nbits) == (j.nv, j.nbits)
    c = t.search(x)
    np.testing.assert_array_equal(c, j.search(x))
    np.testing.assert_array_equal(t.encode(c), j.encode(c))
    ids = np.unique(np.r_[t.encode(c), np.arange(min(t.nv, 300))]).astype(
        np.uint64)
    np.testing.assert_array_equal(t.decode(ids), j.decode(ids))
    if dim & (dim - 1) == 0:
        ja, ta = JL.ZnSphereCodecAlt(dim, r2), TL.ZnSphereCodecAlt(dim, r2)
        np.testing.assert_array_equal(ta.encode(x), ja.encode(x))
        np.testing.assert_array_equal(ta.decode(ja.encode(x)),
                                      ja.decode(ja.encode(x)))


def test_index_lattice_matches_reference(data):
    xb, xq = data
    j = JLM.IndexLattice(D, 2, 4, 10)
    t = TLM.IndexLattice(D, 2, 4, 10, device="cpu")
    j.train(xb)
    t.train(xb)
    np.testing.assert_array_equal(t.trained, j.trained)
    j.add(xb)
    t.add(xb)
    np.testing.assert_array_equal(t._codes.numpy(), j._codes)
    np.testing.assert_allclose(t.reconstruct_n(0, 50), j.reconstruct_n(0, 50),
                               rtol=1e-6)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5, atol=1e-5)
    c = lattice_from_reference({"d": D, "nsq": 2, "scale_nbit": 4, "r2": 10,
                                "trained": j.trained, "codes": j._codes},
                               device="cpu")
    D2, I2 = c.search(xq, K)
    np.testing.assert_array_equal(D2, D1)
    np.testing.assert_array_equal(I2, I1)
