"""The binary indexes of tpu_ann_torch (models/binary.py) against the JAX
package's, on the CPU.

Data: 2000 random codes of 64 bits (a numpy seed), 50 queries. Hamming
distances tie everywhere, so results are compared tie-aware: distances bit
for bit, ids as a set at each distance below the k-th, and at the k-th
only ids whose Hamming distance is the k-th (either package may keep any
of them). The reference's IVF quantizer and HNSW graph are carried across
(`utils.convert`), so both search the same structures."""

import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from tpu_ann.models import binary as JB
from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.utils import factory as JF
from tpu_ann_torch.ops import hamming as H
from tpu_ann_torch.utils import factory as TF

D, N, NQ, K = 64, 2000, 50, 10
LUT = np.array([bin(i).count("1") for i in range(256)], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(7)
    xb = rs.randint(0, 256, size=(N, D // 8)).astype(np.uint8)
    xq = rs.randint(0, 256, size=(NQ, D // 8)).astype(np.uint8)
    return xb, xq


def oracle(xq, xb):
    return LUT[np.bitwise_xor(xq[:, None, :], xb[None, :, :])].sum(-1)


def assert_binary_equal(D0, I0, D1, I1, xq, xb):
    """Distances bit for bit; ids as a set at each distance below a row's
    k-th, and ids at the k-th distance that truly lie at it."""
    np.testing.assert_array_equal(D1, D0)
    assert D1.dtype == np.int32 and I1.dtype == np.int64
    for r in range(len(D0)):
        kth = D0[r][-1]
        for v in np.unique(D0[r]):
            a, b = I0[r][D0[r] == v], I1[r][D1[r] == v]
            if v == 32767:
                assert (b == -1).all()
            elif v < kth:
                assert sorted(a) == sorted(b), (r, v, a, b)
            else:
                assert len(set(b)) == len(b)
                assert (oracle(xq[r:r + 1], xb[b])[0] == v).all()


def assert_range_equal(r0, r1):
    """(lims, D, I) equal as a set of (id, distance) hits a query."""
    np.testing.assert_array_equal(r1[0], r0[0])
    assert r1[1].dtype == np.int32
    for q in range(len(r0[0]) - 1):
        s = slice(r0[0][q], r0[0][q + 1])
        assert sorted(zip(r0[2][s], r0[1][s])) == \
            sorted(zip(r1[2][s], r1[1][s]))


def test_popcount_routes(data):
    xb, xq = data
    t = torch.from_numpy
    want = oracle(xq, xb)
    np.testing.assert_array_equal(
        H.hamming_rows(t(xq)[:, None, :], t(xb)[None]).numpy(), want)
    np.testing.assert_array_equal(
        H.hamming_distances(t(xq), t(xb)).numpy(), want)
    x = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    np.testing.assert_array_equal(H.popcount_u8(x).numpy(), LUT)


def test_flat(data):
    """Search, range search (dis < radius) and remove_ids (the survivors
    renumbered in order) as the reference."""
    xb, xq = data
    j = JB.IndexBinaryFlat(D)
    t = T.IndexBinaryFlat(D, device="cpu")
    for idx in (j, t):
        idx.add(xb[:1000])
        idx.add(xb[1000:])
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_binary_equal(D0, I0, D1, I1, xq, xb)
    assert_range_equal(j.range_search(xq, 24), t.range_search(xq, 24))
    np.testing.assert_array_equal(t.reconstruct(17), xb[17])
    rm = np.arange(0, N, 3)
    assert j.remove_ids(rm) == t.remove_ids(rm) == len(rm)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_binary_equal(D0, I0, D1, I1, xq, np.delete(xb, rm, 0))
    np.testing.assert_array_equal(t.reconstruct(1), xb[2])
    t.reset()
    D2, I2 = t.search(xq, 3)
    assert (D2 == 32767).all() and (I2 == -1).all()


@pytest.fixture(scope="module")
def jivf(data):
    xb, _ = data
    j = JB.IndexBinaryIVF(None, D, 16)
    j.cp.niter = 3
    j.train(xb)
    j.add(xb)
    return j


def _carried_ivf(j, xb):
    q = T.binary_flat_from_reference(
        {"d": D, "codes": np.asarray(j.quantizer._codes)}, device="cpu")
    return T.binary_ivf_from_reference(
        {"d": D, "nlist": 16, "nprobe": j.nprobe, "codes": xb,
         "ids": np.arange(N)}, q, device="cpu")


@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_ivf_carried_quantizer(data, jivf, nprobe):
    """With the reference's binary centroids carried across, the same
    lists, the same search and range search at every nprobe."""
    xb, xq = data
    t = _carried_ivf(jivf, xb)
    jivf.nprobe = t.nprobe = nprobe
    D0, I0 = jivf.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_binary_equal(D0, I0, D1, I1, xq, xb)
    assert_range_equal(jivf.range_search(xq, 26), t.range_search(xq, 26))
    t._ready()
    np.testing.assert_array_equal(t.invlists.ids.numpy(),
                                  np.asarray(jivf.invlists.ids))


def test_ivf_pads_to_k(data, jivf):
    """k above the probed slots: the port returns (nq, k), its empty slots
    (32767, -1); the reference returns fewer columns (binary.py:255)."""
    xb, xq = data
    t = _carried_ivf(jivf, xb)
    jivf.nprobe = t.nprobe = 1
    k = 1000
    D0, I0 = jivf.search(xq, k)
    D1, I1 = t.search(xq, k)
    assert D1.shape == I1.shape == (NQ, k)
    assert D0.shape[1] < k
    full = D1 < 32767
    assert (I1[~full] == -1).all()
    np.testing.assert_array_equal(np.sort(D1, 1)[:, :D0.shape[1]],
                                  np.sort(D0, 1))
    assert (full.sum(1) <= D0.shape[1]).all()
    # a -1 probe (a graph quantizer that found fewer lists) reads nothing
    q = t.quantizer
    q.search_device = lambda x, n: (None, torch.full((len(x), n), -1))
    D2, I2 = t.search(xq, K)
    assert (D2 == 32767).all() and (I2 == -1).all()
    assert t.range_search(xq, 64)[0][-1] == 0


def test_ivf_train_and_hnsw_quantizer(data):
    """The port's own training (float k-means of the bits, centroids by
    majority): at nprobe = nlist the search is exact. An HNSW quantizer
    over the same centroids finds lists at the same distances (the same
    lists up to ties), and at nprobe = nlist the same results."""
    xb, xq = data
    t = T.IndexBinaryIVF(None, D, 16, device="cpu")
    t.cp.niter = 3
    t.train(xb)
    t.add(xb)
    t.nprobe = 16
    flat = T.IndexBinaryFlat(D, device="cpu")
    flat.add(xb)
    np.testing.assert_array_equal(t.search(xq, K)[0], flat.search(xq, K)[0])
    h = T.IndexBinaryIVF(T.IndexBinaryHNSW(D, 8, device="cpu"), D, 16,
                         device="cpu")
    h.quantizer.add(t.quantizer.codes)
    h.is_trained = True
    h.add(xb)
    h.nprobe = t.nprobe = 4
    np.testing.assert_array_equal(h.quantizer.search(xq, 4)[0],
                                  t.quantizer.search(xq, 4)[0])
    h.nprobe = 16
    np.testing.assert_array_equal(h.search(xq, K)[0], flat.search(xq, K)[0])


def test_from_float(data):
    xb, xq = data
    j = JB.IndexBinaryFromFloat(JFlat(D))
    t = T.IndexBinaryFromFloat(T.IndexFlat(D, device="cpu"))
    j.add(xb)
    t.add(xb)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_binary_equal(D0, I0, D1, I1, xq, xb)
    c = T.binary_from_float_from_reference(t.index)
    np.testing.assert_array_equal(c.search(xq, K)[0], D0)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("nflip", [0, 1, 2])
def test_hash(data, multi, nflip):
    """Bucket candidates as the reference's dicts: the same distances,
    range hits and table size; a carried index (the codes) equal."""
    xb, xq = data
    if multi:
        j = JB.IndexBinaryMultiHash(D, 3, 8)
        t = T.IndexBinaryMultiHash(D, 3, 8, device="cpu")
    else:
        j = JB.IndexBinaryHash(D, 8)
        t = T.IndexBinaryHash(D, 8, device="cpu")
    for idx in (j, t):
        idx.nflip = nflip
        idx.add(xb[:1200])
        idx.add(xb[1200:])
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_binary_equal(D0, I0, D1, I1, xq, xb)
    assert_range_equal(j.range_search(xq, 27), t.range_search(xq, 27))
    if multi:
        assert t.hashtable_size() == j.hashtable_size()
        st = {"d": D, "b": 8, "nflip": nflip, "nhash": 3, "codes": xb}
    else:
        st = {"d": D, "b": 8, "nflip": nflip, "codes": xb}
    c = T.binary_hash_from_reference(st, device="cpu")
    np.testing.assert_array_equal(c.search(xq, K)[0], D0)
    cand = [T.models.binary._hash_flips(8, f) for f in (0, 1, 2)]
    assert len(cand[nflip]) == [1, 9, 37][nflip]


def test_hash_candidates_chunked(data, monkeypatch):
    """A small candidate budget splits the queries into many chunks and
    changes nothing."""
    xb, xq = data
    t = T.IndexBinaryMultiHash(D, 2, 8, device="cpu")
    t.nflip = 2
    t.add(xb)
    want = t.search(xq, K)
    monkeypatch.setattr(T.models.binary, "CAND_BUDGET", 500)
    got = t.search(xq, K)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def jhnsw(data):
    xb, _ = data
    j = JB.IndexBinaryHNSW(D, 8)
    j.add(xb[:600])
    return j


def test_hnsw_carried_graph(data, jhnsw):
    """IndexBinaryHNSW on the reference's graph (its IndexHNSWSQ's arrays
    carried across) searches as the reference, and reconstructs the
    codes."""
    xb, xq = data
    g = jhnsw.index.graph
    state = {"d": D, "codes": xb[:600], "hnsw": {
        "d": D, "metric": jhnsw.index.metric_type, "M": jhnsw.hnsw.M,
        "efSearch": jhnsw.hnsw.efSearch,
        "xb": np.asarray(jhnsw.index.storage.vectors, np.float32),
        "neighbors0": np.asarray(g.neighbors0),
        "upper_ids": np.asarray(g.upper_ids),
        "upper_neighbors": np.asarray(g.upper_neighbors),
        "levels": np.asarray(g.levels), "entry": int(g.entry),
        "max_level": int(g.max_level)}}
    t = T.binary_hnsw_from_reference(state, device="cpu")
    t.hnsw.efSearch = jhnsw.hnsw.efSearch = 32
    D0, I0 = jhnsw.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_binary_equal(D0, I0, D1, I1, xq, xb[:600])
    np.testing.assert_array_equal(t.reconstruct(123), xb[123])
    own = T.IndexBinaryHNSW(D, 8, device="cpu")
    own.add(xb[:600])
    assert own.search(xq, 1)[0].dtype == np.int32


@pytest.mark.parametrize("spec", ["BFlat", "BIVF16", "BIVF16_HNSW8",
                                  "BHNSW8", "BHash8", "BHash3x8"])
def test_binary_factory(spec):
    j = JF.index_binary_factory(D, spec)
    t = TF.index_binary_factory(D, spec, device="cpu")
    assert type(t).__name__ == type(j).__name__
    for name in ("d", "nlist", "b"):
        assert getattr(t, name, None) == getattr(j, name, None)
    if spec == "BHash3x8":
        assert t.nhash == j.nhash == 3
    if hasattr(j, "quantizer"):
        assert type(t.quantizer).__name__ == type(j.quantizer).__name__
    if hasattr(j, "hnsw"):
        assert t.hnsw.M == j.hnsw.M
    with pytest.raises(ValueError):
        TF.index_binary_factory(D, spec + "x")
