"""NN-descent, the NSG prune and the graph indexes of tpu_ann_torch
(ops/nndescent.py, models/nsg.py) against the JAX package's, on the CPU.

Data: integer-valued rows (0..15, d 16-32, a numpy seed), where every f32
distance is an exact integer, so one iteration with the reference's
reverse-edge slots, the prune and the beam are bit-equal to the
reference's; ids are compared up to ties. The reference's graphs are
carried across (`utils.convert`). A whole NN-descent run draws its slots
from torch, which cannot follow jax.random: its graph's recall is held to
the reference's less 0.02."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from tpu_ann.models import nsg as JN
from tpu_ann.ops import nndescent as JND
from tpu_ann.ops import sq as JSQ
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import nndescent as TND
from torch_parity import assert_topk_equal

N, D, K = 1500, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    x = rs.randint(0, 16, (N, D)).astype(np.float32)
    xq = rs.randint(0, 16, (40, D)).astype(np.float32)
    return x, xq


def _init_dist(x, g):
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    iv = xj[gj.reshape(-1)].reshape(len(x), -1, x.shape[1])
    return np.array(jnp.sum(xj * xj, 1)[:, None] + jnp.sum(iv * iv, 2)
                    - 2.0 * jnp.einsum("nd,nkd->nk", xj, iv))


def test_initial_graph_equal():
    rs = np.random.RandomState(1234)
    init = rs.randint(0, N, size=(N, K)).astype(np.int32)
    init = np.where(init == np.arange(N)[:, None], (init + 1) % N, init)
    np.testing.assert_array_equal(TND.initial_graph(N, K, 1234), init)


@pytest.mark.parametrize("budget", [1 << 14, 1 << 28])
def test_one_iteration_bit_equal(data, budget):
    """With the reference's reverse-edge slots, one iteration gives its
    graph, distances and update count bit for bit (in row chunks of any
    size), the last writer of a (row, slot) winning as in its scatter."""
    x, _ = data
    g = TND.initial_graph(N, K, 1234)
    gd = _init_dist(x, g)
    key = jax.random.PRNGKey(3)
    g1, d1, u1 = JND._nnd_iter(jnp.asarray(x), jnp.asarray(g),
                               jnp.asarray(gd), key, K)
    slot = torch.from_numpy(np.array(jax.random.randint(key, (N, K), 0,
                                                          K)))
    g2, d2, u2 = TND.nnd_iter(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(gd), slot, K, budget=budget)
    np.testing.assert_array_equal(g2.numpy(), np.asarray(g1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
    assert int(u2) == int(u1)


def test_nn_descent_recall(data):
    """After 4 iterations the graph's recall against the exact K-NN graph
    is at least the reference's less 0.02; its distances are its ids'."""
    x, _ = data
    xt = torch.from_numpy(x)
    gT, dT = TND.nn_descent(xt, K, iters=4)
    gJ, _ = JND.nn_descent(jnp.asarray(x), K, iters=4)
    _, ex = TD.knn(xt, xt, K + 1)
    ex = ex[:, 1:].numpy()

    def recall(g):
        g = np.asarray(g)
        return np.mean([len(np.intersect1d(g[i], ex[i])) / K
                        for i in range(N)])

    assert recall(gT) >= recall(gJ) - 0.02
    want = ((x[:, None, :] - x[gT.numpy()]) ** 2).sum(2)
    np.testing.assert_array_equal(dT.numpy(), want)


@pytest.fixture(scope="module")
def ref_graph(data):
    x, _ = data
    return JND.nn_descent(jnp.asarray(x), 2 * K, iters=3)


def test_build_nsg_carried_graph(data, ref_graph):
    """Over the reference's k-NN graph the prune keeps its adjacency, and
    the medoid is its, bit for bit; the reachable share is the share of
    rows a BFS from the medoid meets."""
    x, _ = data
    g, dist = ref_graph
    adj0, med0 = JND.build_nsg(jnp.asarray(x), g, dist, K)
    adj1, med1 = TND.build_nsg(torch.from_numpy(x),
                               torch.from_numpy(np.asarray(g)),
                               torch.from_numpy(np.asarray(dist)), K)
    np.testing.assert_array_equal(adj1.numpy(), np.asarray(adj0))
    assert med1 == int(med0)
    share = TND.reachable_share(adj1, med1)
    seen, front = {med1}, [med1]
    a = adj1.numpy()
    while front:
        nxt = {int(v) for u in front for v in a[u] if v >= 0} - seen
        seen |= nxt
        front = list(nxt)
    assert share == pytest.approx(len(seen) / N)


@pytest.fixture(scope="module")
def ref_indexes(data):
    """The reference's four graph indexes over the same rows (built
    once)."""
    x, _ = data
    rs = np.random.RandomState(2)
    xt = rs.randint(0, 16, (800, D)).astype(np.float32)
    out = {}
    for name, idx in (("flat", JN.IndexNSGFlat(D, R=K)),
                      ("nnd", JN.IndexNNDescentFlat(D, K=K)),
                      ("pq", JN.IndexNSGPQ(D, 4, R=K, nbits=6)),
                      ("sq", JN.IndexNSGSQ(D, JSQ.QT_8BIT, R=K))):
        idx.nnd_iters = 2
        if not idx.is_trained:
            idx.train(xt)
        idx.add(x)
        idx.efSearch = 24
        out[name] = idx
    return out


def _state(j):
    st = {"d": D, "R": getattr(j, "R", 0), "GK": getattr(j, "GK", 0),
          "efSearch": j.efSearch, "medoid": getattr(j, "medoid", 0),
          "graph": np.asarray(j.graph)}
    if isinstance(j, JN.IndexNSGPQ):
        st.update(codes=j._codes, pq_m=j.pq_m, nbits=j.nbits,
                  centroids=np.asarray(j.pq.centroids))
    elif isinstance(j, JN.IndexNSGSQ):
        st.update(codes=j._codes, qtype=j.qtype, vmin=j.sq.vmin,
                  vdiff=j.sq.vdiff)
    else:
        st["xb"] = np.asarray(j.storage.vectors)
    return st


@pytest.mark.parametrize("name", ["flat", "nnd", "pq", "sq"])
def test_indexes_on_carried_graph(data, ref_indexes, name):
    """Each graph index, carried across (graph, entry, storage), searches
    as the reference's: distances within rtol 1e-5 (exact on the integer
    rows), ids equal up to ties; efSearch from params; search in query
    chunks changes nothing."""
    x, xq = data
    j = ref_indexes[name]
    if name == "nnd":
        t = T.nnd_from_reference({"d": D, "K": K, "efSearch": j.efSearch,
                                  "xb": x, "graph": np.asarray(j.graph)},
                                 device="cpu")
    else:
        t = T.nsg_from_reference(_state(j), device="cpu")
    D0, I0 = j.search(xq, 10)
    D1, I1 = t.search(xq, 10)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    p = T.SearchParametersHNSW(efSearch=48)
    D2, I2 = j.search(xq, 10, params=p)
    t.search_chunk = 7
    D3, I3 = t.search(xq, 10, params=p)
    assert_topk_equal(D2, I2, D3, I3, rtol=1e-5)
    if name in ("pq", "sq"):
        np.testing.assert_allclose(t.reconstruct(5), j.reconstruct(5),
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", ["pq", "sq"])
def test_coded_equals_flat_over_decoded(data, kind):
    """A coded NSG equals an IndexNSGFlat built over its decoded rows, bit
    for bit; its sa_encode / sa_decode round trip is the decode."""
    x, xq = data
    if kind == "pq":
        idx = T.IndexNSGPQ(D, 4, R=K, nbits=6, device="cpu")
    else:
        idx = T.IndexNSGSQ(D, T.QT_8BIT, R=K, device="cpu")
    idx.nnd_iters = 2
    idx.train(x)
    idx.add(x[:1000])
    idx.add(x[1000:])
    twin = T.IndexNSGFlat(D, R=K, device="cpu")
    twin.nnd_iters = 2
    twin.add(idx.storage.vectors.numpy())
    a, b = idx.search(xq, 10), twin.search(xq, 10)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(idx.sa_decode(idx.sa_encode(x[:5])),
                                  idx.storage.vectors[:5].numpy())


def test_nsg_build_keeps_knn_graph(data):
    x, xq = data
    idx = T.index_factory(D, "NSG8", device="cpu")
    idx.nnd_iters = 2
    knn_g = idx.build(x)
    assert knn_g.shape == (N, idx.GK)
    assert idx.graph.shape == (N, 8)
    assert set(idx.build_seconds) == {"nn_descent", "prune"}
    _, I = idx.search(x[:20], 1)
    assert (I[:, 0] == np.arange(20)).mean() >= 0.8
