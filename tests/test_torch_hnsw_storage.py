"""Port parity: the HNSW storages of tpu_ann_torch.models.hnsw — IndexHNSWSQ
(bf16 / fp16 / "sq8" tiles), IndexHNSW2Level (Index2Layer codes) and
IndexHNSWPQ (PQ tiles, tpu_ann_torch.ops.hnsw_tiles.build_tiles_pq /
tile_search_pq) — on the CPU, against the JAX package on the same numpy
inputs and the same graph (the reference's, carried over with the
`utils.convert` functions), its Pallas scan in interpret mode.

Tolerances:
- bf16 / fp16 tiles on integer data (values 0..255, exact in both types):
  (D, I) equal up to ties at the cut (rtol 0);
- "sq8" tiles: the codes byte-equal; the dequantized rows are not
  integers, so the exact re-rank's sums may round apart: D within rtol
  1e-5, ids equal outside near-ties;
- 2-level: the codes and decodes equal; the bf16 decoded rows are floats:
  rtol 1e-5 as "sq8";
- PQ tiles: the layout byte-equal; integer codebooks and queries make
  every ADC table entry and sum exact: (D, I) equal (rtol 0); a PQ index
  over float codebooks: rtol 1e-5;
- the per-node route over bf16 rows: the reference rounds the rows' norms
  to bf16 (`jnp.sum` of bf16 products), the port keeps them in f32 (the
  exact distance to the stored rows): ids overlap >= 0.95, the port's D
  equal to an f32 recomputation (rtol 1e-5)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from tpu_ann.models import hnsw as JM
from tpu_ann.ops import distances as JD
from tpu_ann.ops import hnsw_tiles as JT
from tpu_ann.ops import pq as JPQ
from tpu_ann_torch.ops import hnsw_tiles as HT
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

L2, IP = JD.METRIC_L2, JD.METRIC_INNER_PRODUCT
CPU = torch.device("cpu")
K = 10


@pytest.fixture(scope="module")
def ints():
    x = sift_surrogate(2660, seed=12, **SIFT1M_CALIBRATED)[:, :32].copy()
    return x[:2600], x[2600:]


def _assign(xb):
    cents = xb[::40]
    d = ((xb[:, None, :] - cents[None]) ** 2).sum(-1)
    return np.argmin(d, axis=1).astype(np.int64)


def _graph_state(j, xb=None):
    g = j.graph
    st = dict(d=j.d, metric=j.metric_type, M=j.hnsw.M,
              efSearch=j.hnsw.efSearch, neighbors0=np.array(g.neighbors0),
              upper_ids=np.array(g.upper_ids),
              upper_neighbors=np.array(g.upper_neighbors),
              levels=np.array(g.levels), entry=int(g.entry),
              max_level=g.max_level, coarse_assign=j._coarse_assign)
    if xb is not None:
        st["xb"] = xb
    return st


@pytest.fixture
def interpret(monkeypatch):
    """The reference's fused tiles run their Pallas scan in interpret
    mode (its tests' way on the CPU)."""
    monkeypatch.setattr(JT, "tile_search_fused", functools.partial(
        JT.tile_search_fused, interpret=True))


def _fused_mode(*indexes, threshold=1000):
    for idx in indexes:
        idx.hnsw.tile_threshold = threshold
        idx.hnsw.tile_mode = "fused"


_SQ = {}


def _sq_pair(xb, qtype, metric):
    """A JAX IndexHNSWSQ built on xb (coarse assignment set) and the port's
    over the same graph and storage rows."""
    key = (qtype, metric)
    if key not in _SQ:
        j = JM.IndexHNSWSQ(32, qtype, 8, metric)
        j.add(xb)
        j._coarse_assign = _assign(xb)
        st = _graph_state(j, np.asarray(j.storage.vectors))
        t = T.hnsw_sq_from_reference(dict(st, qtype=qtype), device=CPU)
        _SQ[key] = (j, t)
    return _SQ[key]


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("qtype", ["bfloat16", "float16", "sq8"])
def test_hnsw_sq_fused_equal(ints, interpret, qtype, metric):
    xb, xq = ints
    j, t = _sq_pair(xb, qtype, metric)
    _fused_mode(j, t)
    for ef in (16, 64):
        D0, I0 = j.search(xq, K, params=JM.SearchParametersHNSW(efSearch=ef))
        D1, I1 = t.search(xq, K, params=T.SearchParametersHNSW(efSearch=ef))
        assert_topk_equal(D0, I0, D1, I1,
                          rtol=1e-5 if qtype == "sq8" else 0.0)
    il = t._tiles_fused.il
    if qtype == "sq8":
        # the uint8 tiles alone: no f32 / bf16 copy of the stream, and
        # the raw storage dropped
        assert isinstance(il, T.PackedInvListsSQ8)
        assert not hasattr(il, "data") and t.storage.ntotal == 0
        np.testing.assert_array_equal(il.codes.numpy(),
                                      np.asarray(j._tiles_fused.il.data))
        for key in (0, 77, 2599):
            np.testing.assert_array_equal(t.reconstruct(key),
                                          j.reconstruct(key))
        np.testing.assert_array_equal(t.reconstruct_n(0, 2600),
                                      j._sq8_rows())
    else:
        assert il.data.dtype == getattr(torch, qtype)
        assert il.data_bf16.dtype == torch.bfloat16
        np.testing.assert_array_equal(il.norms.numpy(),
                                      np.asarray(j._tiles_fused.il.norms))


def test_hnsw_sq8_add_after_drop(ints, interpret):
    """An add after the "sq8" tiles dropped the raw rows rebuilds over the
    old rows dequantized, in both packages: the storage rows equal, the
    graphs' link sets >= 99% equal, the searches within rtol 1e-5."""
    xb, xq = ints
    j = JM.IndexHNSWSQ(32, "sq8", 8)
    j.add(xb[:2000])
    j._coarse_assign = _assign(xb[:2000])
    t = T.hnsw_sq_from_reference(
        dict(_graph_state(j, np.asarray(j.storage.vectors)), qtype="sq8"),
        device=CPU)
    _fused_mode(j, t)
    j.search(xq, K)
    t.search(xq, K)
    assert t._storage_dropped() and j._storage_dropped()
    j.add(xb[2000:])                  # 600 > 0.5 * 2000 after the restore
    t.add(xb[2000:])
    assert t.ntotal == j.ntotal == 2600 and t.storage.ntotal == 2600
    np.testing.assert_array_equal(t.storage.vectors.numpy(),
                                  np.asarray(j.storage.vectors))
    same = np.mean([set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(
        t.graph.neighbors0.numpy(), np.asarray(j.graph.neighbors0))])
    assert same >= 0.99


@pytest.mark.parametrize("qtype", ["bfloat16", "float16"])
def test_hnsw_sq_per_node_route(ints, qtype):
    """Below tile_threshold: the per-node beam over the rows at the
    storage type (see the module docstring for the norms). The port's D
    are the exact distances to the stored rows. On fp16 rows of this data
    the reference's fp16 norms overflow (above 65504: inf, every distance
    inf), so there the port is held to recall@10 against exact search over
    the stored rows, at least the reference's."""
    xb, xq = ints
    j, t = _sq_pair(xb, qtype, L2)
    for idx in (j, t):
        idx.hnsw.tile_threshold = 10 ** 6
    _, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    rows = torch.from_numpy(xb).to(getattr(torch, qtype)).float().numpy()
    exact = ((rows[I1] - xq[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(D1, exact, rtol=1e-5)
    if qtype == "bfloat16":
        ov = np.mean([len(set(a) & set(b)) / K for a, b in zip(I0, I1)])
        assert ov >= 0.95
    else:
        assert (rows ** 2).sum(1).max() > 65504
        _, gt = T.knn(torch.from_numpy(xq), torch.from_numpy(rows), K)
        gt = gt.numpy()
        assert T.recall_k_at_k(I1, gt, K) >= max(
            T.recall_k_at_k(np.asarray(I0), gt, K), 0.9)


def test_factory_builds_one_graph_for_every_storage(ints):
    """The factory's HNSW16 storages build the same graph over the same
    rows (the chip check sets one graph by hand on the others)."""
    xb, _ = ints
    graphs = []
    for spec in ("HNSW16", "HNSW16,SQ8", "HNSW16,SQbf16", "HNSW16,SQfp16"):
        idx = T.index_factory(32, spec, device=CPU)
        idx.add(xb)
        graphs.append(idx.graph)
    for g in graphs[1:]:
        for name in ("neighbors0", "upper_ids", "upper_neighbors", "levels"):
            assert torch.equal(getattr(g, name), getattr(graphs[0], name))
        assert (g.entry, g.max_level) == (graphs[0].entry,
                                          graphs[0].max_level)


# -- IndexHNSW2Level -----------------------------------------------------------

@pytest.fixture(scope="module")
def two_level(ints):
    xb, _ = ints
    j = JM.IndexHNSW2Level(32, 16, 8, 8)
    j.train(xb)
    j.add(xb)
    j._coarse_assign = _assign(xb)
    c = j.codec
    st = _graph_state(j, np.asarray(j.storage.vectors))
    st.update(nlist=c.nlist, pq_m=c.M, nbits=c.nbits,
              q1_vectors=np.asarray(c.q1.vectors),
              pq_centroids=np.asarray(c.pq.centroids),
              list_ids=np.concatenate(c._list_ids),
              codes=np.concatenate(c._codes))
    return j, T.hnsw_2level_from_reference(st, device=CPU)


def test_hnsw_2level_codec_equal(ints, two_level):
    xb, xq = ints
    j, t = two_level
    codes = t.sa_encode(xb)
    assert codes.shape == (len(xb), 4 + 8)
    np.testing.assert_array_equal(codes, j.sa_encode(xb))
    dec = t.sa_decode(codes)
    np.testing.assert_array_equal(dec, j.sa_decode(codes))
    # the graph was built on the rows the codes decode to
    np.testing.assert_array_equal(t.storage.vectors.numpy(), dec)
    D0, I0 = j.codec.search(xq, K)
    D1, I1 = t.codec.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


def test_hnsw_2level_fused_equal(ints, two_level, interpret):
    _, xq = ints
    j, t = two_level
    _fused_mode(j, t)
    for ef in (16, 64):
        D0, I0 = j.search(xq, K, params=JM.SearchParametersHNSW(efSearch=ef))
        D1, I1 = t.search(xq, K, params=T.SearchParametersHNSW(efSearch=ef))
        assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    assert t._tiles_fused.il.data.dtype == torch.bfloat16


def test_index2layer_to_ivfpq(ints, two_level):
    """Index2Layer.to_ivfpq: an IndexIVFPQ over the same quantizer and
    codebook holding the decoded rows; its exhaustive search (nprobe =
    nlist) returns the codec's own results."""
    xb, xq = ints
    _, t = two_level
    ivf = t.codec.to_ivfpq()
    assert ivf.ntotal == len(xb) and ivf.nlist == 16
    _, I0 = t.codec.search(xq, K)
    _, I1 = ivf.search(xq, K, params=T.SearchParametersIVF(nprobe=16))
    ov = np.mean([len(set(a) & set(b)) / K for a, b in zip(I0, I1)])
    assert ov >= 0.95


# -- PQ tiles and IndexHNSWPQ ----------------------------------------------------

@pytest.fixture(scope="module")
def pq_tiles(ints):
    """Integer-rounded PQ codebooks (8 sub-quantizers, 8 bits) and the
    codes of the base, the reference's graph, and both packages' PQ tile
    layouts in one spatial order."""
    xb, _ = ints
    codec = JPQ.train_pq(xb, 8, 8)
    cents = np.round(np.asarray(codec.centroids)).astype(np.float32)
    codes = np.asarray(JPQ.pq_encode(jnp.asarray(xb), jnp.asarray(cents)))
    out = {}
    for metric in (L2, IP):
        jg = JM.H.build_graph_knn(jnp.asarray(xb), 8, 40, metric=metric)[0]
        nbr = np.array(jg.neighbors0)
        order = HT.spatial_order(xb, 128, assign=_assign(xb), device=CPU)
        out[metric] = (
            JT.build_tiles_pq(xb, codes, cents, nbr, order=order, b=128),
            HT.build_tiles_pq(xb, codes, cents, nbr, order=order, b=128,
                              device=CPU))
    return out


def test_build_tiles_pq_equal(pq_tiles):
    jt, tt = pq_tiles[L2]
    assert (tt.b, tt.n) == (jt.b, jt.n)
    assert tt.il.nlist == jt.il.nlist          # T + 1: the empty target
    for name in ("codes", "ids", "list_block_start", "list_nblocks"):
        np.testing.assert_array_equal(getattr(tt.il, name).numpy(),
                                      np.asarray(getattr(jt.il, name)), name)
    for name in ("cent", "nbr_pos", "orig_ids", "pq_centroids"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("kw", [dict(nprobe0=4, hops=1, F=4),
                                dict(nprobe0=3, hops=2, F=2, rk=24),
                                dict(nprobe0=5, hops=0)])
def test_tile_search_pq_equal(ints, pq_tiles, metric, kw):
    _, xq = ints
    jt, tt = pq_tiles[metric]
    D0, _, I0 = JT.tile_search_pq(jt, jnp.asarray(xq), K, metric=metric,
                                  **kw)
    D1, P1, I1 = HT.tile_search_pq(tt, torch.from_numpy(xq), K,
                                   metric=metric, **kw)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1.numpy(), I1.numpy())
    np.testing.assert_array_equal(
        I1.numpy(), np.where(P1.numpy() >= 0,
                             tt.orig_ids.numpy()[np.maximum(P1.numpy(), 0)],
                             -1))


@pytest.fixture(scope="module")
def hnsw_pq(ints):
    xb, _ = ints
    j = JM.IndexHNSWPQ(32, 8, 8)
    j.train(xb)
    j.add(xb)                           # 2600 rows < 4096: no tiles yet
    st = _graph_state(j)
    st.update(pq_m=8, nbits=8, codes=np.asarray(j._codes),
              pq_centroids=np.asarray(j.pq.centroids))
    return j, T.hnsw_pq_from_reference(st, device=CPU)


def test_hnsw_pq_per_node_route(ints, hnsw_pq):
    """Below the PQ threshold both decode every code and run the per-node
    beam over the decoded rows."""
    _, xq = ints
    j, t = hnsw_pq
    for key in (0, 1234):
        np.testing.assert_array_equal(t.reconstruct(key), j.reconstruct(key))
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


def test_hnsw_pq_tiles_route(ints, hnsw_pq):
    """Above the threshold over the same PQ tiles (one spatial order and
    the reference's tile centroids set on both): (D, I) within rtol 1e-5;
    the returned D are the ADC distances of the returned ids."""
    _, xq = ints
    j, t = hnsw_pq
    dec = np.asarray(JPQ.pq_decode(jnp.asarray(j._codes),
                                   jnp.asarray(j.pq.centroids)))
    order = HT.spatial_order(dec, 128, assign=_assign(dec), device=CPU)
    j._ptiles = JT.build_tiles_pq(dec, np.asarray(j._codes),
                                  j.pq.centroids,
                                  np.asarray(j.graph.neighbors0),
                                  order=order, b=128)
    t._tile_layout = (order, np.asarray(j._ptiles.cent))
    for idx in (j, t):
        idx.hnsw.tile_threshold = 1000
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
    assert t._ptiles is not None and t.storage.ntotal == 0
    np.testing.assert_allclose(D1, ((dec[I1] - xq[:, None]) ** 2).sum(-1),
                               rtol=1e-4)


def test_hnsw_pq_own_build(ints):
    """The port's IndexHNSWPQ trained and built on its own above the
    threshold: the raw rows dropped, pq_m bytes a vector of codes, an
    add after the drop rebuilds over the decoded rows, and recall@10 within
    0.03 of exact ADC search over the codes."""
    xb, xq = ints
    t = T.IndexHNSWPQ(32, 8, 8, device=CPU)
    t.hnsw.tile_threshold = 2000
    t.train(xb)
    t.add(xb[:2200])
    assert t._ptiles is not None and t.storage.ntotal == 0
    assert t._codes.shape == (2200, 8) and t._codes.dtype == torch.uint8
    t.add(xb[2200:])
    assert t.ntotal == 2600 and t._codes.shape == (2600, 8)
    dec = torch.from_numpy(t.reconstruct_n(0, 2600))
    _, gt = T.knn(torch.from_numpy(xq), torch.from_numpy(xb), K)
    _, Ia = T.knn(torch.from_numpy(xq), dec, K)
    _, I = t.search(xq, K, params=T.SearchParametersHNSW(efSearch=64))
    ra = T.recall_k_at_k(Ia.numpy(), gt.numpy(), K)
    assert T.recall_k_at_k(I, gt.numpy(), K) >= ra - 0.03
