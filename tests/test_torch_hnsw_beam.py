"""Port parity: the tile beam of tpu_ann_torch.ops.hnsw_tiles (TileGraph,
build_tiles, tile_search), the index routes that take it, the fused tiles
above K3's 32 rows a (query, tile), and IndexHNSW.range_search, on the CPU,
against the JAX package on the same numpy inputs and the same graph (the
reference's, carried over), its Pallas scan in interpret mode.

Tolerances:
- build_tiles: every array byte-equal (the bf16 tiles as bit patterns);
- integer data (the SIFT surrogate, values 0..255): every bf16 product,
  norm and re-score is exact on both sides and every sort stable, so (D, I)
  are equal up to ties at the cut (`torch_parity.assert_topk_equal`), and
  a range search's CSR triple is equal;
- float data: the products sum in another order: ids overlap >= 0.99."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from tpu_ann.models.hnsw import IndexHNSWFlat as JHNSW
from tpu_ann.models.hnsw import SearchParametersHNSW as JParams
from tpu_ann.ops import distances as JD
from tpu_ann.ops import hnsw as JH
from tpu_ann.ops import hnsw_tiles as JT
from tpu_ann_torch.ops import hnsw_tiles as HT
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

L2, IP = JD.METRIC_L2, JD.METRIC_INNER_PRODUCT
CPU = torch.device("cpu")
B = 32


@pytest.fixture(scope="module")
def ints():
    x = sift_surrogate(2660, seed=12, **SIFT1M_CALIBRATED)[:, :32].copy()
    return x[:2600], x[2600:]                        # n % B != 0


@pytest.fixture(scope="module")
def floats():
    rs = np.random.RandomState(3)
    cent = rs.randn(20, 32).astype(np.float32) * 2
    xb = cent[rs.randint(0, 20, 2600)] + rs.randn(2600, 32)
    xq = cent[rs.randint(0, 20, 60)] + rs.randn(60, 32)
    return xb.astype(np.float32), xq.astype(np.float32)


def _assign(xb):
    """A coarse assignment both packages order their tiles by."""
    cents = xb[::40]
    d = ((xb[:, None, :] - cents[None]) ** 2).sum(-1)
    return np.argmin(d, axis=1).astype(np.int64)


_GRAPHS = {}


def _graph(xb, metric, m=8):
    key = (id(xb), metric, m)
    if key not in _GRAPHS:
        jg, _ = JH.build_graph_knn(jnp.asarray(xb), m, 40,
                                   levels=JH.random_levels(len(xb), m, 1234),
                                   metric=metric)
        _GRAPHS[key] = jg
    return _GRAPHS[key]


def _tiles(xb, metric):
    jg = _graph(xb, metric)
    nbr = np.array(jg.neighbors0)
    order = JT.spatial_order(xb, B, assign=_assign(xb))
    return (JT.build_tiles(xb, nbr, order=order, b=B),
            HT.build_tiles(xb, nbr, order=order, b=B, device=CPU))


def test_build_tiles_equal(ints):
    xb, _ = ints
    jt, tt = _tiles(xb, L2)
    assert (tt.n, tt.ntiles, tt.b) == (jt.n, jt.ntiles, jt.b)
    np.testing.assert_array_equal(
        tt.vtiles.view(torch.int16).numpy(),
        np.asarray(jt.vtiles).view(np.int16))
    for name in ("vnorms", "nbr_pos", "cent", "orig_ids"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    assert tt.device_bytes() == jt.hbm_bytes()


def _search_both(jt, tt, xq, metric, refine, xb, **kw):
    D0, I0, s0 = JT.tile_search(
        jt, jnp.asarray(xq), 10, metric=metric,
        refine_vectors=jnp.asarray(xb) if refine else None, **kw)
    D1, I1, s1 = HT.tile_search(
        tt, torch.from_numpy(xq), 10, metric=metric,
        refine_vectors=torch.from_numpy(xb) if refine else None, **kw)
    return (np.asarray(D0), np.asarray(I0), D1.numpy(), I1.numpy(), s0, s1)


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("kw", [dict(ef=32), dict(ef=16, expand=2),
                                dict(ef=48, expand=4, scan_tiles=3,
                                     seed_count=4, stop_frac=0.0)])
def test_tile_search_equal_on_integer_data(ints, metric, refine, kw):
    xb, xq = ints
    jt, tt = _tiles(xb, metric)
    D0, I0, D1, I1, s0, s1 = _search_both(jt, tt, xq, metric, refine, xb,
                                          **kw)
    assert_topk_equal(D0, I0, D1, I1)
    assert int(s1["ndis"]) == int(s0["ndis"])
    assert int(s1["nhops"]) == int(s0["nhops"])


@pytest.mark.parametrize("metric", [L2, IP])
def test_tile_search_on_float_data(floats, metric):
    xb, xq = floats
    jt, tt = _tiles(xb, metric)
    _, I0, _, I1, _, _ = _search_both(jt, tt, xq, metric, True, xb, ef=32)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(I0, I1)])
    assert overlap >= 0.99


@pytest.mark.parametrize("check_every", [1, 7, 10**9])
def test_tile_beam_stop_test_changes_nothing(ints, check_every,
                                             monkeypatch):
    """A loop that tests done.all() every hop, every few hops, or never
    (max_hops hops, no host sync) returns the same as the default's."""
    xb, xq = ints
    _, tt = _tiles(xb, L2)
    q = torch.from_numpy(xq)
    D0, I0, _ = HT.tile_search(tt, q, 10, ef=32)
    monkeypatch.setattr(HT, "CHECK_EVERY", check_every)
    D1, I1, _ = HT.tile_search(tt, q, 10, ef=32)
    np.testing.assert_array_equal(D0.numpy(), D1.numpy())
    np.testing.assert_array_equal(I0.numpy(), I1.numpy())


def _carry(j, xb):
    """A port IndexHNSWFlat over the JAX index's graph and coarse
    assignment."""
    g = j.graph
    return T.hnsw_from_reference(dict(
        d=j.d, metric=j.metric_type, M=j.hnsw.M, xb=xb,
        efSearch=j.hnsw.efSearch, neighbors0=np.array(g.neighbors0),
        upper_ids=np.array(g.upper_ids),
        upper_neighbors=np.array(g.upper_neighbors),
        levels=np.array(g.levels), entry=int(g.entry),
        max_level=g.max_level, coarse_assign=j._coarse_assign),
        device=CPU)


@pytest.fixture(scope="module")
def indexes(ints):
    """Per metric, a JAX IndexHNSWFlat (M 8) over the integer base with a
    coarse assignment set, and the port's over the same graph."""
    xb, _ = ints
    out = {}
    for metric in (L2, IP):
        j = JHNSW(32, 8, metric)
        j.add(xb)
        j._coarse_assign = _assign(xb)
        out[metric] = (j, _carry(j, xb))
    return out


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("ef", [16, 48])
def test_index_beam_route_equal(ints, indexes, metric, ef):
    """tile_mode "beam" above tile_threshold (the reference's CPU route):
    (D, I) equal; for IP "auto" takes the same beam."""
    _, xq = ints
    j, t = indexes[metric]
    p = T.SearchParametersHNSW(efSearch=ef)
    for idx in (j, t):
        idx.hnsw.tile_threshold = 1000
        idx.hnsw.tile_mode = "beam"
    D0, I0 = j.search(xq, 10, params=JParams(efSearch=ef))
    D1, I1 = t.search(xq, 10, params=p)
    assert_topk_equal(D0, I0, D1, I1)
    assert "beam_tiles" in t.build_seconds
    if metric == IP:
        t.hnsw.tile_mode = "auto"
        D2, I2 = t.search(xq, 10, params=p)
        np.testing.assert_array_equal(D1, D2)
        np.testing.assert_array_equal(I1, I2)


def test_index_beam_entry_tiles(ints, indexes, monkeypatch):
    """The index's tile beam starts from max(2 expand_tiles, 8, efSearch /
    2) entry tiles, at most the tile count (the reference's rule is
    max(2 expand_tiles, 8): the same up to efSearch 16); tile_seeds set
    is taken as it is."""
    _, xq = ints
    _, t = indexes[L2]
    t.hnsw.tile_threshold = 1000
    t.hnsw.tile_mode = "beam"
    seen = []
    search = HT.tile_search

    def spy(*args, **kw):
        seen.append(kw["seed_count"])
        return search(*args, **kw)

    monkeypatch.setattr(HT, "tile_search", spy)
    ntiles = t._ensure_tiles().ntiles
    for ef in (16, 48, 64, 4 * ntiles):
        t.search(xq, 10, params=T.SearchParametersHNSW(efSearch=ef))
    t.hnsw.tile_seeds = 5
    t.search(xq, 10, params=T.SearchParametersHNSW(efSearch=64))
    t.hnsw.tile_seeds = 0
    assert seen == [8, 24, 32, ntiles, 5]


@pytest.mark.parametrize("route", ["beam_l2", "beam_ip", "node_l2",
                                   "node_ip"])
def test_range_search_equal(ints, indexes, route):
    """IndexHNSW.range_search at the median 5th-NN distance (similarity
    for IP) over the same graph: the CSR triple equal to the reference's,
    on the per-node route and on the tile beam; every hit inside the
    radius."""
    xb, xq = ints
    metric = IP if route.endswith("ip") else L2
    j, t = indexes[metric]
    for idx in (j, t):
        idx.hnsw.tile_threshold = 1000 if route.startswith("beam") else 10**6
        idx.hnsw.tile_mode = "beam"
    Dk, _ = JD.knn(jnp.asarray(xq), jnp.asarray(xb), 5, metric)
    radius = float(np.median(np.asarray(Dk)[:, 4]))
    l0, d0, i0 = j.range_search(xq, radius)
    l1, d1, i1 = t.range_search(xq, radius)
    assert l1[-1] > len(xq)
    np.testing.assert_array_equal(l1, np.asarray(l0))
    np.testing.assert_array_equal(i1, np.asarray(i0))
    np.testing.assert_array_equal(d1, np.asarray(d0))
    assert ((d1 > radius) if metric == IP else (d1 < radius)).all()


@pytest.fixture(scope="module")
def fused(ints):
    """The fused tile layouts (b 128) of both packages over the integer
    base."""
    xb, _ = ints
    jg = _graph(xb, L2)
    nbr = np.array(jg.neighbors0)
    order = HT.spatial_order(xb, 128, assign=_assign(xb), device=CPU)
    return (JT.build_tiles_fused(xb, nbr, order=order, b=128),
            HT.build_tiles_fused(xb, nbr, order=order, b=128, device=CPU))


@pytest.mark.parametrize("kw", [dict(k=100, kp=64, nprobe0=3, hops=1, F=2,
                                     rk=200),
                                dict(k=80, kp=40, nprobe0=4, hops=2, F=2,
                                     rk=160)])
def test_tile_search_fused_above_32_rows_equal(ints, fused, kw):
    """The repair: at kp above K3's 32 rows a (query, tile) every scan
    keeps the tile's exact top-kp, the reference's (its kernel's own kp).
    With k above kp a query's nearest tile holds more than kp of its top-k:
    the former 32-row sub-tiles kept a superset and returned them."""
    _, xq = ints
    jt, tt = fused
    k = kw.pop("k")
    D0, _, I0 = JT.tile_search_fused(jt, jnp.asarray(xq), k, interpret=True,
                                     **kw)
    D1, _, I1 = HT.tile_search_fused(tt, torch.from_numpy(xq), k, **kw)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1.numpy(),
                      I1.numpy())


def test_index_wide_k_fused_equal(ints, indexes, monkeypatch):
    """IndexHNSWFlat's fused route at k 100 (kp = min(b, k, 64)) over the
    same graph and tiles: (D, I) equal to the reference's fused route (its
    Pallas scan in interpret mode)."""
    monkeypatch.setattr(JT, "tile_search_fused", functools.partial(
        JT.tile_search_fused, interpret=True))
    _, xq = ints
    j, t = indexes[L2]
    for idx in (j, t):
        idx.hnsw.tile_threshold = 1000
        idx.hnsw.tile_mode = "fused"
        idx._tiles_fused = None
    D0, I0 = j.search(xq, 100)                # kp = min(128, k, 64)
    D1, I1 = t.search(xq, 100)
    assert_topk_equal(D0, I0, D1, I1)
