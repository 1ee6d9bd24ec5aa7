"""Port parity: wave insertion in tpu_ann_torch.ops.hnsw (the diversity
heuristic, reverse links, one wave, build_graph, extend_graph) and the
index's insert build and incremental add, on the CPU, against the JAX
package on the same numpy inputs.

Tolerances:
- integer data (the SIFT surrogate cut to 32 dims, values 0..255): every
  distance is exact in f32 on both sides and every sort is stable, so the
  level-0 tables, the upper tables of wave insertion, the seeds and the
  levels are EQUAL, entry for entry (what holds, tried for);
  `extend_graph` relinks the upper levels with the batch kNN build, whose
  link sets agree on >= 99% of rows (as tests/test_torch_hnsw.py holds
  build_graph_knn);
- float data: both packages sum their products in another order, so a
  near-tie can flip a link, and every later wave sees the flip: link sets
  equal on >= 99% of rows, levels equal, recall@10 within 0.01."""

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
from tpu_ann_torch.models.hnsw import IndexHNSWFlat as THNSW
from tpu_ann_torch.ops import hnsw as H
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

L2, IP = JD.METRIC_L2, JD.METRIC_INNER_PRODUCT
CPU = torch.device("cpu")
WAVE = 256


def _rows_equal(a, b):
    return float(np.mean([set(x[x >= 0]) == set(y[y >= 0])
                          for x, y in zip(np.asarray(a), np.asarray(b))]))


def _recall(I, gt):
    return float(np.mean([len(set(a) & set(b)) / len(b)
                          for a, b in zip(np.asarray(I), gt)]))


def _port_graph(jg):
    return H.HNSWGraph(
        neighbors0=torch.from_numpy(np.array(jg.neighbors0)),
        upper_ids=torch.from_numpy(np.array(jg.upper_ids)),
        upper_neighbors=torch.from_numpy(np.array(jg.upper_neighbors)),
        levels=torch.from_numpy(np.array(jg.levels)),
        entry=int(jg.entry), max_level=jg.max_level)


@pytest.fixture(scope="module")
def ints():
    x = sift_surrogate(2100, seed=3, **SIFT1M_CALIBRATED)[:, :32].copy()
    return x[:2000], x[2000:]


@pytest.fixture(scope="module")
def floats():
    rs = np.random.RandomState(21)
    cent = rs.randn(30, 32).astype(np.float32) * 3
    x = cent[rs.randint(0, 30, 2100)] + rs.randn(2100, 32).astype(np.float32)
    return x[:2000].astype(np.float32), x[2000:].astype(np.float32)


@pytest.fixture(scope="module")
def wave_inputs(ints):
    """A wave of 200 points over a kNN graph of the other 1800 rows, and
    its beam's candidates (the reference's inputs to the heuristic)."""
    xb, _ = ints
    out = {}
    for metric in (L2, IP):
        jg, _ = JH.build_graph_knn(jnp.asarray(xb[:1800]), 8, 40,
                                   metric=metric)
        nb0 = np.concatenate([np.array(jg.neighbors0),
                              np.full((200, 16), -1, np.int32)])
        wave = np.arange(1800, 2000)
        entry = np.full((200, 1), int(jg.entry), np.int32)
        cd, ci, _ = JH.beam_search_level0(
            jnp.asarray(xb), jnp.asarray(nb0), jnp.asarray(xb[wave]),
            jnp.asarray(entry), ef=40, k=40, metric=metric, raw=True)
        out[metric] = (nb0, wave, entry, np.asarray(cd), np.asarray(ci))
    return out


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [8, 16])
def test_select_neighbors_heuristic_on_scan_inputs(ints, wave_inputs, metric,
                                                   dtype, m):
    """The port's heuristic on the reference's `lax.scan` inputs (a wave's
    beam candidates, rows in f32 or bf16): equal kept ids and
    distances."""
    xb, _ = ints
    _, _, _, cd, ci = wave_inputs[metric]
    jv = jnp.asarray(xb).astype(dtype)
    tv = torch.from_numpy(xb).to(getattr(torch, dtype))
    j_ids, j_dis = JH._select_neighbors_heuristic(
        None, jnp.asarray(ci), jnp.asarray(cd), jv, m, metric,
        return_dis=True)
    t_ids, t_dis = H.select_neighbors_heuristic(
        torch.from_numpy(ci.copy()), torch.from_numpy(cd.copy()), tv, m,
        metric)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_dis.numpy(), np.asarray(j_dis))


@pytest.mark.parametrize("metric", [L2, IP])
def test_apply_reverse_links_equal(ints, wave_inputs, metric):
    xb, _ = ints
    nb0, wave, _, cd, ci = wave_inputs[metric]
    fwd = np.asarray(JH._select_neighbors_heuristic(
        None, jnp.asarray(ci), jnp.asarray(cd), jnp.asarray(xb), 16, metric))
    nb = nb0.copy()
    nb[wave] = fwd
    j = JH._apply_reverse_links(jnp.asarray(xb), jnp.asarray(nb),
                                jnp.asarray(fwd), jnp.asarray(wave), metric)
    t = H.apply_reverse_links(torch.from_numpy(xb),
                              torch.from_numpy(nb.copy()),
                              torch.from_numpy(fwd), torch.from_numpy(wave),
                              metric)
    assert (np.asarray(j) != nb).any()                # links were added
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("metric", [L2, IP])
def test_insert_wave_level_equal(ints, wave_inputs, metric):
    xb, _ = ints
    nb0, wave, entry, _, _ = wave_inputs[metric]
    jn, js = JH._insert_wave_level(
        jnp.asarray(xb), jnp.asarray(nb0), jnp.asarray(xb[wave]),
        jnp.asarray(wave), jnp.asarray(entry), jnp.int32(len(xb)),
        m_fwd=16, ef_construction=40, metric=metric)
    tn, ts = H.insert_wave_level(
        torch.from_numpy(xb), torch.from_numpy(nb0.copy()),
        torch.from_numpy(xb[wave]), torch.from_numpy(wave),
        torch.from_numpy(entry), m_fwd=16, ef_construction=40,
        metric=metric)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _build_both(x, m, metric):
    levels = JH.random_levels(len(x), m, 1234)
    jg = JH.build_graph(jnp.asarray(x), m, 40, levels=levels,
                        wave_size=WAVE, metric=metric)
    tg = H.build_graph(x, m, 40, levels=levels, wave_size=WAVE,
                       metric=metric, device=CPU)
    return jg, tg


@pytest.mark.parametrize("metric", [L2, IP])
def test_build_graph_equal_on_integer_data(ints, metric):
    xb, _ = ints
    jg, tg = _build_both(xb, 8, metric)
    assert tg.entry == int(jg.entry) and tg.max_level == jg.max_level
    np.testing.assert_array_equal(tg.levels.numpy(), np.asarray(jg.levels))
    np.testing.assert_array_equal(tg.upper_ids.numpy(),
                                  np.asarray(jg.upper_ids))
    np.testing.assert_array_equal(tg.neighbors0.numpy(),
                                  np.asarray(jg.neighbors0))
    np.testing.assert_array_equal(tg.upper_neighbors.numpy(),
                                  np.asarray(jg.upper_neighbors))


def test_build_graph_on_float_data(floats):
    xb, xq = floats
    jg, tg = _build_both(xb, 8, L2)
    np.testing.assert_array_equal(tg.levels.numpy(), np.asarray(jg.levels))
    assert _rows_equal(tg.neighbors0.numpy(), jg.neighbors0) >= 0.99
    ju, tu = np.asarray(jg.upper_neighbors), tg.upper_neighbors.numpy()
    for lev in range(ju.shape[1]):
        assert _rows_equal(tu[:, lev], ju[:, lev]) >= 0.99
    _, gt = JD.knn(jnp.asarray(xq), jnp.asarray(xb), 10)
    gt = np.asarray(gt)
    _, I0, _ = JH.hnsw_search(jnp.asarray(xb), jg, jnp.asarray(xq), ef=32,
                              k=10)
    _, I1, _ = H.hnsw_search(torch.from_numpy(xb), tg, torch.from_numpy(xq),
                             ef=32, k=10)
    assert abs(_recall(I1, gt) - _recall(I0, gt)) <= 0.01


@pytest.mark.parametrize("data,exact", [("ints", True), ("floats", False)])
def test_extend_graph(request, data, exact):
    """Rows 1600..1999 wave-inserted into a kNN graph of the first 1600
    (the reference's graph, carried over): level 0 equal on integer data,
    link sets >= 99% on float data; the upper levels (relinked by the kNN
    build) >= 99%; levels and entry equal."""
    xb, _ = request.getfixturevalue(data)
    n0 = 1600
    jg, _ = JH.build_graph_knn(jnp.asarray(xb[:n0]), 8, 40,
                               levels=JH.random_levels(n0, 8, 1234))
    je = JH.extend_graph(jnp.asarray(xb), jg, n0, m=8, ef_construction=40,
                         wave_size=WAVE)
    te = H.extend_graph(xb, _port_graph(jg), n0, m=8, ef_construction=40,
                        wave_size=WAVE, device=CPU)
    np.testing.assert_array_equal(te.levels.numpy(), np.asarray(je.levels))
    assert te.entry == int(je.entry) and te.max_level == je.max_level
    if exact:
        np.testing.assert_array_equal(te.neighbors0.numpy(),
                                      np.asarray(je.neighbors0))
    else:
        assert _rows_equal(te.neighbors0.numpy(), je.neighbors0) >= 0.99
    ju, tu = np.asarray(je.upper_neighbors), te.upper_neighbors.numpy()
    assert tu.shape == ju.shape
    for lev in range(ju.shape[1]):
        assert _rows_equal(tu[:, lev], ju[:, lev]) >= 0.99


@pytest.mark.parametrize("data,exact", [("ints", True), ("floats", False)])
def test_index_insert_build_and_incremental_add(request, data, exact):
    """IndexHNSWFlat with build_mode="insert", 1500 rows, then an add of
    500 (at most incremental_frac): the first build by waves, the add by
    extend_graph, in both packages. Level 0 equal (integer data) or link
    sets >= 99% (float data), levels equal, recall@10 within 0.01."""
    xb, xq = request.getfixturevalue(data)
    j, t = JHNSW(32, 8), THNSW(32, 8, device=CPU)
    for idx in (j, t):
        idx.hnsw.build_mode = "insert"
        idx.hnsw.wave_size = WAVE
        idx.add(xb[:1500])
    assert "graph" in t.build_seconds
    if exact:
        np.testing.assert_array_equal(t.graph.neighbors0.numpy(),
                                      np.asarray(j.graph.neighbors0))
    for idx in (j, t):
        idx.add(xb[1500:])                    # 500 <= 0.5 * 1500: extend
    assert "extend" in t.build_seconds
    assert t.ntotal == t._built_n == len(xb) == j._built_n
    np.testing.assert_array_equal(t.graph.levels.numpy(),
                                  np.asarray(j.graph.levels))
    share = _rows_equal(t.graph.neighbors0.numpy(), j.graph.neighbors0)
    assert share == 1.0 if exact else share >= 0.99
    _, gt = JD.knn(jnp.asarray(xq), jnp.asarray(xb), 10)
    gt = np.asarray(gt)
    _, I0 = j.search(xq, 10)
    _, I1 = t.search(xq, 10)
    assert abs(_recall(I1, gt) - _recall(I0, gt)) <= 0.01


def test_incremental_add_extends_the_coarse_assignment(floats):
    """After extend_graph the port carries the build's coarse assignment
    (the tiles' spatial order) to the added rows: each joins the cell
    whose mean of built rows is nearest, and the tile order runs cell by
    cell, each cell's rows by their distance to that mean (the reference
    drops the assignment; see `IndexHNSW._extended_cells`). Checked
    against numpy: distances in float64, equal within rtol 1e-5 where the
    two orders differ."""
    xb, _ = floats
    t = THNSW(32, 8, device=CPU)
    t.add(xb[:1500])
    cells = np.arange(1500) % 37
    t._coarse_assign = cells.copy()
    t.add(xb[1500:])
    assert "extend" in t.build_seconds and len(t._coarse_assign) == 2000
    np.testing.assert_array_equal(t._coarse_assign[:1500], cells)
    means = np.stack([xb[:1500][cells == c].mean(0) for c in range(37)])
    d = ((xb[1500:, None, :] - means[None]) ** 2).sum(-1)
    want = np.argmin(d, axis=1)
    got = t._coarse_assign[1500:]
    # nearest by f32 distances; a near-tie may go either way
    best = d[np.arange(len(d)), want]
    assert np.mean(got == want) >= 0.99
    assert np.allclose(d[np.arange(len(d)), got], best, rtol=1e-4)
    order = t._tile_order
    assert sorted(order) == list(range(2000))
    ca = t._coarse_assign
    dist = ((xb.astype(np.float64) - means[ca]) ** 2).sum(1)
    assert (np.diff(ca[order]) >= 0).all()
    same = np.diff(ca[order]) == 0
    step = np.diff(dist[order])[same]
    assert (step >= -1e-5 * dist[order][1:][same]).all()


@pytest.mark.parametrize("metric", [L2, IP])
def test_fused_route_after_extend(ints, metric, monkeypatch):
    """The fused tiles after an incremental add. The reference's graph
    (1500 rows, a coarse assignment set) is carried to the port and both
    add 500 rows (extend_graph): level 0 equal. The reference drops the
    assignment, so its tiles take `spatial_order`'s k-means order; the
    port, its assignment and tile order set to None, searches equal to
    it, (D, I) bit for
    bit at efSearch 16 / 64 (the reference's Pallas scan in interpret
    mode). With the cells it carries and their order
    (`IndexHNSW._extended_cells`) the port lays its tiles out in that
    order instead, not the k-means one; here its recall@10 stays within
    0.01 of the reference's (at 1M rows it gains 0.08: chip_smoke.py
    phase 17g)."""
    monkeypatch.setattr(JT, "tile_search_fused", functools.partial(
        JT.tile_search_fused, interpret=True))
    xb, xq = ints
    j = JHNSW(32, 8, metric)
    j.add(xb[:1500])
    cents = xb[:1500:40]
    j._coarse_assign = np.argmin(
        ((xb[:1500, None] - cents[None]) ** 2).sum(-1), 1).astype(np.int64)
    g = j.graph
    t = T.hnsw_from_reference(dict(
        d=32, metric=metric, M=8, xb=xb[:1500],
        neighbors0=np.array(g.neighbors0), upper_ids=np.array(g.upper_ids),
        upper_neighbors=np.array(g.upper_neighbors),
        levels=np.array(g.levels), entry=int(g.entry),
        max_level=g.max_level, coarse_assign=j._coarse_assign), device=CPU)
    for idx in (j, t):
        idx.add(xb[1500:])                    # 500 <= 0.5 * 1500: extend
        idx.hnsw.tile_threshold = 1000
        idx.hnsw.tile_mode = "fused"
    assert "extend" in t.build_seconds and j._coarse_assign is None
    np.testing.assert_array_equal(t.graph.neighbors0.numpy(),
                                  np.asarray(j.graph.neighbors0))
    carried, carried_order = t._coarse_assign, t._tile_order
    assert len(carried) == len(carried_order) == len(xb)
    _, gt = JD.knn(jnp.asarray(xq), jnp.asarray(xb), 10, metric)
    gt = np.asarray(gt)
    for ef in (16, 64):
        D0, I0 = j.search(xq, 10, params=JParams(efSearch=ef))
        t._coarse_assign = t._tile_order = t._tiles_fused = None
        D1, I1 = t.search(xq, 10, params=T.SearchParametersHNSW(efSearch=ef))
        assert_topk_equal(D0, I0, D1, I1)
        kmeans_order = t._tiles_fused.orig_ids[:len(xb)].numpy()
        t._coarse_assign, t._tile_order = carried, carried_order
        t._tiles_fused = None
        _, I2 = t.search(xq, 10, params=T.SearchParametersHNSW(efSearch=ef))
        order = t._tiles_fused.orig_ids[:len(xb)].numpy()
        np.testing.assert_array_equal(order, carried_order)
        assert not np.array_equal(order, kmeans_order)
        assert _recall(I2, gt) >= _recall(I0, gt) - 0.01
