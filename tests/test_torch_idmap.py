"""Port parity: tpu_ann_torch.models.idmap (IndexIDMap / IndexIDMap2 /
IndexShards / IndexReplicas), merge_topk_axis and the selectors of
IndexPQ / IndexScalarQuantizer against the JAX package, on the CPU.

On integer rows every distance is exact in both packages, so results are
compared bit for bit (ids up to ties where the tie sits at the cut). Each
fault of the reference has a test that names its line and checks the
port against exact search or faiss's contract:
- IndexIDMap hands its selector to the sub-index untranslated
  (tpu_ann/models/idmap.py:52-54);
- IndexIDMap over an IVF compacts its id map on removal while the IVF
  keeps its ids (:62-84);
- IndexShards keeps one id base a shard, overwritten by the last add
  (:176, 187), where the port numbers rows in the order of the adds;
- IndexPQ and IndexScalarQuantizer ignore params.sel
  (tpu_ann/models/pq.py:183, 312)."""

import numpy as np
import pytest
import torch

import tpu_ann_torch as T
from torch_parity import assert_topk_equal
from tpu_ann.models import idmap as JM
from tpu_ann.models import selectors as JS
from tpu_ann.models.base import SearchParameters as JParams
from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import IndexIVFFlat as JIVF
from tpu_ann.ops import topk as JTK
from tpu_ann_torch.models import idmap as TM
from tpu_ann_torch.utils import convert

D, NLIST, K = 16, 8, 10


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(21)
    xb = rs.randint(0, 40, size=(2000, D)).astype(np.float32)
    xq = rs.randint(0, 40, size=(40, D)).astype(np.float32)
    cent = xb[rs.choice(len(xb), NLIST, replace=False)]
    return xb, xq, cent


def _ivf(cent, pkg="torch"):
    if pkg == "jax":
        q = JFlat(D)
        q.add(cent)
        idx = JIVF(q, D, NLIST)
        idx.max_list_scan_factor = 0
    else:
        q = T.IndexFlat(D, device="cpu")
        q.add(cent)
        idx = T.IndexIVFFlat(q, D, NLIST, device="cpu")
    idx.quantizer_trains_alone = 1
    idx.train(cent)
    idx.nprobe = NLIST
    return idx


@pytest.mark.parametrize("cls", ["IndexIDMap", "IndexIDMap2"])
@pytest.mark.parametrize("sub", ["flat", "ivf"])
def test_idmap_search_equals_reference(cls, sub, data):
    xb, xq, cent = data
    ids = (np.arange(len(xb), dtype=np.int64) * 7 + (1 << 33))
    j = getattr(JM, cls)(JFlat(D) if sub == "flat" else _ivf(cent, "jax"))
    t = getattr(TM, cls)(T.IndexFlat(D, device="cpu") if sub == "flat"
                         else _ivf(cent))
    for idx in (j, t):
        idx.add_with_ids(xb[:1200], ids[:1200])
        idx.add_with_ids(xb[1200:], ids[1200:])
    assert t.ntotal == j.ntotal == len(xb)
    np.testing.assert_array_equal(t.id_map, np.asarray(j.id_map))
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1)
    if sub == "flat":
        # the reference's index carried over
        c = convert.idmap_from_reference(
            {"id_map": j.id_map, "idmap2": cls == "IndexIDMap2"},
            convert.flat_from_reference(j.index.state_dict(), device="cpu"))
        assert type(c).__name__ == cls
        D2, I2 = c.search(xq, K)
        np.testing.assert_array_equal(D2, D1)
        np.testing.assert_array_equal(I2, I1)
    lims0, Dr0, Ir0 = j.range_search(xq, float(np.median(D1[:, 5])))
    lims1, Dr1, Ir1 = t.range_search(xq, float(np.median(D1[:, 5])))
    np.testing.assert_array_equal(lims1, np.asarray(lims0))
    for q in range(len(xq)):
        s0 = slice(lims0[q], lims0[q + 1])
        assert sorted(zip(np.asarray(Dr0)[s0], np.asarray(Ir0)[s0])) == \
            sorted(zip(Dr1[s0], Ir1[s0]))
    with pytest.raises(RuntimeError):
        t.add(xb[:5])
    if cls == "IndexIDMap2":
        np.testing.assert_array_equal(t.reconstruct(int(ids[77])), xb[77])
        np.testing.assert_array_equal(t.reconstruct(int(ids[77])),
                                      j.reconstruct(int(ids[77])))
        with pytest.raises(KeyError):
            t.reconstruct(5)
    else:
        with pytest.raises(RuntimeError):
            t.reconstruct(int(ids[0]))
    t.reset()
    assert t.ntotal == 0 and len(t.id_map) == 0


@pytest.mark.parametrize("sub", ["flat", "ivf"])
def test_idmap_selector_by_external_id(sub, data):
    """IDSelectorRange(1000, 1100) over external ids 1000..1399: the port
    returns exact search over those 100 rows; the reference returns only
    -1 (idmap.py:52-54 tests the selector against internal rows)."""
    xb, xq, cent = data
    xs = xb[:400]
    ids = np.arange(1000, 1400, dtype=np.int64)
    t = TM.IndexIDMap(T.IndexFlat(D, device="cpu") if sub == "flat"
                      else _ivf(cent))
    t.add_with_ids(xs, ids)
    params = (T.SearchParameters if sub == "flat"
              else T.SearchParametersIVF)(sel=T.IDSelectorRange(1000, 1100))
    D1, I1 = t.search(xq, K, params=params)
    ref = T.IndexFlat(D, device="cpu")
    ref.add(xs[:100])
    D2, I2 = ref.search(xq, K)
    np.testing.assert_array_equal(D1, D2)
    assert_topk_equal(D2, I2 + 1000, D1, I1)
    # the range search keeps only selected external ids too
    lims, _, Ir = t.range_search(xq, float(D2[:, -1].max()),
                                 params=params)
    assert len(Ir) and ((Ir >= 1000) & (Ir < 1100)).all()
    if sub == "flat":
        j = JM.IndexIDMap(JFlat(D))
        j.add_with_ids(xs, ids)
        _, I0 = j.search(xq, K, params=JParams(sel=JS.IDSelectorRange(
            1000, 1100)))
        assert (np.asarray(I0) == -1).all()           # the reference's fault


def test_idmap_over_ivf_remove_then_search(data):
    """Remove external ids 5000..5499 from an IDMap over IVF, then search
    the rows whose ids are 6000..6009 for themselves: the port returns
    6000..6009 and equals a fresh IDMap over the survivors; the reference
    returns 6500..6509 (idmap.py:62-84 compacts id_map, the IVF keeps its
    ids)."""
    xb, _, cent = data
    ids = np.arange(5000, 5000 + len(xb), dtype=np.int64)
    t, j = TM.IndexIDMap2(_ivf(cent)), JM.IndexIDMap(_ivf(cent, "jax"))
    for idx in (t, j):
        idx.add_with_ids(xb, ids)
        assert idx.remove_ids(T.IDSelectorRange(5000, 5500) if idx is t
                              else JS.IDSelectorRange(5000, 5500)) == 500
    probe = xb[1000:1010]
    _, I1 = t.search(probe, 1)
    np.testing.assert_array_equal(I1[:, 0], np.arange(6000, 6010))
    _, I0 = j.search(probe, 1)
    np.testing.assert_array_equal(np.asarray(I0)[:, 0],
                                  np.arange(6500, 6510))   # the fault
    fresh = TM.IndexIDMap2(_ivf(cent))
    fresh.add_with_ids(xb[500:], ids[500:])
    D1, I1 = t.search(xb[::50], K)
    D2, I2 = fresh.search(xb[::50], K)
    assert_topk_equal(D2, I2, D1, I1)
    # a later add gets fresh internal ids: no row maps to another's id
    t.add_with_ids(xb[:300], np.arange(90000, 90300))
    assert t.ntotal == len(xb) - 200
    _, I3 = t.search(xb[:300], 1)
    np.testing.assert_array_equal(I3[:, 0], np.arange(90000, 90300))
    np.testing.assert_array_equal(t.reconstruct(6003), xb[1003])
    with pytest.raises(KeyError):
        t.reconstruct(5003)
    # removing a removed id again is a no-op
    assert t.remove_ids(T.IDSelectorRange(5000, 5500)) == 0


@pytest.mark.parametrize("sub", ["flat", "pq", "sq", "pretransform_ivf"])
def test_idmap_remove_by_kind(sub, data):
    """Stable-renumbering sub-indexes (IndexFlat, IndexPQ,
    IndexScalarQuantizer) are compacted with the id map; an IVF under an
    IndexPreTransform keeps its ids; the survivors search as a fresh
    IDMap over them."""
    xb, xq, cent = data
    ids = np.random.RandomState(4).permutation(len(xb)) * 1000003 \
        + (1 << 40)

    def make():
        if sub == "flat":
            return T.IndexFlat(D, device="cpu")
        if sub == "pq":
            idx = T.IndexPQ(D, 4, 4, device="cpu")
        elif sub == "sq":
            idx = T.IndexScalarQuantizer(D, T.QT_8BIT_DIRECT, device="cpu")
        else:
            idx = T.IndexPreTransform(
                T.RandomRotationMatrix(D, D, device="cpu"), _ivf(cent))
            idx.chain[0].train()
            idx.index.quantizer.reset()
            idx.index.quantizer.add(idx.chain[0].apply(cent))
        idx.train(xb)
        return idx

    t = TM.IndexIDMap(make())
    t.add_with_ids(xb, ids)
    gone = ids[::3]
    assert t.remove_ids(T.IDSelectorBatch(gone)) == len(gone)
    assert t.ntotal == len(xb) - len(gone)
    keep = np.ones(len(xb), bool)
    keep[::3] = False
    fresh = TM.IndexIDMap(make())
    fresh.add_with_ids(xb[keep], ids[keep])
    D1, I1 = t.search(xq, K)
    D2, I2 = fresh.search(xq, K)
    np.testing.assert_array_equal(D1, D2)
    assert_topk_equal(D2, I2, D1, I1)
    assert not np.isin(I1, gone).any()


def test_idmap_remove_unsupported_sub_raises(data):
    xb, _, _ = data
    t = TM.IndexIDMap(T.IndexHNSWFlat(D, 8, device="cpu"))
    t.add_with_ids(xb[:200], np.arange(200))
    with pytest.raises(TypeError, match="neither keeps its ids"):
        t.remove_ids(T.IDSelectorRange(0, 10))


def test_shards_two_adds(data):
    """400 rows added in two batches of 200 to two IndexFlat shards: each
    row searched for itself comes back under its position in the order of
    the adds, and the shards search as one IndexFlat over the rows in that
    order. The reference finds none of them (idmap.py:176, 187: the second
    add overwrites the bases); faiss refuses the second add."""
    xb, xq, _ = data
    xs = xb[:400]
    t = TM.IndexShards(D, device="cpu")
    j = JM.IndexShards(D)
    for i in range(2):
        t.add_shard(T.IndexFlat(D, device="cpu"))
        j.add_shard(JFlat(D))
    for idx in (t, j):
        idx.add(xs[:200])
        idx.add(xs[200:])
    assert t.ntotal == 400
    assert t.id_runs == [[(0, 0, 100), (100, 200, 100)],
                         [(0, 100, 100), (100, 300, 100)]]
    _, I1 = t.search(xs, 1)
    np.testing.assert_array_equal(I1[:, 0], np.arange(400))
    _, I0 = j.search(xs, 1)
    assert (np.asarray(I0)[:, 0] == np.arange(400)).mean() == 0.0
    flat = T.IndexFlat(D, device="cpu")
    flat.add(xs)
    D1, I1 = t.search(xq, K)
    D2, I2 = flat.search(xq, K)
    np.testing.assert_array_equal(D1, D2)
    assert_topk_equal(D2, I2, D1, I1)


@pytest.mark.parametrize("batches,nshard,full", [
    ((150, 50, 200), 3, 0), ((1, 399), 2, 0), ((7, 93, 100, 200), 4, 0),
    ((100, 300), 3, 120)])
def test_shards_adds_follow_add_order(batches, nshard, full, data):
    """Adds of any sizes, after shards that came full (``full`` rows in
    the first): every row's id is its position in the order the rows came
    in, and the shards search as one IndexFlat over that order."""
    xb, xq, _ = data
    xs = xb[:full + sum(batches)]
    t = TM.IndexShards(D, device="cpu")
    for i in range(nshard):
        s = T.IndexFlat(D, device="cpu")
        if i == 0 and full:
            s.add(xs[:full])
        t.add_shard(s)
    n = full
    for b in batches:
        t.add(xs[n:n + b])
        n += b
    assert t.ntotal == len(xs)
    _, I1 = t.search(xs, 1)
    np.testing.assert_array_equal(I1[:, 0], np.arange(len(xs)))
    flat = T.IndexFlat(D, device="cpu")
    flat.add(xs)
    D1, I1 = t.search(xq, K)
    D2, I2 = flat.search(xq, K)
    np.testing.assert_array_equal(D1, D2)
    assert_topk_equal(D2, I2, D1, I1)


def test_shards_changed_outside_raise(data):
    xb, xq, _ = data
    t = TM.IndexShards(D, device="cpu")
    s = T.IndexFlat(D, device="cpu")
    t.add_shard(s)
    t.add(xb[:100])
    s.add(xb[100:110])
    with pytest.raises(RuntimeError, match="changed outside"):
        t.search(xq, K)


@pytest.mark.parametrize("nshard", [1, 3, 4])
def test_shards_single_add_equals_reference(nshard, data):
    xb, xq, _ = data
    t = TM.IndexShards(D, device="cpu")
    j = JM.IndexShards(D)
    for i in range(nshard):
        t.add_shard(T.IndexFlat(D, device="cpu"))
        j.add_shard(JFlat(D))
    t.add(xb)
    j.add(xb)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1)
    flat = T.IndexFlat(D, device="cpu")
    flat.add(xb)
    assert_topk_equal(*flat.search(xq, K), D1, I1)
    c = convert.shards_from_reference(
        {"d": D, "metric": T.METRIC_L2, "successive_ids": True},
        [convert.flat_from_reference(s.state_dict(), device="cpu")
         for s in j.shard_indexes])
    np.testing.assert_array_equal(c.search(xq, K)[1], I1)


@pytest.mark.parametrize("nrep", [1, 2, 3])
def test_replicas_equal_reference(nrep, data):
    xb, xq, cent = data
    t = TM.IndexReplicas(D, device="cpu")
    j = JM.IndexReplicas(D)
    for _ in range(nrep):
        t.add_replica(_ivf(cent))
        j.add_replica(_ivf(cent, "jax"))
    t.add(xb)
    j.add(xb)
    assert t.ntotal == j.ntotal == len(xb)
    D0, I0 = j.search(xq, K)
    D1, I1 = t.search(xq, K)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1)
    single = _ivf(cent)
    single.add(xb)
    D2, I2 = single.search(xq, K)
    np.testing.assert_array_equal(D1, D2)
    np.testing.assert_array_equal(I1, I2)
    c = convert.replicas_from_reference({"d": D, "metric": T.METRIC_L2},
                                        t.replicas)
    np.testing.assert_array_equal(c.search(xq, K)[1], I1)


@pytest.mark.parametrize("similarity", [False, True])
def test_merge_topk_axis_equals_reference(similarity):
    rs = np.random.RandomState(2)
    dis = rs.randint(0, 20, size=(3, 30, 8)).astype(np.float32)
    ids = rs.randint(0, 1000, size=(3, 30, 8)).astype(np.int64)
    D0, I0 = JTK.merge_topk_axis(dis, ids.astype(np.int32), 10,
                                 similarity=similarity)
    D1, I1 = T.merge_topk_axis(torch.from_numpy(dis), torch.from_numpy(ids),
                               10, similarity=similarity)
    np.testing.assert_array_equal(D1.numpy(), np.asarray(D0))
    np.testing.assert_array_equal(I1.numpy(), np.asarray(I0))


@pytest.mark.parametrize("kind", ["pq", "pq4", "pq_sdc", "sq"])
def test_pq_sq_selectors(kind, data):
    """IndexPQ (the decoded cache, 4-bit codes, SDC) and
    IndexScalarQuantizer honour params.sel: the results equal a search
    over the selected rows alone (the reference ignores the selector,
    tpu_ann/models/pq.py:183, 312)."""
    xb, xq, _ = data
    if kind == "sq":
        idx = T.IndexScalarQuantizer(D, T.QT_8BIT_DIRECT, device="cpu")
    else:
        idx = T.IndexPQ(D, 4, 4 if kind == "pq4" else 6, device="cpu")
        if kind == "pq_sdc":
            idx.search_type = T.IndexPQ.ST_SDC
    idx.train(xb)
    idx.add(xb)
    pick = np.sort(np.random.RandomState(5).choice(len(xb), 150,
                                                   replace=False))
    D1, I1 = idx.search(xq, K, params=T.SearchParameters(
        sel=T.IDSelectorBatch(pick)))
    assert np.isin(I1, pick).all()
    codes = idx.sa_encode(xb[pick])
    sub = T.IndexScalarQuantizer(D, T.QT_8BIT_DIRECT, device="cpu") \
        if kind == "sq" else T.IndexPQ(D, 4, idx.nbits, device="cpu")
    if kind != "sq":
        sub._set_codec(idx.pq.centroids)
        sub.search_type = idx.search_type
        sub.use_decoded_cache = idx._cache_enabled()
    sub.add(sub.sa_decode(codes))
    D2, I2 = sub.search(xq, K)
    np.testing.assert_array_equal(D1, D2)
    assert_topk_equal(D2, pick[I2], D1, I1)
