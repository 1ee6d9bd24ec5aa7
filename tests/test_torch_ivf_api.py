"""The IVF API of tpu_ann_torch against the JAX package's, on the CPU: the
query-major scan with IDSelectors and max_codes, the routes that reach it,
coarse_assign / list_of_ids / reconstruct, the DirectMap mutations
(remove_ids, update_vectors, add after a removal), merge_from and the
standalone codec.

Both packages get the same centroids (a pre-built flat quantizer,
quantizer_trains_alone=1), so they hold the same lists. On the CPU the JAX
index scans query-major; the port's default route is the plain version of
K3, its query-major route the port's scan_invlists. On integer data every
score is exact in both, so D is compared bit for bit and ids up to ties;
on float data D within rtol 1e-5."""

import numpy as np
import pytest

from tpu_ann.models import selectors as JS
from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import IndexIVFFlat as JIVF
from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.ops import ivf_scan as JScan
from tpu_ann_torch.models import base as tbase
from tpu_ann_torch.models import selectors as TS
from tpu_ann_torch.models.base import Index as TIndex
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import IndexIVFFlat as TIVF
from tpu_ann_torch.models.ivf import SearchParametersIVF as TParams
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan as TScan
from tpu_ann_torch.ops import ivf_scan_fused as F
from torch_parity import assert_topk_equal

import torch

D, NLIST, K, B = 32, 16, 10, 32
L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(11)
    xb = rs.randint(0, 48, size=(4000, D)).astype(np.float32)
    xq = rs.randint(0, 48, size=(60, D)).astype(np.float32)
    cent = xb[rs.choice(len(xb), NLIST, replace=False)]
    return xb, xq, cent


@pytest.fixture(scope="module")
def fdata():
    rs = np.random.RandomState(12)
    xb = rs.randn(3000, D).astype(np.float32)
    xq = rs.randn(50, D).astype(np.float32)
    return xb, xq, xb[rs.choice(len(xb), NLIST, replace=False)]


def _pair(data, metric=L2, ids=None, block_size=B, chunks=2):
    """(JAX, port) IVF-Flat indexes over the same centroids and rows."""
    xb, _, cent = data
    ids = 1000 + 3 * np.arange(len(xb), dtype=np.int64) if ids is None \
        else ids
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            q = JFlat(D, metric)
            q.add(cent)
            idx = JIVF(q, D, NLIST, metric, block_size)
            # the reference's per-list cap is a TPU-watchdog workaround
            # that the port does not copy: read whole lists on both sides
            idx.max_list_scan_factor = 0
        else:
            q = TFlat(D, metric, device="cpu")
            q.add(cent)
            idx = TIVF(q, D, NLIST, metric, block_size, device="cpu")
        idx.quantizer_trains_alone = 1
        idx.train(xb[:100])
        for part in np.array_split(np.arange(len(xb)), chunks):
            idx.add_with_ids(xb[part], ids[part])
        out.append(idx)
    return out


def _selectors(mod, ids, rs_seed=3):
    """One selector of each class over the stored ids ``ids`` (the same
    arguments for either package's module ``mod``)."""
    rs = np.random.RandomState(rs_seed)
    lo, hi = int(ids.min()), int(ids.max()) + 1
    pick = rs.choice(ids, len(ids) // 3, replace=False)
    bitmap = np.zeros((hi + 8) // 8, np.uint8)
    for i in rs.choice(ids, len(ids) // 2, replace=False):
        bitmap[i >> 3] |= 1 << (i & 7)
    mid = (lo + hi) // 2
    return {
        "range": mod.IDSelectorRange(lo, mid),
        "batch": mod.IDSelectorBatch(pick),
        "array": mod.IDSelectorArray(pick[:50]),
        "bitmap": mod.IDSelectorBitmap(bitmap),
        "all": mod.IDSelectorAll(),
        "not": mod.IDSelectorNot(mod.IDSelectorRange(lo, mid)),
        "and": mod.IDSelectorAnd(mod.IDSelectorRange(lo, mid),
                                 mod.IDSelectorBatch(pick)),
        "or": mod.IDSelectorOr(mod.IDSelectorRange(lo, lo + 300),
                               mod.IDSelectorBatch(pick[:100])),
        "xor": mod.IDSelectorXOr(mod.IDSelectorRange(lo, mid),
                                 mod.IDSelectorBatch(pick)),
        "empty": mod.IDSelectorBatch(np.zeros(0, np.int64)),
        "full": mod.IDSelectorRange(lo, hi),
    }


def _check(D0, I0, D1, I1, exact=True):
    if exact:
        np.testing.assert_array_equal(D1, D0)
    assert_topk_equal(D0, I0, D1, I1, rtol=0 if exact else 1e-5)


# --- the query-major scan itself ------------------------------------------

@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_scan_invlists_id_mask_and_cap(data, fdata, metric, kind):
    """ops.ivf_scan.scan_invlists against the reference's on the same
    packed lists: every mask kind (none, random, empty, full) at caps of 1,
    2 and all blocks a list; ndis counts valid and allowed rows."""
    xb, xq, cent = data if kind == "int" else fdata
    rs = np.random.RandomState(4)
    assign = rs.randint(0, NLIST, len(xb))
    jil = JScan.pack_invlists(xb, np.arange(len(xb)), assign, NLIST, B)
    til = TScan.pack_invlists(xb, np.arange(len(xb)), assign, NLIST, B,
                              device="cpu")
    probes = np.stack([rs.choice(NLIST, 5, replace=False)
                       for _ in range(len(xq))]).astype(np.int32)
    probes[::7, -1] = -1
    probes_t = torch.from_numpy(probes)
    full = til.max_nblocks_per_list
    masks = {"none": None,
             "random": (rs.rand(len(xb)) < 0.4).astype(np.uint8),
             "empty": np.zeros(len(xb), np.uint8),
             "full": np.ones(len(xb), np.uint8)}
    for name, m in masks.items():
        for mnb in (1, 2, full):
            D0, I0, n0 = JScan.scan_invlists(
                xq, probes, jil, K, metric, max_nblocks=mnb,
                id_mask=None if m is None else m)
            D1, I1, n1 = TScan.scan_invlists(
                torch.from_numpy(xq), probes_t, til, K, metric,
                max_nblocks=mnb,
                id_mask=None if m is None else torch.from_numpy(m))
            _check(np.asarray(D0), np.asarray(I0), D1.numpy(), I1.numpy(),
                   exact=kind == "int")
            assert int(n1) == int(n0), (name, mnb)
            if m is not None:
                got = I1.numpy()
                assert m[got[got >= 0]].all(), name


# --- IndexIVF search routes --------------------------------------------------

SEL_KINDS = ["range", "batch", "array", "bitmap", "all", "not", "and",
             "or", "xor", "empty", "full"]


@pytest.fixture(scope="module")
def pair(data):
    return _pair(data)


@pytest.mark.parametrize("kind", SEL_KINDS)
def test_search_with_selector_matches_reference(data, pair, kind):
    _, xq, _ = data
    j, t = pair
    ids = np.concatenate(t._ids_host)
    js, ts = _selectors(JS, ids)[kind], _selectors(TS, ids)[kind]
    before = F.LAUNCHES
    D0, I0 = j.search(xq, K, params=JParams(nprobe=5, sel=js))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=5, sel=ts))
    _check(D0, I0, D1, I1)
    ok = I1[I1 >= 0]
    assert ts.member_array(ok).all()
    if kind == "empty":
        assert (I1 == -1).all()
    # the selector's search_stats: the same route and the scan's ndis
    # (the reference's search_stats ignores sel: ROADMAP queue 3)
    D2, I2, st = t.search_stats(xq, K, params=TParams(nprobe=5, sel=ts))
    np.testing.assert_array_equal(D2, D1)
    np.testing.assert_array_equal(I2, I1)
    _, _, n_all = TScan.scan_invlists(
        torch.from_numpy(xq), torch.from_numpy(t.coarse_assign(xq, 5)),
        t.invlists, K, L2, max_nblocks=t._default_capped_mnb(),
        id_mask=t._sel_mask(TParams(sel=ts)))
    assert st.ndis == int(n_all)
    assert F.LAUNCHES == before


@pytest.mark.parametrize("max_codes", [B, 3 * B, 10 * B, 10 ** 6])
def test_search_with_max_codes_matches_reference(data, pair, max_codes):
    _, xq, _ = data
    j, t = pair
    D0, I0, s0 = j.search_stats(xq, K, params=JParams(nprobe=6,
                                                      max_codes=max_codes))
    D1, I1, s1 = t.search_stats(xq, K, params=TParams(nprobe=6,
                                                      max_codes=max_codes))
    _check(D0, I0, D1, I1)
    assert s1.ndis == s0.ndis
    D2, I2 = t.search(xq, K, params=TParams(nprobe=6, max_codes=max_codes))
    np.testing.assert_array_equal(D2, D1)
    np.testing.assert_array_equal(I2, I1)
    # an index-level cap takes the same route as the per-call one
    t.max_codes = max_codes
    try:
        D3, I3 = t.search(xq, K, params=TParams(nprobe=6))
    finally:
        t.max_codes = 0
    np.testing.assert_array_equal(D3, D1)
    np.testing.assert_array_equal(I3, I1)


def test_scan_modes_and_search_chunk(data, pair):
    _, xq, _ = data
    j, t = pair
    D0, I0 = j.search(xq, K, params=JParams(nprobe=4))
    for mode in ("auto", "fused", "grouped", "query"):
        t.scan_mode = mode
        D1, I1 = t.search(xq, K, params=TParams(nprobe=4))
        _check(D0, I0, D1, I1)
    t.scan_mode = "auto"
    t.search_chunk = 17
    try:
        D2, I2 = t.search(xq, K, params=TParams(nprobe=4))
    finally:
        t.search_chunk = 0
    _check(D0, I0, D2, I2)


def test_coarse_assign_list_of_ids_reconstruct(data, pair):
    xb, xq, _ = data
    j, t = pair
    np.testing.assert_array_equal(t.coarse_assign(xq, 5),
                                  j.coarse_assign(xq, 5))
    ids = np.r_[1000 + 3 * np.arange(0, 4000, 37), 7, -1, 10 ** 9]
    np.testing.assert_array_equal(t.list_of_ids(ids), j.list_of_ids(ids))
    for key in (1000, 1003 + 3 * 1999):
        np.testing.assert_array_equal(t.reconstruct(key), j.reconstruct(key))
    with pytest.raises(KeyError):
        t.reconstruct(1001)
    keys = 1000 + 3 * np.arange(5)
    np.testing.assert_array_equal(t.reconstruct_batch(keys), xb[:5])
    np.testing.assert_array_equal(t.compute_residual_n(xb[:5], keys), 0)
    Dr, Ir, R = t.search_and_reconstruct(xq[:4], 3)
    np.testing.assert_array_equal(R[0, 0], t.reconstruct(int(Ir[0, 0])))


def test_coarse_mode_quantizer_over_flat(data, pair):
    """coarse_mode="quantizer" asks the IndexFlat quantizer itself (its
    search_device): the same probes, so the same results as "auto"; a
    quantizer with no search of its own still raises."""
    _, xq, _ = data
    _, t = pair
    D0, I0 = t.search(xq, K, params=TParams(nprobe=5))
    t.coarse_mode = "quantizer"
    try:
        D1, I1 = t.search(xq, K, params=TParams(nprobe=5))
        np.testing.assert_array_equal(D1, D0)
        np.testing.assert_array_equal(I1, I0)
        assert (t._assign(xq) == t.coarse_assign(xq, 1)[:, 0]).all()
        q = t.quantizer
        t.quantizer = TIndex(D, device="cpu")
        with pytest.raises(NotImplementedError):
            t.search(xq, K)
        t.quantizer = q
    finally:
        t.coarse_mode = "auto"


def test_quantizer_trains_alone_2_runs_kmeans(data):
    xb, xq, _ = data
    t = TIVF(TFlat(D, device="cpu"), D, NLIST, device="cpu")
    t.quantizer_trains_alone = 2
    t.cp.niter = 3
    t.train(xb[:1500])
    assert len(t.clustering_stats) == 3 and t.quantizer.ntotal == NLIST
    t.add(xb)
    _, I = t.search(xb[:20], 1, params=TParams(nprobe=NLIST))
    assert (I[:, 0] == np.arange(20)).all()


# --- mutation ---------------------------------------------------------------

def _state_equal(j, t, xq, nprobe=6, exact=True):
    """Search (the port's K3 route and its query-major route), list sizes,
    list_of_ids, search_stats.ndis and the per-query ndis agree with the
    reference's."""
    D0, I0, s0 = j.search_stats(xq, K, params=JParams(nprobe=nprobe))
    D1, I1, s1 = t.search_stats(xq, K, params=TParams(nprobe=nprobe))
    _check(D0, I0, D1, I1, exact)
    assert s1.ndis == s0.ndis
    t.scan_mode = "query"
    try:
        D2, I2 = t.search(xq, K, params=TParams(nprobe=nprobe))
    finally:
        t.scan_mode = "auto"
    _check(D0, I0, D2, I2, exact)
    assert t.ntotal == j.ntotal
    np.testing.assert_array_equal(t.list_sizes, j.list_sizes)
    probe_ids = np.concatenate(j._ids_host)[::7]
    np.testing.assert_array_equal(t.list_of_ids(probe_ids),
                                  j.list_of_ids(probe_ids))
    # the per-query ndis: the probed lists' current sizes (the reference's
    # per-query count caches its sizes across in-place edits: queue 3)
    _, _, sp = t.search_stats_per_query(xq[:5], K,
                                        params=TParams(nprobe=nprobe))
    probes = j.coarse_assign(xq[:5], nprobe)
    np.testing.assert_array_equal(sp.per_query.ndis,
                                  j.list_sizes[probes].sum(1))
    return I1


def test_mutation_sequence_matches_reference(data):
    xb, xq, cent = data
    j, t = _pair(data)
    rs = np.random.RandomState(7)
    ids = 1000 + 3 * np.arange(len(xb), dtype=np.int64)
    _state_equal(j, t, xq)

    # 1. remove by id (the DirectMap route), absent ids included
    gone = np.r_[rs.choice(ids, 150, replace=False), 5, 10 ** 9]
    assert t.remove_ids(TS.IDSelectorBatch(gone)) == \
        j.remove_ids(JS.IDSelectorBatch(gone)) == 150
    assert not t._dirty and t._holes == 150
    I = _state_equal(j, t, xq)
    assert not np.isin(I, gone).any()
    with pytest.raises(KeyError):
        t.reconstruct(int(gone[0]))

    # 2. remove by predicate (one host scan), below the hole threshold
    sel = (1000 + 3 * 2000, 1000 + 3 * 2300)
    assert t.remove_ids(TS.IDSelectorRange(*sel)) == \
        j.remove_ids(JS.IDSelectorRange(*sel))
    assert not t._dirty
    I = _state_equal(j, t, xq)
    assert not ((I >= sel[0]) & (I < sel[1])).any()

    # 3. update in place: rows that stay in their list, rows that move to
    #    another list's padding
    live = ids[~np.isin(ids, gone) & ~((ids >= sel[0]) & (ids < sel[1]))]
    upd = rs.choice(live, 40, replace=False)
    rows = (upd - 1000) // 3
    same = xb[rows].copy()
    same[:, 0] = np.where(same[:, 0] > 0, same[:, 0] - 1, 1)
    j.update_vectors(upd, same)
    t.update_vectors(upd, same)
    _state_equal(j, t, xq)
    np.testing.assert_array_equal(t.reconstruct(int(upd[0])), same[0])
    holes = t._holes
    mv = upd[:6]
    target = (t.list_of_ids(mv) + 1) % NLIST
    xnew = cent[target]                         # each row's new list
    j.update_vectors(mv, xnew)
    t.update_vectors(mv, xnew)
    np.testing.assert_array_equal(t.list_of_ids(mv), target)
    assert t._holes == holes + 6 and not t._dirty
    _state_equal(j, t, xq)
    Dn, In = t.search(xnew, 1, params=TParams(nprobe=1))
    np.testing.assert_array_equal(Dn[:, 0], 0)

    # 4. a move into a full list repacks (more rows than its padding)
    fill = t._list_fill
    nblk = t.invlists.list_nblocks.numpy()
    lst = int(np.argmin(nblk * B - fill))
    room = int(nblk[lst] * B - fill[lst])
    others = live[~np.isin(live, upd)]
    mv = others[t.list_of_ids(others) != lst][:room + 3]
    xnew = np.repeat(cent[lst:lst + 1], len(mv), 0) + \
        (np.arange(len(mv)) % 2)[:, None].astype(np.float32)
    j.update_vectors(mv, xnew)
    t.update_vectors(mv, xnew)
    assert t._holes == 0 and t._pending_removals() == 0   # repacked
    _state_equal(j, t, xq)

    # 5. add after removals
    more = rs.randint(0, 48, size=(300, D)).astype(np.float32)
    more_ids = 10 ** 6 + np.arange(300, dtype=np.int64)
    t.remove_ids(TS.IDSelectorBatch(live[-20:]))
    j.remove_ids(JS.IDSelectorBatch(live[-20:]))
    j.add_with_ids(more, more_ids)
    t.add_with_ids(more, more_ids)
    _state_equal(j, t, np.r_[xq, more[:10]])

    # 6. a removal above max(1024, ntotal // 4) holes compacts at the next
    #    use
    big = TS.IDSelectorRange(1000, 1000 + 3 * 1500)
    n0 = t.remove_ids(big)
    assert n0 == j.remove_ids(JS.IDSelectorRange(1000, 1000 + 3 * 1500))
    assert n0 > 1024 and t._dirty
    _state_equal(j, t, xq)
    assert t._holes == 0 and len(t._ids_flat) == t.ntotal

    # 7. removing everything empties the index
    everything = TS.IDSelectorAll()
    assert t.remove_ids(everything) == j.remove_ids(JS.IDSelectorAll())
    assert t.ntotal == 0 and t.invlists is None
    assert t.remove_ids(everything) == 0


def test_merge_from_equals_whole_index(data):
    xb, xq, cent = data
    ids = 1000 + 3 * np.arange(len(xb), dtype=np.int64)
    whole = _pair(data, chunks=2)[1]
    a = _pair((xb[:2000], xq, cent), ids=ids[:2000], chunks=1)
    b = _pair((xb[2000:], xq, cent), ids=ids[2000:], chunks=1)
    a[0].merge_from(b[0])
    a[1].merge_from(b[1])
    assert b[1].ntotal == 0 and a[1].ntotal == len(xb)
    for name in ("data", "data_bf16", "ids", "norms", "list_block_start",
                 "list_nblocks"):
        assert torch.equal(getattr(a[1].invlists, name),
                           getattr(whole.invlists, name)), name
    Dw, Iw = whole.search(xq, K, params=TParams(nprobe=5))
    Dm, Im = a[1].search(xq, K, params=TParams(nprobe=5))
    np.testing.assert_array_equal(Dm, Dw)
    np.testing.assert_array_equal(Im, Iw)
    D0, I0 = a[0].search(xq, K, params=JParams(nprobe=5))
    _check(D0, I0, Dm, Im)
    with pytest.raises(ValueError):
        a[1].merge_from(b[1], add_id=5)


def test_merge_from_drops_pending_removals(data):
    xb, xq, cent = data
    ids = np.arange(len(xb), dtype=np.int64)
    _, a = _pair((xb[:2000], xq, cent), ids=ids[:2000], chunks=1)
    _, b = _pair((xb[2000:], xq, cent), ids=ids[2000:], chunks=1)
    b.remove_ids(TS.IDSelectorRange(2000, 2100))
    a.merge_from(b)
    assert a.ntotal == len(xb) - 100
    _, I = a.search(xb[2000:2100], 1, params=TParams(nprobe=NLIST))
    assert not ((I >= 2000) & (I < 2100)).any()


def test_float_data_mutation_matches_reference(fdata):
    """The same removal and update steps on float data: D within rtol
    1e-5, ids up to ties."""
    xb, xq, _ = fdata
    j, t = _pair(fdata, metric=IP)
    gone = 1000 + 3 * np.arange(0, 3000, 5)
    t.remove_ids(TS.IDSelectorBatch(gone))
    j.remove_ids(JS.IDSelectorBatch(gone))
    _state_equal(j, t, xq, exact=False)
    upd = 1000 + 3 * np.arange(1, 3000, 50)
    xnew = np.random.RandomState(2).randn(len(upd), D).astype(np.float32)
    t.update_vectors(upd, xnew)
    j.update_vectors(upd, xnew)
    _state_equal(j, t, xq, exact=False)


@pytest.mark.parametrize("nlist", [NLIST, 300])
def test_sa_encode_decode(data, nlist):
    xb, xq, _ = data
    rs = np.random.RandomState(1)
    cent = xb[rs.choice(len(xb), nlist, replace=False)]
    j = JIVF(JFlat(D), D, nlist)
    t = TIVF(TFlat(D, device="cpu"), D, nlist, device="cpu")
    for idx in (j, t):
        idx.quantizer.add(cent)
        idx.quantizer_trains_alone = 1
        idx.train(xb[:10])
    assert t.coarse_code_size() == j.coarse_code_size() == \
        (1 if nlist <= 256 else 2)
    assert t.sa_code_size() == j.sa_code_size()
    ct, cj = t.sa_encode(xq), j.sa_encode(xq)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(t.sa_decode(ct), xq)
    np.testing.assert_array_equal(
        t.decode_listno(ct[:, :t.coarse_code_size()]),
        t.coarse_assign(xq, 1)[:, 0])


def test_search_stats_counts_into_global_stats(data, pair):
    _, xq, _ = data
    _, t = pair
    tbase.indexIVF_stats.reset()
    _, _, st = t.search_stats(xq, K, params=TParams(nprobe=3, max_codes=B))
    assert tbase.indexIVF_stats.ndis == st.ndis > 0


def test_carried_index_with_pending_removals(data):
    """A JAX index with removals pending carries over with its holes
    (utils.convert): the port searches it as the reference does, and it is
    search-only."""
    from tpu_ann_torch.utils.convert import ivf_flat_from_reference

    _, xq, _ = data
    j, _ = _pair(data)
    gone = 1000 + 3 * np.arange(0, 4000, 4)
    j.remove_ids(JS.IDSelectorBatch(gone))
    il = j.invlists
    state = {"d": D, "metric": L2, "nlist": NLIST, "ntotal": j.ntotal,
             "vectors": np.asarray(j.quantizer.vectors),
             "data": np.asarray(il.data), "ids": np.asarray(il.ids),
             "norms": np.asarray(il.norms),
             "list_block_start": np.asarray(il.list_block_start),
             "list_nblocks": np.asarray(il.list_nblocks),
             "ids_flat": np.asarray(j._ids_flat)}
    t = ivf_flat_from_reference(state, device="cpu")
    assert t.ntotal == j.ntotal == 3000
    np.testing.assert_array_equal(t.list_sizes, j.list_sizes)
    D0, I0 = j.search(xq, K, params=JParams(nprobe=5))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=5))
    _check(D0, I0, D1, I1)
    assert not np.isin(I1, gone).any()
    with pytest.raises(RuntimeError):
        t.remove_ids(TS.IDSelectorBatch(gone[:1] + 3))


@pytest.fixture(scope="module")
def skewed():
    """22k rows in 64 lists, d 8: list 0 holds 12156 rows (95 blocks of
    128), far past the reference's per-list cap of max(64, 16 x the
    average) blocks; the other 63 lists share the rest."""
    rs = np.random.RandomState(5)
    cent = (np.arange(64, dtype=np.float32)[:, None] * 100
            + np.zeros((1, 8), np.float32))
    big = cent[0] + rs.randint(-3, 4, size=(12156, 8)).astype(np.float32)
    lst = rs.randint(1, 64, 22000 - 12156)
    rest = cent[lst] + rs.randint(-3, 4, size=(len(lst), 8)).astype(
        np.float32)
    xb = np.concatenate([big, rest])
    q = TFlat(8, device="cpu")
    q.add(cent)
    idx = TIVF(q, 8, 64, device="cpu")
    idx.quantizer_trains_alone = 1
    idx.train(xb[:100])
    idx.add(xb)
    xq = cent[:1] + rs.randint(-2, 3, size=(5, 8)).astype(np.float32)
    return idx, xb, xq


def test_skewed_index_reads_whole_lists(skewed):
    """The port reads whole lists on every route (max_list_scan_factor 0):
    IDSelectorAll returns what no selector returns, and a range search with
    an infinite radius returns every row of the probed list."""
    idx, xb, xq = skewed
    assert idx.list_sizes[0] == 12156 and idx.invlists.list_nblocks[0] == 95
    assert idx.max_list_scan_factor == 0
    p = TParams(nprobe=1)
    D0, I0 = idx.search(xq, K, params=p)
    before = F.LAUNCHES
    D1, I1 = idx.search(xq, K, params=TParams(nprobe=1,
                                              sel=TS.IDSelectorAll()))
    assert F.LAUNCHES == before                    # the query-major route
    assert_topk_equal(D0, I0, D1, I1, rtol=0)
    # both equal an exact search over list 0's rows
    ex = ((xq[:, None, :] - xb[None, :12156]) ** 2).sum(-1)
    np.testing.assert_array_equal(D0, np.sort(ex, 1)[:, :K])
    idx.nprobe = 1
    lims, Dr, Ir = idx.range_search(xq, float("inf"))
    assert np.all(np.diff(lims) == 12156)
    assert all(set(Ir[lims[i]:lims[i + 1]]) == set(range(12156))
               for i in range(len(xq)))
    # a caller may still set the cap: the query-major routes then read
    # max(64, 16 x the average) blocks of a list, as the reference's do
    idx.max_list_scan_factor = 16
    try:
        lims, _, _ = idx.range_search(xq, float("inf"))
        assert np.all(np.diff(lims) == 64 * 128)
    finally:
        idx.max_list_scan_factor = 0


def test_update_vectors_repeated_id_keeps_the_last(data):
    """An id given twice to update_vectors takes its last vector, moved to
    another list, and is stored once: search returns it once, the list
    sizes sum to ntotal, and the index equals one rebuilt from the final
    vectors. (The reference stores each occurrence.)"""
    xb, xq, cent = data
    xb = xb[:2000]
    rs = np.random.RandomState(3)
    x64 = xb[rs.choice(len(xb), 64, replace=False)]

    def build(rows):
        q = TFlat(D, device="cpu")
        q.add(x64)
        idx = TIVF(q, D, 64, device="cpu")
        idx.quantizer_trains_alone = 1
        idx.train(rows[:100])
        idx.add(rows)
        return idx

    t = build(xb)
    own = t.list_of_ids([7])[0]
    other = [lst for lst in range(64) if lst != own][:2]
    first, last = x64[other[0]], x64[other[1]]
    t.update_vectors([7, 7], np.stack([first, last]))
    assert t.list_of_ids([7])[0] == other[1]
    assert t.list_sizes.sum() == t.ntotal == len(xb)
    np.testing.assert_array_equal(t.reconstruct(7), last)
    Dq, Iq = t.search(last[None], 5, params=TParams(nprobe=64))
    assert list(Iq[0]).count(7) == 1
    final = xb.copy()
    final[7] = last
    ref = build(final)
    p = TParams(nprobe=4)
    D0, I0 = ref.search(xq, K, params=p)
    D1, I1 = t.search(xq, K, params=p)
    assert_topk_equal(D0, I0, D1, I1, rtol=0)
