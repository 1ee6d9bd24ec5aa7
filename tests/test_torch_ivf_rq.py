"""The IVF additive-quantizer indexes and the additive coarse quantizers of
tpu_ann_torch (models/rq.py) against the JAX package's, on the CPU.

Both packages share the coarse centroids (a pre-built flat quantizer,
quantizer_trains_alone=1) and the reference's codebooks rounded to
integers: on the integer SIFT surrogate (d 32) every sum is then exact in
f32, the code lists are byte-equal and the searches equal up to ties at
rtol 1e-6 (the bf16 decoded cache, through K3's plain version against the
reference's `scan_invlists_fused` in interpret mode on the same probes)
or 1e-5 (the "sq8" cache, whose dequantized values are not integers; the
table scan against the reference's `_ivf_rq_search`). Codes
have 4 bits, so ``use_decoded_cache=True`` is set where the cache is
wanted (the auto rule wants ksub > 16).

The reference's faults in this family are held to the port's own search or
to exact search over the decoded rows: its IVF-RQ scans code lists only in
`search`, ignores selectors, reconstructs the raw row, and cannot train an
IVF-RQ over a coarse quantizer without a centroid table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.models import rq as JM
from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.ops.ivf_scan_pallas import scan_invlists_fused as j_fused
from tpu_ann.utils import factory as JF
from tpu_ann_torch.models import rq as TM
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import SearchParametersIVF as TParams
from tpu_ann_torch.models.selectors import IDSelectorRange as TRange
from tpu_ann_torch.ops import ivf_scan as TS
from tpu_ann_torch.ops import sq as TSQ
from tpu_ann_torch.utils import factory as TF
from tpu_ann_torch.utils.convert import (coarse_aq_from_reference,
                                         ivf_aq_from_reference)
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

D, NLIST, K, B, M, NBITS = 32, 16, 10, 32, 3, 4
IDS0 = 300


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
    x = sift_surrogate(3100, seed=8, **SIFT1M_CALIBRATED)[:, :D].copy()
    xb, xt, xq = x[:2000], x[2000:3040], x[3040:]
    cent = xt[np.random.RandomState(1).choice(len(xt), NLIST, replace=False)]
    return xb, xt, xq, cent


def _ids(n):
    return IDS0 + 3 * np.arange(n, dtype=np.int64)


def _int_books(j):
    """Round the reference index's codebooks to integers, in place."""
    cb = np.round(j.rq.codebooks).astype(np.float32)
    j.rq.codebooks = cb
    j._books = jnp.asarray(cb)
    return cb


@pytest.fixture(scope="module")
def pair(data):
    """The reference's IVF-RQ (integer codebooks) and the port's over the
    same centroids and codebooks, both holding xb under ids IDS0 + 3i."""
    xb, xt, _, cent = data
    jq = JFlat(D)
    jq.add(cent)
    j = JM.IndexIVFResidualQuantizer(jq, D, NLIST, M, NBITS, block_size=B)
    j.quantizer_trains_alone = 1
    j.max_list_scan_factor = 0
    j.train(xt)
    cb = _int_books(j)
    j.add_with_ids(xb, _ids(len(xb)))
    tq = TFlat(D, device="cpu")
    tq.add(cent)
    t = TM.IndexIVFResidualQuantizer(tq, D, NLIST, M, NBITS, block_size=B,
                                     device="cpu")
    t.quantizer_trains_alone = 1
    t._set_codec(cb)
    t.is_trained = True
    t.add_with_ids(xb, _ids(len(xb)))
    return j, t


def _probes(t, xq, nprobe):
    return t.coarse_assign(xq, nprobe)


def test_lists_equal_reference(pair):
    j, t = pair
    for name in ("codes", "ids", "list_block_start", "list_nblocks"):
        np.testing.assert_array_equal(getattr(t.invlists, name).numpy(),
                                      np.asarray(getattr(j.invlists, name)),
                                      err_msg=name)


@pytest.mark.parametrize("dtype", ["bfloat16", "sq8"])
def test_cache_route_matches_reference_kernel(data, pair, dtype):
    """The decoded cache (byte-equal to the reference's) through K3's /
    K3-SQ8's plain version, against the reference's fused scan in
    interpret mode on the same probes."""
    xq = data[2]
    j, t = pair
    j.use_decoded_cache = t.use_decoded_cache = True
    j.decoded_cache_dtype = t.decoded_cache_dtype = dtype
    t._lists_changed()
    j._decoded = None
    probes = _probes(t, xq, 5)
    D1, I1 = t.search_preassigned(xq, K, probes)
    jl = j._decoded_cache()
    tl = t._decoded
    if dtype == "sq8":
        assert isinstance(tl, TS.PackedInvListsSQ8)
        np.testing.assert_array_equal(tl.codes.numpy(), np.asarray(jl.data))
    else:
        assert tl.data is tl.data_bf16
        np.testing.assert_array_equal(tl.data.float().numpy(),
                                      np.asarray(jl.data, np.float32))
    np.testing.assert_allclose(tl.norms.numpy(), np.asarray(jl.norms),
                               rtol=1e-6)
    D0, I0, _ = j_fused(jnp.asarray(xq), jnp.asarray(probes, jnp.int32), jl,
                        K, PT=32, CB=2, RW=0, interpret=True)
    # bf16 rows of integer values are exact; the SQ8 dequant is not
    assert_topk_equal(np.asarray(D0), j._map_ids(I0), D1, I1,
                      rtol=1e-6 if dtype == "bfloat16" else 1e-5)
    # search() takes the same probes and the same scan
    D2, I2 = t.search(xq, K, params=TParams(nprobe=5))
    np.testing.assert_array_equal(D2, D1)
    np.testing.assert_array_equal(I2, I1)


def test_table_route_matches_reference(data, pair):
    xq = data[2]
    j, t = pair
    j.use_decoded_cache = t.use_decoded_cache = False
    t._lists_changed()
    for nprobe in (3, 8):
        D0, I0 = j.search(xq, K, params=JParams(nprobe=nprobe))
        D1, I1 = t.search(xq, K, params=TParams(nprobe=nprobe))
        assert I1.min() >= IDS0
        assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)


@pytest.mark.parametrize("cache", [True, False])
def test_every_entry_point_scans_the_codec(data, pair, cache):
    """The reference's IVF-RQ fails in search_stats, search_preassigned,
    the per-query stats and range_search; the port's equal its search, and
    its range search equals brute force over the decoded probed rows."""
    xq = data[2]
    _, t = pair
    t.use_decoded_cache = cache
    t._lists_changed()
    p = TParams(nprobe=6)
    D1, I1 = t.search(xq, K, params=p)
    D2, I2, st = t.search_stats(xq, K, params=p)
    np.testing.assert_array_equal(D2, D1)
    np.testing.assert_array_equal(I2, I1)
    assert st.ndis > 0
    D3, I3 = t.search_preassigned(xq, K, _probes(t, xq, 6))
    np.testing.assert_array_equal(D3, D1)
    np.testing.assert_array_equal(I3, I1)
    D4, I4, _ = t.search_stats_per_query(xq[:6], K, params=p)
    np.testing.assert_allclose(D4, D1[:6], rtol=1e-6)
    np.testing.assert_array_equal(I4, I1[:6])
    # range search over the probed lists, exact f32 on the decoded rows
    t.nprobe = 6
    dec = t._range_lists()
    flat_ids = dec.ids.reshape(-1).numpy()
    rows = dec.data.reshape(-1, D).numpy()
    blk_list = np.repeat(np.arange(NLIST), dec.list_nblocks.numpy())
    probes = _probes(t, xq, 6)
    dis_all = ((xq[:, None, :] - rows[None]) ** 2).sum(-1)
    radius = float(np.quantile(D1[:, -1], 0.5))
    lims, Dr, Ir = t.range_search(xq, radius)
    real = np.nonzero(flat_ids >= 0)[0]
    row_list = blk_list[real // B]
    for q in range(len(xq)):
        ok = real[np.isin(row_list, probes[q])]
        dq = dis_all[q, ok]
        want = t._map_ids(flat_ids[ok][dq < radius * (1 - 1e-5)])
        maybe = t._map_ids(flat_ids[ok][dq < radius * (1 + 1e-5)])
        got = set(Ir[lims[q]:lims[q + 1]])
        assert set(want) <= got <= set(maybe)
    t.nprobe = 1


@pytest.mark.parametrize("cache", [True, False])
def test_selector_and_max_codes(data, pair, cache):
    """Under IDSelectorRange the reference returns unfiltered ids; the
    port's ids are the selected ones, equal to exact search over the
    decoded rows of the selected ids (every list probed)."""
    xq = data[2]
    j, t = pair
    t.use_decoded_cache = cache
    t._lists_changed()
    lo, hi = IDS0 + 300, IDS0 + 1500
    p = TParams(nprobe=NLIST, sel=TRange(lo, hi))
    Dv, Iv = t.search(xq, K, params=p)
    assert ((Iv >= lo) & (Iv < hi)).all()
    dec = t._range_lists() if not cache else t._decoded
    flat_ids = dec.ids.reshape(-1)
    real = torch.nonzero(flat_ids >= 0)[:, 0]
    user = torch.from_numpy(t._map_ids(flat_ids[real].numpy()))
    keep = real[(user >= lo) & (user < hi)]
    rows, norms = dec.rows_at(keep)
    xqt = torch.from_numpy(xq)
    dis = torch.clamp((xqt * xqt).sum(1, keepdim=True) + norms[None]
                      - 2.0 * xqt @ rows.T, min=0.0)
    ed, pos = torch.sort(dis, dim=1, stable=True)
    E_i = t._map_ids(flat_ids[keep][pos[:, :K]].numpy())
    assert_topk_equal(ed[:, :K].numpy(), E_i, Dv, Iv, rtol=1e-4)
    # a max_codes cap takes the query-major route, within the probed lists
    Dc, Ic, st = t.search_stats(xq, K, params=TParams(nprobe=4,
                                                      max_codes=B))
    assert st.ndis <= len(xq) * 4 * B
    assert np.isfinite(Dc[:, 0]).all()


def test_reconstruct_is_decoded(data, pair):
    """faiss reconstructs the decoded vector; the reference returns the
    raw row from its host store."""
    xb = data[0]
    j, t = pair
    for i in (0, 7, 1999):
        key = int(_ids(len(xb))[i])
        rec = t.reconstruct(key)
        np.testing.assert_array_equal(j.reconstruct(key), xb[i])
        sa = t.sa_decode(t.sa_encode(xb[i:i + 1]))[0]
        np.testing.assert_allclose(rec, sa, rtol=1e-6, atol=1e-4)
        assert not np.array_equal(rec, xb[i])
    with pytest.raises(KeyError):
        t.reconstruct(IDS0 + 1)


@pytest.fixture(scope="module")
def coarse_pair(data):
    xt = data[1]
    out = {}
    for name in ("ResidualCoarseQuantizer", "LocalSearchCoarseQuantizer"):
        j = getattr(JM, name)(D, 2, 3)
        j.train(xt)
        t = coarse_aq_from_reference(
            {"cls": name, "d": D, "M": 2, "nbits": 3,
             "beam_factor": j.beam_factor,
             "codebooks": np.asarray(j.rq.codebooks)}, device="cpu")
        out[name] = j, t
    return out


@pytest.mark.parametrize("name,bf", [("ResidualCoarseQuantizer", 4.0),
                                     ("ResidualCoarseQuantizer", 0.5),
                                     ("ResidualCoarseQuantizer", -1.0),
                                     ("LocalSearchCoarseQuantizer", -1.0)])
def test_coarse_search_matches_reference(data, coarse_pair, name, bf):
    xq = data[2]
    j, t = coarse_pair[name]
    j.beam_factor = t.beam_factor = bf
    assert t.ntotal == j.ntotal == 64
    D0, I0 = j.search(xq, 6)
    D1, I1 = t.search(xq, 6)
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(t.reconstruct_batch(I1[:, 0]),
                               j.reconstruct_batch(I1[:, 0]), rtol=1e-6)


def _set_int_coarse(j, t):
    """Integer codebooks in both packages' coarse quantizers."""
    cb = np.round(np.asarray(j.quantizer.rq.codebooks)).astype(np.float32)
    j.quantizer.rq.codebooks = cb
    j.quantizer._books = jnp.asarray(cb)
    t.quantizer.set_codebooks(cb)


@pytest.mark.parametrize("code", ["Flat", "SQ8", "PQ8"])
def test_ivf_over_rcq_matches_reference(data, code):
    """IVF64(RCQ2x3),Flat|SQ8|PQ8 trained by the reference; the port takes
    its (integer) coarse codebooks and codec and holds the same rows."""
    xb, xt, xq, _ = data
    spec = f"IVF64(RCQ2x3),{code}"
    j = JF.index_factory(D, spec)
    j.max_list_scan_factor = 0
    j.train(xt)
    t = TF.index_factory(D, spec, device="cpu")
    assert isinstance(t.quantizer, TM.ResidualCoarseQuantizer)
    assert t.quantizer_trains_alone == 1
    _set_int_coarse(j, t)
    if code == "SQ8":
        t.sq = TSQ.SQCodec(qtype=j.sq.qtype, d=D, vmin=j.sq.vmin,
                           vdiff=j.sq.vdiff)
    elif code == "PQ8":
        pc = np.round(j.pq.centroids).astype(np.float32)
        j.pq.centroids = pc
        j._pq_cent_dev = jnp.asarray(pc)
        t._set_codec(pc)
    t.is_trained = True
    j.add(xb)
    t.add(xb)
    for nprobe in (4, 16):
        D0, I0 = j.search(xq, K, params=JParams(nprobe=nprobe))
        D1, I1 = t.search(xq, K, params=TParams(nprobe=nprobe))
        if code == "SQ8":
            inter = np.mean([len(set(a) & set(b)) / K
                             for a, b in zip(I0, I1)])
            assert inter >= 0.99
            np.testing.assert_allclose(D1[:, 0], D0[:, 0], rtol=1e-5)
        else:
            assert_topk_equal(D0, I0, D1, I1, rtol=1e-6)


def test_rcq_rq_trains_and_equals_flat_quantizer(data):
    """IVF64(RCQ2x3),RQ4x4: the reference's train fails (its encoder
    indexes a missing centroid table); the port's trains on the decoded
    centroids, and with exact enumeration equals an IVF-RQ whose IndexFlat
    quantizer holds the same 64 centroids."""
    xb, xt, xq, _ = data
    spec = "IVF64(RCQ2x3),RQ4x4"
    with pytest.raises(IndexError):
        JF.index_factory(D, spec).train(xt)
    t = TF.index_factory(D, spec, device="cpu")
    t.quantizer.beam_factor = -1.0
    t.use_decoded_cache = True
    t.train(xt)
    t.add(xb)
    cents = t.quantizer.reconstruct_batch(np.arange(64))
    q = TFlat(D, device="cpu")
    q.add(cents)
    f = TM.IndexIVFResidualQuantizer(q, D, 64, 4, 4, device="cpu")
    f.quantizer_trains_alone = 1
    f.use_decoded_cache = True
    f._set_codec(t.rq.codebooks)
    f.is_trained = True
    f.add(xb)
    np.testing.assert_array_equal(f.invlists.codes.numpy(),
                                  t.invlists.codes.numpy())
    for cache in (True, False):
        t.use_decoded_cache = f.use_decoded_cache = cache
        t._lists_changed()
        f._lists_changed()
        D0, I0 = f.search(xq, K, params=TParams(nprobe=8))
        D1, I1 = t.search(xq, K, params=TParams(nprobe=8))
        np.testing.assert_array_equal(D1, D0)
        np.testing.assert_array_equal(I1, I0)
    # the beam route finds most of the exact nearest lists
    t.quantizer.beam_factor = 4.0
    exact = f.coarse_assign(xq, 8)
    beam = t.coarse_assign(xq, 8)
    assert np.mean([len(set(a) & set(b)) / 8
                    for a, b in zip(exact, beam)]) >= 0.9


def test_virtual_centroids_enumerated_once(data):
    """An IVF over RCQ reads its centroids from the quantizer's one cached
    enumeration (every search, add and cache build), equal to the decode
    of each id, and a new set of codebooks replaces it."""
    _, xt, _, _ = data
    t = TF.index_factory(D, "IVF64(RCQ2x3),Flat", device="cpu")
    t.train(xt)
    cents = t._coarse_centroids()
    assert cents is t._coarse_centroids()
    assert cents is t.quantizer._all_centroids()
    np.testing.assert_array_equal(
        cents.numpy(), t.quantizer.reconstruct_batch(np.arange(64)))
    t.quantizer.set_codebooks(t.quantizer.rq.codebooks * 2)
    np.testing.assert_array_equal(t._coarse_centroids().numpy(),
                                  2 * cents.numpy())


def test_ivf_convert_matches_reference(data, pair):
    """A reference IVF-RQ carried over by `ivf_aq_from_reference` searches
    as the reference does (the table route)."""
    xb, _, xq, cent = data
    j, _ = pair
    j.use_decoded_cache = False
    il = j.invlists
    state = {"cls": "IndexIVFResidualQuantizer", "d": D, "metric": TM.D.METRIC_L2,
             "nlist": NLIST, "ntotal": j.ntotal, "M": M, "nbits": NBITS,
             "vectors": cent, "codebooks": np.asarray(j.rq.codebooks),
             "codes": np.asarray(il.codes), "ids": np.asarray(il.ids),
             "list_block_start": np.asarray(il.list_block_start),
             "list_nblocks": np.asarray(il.list_nblocks),
             "ids_flat": np.concatenate(j._ids_host)}
    t = ivf_aq_from_reference(state, device="cpu")
    t.use_decoded_cache = False
    D0, I0 = j.search(xq, K, params=JParams(nprobe=5))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=5))
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5)
