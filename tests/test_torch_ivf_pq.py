"""IndexIVFPQ of tpu_ann_torch against the JAX package's, on the CPU.

Both indexes get the same coarse centroids (a pre-built flat quantizer,
quantizer_trains_alone=1) and the port takes the JAX index's PQ codebook,
so they hold the same code lists. On the CPU the JAX index scans its
decoded cache query-major (its fused route refuses the CPU backend), the
port runs the plain version of K3 (K3-SQ8 for an "sq8" cache) over the
same cache; both re-rank the bf16 rows with the norms of the f32 decode.
With integer codebooks every product is exact: (D, I) equal up to ties at
rtol 0. Float codebooks: ids overlap >= 0.99, D within rtol 1e-5. The
4-bit table scan is held to exact f32 ADC (the reference rounds its 4-bit
table to bf16) and to an overlap >= 0.95 with the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.models.flat import IndexFlat as JFlat
from tpu_ann.models.ivf import SearchParametersIVF as JParams
from tpu_ann.models.ivf_pq import IndexIVFPQ as JIVFPQ
from tpu_ann.models.selectors import IDSelectorRange as JRange
from tpu_ann_torch.models.flat import IndexFlat as TFlat
from tpu_ann_torch.models.ivf import SearchParametersIVF as TParams
from tpu_ann_torch.models.ivf_pq import IndexIVFPQ as TIVFPQ
from tpu_ann_torch.models.selectors import IDSelectorBatch as TBatch
from tpu_ann_torch.models.selectors import IDSelectorRange as TRange
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan as TS
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.utils.convert import ivf_pq_from_reference
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

D, NLIST, K, B = 32, 16, 10, 32
L2, IP = TD.METRIC_L2, TD.METRIC_INNER_PRODUCT
IDS0 = 500


@pytest.fixture(scope="module")
def data():
    x = sift_surrogate(5000, seed=8, **SIFT1M_CALIBRATED)[:, :D].copy()
    xb, xt, xq = x[:4000], x[4000:4900], x[4900:]
    cent = xt[np.random.RandomState(1).choice(len(xt), NLIST, replace=False)]
    return xb, xt, xq, cent


def _quant(pkg, cent, metric):
    q = JFlat(D, metric) if pkg == "jax" else TFlat(D, metric, device="cpu")
    q.add(cent)
    return q


def _ids(n):
    return IDS0 + 2 * np.arange(n, dtype=np.int64)


def _port(data, codebook, M=8, nbits=8, metric=L2, rows=None, ids=None,
          by_residual=True, cache_dtype="bfloat16"):
    """A port IndexIVFPQ over the shared centroids with ``codebook``."""
    xb, xt, _, cent = data
    t = TIVFPQ(_quant("torch", cent, metric), D, NLIST, M, nbits, metric, B,
               device="cpu")
    t.quantizer_trains_alone = 1
    t.by_residual = by_residual
    t.decoded_cache_dtype = cache_dtype
    t.train(xt[:300])
    t._set_codec(codebook)
    rows = xb if rows is None else rows
    t.add_with_ids(rows, _ids(len(xb)) if ids is None else ids)
    return t


def _pair(data, M=8, nbits=8, metric=L2, integer=True, by_residual=True,
          cache_dtype="bfloat16"):
    xb, xt, _, cent = data
    j = JIVFPQ(_quant("jax", cent, metric), D, NLIST, M, nbits, metric, B)
    j.quantizer_trains_alone = 1
    j.max_list_scan_factor = 0      # the reference's TPU-watchdog cap off
    j.by_residual = by_residual
    j.decoded_cache_dtype = cache_dtype
    j.train(xt)
    if integer:
        j.pq.centroids = np.round(j.pq.centroids).astype(np.float32)
        j._pq_cent_dev = jnp.asarray(j.pq.centroids)
    for part in np.array_split(np.arange(len(xb)), 2):
        j.add_with_ids(xb[part], _ids(len(xb))[part])
    t = _port(data, j.pq.centroids, M, nbits, metric, by_residual=by_residual,
              cache_dtype=cache_dtype)
    for name in ("codes", "ids", "list_block_start", "list_nblocks"):
        np.testing.assert_array_equal(getattr(t.invlists, name).numpy(),
                                      np.asarray(getattr(j.invlists, name)),
                                      err_msg=name)
    return j, t


def _overlap(I0, I1):
    return np.mean([len(set(a) & set(b)) / I0.shape[1]
                    for a, b in zip(I0, I1)])


def _close_common(D0, I0, D1, I1, rtol):
    for q in range(len(I0)):
        m0, m1 = dict(zip(I0[q], D0[q])), dict(zip(I1[q], D1[q]))
        for i in set(m0) & set(m1):
            np.testing.assert_allclose(m1[i], m0[i], rtol=rtol)


CASES = [(True, L2, True), (False, L2, True), (True, IP, True),
         (True, L2, False)]


@pytest.mark.parametrize("integer,metric,by_residual", CASES)
def test_bf16_cache_matches_reference(data, integer, metric, by_residual):
    """The default route: the bf16 decoded cache through K3's plain
    version, search and search_stats."""
    xq = data[2]
    j, t = _pair(data, metric=metric, integer=integer,
                 by_residual=by_residual)
    before = (F.LAUNCHES, F.LAUNCHES_SQ8)
    for nprobe in (4, 8):
        D0, I0 = j.search(xq, K, params=JParams(nprobe=nprobe))
        D1, I1 = t.search(xq, K, params=TParams(nprobe=nprobe))
        assert D1.dtype == np.float32 and I1.dtype == np.int64
        assert I1.min() >= IDS0
        if integer:
            assert_topk_equal(D0, I0, D1, I1, rtol=0)
        else:
            assert _overlap(I0, I1) >= 0.99
            _close_common(D0, I0, D1, I1, 1e-5)
        D2, I2, st = t.search_stats(xq, K, params=TParams(nprobe=nprobe))
        np.testing.assert_array_equal(D2, D1)
        np.testing.assert_array_equal(I2, I1)
        assert st.nq == len(xq) and 0 < st.ndis <= len(xq) * t.ntotal
    assert (F.LAUNCHES, F.LAUNCHES_SQ8) == before   # CPU: plain versions
    dl = t._decoded
    assert isinstance(dl, TS.PackedInvLists) and dl.ids is t.invlists.ids
    # the bf16 cache holds its rows once: the re-rank widens the stream
    assert dl.data is dl.data_bf16 and dl.data.dtype == torch.bfloat16


@pytest.mark.parametrize("nprobe", [1, 2])
def test_wide_k_keeps_default_kp(data, nprobe):
    """k 100 asks K3 for default_kp(100) = 106 rows a (query, list), more
    than the kernel keeps in a pass (32): the cache route keeps the
    reference's width on every device. The port's search equals K3's plain
    version at default_kp(k) and the reference at rtol 0 (integer
    codebooks), with k hits wherever the probed lists hold k rows. On the
    card the same width is one launch of K3's kernel whose lists live in
    global memory (held to this plain version in
    tests/test_torch_cuda_kernels.py)."""
    xq = data[2]
    j, t = _pair(data)
    k = 100
    D0, I0 = j.search(xq, k, params=JParams(nprobe=nprobe))
    D1, I1 = t.search(xq, k, params=TParams(nprobe=nprobe))
    xq_t = torch.from_numpy(xq)
    _, probes = t._coarse_search_device(xq_t, nprobe)
    D2, I2, _ = F.scan_invlists_fused_reference(xq_t, probes, t._decoded, k,
                                                kp=F.default_kp(k))
    np.testing.assert_array_equal(D1, D2.numpy())
    np.testing.assert_array_equal(I1, t._map_ids(I2.numpy()))
    assert_topk_equal(D0, I0, D1, I1, rtol=0)
    ids = t.invlists.ids.numpy()
    lbs, lnb = (a.numpy() for a in (t.invlists.list_block_start,
                                    t.invlists.list_nblocks))
    size = np.array([(ids[s:s + n] >= 0).sum() for s, n in zip(lbs, lnb)])
    held = np.minimum(size[probes.numpy()].sum(1), k)
    np.testing.assert_array_equal((I1 >= 0).sum(1), held)
    assert (held == k).mean() > 0.9


def test_sq8_cache_matches_reference(data):
    """decoded_cache_dtype "sq8": the SQ8 stream requantized from the
    bf16-rounded rows, byte-equal to the reference's, through K3-SQ8's
    plain version."""
    xq = data[2]
    j, t = _pair(data, cache_dtype="sq8")
    p = TParams(nprobe=6)
    D0, I0 = j.search(xq, K, params=JParams(nprobe=6))
    D1, I1 = t.search(xq, K, params=p)
    dl = t._decoded
    assert isinstance(dl, TS.PackedInvListsSQ8)
    assert dl.codes.dtype == torch.uint8 and not hasattr(dl, "data")
    np.testing.assert_array_equal(dl.codes.numpy(),
                                  np.asarray(j._decoded.data))
    np.testing.assert_allclose(dl.norms.numpy(),
                               np.asarray(j._decoded.norms), rtol=1e-6)
    assert _overlap(I0, I1) >= 0.99
    _close_common(D0, I0, D1, I1, 1e-5)
    # the byte rule counts a byte a dimension for "sq8"
    assert t._cache_enabled()
    t.decoded_cache_max_bytes = (t.invlists.nblocks + 1) * B * D - 1
    assert not t._cache_enabled()


def test_lut_8bit_matches_reference(data):
    xq = data[2]
    j, t = _pair(data, integer=False)
    j.use_decoded_cache = t.use_decoded_cache = False
    t._decoded = None
    D0, I0 = j.search(xq, K, params=JParams(nprobe=5))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=5))
    assert t._decoded is None
    assert_topk_equal(D0, I0, D1, I1, rtol=1e-5, atol=1e-2)


def _exact_adc(t, xq, probes):
    """Exact f32 top-K over the f32-decoded rows of each query's probed
    lists, as user ids."""
    dec = t._decode_lists(torch.float32)
    out_d, out_i = [], []
    for q in range(len(xq)):
        bl = np.concatenate([
            np.arange(s, s + n) for s, n in zip(
                dec.list_block_start.numpy()[probes[q]],
                dec.list_nblocks.numpy()[probes[q]])])
        rows = dec.data[bl].reshape(-1, D).numpy()
        ids = dec.ids[bl].reshape(-1).numpy()
        dis = ((rows - xq[q]) ** 2).sum(1)
        dis[ids < 0] = np.inf
        o = np.argsort(dis, kind="stable")[:K]
        out_d.append(dis[o])
        out_i.append(t._map_ids(ids[o]))
    return np.stack(out_d), np.stack(out_i)


def test_4bit_is_exact_adc(data):
    xq = data[2]
    j, t = _pair(data, M=16, nbits=4, integer=False)
    assert not t._cache_enabled() and not j._cache_enabled()
    assert t.invlists.codes.shape[-1] == 8          # two a byte
    p = TParams(nprobe=4)
    D1, I1 = t.search(xq, K, params=p)
    probes = t.coarse_assign(xq, 4)
    De, Ie = _exact_adc(t, xq, probes)
    assert_topk_equal(De, Ie, D1, I1, rtol=1e-5)
    D0, I0 = j.search(xq, K, params=JParams(nprobe=4))
    assert _overlap(I0, I1) >= 0.95


def test_selector_max_codes_range(data):
    xb, _, xq, _ = data
    j, t = _pair(data)
    sel_t, sel_j = TRange(IDS0 + 1000, IDS0 + 5000), JRange(IDS0 + 1000,
                                                            IDS0 + 5000)
    before = F.LAUNCHES
    D0, I0 = j.search(xq, K, params=JParams(nprobe=6, sel=sel_j))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=6, sel=sel_t))
    assert_topk_equal(D0, I0, D1, I1, rtol=0)
    assert ((I1 >= IDS0 + 1000) & (I1 < IDS0 + 5000)).all()
    longest = t.invlists.max_nblocks_per_list
    cap = (longest - 2) * B
    D0, I0 = j.search(xq, K, params=JParams(nprobe=6, max_codes=cap))
    D1, I1, st = t.search_stats(xq, K, params=TParams(nprobe=6,
                                                       max_codes=cap))
    assert_topk_equal(D0, I0, D1, I1, rtol=0)
    assert F.LAUNCHES == before
    j.nprobe = t.nprobe = 3
    r = float(np.median(D1[:, 5]))
    l0, d0, i0 = j.range_search(xq, r)
    l1, d1, i1 = t.range_search(xq, r)
    np.testing.assert_array_equal(l1, l0)
    for q in range(len(xq)):
        s0 = sorted(zip(i0[l0[q]:l0[q + 1]], d0[l0[q]:l0[q + 1]]))
        s1 = sorted(zip(i1[l1[q]:l1[q + 1]], d1[l1[q]:l1[q + 1]]))
        assert [a for a, _ in s0] == [a for a, _ in s1]
        np.testing.assert_allclose([b for _, b in s1], [b for _, b in s0],
                                   rtol=1e-6)


@pytest.mark.parametrize("nbits,M", [(8, 8), (4, 16)])
def test_sa_codec_and_reconstruct(data, nbits, M):
    xb, _, xq, _ = data
    j, t = _pair(data, M=M, nbits=nbits)
    assert t.sa_code_size() == j.sa_code_size()
    cj, ct = j.sa_encode(xq), t.sa_encode(xq)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(t.sa_decode(cj), j.sa_decode(cj))
    np.testing.assert_array_equal(t.reconstruct(IDS0 + 14), xb[7])


def test_train_encoder_on_residuals(data):
    """The port trains its codebook on the residuals of the same
    assignment: its quantization error within 1% of the reference's."""
    xb, xt, _, cent = data
    j = JIVFPQ(_quant("jax", cent, L2), D, NLIST, 8, 8, L2, B)
    t = TIVFPQ(_quant("torch", cent, L2), D, NLIST, 8, 8, L2, B,
               device="cpu")
    errs = []
    for idx in (j, t):
        idx.quantizer_trains_alone = 1
        idx.train(xt)
        c = idx.pq.centroids
        a = ((xb[:, None] - cent[None]) ** 2).sum(-1).argmin(1)
        r = (xb - cent[a]).reshape(len(xb), 8, 4)
        dis = ((r[:, :, None, :] - c[None]) ** 2).sum(-1)
        errs.append(dis.min(-1).sum(-1).mean())
    assert abs(errs[1] - errs[0]) <= 0.01 * errs[0]


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "sq8"])
def test_cache_follows_removals(data, cache_dtype):
    """remove_ids edits the id plane in place and drops the cache: the next
    search rebuilds it over the same (shared) id plane, so no removed id
    comes back; a removal past the hole threshold repacks (a new id plane)
    and the cache follows it too. After each, (D, I) equal an index built
    over the remaining rows with the same codebook."""
    xb, _, xq, _ = data
    j, t = _pair(data, cache_dtype=cache_dtype)
    p = TParams(nprobe=6)
    t.search(xq, K, params=p)
    ids = _ids(len(xb))
    gone = ids[np.random.RandomState(2).choice(len(xb), 300, replace=False)]
    ids_plane = t.invlists.ids
    assert t.remove_ids(TBatch(gone)) == 300 and t._decoded is None
    D1, I1 = t.search(xq, K, params=p)
    assert t.invlists.ids is ids_plane and t._decoded.ids is ids_plane
    assert not np.isin(I1, gone).any()

    def rest_index(gone_ids):
        keep = ~np.isin(ids, gone_ids)
        return _port(data, t.pq.centroids, rows=xb[keep], ids=ids[keep],
                     cache_dtype=cache_dtype)

    D0, I0 = rest_index(gone).search(xq, K, params=p)
    if cache_dtype == "sq8":
        # the requantize affine spans the remaining rows in both
        assert _overlap(I0, I1) >= 0.99
        _close_common(D0, I0, D1, I1, 1e-6)
    else:
        assert_topk_equal(D0, I0, D1, I1, rtol=0)
    more = ids[:1500]
    t.remove_ids(TRange(int(more[0]), int(more[-1]) + 1))
    assert t._dirty                               # past the hole threshold
    D1, I1 = t.search(xq, K, params=p)
    assert t.invlists.ids is not ids_plane
    assert t._decoded.ids is t.invlists.ids
    allgone = np.union1d(gone, more)
    assert not np.isin(I1, allgone).any()
    D0, I0 = rest_index(allgone).search(xq, K, params=p)
    if cache_dtype == "sq8":
        assert _overlap(I0, I1) >= 0.99
    else:
        assert_topk_equal(D0, I0, D1, I1, rtol=0)


def test_update_and_merge(data):
    """update_vectors on coded storage re-encodes through a repack;
    merge_from of two halves equals the whole."""
    xb, _, xq, _ = data
    j, t = _pair(data)
    p = TParams(nprobe=6)
    ids = _ids(len(xb))
    upd = ids[[3, 40, 41, 900]]
    xnew = xb[[10, 11, 12, 13]] + 1.0
    t.update_vectors(upd, xnew)
    rows = xb.copy()
    rows[[3, 40, 41, 900]] = xnew
    ref = _port(data, t.pq.centroids, rows=rows)
    assert_topk_equal(*ref.search(xq, K, params=p), *t.search(xq, K,
                                                                params=p),
                      rtol=0)
    half = len(xb) // 2
    a = _port(data, t.pq.centroids, rows=xb[:half], ids=ids[:half])
    b = _port(data, t.pq.centroids, rows=xb[half:], ids=ids[half:])
    a.search(xq, K, params=p)                     # a cache to drop
    a.merge_from(b)
    assert b.ntotal == 0 and a.ntotal == len(xb)
    whole = _port(data, t.pq.centroids)
    for x0, x1 in zip(whole.search(xq, K, params=p),
                      a.search(xq, K, params=p)):
        np.testing.assert_array_equal(x1, x0)


def test_ivf_pq_from_reference(data):
    xq = data[2]
    j, _ = _pair(data, integer=False)
    il = j.invlists
    state = {"d": j.d, "metric": j.metric_type, "nlist": j.nlist,
             "ntotal": j.ntotal, "vectors": np.asarray(j.quantizer.vectors),
             "codes": np.asarray(il.codes), "ids": np.asarray(il.ids),
             "list_block_start": np.asarray(il.list_block_start),
             "list_nblocks": np.asarray(il.list_nblocks),
             "ids_flat": np.asarray(j._ids_flat), "M": j.M,
             "nbits": j.nbits, "by_residual": j.by_residual,
             "pq_centroids": j.pq.centroids}
    t = ivf_pq_from_reference(state, device="cpu")
    D0, I0 = j.search(xq, K, params=JParams(nprobe=5))
    D1, I1 = t.search(xq, K, params=TParams(nprobe=5))
    assert _overlap(I0, I1) >= 0.99
    _close_common(D0, I0, D1, I1, 1e-5)
    with pytest.raises(RuntimeError):
        t.add(data[0][:5])                      # search-only
