"""Port parity for the SQ8 stream of the fused IVF scan and for K3g:
tpu_ann_torch.ops.ivf_scan (coded lists, PackedInvListsSQ8) and
tpu_ann_torch.ops.ivf_scan_fused (the uint8 route, scan_invlists_fused_grid)
against the JAX package, on the CPU.

The JAX side runs its Pallas kernels as tests/test_ivf_pallas.py does:
interpret mode, small blocks (B=16), PT=32; K3 with RW=0, so that its
per-pair top-kp is exact like the port's. Data is the SIFT surrogate
(integers 0..255). With QT_8BIT_DIRECT the codes are the data, every score
is exact in both packages, and (D, I) must agree bit for bit. With trained
QT_8BIT ranges the query fold rounds q * scale to bf16 on both sides, but
q.bias and the re-rank's sums run in another order: distances within rtol
1e-5, ids overlapping >= 0.99. K3g keeps a lane-min reservoir in the JAX
package (it has no RW=0), so it is held to overlap, and the port's K3g to
its own K3 and to exact answers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import distances as JD
from tpu_ann.ops import ivf_scan as JS
from tpu_ann.ops import sq as JSQ
from tpu_ann.ops.ivf_scan_pallas import grid2d_maxc as j_maxc
from tpu_ann.ops.ivf_scan_pallas import scan_invlists_fused as j_fused
from tpu_ann.ops.ivf_scan_pallas import scan_invlists_fused_grid as j_grid
from tpu_ann_torch.ops import distances as TD
from tpu_ann_torch.ops import ivf_scan as TS
from tpu_ann_torch.ops import ivf_scan_fused as F
from tpu_ann_torch.ops import sq as TSQ
from tpu_ann_torch.utils.datasets import SIFT1M_CALIBRATED, sift_surrogate
from torch_parity import assert_topk_equal

B, NLIST, K = 16, 24, 10
L2, IP = JD.METRIC_L2, JD.METRIC_INNER_PRODUCT


@pytest.fixture(scope="module")
def data():
    """SIFT-surrogate rows assigned to the first NLIST - 4 centroids, so the
    last 4 lists are empty (and still probed)."""
    x = sift_surrogate(2440, seed=11, **SIFT1M_CALIBRATED)
    xb, xt, xq = x[:2000], x[2000:2400], x[2400:]
    rs = np.random.RandomState(0)
    cent = xb[rs.choice(len(xb), NLIST, replace=False)]
    _, a = TD.knn(torch.from_numpy(xb), torch.from_numpy(cent[:NLIST - 4]), 1)
    return xb, xt, xq, cent, a[:, 0].numpy()


def _probes(xq, cent, nprobe, metric, drop=True):
    _, p = TD.knn(torch.from_numpy(xq), torch.from_numpy(cent), nprobe,
                  metric)
    p = p.numpy().astype(np.int32)
    if drop:
        p[::3, -1] = -1                  # -1 probes are skipped
    return p


def _affine(qtype, codec):
    """The SQ8 view's (bias, scale) for a qtype, as both indexes set it."""
    d = codec.d
    if qtype == TSQ.QT_8BIT_DIRECT:
        return np.zeros(d, np.float32), np.ones(d, np.float32)
    scale = (codec.vdiff / np.float32(256.0)).astype(np.float32)
    return (codec.vmin + np.float32(0.5) * scale).astype(np.float32), scale


def _views(data, qtype):
    """The same SQ8 stream in both packages: codes from each package's
    encoder, packed by each, viewed with the same affine."""
    xb, xt, _, _, assign = data
    codec = TSQ.train_sq(xt, qtype)
    jcodes = np.asarray(JSQ.sq_encode(jnp.asarray(xb),
                                      JSQ.train_sq(xt, qtype)))
    tcodes = TSQ.sq_encode(torch.from_numpy(xb), codec)
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    bias, scale = _affine(qtype, codec)
    jl = JS.sq8_view_from_codes(
        JS.pack_code_invlists(jcodes, np.arange(len(xb)), assign, NLIST, B),
        jnp.asarray(bias), jnp.asarray(scale))
    tl = TS.sq8_view_from_codes(
        TS.pack_code_invlists(tcodes, np.arange(len(xb)), assign, NLIST, B,
                              device="cpu"), bias, scale)
    return jl, tl


def _bf16_lists(data):
    xb, _, _, _, assign = data
    ids = np.arange(len(xb))
    return (JS.pack_invlists(xb, ids, assign, NLIST, block_size=B),
            TS.pack_invlists(xb, ids, assign, NLIST, block_size=B,
                             device="cpu"))


def _overlap(I0, I1):
    I0, I1 = np.asarray(I0), np.asarray(I1)
    return np.mean([len(set(a) & set(b)) / I0.shape[1]
                    for a, b in zip(I0, I1)])


def _same_on_common(D0, I0, D1, I1, rtol):
    for q in range(len(I0)):
        m0 = dict(zip(np.asarray(I0[q]).tolist(), np.asarray(D0[q])))
        m1 = dict(zip(np.asarray(I1[q]).tolist(), np.asarray(D1[q])))
        for i in (set(m0) & set(m1)) - {-1}:
            np.testing.assert_allclose(m1[i], m0[i], rtol=rtol)


@pytest.mark.parametrize("code_dtype", [np.uint8, np.float16])
def test_pack_code_invlists_matches_reference(data, code_dtype):
    xb, _, _, _, assign = data
    codes = (xb[:, :40] if code_dtype == np.float16
             else xb[:, :40].astype(np.uint8)).astype(code_dtype)
    jl = JS.pack_code_invlists(codes, np.arange(len(xb)), assign, NLIST, B)
    tl = TS.pack_code_invlists(codes, np.arange(len(xb)), assign, NLIST, B,
                               device="cpu")
    for name in ("codes", "ids", "list_block_start", "list_nblocks"):
        a, b = np.asarray(getattr(jl, name)), getattr(tl, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert (tl.list_nblocks.numpy()[-4:] == 0).all()
    assert (tl.list_block_start.numpy()[-4:] == tl.nblocks).all()
    assert (tl.ids.numpy()[-1] == -1).all()         # the dummy block
    with pytest.raises(ValueError):
        TS.pack_code_invlists(codes[:3], np.arange(3), [0, NLIST, 1], NLIST,
                              B, device="cpu")


@pytest.mark.parametrize("qtype", [TSQ.QT_8BIT, TSQ.QT_8BIT_DIRECT])
def test_sq8_view_matches_reference(data, qtype):
    jl, tl = _views(data, qtype)
    assert tl.codes.dtype == torch.uint8
    np.testing.assert_array_equal(tl.codes.numpy(), np.asarray(jl.data))
    np.testing.assert_array_equal(tl.sq_bias.numpy(), np.asarray(jl.sq_bias))
    np.testing.assert_array_equal(tl.sq_scale.numpy(),
                                  np.asarray(jl.sq_scale))
    np.testing.assert_allclose(tl.norms.numpy(), np.asarray(jl.norms),
                               rtol=1e-6)
    # rows_at dequantizes as code * scale + bias
    pos = torch.tensor([[0, 5], [17, 33]])
    rows, rn = tl.rows_at(pos)
    flat = np.asarray(jl.data).reshape(-1, tl.codes.shape[-1])
    ref = (flat[pos.numpy()].astype(np.float32) * np.asarray(jl.sq_scale)
           + np.asarray(jl.sq_bias))
    np.testing.assert_array_equal(rows.numpy(), ref)
    np.testing.assert_array_equal(rn.numpy(),
                                  tl.norms.view(-1)[pos].numpy())


def test_sq8_requantize_matches_reference(data):
    jf, tf = _bf16_lists(data)
    jl, tl = JS.sq8_requantize_invlists(jf), TS.sq8_requantize_invlists(tf)
    np.testing.assert_array_equal(tl.codes.numpy(), np.asarray(jl.data))
    np.testing.assert_allclose(tl.sq_bias.numpy(), np.asarray(jl.sq_bias),
                               rtol=1e-6)
    np.testing.assert_allclose(tl.sq_scale.numpy(), np.asarray(jl.sq_scale),
                               rtol=1e-6)
    np.testing.assert_allclose(tl.norms.numpy(), np.asarray(jl.norms),
                               rtol=1e-6)
    assert tl.ids is tf.ids


SCAN_CASES = [(TSQ.QT_8BIT_DIRECT, L2, 0), (TSQ.QT_8BIT_DIRECT, IP, 3 * K),
              (TSQ.QT_8BIT, L2, 0), (TSQ.QT_8BIT, IP, 3 * K)]


@pytest.mark.parametrize("qtype,metric,kp", SCAN_CASES)
def test_sq8_fused_scan_matches_reference_rw0(data, qtype, metric, kp):
    _, _, xq, cent, _ = data
    jl, tl = _views(data, qtype)
    probes = _probes(xq, cent, 6, metric)
    D0, I0, n0 = j_fused(jnp.asarray(xq), jnp.asarray(probes), jl, K,
                         metric, PT=32, CB=2, RW=0, kp=kp, interpret=True)
    D0, I0 = np.asarray(D0), np.asarray(I0)
    xq_t, pr_t = torch.from_numpy(xq), torch.from_numpy(probes)
    before = (F.LAUNCHES, F.LAUNCHES_SQ8)
    outs = [F.scan_invlists_fused(xq_t, pr_t, tl, K, metric, kp=kp),
            F.scan_invlists_fused_reference(xq_t, pr_t, tl, K, metric, kp=kp,
                                            pt=32)]
    assert (F.LAUNCHES, F.LAUNCHES_SQ8) == before     # CPU: plain version
    for D1, I1, n1 in outs:
        assert int(n1) == int(n0)
        if qtype == TSQ.QT_8BIT_DIRECT:
            np.testing.assert_array_equal(D1.numpy(), D0)
            np.testing.assert_array_equal(I1.numpy(), I0)
        else:
            assert _overlap(I0, I1) >= 0.99
            _same_on_common(D0, I0, D1.numpy(), I1.numpy(), rtol=1e-5)


@pytest.mark.parametrize("qtype,metric", [(q, m) for q, m, _ in SCAN_CASES])
def test_sq8_fused_scan_wide_k_matches_reference_rw0(data, qtype, metric):
    """k 100 (kp 106: K3-SQ8's lists in global memory on the card) against
    the JAX kernel with RW=0, held as at k 10: bit for bit on
    QT_8BIT_DIRECT, within rtol 1e-5 (ids overlapping >= 0.99) on
    QT_8BIT."""
    k = 100
    _, _, xq, cent, _ = data
    jl, tl = _views(data, qtype)
    probes = _probes(xq, cent, 6, metric)
    D0, I0, n0 = j_fused(jnp.asarray(xq), jnp.asarray(probes), jl, k,
                         metric, PT=32, CB=2, RW=0, interpret=True)
    D0, I0 = np.asarray(D0), np.asarray(I0)
    D1, I1, n1 = F.scan_invlists_fused(torch.from_numpy(xq),
                                       torch.from_numpy(probes), tl, k,
                                       metric)
    assert int(n1) == int(n0)
    if qtype == TSQ.QT_8BIT_DIRECT:
        np.testing.assert_array_equal(D1.numpy(), D0)
        np.testing.assert_array_equal(I1.numpy(), I0)
    else:
        assert _overlap(I0, I1) >= 0.99
        _same_on_common(D0, I0, D1.numpy(), I1.numpy(), rtol=1e-5)


def test_sq8_direct_equals_bf16_stream(data):
    """On integer data the lossless codes give the bf16 stream's result."""
    _, _, xq, cent, _ = data
    _, tl = _views(data, TSQ.QT_8BIT_DIRECT)
    _, tf = _bf16_lists(data)
    probes = torch.from_numpy(_probes(xq, cent, 5, L2))
    xq_t = torch.from_numpy(xq)
    D0, I0, _ = F.scan_invlists_fused(xq_t, probes, tf, K)
    D1, I1, _ = F.scan_invlists_fused(xq_t, probes, tl, K)
    assert torch.equal(D0, D1) and torch.equal(I0, I1)


def test_sq8_pairs_exact_topk(data):
    """The plain per-pair output on the uint8 stream is the exact top-kp of
    the folded scores qn + |x|^2 - 2 q'.code, ties to the lower position."""
    _, _, xq, cent, _ = data
    _, tl = _views(data, TSQ.QT_8BIT)
    probes = torch.from_numpy(_probes(xq[:12], cent, 3, L2))
    xq_t = torch.from_numpy(xq[:12])
    q, qn = F.fold_queries(xq_t, tl, False)
    assert q.dtype == torch.bfloat16
    torch.testing.assert_close(q, (xq_t * tl.sq_scale).bfloat16(), rtol=0,
                               atol=0)
    plan = F.plan_pairs(probes, tl, 8)
    kp = 7
    d, p = F.scan_pairs(q, qn, plan, tl, kp, False)
    npairs = probes.numel()
    pd = torch.empty(npairs, kp)
    pp = torch.empty(npairs, kp, dtype=torch.int32)
    pd[plan.order], pp[plan.order] = d[:npairs], p[:npairs]
    codes = tl.codes.view(-1, tl.codes.shape[-1]).float()
    ids, norms = tl.ids.view(-1), tl.norms.view(-1)
    for i, lst in enumerate(probes.reshape(-1).tolist()):
        qi = i // probes.shape[1]
        if lst < 0 or tl.list_nblocks[lst] == 0:
            assert torch.isinf(pd[i]).all() and (pp[i] == -1).all()
            continue
        s0 = int(tl.list_block_start[lst]) * B
        rows = torch.arange(s0, s0 + int(tl.list_nblocks[lst]) * B)
        rows = rows[ids[rows] >= 0]
        sc = torch.clamp(qn[qi] + norms[rows]
                         - 2.0 * (codes[rows] @ q[qi].float()), min=0.0)
        order = sorted(range(len(rows)),
                       key=lambda j: (float(sc[j]), int(rows[j])))[:kp]
        assert pp[i, :len(order)].tolist() == [int(rows[j]) for j in order]
        torch.testing.assert_close(pd[i, :len(order)], sc[order],
                                   rtol=1e-6, atol=1e-2)


# ---------------------------------------------------------------------------
# K3g
# ---------------------------------------------------------------------------

def _stream_pair(data, stream):
    return _bf16_lists(data) if stream == "bf16" else _views(
        data, TSQ.QT_8BIT)


@pytest.mark.parametrize("stream", ["bf16", "sq8"])
def test_grid_uncut_equals_k3(data, stream):
    """With grid2d_maxc's bound nothing is cut: the port's K3g equals its
    K3 bit for bit, and the JAX K3g (lossy reservoir) at overlap >= 0.99."""
    _, _, xq, cent, _ = data
    jl, tl = _stream_pair(data, stream)
    probes = _probes(xq, cent, 6, L2)
    mc = F.grid2d_maxc(tl, probes, PT=32, CB=8)
    assert mc == j_maxc(jl, probes, PT=32, CB=8)
    xq_t, pr_t = torch.from_numpy(xq), torch.from_numpy(probes)
    D3, I3, n3 = F.scan_invlists_fused(xq_t, pr_t, tl, K)
    Dg, Ig, ng = F.scan_invlists_fused_grid(xq_t, pr_t, tl, K, maxc=mc,
                                            PT=32, CB=8)
    assert torch.equal(D3, Dg) and torch.equal(I3, Ig)
    assert int(n3) == int(ng)
    D0, I0, n0 = j_grid(jnp.asarray(xq), jnp.asarray(probes), jl, K,
                        maxc=mc, PT=32, CB=8, interpret=True)
    assert int(n0) == int(ng)
    assert _overlap(I0, Ig.numpy()) >= 0.99
    _same_on_common(np.asarray(D0), np.asarray(I0), Dg.numpy(), Ig.numpy(),
                    rtol=1e-5)


def _cut_truth(tl, probes, plan, xq, rows_f32, k):
    """Exact top-k ids of each query over the rows its pairs reach in the
    cut plan (the f32 rows the re-rank uses)."""
    npairs = probes.numel()
    ps = torch.empty(npairs, dtype=torch.long)
    pe = torch.empty(npairs, dtype=torch.long)
    ps[plan.order] = plan.pstart[:npairs].long()
    pe[plan.order] = plan.pend[:npairs].long()
    ps, pe = ps.view(probes.shape), pe.view(probes.shape)
    ids = tl.ids.view(-1)
    out = []
    for q in range(len(xq)):
        rows = torch.cat([torch.arange(int(a) * B, int(b) * B)
                          for a, b in zip(ps[q], pe[q])] + [
                              torch.zeros(0, dtype=torch.long)])
        rows = rows[ids[rows] >= 0]
        dist = ((rows_f32[rows] - xq[q]) ** 2).sum(1)
        order = torch.sort(dist, stable=True)[1][:k]
        out.append(set(ids[rows[order]].tolist()))
    return out


@pytest.mark.parametrize("stream", ["bf16", "sq8"])
def test_grid_cut_exact_over_cut_ranges(data, stream):
    """A maxc that cuts ranges: the port's K3g is the scan of the cut plan
    (equal to the plain route over it), its pair ranges stay inside each
    tile's first maxc chunks, and its recall against the exact answer over
    those ranges is not below the JAX K3g's (and is >= 0.99)."""
    _, _, xq, cent, _ = data
    jl, tl = _stream_pair(data, stream)
    probes = _probes(xq, cent, 6, L2)
    full = F.grid2d_maxc(tl, probes, PT=32, CB=8)
    mc = 1
    assert mc < full
    xq_t, pr_t = torch.from_numpy(xq), torch.from_numpy(probes)
    plan = F.plan_pairs(pr_t, tl, 32)
    cut = F.truncate_plan(plan, mc, 8)
    c0 = plan.tile_bs.long() // 8
    assert (cut.tile_nb < plan.tile_nb).any()
    assert ((cut.tile_bs.long() + cut.tile_nb.long())
            <= (c0 + mc) * 8).all()
    assert (cut.pend.view(-1, 32).long() <= (c0 + mc)[:, None] * 8).all()
    assert (cut.pstart <= cut.pend).all()
    Dg, Ig, _ = F.scan_invlists_fused_grid(xq_t, pr_t, tl, K, maxc=mc,
                                           PT=32, CB=8)
    Dr, Ir, _ = F.scan_invlists_fused_reference(xq_t, pr_t, tl, K, maxc=mc,
                                                CB=8, pt=32)
    assert torch.equal(Dg, Dr) and torch.equal(Ig, Ir)
    rows_f32 = (tl.rows_at(torch.arange(tl.ids.numel()))[0]
                if stream == "sq8" else tl.data.view(-1, xq.shape[1]))
    truth = _cut_truth(tl, pr_t, cut, xq_t, rows_f32, K)
    _, I0, _ = j_grid(jnp.asarray(xq), jnp.asarray(probes), jl, K, maxc=mc,
                      PT=32, CB=8, interpret=True)

    def recall(I):
        # queries whose every pair was cut away have no answer
        return (sum(len(set(np.asarray(I[q]).tolist()) & truth[q])
                    for q in range(len(xq)))
                / sum(len(t) for t in truth))

    for q in range(len(xq)):
        if not truth[q]:
            assert (Ig[q] == -1).all()
    r0, r1 = recall(np.asarray(I0)), recall(Ig.numpy())
    assert r1 >= r0 and r1 >= 0.99, (r1, r0)


def test_grid_ignores_rw(data):
    """RW is accepted and ignored: any RW gives the same result."""
    _, _, xq, cent, _ = data
    _, tl = _views(data, TSQ.QT_8BIT_DIRECT)
    probes = torch.from_numpy(_probes(xq[:8], cent, 4, IP))
    xq_t = torch.from_numpy(xq[:8])
    a = F.scan_invlists_fused_grid(xq_t, probes, tl, K, IP, maxc=2, RW=0)
    b = F.scan_invlists_fused_grid(xq_t, probes, tl, K, IP, maxc=2, RW=512)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
