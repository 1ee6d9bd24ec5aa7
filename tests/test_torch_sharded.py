"""Port twins of tests/test_sharded.py: tpu_ann_torch.parallel on a 2 x 2
mesh (2 shards x 2 replicas) against tpu_ann.parallel on a 2 x 2 mesh of
four of the conftest's eight CPU devices.

The port's mesh is a gloo world of 4 CPU processes, spawned once for the
module (tests/torch_sharded_world.py): it runs every scenario once and
writes each rank's results, and the tests assert on them. The world has a
deadline (a timeout on the process group, a join with a limit that kills
the children), so a hung collective fails the tests.

Tolerances: integer-valued data give ids and distances equal bit for bit;
float data equal ids and distances within rtol 1e-5 (the libraries sum in
other orders); k-means centroids within 1e-5; every rank's result equals
rank 0's."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ann.ops import distances as JD
from tpu_ann.ops import ivf_scan as JS
from tpu_ann.ops import pq as JPQ
from tpu_ann.parallel import make_mesh as j_make_mesh
from tpu_ann.parallel import sharded as JP
from tpu_ann_torch.ops import ivf_scan as TS
from tpu_ann_torch.ops import topk as TK
from torch_parity import assert_topk_equal
from torch_sharded_world import sharded_scenarios, spawn_world

S = 2           # shards


def _pq_inputs(rs, nbits):
    """The reference test's PQ data (1024 rows, 12 lists, M 4), its codes
    cut into S row partitions, each packed with global ids by both
    packages (the JAX packs padded to one block count and stacked)."""
    n, d, nlist, nq, k, M = 1024, 16, 12, 8, 5, 4
    xb = rs.rand(n, d).astype(np.float32)
    xq = rs.rand(nq, d).astype(np.float32)
    cent = xb[rs.choice(n, nlist, replace=False)]
    _, assign = JD.knn(jnp.asarray(xb), jnp.asarray(cent), 1)
    assign = np.asarray(assign)[:, 0]
    pqc = JPQ.train_pq(xb - cent[assign], M, nbits)
    books = np.asarray(pqc.centroids)
    codes = np.asarray(JPQ.pq_encode(jnp.asarray(xb - cent[assign]),
                                     jnp.asarray(books)))
    if nbits == 4:
        codes = np.asarray(JPQ.pack_codes_4bit(jnp.asarray(codes)))
    cd, probes = JD.knn(jnp.asarray(xq), jnp.asarray(cent), 6)
    shards, jpacks = [], []
    per = n // S
    for s in range(S):
        lo, hi = s * per, (s + 1) * per
        tp = TS.pack_code_invlists(codes[lo:hi], np.arange(lo, hi),
                                   assign[lo:hi], nlist, block_size=16,
                                   device="cpu")
        shards.append({"codes": tp.codes.numpy(), "ids": tp.ids.numpy(),
                       "lbs": tp.list_block_start.numpy(),
                       "lnb": tp.list_nblocks.numpy()})
        jpacks.append(JS.pack_code_invlists(
            codes[lo:hi], np.arange(lo, hi), assign[lo:hi], nlist,
            block_size=16))
    mnb = max(p.max_nblocks_per_list for p in jpacks)
    nbmax = max(p.codes.shape[0] for p in jpacks)
    stacked = (
        np.stack([np.pad(np.asarray(p.codes),
                         ((0, nbmax - p.codes.shape[0]), (0, 0), (0, 0)))
                  for p in jpacks]),
        np.stack([np.pad(np.asarray(p.ids),
                         ((0, nbmax - p.ids.shape[0]), (0, 0)),
                         constant_values=-1) for p in jpacks]),
        np.stack([np.asarray(p.list_block_start) for p in jpacks]),
        np.stack([np.asarray(p.list_nblocks) for p in jpacks]))
    return {"xq": xq, "probes": np.asarray(probes, np.int32),
            "cd": np.asarray(cd, np.float32), "books": books, "cent": cent,
            "k": k, "mnb": mnb, "shards": shards, "jax_stacked": stacked}


def _ivf_inputs(rs):
    """Integer-valued rows (bf16 products and f32 sums exact): S shards of
    1024 rows, 16 lists, 32 queries at nprobe 4, packed with global ids."""
    n_per, d, nlist, nq, k = 1024, 32, 16, 32, 5
    xb = rs.randint(0, 128, size=(S * n_per, d)).astype(np.float32)
    xq = rs.randint(0, 128, size=(nq, d)).astype(np.float32)
    cent = xb[rs.choice(len(xb), nlist, replace=False)]
    _, assign = JD.knn(jnp.asarray(xb), jnp.asarray(cent), 1)
    assign = np.asarray(assign)[:, 0]
    _, probes = JD.knn(jnp.asarray(xq), jnp.asarray(cent), 4)
    shards, jpacks = [], []
    for s in range(S):
        lo, hi = s * n_per, (s + 1) * n_per
        tp = TS.pack_invlists(xb[lo:hi], np.arange(lo, hi), assign[lo:hi],
                              nlist, block_size=16, device="cpu")
        shards.append({"data": tp.data.numpy(), "ids": tp.ids.numpy(),
                       "norms": tp.norms.numpy(),
                       "lbs": tp.list_block_start.numpy(),
                       "lnb": tp.list_nblocks.numpy()})
        jpacks.append(JS.pack_invlists(xb[lo:hi], np.arange(lo, hi),
                                       assign[lo:hi], nlist, block_size=16))
    mnb = max(p.max_nblocks_per_list for p in jpacks)
    nbmax = max(p.data.shape[0] for p in jpacks)

    def pad(a, fill=0):
        a = np.asarray(a)
        return np.pad(a, ((0, nbmax - a.shape[0]),) + ((0, 0),) *
                      (a.ndim - 1), constant_values=fill)

    stacked = (np.stack([pad(p.data) for p in jpacks]),
               np.stack([pad(p.ids, -1) for p in jpacks]),
               np.stack([pad(p.norms) for p in jpacks]),
               np.stack([np.asarray(p.list_block_start) for p in jpacks]),
               np.stack([np.asarray(p.list_nblocks) for p in jpacks]))
    return {"xb": xb, "xq": xq, "probes": np.asarray(probes, np.int32),
            "k": k, "mnb": mnb, "shards": shards, "jax_stacked": stacked}


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(42)
    inp = {
        # 1001 rows: the shards' padding is masked by valid_n
        "knn": {"xq": rs.rand(16, 24).astype(np.float32),
                "xb": rs.rand(1001, 24).astype(np.float32), "k": 10},
        "knn_ip": {"xq": rs.rand(8, 16).astype(np.float32),
                   "xb": rs.rand(256, 16).astype(np.float32), "k": 5},
    }
    x = rs.rand(800, 16).astype(np.float32)
    inp["kmeans_iter"] = {"x": x, "cent": x[:10].copy(), "k": 10}
    inp["kmeans_distributed"] = {
        "x": rs.rand(2000, 16).astype(np.float32), "k": 16, "niter": 6}
    inp["pq8"] = _pq_inputs(rs, 8)
    inp["pq4"] = _pq_inputs(rs, 4)
    inp["ivf"] = _ivf_inputs(rs)
    r4 = np.random.RandomState(4)
    n, d, nq, R = 256, 16, 8, 12
    inp["refine"] = {"xb": r4.randn(n, d).astype(np.float32),
                     "xq": r4.randn(nq, d).astype(np.float32),
                     "cand": r4.randint(0, n, size=(nq, R)).astype(np.int32),
                     "k": 5, "k_wide": 15}
    inp["refine"]["cand"][:, -1] = -1
    return inp


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The four ranks' results (a list in rank order)."""
    root = tmp_path_factory.mktemp("world")
    path = str(root / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump({key: {kk: v for kk, v in a.items()
                           if kk != "jax_stacked"}
                     for key, a in inputs.items()}, f)
    codes, hung = spawn_world(sharded_scenarios, 4, (path, str(root)),
                              timeout=120)
    errs = [open(root / f"rank{r}.err").read() for r in range(4)
            if (root / f"rank{r}.err").exists()]
    assert not hung, "the world hung and was killed"
    assert codes == [0] * 4, (codes, errs)
    out = []
    for r in range(4):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(n_shards=S, n_replicas=2)


def _same_on_every_rank(world, key):
    for r in range(1, 4):
        for a, b in zip(world[0][key], world[r][key]):
            np.testing.assert_array_equal(a, b)
    return world[0][key]


def test_devices_available(world):
    """Four ranks; rank r at replica r // 2 and shard r % 2."""
    assert [(w["rank"], w["replica"], w["shard"]) for w in world] == [
        (0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]


def test_sharded_knn_matches_local(world, inputs, jmesh):
    a = inputs["knn"]
    Dv, Iv = _same_on_every_rank(world, "knn")
    Dj, Ij = JP.sharded_knn(jnp.asarray(a["xq"]),
                            jnp.asarray(JP.shard_rows(a["xb"], S)), a["k"],
                            mesh=jmesh, valid_n=jnp.int32(len(a["xb"])))
    np.testing.assert_array_equal(Iv, np.asarray(Ij))
    np.testing.assert_allclose(Dv, np.asarray(Dj), rtol=1e-5, atol=1e-6)
    assert (Iv < len(a["xb"])).all()     # no padding row
    Dr, Ir = JD.knn(jnp.asarray(a["xq"]), jnp.asarray(a["xb"]), a["k"])
    np.testing.assert_array_equal(Iv, np.asarray(Ir))
    # nq 7 over 2 replicas is refused on every rank
    assert all("divide" in w["knn_nq7"] for w in world)


def test_sharded_knn_ip(world, inputs, jmesh):
    a = inputs["knn_ip"]
    Dv, Iv = _same_on_every_rank(world, "knn_ip")
    Dj, Ij = JP.sharded_knn(jnp.asarray(a["xq"]), jnp.asarray(a["xb"]),
                            a["k"], metric=JD.METRIC_INNER_PRODUCT,
                            mesh=jmesh)
    np.testing.assert_array_equal(Iv, np.asarray(Ij))
    np.testing.assert_allclose(Dv, np.asarray(Dj), rtol=1e-5)


def test_sharded_kmeans_iter_matches_serial(world, inputs, jmesh):
    a = inputs["kmeans_iter"]
    new_c, counts, obj = _same_on_every_rank(world, "kmeans_iter")
    jc, jn, jo = JP.sharded_kmeans_iter(jnp.asarray(a["x"]),
                                        jnp.asarray(a["cent"]), a["k"],
                                        mesh=jmesh)
    np.testing.assert_array_equal(counts, np.asarray(jn))
    np.testing.assert_allclose(new_c, np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(obj), float(jo), rtol=1e-5)
    # the serial oracle of the reference test
    dis, assign = JD.knn(jnp.asarray(a["x"]), jnp.asarray(a["cent"]), 1)
    ref_n = np.bincount(np.asarray(assign)[:, 0], minlength=a["k"])
    np.testing.assert_array_equal(counts, ref_n)


def test_kmeans_distributed(world, inputs, jmesh):
    a = inputs["kmeans_distributed"]
    cent = world[0]["kmeans_distributed"]
    for w in world[1:]:
        np.testing.assert_array_equal(w["kmeans_distributed"], cent)
    assert cent.shape == (16, 16)
    jc = JP.kmeans_distributed(a["x"], a["k"], mesh=jmesh,
                               niter=a["niter"])
    np.testing.assert_allclose(cent, jc, rtol=0, atol=1e-5)
    _, ia = JD.knn(jnp.asarray(a["x"]), jnp.asarray(cent), 1)
    assert (np.bincount(np.asarray(ia)[:, 0], minlength=16) > 0).all()


def test_kmeans_checkpoint_resume(tmp_path):
    """Twin of the reference's test: the checkpoint is rewound to
    iteration 2 and the run resumes for iterations 3..5; on the same file
    the reference resumes to centroids within 1e-5 (data without a cluster
    split, so no random draw)."""
    import shutil

    from tpu_ann.ops import kmeans as JK
    from tpu_ann_torch.ops.kmeans import ClusteringParameters, kmeans

    x = np.random.RandomState(7).rand(1000, 8).astype(np.float32)
    ck = str(tmp_path / "km.pkl")
    cp = ClusteringParameters(niter=6, seed=5)
    c1, st1 = kmeans(x, 8, cp, checkpoint=ck, device="cpu")
    assert os.path.exists(ck) and len(st1) == 6
    with open(ck, "rb") as f:
        st = pickle.load(f)
    st["iter"] = 2
    with open(ck, "wb") as f:
        pickle.dump(st, f)
    shutil.copy(ck, ck + ".j")
    c2, st2 = kmeans(x, 8, cp, checkpoint=ck, device="cpu")
    assert c2.shape == (8, 8)
    assert len(st2) == 3  # iters 3..5 only
    cj, stj = JK.kmeans(x, 8, JK.ClusteringParameters(niter=6, seed=5),
                        checkpoint=ck + ".j")
    assert [s.nsplit for s in st2] == [s.nsplit for s in stj] == [0] * 3
    np.testing.assert_allclose(c2, cj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("nbits", [8, 4])
def test_sharded_ivf_scan_pq_matches_single(world, inputs, jmesh, nbits):
    """The sharded PQ / x4fs ADC scan equals the port's one-process scan
    over the union pack (global row ids); at 8 bits it equals the
    reference's sharded scan over the same packs too. At 4 bits the port
    sums the f32 table, where the reference rounds it to bf16 (ROADMAP:
    held to an overlap only)."""
    a = inputs[f"pq{nbits}"]
    Dv, Iv = _same_on_every_rank(world, f"pq{nbits}")
    packs = [TS.PackedCodeInvLists(
        codes=torch.from_numpy(s["codes"]), ids=torch.from_numpy(s["ids"]),
        list_block_start=torch.from_numpy(s["lbs"]),
        list_nblocks=torch.from_numpy(s["lnb"])) for s in a["shards"]]
    parts = [TS.scan_invlists_pq(
        torch.from_numpy(a["xq"]), torch.from_numpy(a["probes"]).long(), p,
        torch.from_numpy(a["books"]), torch.from_numpy(a["cent"]), a["k"],
        max_nblocks=a["mnb"], packed4=nbits == 4) for p in packs]
    D1, I1 = TK.merge_topk_axis(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1].long() for p in parts]),
                                a["k"])
    np.testing.assert_array_equal(Iv, I1.numpy())
    np.testing.assert_array_equal(Dv, D1.numpy())
    cs, ids, lbs, lnb = (jnp.asarray(v) for v in a["jax_stacked"])
    Dj, Ij = JP.sharded_ivf_scan_pq(
        jnp.asarray(a["xq"]), jnp.asarray(a["probes"]), jnp.asarray(a["cd"]),
        cs, ids, lbs, lnb, jnp.asarray(a["books"]), jnp.asarray(a["cent"]),
        a["k"], max_nblocks=a["mnb"], packed4=nbits == 4, mesh=jmesh)
    if nbits == 8:
        np.testing.assert_array_equal(Iv, np.asarray(Ij))
        np.testing.assert_allclose(Dv, np.asarray(Dj), rtol=1e-5, atol=1e-6)
    else:
        ov = np.mean([len(set(a0) & set(a1)) / a["k"]
                      for a0, a1 in zip(np.asarray(Ij), Iv)])
        assert ov >= 0.9, ov


def test_sharded_fused_scan_matches_plain(world, inputs, jmesh):
    """Integer-valued rows: the fused route (K3's plain version on CPU
    tensors) equals the plain sharded route bit for bit, and both equal
    the reference's plain sharded scan (ties either way)."""
    a = inputs["ivf"]
    D0, I0 = _same_on_every_rank(world, "ivf_fused0")
    D1, I1 = _same_on_every_rank(world, "ivf_fused1")
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)
    Dj, Ij = JP.sharded_ivf_scan(
        jnp.asarray(a["xq"]), jnp.asarray(a["probes"]),
        *(jnp.asarray(v) for v in a["jax_stacked"]), a["k"], mesh=jmesh,
        max_nblocks=a["mnb"])
    assert_topk_equal(np.asarray(Dj), np.asarray(Ij), D0, I0)
    assert (I0 >= 0).all()


def test_sharded_refine(world, inputs, jmesh):
    """sharded_refine equals the reference's on the same candidates; at k
    above the R candidates the port pads to (nq, k) with (inf, -1), where
    the reference returns R columns."""
    a = inputs["refine"]
    args = (jnp.asarray(a["xq"]), jnp.asarray(a["cand"]),
            jnp.asarray(a["xb"]))
    Dv, Iv = _same_on_every_rank(world, "refine5")
    Dj, Ij = JP.sharded_refine(*args, 5, mesh=jmesh)
    np.testing.assert_array_equal(Iv, np.asarray(Ij))
    np.testing.assert_allclose(Dv, np.asarray(Dj), rtol=1e-5, atol=1e-6)
    Dv, Iv = _same_on_every_rank(world, "refine15")
    R = a["cand"].shape[1]
    Dj, Ij = JP.sharded_refine(*args, 15, mesh=jmesh)
    assert Dv.shape == (8, 15) and np.asarray(Dj).shape == (8, R)
    np.testing.assert_allclose(Dv[:, :R], np.asarray(Dj), rtol=1e-5,
                               atol=1e-6)
    valid = np.asarray(Ij) >= 0
    np.testing.assert_array_equal(Iv[:, :R][valid], np.asarray(Ij)[valid])
    assert (Iv[:, R:] == -1).all() and np.isinf(Dv[:, R:]).all()
    # the oracle of the reference test: exact L2 over each candidate set
    for q in range(len(a["xq"])):
        ids = a["cand"][q][a["cand"][q] >= 0]
        dis = ((a["xq"][q][None] - a["xb"][ids]) ** 2).sum(1)
        assert set(Iv[q][Iv[q] >= 0]) == set(ids)
        np.testing.assert_allclose(np.sort(Dv[q][Iv[q] >= 0]),
                                   np.sort(dis), rtol=1e-5)


def test_mesh_without_process_group(inputs):
    """Without a process group only a 1 x 1 mesh exists, and there every
    function runs with no collective: sharded_knn is the exact k-NN."""
    from tpu_ann_torch import parallel as P

    with pytest.raises(ValueError):
        P.make_mesh(2, 2, device="cpu")
    mesh = P.make_mesh(1, device="cpu")
    assert (mesh.rank, mesh.shard, mesh.replica) == (0, 0, 0)
    assert mesh.shard_group is None and not mesh.distributed
    a = inputs["knn"]
    Dv, Iv = P.sharded_knn(a["xq"], a["xb"], a["k"], mesh=mesh)
    Dr, Ir = JD.knn(jnp.asarray(a["xq"]), jnp.asarray(a["xb"]), a["k"])
    np.testing.assert_array_equal(Iv.numpy(), np.asarray(Ir))
    np.testing.assert_allclose(Dv.numpy(), np.asarray(Dr), rtol=1e-5,
                               atol=1e-6)
