"""The eight demos of tpu_ann_torch (tpu_ann_torch/demos/) on the CPU.

Each demo's ``main(device="cpu", ...)`` runs at a tiny size (nb <= 5000,
d <= 32) with its own asserts, and its returned numbers are checked. Then
the parity checks against the JAX package's demos and functions:
- a sqlite store written by the JAX demo's SQLiteInvertedLists is merged
  and searched by the port, and a store the port wrote is merged and
  searched by the JAX package: ids equal to the in-memory index's (up to
  ties; integer data, exact scores in both packages);
- the paged demo's directory, built by the JAX package's
  IndexIVFFlatPaged (its Pallas kernel in interpret mode, as
  tests/test_ivf_paged.py runs it), reopened by the port's demo with its
  hot tier and searched at the same nprobe: (D, I) equal, up to ties, to
  the JAX scan with an exact per-pair top-kp (RW=0) on integer data;
- the residual-quantizer demo's PQ and RQ reconstruction MSE within 1% of
  the JAX functions' on the same data.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpu_ann_torch.demos import (demo_auto_tune, demo_client_server_ivf,
                                 demo_custom_invlists, demo_ondisk_ivf,
                                 demo_paged_outofcore, demo_qinco,
                                 demo_residual_quantizer,
                                 demo_sharded_search)
from tpu_ann_torch.utils.convert import ivf_flat_from_reference
from torch_parity import assert_topk_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEMOS = {
    "custom_invlists": (demo_custom_invlists, dict(
        d=32, nt=2000, nb=5000, nq=50, nlist=16, nprobe=4)),
    "ondisk_ivf": (demo_ondisk_ivf, dict(
        d=32, nt=2000, nb=4000, nq=50, nlist=16, M=8, nshard=2, nprobe=4)),
    "paged_outofcore": (demo_paged_outofcore, dict(
        d=32, nt=2000, nb=5000, nq=50, nlist=16, nprobe=4)),
    "auto_tune": (demo_auto_tune, dict(
        d=32, nt=2000, nb=5000, nq=50, spec="IVF16_HNSW8,Flat")),
    "client_server_ivf": (demo_client_server_ivf, dict(
        d=16, nb=4000, nt=2000, nq=50, timeout_s=120.0)),
    "sharded_search": (demo_sharded_search, dict(
        nb=4000, nq=100, d=32, nc=16, timeout_s=120.0)),
    "residual_quantizer": (demo_residual_quantizer, dict(
        d=16, M=2, nbits=6, nb=3000, nt=2000, nq=50)),
    "qinco": (demo_qinco, dict(nb=1000, nq=100)),
}


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_runs_small(name):
    mod, kw = DEMOS[name]
    out = mod.main(device="cpu", **kw)
    assert isinstance(out, dict) and out
    if name == "custom_invlists":
        assert out == {"stored": 5000, "merged": 5000, "intersection": 1.0}
    elif name == "ondisk_ivf":
        assert out["merged"] == 4000 and out["recall"] > 0.5
    elif name == "paged_outofcore":
        assert out["recall"] > 0.85
    elif name == "auto_tune":
        assert out["points"] > len(out["front"]) > 0
        assert out["best_recall"] > 0.9
    elif name == "client_server_ivf":
        assert out["recall"] > 0.9 and out["ntotal"] == 4000
        assert out["server_k3_launches"] == 0      # plain version on CPU
    elif name == "sharded_search":
        assert out["world"] == 4 and out["agree"] == 1.0
    elif name == "residual_quantizer":
        assert out["rq_mse"] < out["pq_mse"] and out["recall"] > 0.5
    else:
        assert out["self_hit"] > 0.95 and out["qinco_mse"] > out["pq_mse"]


# -- parity with the JAX package ----------------------------------------------

def _reference_sqlite_lists():
    sys.path.insert(0, os.path.join(ROOT, "demos"))
    from demo_custom_invlists import SQLiteInvertedLists

    return SQLiteInvertedLists


def _export(idx) -> dict:
    il = idx.invlists
    return {"d": idx.d, "metric": idx.metric_type, "nlist": idx.nlist,
            "ntotal": idx.ntotal,
            "vectors": np.asarray(idx.quantizer.vectors),
            "data": np.asarray(il.data), "ids": np.asarray(il.ids),
            "norms": np.asarray(il.norms),
            "list_block_start": np.asarray(il.list_block_start),
            "list_nblocks": np.asarray(il.list_nblocks),
            "ids_flat": np.asarray(idx._ids_flat)}


@pytest.fixture(scope="module")
def ivf_pair():
    """A JAX IVF16,Flat over integer data and the port's copy of it."""
    from tpu_ann import index_factory

    rs = np.random.RandomState(3)
    xb = rs.randint(0, 32, (4000, 16)).astype(np.float32)
    xq = rs.randint(0, 32, (40, 16)).astype(np.float32)
    jidx = index_factory(16, "IVF16,Flat")
    jidx.cp.niter = 4
    jidx.train(xb[:2000])
    jidx.add_with_ids(xb, 10 + np.arange(len(xb), dtype=np.int64))
    jidx.nprobe = 4
    tidx = ivf_flat_from_reference(_export(jidx), device="cpu")
    tidx.nprobe = 4
    return jidx, tidx, xq


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sqlite_store_crosses_packages(ivf_pair, tmp_path, writer):
    from tpu_ann import index_factory
    from tpu_ann import read_index as j_read
    from tpu_ann.utils.contrib import get_invlist as j_get_invlist
    from tpu_ann.utils.invlists_io import merge_ondisk as j_merge

    jidx, tidx, xq = ivf_pair
    RefLists = _reference_sqlite_lists()
    db = str(tmp_path / "kv.sqlite")
    if writer == "reference":
        kv = RefLists(db, nlist=16, width=16, create=True)
        for l in range(16):
            ids, payload = j_get_invlist(jidx, l)
            kv.put_list(l, np.asarray(payload), np.asarray(ids))
        kv.commit()
        kv.conn.close()
        src = demo_custom_invlists.SQLiteInvertedLists(db)
        n, merged = demo_custom_invlists.merge_store(
            tidx, src, str(tmp_path / "m.tann"), device="cpu", nprobe=4)
        src.close()
        D0, I0 = tidx.search(xq, 10)
    else:
        demo_custom_invlists.store_lists(tidx, db).close()
        src = RefLists(db)
        shell = index_factory(16, "IVF16,Flat")
        shell.quantizer = jidx.quantizer
        shell.is_trained = True
        n = j_merge(shell, [src], str(tmp_path / "m.tann"))
        src.conn.close()
        merged = j_read(str(tmp_path / "m.tann"), mmap=True)
        merged.nprobe = 4
        D0, I0 = jidx.search(xq, 10)
    assert n == 4000
    D1, I1 = merged.search(xq, 10)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), np.asarray(D1),
                      np.asarray(I1))


def test_paged_directory_of_reference_searched_by_port(tmp_path):
    from tpu_ann.models.ivf_paged import IndexIVFFlatPaged as JPaged
    from tpu_ann.ops import distances as JD
    from tpu_ann.ops import ivf_scan_paged as JP

    rs = np.random.RandomState(8)
    xb = rs.randint(0, 64, (3000, 32)).astype(np.float32)
    xq = rs.randint(0, 64, (40, 32)).astype(np.float32)
    path = str(tmp_path / "big.paged")
    jidx = JPaged(32, nlist=16, path=path)
    jidx.scan_interpret = True
    jidx.cp_niter = 5
    jidx.train(xb[:2000])
    jidx.add(xb)
    jidx.save()
    _, probes = JD.knn(xq, jidx.centroids, 4)
    D0, I0, _ = JP.scan_invlists_paged(
        xq, np.asarray(probes, np.int32), jidx.invlists, 10,
        refine=jidx.refine, RW=0, interpret=True)

    idx = demo_paged_outofcore.reopen(path, nprobe=4, device="cpu")
    assert idx.resident_blocks == idx.invlists.nblocks // 4 > 0
    D1, I1 = idx.search(xq, 10)
    assert_topk_equal(np.asarray(D0), np.asarray(I0), D1, I1)


def test_residual_quantizer_mse_matches_reference():
    import jax.numpy as jnp

    from tpu_ann.ops.pq import pq_decode, pq_encode, train_pq
    from tpu_ann.ops.rq import rq_decode, rq_encode, train_rq

    xt, xb, _ = demo_residual_quantizer.make_data(16, 3000, 2000, 10)
    rq_t, pq_t = demo_residual_quantizer.codec_mse(xt, xb, M=2, nbits=6,
                                                   device="cpu")
    rq = train_rq(xt, M=2, nbits=6, niter=8)
    books = jnp.asarray(rq.codebooks)
    rq_j = float(np.mean((xb - np.asarray(rq_decode(
        rq_encode(jnp.asarray(xb), books, beam=8), books))) ** 2))
    pq = train_pq(xt, M=2, nbits=6, niter=8)
    cent = jnp.asarray(pq.centroids)
    pq_j = float(np.mean((xb - np.asarray(pq_decode(
        pq_encode(jnp.asarray(xb), cent), cent))) ** 2))
    assert rq_t == pytest.approx(rq_j, rel=0.01)
    assert pq_t == pytest.approx(pq_j, rel=0.01)
    assert rq_t < pq_t and rq_j < pq_j
