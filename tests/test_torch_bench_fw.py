"""The descriptor-driven benchmark framework of tpu_ann_torch
(utils/bench_fw.py) on the CPU, against the JAX package's: descriptor
names, the synthetic vector sets, the ground truth, the staged train /
build / sweep with its on-disk cache, the Pareto filter and the
Optimizer's stages.

The port's BenchmarkIO runs its stages on ``device="cpu"``. Both packages
name their artifacts alike and write them in the same formats (.npy, the
index file, JSON rows), so a reference Benchmark over the port's cache
reuses every artifact. Tolerances: names, vector sets and the Pareto
filter are equal; the ground truth ids equal the reference's where the
exact f64 distances of the two differ by more than 1e-5 relative (float
data: only near-ties may swap); a second run reads every cached artifact
and returns the same rows."""

import json
import os

import numpy as np
import pytest
import torch

from tpu_ann.utils import bench_fw as JB
from tpu_ann_torch.utils.bench_fw import (Benchmark, BenchmarkIO,
                                          IndexDescriptor)
from tpu_ann_torch.utils import bench_fw as TB


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _descs(mod, d=32, seed=77, nt=4000, nb=8000, nq=100):
    return (mod.DatasetDescriptor(namespace="syn", tablename=f"{d}_{seed}",
                                  num_vectors=nt, split="train"),
            mod.DatasetDescriptor(namespace="syn", tablename=f"{d}_{seed}",
                                  num_vectors=nb, split="db"),
            mod.DatasetDescriptor(namespace="syn", tablename=f"{d}_{seed}",
                                  num_vectors=nq, split="q"))


def _index_descs(mod):
    return [mod.IndexDescriptor(d=32, factory="IVF32,Flat",
                                search_params={"nprobe": [1, 4, 16]}),
            mod.IndexDescriptor(d=32, factory="Flat")]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


@pytest.fixture(scope="module")
def bm(cache):
    tr, db, q = _descs(TB)
    return Benchmark(io=BenchmarkIO(path=cache, device="cpu"),
                     training_vectors=tr, database_vectors=db,
                     query_vectors=q, index_descs=_index_descs(TB), k=10)


def test_descriptor_names_match_the_reference():
    for t, j in zip(_descs(TB), _descs(JB)):
        assert t.get_filename() == j.get_filename()
        assert t.get_filename("p") == j.get_filename("p")
    for t, j in zip(_index_descs(TB), _index_descs(JB)):
        assert t.get_name() == j.get_name()
        assert t.param_grid() == j.param_grid()
    cp = IndexDescriptor(d=32, factory="HNSW32",
                         construction_params={"efConstruction": 64})
    assert cp.get_name() == JB.IndexDescriptor(
        d=32, factory="HNSW32",
        construction_params={"efConstruction": 64}).get_name()


def test_datasets_and_ground_truth(bm, tmp_path):
    jio = JB.BenchmarkIO(path=str(tmp_path))
    for t, j in zip(_descs(TB), _descs(JB)):
        np.testing.assert_array_equal(bm.io.get_dataset(t),
                                      jio.get_dataset(j))
    tr, db, q = _descs(TB)
    xb, xq = bm.io.get_dataset(db), bm.io.get_dataset(q)
    assert xb.shape == (8000, 32) and np.abs(xb[:100] - xq).sum() > 1.0
    gt = bm.io.get_ground_truth(db, q, 10, "L2")
    gj = jio.get_ground_truth(_descs(JB)[1], _descs(JB)[2], 10, "L2")
    x64, q64 = xb.astype(np.float64), xq.astype(np.float64)
    d_t = ((q64[:, None] - x64[gt]) ** 2).sum(-1)
    d_j = ((q64[:, None] - x64[gj]) ** 2).sum(-1)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5)
    assert (gt == gj).mean() > 0.99


def test_benchmark_stages_and_results(bm):
    res = bm.benchmark(result_file="result.json")
    ivf = bm.index_descs[0].get_name()
    assert res["indices"][ivf]["ntotal"] == 8000
    assert len(res["experiments"]) == 4
    recs = [res["experiments"][f"{ivf}knn.nprobe={p}"]["recall"]
            for p in (1, 4, 16)]
    assert recs[0] <= recs[1] <= recs[2]
    flat = bm.index_descs[1].get_name()
    assert res["experiments"][f"{flat}knn.default"]["recall"] >= 0.999
    opt = res["optimal"]
    assert opt and max(o["recall"] for o in opt) == max(
        e["recall"] for e in res["experiments"].values())
    with open(os.path.join(bm.io.path, "result.json")) as f:
        assert json.load(f)["indices"]
    for row in res["experiments"].values():
        assert row["qps"] > 0 and row["time"] > 0


def test_artifacts_are_cached_and_reused(bm):
    """A second benchmark() (a fresh BenchmarkIO over the same directory)
    writes nothing and returns the same rows; so does the reference's
    Benchmark over the port's cache."""
    first = bm.benchmark()
    stamps = {f: os.path.getmtime(os.path.join(bm.io.path, f))
              for f in os.listdir(bm.io.path)}
    bm2 = Benchmark(io=BenchmarkIO(path=bm.io.path, device="cpu"),
                    training_vectors=bm.training_vectors,
                    database_vectors=bm.database_vectors,
                    query_vectors=bm.query_vectors,
                    index_descs=bm.index_descs, k=10)
    second = bm2.benchmark()
    assert second["experiments"] == first["experiments"]
    tr, db, q = _descs(JB)
    jbm = JB.Benchmark(io=JB.BenchmarkIO(path=bm.io.path),
                       training_vectors=tr, database_vectors=db,
                       query_vectors=q, index_descs=_index_descs(JB), k=10)
    assert jbm.benchmark()["experiments"] == first["experiments"]
    assert {f: os.path.getmtime(os.path.join(bm.io.path, f))
            for f in os.listdir(bm.io.path)} == stamps


def test_filter_results_pareto():
    rows = [
        {"factory": "A", "recall": 0.90, "time": 1.0, "code_size": 8},
        {"factory": "B", "recall": 0.95, "time": 2.0, "code_size": 8},
        {"factory": "C", "recall": 0.90, "time": 3.0, "code_size": 8},
        {"factory": "D", "recall": 0.99, "time": 2.0, "code_size": 64},
        {"factory": "Flat", "recall": 1.0, "time": 9.0, "code_size": 128},
    ]
    for args in ((0.5, TB.PARETO_TIME), (0.99, TB.PARETO_TIME),
                 (0.5, TB.PARETO_TIME_SPACE)):
        assert TB.filter_results(rows, *args) == JB.filter_results(rows,
                                                                   *args)
    names = [r["factory"] for r in TB.filter_results(rows, 0.5)]
    assert "C" not in names and "B" not in names and "A" in names
    out = TB.filter_results(rows, 0.5, name_filter=lambda n: n != "Flat")
    assert all(r["factory"] != "Flat" for r in out)


def test_optimizer_stages(tmp_path):
    """The staged Optimizer's output shape (bench_fw/optimize.py optimize():
    the nprobe probe, the codec Pareto set, the quantizer Pareto set, the
    crossed Pareto rows), on a codec grid cut to three."""
    io = BenchmarkIO(path=str(tmp_path), device="cpu")
    tr, db, q = _descs(TB, seed=91, nt=3000, nb=6000, nq=80)
    opt = TB.Optimizer(io=io)
    opt.codec_candidates = lambda d: ["Flat", "SQ8", "PQ8"]
    result = opt.optimize(32, tr, [db], q, min_accuracy=0.3, nlist=32,
                          quantizer_nlists=[32])
    assert isinstance(result["nprobe_at_95"], int)
    assert result["nprobe_at_95"] >= 1
    assert result["codecs"] and 32 in result["quantizers"]
    assert result["quantizers"][32]
    rows = result["pareto"][db.get_filename()]
    assert rows
    for r in rows:
        assert r["recall"] >= 0.3 and "nprobe" in r["search_params"]
        assert r["code_size"] > 0
    for f in ("result_ivf32_flat.json", "result_ivf32_codec.json",
              "result_quantizer32.json"):
        assert io.file_exist(f)
