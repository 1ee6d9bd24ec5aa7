"""Port parity: tpu_ann_torch.utils.benchmark against the JAX package's
utils/benchmark.py, on the CPU: the config parser, the percentile helper,
and a tiny grid whose CSV has the JAX package's header and rows."""

import csv
import dataclasses
import os

import numpy as np
import pytest

from tpu_ann.utils import benchmark as JB
from tpu_ann.utils.datasets import SyntheticDataset as JDataset
from tpu_ann_torch.utils import benchmark as TB
from tpu_ann_torch.utils.datasets import SyntheticDataset as TDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = {"build": {"nlist": [8.0], "ef_construction": [16.0]},
        "search": {"nprobe": [2.0, 8.0], "k": [10.0]}}


def test_parse_config_matches_reference(tmp_path):
    path = os.path.join(ROOT, "benchs", "benchmark.config")
    assert TB.parse_config(path) == JB.parse_config(path)
    other = tmp_path / "grid.config"
    other.write_text("# a comment\n[build]\nnlist = 1024, 4096  # two\n"
                     "ef_construction = 40\n\n[search]\nnprobe = 16 64\n"
                     "ef_search_ratio = 0.5, 1.0\nk = 10\n")
    assert TB.parse_config(str(other)) == JB.parse_config(str(other))


def test_latency_percentiles_match_reference():
    t = np.random.RandomState(0).rand(257) * 1e-3
    assert TB.latency_percentiles(t) == JB.latency_percentiles(t)


def test_bench_result_fields_match_reference():
    assert [f.name for f in dataclasses.fields(TB.BenchResult)] == \
        [f.name for f in dataclasses.fields(JB.BenchResult)]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_hnsw"])
def test_tiny_grid_writes_the_reference_csv(kind, tmp_path):
    """Both packages run the same 1 x 2 grid on the same tiny dataset: the
    same header, one row per nprobe with the same grid columns, recalls
    in [0, 1] and positive times; the port also measures the per-query
    tails."""
    kw = dict(d=16, nt=1000, nb=2000, nq=64)
    t_csv, j_csv = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    res = TB.run_grid(TDataset(**kw, device="cpu"), GRID, index_kind=kind,
                      out_csv=t_csv, latency_batch=16, per_query_sample=8,
                      verbose=False, device="cpu")
    JB.run_grid(JDataset(**kw), GRID, index_kind=kind, out_csv=j_csv,
                latency_batch=16, verbose=False)
    t_rows, j_rows = _rows(t_csv), _rows(j_csv)
    assert t_rows[0] == j_rows[0]
    assert len(t_rows) == len(j_rows) == 3
    cols = t_rows[0]
    for tr, jr in zip(t_rows[1:], j_rows[1:]):
        for name in ("config", "nlist", "nprobe", "ef_search"):
            assert tr[cols.index(name)] == jr[cols.index(name)]
    for r in res:
        assert 0.0 <= r.recall_at_10 <= 1.0 and r.qps > 0
        assert r.p999_ms >= r.p50_ms > 0
        assert r.pq_p999_ms >= r.pq_p99_ms > 0
    assert res[1].recall_at_10 >= res[0].recall_at_10


def test_unknown_index_kind_raises():
    with pytest.raises(ValueError):
        TB.run_grid(TDataset(d=8, nt=100, nb=100, nq=4, device="cpu"), GRID,
                    index_kind="flat", verbose=False, device="cpu")
