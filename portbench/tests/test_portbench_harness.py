"""CPU tests of the benchmark harness at a tiny size: the result line, the
files found by name, the imports, the timeline, and the comparison
catching a broken program (the look for a card is skipped: the run goes
straight to ``run`` on the CPU)."""

import ast
import json
import os
import re
import shutil

import pytest
import torch

from portbench import run as run_py
from portbench.core import faults, spec, trace

from .conftest import ROOT

PB = os.path.join(ROOT, "portbench")
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    WORKLOADS = json.load(_f)["workloads"]
CELLS = tuple(w["name"] for w in WORKLOADS)
CONTRACT_KEYS = ("correct", "attempted", "failed", "metrics", "device")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def read(path):
    with open(path) as f:
        return json.load(f)


def write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_copy(tmp_path):
    """A copy of portbench/ and BENCHMARK.json under tmp_path, with every
    configuration and traffic mix cut to a size the CPU runs in seconds."""
    dst = tmp_path / "portbench"
    shutil.copytree(PB, dst, ignore=shutil.ignore_patterns("__pycache__",
                                                           "tests"))
    for name in os.listdir(dst / "configs"):
        cfg = read(dst / "configs" / name)
        cfg["data"].update(base_rows=6000, train_rows=2000)
        cfg["index"]["nlist"] = 32
        write(dst / "configs" / name, cfg)
    for name in os.listdir(dst / "traffic"):
        tr = read(dst / "traffic" / name)
        tr.update(pool=1000, batch=100, nprobe=4, trace_batches=8,
                  warm_seconds=0)
        write(dst / "traffic" / name, tr)
    bench = read(os.path.join(ROOT, "BENCHMARK.json"))
    write(tmp_path / "BENCHMARK.json", bench)
    return str(tmp_path / "BENCHMARK.json"), str(dst)


def run_line(capsys, bench_json, bench_dir, cell, trace=0, seed=2**31 + 7,
             seconds=1):
    """Run ``cell`` once on the CPU; returns (exit code, result line,
    standard error)."""
    args = run_py.parse(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)])
    rc = run_py.run(spec.load_cell(bench_json, cell, bench_dir), args,
                    torch.device("cpu"))
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("trace_on", [0, 1])
def test_result_line_has_the_contracts_keys(tmp_path, capsys, trace_on):
    bj, bd = tiny_copy(tmp_path)
    rc, line, err = run_line(capsys, bj, bd, CELLS[0], trace=trace_on)
    assert rc == 0
    keys = list(line)
    assert set(CONTRACT_KEYS) <= set(keys)
    assert set(keys) - set(CONTRACT_KEYS) <= {"breakdown", "power_limit",
                                              "checks"}
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    bench = read(bj)
    kind = "per_layer" if trace_on else "end_to_end"
    names = {m["name"] for m in bench[kind]}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace_on:
        assert set(line["metrics"]) == names
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    # the compared numbers close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for name, got in zip(line["checks"], tail):
        assert got.startswith(f"check {name} ") and " limit " in got


@pytest.mark.parametrize("cell", CELLS[1:])
def test_every_cell_runs_tiny(tmp_path, capsys, cell):
    bj, bd = tiny_copy(tmp_path)
    rc, line, _ = run_line(capsys, bj, bd, cell)
    assert rc == 0 and line["correct"] is True


@pytest.mark.parametrize("fault", ["stale", "half", "altered",
                                   "one_query", "kmeans_unchanged"])
def test_a_broken_program_is_not_correct(tmp_path, capsys, fault):
    bj, bd = tiny_copy(tmp_path)
    plant = faults.SEARCH_FAULTS.get(fault) or faults.kmeans_unchanged
    with plant():
        # long enough for the window to go round the pool at least once
        rc, line, _ = run_line(capsys, bj, bd, CELLS[0], seconds=4)
    assert rc == 0
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_window_index_searches_the_benchmarks_centroids(tmp_path, cell):
    """The window's index holds the table the plain reference made from the
    seed, bit for bit; the program's own training ran apart and made a
    table of its own."""
    import numpy as np

    from portbench.core import session

    bj, bd = tiny_copy(tmp_path)
    c = spec.load_cell(bj, cell, bd)
    prep = session.prepare(c, 2**31 + 99, "cpu", trace=False)
    held = prep.builder.centroids(prep.index)
    assert held.dtype == np.float32
    assert np.array_equal(held, prep.centroids)
    assert prep.program_centroids.shape == prep.centroids.shape
    assert not np.array_equal(prep.program_centroids, prep.centroids)
    again = session.prepare(c, 2**31 + 99, "cpu", trace=False)
    assert np.array_equal(again.centroids, prep.centroids)


def test_reference_kmeans_trains_from_the_seed():
    from portbench.reference import ivf_flat_l2 as ref

    g = torch.Generator().manual_seed(5)
    xt = torch.randint(0, 256, (3000, 16), generator=g).float()
    a = ref.kmeans(xt, 24, 10, seed=2**31 + 5)
    assert a.dtype == torch.float32 and a.shape == (24, 16)
    assert torch.equal(a, ref.kmeans(xt, 24, 10, seed=2**31 + 5))
    assert not torch.equal(a, ref.kmeans(xt, 24, 10, seed=2**31 + 6))
    drawn = xt[torch.randperm(3000, generator=g)[:24]]
    assert ref.kmeans_step_gain(xt, a) < 0.1 * ref.kmeans_step_gain(
        xt, drawn)


def test_a_cell_config_and_metric_added_by_files_alone(tmp_path, capsys):
    bj, bd = tiny_copy(tmp_path)
    first = WORKLOADS[0]
    cfg = read(os.path.join(bd, "configs", first["config"] + ".json"))
    cfg["name"] = "tiny-ivf16-flat"
    cfg["index"]["nlist"] = 16
    write(os.path.join(bd, "configs", "tiny-ivf16-flat.json"), cfg)
    tr = read(os.path.join(bd, "traffic", first["traffic"] + ".json"))
    tr.update(k=5, nprobe=2)
    write(os.path.join(bd, "traffic", "tiny-k5-np2.json"), tr)
    cell = "tiny-ivf16-flat.tiny-k5-np2"
    shutil.copy(os.path.join(bd, "limits", CELLS[0] + ".json"),
                os.path.join(bd, "limits", cell + ".json"))
    with open(os.path.join(bd, "metrics", "traced_calls.count.py"),
              "w") as f:
        f.write('UNIT = "calls"\nLAYER = "device"\nMOVES = "qps"\n'
                'SOURCE = "program_counter"\n\n\ndef read(obs):\n'
                '    return len(obs.call_probes)\n')
    bench = read(bj)
    bench["configs"].append({
        "name": "tiny-ivf16-flat", "source": "https://example.org/tiny",
        "file": "portbench/configs/tiny-ivf16-flat.json", "reduced": [],
        "why": "tiny"})
    bench["workloads"].append({
        "name": cell, "config": "tiny-ivf16-flat", "traffic": "tiny-k5-np2",
        "chips": 1, "why": "tiny"})
    bench["per_layer"].append({
        "name": "traced_calls.count", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "device", "moves": "qps",
        "workloads": [cell]})
    write(bj, bench)
    rc, line, _ = run_line(capsys, bj, bd, cell, trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["traced_calls.count"]["value"] == 8
    assert "coarse_ms" in line["metrics"]
    rc, line, _ = run_line(capsys, bj, bd, CELLS[0], trace=1)
    assert "traced_calls.count" not in line["metrics"]


def test_main_gives_no_result_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_py.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                      "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no CUDA device" in out.err


def imports_of(path):
    """(top-level names of absolute imports, number of relative ones)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names, relative = set(), 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                relative += 1
            else:
                names.add(node.module.split(".")[0])
    return names, relative


def python_files(top):
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in python_files(PB):
        names, _ = imports_of(path)
        bad = names & {"jax", "jaxlib", "flax", "tpu_ann"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in python_files(os.path.join(PB, "reference")):
        names, relative = imports_of(path)
        assert "tpu_ann_torch" not in names and "portbench" not in names
        assert relative == 0, path


def test_benchmark_json_names_its_files():
    bench = read(os.path.join(ROOT, "BENCHMARK.json"))
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        assert read(os.path.join(ROOT, c["file"]))["name"] == c["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        cell = spec.load_cell(os.path.join(ROOT, "BENCHMARK.json"),
                              w["name"])
        assert set(cell.limits) == {"kmeans_gain", "wrong_answers",
                                    "bad_slots", "unanswered"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        mod = spec.load_module(os.path.join(PB, "metrics",
                                            m["name"] + ".py"))
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"])


def test_timeline_busy_union_and_idle_gaps():
    tl = trace.Timeline(
        window=(0.0, 100.0),
        device=[(10.0, 30.0, "a"), (20.0, 40.0, "b"), (90.0, 120.0, "a")],
        host=[(0.0, 100.0, trace.WINDOW), (40.0, 90.0, trace.CALL),
              (50.0, 60.0, "aten::copy_")])
    assert tl.busy_intervals() == [[10.0, 40.0], [90.0, 100.0]]
    assert tl.busy_s == pytest.approx(40e-6)
    assert tl.window_s == pytest.approx(100e-6)
    assert tl.device_ops() == [["a", pytest.approx(50e-6)],
                               ["b", pytest.approx(20e-6)]]
    gaps = dict(tl.idle_gaps())
    assert gaps == {trace.NO_HOST_OP[trace.WINDOW]: pytest.approx(10e-6),
                    trace.NO_HOST_OP[trace.CALL]: pytest.approx(50e-6)}


def test_reference_bounds_allow_either_side_of_a_tie():
    from portbench.reference import ivf_flat_l2 as ref

    cent = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 40.0]])
    # row 0 lies exactly between lists 0 and 1; row 1 sits in list 0,
    # row 2 in list 1, row 3 in list 2
    xb = torch.tensor([[5.0, 1.0], [1.0, 0.0], [11.0, 0.0], [0.0, 39.0]])
    r = ref.IVFFlatL2(xb, cent)
    assert r.tied.tolist() == [0]
    a = r.answers(torch.tensor([[4.0, 1.0]]), k=2, nprobe=1)
    # a sound program may list row 0 in list 0 (then it is found) or in
    # list 1 (then it is not): the bounds hold both answers
    assert a.low_d[0].tolist() == [1.0, 10.0]
    assert a.high_d[0].tolist() == [10.0, float("inf")]
    strict = ref.IVFFlatL2(xb, cent, rel_tol=0.0)
    b = strict.answers(torch.tensor([[4.0, 1.0]]), k=2, nprobe=1)
    assert torch.equal(b.low_d, b.high_d)


def test_a_call_that_fails_counts_its_queries_unanswered():
    import numpy as np

    from portbench.loops import closed

    def call(x):
        if x[0, 0] == 1.0:
            raise RuntimeError("planted")
        return np.zeros((len(x), 3)), np.zeros((len(x), 3), np.int64)

    pool = np.zeros((40, 4), np.float32)
    pool[10:20] = 1.0
    run = closed.run(call, pool, 10, rng=np.random.default_rng(0),
                     batches=8, sample=2)
    assert run.queries_failed == 20 and run.queries_answered == 60
    assert run.attempted == 80 and len(run.errors) == 2
    assert run.last[1] is None and run.last[0] is not None
