"""What a cell is made of, found by name.

``BENCHMARK.json`` (at the root of the checkout) names the cell, its
configuration and its traffic mix, and lists the metrics. Everything else
sits in a file of its own under ``portbench/``:

- ``configs/<config>.json``: the deployment (index, data, sizes);
- ``traffic/<traffic>.json``: the traffic mix (loop, batch, k, nprobe);
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``;
- ``loops/<loop>.py``: the load generator a traffic mix names;
- ``indexes/<kind>.py``: how a configuration's index is built;
- ``metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: str        # the portbench folder the files came from


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str) -> ModuleType:
    """A module loaded from its file (names may hold dots)."""
    name = "portbench_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod     # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(benchmark_json: str, workload: str,
              bench_dir: str = HERE) -> Cell:
    """The cell named ``workload`` of ``benchmark_json``, with its files
    read from ``bench_dir``."""
    bench = read_json(benchmark_json)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark_json} "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[workload]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=read_json(os.path.join(bench_dir, "configs",
                                      w["config"] + ".json")),
        traffic=read_json(os.path.join(bench_dir, "traffic",
                                       w["traffic"] + ".json")),
        limits=read_json(os.path.join(bench_dir, "limits",
                                      workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, workload)],
        bench_dir=bench_dir)


def loop(cell: Cell) -> ModuleType:
    return load_module(os.path.join(cell.bench_dir, "loops",
                                    cell.traffic["loop"] + ".py"))


def index_builder(cell: Cell) -> ModuleType:
    return load_module(os.path.join(cell.bench_dir, "indexes",
                                    cell.config["index"]["kind"] + ".py"))


def metric_reader(cell: Cell, name: str) -> ModuleType:
    return load_module(os.path.join(cell.bench_dir, "metrics", name + ".py"))
