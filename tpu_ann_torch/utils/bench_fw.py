"""Descriptor-driven benchmarking framework — PyTorch counterpart of
`tpu_ann/utils/bench_fw.py`, the role of the reference's `benchs/bench_fw/` (descriptors.py / benchmark_io.py / benchmark.py /
optimize.py, ~3.6k LoC): datasets, codecs, and experiments are named by
declarative descriptors; every expensive artifact (vectors, trained
codec, populated index, ground truth, experiment results) is cached on
disk under a descriptor-derived filename, so re-running a sweep only
recomputes what changed.

Differences from the reference, by design:
  * artifacts serialize through `utils.index_io` (one registry for every
    index class) instead of per-type writers;
  * the sweep measures batched search on the device rather than
    per-thread CPU loops: each time is `time.perf_counter` around a call
    whose outputs are numpy, so it covers the device's work;
  * Pareto filtering reuses `utils.autotune.OperatingPoints` — the same
    machinery the AutoTune layer uses, where the reference duplicates it
    (bench_fw/optimize.py vs AutoTune.cpp).

Typical use (mirrors bench_fw/benchmark.py's train/build/knn stages)::

    io = BenchmarkIO(path="/tmp/bench_cache", device="cuda")
    bm = Benchmark(
        io=io,
        training_vectors=DatasetDescriptor(namespace="syn",
                                           tablename="64_123",
                                           num_vectors=20000),
        database_vectors=DatasetDescriptor(namespace="syn",
                                           tablename="64_123",
                                           num_vectors=50000, split="db"),
        query_vectors=DatasetDescriptor(namespace="syn",
                                        tablename="64_123",
                                        num_vectors=500, split="q"),
        index_descs=[IndexDescriptor(d=64, factory="IVF64,Flat",
                                     search_params={"nprobe": [1, 4, 16]})],
        k=10,
    )
    results = bm.benchmark()
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops import distances as _D
from . import index_io
from .autotune import OperatingPoints, set_index_parameter
from .factory import index_factory

_METRICS = {"L2": _D.METRIC_L2, "IP": _D.METRIC_INNER_PRODUCT}


@dataclasses.dataclass
class DatasetDescriptor:
    """Names a vector set (bench_fw/descriptors.py:54 DatasetDescriptor).

    namespace:
      * ``"syn"`` — deterministic synthetic vectors; ``tablename`` is
        ``"{d}_{seed}"`` (the reference's 3rd convention) and
        ``num_vectors`` the row count;
      * ``"std_t" / "std_d" / "std_q"`` — train/database/query split of a
        zoo dataset via `utils.datasets.dataset_from_name`;
      * ``None`` — a local ``.npy`` file (``tablename``) under the
        BenchmarkIO path.
    """

    namespace: Optional[str] = None
    tablename: Optional[str] = None
    num_vectors: Optional[int] = None
    # disambiguates descriptors drawing different rows of one synthetic
    # pool (the reference separates them by seed only)
    split: str = ""
    desc_name: Optional[str] = None

    def __hash__(self):
        return hash(self.get_filename())

    def get_filename(self, prefix: Optional[str] = None) -> str:
        """Descriptor-derived cache stem, '.'-terminated (reference
        convention: callers append 'npy' / 'json' / 'codec')."""
        if self.desc_name is None:
            parts = []
            if self.namespace:
                parts.append(self.namespace)
            assert self.tablename is not None
            parts.append(str(self.tablename).replace("/", "_"))
            if self.split:
                parts.append(self.split)
            if self.num_vectors is not None:
                parts.append(str(self.num_vectors))
            self.desc_name = "_".join(parts) + "."
        name = self.desc_name
        return f"{prefix}_{name}" if prefix else name


@dataclasses.dataclass
class IndexDescriptor:
    """Names one index configuration (bench_fw/descriptors.py:160
    IndexDescriptorClassic): a factory string plus construction-time and
    search-time parameters."""

    d: int
    factory: str
    metric: str = "L2"
    # applied once after construction, e.g. {"efConstruction": 80}
    construction_params: Optional[Dict[str, Any]] = None
    # swept at search time: name -> list of values, e.g.
    # {"nprobe": [1, 4, 16], "k_factor": [2, 4]}
    search_params: Optional[Dict[str, List[Any]]] = None
    training_size: Optional[int] = None
    desc_name: Optional[str] = None

    def get_name(self) -> str:
        if self.desc_name is None:
            name = self.factory.replace(",", "_").replace("/", "_")
            if self.construction_params:
                cp = "_".join(f"{k}{v}" for k, v in
                              sorted(self.construction_params.items()))
                name += f".cp_{cp}"
            self.desc_name = f"{name}.{self.metric}.d{self.d}."
        return self.desc_name

    def param_grid(self) -> List[Dict[str, Any]]:
        """Cartesian sweep of search_params (bench_fw's
        param_dict_list expansion), stable order."""
        grid: List[Dict[str, Any]] = [{}]
        for pname in sorted(self.search_params or {}):
            grid = [dict(g, **{pname: v}) for g in grid
                    for v in self.search_params[pname]]
        return grid


def _sync(device) -> None:
    """Wait for the device's queued work (a no-op off CUDA)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _param_name(params: Dict[str, Any]) -> str:
    return "_".join(f"{k}={v}" for k, v in sorted(params.items())) or "default"


class BenchmarkIO:
    """Disk + memory cache for benchmark artifacts
    (bench_fw/benchmark_io.py role). Filenames come from descriptors;
    anything already on disk is reused. ``device`` is where the indexes,
    the ground truth and the k-means of every stage run."""

    def __init__(self, path: str, device="cuda"):
        self.path = path
        self.device = device
        os.makedirs(path, exist_ok=True)
        self._mem: Dict[str, Any] = {}

    # -- primitive artifacts ------------------------------------------------
    def file_exist(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.path, name))

    def write_nparray(self, arr: np.ndarray, name: str) -> None:
        np.save(os.path.join(self.path, name), arr, allow_pickle=False)

    def read_nparray(self, name: str) -> np.ndarray:
        return np.load(os.path.join(self.path, name), allow_pickle=False)

    def write_json(self, obj, name: str) -> None:
        with open(os.path.join(self.path, name), "w") as f:
            json.dump(obj, f, indent=1, default=float)

    def read_json(self, name: str):
        with open(os.path.join(self.path, name)) as f:
            return json.load(f)

    def write_index(self, index, name: str) -> None:
        index_io.write_index(index, os.path.join(self.path, name))

    def read_index(self, name: str):
        return index_io.read_index(os.path.join(self.path, name),
                                   device=self.device)

    # -- datasets -----------------------------------------------------------
    def get_dataset(self, desc: DatasetDescriptor) -> np.ndarray:
        key = desc.get_filename()
        if key in self._mem:
            return self._mem[key]
        fname = key + "npy"
        if self.file_exist(fname):
            x = self.read_nparray(fname)
        else:
            x = self._materialize(desc)
            self.write_nparray(x, fname)
        self._mem[key] = x
        return x

    def _materialize(self, desc: DatasetDescriptor) -> np.ndarray:
        ns = desc.namespace
        if ns == "syn":
            d_str, seed_str = str(desc.tablename).split("_")
            d, seed = int(d_str), int(seed_str)
            n = desc.num_vectors or 10000
            # one deterministic manifold per (d, seed): the random
            # projection + per-dim scale come from `seed` alone, so every
            # split lies on the SAME manifold; only the latent rows are
            # re-seeded per split, so train/db/q are disjoint samples
            # that never alias each other
            offsets = {"": 0, "train": 1, "db": 2, "q": 3}
            if desc.split not in offsets:
                raise ValueError(f"unknown split {desc.split!r}; "
                                 f"expected one of {sorted(offsets)}")
            d1 = 10
            rs_manifold = np.random.RandomState(seed)
            proj = rs_manifold.rand(d1, d)
            scale = rs_manifold.rand(d) * 4 + 0.1
            rs_rows = np.random.RandomState(seed + 100003 * offsets[desc.split])
            x = np.sin(np.dot(rs_rows.normal(size=(n, d1)), proj) * scale)
            return np.ascontiguousarray(x, np.float32)
        if ns in ("std_t", "std_d", "std_q"):
            from .datasets import dataset_from_name
            ds = dataset_from_name(str(desc.tablename), device=self.device)
            x = {"std_t": ds.get_train, "std_d": ds.get_database,
                 "std_q": ds.get_queries}[ns]()
            return np.ascontiguousarray(
                x[: desc.num_vectors] if desc.num_vectors else x, np.float32)
        # local file
        return self.read_nparray(str(desc.tablename))

    # -- ground truth -------------------------------------------------------
    def get_ground_truth(self, db: DatasetDescriptor, q: DatasetDescriptor,
                         k: int, metric: str) -> np.ndarray:
        name = (q.get_filename() + "gt_" + db.get_filename()
                + f"{metric}_k{k}.")
        fname = name + "npy"
        if self.file_exist(fname):
            return self.read_nparray(fname)
        from .contrib import knn_ground_truth
        xb, xq = self.get_dataset(db), self.get_dataset(q)
        _, gt = knn_ground_truth(xq, iter([xb]), k,
                                 metric=_METRICS[metric],
                                 device=self.device)
        gt = np.asarray(gt)
        self.write_nparray(gt, fname)
        return gt


@dataclasses.dataclass
class Benchmark:
    """Staged train -> build -> sweep benchmark over index descriptors
    (bench_fw/benchmark.py role). Every stage is cached through
    BenchmarkIO; `benchmark()` returns the reference-shaped result dict
    and writes it as JSON when `result_file` is given."""

    io: BenchmarkIO
    training_vectors: Optional[DatasetDescriptor]
    database_vectors: DatasetDescriptor
    query_vectors: DatasetDescriptor
    index_descs: List[IndexDescriptor]
    k: int = 10
    verbose: bool = False

    def _log(self, *a) -> None:
        if self.verbose:
            print("[bench_fw]", *a, flush=True)

    # -- stages ------------------------------------------------------------
    def train_one(self, desc: IndexDescriptor):
        """Trained (empty) codec for a descriptor, cached as
        '<name>codec' (bench_fw/index.py get_codec role)."""
        name = desc.get_name()
        codec_f, meta_f = name + "codec", name + "train.json"
        if self.io.file_exist(codec_f) and self.io.file_exist(meta_f):
            return (self.io.read_index(codec_f),
                    self.io.read_json(meta_f)["train_time"])
        index = index_factory(desc.d, desc.factory,
                              _METRICS[desc.metric], device=self.io.device)
        for pname, v in (desc.construction_params or {}).items():
            set_index_parameter(index, pname, v)
        t = 0.0
        if self.training_vectors is not None:
            xt = self.io.get_dataset(self.training_vectors)
            if desc.training_size:
                xt = xt[: desc.training_size]
            t0 = time.perf_counter()
            index.train(xt)
            _sync(self.io.device)
            t = time.perf_counter() - t0
        self.io.write_index(index, codec_f)
        self.io.write_json({"train_time": t}, meta_f)
        self._log(f"trained {name} in {t:.2f}s")
        return index, t

    def build_one(self, desc: IndexDescriptor):
        """Populated index, cached as '<name>index'."""
        name = desc.get_name()
        index_f, meta_f = name + "index", name + "build.json"
        if self.io.file_exist(index_f) and self.io.file_exist(meta_f):
            return (self.io.read_index(index_f),
                    self.io.read_json(meta_f)["add_time"])
        index, _ = self.train_one(desc)
        xb = self.io.get_dataset(self.database_vectors)
        t0 = time.perf_counter()
        index.add(xb)
        _sync(self.io.device)
        t = time.perf_counter() - t0
        self.io.write_index(index, index_f)
        self.io.write_json({"add_time": t}, meta_f)
        self._log(f"built {name} in {t:.2f}s")
        return index, t

    def benchmark_knn_one(self, desc: IndexDescriptor) -> Dict[str, Any]:
        """Sweep the descriptor's search grid; one result row per
        parameter combination (bench_fw/benchmark.py knn experiments)."""
        from .evaluation import recall_k_at_k

        index, add_t = self.build_one(desc)
        xq = self.io.get_dataset(self.query_vectors)
        gt = self.io.get_ground_truth(self.database_vectors,
                                      self.query_vectors, self.k,
                                      desc.metric)
        rows: Dict[str, Any] = {}
        for params in desc.param_grid():
            pkey = _param_name(params)
            rname = desc.get_name() + f"knn.{pkey}.json"
            if self.io.file_exist(rname):
                rows[pkey] = self.io.read_json(rname)
                continue
            for pname, v in params.items():
                set_index_parameter(index, pname, v)
            index.search(xq, self.k)            # warm-up
            # best of 3 after the warm-up: rows are cached for good, so
            # one noisy measurement would persist; search returns numpy,
            # so each time covers the device's work
            dt = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                _, I = index.search(xq, self.k)
                dt = min(dt, max(time.perf_counter() - t0, 1e-9))
            row = {
                "recall": float(recall_k_at_k(I, gt, self.k)),
                "time": dt / len(xq),
                "qps": len(xq) / dt,
                "k": self.k,
                "search_params": params,
                "add_time": add_t,
            }
            self.io.write_json(row, rname)
            rows[pkey] = row
            self._log(f"{desc.get_name()} {pkey}: "
                      f"R@{self.k}={row['recall']:.4f} "
                      f"QPS={row['qps']:.0f}")
        return rows

    def benchmark(self, result_file: Optional[str] = None) -> Dict[str, Any]:
        """Run every descriptor; returns {'indices', 'experiments',
        'optimal'} (the reference's benchmark result JSON shape plus the
        Pareto filter that bench_fw/optimize.py applies separately)."""
        results: Dict[str, Any] = {"indices": {}, "experiments": {}}
        ops_pareto = OperatingPoints()
        for desc in self.index_descs:
            name = desc.get_name()
            _, train_t = self.train_one(desc)
            index, add_t = self.build_one(desc)
            results["indices"][name] = {
                "train_time": train_t,
                "add_time": add_t,
                "ntotal": int(getattr(index, "ntotal", 0)),
            }
            for pkey, row in self.benchmark_knn_one(desc).items():
                ekey = f"{name}knn.{pkey}"
                results["experiments"][ekey] = row
                ops_pareto.add(row["recall"], row["time"], ekey)
        results["optimal"] = [
            {"key": p.key, "recall": p.perf, "time": p.t}
            for p in ops_pareto.optimal_pts()
        ]
        if result_file:
            self.io.write_json(results, result_file)
        return results


# ---------------------------------------------------------------------------
# Optimizer — staged index-design exploration (bench_fw/optimize.py:24-282
# Optimizer: optimize_quantizer / optimize_ivf / optimize_codec / optimize).
# Each stage benchmarks a family of candidate descriptors through
# `Benchmark` (so every artifact caches) and keeps only the Pareto-optimal
# operating points by time or time*space.
# ---------------------------------------------------------------------------

PARETO_TIME = "time"
PARETO_TIME_SPACE = "time_space"


def filter_results(rows, min_accuracy, pareto_metric=PARETO_TIME,
                   name_filter=None):
    """Global Pareto filter over flat result rows
    (bench_fw/utils.py:174 filter_results, ParetoMode.GLOBAL).

    rows: list of dicts with keys factory/search_params/recall/time and
    (for time_space) code_size. Returns the rows on the accuracy-cost
    Pareto frontier with recall >= min_accuracy, best-first by cost."""
    kept = []
    for r in rows:
        if r["recall"] < min_accuracy:
            continue
        if name_filter is not None and not name_filter(r["factory"]):
            continue
        kept.append(r)

    def cost(r):
        t = r["time"]
        if pareto_metric == PARETO_TIME_SPACE:
            t = t * max(r.get("code_size", 1), 1)
        return t

    frontier = []
    for r in kept:
        dominated = any(
            o["recall"] >= r["recall"] and cost(o) <= cost(r)
            and (o["recall"] > r["recall"] or cost(o) < cost(r))
            for o in kept)
        if not dominated:
            frontier.append(r)
    return sorted(frontier, key=cost)


@dataclasses.dataclass
class Optimizer:
    """Staged exploration (bench_fw/optimize.py:24 Optimizer).

    The reference's recipe, kept stage for stage:
      1. `ivf_flat_nprobe_required_for_accuracy` — sweep nprobe on
         IVF{nlist},Flat, find the smallest nprobe hitting the target;
      2. `optimize_codec` — at that fixed nprobe, benchmark the codec
         family (SQ*, PQ/OPQ grid) and keep the time*space Pareto set;
      3. `optimize_quantizer` — benchmark coarse-quantizer candidates
         (exact GEMM vs graph routing) on the centroid set per nlist;
      4. `optimize_ivf` — cross the surviving quantizers and codecs,
         benchmark at scale, keep the global Pareto set.
    `optimize()` chains them and returns the reference-shaped dict.
    """

    io: BenchmarkIO
    distance_metric: str = "L2"
    k: int = 10
    verbose: bool = False

    def _benchmark_rows(self, index_descs, training_vectors,
                        database_vectors, query_vectors,
                        result_file=None) -> List[Dict[str, Any]]:
        from .factory import get_code_size

        rows: List[Dict[str, Any]] = []
        for desc in index_descs:
            bm = Benchmark(
                io=self.io,
                training_vectors=training_vectors,
                database_vectors=database_vectors,
                query_vectors=query_vectors,
                index_descs=[desc],
                k=self.k,
                verbose=self.verbose,
            )
            try:
                desc_rows = bm.benchmark_knn_one(desc)
            except ValueError as e:
                # infeasible candidate for this dataset (e.g. a 12-bit PQ
                # without 4096 training rows) — exploration skips it, like
                # the reference's per-candidate isolation
                if self.verbose:
                    print(f"[optimizer] skip {desc.factory}: {e}",
                          flush=True)
                continue
            try:
                code_size = get_code_size(desc.d, desc.factory)
            except Exception:
                code_size = 0
            for pkey, row in desc_rows.items():
                rows.append(dict(row, factory=desc.factory,
                                 desc_name=desc.get_name(),
                                 code_size=code_size))
        if result_file:
            self.io.write_json(rows, result_file)
        return rows

    def benchmark_and_filter_candidates(
            self, index_descs, training_vectors, database_vectors,
            query_vectors, result_file, min_accuracy,
            pareto_metric=PARETO_TIME, include_flat=True):
        """(bench_fw/optimize.py:43) benchmark then Pareto-filter; returns
        (surviving IndexDescriptors, surviving rows)."""
        rows = self._benchmark_rows(index_descs, training_vectors,
                                    database_vectors, query_vectors,
                                    result_file)
        filtered = filter_results(
            rows, min_accuracy, pareto_metric,
            name_filter=None if include_flat
            else (lambda n: not n.startswith("Flat")))
        by_factory = {}
        for r in filtered:
            by_factory.setdefault(r["factory"], r)
        descs = [
            IndexDescriptor(
                d=index_descs[0].d, factory=f,
                metric=self.distance_metric,
                search_params={k2: [v] for k2, v in
                               r["search_params"].items()})
            for f, r in by_factory.items()
        ]
        return descs, filtered

    # -- stage 1 ------------------------------------------------------------
    def ivf_flat_nprobe_required_for_accuracy(
            self, d, training_vectors, database_vectors, query_vectors,
            nlist, accuracy, nprobes=(1, 2, 4, 8, 16, 32, 64, 128)):
        """(bench_fw/optimize.py:180) smallest nprobe reaching `accuracy`
        on IVF{nlist},Flat."""
        nprobes = [p for p in nprobes if p <= nlist]
        rows = self._benchmark_rows(
            [IndexDescriptor(d=d, factory=f"IVF{nlist},Flat",
                             metric=self.distance_metric,
                             search_params={"nprobe": nprobes})],
            training_vectors, database_vectors, query_vectors,
            result_file=f"result_ivf{nlist}_flat.json")
        ok = [r["search_params"]["nprobe"] for r in rows
              if r["recall"] >= accuracy]
        return min(ok) if ok else nlist // 2

    # -- stage 2 ------------------------------------------------------------
    def codec_candidates(self, d: int) -> List[str]:
        """Candidate codec grid (optimize_codec's SQ/PQ/OPQ family,
        bench_fw/optimize.py:222-243), pruned to codes < SQ8's bytes."""
        specs = ["Flat", "SQfp16", "SQbf16", "SQ8"]
        Ms = [M for M in (8, 12, 16, 32, 48, 64, 96, 128) if d % M == 0]
        for M in Ms:
            for b in (8, 10, 12):
                if M * b < d * 8:
                    specs.append(f"PQ{M}x{b}" if b != 8 else f"PQ{M}")
            for dim in range(2, 18, 2):
                if M * dim <= d:
                    specs.append(f"OPQ{M}_{M * dim},PQ{M}")
                    break   # one OPQ out-dim per M keeps the grid tractable
        return specs

    def optimize_codec(self, d, training_vectors, database_vectors,
                       query_vectors, nlist, nprobe, min_accuracy,
                       codecs=None):
        """(bench_fw/optimize.py:214) benchmark IVF{nlist},<codec> at a
        fixed nprobe; keep the time*space Pareto set of codecs."""
        specs = codecs if codecs is not None else self.codec_candidates(d)
        descs = [
            IndexDescriptor(
                d=d,
                factory=(f"IVF{nlist},{c}" if "," not in c
                         else f"{c.split(',')[0]},IVF{nlist},"
                              f"{c.split(',')[1]}"),
                metric=self.distance_metric,
                search_params={"nprobe": [nprobe]})
            for c in specs
        ]
        kept, filtered = self.benchmark_and_filter_candidates(
            descs, training_vectors, database_vectors, query_vectors,
            result_file=f"result_ivf{nlist}_codec.json",
            min_accuracy=min_accuracy,
            pareto_metric=PARETO_TIME_SPACE, include_flat=False)
        # return the codec spellings (strip the IVF container)
        out = []
        for desc in kept:
            f = desc.factory
            parts = f.split(",")
            out.append(parts[-1] if len(parts) == 2
                       else f"{parts[0]},{parts[-1]}")
        return out, filtered

    # -- stage 3 ------------------------------------------------------------
    def optimize_quantizer(self, d, training_vectors, query_vectors,
                           nlists, min_accuracy):
        """(bench_fw/optimize.py:89) per nlist: cluster the training set,
        benchmark quantizer candidates (Flat GEMM vs HNSW graph routing)
        with the centroids as the database, keep the time Pareto set."""
        from ..ops.kmeans import kmeans as _kmeans

        out = {}
        for nlist in nlists:
            cname = (training_vectors.get_filename()
                     + f"kmeans{nlist}.npy")
            if self.io.file_exist(cname):
                centroids = self.io.read_nparray(cname)
            else:
                xt = self.io.get_dataset(training_vectors)
                from ..ops.kmeans import ClusteringParameters

                cp = ClusteringParameters()
                cp.niter = 6
                cents, _ = _kmeans(xt, nlist, cp, device=self.io.device)
                centroids = np.asarray(cents, np.float32)
                self.io.write_nparray(centroids, cname)
            cdesc = DatasetDescriptor(tablename=cname)
            descs = [IndexDescriptor(d=d, factory="Flat",
                                     metric=self.distance_metric)] + [
                IndexDescriptor(
                    d=d, factory="HNSW32",
                    metric=self.distance_metric,
                    construction_params={"efConstruction": 2 ** i},
                    search_params={"efSearch": [16, 64]})
                for i in (6, 8)
            ]
            kept, _ = self.benchmark_and_filter_candidates(
                descs, None, cdesc, query_vectors,
                result_file=f"result_quantizer{nlist}.json",
                min_accuracy=min_accuracy,
                pareto_metric=PARETO_TIME, include_flat=True)
            out[nlist] = kept
        return out

    # -- stage 4 ------------------------------------------------------------
    def optimize_ivf(self, d, training_vectors, database_vectors,
                     query_vectors, quantizers, codecs, min_accuracy,
                     nprobes=(4, 16, 64)):
        """(bench_fw/optimize.py:128) cross surviving quantizers x codecs
        into full IVF descriptors, benchmark at scale, keep the global
        Pareto set."""
        descs = []
        for nlist, qdescs in quantizers.items():
            for q in qdescs:
                # graph-routed coarse quantizer -> IVF{n}_HNSW{M} spelling
                hnsw = "_HNSW32" if q.factory.startswith("HNSW") else ""
                for codec in codecs:
                    if "," in codec:      # OPQ prefix
                        pre, code = codec.split(",")
                        factory = f"{pre},IVF{nlist}{hnsw},{code}"
                    else:
                        factory = f"IVF{nlist}{hnsw},{codec}"
                    descs.append(IndexDescriptor(
                        d=d, factory=factory,
                        metric=self.distance_metric,
                        search_params={"nprobe": list(nprobes)}))
        # dedupe by factory string
        seen, uniq = set(), []
        for desc in descs:
            if desc.factory not in seen:
                seen.add(desc.factory)
                uniq.append(desc)
        return self.benchmark_and_filter_candidates(
            uniq, training_vectors, database_vectors, query_vectors,
            result_file=f"result_{database_vectors.get_filename()}json",
            min_accuracy=min_accuracy,
            pareto_metric=PARETO_TIME_SPACE, include_flat=False)

    # -- the full recipe ----------------------------------------------------
    def optimize(self, d, training_vectors, database_vectors_list,
                 query_vectors, min_accuracy, nlist=256,
                 quantizer_nlists=None):
        """(bench_fw/optimize.py:282) chained stages; returns
        {"nprobe_at_95": int, "codecs": [...], "quantizers": {...},
        "pareto": {db_filename: [rows...]}}."""
        nprobe95 = self.ivf_flat_nprobe_required_for_accuracy(
            d, training_vectors, database_vectors_list[0], query_vectors,
            nlist=nlist, accuracy=0.95)
        codecs, _ = self.optimize_codec(
            d, training_vectors, database_vectors_list[0], query_vectors,
            nlist=nlist, nprobe=nprobe95, min_accuracy=min_accuracy)
        quantizers = self.optimize_quantizer(
            d, training_vectors, query_vectors,
            nlists=quantizer_nlists or [nlist],
            min_accuracy=0.7)
        pareto = {}
        for db in database_vectors_list:
            _, rows = self.optimize_ivf(
                d, training_vectors, db, query_vectors,
                quantizers=quantizers, codecs=codecs,
                min_accuracy=min_accuracy)
            pareto[db.get_filename()] = rows
        return {"nprobe_at_95": nprobe95, "codecs": codecs,
                "quantizers": quantizers, "pareto": pareto}
