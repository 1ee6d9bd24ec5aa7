"""Offline sharded IVF build pipeline and job scheduler — PyTorch
counterpart of `tpu_ann/utils/offline_pipeline.py`, the role of the
reference's ``demos/offline_ivf/offline_ivf.py`` (config-driven OfflineIVF
steps) and ``benchs/distributed_ondisk/`` (make_trained_index ->
make_index_vslice x N -> merge_to_ondisk, run by run_on_cluster.bash).

Each step is a :class:`Job` with explicit dependencies and a completion
marker on disk, so a pipeline launched again after a crash runs only the
missing steps. Shard jobs are independent and run inline or each in its
own Python process (the cluster-worker model).

The device is a field of the config (``device``, "cuda" by default). The
train step writes it to ``config.json`` with the shard bounds' inputs, and
every worker reads it there, so a worker process needs no environment
variable to find its device.

Artifacts are plain files in ``workdir`` (the JAX package's index format):
    config.json               nb, nshard, xb_path, device
    trained.tann              the empty trained index (quantizer + codecs)
    shard{i}.tann             per-worker vector-slice indexes
    merged.tann               stream-merged on-disk index
    <job>.done                completion markers
"""

from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# generic DAG scheduler
# ---------------------------------------------------------------------------

@dataclass
class Job:
    name: str
    fn: Callable[[], None]
    deps: Sequence[str] = ()
    # jobs in the same group may run concurrently once their deps are met
    group: str = ""


class JobRunner:
    """Topological runner with on-disk completion markers.

    ``max_workers`` bounds concurrency inside a dependency level — the
    role of the Slurm array width in run_on_cluster.bash.
    """

    def __init__(self, workdir: str, max_workers: int = 1,
                 verbose: bool = False):
        self.workdir = workdir
        self.max_workers = max_workers
        self.verbose = verbose
        os.makedirs(workdir, exist_ok=True)

    def _marker(self, name: str) -> str:
        return os.path.join(self.workdir, f"{name}.done")

    def done(self, name: str) -> bool:
        return os.path.exists(self._marker(name))

    def run(self, jobs: Sequence[Job]) -> List[str]:
        """Run all jobs respecting deps; returns names actually executed."""
        by_name: Dict[str, Job] = {j.name: j for j in jobs}
        for j in jobs:
            for d in j.deps:
                if d not in by_name:
                    raise ValueError(f"job {j.name!r}: unknown dep {d!r}")
        pending = [j for j in jobs if not self.done(j.name)]
        finished = {j.name for j in jobs if self.done(j.name)}
        executed: List[str] = []
        while pending:
            ready = [j for j in pending
                     if all(d in finished for d in j.deps)]
            if not ready:
                cyc = ", ".join(j.name for j in pending)
                raise RuntimeError(f"dependency cycle or failed dep: {cyc}")

            def run_one(j: Job) -> str:
                if self.verbose:
                    print(f"[pipeline] {j.name}", flush=True)
                j.fn()
                with open(self._marker(j.name), "w") as f:
                    f.write("ok\n")
                return j.name

            if self.max_workers > 1 and len(ready) > 1:
                with ThreadPoolExecutor(self.max_workers) as ex:
                    for name in ex.map(run_one, ready):
                        finished.add(name)
                        executed.append(name)
            else:
                for j in ready:
                    finished.add(run_one(j))
                    executed.append(j.name)
            pending = [j for j in pending if j.name not in finished]
        return executed


# ---------------------------------------------------------------------------
# the offline IVF pipeline
# ---------------------------------------------------------------------------

@dataclass
class OfflineIVFConfig:
    """Declarative pipeline config (the role of offline_ivf's yaml)."""

    factory: str                 # e.g. "IVF256,Flat" / "IVF1024,PQ16"
    d: int
    workdir: str
    xt_path: str                 # .npy training vectors
    xb_path: str                 # .npy database vectors
    nshard: int = 4
    metric: str = "L2"
    # run each shard-add in its own Python process (the cluster model);
    # inline threads otherwise
    use_subprocess: bool = False
    # where every step (and every worker) puts its tensors
    device: str = "cuda"
    max_workers: int = 1
    verbose: bool = False
    # evaluation (optional)
    xq_path: Optional[str] = None
    gt_path: Optional[str] = None
    k: int = 10
    nprobe: int = 8
    search_result: dict = field(default_factory=dict)


# seconds a shard worker process may take before it is killed (one 500k-row
# shard takes ~16 s on an H100)
WORKER_TIMEOUT_S = 1200.0
# the directory that holds the tpu_ann_torch package
_TREE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load_rows(path: str, lo: int = 0, hi: Optional[int] = None):
    a = np.load(path, mmap_mode="r")
    # a copy: rows of the read-only map would reach torch unwritable
    return np.array(a[lo:hi], dtype=np.float32)


def _shard_bounds(n: int, nshard: int) -> np.ndarray:
    return np.linspace(0, n, nshard + 1).astype(np.int64)


_WORKER_SRC = r"""
import sys
from tpu_ann_torch.utils.offline_pipeline import shard_add_worker
shard_add_worker(sys.argv[1], int(sys.argv[2]))
"""


def shard_add_worker(workdir: str, shard: int) -> None:
    """Add one vector slice to a copy of the trained index and save it
    (= make_index_vslice.py's per-Slurm-task body), on the device that
    config.json names."""
    import json

    from .index_io import read_index, write_index

    with open(os.path.join(workdir, "config.json")) as f:
        cfg = json.load(f)
    bounds = _shard_bounds(cfg["nb"], cfg["nshard"])
    lo, hi = int(bounds[shard]), int(bounds[shard + 1])
    index = read_index(os.path.join(workdir, "trained.tann"),
                       device=cfg["device"])
    xb = _load_rows(cfg["xb_path"], lo, hi)
    index.add_with_ids(xb, np.arange(lo, hi, dtype=np.int64))
    write_index(index, os.path.join(workdir, f"shard{shard}.tann"))


class OfflineIVFPipeline:
    """train → shard-add × N → merge → (search/eval), resumable.

    Equivalent of offline_ivf.py's command surface (run.py --command
    train/index/merge/search) driven through one DAG.
    """

    def __init__(self, cfg: OfflineIVFConfig):
        self.cfg = cfg
        os.makedirs(cfg.workdir, exist_ok=True)
        self.runner = JobRunner(cfg.workdir, max_workers=cfg.max_workers,
                                verbose=cfg.verbose)

    # -- artifact paths ----------------------------------------------------
    @property
    def trained_path(self):
        return os.path.join(self.cfg.workdir, "trained.tann")

    @property
    def merged_path(self):
        return os.path.join(self.cfg.workdir, "merged.tann")

    def shard_path(self, i: int):
        return os.path.join(self.cfg.workdir, f"shard{i}.tann")

    # -- steps -------------------------------------------------------------
    def _step_train(self) -> None:
        import json

        from .factory import index_factory
        from ..ops.distances import METRIC_INNER_PRODUCT, METRIC_L2

        cfg = self.cfg
        metric = (METRIC_INNER_PRODUCT if cfg.metric.upper() == "IP"
                  else METRIC_L2)
        from .index_io import write_index

        index = index_factory(cfg.d, cfg.factory, metric,
                              device=cfg.device)
        index.train(_load_rows(cfg.xt_path))
        write_index(index, self.trained_path)
        nb = int(np.load(cfg.xb_path, mmap_mode="r").shape[0])
        with open(os.path.join(cfg.workdir, "config.json"), "w") as f:
            json.dump({"nb": nb, "nshard": cfg.nshard,
                       "xb_path": cfg.xb_path, "device": cfg.device}, f)

    def _step_shard(self, i: int) -> None:
        if self.cfg.use_subprocess:
            # the worker imports this package from the tree it lives in
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_TREE, env.get("PYTHONPATH")) if p)
            subprocess.run(
                [sys.executable, "-c", _WORKER_SRC, self.cfg.workdir,
                 str(i)],
                check=True, env=env, timeout=WORKER_TIMEOUT_S)
        else:
            shard_add_worker(self.cfg.workdir, i)

    def _step_merge(self) -> None:
        from .index_io import read_index
        from .invlists_io import FileInvlistSource, merge_ondisk

        empty = read_index(self.trained_path, device=self.cfg.device)
        sources = [FileInvlistSource(self.shard_path(i))
                   for i in range(self.cfg.nshard)]
        merge_ondisk(empty, sources, self.merged_path)

    def _step_search(self) -> None:
        import json

        from .evaluation import knn_intersection_measure
        from .index_io import read_index

        cfg = self.cfg
        index = read_index(self.merged_path, mmap=True,
                           device=cfg.device)
        if hasattr(index, "nprobe"):
            index.nprobe = cfg.nprobe
        xq = _load_rows(cfg.xq_path)
        D, I = index.search(xq, cfg.k)
        out = {"ntotal": int(index.ntotal)}
        if cfg.gt_path:
            gt = np.load(cfg.gt_path)
            out["knn_intersection"] = float(
                knn_intersection_measure(np.asarray(I), gt[:, :cfg.k]))
        np.save(os.path.join(cfg.workdir, "search_I.npy"), np.asarray(I))
        np.save(os.path.join(cfg.workdir, "search_D.npy"), np.asarray(D))
        with open(os.path.join(cfg.workdir, "search.json"), "w") as f:
            json.dump(out, f)
        cfg.search_result.update(out)

    # -- assembly ----------------------------------------------------------
    def jobs(self) -> List[Job]:
        cfg = self.cfg
        jobs = [Job("train", self._step_train)]
        shard_names = []
        for i in range(cfg.nshard):
            name = f"shard{i}"
            shard_names.append(name)
            jobs.append(Job(name, lambda i=i: self._step_shard(i),
                            deps=("train",), group="shards"))
        jobs.append(Job("merge", self._step_merge, deps=shard_names))
        if cfg.xq_path:
            jobs.append(Job("search", self._step_search, deps=("merge",)))
        return jobs

    def run(self) -> List[str]:
        return self.runner.run(self.jobs())
