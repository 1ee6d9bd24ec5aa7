"""One run of one cell: set-up, the measured window, the comparison.

Set-up makes the data on the device from the seed and the coarse
centroids from it by the plain reference's k-means, copies both to the
host, times the program's own ``train`` on an index of its own (checked
by ``kmeans_gain`` after the window), builds the window's index from the
benchmark's centroids through the program's pre-trained quantizer route
and its ``add``, and warms up: one full pass over the query pool, which
meets every shape the window uses, then calls until ``warm_seconds`` have
passed. The window (``--trace 0``) drives the cell's loop for
``seconds``; a traced run (``--trace 1``) drives it for ``trace_batches``
calls under the profiler, then as many calls of ``search_stats``. After
the window the device's peak memory is read, the program's index is
freed, and the plain reference works out what the comparison needs.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time

import numpy as np
import torch

from . import checks, device as card, spec, trace as tracing

CHECKED = ("kmeans_gain", "wrong_answers", "bad_slots", "unanswered")


@dataclasses.dataclass
class Observations:
    """What the per-layer readers read, from one traced run."""

    build_s: float
    timeline: tracing.Timeline
    stats: list           # SearchStats of each call of the stats stretch
    call_probes: list     # (nq, nprobe) probes of each traced call
    list_sizes: np.ndarray
    d: int
    k: int


@dataclasses.dataclass
class Prepared:
    """A cell set up for its window: the data and the benchmark's coarse
    centroids on the host, the index, and the centroids that the
    program's own ``train`` made (for ``kmeans_gain``)."""

    cell: spec.Cell
    device: torch.device
    seed: int
    xb: np.ndarray
    xt: np.ndarray
    pool: np.ndarray
    centroids: np.ndarray
    program_centroids: np.ndarray
    index: object
    builder: object
    loop: object
    reference: object
    setup: dict
    batch_probes: list    # (batch, nprobe) probes of each pool batch

    @property
    def k(self) -> int:
        return self.cell.traffic["k"]

    @property
    def nprobe(self) -> int:
        return self.cell.traffic["nprobe"]

    @property
    def batch(self) -> int:
        return self.cell.traffic["batch"]

    @property
    def build_s(self) -> float:
        return self.setup["train_s"] + self.setup["add_s"]

    def call(self):
        return self.builder.searcher(self.index, self.k, self.nprobe)

    def stats_call(self):
        return self.builder.stats_searcher(self.index, self.k, self.nprobe)

    def rng(self, stream: int) -> np.random.Generator:
        return np.random.Generator(np.random.PCG64([self.seed, stream]))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def prepare(cell: spec.Cell, seed: int, device, trace: bool) -> Prepared:
    """Data, centroids, index and warm-up (with ``trace``, also of
    ``search_stats`` and each pool batch's probes)."""
    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    data_cfg, index_cfg = cfg["data"], cfg["index"]
    if tr["clients"] != 1 or tr["pool"] % tr["batch"]:
        raise ValueError(f"{cell.name}: one client and a pool of whole "
                         f"batches are supported")
    make_data = spec.load_module(os.path.join(
        cell.bench_dir, "data", data_cfg["generator"] + ".py")).make
    reference = spec.load_module(os.path.join(
        cell.bench_dir, "reference", cfg["reference"] + ".py"))
    setup = {}

    t = time.perf_counter()
    nb, nt, npool = data_cfg["base_rows"], data_cfg["train_rows"], tr["pool"]
    allx = make_data(nb + nt + npool, seed, device, data_cfg)
    host = allx.cpu().numpy()
    setup["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cent = reference.kmeans(allx[nb:nb + nt], index_cfg["nlist"],
                            index_cfg["kmeans_niter"], seed).cpu().numpy()
    del allx
    free(device)
    setup["centroids_s"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    xb, xt = host[:nb], host[nb:nb + nt]

    builder = spec.index_builder(cell)
    t = time.perf_counter()
    trained = builder.create(index_cfg, host.shape[1], device)
    trained.train(xt)
    sync(device)
    setup["train_s"] = time.perf_counter() - t
    program_cent = np.ascontiguousarray(builder.centroids(trained))
    del trained
    t = time.perf_counter()
    index = builder.with_centroids(
        builder.create(index_cfg, host.shape[1], device), cent, xt)
    index.add(xb)
    sync(device)
    setup["add_s"] = time.perf_counter() - t

    prep = Prepared(cell=cell, device=device, seed=seed, xb=xb, xt=xt,
                    pool=host[nb + nt:], centroids=cent,
                    program_centroids=program_cent, index=index,
                    builder=builder, loop=spec.loop(cell),
                    reference=reference, setup=setup, batch_probes=[])
    t = time.perf_counter()
    call, stats_call = prep.call(), prep.stats_call()
    pool_batches = batches(prep)
    for x in pool_batches:
        call(x)
        if trace:
            stats_call(x)
            prep.batch_probes.append(builder.probes(index, x, prep.nprobe))
    i = 0
    while time.perf_counter() - t < tr["warm_seconds"]:
        call(pool_batches[i % len(pool_batches)])
        i += 1
    sync(device)
    setup["warm_s"] = time.perf_counter() - t
    return prep


def batches(prep: Prepared) -> list:
    b = prep.batch
    return [prep.pool[j:j + b] for j in range(0, len(prep.pool), b)]


def window(prep: Prepared, seconds: float, trace: bool):
    """The measured window: (runs of the loop, the Timeline of a traced
    run or None, the SearchStats of its stats stretch)."""
    tr = prep.cell.traffic
    rng = prep.rng(1)
    sample = tr["sample_per_batch"]
    call = prep.call()
    if not trace:
        return [prep.loop.run(call, prep.pool, prep.batch, rng=rng,
                              seconds=seconds, sample=sample)], None, []
    first, timeline = tracing.profiled(lambda mark: prep.loop.run(
        call, prep.pool, prep.batch, rng=rng, batches=tr["trace_batches"],
        sample=sample, mark=mark), cuda=prep.device.type == "cuda")
    stats, stats_call = [], prep.stats_call()

    def stats_only(x):
        d, i, st = stats_call(x)
        stats.append(st)
        return d, i

    second = prep.loop.run(stats_only, prep.pool, prep.batch, rng=rng,
                           batches=tr["trace_batches"], sample=sample)
    return [first, second], timeline, stats


def release(prep: Prepared) -> None:
    """Free the program's index."""
    prep.index = None
    free(prep.device)


@dataclasses.dataclass
class Judged:
    """The reference's view of a run, and the numbers compared."""

    xb: torch.Tensor
    pool: torch.Tensor
    xt: torch.Tensor
    cent: torch.Tensor
    answers: object
    numbers: dict


def judge(prep: Prepared, runs: list) -> Judged:
    """The plain reference after the window, and the numbers compared."""
    dev, ref_mod = prep.device, prep.reference
    xb = torch.from_numpy(prep.xb).to(dev)
    pool = torch.from_numpy(prep.pool).to(dev)
    xt = torch.from_numpy(prep.xt).to(dev)
    cent_d = torch.from_numpy(prep.centroids).to(dev)
    ref = ref_mod.IVFFlatL2(xb, cent_d)
    answers = ref.answers(pool, prep.k, prep.nprobe)
    del ref
    numbers = numbers_of(prep, runs, answers, xb, pool)
    numbers["kmeans_gain"] = ref_mod.kmeans_step_gain(
        xt, torch.from_numpy(prep.program_centroids).to(dev))
    sync(dev)
    return Judged(xb, pool, xt, cent_d, answers, numbers)


def numbers_of(prep: Prepared, runs: list, answers, xb, pool) -> dict:
    """``wrong_answers``, ``bad_slots``, ``recall`` and ``unanswered`` (the
    queries of calls that failed) of the runs' answers against the
    reference's ``answers``."""
    compared = checks.collect(runs, prep.k)
    out = checks.compare(compared, answers, pool, xb,
                         prep.reference.row_distances)
    out["unanswered"] = sum(r.queries_failed for r in runs)
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_process: float, log=print) -> dict:
    """Run the cell once; returns the result line (a dict) and logs the
    set-up parts through ``log``."""
    prep = prepare(cell, seed, device, trace)
    setup_s = time.perf_counter() - t_process
    log("setup " + " ".join(f"{n}={v:.6f}" for n, v in prep.setup.items())
        + f" build_s={prep.build_s:.6f} setup_s={setup_s:.6f}")
    runs, timeline, stats = window(prep, seconds, trace)
    lat = np.asarray(runs[0].latencies_s) * 1e3
    log("window batches_by_second=" + str(np.bincount(np.asarray(
        runs[0].starts_s).astype(np.int64)).tolist()) + " batch_ms p50="
        f"{np.percentile(lat, 50):.6f} p95={np.percentile(lat, 95):.6f}")
    dev = prep.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    sizes = prep.builder.list_sizes(prep.index) if trace else None
    release(prep)
    t = time.perf_counter()
    numbers = judge(prep, runs).numbers
    free(dev)
    log(f"reference_s={time.perf_counter() - t:.6f}")
    for r in runs:
        for e in r.errors[:3]:
            log("failed call: " + e.strip().replace("\n", " | "))

    checked = {n: {"value": numbers[n], "limit": cell.limits[n]}
               for n in CHECKED}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checked.values()),
              "attempted": sum(r.attempted for r in runs),
              "failed": sum(r.queries_failed for r in runs)}
    desc = card.describe(dev, cell.chips, peak)
    if not trace:
        run = runs[0]
        values = {"qps": run.queries_answered / run.window_s,
                  "p95_batch_ms": float(np.percentile(lat, 95)),
                  "recall": numbers["recall"],
                  "peak_mem_gib": peak / 2**30,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = desc
    else:
        obs = Observations(
            build_s=prep.build_s, timeline=timeline, stats=stats,
            call_probes=[prep.batch_probes[i % len(prep.batch_probes)]
                         for i in range(len(runs[0].latencies_s))],
            list_sizes=sizes, d=prep.xb.shape[1], k=prep.k)
        result["metrics"] = {}
        for m in cell.per_layer:
            v = spec.metric_reader(cell, m["name"]).read(obs)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"] = dict(desc, busy_s=timeline.busy_s,
                                window_s=timeline.window_s)
        result["breakdown"] = {"device_ops": timeline.device_ops(),
                               "idle_gaps": timeline.idle_gaps()}
    result["power_limit"] = card.power_limit() if dev.type == "cuda" else ""
    result["checks"] = checked
    return result
