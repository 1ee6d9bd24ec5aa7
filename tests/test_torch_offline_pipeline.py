"""The offline sharded IVF pipeline of tpu_ann_torch
(utils/offline_pipeline.py) on the CPU, against the JAX package's: the
DAG runner, the train -> shard x N -> merge -> search pipeline with its
resume, a shard in a worker process, and the cross-package files.

The pipeline's device is a field of its config ("cpu" here), written to
config.json, where the worker process reads it: no environment variable
is set for it. The worker process is bounded by the module's
WORKER_TIMEOUT_S (subprocess.run's timeout). Data:
d 24, 6000 rows of integers in [0, 64) from a numpy seed, so every
distance is exact in f32 in both packages. Tolerances: the merged index
equals an index built by one add of all the rows onto the same
trained.tann bit for bit (D and I); the port's pipeline over the
reference's trained.tann equals the reference's pipeline with distances
bit for bit and ids up to ties; each package reads the other's merged
file with the same result."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from tpu_ann.utils import offline_pipeline as JOP
from tpu_ann.utils.index_io import read_index as jread
from tpu_ann_torch.utils.index_io import read_index as tread
from tpu_ann_torch.utils.offline_pipeline import (Job, JobRunner,
                                                  OfflineIVFConfig,
                                                  OfflineIVFPipeline)
from torch_parity import assert_topk_equal

D = 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("offline"))
    r = np.random.RandomState(7)
    xt = r.randint(0, 64, (3000, D)).astype(np.float32)
    xb = r.randint(0, 64, (6000, D)).astype(np.float32)
    xq = r.randint(0, 64, (40, D)).astype(np.float32)
    d2 = ((xq[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10].astype(np.int64)
    p = {"root": tmp}
    for name, arr in (("xt", xt), ("xb", xb), ("xq", xq), ("gt", gt)):
        p[name] = os.path.join(tmp, f"{name}.npy")
        np.save(p[name], arr)
    return p


def _cfg(paths, work, **kw):
    args = dict(factory="IVF32,Flat", d=D, workdir=work,
                xt_path=paths["xt"], xb_path=paths["xb"],
                xq_path=paths["xq"], gt_path=paths["gt"], nshard=3,
                nprobe=8)
    args.update(kw)
    return args


def test_job_runner_deps_and_markers(tmp_path):
    order = []
    jobs = [Job("c", lambda: order.append("c"), deps=("a", "b")),
            Job("a", lambda: order.append("a")),
            Job("b", lambda: order.append("b"), deps=("a",))]
    runner = JobRunner(str(tmp_path))
    assert runner.run(jobs) == ["a", "b", "c"] and order == ["a", "b", "c"]
    order.clear()
    assert runner.run(jobs) == [] and order == []
    with pytest.raises(ValueError, match="unknown dep"):
        runner.run([Job("x", lambda: None, deps=("ghost",))])
    with pytest.raises(RuntimeError, match="cycle"):
        JobRunner(str(tmp_path / "cyc")).run(
            [Job("p", lambda: None, deps=("q",)),
             Job("q", lambda: None, deps=("p",))])


@pytest.fixture(scope="module")
def port_run(paths):
    cfg = OfflineIVFConfig(**_cfg(paths, os.path.join(paths["root"], "t"),
                                  device="cpu", max_workers=2))
    executed = OfflineIVFPipeline(cfg).run()
    return cfg, executed


def test_pipeline_end_to_end_and_resume(paths, port_run):
    """train -> 3 shards -> merge -> search on the CPU; the merged index
    equals one add of all rows onto trained.tann; a second run executes
    nothing; removing a shard's marker reruns that shard and what follows
    it."""
    cfg, executed = port_run
    assert executed[0] == "train" and executed[-2:] == ["merge", "search"]
    assert cfg.search_result["ntotal"] == 6000
    assert cfg.search_result["knn_intersection"] > 0.5
    with open(os.path.join(cfg.workdir, "config.json")) as f:
        assert json.load(f)["device"] == "cpu"
    pipe = OfflineIVFPipeline(cfg)
    merged = tread(pipe.merged_path, device="cpu")
    one = tread(pipe.trained_path, device="cpu")
    one.add(np.load(paths["xb"]))
    xq = np.load(paths["xq"])
    for idx in (merged, one):
        idx.nprobe = 8
    Dm, Im = merged.search(xq, 10)
    Do, Io = one.search(xq, 10)
    np.testing.assert_array_equal(Dm, Do)
    np.testing.assert_array_equal(Im, Io)
    np.testing.assert_array_equal(
        np.load(os.path.join(cfg.workdir, "search_I.npy")), Im)
    assert pipe.run() == []
    for name in ("shard1", "merge", "search"):
        os.remove(os.path.join(cfg.workdir, f"{name}.done"))
    assert set(OfflineIVFPipeline(cfg).run()) == {"shard1", "merge",
                                                  "search"}


def test_pipeline_subprocess_worker(paths, port_run):
    """Two shards, each added in its own Python process on the device that
    config.json names (the CPU): the same merged search as the inline
    run, whose trained.tann it starts from."""
    base, _ = port_run
    work = os.path.join(paths["root"], "sub")
    os.makedirs(work)
    shutil.copy(os.path.join(base.workdir, "trained.tann"), work)
    cfg = OfflineIVFConfig(**_cfg(paths, work, nshard=2, device="cpu",
                                  use_subprocess=True))
    pipe = OfflineIVFPipeline(cfg)
    pipe._step_train = lambda: _config_only(pipe)
    assert pipe.run() == ["train", "shard0", "shard1", "merge", "search"]
    assert cfg.search_result["ntotal"] == 6000
    for name in ("search_D.npy", "search_I.npy"):
        np.testing.assert_array_equal(
            np.load(os.path.join(work, name)),
            np.load(os.path.join(base.workdir, name)))


def _config_only(pipe) -> None:
    """The train step of a pipeline whose trained.tann is already there:
    only config.json."""
    cfg = pipe.cfg
    with open(os.path.join(cfg.workdir, "config.json"), "w") as f:
        json.dump({"nb": int(np.load(cfg.xb_path, mmap_mode="r").shape[0]),
                   "nshard": cfg.nshard, "xb_path": cfg.xb_path,
                   "device": cfg.device}, f)


def test_pipeline_over_the_references_files(paths):
    """The reference's pipeline trains; the port's runs the shards, the
    merge and the search from that trained.tann: the same search result;
    and each package reads the other's merged.tann."""
    jwork = os.path.join(paths["root"], "j")
    jcfg = JOP.OfflineIVFConfig(**_cfg(paths, jwork))
    JOP.OfflineIVFPipeline(jcfg).run()
    twork = os.path.join(paths["root"], "tj")
    os.makedirs(twork)
    shutil.copy(os.path.join(jwork, "trained.tann"), twork)
    tcfg = OfflineIVFConfig(**_cfg(paths, twork, device="cpu"))
    pipe = OfflineIVFPipeline(tcfg)
    pipe._step_train = lambda: _config_only(pipe)
    pipe.run()
    assert tcfg.search_result["ntotal"] == jcfg.search_result["ntotal"]
    Dj = np.load(os.path.join(jwork, "search_D.npy"))
    Ij = np.load(os.path.join(jwork, "search_I.npy"))
    Dt = np.load(os.path.join(twork, "search_D.npy"))
    It = np.load(os.path.join(twork, "search_I.npy"))
    assert_topk_equal(Dj, Ij, Dt, It)
    xq = np.load(paths["xq"])
    for reader, path in ((jread, os.path.join(twork, "merged.tann")),
                         (lambda p: tread(p, device="cpu"),
                          os.path.join(jwork, "merged.tann"))):
        idx = reader(path)
        idx.nprobe = 8
        assert_topk_equal(Dj, Ij, *idx.search(xq, 10))
