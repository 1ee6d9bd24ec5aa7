"""A gloo world of CPU processes for the port's sharded tests
(test_torch_sharded.py, test_torch_multihost.py).

`spawn_world` starts ``nprocs`` processes with the spawn start method, each
running ``fn(rank, nprocs, port, *args)``, and joins them under one
deadline: a process still running then (a hung collective) is killed, and
the caller's test fails instead of holding the suite. This module imports
neither jax nor the JAX package: the children load only torch and
tpu_ann_torch."""

import multiprocessing
import os
import pickle
import socket
import time
import traceback

import numpy as np


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_world(fn, nprocs: int, args=(), timeout: float = 120.0):
    """Runs fn(rank, nprocs, port, *args) in nprocs spawned processes.
    Returns (exit codes, whether any process had to be killed)."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=fn, args=(r, nprocs, port) + tuple(args))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    return [p.exitcode for p in procs], bool(hung)


def _join(rank, world, port, timeout_s=60.0):
    import torch

    from tpu_ann_torch.parallel import initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo",
                         timeout_s=timeout_s)


def _run(rank, outdir, body):
    """body() -> dict of results, pickled to outdir/rank<r>.pkl; a failure
    writes its traceback to outdir/rank<r>.err and exits 1."""
    try:
        out = body()
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        import torch.distributed as dist

        dist.barrier()                 # no rank leaves while others work
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def _np(res):
    return tuple(t.cpu().numpy() for t in res)


def sharded_scenarios(rank, world, port, inputs, outdir):
    """Every scenario of test_torch_sharded.py, once, on a 2 x 2 mesh."""
    def body():
        import torch

        from tpu_ann_torch import parallel as P
        from tpu_ann_torch.ops import distances as TD
        from tpu_ann_torch.ops.ivf_scan import (
            PackedCodeInvLists,
            PackedInvLists,
        )

        _join(rank, world, port)
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        mesh = P.make_mesh(2, 2, device="cpu")
        out = {"rank": rank, "shard": mesh.shard, "replica": mesh.replica}

        a = inp["knn"]
        xb_p = P.shard_rows(a["xb"], 2)
        out["knn"] = _np(P.sharded_knn(a["xq"], P.local_rows(xb_p, mesh),
                                       a["k"], mesh=mesh,
                                       valid_n=len(a["xb"])))
        try:
            P.sharded_knn(a["xq"][:7], P.local_rows(xb_p, mesh), a["k"],
                          mesh=mesh)
            out["knn_nq7"] = "answered"
        except ValueError as e:
            out["knn_nq7"] = str(e)

        a = inp["knn_ip"]
        out["knn_ip"] = _np(P.sharded_knn(
            a["xq"], P.local_rows(a["xb"], mesh), a["k"],
            TD.METRIC_INNER_PRODUCT, mesh=mesh))

        a = inp["kmeans_iter"]
        out["kmeans_iter"] = _np(P.sharded_kmeans_iter(
            P.local_rows(a["x"], mesh, axis="world"), a["cent"], a["k"],
            mesh=mesh))

        a = inp["kmeans_distributed"]
        out["kmeans_distributed"] = P.kmeans_distributed(
            a["x"], a["k"], mesh=mesh, niter=a["niter"])

        for nbits in (8, 4):
            a = inp[f"pq{nbits}"]
            s = a["shards"][mesh.shard]
            pil = PackedCodeInvLists(
                codes=torch.from_numpy(s["codes"]),
                ids=torch.from_numpy(s["ids"]),
                list_block_start=torch.from_numpy(s["lbs"]),
                list_nblocks=torch.from_numpy(s["lnb"]))
            out[f"pq{nbits}"] = _np(P.sharded_ivf_scan_pq(
                a["xq"], a["probes"], a["cd"], pil, a["books"], a["cent"],
                a["k"], max_nblocks=a["mnb"], packed4=nbits == 4,
                mesh=mesh))

        a = inp["ivf"]
        s = a["shards"][mesh.shard]
        pil = PackedInvLists.from_arrays(s["data"], s["ids"], s["norms"],
                                         s["lbs"], s["lnb"], device="cpu")
        for fused in (False, True):
            out[f"ivf_fused{int(fused)}"] = _np(P.sharded_ivf_scan(
                a["xq"], a["probes"], pil, a["k"], max_nblocks=a["mnb"],
                mesh=mesh, fused=fused))

        a = inp["refine"]
        for k in (a["k"], a["k_wide"]):
            out[f"refine{k}"] = _np(P.sharded_refine(
                a["xq"], a["cand"], P.local_rows(a["xb"], mesh), k,
                mesh=mesh))
        return out

    _run(rank, outdir, body)


def multihost_knn(rank, world, port, outdir):
    """test_torch_multihost.py's world: each process holds half of xb and
    joins through initialize_multihost; sharded_knn over both halves."""
    def body():
        from tpu_ann_torch.parallel import make_mesh, sharded_knn

        _join(rank, world, port)
        import torch.distributed as dist

        if dist.get_world_size() != 2:
            raise RuntimeError(f"world size {dist.get_world_size()}")
        rs = np.random.RandomState(0)
        xb = rs.randn(256, 16).astype(np.float32)
        xq = rs.randn(8, 16).astype(np.float32)
        mesh = make_mesh(n_shards=2, device="cpu")
        Dv, Iv = sharded_knn(xq, xb[rank * 128:(rank + 1) * 128], 4,
                             mesh=mesh)
        return {"D": Dv.numpy(), "I": Iv.numpy(), "xb": xb, "xq": xq}

    _run(rank, outdir, body)
