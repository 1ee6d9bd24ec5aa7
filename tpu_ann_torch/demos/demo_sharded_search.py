"""Sharded search demo (the role of faiss
demos/demo_client_server_ivf.py with the RPC replaced by collectives):
one distributed k-means step and an exact search over a database
row-sharded across a torch.distributed world of 2 replicas x 2 shards
(tpu_ann_torch.parallel).

The world is started here (`run_world`): one process a rank, gloo on the
CPU and for ranks that share one card (NCCL refuses two ranks on one
device), NCCL where each rank has a card of its own; every process is
bounded by a deadline.

    python -m tpu_ann_torch.demos.demo_sharded_search [--device cpu]
"""

import datetime
import multiprocessing as mp
import os
import pickle
import socket
import tempfile
import time
import traceback

import numpy as np


def world_layout(world: int, device="cuda"):
    """(backend, the device of each rank) for a world of ``world`` ranks on
    ``device``: NCCL and a card a rank where there are enough cards, gloo
    and the one device otherwise."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and \
            torch.cuda.device_count() >= world > 1:
        return "nccl", [f"cuda:{r}" for r in range(world)]
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return "gloo", [str(dev)] * world


def _rank_main(fn, rank, world, port, backend, device, outdir, args,
               timeout_s):
    """Body of one spawned rank: joins the world, runs fn(device, *args),
    pickles its result to outdir/rank<r>.pkl (a failure: its traceback to
    rank<r>.err, exit 1)."""
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(2)
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(
            backend=backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(device, *args)
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(fn, world: int, device="cuda", args=(), timeout_s=120.0):
    """Runs ``fn(rank_device, *args)`` in ``world`` spawned processes
    joined in one torch.distributed process group (`world_layout`), under
    one deadline: a process still running then is killed. ``fn`` must be a
    module-level function. Returns each rank's result; raises with the
    ranks' tracebacks if any failed or hung."""
    backend, devices = world_layout(world, device)
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as outdir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, port, backend, devices[r],
                                   outdir, tuple(args), timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * world:
            errs = {}
            for r in range(world):
                e = os.path.join(outdir, f"rank{r}.err")
                if os.path.exists(e):
                    with open(e) as f:
                        errs[r] = f.read()[-3000:]
            raise RuntimeError(f"the {world}-rank world failed: exit codes "
                               f"{codes}, killed {len(hung)}; {errs}")
        out = []
        for r in range(world):
            with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _sharded_rank(device, n_shards, n_replicas, nb, nq, d, k, nc):
    """One rank of the demo: a k-means step over its rows of the training
    set, then the sharded exact search held against a one-device one."""
    import torch

    from ..ops import distances as D
    from ..parallel import (local_rows, make_mesh, sharded_kmeans_iter,
                            sharded_knn)

    mesh = make_mesh(n_shards=n_shards, n_replicas=n_replicas, device=device)
    rs = np.random.RandomState(0)
    xb = rs.rand(nb, d).astype(np.float32)
    xq = rs.rand(nq, d).astype(np.float32)

    # distributed k-means step (all-reduce of per-centroid sums)
    cent, counts, obj = sharded_kmeans_iter(
        local_rows(xb, mesh, axis="world"), xb[:nc], nc, mesh=mesh)

    # sharded exact search: db row-sharded, queries replica-split,
    # all_gather + k-select merge (the ClientIndex / ResultHeap role)
    Ds, Is = sharded_knn(xq, local_rows(xb, mesh), k, mesh=mesh)
    dev = mesh.device
    _, Ir = D.knn(torch.from_numpy(xq).to(dev), torch.from_numpy(xb).to(dev),
                  k)
    agree = float((Is == Ir).float().mean())
    return {"replica": mesh.replica, "shard": mesh.shard, "obj": float(obj),
            "count": float(counts.sum()), "agree": agree}


def main(device="cuda", nb=40000, nq=1000, d=64, k=10, nc=64, n_shards=2,
         n_replicas=2, timeout_s=180.0):
    world = n_shards * n_replicas
    print(f"mesh: replica={n_replicas} x shard={n_shards} "
          f"({world_layout(world, device)[0]})")
    ranks = run_world(_sharded_rank, world, device,
                      (n_shards, n_replicas, nb, nq, d, k, nc), timeout_s)
    r0 = ranks[0]
    print(f"kmeans step: obj={r0['obj']:.1f}")
    print(f"sharded == single-device: {r0['agree']:.4f}")
    for r in ranks:
        assert r["obj"] == r0["obj"] and r["agree"] == r0["agree"], ranks
    assert r0["count"] == nb, r0
    return {"obj": r0["obj"], "agree": r0["agree"], "world": world}


if __name__ == "__main__":
    from . import cli_device

    main(cli_device(__doc__.splitlines()[0]))
