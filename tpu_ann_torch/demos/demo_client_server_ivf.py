"""Client/server IVF search over TCP (faiss
demos/demo_client_server_ivf.py — contrib/client_server.py's RPC
ClientIndex / SearchServer, on this package's utils/rpc and
utils/client_server).

Starts N shard servers in subprocesses (each owning a slice of the
database, its index on the caller's device), then fans queries from a
ClientIndex and checks recall against an exact search. Every server
exits at its deadline even if this process dies first.

    python -m tpu_ann_torch.demos.demo_client_server_ivf [--device cpu]
"""

import multiprocessing as mp
import socket
import time

import numpy as np

from ..utils.client_server import SearchServer


class CountingServer(SearchServer):
    """A SearchServer that also reports its process's launches of the
    IVF scan kernel (K3)."""

    def kernel_launches(self) -> int:
        from ..ops import ivf_scan_fused

        return int(ivf_scan_fused.LAUNCHES)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _data(d, nb, nt, nq):
    rs = np.random.RandomState(7)
    xb = rs.rand(nb, d).astype(np.float32)
    xt = rs.rand(nt, d).astype(np.float32)
    xq = rs.rand(nq, d).astype(np.float32)
    return xb, xt, xq


def _serve(shard, nshard, port, device, sizes, lifetime_s):
    """One shard server: an IVF over rows [lo, hi) under their global ids,
    served on localhost until ``lifetime_s`` has passed."""
    import torch

    from ..models.ivf import make_ivf_flat
    from ..utils import rpc

    torch.set_num_threads(2)
    deadline = time.monotonic() + lifetime_s
    xb, xt, _ = _data(**sizes)
    nb = sizes["nb"]
    lo, hi = shard * nb // nshard, (shard + 1) * nb // nshard
    index = make_ivf_flat(sizes["d"], nlist=64, device=device)
    index.cp.niter = 5
    index.train(xt)
    index.add_with_ids(xb[lo:hi], np.arange(lo, hi, dtype=np.int64))
    index.nprobe = 32
    srv = rpc.Server(CountingServer(index), port=port, host="127.0.0.1")
    srv.serve_in_background()
    while time.monotonic() < deadline:
        time.sleep(0.2)
    srv.shutdown()


def main(device="cuda", d=32, nb=20_000, nt=5_000, nq=200, k=10, nshard=2,
         timeout_s=180.0):
    import torch

    from ..ops import distances as D
    from ..utils.client_server import ClientIndex
    from ..utils.evaluation import recall_k_at_k

    sizes = {"d": d, "nb": nb, "nt": nt, "nq": nq}
    ctx = mp.get_context("spawn")
    ports = [_free_port() for _ in range(nshard)]
    procs = [ctx.Process(target=_serve, daemon=True,
                         args=(s, nshard, p, str(device), sizes, timeout_s))
             for s, p in enumerate(ports)]
    for p in procs:
        p.start()
    client = None
    try:
        xb, _, xq = _data(**sizes)
        deadline = time.monotonic() + timeout_s
        while client is None:
            try:
                client = ClientIndex([("127.0.0.1", p) for p in ports])
            except OSError:
                dead = [p.exitcode for p in procs if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"shard servers not reachable "
                                       f"(exit codes {dead})") from None
                time.sleep(0.5)
        print(f"connected to {nshard} shards, ntotal={client.ntotal}")

        t0 = time.time()
        _, Im = client.search(xq, k)
        print(f"distributed search: {nq} queries in {time.time()-t0:.2f}s")
        launches = sum(c.kernel_launches() for c in client.sub_indexes)
    finally:
        if client is not None:
            client.close()
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(10)

    _, gt = D.knn(torch.from_numpy(xq).to(device),
                  torch.from_numpy(xb).to(device), k)
    rec = recall_k_at_k(Im, gt.cpu().numpy(), k)
    print(f"recall@{k} vs exact = {rec:.4f}")
    assert rec > 0.9, rec
    print("OK")
    return {"recall": rec, "ntotal": nb, "server_k3_launches": launches}


if __name__ == "__main__":
    from . import cli_device

    main(cli_device(__doc__.splitlines()[0]))
