"""Distributed index serving over TCP — PyTorch counterpart of
`tpu_ann/utils/client_server.py`, the role of the reference's
``contrib/client_server.py`` (SearchServer / run_index_server /
ClientIndex) and ``benchs/distributed_ondisk/search_server.py``.

Each server process hosts one index shard (an IVF over a slice of the
rows with their global ids, say); the client fans each query batch out to
every shard in parallel and merges the partial top-k sets on the host
(client_server.py:85-91's ``ResultHeap`` merge: one stable sort of the
concatenated candidates, so on equal distances the lower shard wins).

A server answers with the numpy result of its index's ``search``: the
copy off the card is synchronised, so the served result is the device's.
Results carry f32 distances + int64 ids; queries travel as one numpy frame
a batch. The frames are `rpc`'s, the JAX package's, so a port client
fans out over servers of either package.
"""

from __future__ import annotations

from multiprocessing.pool import ThreadPool
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from . import rpc


class SearchServer:
    """RPC handler exposing an index (= client_server.py:17-34).

    Known setters are explicit; everything else forwards to the index, so
    remote callers can reach ``reconstruct``, ``range_search`` etc.
    """

    def __init__(self, index: Any):
        self.index = index

    def set_nprobe(self, nprobe: int) -> None:
        ivf = _extract_ivf(self.index)
        if ivf is None:
            raise AttributeError("index has no IVF layer")
        ivf.nprobe = int(nprobe)

    def get_ntotal(self) -> int:
        return int(self.index.ntotal)

    def search(self, x: np.ndarray, k: int):
        D, I = self.index.search(np.ascontiguousarray(x, np.float32), k)
        return np.asarray(D, np.float32), np.asarray(I, np.int64)

    def __getattr__(self, name: str):
        return getattr(self.index, name)


def _extract_ivf(index: Any) -> Optional[Any]:
    """Walk wrapper layers to the IVF index (contrib-style
    ``extract_index_ivf``)."""
    seen = set()
    while index is not None and id(index) not in seen:
        seen.add(id(index))
        if hasattr(index, "nprobe") and hasattr(index, "nlist"):
            return index
        index = getattr(index, "base_index", None) or \
            getattr(index, "index", None)
    return None


def run_index_server(index: Any, port: int = 0, v6: bool = False,
                     **kw) -> None:
    """Serve requests for ``index`` forever
    (= client_server.py:36-40)."""
    rpc.run_server(lambda: SearchServer(index), port=port, v6=v6, **kw)


class ClientIndex:
    """Fans searches over a set of remote shard servers and merges
    (= client_server.py:47-91).

    Exposes the local Index calling convention (``d``-less: the remote
    shards own the data), so it drops into evaluation / autotune code
    unchanged.
    """

    def __init__(self, machine_ports: Sequence[Tuple[str, int]],
                 v6: bool = False, similarity: bool = False):
        self.sub_indexes: List[rpc.Client] = [
            rpc.Client(host, port, v6) for host, port in machine_ports]
        self.ni = len(self.sub_indexes)
        self.similarity = similarity  # True for METRIC_INNER_PRODUCT
        self.pool = ThreadPool(self.ni)
        self.ntotal = self.get_ntotal()  # doubles as a connection test
        self.verbose = False

    def set_nprobe(self, nprobe: int) -> None:
        self.pool.map(lambda c: c.set_nprobe(nprobe), self.sub_indexes)

    def get_ntotal(self) -> int:
        return sum(self.pool.map(lambda c: c.get_ntotal(),
                                 self.sub_indexes))

    def search(self, x: np.ndarray, k: int):
        """Merge shard top-k sets into a global (nq, k).

        Ordering convention matches the shards' own output (L2
        ascending), so the merge is a plain per-row sort of ni*k
        candidates — invalid slots (-1 ids) are pushed to +inf first.
        """
        x = np.ascontiguousarray(x, np.float32)
        parts = self.pool.map(lambda c: c.search(x, k), self.sub_indexes)
        D = np.concatenate([p[0] for p in parts], axis=1)
        I = np.concatenate([p[1] for p in parts], axis=1)
        bad = -np.inf if self.similarity else np.inf
        D = np.where(I < 0, bad, D)
        key = -D if self.similarity else D
        order = np.argsort(key, axis=1, kind="stable")[:, :k]
        Dm = np.take_along_axis(D, order, axis=1)
        Im = np.take_along_axis(I, order, axis=1)
        Im = np.where(np.isinf(Dm), -1, Im)
        return Dm, Im

    def close(self) -> None:
        for c in self.sub_indexes:
            c.close()
        self.pool.close()
