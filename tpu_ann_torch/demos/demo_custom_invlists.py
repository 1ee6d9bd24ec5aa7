"""Custom inverted-list storage backend demo (faiss demos/rocksdb_ivf/ —
a RocksDBInvertedLists registered through InvertedListsIOHook so an IVF
index can serve lists from an external key-value store).

The extension point is the `InvlistSource` protocol
(tpu_ann_torch/utils/invlists_io.py) instead of a C++ IOHook vtable. Any
object with {nlist, coded, width, list_size(i), get_list(i)} plugs into
the streaming machinery — composition views, `merge_ondisk`, and the
device repack — so a key-value store becomes searchable by writing one
small adapter class. Here the store is stdlib sqlite3 (standing in for
RocksDB): one row per inverted list, payload and ids as raw blobs, in the
JAX package's table schema, so either package reads the other's store.

    python -m tpu_ann_torch.demos.demo_custom_invlists [--device cpu]
"""

import os
import sqlite3
import tempfile

import numpy as np


class SQLiteInvertedLists:
    """InvlistSource adapter over a sqlite3 table (RocksDBInvertedLists
    role, demos/rocksdb_ivf/RocksDBInvertedLists.h)."""

    def __init__(self, path: str, nlist: int = 0, width: int = 0,
                 coded: bool = False, create: bool = False):
        self.conn = sqlite3.connect(path)
        if create:
            self.conn.execute(
                "CREATE TABLE IF NOT EXISTS meta "
                "(nlist INTEGER, width INTEGER, coded INTEGER)")
            self.conn.execute(
                "CREATE TABLE IF NOT EXISTS lists "
                "(list_no INTEGER PRIMARY KEY, size INTEGER, "
                "payload BLOB, ids BLOB)")
            self.conn.execute("DELETE FROM meta")
            self.conn.execute("INSERT INTO meta VALUES (?,?,?)",
                              (nlist, width, int(coded)))
            self.conn.commit()
        row = self.conn.execute("SELECT * FROM meta").fetchone()
        self.nlist, self.width, self.coded = row[0], row[1], bool(row[2])
        self._pdtype = np.uint8 if self.coded else np.float32

    # --- write side (add_entries role) -----------------------------------
    def put_list(self, list_no: int, payload: np.ndarray,
                 ids: np.ndarray) -> None:
        payload = np.ascontiguousarray(payload, self._pdtype)
        ids = np.ascontiguousarray(ids, np.int64)
        self.conn.execute(
            "INSERT OR REPLACE INTO lists VALUES (?,?,?,?)",
            (int(list_no), len(ids), payload.tobytes(), ids.tobytes()))

    def commit(self) -> None:
        self.conn.commit()

    def close(self) -> None:
        self.conn.close()

    # --- InvlistSource protocol -------------------------------------------
    def list_size(self, i: int) -> int:
        row = self.conn.execute(
            "SELECT size FROM lists WHERE list_no=?", (i,)).fetchone()
        return 0 if row is None else int(row[0])

    def get_list(self, i: int):
        row = self.conn.execute(
            "SELECT size, payload, ids FROM lists WHERE list_no=?",
            (i,)).fetchone()
        if row is None:
            return (np.zeros((0, self.width), self._pdtype),
                    np.zeros(0, np.int64))
        sz, payload, ids = row
        return (np.frombuffer(payload, self._pdtype).reshape(sz, self.width),
                np.frombuffer(ids, np.int64))

    @property
    def ntotal(self) -> int:
        row = self.conn.execute("SELECT SUM(size) FROM lists").fetchone()
        return int(row[0] or 0)


def store_lists(index, path: str) -> SQLiteInvertedLists:
    """Pour an IVF-Flat index's lists into a new sqlite store at path."""
    from ..utils.contrib import get_invlist

    kv = SQLiteInvertedLists(path, nlist=index.nlist, width=index.d,
                             create=True)
    for l in range(index.nlist):
        ids, payload = get_invlist(index, l)
        kv.put_list(l, payload, ids)
    kv.commit()
    return kv


def merge_store(index, kv, dst: str, device="cuda", nprobe: int = 16):
    """Stream a store's lists into an index file under ``index``'s trained
    quantizer (the merge_ondisk path OnDisk / File sources use; peak host
    memory one list) and reopen it memory-mapped. Returns (rows merged,
    the reopened index)."""
    from ..utils.factory import index_factory
    from ..utils.index_io import read_index
    from ..utils.invlists_io import merge_ondisk

    shell = index_factory(index.d, f"IVF{index.nlist},Flat",
                          index.metric_type, device=device)
    shell.quantizer = index.quantizer
    shell.is_trained = True
    n = merge_ondisk(shell, [kv], dst)
    merged = read_index(dst, mmap=True, device=device)
    merged.nprobe = nprobe
    return n, merged


def main(device="cuda", d=64, nt=10000, nb=50000, nq=100, nlist=128,
         nprobe=16, k=10):
    from ..utils.datasets import SyntheticDataset
    from ..utils.evaluation import knn_intersection_measure
    from ..utils.factory import index_factory

    ds = SyntheticDataset(d=d, nt=nt, nb=nb, nq=nq, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        # 1. build a normal in-memory IVF index
        index = index_factory(d, f"IVF{nlist},Flat", device=device)
        index.train(ds.get_train())
        index.add(ds.get_database())
        index.nprobe = nprobe
        _, I_ref = index.search(ds.get_queries(), k)

        # 2. pour its lists into the key-value store
        db_path = os.path.join(tmp, "invlists.sqlite")
        kv = store_lists(index, db_path)
        stored = kv.ntotal
        print(f"stored {stored} vectors in {index.nlist} sqlite rows "
              f"({os.path.getsize(db_path) / 1e6:.1f} MB)")

        # 3. stream the store back into a searchable index file
        n, index2 = merge_store(index, kv, os.path.join(
            tmp, "from_sqlite.tann"), device=device, nprobe=nprobe)
        kv.close()
        _, I_new = index2.search(ds.get_queries(), k)

    inter = knn_intersection_measure(I_ref, I_new)
    print(f"merged {n} vectors from sqlite; "
          f"result intersection vs in-memory index = {inter:.4f}")
    assert inter == 1.0
    return {"stored": stored, "merged": n, "intersection": inter}


if __name__ == "__main__":
    from . import cli_device

    main(cli_device(__doc__.splitlines()[0]))
