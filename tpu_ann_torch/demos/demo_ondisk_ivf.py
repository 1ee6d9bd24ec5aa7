"""On-disk IVF demo (faiss demos/demo_ondisk_ivf.py): build shards, save
them, merge on disk, reopen memory-mapped, search.

    python -m tpu_ann_torch.demos.demo_ondisk_ivf [--device cpu]
"""

import os
import tempfile

import numpy as np


def main(device="cuda", d=64, nt=20000, nb=100000, nq=200, nlist=256,
         M=16, nshard=4, nprobe=16, k=10):
    from ..models.ivf_hnsw import IndexIVFHNSW
    from ..utils.datasets import SyntheticDataset
    from ..utils.evaluation import recall_at_r
    from ..utils.index_io import read_index
    from ..utils.invlists_io import FileInvlistSource, merge_ondisk

    ds = SyntheticDataset(d=d, nt=nt, nb=nb, nq=nq, device=device)
    xb = ds.get_database()
    with tempfile.TemporaryDirectory() as tmp:
        # 1. train one quantizer, build the shards sharing it
        master = IndexIVFHNSW(d, nlist=nlist, M=M, device=device)
        master.train(ds.get_train())
        shards = []
        per = len(xb) // nshard
        for s in range(nshard):
            sh = IndexIVFHNSW(d, nlist=nlist, M=M, device=device)
            sh.quantizer = master.quantizer
            sh.is_trained = True
            sh.add_with_ids(xb[s * per:(s + 1) * per],
                            np.arange(s * per, (s + 1) * per))
            p = os.path.join(tmp, f"shard{s}.tann")
            sh.save_to_disk(p)
            shards.append(p)
            print(f"shard {s}: {sh.ntotal} vectors -> {p}")

        # 2. stream-merge the shard FILES into one index file without
        # loading them (OnDiskInvertedLists::merge_from_multiple +
        # contrib/ondisk.py merge_ondisk; peak host memory = one list)
        merged = os.path.join(tmp, "merged.tann")
        empty = IndexIVFHNSW(d, nlist=nlist, M=M, device=device)
        empty.quantizer = master.quantizer
        empty.is_trained = True
        n = merge_ondisk(empty, [FileInvlistSource(p) for p in shards],
                         merged)
        print(f"merged: {n} vectors -> {merged}")

        # 3. reopen memory-mapped (IO_FLAG_MMAP role) and search
        index = read_index(merged, mmap=True, device=device)
        index.nprobe = nprobe
        _, I = index.search(ds.get_queries(), k)
    rec = recall_at_r(I, ds.get_groundtruth(k), k)
    print(f"mmap search recall@{k} = {rec:.4f}")
    assert n == nshard * per, n
    return {"merged": n, "recall": rec}


if __name__ == "__main__":
    from . import cli_device

    main(cli_device(__doc__.splitlines()[0]))
