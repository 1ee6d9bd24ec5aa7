"""Out-of-core paged IVF demo — search an index bigger than device memory.

faiss role: the fork's whole 190-series workflow — build, save, reopen
with IO_FLAG_MMAP, search without loading the inverted lists into RAM
(tutorial/python/190-hnsw-ivf-test.py:1404-1427;
invlists/OnDiskInvertedLists.h:60-136; gpu/GpuIndex.h:70+ auto-paging).

Here the packed invlist blocks stay on disk (np.memmap); per query batch
the coarse pass plans contiguous block windows, and a double-buffered
pinned host-to-device upload overlaps each window's transfer with the
previous window's scan (the window kernel K4 on the card). An optional
hot tier pins the first `resident_blocks` of the stream on the device.
The shapes are scaled down so the demo runs anywhere, the CPU included.

    python -m tpu_ann_torch.demos.demo_paged_outofcore [--device cpu]
"""

import os
import tempfile

import numpy as np


def build(path, xt, xb, nlist=512, device="cuda"):
    """Train on a sample, stream the database to disk (two-pass build),
    save; returns the index."""
    from ..models.ivf_paged import IndexIVFFlatPaged

    idx = IndexIVFFlatPaged(xb.shape[1], nlist=nlist, path=path,
                            device=device)
    idx.train(xt)
    idx.add(xb)
    idx.save()
    return idx


def reopen(path, nprobe=16, resident_frac=4, device="cuda"):
    """Reopen memory-mapped (only the centroids and the list metadata are
    resident) with the first 1 / resident_frac of the stream on the device
    as the hot tier."""
    from ..models.ivf_paged import IndexIVFFlatPaged
    from ..ops.ivf_scan_paged import upload_resident

    idx = IndexIVFFlatPaged.load(path, device=device)
    idx.nprobe = nprobe
    idx.resident_blocks = idx.invlists.nblocks // resident_frac
    idx._resident = upload_resident(idx.invlists, idx.resident_blocks,
                                    device=device)
    return idx


def main(device="cuda", d=64, nt=20000, nb=200000, nq=200, nlist=512,
         nprobe=16, k=10):
    import torch

    from ..ops import distances as D
    from ..utils.datasets import SyntheticDataset

    ds = SyntheticDataset(d=d, nt=nt, nb=nb, nq=nq, device=device)
    xb, xq = ds.get_database(), ds.get_queries()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "big.paged")
        # 1. build: train on a sample, stream the database to disk
        idx = build(path, ds.get_train(), xb, nlist, device)
        print(f"built + saved: ntotal={idx.ntotal:,} "
              f"blocks={idx.invlists.nblocks:,} at {path}")
        del idx

        # 2. reopen memory-mapped, a quarter of the stream resident
        idx = reopen(path, nprobe, device=device)
        _, Iv = idx.search(xq, k)
        del idx

    # 3. verify against exact brute force (f32 on the same device)
    _, gt_i = D.knn(torch.from_numpy(xq).to(device),
                    torch.from_numpy(xb).to(device), k)
    gt_i = gt_i.cpu().numpy()
    recall = float(np.mean([len(set(Iv[q]) & set(gt_i[q])) / k
                            for q in range(len(xq))]))
    print(f"recall@{k} vs exact: {recall:.4f} (nprobe={nprobe})")
    assert recall > 0.85, recall
    print("demo ok")
    return {"recall": recall}


if __name__ == "__main__":
    from . import cli_device

    main(cli_device(__doc__.splitlines()[0]))
