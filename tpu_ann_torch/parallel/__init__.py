"""Sharding, replication and distributed search and clustering over
`torch.distributed` — PyTorch counterpart of `tpu_ann/parallel`."""

from .sharded import (  # noqa: F401
    Mesh,
    initialize_multihost,
    kmeans_distributed,
    local_rows,
    make_mesh,
    shard_rows,
    sharded_ivf_scan,
    sharded_ivf_scan_pq,
    sharded_kmeans_iter,
    sharded_knn,
    sharded_refine,
)
