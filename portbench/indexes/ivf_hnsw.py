"""The fork's namesake ``IndexIVFHNSW(d, nlist, M)``: IVF-Flat under L2
whose coarse quantizer is an HNSW graph over the centroids. Searched as
IVF-Flat is (it inherits ``IndexIVF.search``), in the configured
``coarse_mode``. The benchmark's centroids go into the HNSW quantizer as
they go into a flat one (``with_centroids``): its ``add`` builds the
graph over them."""

from __future__ import annotations

from portbench.indexes.ivf_flat import (  # noqa: F401
    centroids, list_sizes, probes, searcher, stats_searcher, with_centroids)


def create(index_cfg: dict, d: int, device):
    """The empty index; the harness times its ``train`` and ``add``."""
    import tpu_ann_torch as T

    if index_cfg.get("metric", "L2") != "L2":
        raise ValueError("ivf_hnsw: only the L2 metric is configured")
    index = T.IndexIVFHNSW(d, index_cfg["nlist"], M=index_cfg["M"],
                           device=device)
    index.set_hnsw_parameters(efConstruction=index_cfg["efConstruction"])
    index.coarse_mode = index_cfg["coarse_mode"]
    index.cp.niter = index_cfg["kmeans_niter"]
    return index
