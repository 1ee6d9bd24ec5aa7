"""IVF-Flat under L2 (faiss "IVF<nlist>,Flat"), built and searched through
the port's public API: ``make_ivf_flat``, ``train``, ``add`` and
``IndexIVF.search(x, k, params=SearchParametersIVF(nprobe=...))``, numpy
in and numpy out, as faiss users and the port's C handle call it.

The index that the window searches takes the benchmark's own coarse
centroids through faiss's pre-trained quantizer route (the quantizer
filled with them, ``quantizer_trains_alone = 1``, then ``train``); the
program's own k-means runs on an index of its own, timed and checked."""

from __future__ import annotations

import numpy as np


def create(index_cfg: dict, d: int, device):
    """The empty index; the harness times its ``train`` and ``add``."""
    import tpu_ann_torch as T

    if index_cfg.get("metric", "L2") != "L2":
        raise ValueError("ivf_flat: only the L2 metric is configured")
    index = T.make_ivf_flat(d, index_cfg["nlist"], device=device)
    index.cp.niter = index_cfg["kmeans_niter"]
    return index


def with_centroids(index, cent: np.ndarray, xt: np.ndarray):
    """Make ``index`` (empty, untrained) search the lists of ``cent``, the
    benchmark's (nlist, d) float32 table: the quantizer takes the table as
    it is and ``train`` passes it through."""
    index.quantizer.train(cent)
    index.quantizer.add(cent)
    index.quantizer_trains_alone = 1
    index.train(xt)
    return index


def _params(nprobe: int):
    import tpu_ann_torch as T

    return T.SearchParametersIVF(nprobe=nprobe)


def searcher(index, k: int, nprobe: int):
    """``call(x) -> (D, I)``: the timed path."""
    params = _params(nprobe)
    return lambda x: index.search(x, k, params=params)


def stats_searcher(index, k: int, nprobe: int):
    """``call(x) -> (D, I, SearchStats)``: the same search with the
    fork's coarse / list-scan split, fenced by device syncs."""
    params = _params(nprobe)
    return lambda x: index.search_stats(x, k, params=params)


def probes(index, x: np.ndarray, nprobe: int) -> np.ndarray:
    """(nq, nprobe) lists the coarse quantizer picks for ``x``."""
    return index.coarse_assign(x, nprobe)


def centroids(index) -> np.ndarray:
    """(nlist, d) float32 coarse centroids."""
    return index.quantizer.reconstruct_n(0, index.nlist)


def list_sizes(index) -> np.ndarray:
    return np.asarray(index.list_sizes, np.int64)
