"""State carried over from the JAX package (`tpu_ann`).

Both functions take plain numpy arrays exported from a `tpu_ann` index, so
this module needs neither jax nor tpu_ann, and both packages then search
the very same index whatever their k-means did.
"""

from __future__ import annotations

import numpy as np

from ..models.flat import IndexFlat
from ..models.ivf import IndexIVFFlat
from ..ops.ivf_scan import PackedInvLists


def flat_from_reference(state: dict, device="cuda") -> IndexFlat:
    """A port `IndexFlat` from `tpu_ann` `IndexFlat.state_dict()`
    (keys d, metric, ntotal, xb)."""
    return IndexFlat.from_state(state, device=device)


def ivf_flat_from_reference(state: dict, device="cuda") -> IndexIVFFlat:
    """A search-only port `IndexIVFFlat` from a `tpu_ann` IVF-Flat index's
    arrays, exported as numpy:

      d, metric, nlist, ntotal       ints
      vectors                        (nlist, d) quantizer centroids
      data, ids, norms               the packed invlists
      list_block_start, list_nblocks
      ids_flat                       (ntotal,) int64 user id of each row

    The host vector store does not come across, so the index cannot be
    added to."""
    d, nlist = int(state["d"]), int(state["nlist"])
    metric = int(state["metric"])
    vectors = np.asarray(state["vectors"], np.float32)
    if vectors.shape != (nlist, d):
        raise ValueError(f"vectors must be ({nlist}, {d}), "
                         f"got {vectors.shape}")
    quant = IndexFlat(d, metric, device=device)
    quant.add(vectors)
    index = IndexIVFFlat(quant, d, nlist, metric,
                         block_size=int(np.asarray(state["data"]).shape[1]),
                         device=device)
    index.is_trained = True
    index.invlists = PackedInvLists.from_arrays(
        state["data"], state["ids"], state["norms"],
        state["list_block_start"], state["list_nblocks"], device=device)
    ids_flat = np.asarray(state["ids_flat"], np.int64)
    index.ntotal = int(state["ntotal"])
    index._ids_flat = ids_flat
    index._ids_trivial = bool(
        np.array_equal(ids_flat, np.arange(len(ids_flat), dtype=np.int64)))
    return index
