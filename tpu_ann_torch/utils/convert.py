"""State carried over from the JAX package (`tpu_ann`).

These functions take plain numpy arrays exported from a `tpu_ann` index, so
this module needs neither jax nor tpu_ann, and both packages then search
the very same index whatever their k-means did.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.flat import IndexFlat
from ..models.hnsw import IndexHNSWFlat
from ..models.ivf import IndexIVFFlat
from ..models.ivf_hnsw import IndexIVFHNSW
from ..models.ivf_pq import IndexIVFScalarQuantizer
from ..models.pq import IndexScalarQuantizer
from ..ops import sq as SQ
from ..ops.distances import METRIC_L2
from ..ops.hnsw import HNSWGraph
from ..ops.ivf_scan import PackedCodeInvLists, PackedInvLists


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
    index = _ivf_shell(IndexIVFFlat, state, np.asarray(state["data"]),
                       device)
    index.invlists = PackedInvLists.from_arrays(
        state["data"], state["ids"], state["norms"],
        state["list_block_start"], state["list_nblocks"], device=device)
    return index


def hnsw_from_reference(state: dict, device="cuda") -> IndexHNSWFlat:
    """A port `IndexHNSWFlat` that searches the graph of a `tpu_ann` one,
    from its arrays as numpy:

      d, metric, M, efSearch, efConstruction   ints
      xb                     (ntotal, d) storage vectors
      neighbors0, upper_ids, upper_neighbors, levels, entry, max_level
                             the HNSWGraph's arrays and scalars
      coarse_assign          optional: the build's coarse assignment (the
                             spatial order of the fused tiles)"""
    d, M = int(state["d"]), int(state["M"])
    index = IndexHNSWFlat(d, M, int(state["metric"]), device=device)
    for key in ("efSearch", "efConstruction"):
        if key in state:
            setattr(index.hnsw, key, int(state[key]))
    index.storage.add(np.asarray(state["xb"], np.float32))
    index.ntotal = index._built_n = index.storage.ntotal

    def up(name):
        return torch.tensor(np.asarray(state[name], np.int32), device=device)

    index.graph = HNSWGraph(
        neighbors0=up("neighbors0"), upper_ids=up("upper_ids"),
        upper_neighbors=up("upper_neighbors"), levels=up("levels"),
        entry=int(state["entry"]), max_level=int(state["max_level"]))
    ca = state.get("coarse_assign")
    index._coarse_assign = None if ca is None else np.asarray(ca, np.int64)
    return index


def ivf_hnsw_from_reference(state: dict, device="cuda") -> IndexIVFHNSW:
    """A search-only port `IndexIVFHNSW` from a `tpu_ann` one: the keys of
    `ivf_flat_from_reference` without ``vectors``, plus ``quantizer``, the
    `hnsw_from_reference` state of its HNSW quantizer (whose storage holds
    the centroids)."""
    quant = hnsw_from_reference(state["quantizer"], device=device)
    index = _ivf_shell(IndexIVFHNSW, state, np.asarray(state["data"]),
                       device, quantizer=quant)
    index.invlists = PackedInvLists.from_arrays(
        state["data"], state["ids"], state["norms"],
        state["list_block_start"], state["list_nblocks"], device=device)
    return index


def _ivf_shell(cls, state: dict, stored: np.ndarray, device, *,
               quantizer=None, **kw):
    """A search-only IVF index of class ``cls`` with the reference's
    quantizer centroids (an IndexFlat over ``state["vectors"]``, or the
    given quantizer) and id map; the caller sets its invlists."""
    d, nlist = int(state["d"]), int(state["nlist"])
    metric = int(state["metric"])
    if quantizer is None:
        vectors = np.asarray(state["vectors"], np.float32)
        if vectors.shape != (nlist, d):
            raise ValueError(f"vectors must be ({nlist}, {d}), "
                             f"got {vectors.shape}")
        quantizer = IndexFlat(d, metric, device=device)
        quantizer.add(vectors)
    if cls is IndexIVFHNSW:
        index = cls(d, nlist, metric, M=quantizer.hnsw.M,
                    block_size=stored.shape[1], device=device)
        index.quantizer = quantizer
    else:
        index = cls(quantizer, d, nlist, metric=metric,
                    block_size=stored.shape[1], device=device, **kw)
    index.is_trained = True
    ids_flat = np.asarray(state["ids_flat"], np.int64)
    index.ntotal = int(state["ntotal"])
    index._ids_flat = ids_flat
    index._ids_trivial = bool(
        np.array_equal(ids_flat, np.arange(len(ids_flat), dtype=np.int64)))
    return index


def _codes_tensor(codes: np.ndarray, qtype: int) -> torch.Tensor:
    """Reference codes as a tensor of the codec's dtype (bf16 codes come as
    2-byte words: numpy has no bfloat16 of its own)."""
    codes = np.ascontiguousarray(codes)
    if qtype == SQ.QT_BF16:
        return torch.tensor(codes.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(codes)


def _codec(state: dict) -> SQ.SQCodec:
    def opt(name):
        v = state.get(name)
        return None if v is None else np.asarray(v, np.float32)

    return SQ.SQCodec(qtype=int(state["qtype"]), d=int(state["d"]),
                      vmin=opt("vmin"), vdiff=opt("vdiff"))


def sq_from_reference(state: dict, device="cuda") -> IndexScalarQuantizer:
    """A port `IndexScalarQuantizer` from a `tpu_ann` one's arrays, as
    numpy: qtype, d, vmin and vdiff (None for untrained qtypes), codes
    (ntotal, code width) in the codec's dtype, and optionally metric."""
    index = IndexScalarQuantizer(int(state["d"]), int(state["qtype"]),
                                 int(state.get("metric", METRIC_L2)),
                                 device=device)
    index.sq = _codec(state)
    index.is_trained = True
    index._codes = _codes_tensor(state["codes"], index.qtype).to(device)
    index.ntotal = len(index._codes)
    return index


def ivf_sq_from_reference(state: dict,
                          device="cuda") -> IndexIVFScalarQuantizer:
    """A search-only port `IndexIVFScalarQuantizer` from a `tpu_ann` one's
    arrays: the keys of `ivf_flat_from_reference` with ``codes``
    ((nblocks+1, B, code width), the packed code lists) in place of data
    and norms, plus qtype, vmin and vdiff."""
    codes = np.asarray(state["codes"])
    qtype = int(state["qtype"])
    index = _ivf_shell(IndexIVFScalarQuantizer, state, codes, device,
                       qtype=qtype)
    index.sq = _codec(state)
    index.invlists = PackedCodeInvLists(
        codes=_codes_tensor(codes, qtype).to(device),
        ids=torch.tensor(np.asarray(state["ids"], np.int32), device=device),
        list_block_start=torch.tensor(
            np.asarray(state["list_block_start"], np.int32), device=device),
        list_nblocks=torch.tensor(
            np.asarray(state["list_nblocks"], np.int32), device=device))
    return index
