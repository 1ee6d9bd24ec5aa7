"""State carried over from the JAX package (`tpu_ann`).

These functions take plain numpy arrays exported from a `tpu_ann` index, so
this module needs neither jax nor tpu_ann, and both packages then search
the very same index whatever their k-means did. Each one lays the arrays
out as an index file's meta and arrays (`utils.index_io`) and builds the
index with its loader, so an index carried over and an index read from a
file are built by the same code.
"""

from __future__ import annotations

import numpy as np

from ..models.flat import IndexFlat
from ..models.hnsw import (IndexHNSW2Level, IndexHNSWFlat, IndexHNSWPQ,
                           IndexHNSWSQ)
from ..models.idmap import IndexIDMap, IndexIDMap2, IndexReplicas, IndexShards
from ..models.ivf import IndexIVFFlat
from ..models.ivf_hnsw import IndexIVFHNSW
from ..models.ivf_pq import (IndexIVFPQ, IndexIVFPQR,
                             IndexIVFScalarQuantizer)
from ..models.pq import IndexPQ, IndexScalarQuantizer
from ..models.refine import IndexRefineFlat, IndexRefineSQ8Tier
from ..models.transforms import IndexPreTransform
from ..ops import sq as SQ
from ..ops.distances import METRIC_L2
from . import index_io as iio


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
      ids_flat                       (n,) int64 user id of each packed row

    The host vector store does not come across, so the index cannot be
    added to. An index with removals pending carries its holes (ids -1 in
    ``ids``) across; ``ntotal`` is then below n. With ``instances`` (the
    dict of an `IndexIVFFlatDedup`) the result is an `IndexIVFFlatDedup`
    that expands the duplicates as the reference's does."""
    d, nlist = int(state["d"]), int(state["nlist"])
    vectors = np.asarray(state["vectors"], np.float32)
    if vectors.shape != (nlist, d):
        raise ValueError(f"vectors must be ({nlist}, {d}), "
                         f"got {vectors.shape}")
    quantizer = ({"tag": "IxFl", "d": d, "metric": int(state["metric"]),
                  "ntotal": nlist}, {"xb": vectors})
    lists = _raw_lists(state)
    instances = state.get("instances")
    if instances is None:
        return _load_ivf("IwFl", state, quantizer, lists, device)
    pairs = [(rep, dup) for rep, dups in instances.items() for dup in dups]
    if pairs:
        lists["dedup_reps"] = np.asarray([p[0] for p in pairs], np.int64)
        lists["dedup_dups"] = np.asarray([p[1] for p in pairs], np.int64)
    return _load_ivf("IwFD", state, quantizer, lists, device)


def hnsw_from_reference(state: dict, device="cuda") -> IndexHNSWFlat:
    """A port `IndexHNSWFlat` that searches the graph of a `tpu_ann` one,
    from its arrays as numpy:

      d, metric, M, efSearch, efConstruction   ints
      xb                     (ntotal, d) storage vectors
      neighbors0, upper_ids, upper_neighbors, levels, entry, max_level
                             the HNSWGraph's arrays and scalars
      coarse_assign          optional: the build's coarse assignment (the
                             spatial order of the fused tiles)"""
    return iio.load_index(*_hnsw_file(state), device=device)


def _hnsw_file(state: dict, tag: str = "IHNf", ntotal=None):
    meta = {"tag": tag, "d": int(state["d"]),
            "metric": int(state["metric"]), "M": int(state["M"]),
            "ntotal": len(state["xb"]) if ntotal is None else ntotal,
            "has_graph": True, "entry": int(state["entry"]),
            "max_level": int(state["max_level"])}
    defaults = {"efSearch": 16, "efConstruction": 40}
    for key, v in defaults.items():
        meta[key] = int(state.get(key, v))
    arrays = {name: state[name] for name in (
        "neighbors0", "upper_ids", "upper_neighbors", "levels")}
    if "xb" in state:
        arrays["xb"] = state["xb"]
    if state.get("coarse_assign") is not None:
        arrays["coarse_assign"] = np.asarray(state["coarse_assign"],
                                             np.int64)
    return meta, arrays


def hnsw_sq_from_reference(state: dict, device="cuda") -> IndexHNSWSQ:
    """A port `IndexHNSWSQ` that searches the graph of a `tpu_ann` one:
    the keys of `hnsw_from_reference` plus ``qtype`` ("bfloat16",
    "float16" or "sq8"); ``xb`` holds the f32 rows of its storage (for an
    "sq8" index whose raw rows are dropped, the dequantized rows, as its
    index file holds)."""
    meta, arrays = _hnsw_file(state, "IHNs")
    meta["qtype"] = state["qtype"]
    return iio.load_index(meta, arrays, device=device)


def hnsw_pq_from_reference(state: dict, device="cuda") -> IndexHNSWPQ:
    """A port `IndexHNSWPQ` from a `tpu_ann` one's arrays: the graph keys
    of `hnsw_from_reference` (no ``xb``), pq_m, nbits, ``codes`` (ntotal,
    pq_m) uint8 and ``pq_centroids`` (pq_m, ksub, dsub). Its PQ tiles are
    laid out at the first search."""
    meta, arrays = _hnsw_file(state, "IHNq", len(state["codes"]))
    meta.update(pq_m=int(state["pq_m"]), nbits=int(state.get("nbits", 8)),
                is_trained=True)
    arrays.update(codes=np.asarray(state["codes"], np.uint8),
                  pq_centroids=np.asarray(state["pq_centroids"], np.float32))
    return iio.load_index(meta, arrays, device=device)


def hnsw_2level_from_reference(state: dict,
                               device="cuda") -> IndexHNSW2Level:
    """A port `IndexHNSW2Level` from a `tpu_ann` one's arrays: the keys of
    `hnsw_from_reference` (``xb`` the decoded rows its storage holds) plus
    its codec's: nlist, pq_m, nbits, ``q1_vectors`` (nlist, d) the coarse
    centroids, ``pq_centroids``, ``list_ids`` (ntotal,) and ``codes``
    (ntotal, pq_m)."""
    meta, arrays = _hnsw_file(state, "IHN2")
    meta["is_trained"] = True
    d, metric, nlist = int(state["d"]), int(state["metric"]), \
        int(state["nlist"])
    codec_m = {"tag": "Ix2L", "d": d, "ntotal": len(state["codes"]),
               "nlist": nlist, "M": int(state["pq_m"]),
               "nbits": int(state.get("nbits", 8)), "is_trained": True}
    codec_a = {"pq_centroids": np.asarray(state["pq_centroids"], np.float32),
               "list_ids": np.asarray(state["list_ids"], np.int32),
               "codes": np.asarray(state["codes"], np.uint8)}
    iio._flatten("q1", {"tag": "IxFl", "d": d, "metric": metric,
                        "ntotal": nlist},
                 {"xb": np.asarray(state["q1_vectors"], np.float32)},
                 codec_m, codec_a)
    iio._flatten("codec", codec_m, codec_a, meta, arrays)
    return iio.load_index(meta, arrays, device=device)


def ivf_hnsw_from_reference(state: dict, device="cuda") -> IndexIVFHNSW:
    """A search-only port `IndexIVFHNSW` from a `tpu_ann` one: the keys of
    `ivf_flat_from_reference` without ``vectors``, plus ``quantizer``, the
    `hnsw_from_reference` state of its HNSW quantizer (whose storage holds
    the centroids)."""
    return _load_ivf("IwHn", state, _hnsw_file(state["quantizer"]),
                     _raw_lists(state), device)


def _raw_lists(state: dict) -> dict:
    return {"il_data": state["data"], "il_ids": state["ids"],
            "il_norms": state["norms"]}


def _load_ivf(tag: str, state: dict, quantizer, lists: dict, device,
              **extra_meta):
    """A search-only IVF index from its packed lists (``lists``: il_data
    and il_ids, and il_norms for raw lists, with any other arrays of the
    tag), the reference's list ranges and id map, and the (meta, arrays) of
    its quantizer."""
    meta = {"tag": tag, "d": int(state["d"]), "metric": int(state["metric"]),
            "ntotal": int(state["ntotal"]), "nlist": int(state["nlist"]),
            "nprobe": 1, "block_size": int(np.shape(lists["il_data"])[1]),
            "has_invlists": True, "il_from_host": False,
            "il_coded": "il_norms" not in lists, **extra_meta}
    arrays = {**lists, "il_start": state["list_block_start"],
              "il_nblocks": state["list_nblocks"],
              "ids_host": np.asarray(state["ids_flat"], np.int64)}
    iio._flatten("quantizer", *quantizer, meta, arrays)
    return iio.load_index(meta, arrays, device=device)


def _codes(codes: np.ndarray, qtype: int) -> np.ndarray:
    """Reference codes as the container hands them over: bf16 codes come
    as 2-byte words (numpy has no bfloat16 of its own)."""
    codes = np.ascontiguousarray(codes)
    if qtype == SQ.QT_BF16:
        return codes.view(np.uint16).view(iio.Bf16Array)
    return codes


def _codec_arrays(state: dict, prefix: str = "") -> dict:
    return {prefix + name: np.asarray(state[name], np.float32)
            for name in ("vmin", "vdiff") if state.get(name) is not None}


def sq_from_reference(state: dict, device="cuda") -> IndexScalarQuantizer:
    """A port `IndexScalarQuantizer` from a `tpu_ann` one's arrays, as
    numpy: qtype, d, vmin and vdiff (None for untrained qtypes), codes
    (ntotal, code width) in the codec's dtype, and optionally metric."""
    qtype = int(state["qtype"])
    codes = _codes(state["codes"], qtype)
    meta = {"tag": "IxSQ", "d": int(state["d"]), "qtype": qtype,
            "metric": int(state.get("metric", METRIC_L2)),
            "ntotal": len(codes)}
    return iio.load_index(meta, {**_codec_arrays(state), "codes": codes},
                          device=device)


def ivf_sq_from_reference(state: dict,
                          device="cuda") -> IndexIVFScalarQuantizer:
    """A search-only port `IndexIVFScalarQuantizer` from a `tpu_ann` one's
    arrays: the keys of `ivf_flat_from_reference` with ``codes``
    ((nblocks+1, B, code width), the packed code lists) in place of data
    and norms, plus qtype, vmin and vdiff."""
    qtype = int(state["qtype"])
    d, nlist = int(state["d"]), int(state["nlist"])
    quantizer = ({"tag": "IxFl", "d": d, "metric": int(state["metric"]),
                  "ntotal": nlist},
                 {"xb": np.asarray(state["vectors"], np.float32)})
    lists = {"il_data": _codes(state["codes"], qtype),
             "il_ids": state["ids"], **_codec_arrays(state, "sq_")}
    return _load_ivf("IwSQ", state, quantizer, lists, device, qtype=qtype)


def pq_from_reference(state: dict, device="cuda") -> IndexPQ:
    """A port `IndexPQ` from a `tpu_ann` one's arrays, as numpy: d, M,
    nbits, metric, centroids (M, ksub, dsub) and codes (ntotal, code
    width) uint8; optionally search_type, polysemous_ht and
    do_polysemous_training (a polysemous index's centroids are already
    permuted)."""
    codes = np.asarray(state["codes"], np.uint8)
    meta = {"tag": "IxPQ", "d": int(state["d"]), "M": int(state["M"]),
            "nbits": int(state["nbits"]),
            "metric": int(state.get("metric", METRIC_L2)),
            "ntotal": len(codes),
            "search_type": int(state.get("search_type", 0)),
            "polysemous_ht": int(state.get("polysemous_ht", 0)),
            "do_polysemous_training": bool(
                state.get("do_polysemous_training", False))}
    return iio.load_index(meta, {"centroids": state["centroids"],
                                 "codes": codes}, device=device)


def _pq_meta(state: dict) -> dict:
    return {"M": int(state["M"]), "nbits": int(state["nbits"]),
            "by_residual": bool(state.get("by_residual", True))}


def _pq_lists(state: dict) -> tuple:
    quantizer = ({"tag": "IxFl", "d": int(state["d"]),
                  "metric": int(state["metric"]),
                  "ntotal": int(state["nlist"])},
                 {"xb": np.asarray(state["vectors"], np.float32)})
    lists = {"il_data": np.asarray(state["codes"], np.uint8),
             "il_ids": state["ids"],
             "pq_centroids": np.asarray(state["pq_centroids"], np.float32)}
    return quantizer, lists


def ivf_pq_from_reference(state: dict, device="cuda") -> IndexIVFPQ:
    """A search-only port `IndexIVFPQ` from a `tpu_ann` one's arrays: the
    keys of `ivf_flat_from_reference` with ``codes`` ((nblocks+1, B, code
    width), the packed code lists) in place of data and norms, plus M,
    nbits, by_residual and pq_centroids (M, ksub, dsub). The decoded cache
    is built from them at the first search."""
    return _load_ivf("IwPQ", state, *_pq_lists(state), device,
                     **_pq_meta(state))


def ivf_pqr_from_reference(state: dict, device="cuda") -> IndexIVFPQR:
    """A search-only port `IndexIVFPQR`: the keys of
    `ivf_pq_from_reference` plus M_refine, nbits_refine, k_factor,
    refine_centroids and the row tables row_codes (n, M), row_refine
    (n, M_refine) and row_assign (n,)."""
    quantizer, lists = _pq_lists(state)
    lists.update(refine_centroids=np.asarray(state["refine_centroids"],
                                             np.float32),
                 row_codes=np.asarray(state["row_codes"], np.uint8),
                 row_refine=np.asarray(state["row_refine"], np.uint8),
                 row_assign=np.asarray(state["row_assign"], np.int32))
    return _load_ivf("IwPR", state, quantizer, lists, device,
                     M_refine=int(state["M_refine"]),
                     nbits_refine=int(state["nbits_refine"]),
                     k_factor=int(state.get("k_factor", 4)),
                     **_pq_meta(state))


def refine_from_reference(state: dict, base, device="cuda"):
    """A port refine index over ``base`` (a port index already carried
    over, e.g. by `ivf_pq_from_reference`) from a `tpu_ann` refine index's
    arrays: ``xb`` (ntotal, d), the refine IndexFlat's rows, for an
    `IndexRefineFlat`; or qtype, vmin, vdiff and ``codes`` (ntotal, code
    size) uint8 for an `IndexRefineSQ8Tier`; and k_factor."""
    if "xb" in state:
        refine = flat_from_reference(
            {"d": base.d, "metric": base.metric_type,
             "ntotal": len(state["xb"]), "xb": state["xb"]}, device=device)
        idx = IndexRefineFlat(base, refine)
    else:
        idx = IndexRefineSQ8Tier(base)
        idx.codec = SQ.SQCodec(
            qtype=int(state.get("qtype", SQ.QT_8BIT)), d=base.d,
            vmin=np.asarray(state["vmin"], np.float32),
            vdiff=np.asarray(state["vdiff"], np.float32))
        idx._codes = iio.to_tensor(state["codes"], device, np.uint8)
        idx.is_trained = True
    idx.k_factor = int(state.get("k_factor", 4))
    idx.ntotal = base.ntotal
    return idx


def transform_from_reference(cls_name: str, attrs: dict, device="cuda"):
    """A port VectorTransform of class ``cls_name`` (PCAMatrix, OPQMatrix,
    ...) from a `tpu_ann` transform's attributes (``vars(t)``: d_in,
    d_out, A, b, is_orthonormal, mean, eigenvalues, map and the scalar
    settings, all numpy or plain values)."""
    from ..models import transforms as TR

    cls = getattr(TR, cls_name)
    t = cls.__new__(cls)
    TR.VectorTransform.__init__(t, int(attrs["d_in"]), int(attrs["d_out"]),
                                device=device)
    t.__dict__.update({k: np.array(v) if isinstance(v, np.ndarray) else v
                       for k, v in attrs.items() if k != "device"})
    t.is_trained = True
    return t


def pretransform_from_reference(chain, index) -> IndexPreTransform:
    """A port IndexPreTransform over ``index`` (a port index already
    carried over) from a `tpu_ann` chain as (class name, ``vars(t)``)
    pairs."""
    return IndexPreTransform(*[transform_from_reference(c, a, index.device)
                               for c, a in chain], index)


def idmap_from_reference(state: dict, index) -> IndexIDMap:
    """A port IndexIDMap (IndexIDMap2 if ``state["idmap2"]``) over
    ``index`` (a port index already carried over) from a `tpu_ann` one's
    ``id_map``."""
    cls = IndexIDMap2 if state.get("idmap2") else IndexIDMap
    idx = cls(index)
    idx.id_map = np.asarray(state["id_map"], np.int64).copy()
    idx.ntotal = index.ntotal
    if isinstance(idx, IndexIDMap2):
        idx.construct_rev_map()
    return idx


def shards_from_reference(state: dict, shards) -> IndexShards:
    """A port IndexShards over ``shards`` (port indexes already carried
    over, in order) with a `tpu_ann` one's d, metric and
    successive_ids."""
    idx = IndexShards(int(state["d"]), int(state["metric"]),
                      successive_ids=bool(state.get("successive_ids", True)),
                      device=shards[0].device)
    for s in shards:
        idx.add_shard(s)
    return idx


def replicas_from_reference(state: dict, replicas) -> IndexReplicas:
    """A port IndexReplicas over ``replicas`` (port indexes already
    carried over) with a `tpu_ann` one's d and metric."""
    idx = IndexReplicas(int(state["d"]), int(state["metric"]),
                        device=replicas[0].device)
    for r in replicas:
        idx.add_replica(r)
    return idx


# --- the additive quantizers, QINCo and the lattice -------------------------

_AQ_KEYS = ("beam_size", "train_iters", "icm_iters", "nperts", "lambd",
            "nsplits", "Msub")


def _aq_meta(state: dict) -> dict:
    return {"cls": state["cls"], "d": int(state["d"]),
            "metric": int(state.get("metric", METRIC_L2)),
            "M": int(state["M"]), "nbits": int(state["nbits"]),
            **{k: state[k] for k in _AQ_KEYS if k in state}}


def coarse_aq_from_reference(state: dict, device="cuda"):
    """A port ResidualCoarseQuantizer / LocalSearchCoarseQuantizer from a
    `tpu_ann` one: cls (its class name), d, M, nbits, beam_factor and
    codebooks (M, ksub, d)."""
    return iio.load_index(*_coarse_file(state), device=device)


def _coarse_file(state: dict):
    meta = {"tag": "IxCQ", "cls": state["cls"], "d": int(state["d"]),
            "metric": int(state.get("metric", METRIC_L2)),
            "M": int(state["M"]), "nbits": int(state["nbits"]),
            "beam_factor": float(state["beam_factor"]), "is_trained": True}
    return meta, {"codebooks": np.asarray(state["codebooks"], np.float32)}


def aq_from_reference(state: dict, device="cuda"):
    """A port flat additive index (IndexResidualQuantizer,
    IndexLocalSearchQuantizer, IndexProduct...) from a `tpu_ann` one: cls,
    d, M (the stages, nsplits * Msub for a product), nbits, codebooks
    (M, ksub, d), codes (ntotal, M) uint8, norms (ntotal,) f32, and
    nsplits / Msub for a product, the LSQ knobs if set."""
    codes = np.asarray(state["codes"], np.uint8)
    meta = {"tag": "IxRQ", "ntotal": len(codes), "is_trained": True,
            **_aq_meta(state)}
    arrays = {"codebooks": np.asarray(state["codebooks"], np.float32)}
    if len(codes):
        arrays.update(codes=codes,
                      norms=np.asarray(state["norms"], np.float32))
    return iio.load_index(meta, arrays, device=device)


def ivf_aq_from_reference(state: dict, device="cuda"):
    """A search-only port IVF additive index (IndexIVFResidualQuantizer and
    its family) from a `tpu_ann` one: the keys of `ivf_flat_from_reference`
    with ``codes`` ((nblocks+1, B, M + 4) uint8, the packed payload lists)
    in place of data and norms, plus cls, M, nbits, codebooks, and either
    ``vectors`` (an IndexFlat quantizer's centroids) or ``coarse`` (the
    `coarse_aq_from_reference` state of an additive coarse quantizer)."""
    d, nlist = int(state["d"]), int(state["nlist"])
    if "coarse" in state:
        quantizer = _coarse_file(state["coarse"])
    else:
        quantizer = ({"tag": "IxFl", "d": d, "metric": int(state["metric"]),
                      "ntotal": nlist},
                     {"xb": np.asarray(state["vectors"], np.float32)})
    lists = {"il_data": np.asarray(state["codes"], np.uint8),
             "il_ids": state["ids"],
             "codebooks": np.asarray(state["codebooks"], np.float32)}
    meta = _aq_meta(state)
    meta.pop("d")
    meta.pop("metric")
    return _load_ivf("IwRQ", state, quantizer, lists, device, **meta)


def qinco_from_reference(state: dict, device="cuda"):
    """A port IndexQINCo from a `tpu_ann` one: d, K, L, M, h, metric, the
    packed ``codes`` (ntotal, code size) uint8, and its QINCoParams as
    numpy: ``codebook0`` (K, d) and ``steps``, one dict a step with
    codebook, w_cb, w_xh, b, ffn_w1, ffn_w2 (the reference's layout)."""
    codes = np.asarray(state["codes"], np.uint8)
    meta = {"tag": "IxQN", "d": int(state["d"]),
            "metric": int(state.get("metric", METRIC_L2)),
            "ntotal": len(codes), "K": int(state["K"]), "L": int(state["L"]),
            "M": int(state["M"]), "h": int(state["h"])}
    arrays = {"codes": codes, "codebook0": state["codebook0"]}
    for i, st in enumerate(state["steps"]):
        for name, v in st.items():
            arrays[f"step{i}/{name}"] = np.asarray(v, np.float32)
    return iio.load_index(meta, arrays, device=device)


def lattice_from_reference(state: dict, device="cuda"):
    """A port IndexLattice from a `tpu_ann` one: d, nsq, scale_nbit, r2,
    metric, ``trained`` (2, nsq) f32 and the packed ``codes``."""
    codes = np.asarray(state["codes"], np.uint8)
    meta = {"tag": "IxLt", "d": int(state["d"]),
            "metric": int(state.get("metric", METRIC_L2)),
            "ntotal": len(codes), "nsq": int(state["nsq"]),
            "scale_nbit": int(state["scale_nbit"]), "r2": int(state["r2"]),
            "is_trained": True}
    return iio.load_index(meta, {"codes": codes,
                                 "trained": np.asarray(state["trained"],
                                                       np.float32)},
                          device=device)


# --- the binary indexes, the long-tail indexes, the graph indexes and the
#     IVF couplings -----------------------------------------------------------

def binary_flat_from_reference(state: dict, device="cuda"):
    """A port IndexBinaryFlat from a `tpu_ann` one: d and ``codes``
    (ntotal, d / 8) uint8."""
    codes = np.asarray(state["codes"], np.uint8)
    return iio.load_index({"tag": "BxFl", "d": int(state["d"]),
                           "ntotal": len(codes)},
                          {"codes": codes} if len(codes) else {},
                          device=device)


def binary_ivf_from_reference(state: dict, quantizer, device="cuda"):
    """A port IndexBinaryIVF over ``quantizer`` (a port binary index
    already carried over: the reference's binary centroids) from a
    `tpu_ann` one's d, nlist, nprobe and host store ``codes`` (n, d / 8),
    ``ids`` (n,); its lists are packed at the first search, by the
    carried quantizer's assignment."""
    from ..models.binary import IndexBinaryIVF

    idx = IndexBinaryIVF(quantizer, int(state["d"]), int(state["nlist"]),
                         device=device)
    idx.nprobe = int(state.get("nprobe", 1))
    idx.is_trained = True
    codes = np.asarray(state["codes"], np.uint8)
    if len(codes):
        idx._codes_host = [codes.copy()]
        idx._ids_host = [np.asarray(state["ids"], np.int64).copy()]
        idx.ntotal = len(codes)
        idx._dirty = True
    return idx


def binary_hnsw_from_reference(state: dict, device="cuda"):
    """A port IndexBinaryHNSW that searches the graph of a `tpu_ann` one:
    d, ``codes`` (ntotal, d / 8) and ``hnsw``, the `hnsw_sq_from_reference`
    state of its bf16 IndexHNSWSQ over the unpacked bits."""
    codes = np.asarray(state["codes"], np.uint8)
    meta = {"tag": "BxHN", "d": int(state["d"]), "ntotal": len(codes)}
    arrays = {"codes": codes}
    sub_m, sub_a = _hnsw_file({**state["hnsw"], "qtype": "bfloat16"},
                              "IHNs")
    sub_m["qtype"] = "bfloat16"
    iio._flatten("sub", sub_m, sub_a, meta, arrays)
    return iio.load_index(meta, arrays, device=device)


def binary_hash_from_reference(state: dict, device="cuda"):
    """A port IndexBinaryHash (IndexBinaryMultiHash when ``nhash`` is
    given) from a `tpu_ann` one: d, b, nflip, [nhash,] and ``codes``; the
    tables are rebuilt from the codes."""
    codes = np.asarray(state["codes"], np.uint8)
    meta = {"tag": "BxMH" if "nhash" in state else "BxHs",
            "d": int(state["d"]), "ntotal": len(codes),
            "b": int(state["b"]), "nflip": int(state.get("nflip", 1))}
    if "nhash" in state:
        meta["nhash"] = int(state["nhash"])
    return iio.load_index(meta, {"codes": codes} if len(codes) else {},
                          device=device)


def binary_from_float_from_reference(index):
    """A port IndexBinaryFromFloat over ``index`` (the float index already
    carried over, holding the unpacked 0/1 rows)."""
    from ..models.binary import IndexBinaryFromFloat

    idx = IndexBinaryFromFloat(index)
    idx.ntotal = index.ntotal
    return idx


def lsh_from_reference(state: dict, device="cuda"):
    """A port IndexLSH from a `tpu_ann` one: d, nbits, rotate_data,
    train_thresholds, ``P`` (d, nbits), ``thresholds`` (nbits,) and
    ``codes`` (ntotal, nbits / 8)."""
    codes = np.asarray(state["codes"], np.uint8)
    meta = {"tag": "IxLs", "d": int(state["d"]), "ntotal": len(codes),
            "nbits": int(state["nbits"]),
            "rotate_data": bool(state["rotate_data"]),
            "train_thresholds": bool(state["train_thresholds"]),
            "is_trained": True}
    arrays = {"P": np.asarray(state["P"], np.float32),
              "thresholds": np.asarray(state["thresholds"], np.float32)}
    if len(codes):
        arrays["codes"] = codes
    return iio.load_index(meta, arrays, device=device)


def rowwise_minmax_from_reference(state: dict, index):
    """A port IndexRowwiseMinMax over ``index`` (the sub-index already
    carried over) with a `tpu_ann` one's ``mins`` and ``scales``
    (ntotal,)."""
    from ..models.extra import IndexRowwiseMinMax

    idx = IndexRowwiseMinMax(index)
    idx._mins = iio.to_tensor(state["mins"], index.device, np.float32)
    idx._scales = iio.to_tensor(state["scales"], index.device, np.float32)
    idx.ntotal = index.ntotal
    idx.is_trained = True
    return idx


def imi_from_reference(state: dict, device="cuda"):
    """A port MultiIndexQuantizer from a `tpu_ann` one: d, M, nbits and
    ``centroids`` (M, ksub, d / M)."""
    return iio.load_index(
        {"tag": "IxMI", "d": int(state["d"]), "M": int(state["M"]),
         "nbits": int(state["nbits"]), "ntotal": 0, "is_trained": True},
        {"centroids": np.asarray(state["centroids"], np.float32)},
        device=device)


def split_vectors_from_reference(d: int, subs):
    """A port IndexSplitVectors of width d over ``subs`` (the sub-indexes
    already carried over, in order)."""
    from ..models.extra import IndexSplitVectors

    idx = IndexSplitVectors(d, device=subs[0].device)
    for s in subs:
        idx.add_sub_index(s)
    idx.ntotal = subs[0].ntotal
    return idx


def random_from_reference(state: dict, device="cuda"):
    """A port IndexRandom from a `tpu_ann` one: d, ntotal, seed."""
    return iio.load_index({"tag": "IxRn", "d": int(state["d"]),
                           "ntotal": int(state["ntotal"]),
                           "seed": int(state["seed"])}, {}, device=device)


def nsg_from_reference(state: dict, device="cuda"):
    """A port NSG that searches the graph of a `tpu_ann` one: d, metric,
    R, GK, efSearch, medoid, ``graph`` (ntotal, R) int32 and its storage:
    ``xb`` (ntotal, d) for an IndexNSGFlat; ``codes`` and pq_m, nbits,
    ``centroids`` for an IndexNSGPQ; ``codes`` and qtype, ``vmin``,
    ``vdiff`` for an IndexNSGSQ."""
    meta = {"tag": "IxNS", "d": int(state["d"]),
            "metric": int(state.get("metric", METRIC_L2)),
            "R": int(state["R"]), "GK": int(state["GK"]),
            "efSearch": int(state.get("efSearch", 16)),
            "medoid": int(state["medoid"])}
    arrays = {"graph": np.asarray(state["graph"], np.int32)}
    if "xb" in state:
        arrays["xb"] = np.asarray(state["xb"], np.float32)
        meta["ntotal"] = len(arrays["xb"])
    else:
        meta["ntotal"] = len(state["codes"])
        meta["is_trained"] = True
        if "centroids" in state:
            meta.update(tag="IxNP", pq_m=int(state["pq_m"]),
                        nbits=int(state.get("nbits", 8)))
            arrays.update(centroids=np.asarray(state["centroids"],
                                               np.float32),
                          codes=np.asarray(state["codes"], np.uint8))
        else:
            meta.update(tag="IxNQ", qtype=int(state["qtype"]))
            arrays["codes"] = _codes(state["codes"], int(state["qtype"]))
            arrays.update(_codec_arrays(state, "sq_"))
    return iio.load_index(meta, arrays, device=device)


def nnd_from_reference(state: dict, device="cuda"):
    """A port IndexNNDescentFlat from a `tpu_ann` one: d, metric, K,
    efSearch, ``xb`` and ``graph`` (ntotal, K) int32."""
    xb = np.asarray(state["xb"], np.float32)
    return iio.load_index(
        {"tag": "IxND", "d": int(state["d"]),
         "metric": int(state.get("metric", METRIC_L2)), "ntotal": len(xb),
         "K": int(state["K"]), "efSearch": int(state.get("efSearch", 16))},
        {"xb": xb, "graph": np.asarray(state["graph"], np.int32)},
        device=device)


def ivf_spectral_hash_from_reference(state: dict, device="cuda"):
    """A search-only port IndexIVFSpectralHash from a `tpu_ann` one: the
    keys of `ivf_flat_from_reference` with ``codes`` ((nblocks+1, B, nbit /
    8) uint8, the packed code lists) in place of data and norms, plus
    nbit, period, threshold_type, ``trained`` (nlist, nbit) and the
    projection's ``vt_A`` (nbit, d) (and ``vt_b`` if it has one)."""
    quantizer = ({"tag": "IxFl", "d": int(state["d"]),
                  "metric": int(state["metric"]),
                  "ntotal": int(state["nlist"])},
                 {"xb": np.asarray(state["vectors"], np.float32)})
    lists = {"il_data": np.asarray(state["codes"], np.uint8),
             "il_ids": state["ids"],
             "trained": np.asarray(state["trained"], np.float32),
             "vt_A": np.asarray(state["vt_A"], np.float32)}
    if state.get("vt_b") is not None:
        lists["vt_b"] = np.asarray(state["vt_b"], np.float32)
    nbit = int(state["nbit"])
    return _load_ivf("IwSH", state, quantizer, lists, device, nbit=nbit,
                     period=float(state["period"]),
                     threshold_type=state["threshold_type"],
                     vt_din=int(state["d"]), vt_dout=nbit, vt_ortho=True)


def ivf_independent_from_reference(quantizer, index_ivf, vt=None):
    """A port IndexIVFIndependentQuantizer over ``quantizer`` and the
    payload ``index_ivf`` (both already carried over; the payload holds
    the quantizer's lists) and the transform ``vt`` (port, or None)."""
    from ..models.ivf_extra import IndexIVFIndependentQuantizer

    idx = IndexIVFIndependentQuantizer(quantizer, index_ivf, vt)
    idx.is_trained = True
    idx.ntotal = index_ivf.ntotal
    return idx
