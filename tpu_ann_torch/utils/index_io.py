"""Index (de)serialization — PyTorch counterpart of
`tpu_ann/utils/index_io.py` (faiss `impl/index_write.cpp` /
`impl/index_read.cpp` / `index_io.h`), in the very same file format, so
either package reads the other's files:

    magic "TANN0001" | u64 header_len | JSON header | 64-byte-aligned blobs

The JSON header holds ``{"meta", "arrays"}``: the index's type tag and
scalars, and per array its numpy dtype string, shape and offset.
``read_index(path, mmap=True)`` maps every blob with ``np.memmap`` instead
of reading it (the reference's IO_FLAG_MMAP, impl/index_read.cpp:185-230);
the index copies what it uploads to its device.

bfloat16 arrays are stored under the dtype name ``"bfloat16"`` (the name
the reference writes for its numpy-extension bf16 arrays). numpy has no
bfloat16, so this module reads them as uint16 bit patterns, marked as
`Bf16Array`, and views them as ``torch.bfloat16`` after the upload; a torch
bf16 tensor is written under that same name.

Every ported index type registers a dumper (index -> meta + arrays) and a
loader (meta + arrays -> index) under the reference's four-letter tag, with
the reference's meta keys and array names; a nested index (an IVF's coarse
quantizer) nests under a name prefix. Every tag of the reference's is
registered; an unknown tag raises ValueError.
"""

from __future__ import annotations

import copy
import io
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

MAGIC = b"TANN0001"
ALIGN = 64
BF16 = "bfloat16"


class Bf16Array(np.ndarray):
    """uint16 bit patterns of bfloat16 values: how the container hands over
    a blob stored under the dtype name "bfloat16"."""


def to_tensor(a, device, dtype=None) -> torch.Tensor:
    """A device tensor holding a copy of host array ``a`` (numpy dtype
    ``dtype`` if given): a read-only memmap is read, never shared, and a
    `Bf16Array` becomes a torch.bfloat16 tensor."""
    if isinstance(a, Bf16Array):
        bits = np.array(a, np.uint16).view(np.int16)
        return torch.from_numpy(bits).to(device).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def _blob(arr) -> Tuple[str, np.ndarray]:
    """(header dtype string, C-contiguous numpy array of the bytes) of a
    numpy array or a tensor."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype == torch.bfloat16:
            return BF16, arr.view(torch.int16).numpy()
        arr = arr.numpy()
    if isinstance(arr, Bf16Array):
        return BF16, np.ascontiguousarray(arr.view(np.ndarray))
    arr = np.ascontiguousarray(arr)
    return arr.dtype.str, arr


# ---------------------------------------------------------------------------
# container (reference :37-97)
# ---------------------------------------------------------------------------

def _write_container(dst, meta: Dict[str, Any], arrays: Dict[str, Any]
                     ) -> None:
    """Write the container to a path or a binary file object. An array is
    a numpy array, a tensor, or a stream: an object with ``dtype``,
    ``shape``, ``nbytes`` and ``gen()`` yielding its bytes' arrays in order
    (`invlists_io.merge_ondisk` writes its lists that way)."""
    table, blobs, offset = {}, [], 0
    for name, arr in arrays.items():
        if hasattr(arr, "gen"):
            dstr, shape, nbytes = np.dtype(arr.dtype).str, arr.shape, \
                arr.nbytes
        else:
            dstr, arr = _blob(arr)
            shape, nbytes = arr.shape, arr.nbytes
        pad = (-offset) % ALIGN
        offset += pad
        table[name] = {"dtype": dstr, "shape": [int(s) for s in shape],
                       "offset": offset}
        blobs.append((pad, arr))
        offset += nbytes
    header = json.dumps({"meta": meta, "arrays": table}).encode()
    if isinstance(dst, (str, os.PathLike)):
        with open(dst, "wb") as f:
            _write_blobs(f, header, blobs)
    else:
        _write_blobs(dst, header, blobs)


def _write_blobs(f, header: bytes, blobs) -> None:
    f.write(MAGIC)
    f.write(np.uint64(len(header)).tobytes())
    f.write(header)
    f.write(b"\0" * ((-(len(MAGIC) + 8 + len(header))) % ALIGN))
    for pad, arr in blobs:
        f.write(b"\0" * pad)
        if not hasattr(arr, "gen"):
            f.write(arr.tobytes())
            continue
        written = 0
        for chunk in arr.gen():
            b = np.ascontiguousarray(chunk, dtype=arr.dtype).tobytes()
            written += len(b)
            f.write(b)
        if written != arr.nbytes:
            raise IOError(f"stream for {arr.shape} produced {written} "
                          f"bytes, expected {arr.nbytes}")


def _read_container(src, mmap: bool = False
                    ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(meta, arrays) of a container file (a path) or of its bytes (a
    bytes object or a uint8 array). ``mmap`` maps a file's blobs
    read-only instead of reading them."""
    is_path = isinstance(src, (str, os.PathLike))
    if is_path:
        with open(src, "rb") as f:
            head = f.read(16)
            if head[:8] != MAGIC:
                raise ValueError(f"{src}: not a tpu_ann index file")
            hlen = int(np.frombuffer(head[8:], np.uint64)[0])
            header = json.loads(f.read(hlen).decode())
    else:
        buf = np.frombuffer(src, np.uint8) if isinstance(src, bytes) \
            else np.ascontiguousarray(src, np.uint8).reshape(-1)
        if buf[:8].tobytes() != MAGIC:
            raise ValueError("not a tpu_ann index buffer")
        hlen = int(buf[8:16].view(np.uint64)[0])
        header = json.loads(buf[16:16 + hlen].tobytes().decode())
    base = 16 + hlen
    base += (-base) % ALIGN
    arrays = {}
    f = open(src, "rb") if is_path and not mmap else None
    try:
        for name, spec in header["arrays"].items():
            bf16 = spec["dtype"] == BF16
            dtype = np.dtype(np.uint16 if bf16 else spec["dtype"])
            shape = tuple(spec["shape"])
            off = base + spec["offset"]
            count = int(np.prod(shape, dtype=np.int64))
            if count == 0:
                a = np.zeros(shape, dtype)
            elif not is_path:
                a = buf[off:off + count * dtype.itemsize].view(dtype) \
                    .reshape(shape)
            elif mmap:
                a = np.memmap(src, dtype=dtype, mode="r", offset=off,
                              shape=shape)
            else:
                f.seek(off)
                a = np.fromfile(f, dtype=dtype, count=count).reshape(shape)
            arrays[name] = a.view(Bf16Array) if bf16 else a
    finally:
        if f is not None:
            f.close()
    return header["meta"], arrays


# ---------------------------------------------------------------------------
# per-type (de)serializers, by the reference's four-letter tags
# ---------------------------------------------------------------------------

def _flatten(prefix: str, meta: dict, arrays: dict, out_m: dict,
             out_a: dict) -> None:
    out_m[prefix] = meta
    for k, v in arrays.items():
        out_a[f"{prefix}/{k}"] = v


def _sub(prefix: str, meta: dict, arrays: dict):
    a = {k[len(prefix) + 1:]: v for k, v in arrays.items()
         if k.startswith(prefix + "/")}
    return meta[prefix], a


def _f32_or_none(arrays: dict, name: str):
    return np.array(arrays[name], np.float32) if name in arrays else None


def _dump_flat(index):
    return ({"tag": "IxFl", "d": index.d, "metric": index.metric_type,
             "ntotal": index.ntotal}, {"xb": index.vectors})


def _load_flat(meta, arrays, device):
    from ..models.flat import IndexFlat

    return IndexFlat.from_state({**meta, **arrays}, device=device)


def _dump_flat1d(index):
    return ({"tag": "IxF1", "d": 1, "ntotal": index.ntotal},
            {"xb": index.vectors} if index.ntotal else {})


def _load_flat1d(meta, arrays, device):
    from ..models.flat import IndexFlat1D

    idx = IndexFlat1D(device=device)
    if "xb" in arrays:
        idx.add(np.asarray(arrays["xb"]))
    return idx


def _hnsw_meta(index, tag: str) -> dict:
    return {"tag": tag, "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "M": index.hnsw.M,
            "efConstruction": index.hnsw.efConstruction,
            "efSearch": index.hnsw.efSearch}


def _graph_arrays(index, meta: dict, arrays: dict) -> None:
    """The graph's scalars and arrays (reference `_graph_meta_arrays`,
    :159-171). The port also writes the build's coarse assignment
    (``coarse_assign``) and the fused tiles' order (``tile_order``, their
    position -> id map), which the reference neither writes nor reads, so
    that a reopened index lays out the same tiles."""
    g = index.graph
    meta["has_graph"] = g is not None
    if g is not None:
        meta["max_level"] = int(g.max_level)
        meta["entry"] = int(g.entry)
        arrays.update(neighbors0=g.neighbors0, upper_ids=g.upper_ids,
                      upper_neighbors=g.upper_neighbors, levels=g.levels)
    ca = index._coarse_assign
    if ca is not None and len(ca) == index.ntotal:
        arrays["coarse_assign"] = np.asarray(ca, np.int64)
    ftg = index._tiles_fused
    if ftg is not None:
        arrays["tile_order"] = ftg.orig_ids[:ftg.n].long()
    elif index._tile_order is not None:
        arrays["tile_order"] = index._tile_order


def _restore_graph(idx, meta, arrays, device) -> None:
    """The reference's `_restore_graph` (:174-188); the graph's entry is an
    int here, a jnp.int32 scalar there. Without ``tile_order`` (a file of
    the reference's) the fused tiles of the reopened index take their
    spatial order from ``coarse_assign``, or else from a fresh k-means."""
    from ..ops.hnsw import HNSWGraph

    if meta.get("has_graph"):
        def up(name):
            return to_tensor(arrays[name], device, np.int32)

        idx.graph = HNSWGraph(
            neighbors0=up("neighbors0"), upper_ids=up("upper_ids"),
            upper_neighbors=up("upper_neighbors"), levels=up("levels"),
            entry=int(meta["entry"]), max_level=int(meta["max_level"]))
        idx._built_n = idx.ntotal
    if "coarse_assign" in arrays:
        idx._coarse_assign = np.array(arrays["coarse_assign"], np.int64)
    if "tile_order" in arrays:
        idx._tile_order = np.array(arrays["tile_order"], np.int64)


def _hnsw_shell(idx, meta, arrays, device):
    """The knobs, the storage rows (no graph build) and the graph."""
    idx.hnsw.efConstruction = int(meta["efConstruction"])
    idx.hnsw.efSearch = int(meta["efSearch"])
    if meta["ntotal"] and "xb" in arrays:
        idx.storage.add(np.asarray(arrays["xb"]))
        idx.ntotal = idx.storage.ntotal
    _restore_graph(idx, meta, arrays, device)
    return idx


def _dump_hnsw(index):
    meta = _hnsw_meta(index, "IHNf")
    arrays = {"xb": index._vectors()}
    _graph_arrays(index, meta, arrays)
    return meta, arrays


def _load_hnsw(meta, arrays, device):
    """The reference's `_load_hnsw` (:143-156)."""
    from ..models.hnsw import IndexHNSWFlat

    idx = IndexHNSWFlat(int(meta["d"]), int(meta["M"]), int(meta["metric"]),
                        device=device)
    return _hnsw_shell(idx, meta, arrays, device)


def _dump_hnswsq(index):
    """IHNs (reference :191-209): IHNf's arrays and the qtype. Once the
    "sq8" tiles dropped the raw rows, ``xb`` holds the dequantized rows
    (the storage precision is the index's), and the port adds the tiles'
    affine as ``sq8_bias`` / ``sq8_scale``, which with ``tile_order`` give
    a reopened index the same tiles and codes."""
    meta, arrays = _dump_hnsw(index)
    meta.update(tag="IHNs", qtype=index.storage_dtype)
    if index.storage_dtype == "sq8" and index._storage_dropped():
        il = index._tiles_fused.il
        arrays.update(sq8_bias=il.sq_bias, sq8_scale=il.sq_scale)
    return meta, arrays


def _load_hnswsq(meta, arrays, device):
    from ..models.hnsw import IndexHNSWSQ

    idx = IndexHNSWSQ(int(meta["d"]), meta["qtype"], int(meta["M"]),
                      int(meta["metric"]), device=device)
    if "sq8_bias" in arrays:
        idx._sq8_affine = (_f32_or_none(arrays, "sq8_bias"),
                           _f32_or_none(arrays, "sq8_scale"))
    return _hnsw_shell(idx, meta, arrays, device)


def _dump_hnswpq(index):
    """IHNq (reference :212-226): the codes, the PQ codebook and the graph.
    The port adds the PQ tiles' layout (``tile_order``, and ``tile_cent``,
    the tiles' centroids of the raw rows, which the file does not hold),
    so that a reopened index searches the same tiles."""
    meta = _hnsw_meta(index, "IHNq")
    meta.update(pq_m=index.pq_m, nbits=index.nbits,
                is_trained=index.is_trained)
    arrays = {"codes": index._codes}
    if index.pq is not None:
        arrays["pq_centroids"] = index.pq.centroids
    _graph_arrays(index, meta, arrays)
    pt = index._ptiles
    if pt is not None:
        arrays.update(tile_order=pt.orig_ids[:pt.n].long(),
                      tile_cent=pt.cent)
    elif index._tile_layout is not None:
        arrays.update(tile_order=index._tile_layout[0],
                      tile_cent=index._tile_layout[1])
    return meta, arrays


def _load_hnswpq(meta, arrays, device):
    """The reference's `_load_hnswpq` (:229-248): the storage keeps no
    rows (the codes are the index), and the tiles are built at the first
    search."""
    from ..models.hnsw import IndexHNSWPQ

    idx = IndexHNSWPQ(int(meta["d"]), int(meta["pq_m"]), int(meta["M"]),
                      int(meta["nbits"]), int(meta["metric"]), device=device)
    idx.hnsw.efConstruction = int(meta["efConstruction"])
    idx.hnsw.efSearch = int(meta["efSearch"])
    if "pq_centroids" in arrays:
        idx._set_codec(np.array(arrays["pq_centroids"], np.float32))
    idx.is_trained = bool(meta["is_trained"])
    idx._codes = to_tensor(arrays["codes"], device, np.uint8).reshape(
        -1, idx.pq_m)
    idx.ntotal = int(meta["ntotal"])
    _restore_graph(idx, meta, arrays, device)
    if "tile_cent" in arrays:
        idx._tile_layout = (idx._tile_order,
                            np.array(arrays["tile_cent"], np.float32))
    return idx


def _dump_2layer(index):
    """Ix2L (reference :1173-1185): the quantizer, nested, the PQ codebook,
    the list ids and the codes."""
    meta = {"tag": "Ix2L", "d": index.d, "ntotal": index.ntotal,
            "nlist": index.nlist, "M": index.M, "nbits": index.nbits,
            "is_trained": index.is_trained}
    arrays: dict = {}
    _flatten("q1", *dump_index(index.q1), meta, arrays)
    if index.pq is not None:
        arrays["pq_centroids"] = index.pq.centroids
    if index.ntotal:
        arrays.update(list_ids=index._list_ids, codes=index._codes)
    return meta, arrays


def _load_2layer(meta, arrays, device):
    from ..models.extra import Index2Layer

    idx = Index2Layer(load_index(*_sub("q1", meta, arrays), device=device),
                      int(meta["nlist"]), int(meta["M"]), int(meta["nbits"]))
    if "pq_centroids" in arrays:
        idx._set_codec(np.array(arrays["pq_centroids"], np.float32))
    idx.is_trained = bool(meta["is_trained"])
    if "codes" in arrays:
        idx._list_ids = to_tensor(arrays["list_ids"], device, np.int32)
        idx._codes = to_tensor(arrays["codes"], device, np.uint8)
        idx.ntotal = int(meta["ntotal"])
    return idx


def _dump_hnsw2level(index):
    """IHN2 (reference :1410-1423): the codec nested, the decoded rows the
    graph holds, and the graph."""
    meta = _hnsw_meta(index, "IHN2")
    meta["is_trained"] = index.is_trained
    arrays: dict = {}
    _flatten("codec", *dump_index(index.codec), meta, arrays)
    if index.ntotal:
        arrays["xb"] = index._vectors()
    _graph_arrays(index, meta, arrays)
    return meta, arrays


def _load_hnsw2level(meta, arrays, device):
    from ..models.hnsw import IndexHNSW2Level

    codec = load_index(*_sub("codec", meta, arrays), device=device)
    idx = IndexHNSW2Level(int(meta["d"]), codec.nlist, codec.M,
                          int(meta["M"]), codec.nbits, int(meta["metric"]),
                          device=device)
    idx.codec = codec
    idx.is_trained = bool(meta["is_trained"])
    return _hnsw_shell(idx, meta, arrays, device)


def _dump_ivf_common(index):
    """The reference's `_dump_ivf_common` (:263-312). Raw-float invlists
    that the host store fully recovers (no removal pending) are not written
    (``il_from_host``):
    the rows, their user ids and their int32 list assignments are, and the
    first use after a load repacks. Coded invlists write their codes. A
    search-only index (no host store) writes its row -> id map as
    ``ids_host``, as a coded merge_ondisk output does."""
    from ..ops.ivf_scan import PackedCodeInvLists

    index._maybe_repack()
    il = index.invlists
    meta = {"d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "nlist": index.nlist,
            "nprobe": index.nprobe, "block_size": index.block_size,
            "has_invlists": il is not None}
    arrays: dict = {}
    qm, qa = dump_index(index.quantizer)
    _flatten("quantizer", qm, qa, meta, arrays)
    host_n = sum(len(c) for c in index._xb_host)
    coded = isinstance(il, PackedCodeInvLists)
    # pending removals are holes in the device lists only: the host store
    # still holds those rows, so the lists must be written
    il_from_host = (il is not None and not coded and host_n == index.ntotal
                    and not index._pending_removals())
    meta["il_from_host"] = il_from_host
    if il is not None and not il_from_host:
        meta["max_nblocks"] = max(int(il.list_nblocks.max()), 1) \
            if il.nlist else 1
        meta["il_coded"] = coded
        arrays.update(il_data=il.codes if coded else il.data, il_ids=il.ids,
                      il_start=il.list_block_start,
                      il_nblocks=il.list_nblocks)
        if not coded:
            arrays["il_norms"] = il.norms
    if index._xb_host:
        arrays["xb_host"] = np.concatenate(index._xb_host, axis=0)
        arrays["ids_host"] = np.concatenate(index._ids_host, axis=0)
        if il_from_host and all(a is not None for a in index._assign_host):
            arrays["assign_host"] = np.concatenate(
                [np.asarray(a, np.int32) for a in index._assign_host])
    elif index._ids_flat is not None:
        arrays["ids_host"] = index._ids_flat
    return meta, arrays


def _set_ids_flat(idx, ids: np.ndarray) -> None:
    n = len(ids)
    idx._ids_flat = ids
    idx._ids_trivial = bool(
        n == 0 or (ids[0] == 0 and ids[-1] == n - 1
                   and np.array_equal(ids, np.arange(n, dtype=np.int64))))


def _restore_ivf_common(idx, meta, arrays, device):
    """The reference's `_restore_ivf_common` (:315-371). An il_from_host
    file restores the host store (a memmap under mmap=True) and the
    assignments (int32 in the file, int64 in ``_assign_host``); the first
    use repacks, concatenating the store into one host copy."""
    from ..ops.ivf_scan import PackedCodeInvLists, PackedInvLists

    qm, qa = _sub("quantizer", meta, arrays)
    idx.quantizer = load_index(qm, qa, device=device)
    idx.nprobe = int(meta["nprobe"])
    idx.ntotal = int(meta["ntotal"])
    idx.is_trained = True
    if meta.get("il_from_host"):
        idx._xb_host = [arrays["xb_host"]]
        idx._ids_host = [np.asarray(arrays["ids_host"], np.int64)]
        idx._assign_host = [np.asarray(arrays["assign_host"], np.int64)
                            if "assign_host" in arrays else None]
        idx._dirty = True
        idx.invlists = None
        return idx
    if meta.get("has_invlists"):
        if meta.get("il_coded"):
            idx.invlists = PackedCodeInvLists(
                codes=to_tensor(arrays["il_data"], device),
                ids=to_tensor(arrays["il_ids"], device, np.int32),
                list_block_start=to_tensor(arrays["il_start"], device,
                                           np.int32),
                list_nblocks=to_tensor(arrays["il_nblocks"], device,
                                       np.int32))
        else:
            idx.invlists = PackedInvLists.from_arrays(
                arrays["il_data"], arrays["il_ids"], arrays["il_norms"],
                arrays["il_start"], arrays["il_nblocks"], device=device)
    if "ids_host" in arrays:
        # packed invlists store row indices: the row -> id map (present
        # also in search-only files without a host store)
        ids = np.asarray(arrays["ids_host"], np.int64)
        _set_ids_flat(idx, ids)
        if "xb_host" in arrays:
            idx._xb_host = [arrays["xb_host"]]
            idx._ids_host = [ids]
            idx._assign_host = [None]
    return idx


def _dump_ivfflat(index):
    meta, arrays = _dump_ivf_common(index)
    meta["tag"] = "IwFl"
    return meta, arrays


def _load_ivfflat(meta, arrays, device):
    from ..models.flat import IndexFlat
    from ..models.ivf import IndexIVFFlat

    d, metric = int(meta["d"]), int(meta["metric"])
    idx = IndexIVFFlat(IndexFlat(d, metric, device=device), d,
                       int(meta["nlist"]), metric, int(meta["block_size"]),
                       device=device)
    return _restore_ivf_common(idx, meta, arrays, device)


def _dump_ivfdedup(index):
    """IwFD (reference :390-417): IwFl's arrays plus ``instances`` as the
    parallel arrays dedup_reps / dedup_dups."""
    meta, arrays = _dump_ivf_common(index)
    meta["tag"] = "IwFD"
    pairs = [(rep, dup) for rep, dups in index.instances.items()
             for dup in dups]
    if pairs:
        arrays["dedup_reps"] = np.asarray([p[0] for p in pairs], np.int64)
        arrays["dedup_dups"] = np.asarray([p[1] for p in pairs], np.int64)
    return meta, arrays


def _load_ivfdedup(meta, arrays, device):
    from ..models.flat import IndexFlat
    from ..models.ivf import IndexIVFFlatDedup

    d, metric = int(meta["d"]), int(meta["metric"])
    idx = IndexIVFFlatDedup(IndexFlat(d, metric, device=device), d,
                            int(meta["nlist"]), metric,
                            int(meta["block_size"]), device=device)
    if "dedup_reps" in arrays:
        for rep, dup in zip(np.asarray(arrays["dedup_reps"]),
                            np.asarray(arrays["dedup_dups"])):
            idx.instances.setdefault(int(rep), []).append(int(dup))
    return _restore_ivf_common(idx, meta, arrays, device)


def _dump_ivfhnsw(index):
    meta, arrays = _dump_ivf_common(index)
    meta["tag"] = "IwHn"
    meta["add_chunk_size"] = index.add_chunk_size
    return meta, arrays


def _load_ivfhnsw(meta, arrays, device):
    from ..models.ivf_hnsw import IndexIVFHNSW

    idx = IndexIVFHNSW(int(meta["d"]), int(meta["nlist"]),
                       int(meta["metric"]),
                       M=int(meta["quantizer"].get("M", 32)),
                       block_size=int(meta["block_size"]), device=device)
    idx.add_chunk_size = int(meta.get("add_chunk_size", 100000))
    return _restore_ivf_common(idx, meta, arrays, device)


def _dump_sq(index):
    meta = {"tag": "IxSQ", "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "qtype": index.qtype}
    arrays = {}
    if index.sq is not None and index.sq.vmin is not None:
        arrays["vmin"] = index.sq.vmin
        arrays["vdiff"] = index.sq.vdiff
    if index.ntotal:
        arrays["codes"] = index._codes
    return meta, arrays


def _load_sq(meta, arrays, device):
    from ..models.pq import IndexScalarQuantizer
    from ..ops.sq import SQCodec

    idx = IndexScalarQuantizer(int(meta["d"]), int(meta["qtype"]),
                               int(meta["metric"]), device=device)
    idx.sq = SQCodec(qtype=idx.qtype, d=idx.d,
                     vmin=_f32_or_none(arrays, "vmin"),
                     vdiff=_f32_or_none(arrays, "vdiff"))
    idx.is_trained = True
    if "codes" in arrays:
        idx._codes = to_tensor(arrays["codes"], device)
        idx.ntotal = int(meta["ntotal"])
    return idx


def _dump_ivfsq(index):
    meta, arrays = _dump_ivf_common(index)
    meta["tag"] = "IwSQ"
    meta["qtype"] = index.qtype
    if index.sq is not None and index.sq.vmin is not None:
        arrays["sq_vmin"] = index.sq.vmin
        arrays["sq_vdiff"] = index.sq.vdiff
    return meta, arrays


def _load_ivfsq(meta, arrays, device):
    from ..models.flat import IndexFlat
    from ..models.ivf_pq import IndexIVFScalarQuantizer
    from ..ops.sq import SQCodec

    d, metric = int(meta["d"]), int(meta["metric"])
    idx = IndexIVFScalarQuantizer(
        IndexFlat(d, metric, device=device), d, int(meta["nlist"]),
        int(meta["qtype"]), metric, int(meta["block_size"]), device=device)
    idx.sq = SQCodec(qtype=idx.qtype, d=d,
                     vmin=_f32_or_none(arrays, "sq_vmin"),
                     vdiff=_f32_or_none(arrays, "sq_vdiff"))
    return _restore_ivf_common(idx, meta, arrays, device)


def _dump_pq(index):
    """IxPQ (reference :499-527): the codebook (a polysemous index's
    permuted one) and the stored codes; the port adds its search type and
    polysemous threshold, which the reference's loader ignores."""
    return ({"tag": "IxPQ", "d": index.d, "metric": index.metric_type,
             "ntotal": index.ntotal, "M": index.M, "nbits": index.nbits,
             "search_type": index.search_type,
             "polysemous_ht": index.polysemous_ht,
             "do_polysemous_training": index.do_polysemous_training},
            {"centroids": index.pq.centroids,
             "codes": index._codes if index.ntotal
             else np.zeros((0, 0), np.uint8)})


def _load_pq(meta, arrays, device):
    from ..models.pq import IndexPQ

    idx = IndexPQ(int(meta["d"]), int(meta["M"]), int(meta["nbits"]),
                  int(meta["metric"]), device=device)
    idx._set_codec(arrays["centroids"])
    idx.search_type = int(meta.get("search_type", idx.ST_PQ))
    idx.polysemous_ht = int(meta.get("polysemous_ht", 0))
    idx.do_polysemous_training = bool(meta.get("do_polysemous_training",
                                               False))
    if meta["ntotal"]:
        idx._codes = to_tensor(arrays["codes"], device, np.uint8)
        idx._capacity = idx._codes.shape[0]
        idx.ntotal = int(meta["ntotal"])
    return idx


def _dump_ivfpq(index, tag="IwPQ"):
    """IwPQ (reference :566-592): the IVF arrays (code lists), the PQ
    codebook and by_residual. The decoded cache is never written."""
    meta, arrays = _dump_ivf_common(index)
    meta["tag"] = tag
    meta.update(M=index.M, nbits=index.nbits,
                by_residual=bool(index.by_residual))
    arrays["pq_centroids"] = index.pq.centroids
    return meta, arrays


def _ivfpq_shell(cls, meta, arrays, device, *extra):
    from ..models.flat import IndexFlat

    d, metric = int(meta["d"]), int(meta["metric"])
    idx = cls(IndexFlat(d, metric, device=device), d, int(meta["nlist"]),
              int(meta["M"]), int(meta["nbits"]), *extra, metric,
              int(meta["block_size"]), device=device)
    idx.by_residual = bool(meta["by_residual"])
    idx._set_codec(arrays["pq_centroids"])
    return idx


def _load_ivfpq(meta, arrays, device):
    from ..models.ivf_pq import IndexIVFPQ

    idx = _ivfpq_shell(IndexIVFPQ, meta, arrays, device)
    return _restore_ivf_common(idx, meta, arrays, device)


def _dump_ivfpqr(index):
    """IwPR (reference :924-965): IwPQ's arrays, the refine codebook and
    the row-indexed side tables of the re-rank."""
    meta, arrays = _dump_ivfpq(index, "IwPR")
    meta.update(M_refine=index.M_refine, nbits_refine=index.nbits_refine,
                k_factor=index.k_factor)
    arrays["refine_centroids"] = index.refine_pq.centroids
    if index._row_codes is not None:
        arrays.update(row_codes=index._row_codes,
                      row_refine=index._row_refine,
                      row_assign=index._row_assign)
    return meta, arrays


def _load_ivfpqr(meta, arrays, device):
    from ..models.ivf_pq import IndexIVFPQR

    idx = _ivfpq_shell(IndexIVFPQR, meta, arrays, device,
                       int(meta["M_refine"]), int(meta["nbits_refine"]))
    idx.k_factor = int(meta["k_factor"])
    idx._set_refine_codec(arrays["refine_centroids"])
    if "row_codes" in arrays:
        idx._row_codes = to_tensor(arrays["row_codes"], device, np.uint8)
        idx._row_refine = to_tensor(arrays["row_refine"], device, np.uint8)
        idx._row_assign = to_tensor(arrays["row_assign"], device, np.int32)
    return _restore_ivf_common(idx, meta, arrays, device)


def _dump_refine(index):
    """IxRF (reference :688-710): the base and the refine index, nested."""
    meta = {"tag": "IxRF", "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "k_factor": index.k_factor}
    arrays: dict = {}
    _flatten("base", *dump_index(index.base_index), meta, arrays)
    _flatten("refine", *dump_index(index.refine_index), meta, arrays)
    return meta, arrays


def _load_refine(meta, arrays, device):
    from ..models.refine import IndexRefineFlat

    idx = IndexRefineFlat(
        load_index(*_sub("base", meta, arrays), device=device),
        load_index(*_sub("refine", meta, arrays), device=device))
    idx.k_factor = int(meta["k_factor"])
    idx.ntotal = int(meta["ntotal"])
    idx.is_trained = True
    return idx


def _dump_refine_sq8_tier(index):
    """IxRT (reference :712-740): the codec, the codes and the base
    index."""
    meta = {"tag": "IxRT", "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "k_factor": index.k_factor,
            "qtype": index.codec.qtype}
    arrays = {"vmin": np.asarray(index.codec.vmin, np.float32),
              "vdiff": np.asarray(index.codec.vdiff, np.float32)}
    if index._codes is not None:
        arrays["codes"] = index._codes
    _flatten("base", *dump_index(index.base_index), meta, arrays)
    return meta, arrays


def _load_refine_sq8_tier(meta, arrays, device):
    from ..models.refine import IndexRefineSQ8Tier
    from ..ops.sq import SQCodec

    idx = IndexRefineSQ8Tier(
        load_index(*_sub("base", meta, arrays), device=device))
    idx.codec = SQCodec(qtype=int(meta["qtype"]), d=int(meta["d"]),
                        vmin=_f32_or_none(arrays, "vmin"),
                        vdiff=_f32_or_none(arrays, "vdiff"))
    if "codes" in arrays:
        idx._codes = to_tensor(arrays["codes"], device, np.uint8)
    idx.k_factor = int(meta["k_factor"])
    idx.ntotal = int(meta["ntotal"])
    idx.is_trained = True
    return idx


def _dump_ivf_paged(index):
    """Like faiss OnDiskInvertedLists, the file holds the DIRECTORY of the
    block-stream memmaps (byte-equal across the two packages), not the
    streams (reference :1352-1363)."""
    meta = {"tag": "IwPG", "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "nlist": index.nlist,
            "nprobe": index.nprobe, "block_size": index.block_size,
            "path": index.path}
    arrays = {}
    if index.centroids is not None:
        arrays["centroids"] = np.asarray(index.centroids, np.float32)
    return meta, arrays


def _load_ivf_paged(meta, arrays, device):
    from ..models.ivf_paged import IndexIVFFlatPaged
    from ..ops import ivf_scan_paged as PS

    idx = IndexIVFFlatPaged(int(meta["d"]), int(meta["nlist"]), meta["path"],
                            int(meta["metric"]), int(meta["block_size"]),
                            device=device)
    idx.nprobe = int(meta["nprobe"])
    idx.ntotal = int(meta["ntotal"])
    if "centroids" in arrays:
        idx.centroids = np.array(arrays["centroids"], np.float32)
        idx._cent_dev = torch.from_numpy(idx.centroids).to(idx.device)
        idx.is_trained = True
    if os.path.exists(os.path.join(meta["path"], "paged_meta.json")):
        idx.invlists = PS.open_paged_invlists(meta["path"])
        idx.keep_f32 = idx.invlists.data_f32 is not None
    return idx


# --- composites: transforms, id maps, shards, replicas (reference :620-684,
#     1530-1580) ----------------------------------------------------------

def _dump_pretransform(index):
    """IxPT: the reference's keys for each linear transform (vt<i>_A,
    vt<i>_b, vt<i>_din / dout / ortho) plus two the reference ignores:
    ``vt<i>_params`` (the transform's scalar settings) and the arrays
    vt<i>_mean / _eigenvalues / _map, so that the port reopens the same
    classes. A chain with a non-linear transform (L2norm) is a file only
    the port reads."""
    from ..models.transforms import LinearTransform

    meta = {"tag": "IxPT", "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "nchain": len(index.chain),
            "chain_types": [type(t).__name__ for t in index.chain]}
    arrays: dict = {}
    for i, t in enumerate(index.chain):
        _dump_vt_at(t, f"vt{i}", meta, arrays)
    _flatten("sub", *dump_index(index.index), meta, arrays)
    return meta, arrays


def _load_vt(i: int, meta, arrays, device):
    """Transform i of an IxPT file."""
    return _load_vt_at(f"vt{i}", meta["chain_types"][i]
                       if "chain_types" in meta else None, meta, arrays,
                       device)


def _load_vt_at(prefix: str, cls_name, meta, arrays, device):
    """The transform stored under ``prefix``: its class with its settings
    from a port file (``<prefix>_params``), a LinearTransform from a
    reference file (as the reference reloads every transform)."""
    from ..models import transforms as TR

    params = meta.get(f"{prefix}_params")
    cls = TR.LinearTransform if params is None else getattr(TR, cls_name)
    t = cls.__new__(cls)
    TR.VectorTransform.__init__(t, int(meta[f"{prefix}_din"]),
                                int(meta[f"{prefix}_dout"]), device=device)
    if isinstance(t, TR.LinearTransform):
        t.A = np.array(arrays[f"{prefix}_A"], np.float32)
        t.b = _f32_or_none(arrays, f"{prefix}_b")
        t.is_orthonormal = bool(meta[f"{prefix}_ortho"])
    t.__dict__.update(params or {})
    for name in ("mean", "eigenvalues", "map"):
        if f"{prefix}_{name}" in arrays:
            setattr(t, name, np.array(arrays[f"{prefix}_{name}"]))
    t.is_trained = True
    return t


def _dump_vt_at(t, prefix: str, meta: dict, arrays: dict) -> None:
    """A transform under ``prefix``: the reference's keys (<prefix>_A, _b,
    _din, _dout, _ortho, _cls) and, for the port, its scalar settings
    (<prefix>_params) and arrays (_mean, _eigenvalues, _map)."""
    from ..models.transforms import LinearTransform

    meta[f"{prefix}_cls"] = type(t).__name__
    meta[f"{prefix}_din"], meta[f"{prefix}_dout"] = t.d_in, t.d_out
    if isinstance(t, LinearTransform):
        arrays[f"{prefix}_A"] = np.asarray(t.A, np.float32)
        if t.b is not None:
            arrays[f"{prefix}_b"] = np.asarray(t.b, np.float32)
        meta[f"{prefix}_ortho"] = bool(t.is_orthonormal)
    meta[f"{prefix}_params"] = {
        k: v for k, v in vars(t).items()
        if isinstance(v, (bool, int, float, str))
        and k not in ("d_in", "d_out", "is_trained", "is_orthonormal")}
    for name in ("mean", "eigenvalues", "map"):
        if getattr(t, name, None) is not None:
            arrays[f"{prefix}_{name}"] = np.asarray(getattr(t, name))


def _load_pretransform(meta, arrays, device):
    from ..models.transforms import IndexPreTransform

    chain = [_load_vt(i, meta, arrays, device)
             for i in range(int(meta["nchain"]))]
    idx = IndexPreTransform(*chain, load_index(*_sub("sub", meta, arrays),
                                               device=device))
    idx.ntotal = int(meta["ntotal"])
    idx.is_trained = True
    return idx


def _dump_idmap(index):
    """IxMp / IxM2: the id map and the sub-index; ``gone`` (a key the
    reference ignores) marks the internal ids removed from a sub-index
    that keeps its ids."""
    from ..models.idmap import IndexIDMap2

    meta = {"tag": "IxM2" if isinstance(index, IndexIDMap2) else "IxMp",
            "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal}
    arrays = {"id_map": np.asarray(index.id_map, np.int64)}
    if index._gone is not None:
        arrays["gone"] = index._gone
    _flatten("sub", *dump_index(index.index), meta, arrays)
    return meta, arrays


def _load_idmap(meta, arrays, device):
    from ..models.idmap import IndexIDMap, IndexIDMap2

    cls = IndexIDMap2 if meta["tag"] == "IxM2" else IndexIDMap
    idx = cls(load_index(*_sub("sub", meta, arrays), device=device))
    idx.id_map = np.array(arrays["id_map"], np.int64)
    if "gone" in arrays:
        idx._gone = np.array(arrays["gone"], bool)
    idx.ntotal = int(meta["ntotal"])
    if isinstance(idx, IndexIDMap2):
        idx.construct_rev_map()
    return idx


def _dump_shards(index):
    """IxSh: ``id_bases`` holds the ntotal of the shards before each shard,
    the one base a shard the reference reads (right after a single add);
    ``id_runs``, which the reference ignores, holds the port's runs of ids,
    one an add."""
    sizes = [s.ntotal for s in index.shard_indexes]
    meta = {"tag": "IxSh", "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "nshard": index.count,
            "successive_ids": bool(index.successive_ids),
            "id_bases": [int(b) for b in np.cumsum([0] + sizes)[:-1]],
            "id_runs": [[[int(v) for v in r] for r in runs]
                        for runs in index.id_runs]}
    arrays: dict = {}
    for i, sub in enumerate(index.shard_indexes):
        _flatten(f"shard{i}", *dump_index(sub), meta, arrays)
    return meta, arrays


def _load_shards(meta, arrays, device):
    from ..models.idmap import IndexShards

    idx = IndexShards(int(meta["d"]), int(meta["metric"]),
                      successive_ids=bool(meta["successive_ids"]),
                      device=device)
    for i in range(int(meta["nshard"])):
        idx.add_shard(load_index(*_sub(f"shard{i}", meta, arrays),
                                 device=device))
    if "id_runs" in meta:              # a port file; else the bases above
        idx.id_runs = [[tuple(r) for r in runs] for runs in meta["id_runs"]]
    idx.is_trained = True
    return idx


def _dump_replicas(index):
    meta = {"tag": "IxRp", "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "nrep": len(index.replicas)}
    arrays: dict = {}
    for i, sub in enumerate(index.replicas):
        _flatten(f"rep{i}", *dump_index(sub), meta, arrays)
    return meta, arrays


def _load_replicas(meta, arrays, device):
    from ..models.idmap import IndexReplicas

    idx = IndexReplicas(int(meta["d"]), int(meta["metric"]), device=device)
    for i in range(int(meta["nrep"])):
        idx.add_replica(load_index(*_sub(f"rep{i}", meta, arrays),
                                   device=device))
    idx.ntotal = int(meta["ntotal"])
    idx.is_trained = True
    return idx


_DUMPERS: dict = {}
_LOADERS: dict = {}


# --- the additive quantizers, QINCo and the lattice (reference :735-790,
#     :820-900, :1578-1623) -------------------------------------------------

_AQ_SCALARS = ("train_iters", "icm_iters", "nperts", "lambd", "nsplits",
               "Msub")


def _aq_meta(index) -> dict:
    m = {"M": index.M, "nbits": index.nbits, "beam_size": index.beam_size}
    for f in _AQ_SCALARS:
        if hasattr(index, f):
            m[f] = getattr(index, f)
    return m


def _aq_restore(idx, meta, arrays) -> None:
    for f in ("beam_size", "train_iters", "icm_iters", "nperts", "lambd"):
        if f in meta:
            setattr(idx, f, meta[f])
    if "codebooks" in arrays:
        idx._set_codec(np.asarray(arrays["codebooks"], np.float32))


def _aq_class(name: str):
    from ..models import rq as RQM

    if name not in RQM.__dict__ or not name.startswith(
            ("Index", "Residual", "LocalSearch")):
        raise ValueError(f"unknown additive quantizer class {name!r}")
    return getattr(RQM, name)


def _dump_rq(index):
    """IxRQ: the codebooks, the (n, M) stage codes and their norms."""
    meta = {"tag": "IxRQ", "cls": type(index).__name__, "d": index.d,
            "metric": index.metric_type, "ntotal": index.ntotal,
            "is_trained": index.is_trained, **_aq_meta(index)}
    arrays = {}
    if index.rq is not None:
        arrays["codebooks"] = index.rq.codebooks
    if index.ntotal:
        arrays.update(codes=index._codes, norms=index._norms)
    return meta, arrays


def _load_rq(meta, arrays, device):
    cls = _aq_class(meta["cls"])
    d, metric = int(meta["d"]), int(meta["metric"])
    if "nsplits" in meta:
        idx = cls(d, int(meta["nsplits"]), int(meta["Msub"]),
                  int(meta["nbits"]), metric, device=device)
    else:
        idx = cls(d, int(meta["M"]), int(meta["nbits"]), metric,
                  device=device)
    _aq_restore(idx, meta, arrays)
    if "codes" in arrays:
        idx._codes = to_tensor(arrays["codes"], device, np.uint8)
        idx._norms = to_tensor(arrays["norms"], device, np.float32)
        idx.ntotal = int(meta["ntotal"])
    return idx


def _dump_ivfrq(index):
    """IwRQ: the IVF arrays (code lists of stage bytes and norms), the
    codebooks and the class. The decoded cache is never written."""
    meta, arrays = _dump_ivf_common(index)
    meta.update(tag="IwRQ", cls=type(index).__name__, **_aq_meta(index))
    if index.rq is not None:
        arrays["codebooks"] = index.rq.codebooks
    return meta, arrays


def _load_ivfrq(meta, arrays, device):
    from ..models.flat import IndexFlat

    cls = _aq_class(meta["cls"])
    d, metric = int(meta["d"]), int(meta["metric"])
    q = IndexFlat(d, metric, device=device)    # replaced by the file's
    shape = ((int(meta["nsplits"]), int(meta["Msub"])) if "nsplits" in meta
             else (int(meta["M"]),))
    idx = cls(q, d, int(meta["nlist"]), *shape, int(meta["nbits"]), metric,
              int(meta["block_size"]), device=device)
    _aq_restore(idx, meta, arrays)
    return _restore_ivf_common(idx, meta, arrays, device)


def _dump_coarse_aq(index):
    """IxCQ: an additive coarse quantizer's codebooks and beam factor."""
    meta = {"tag": "IxCQ", "cls": type(index).__name__, "d": index.d,
            "metric": index.metric_type, "M": index.M,
            "nbits": index.nbits, "beam_factor": index.beam_factor,
            "is_trained": index.is_trained}
    arrays = {}
    if index.rq is not None:
        arrays["codebooks"] = index.rq.codebooks
    return meta, arrays


def _load_coarse_aq(meta, arrays, device):
    cls = _aq_class(meta["cls"])
    idx = cls(int(meta["d"]), int(meta["M"]), int(meta["nbits"]),
              int(meta["metric"]), device=device)
    idx.beam_factor = float(meta["beam_factor"])
    if "codebooks" in arrays:
        idx.set_codebooks(np.asarray(arrays["codebooks"], np.float32))
    return idx


# IxQN arrays of a step, in the reference's layout: right factors of
# MLPconcat's two halves, its bias, and (L, d, h) / (L, h, d) FFN weights
_QINCO_STEP = ("codebook", "w_cb", "w_xh", "b", "ffn_w1", "ffn_w2")


def _dump_qinco(index):
    """IxQN: the packed codes and the weights in the reference's layout."""
    meta = {"tag": "IxQN", "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "K": index.K, "L": index.L,
            "M": index.M, "h": index.h, "nbits": index.nbits}
    net = index.qinco
    arrays = {"codes": index._codes,
              "codebook0": net.codebook0.weight.detach()}
    for i, st in enumerate(net.steps):
        w_cb, w_xh = st._weights()
        blocks = st.residual_blocks
        vals = (st.codebook.weight, w_cb, w_xh, st.MLPconcat.bias,
                torch.stack([b.linear1.weight.T for b in blocks])
                if len(blocks) else torch.zeros((0, index.d, index.h)),
                torch.stack([b.linear2.weight.T for b in blocks])
                if len(blocks) else torch.zeros((0, index.h, index.d)))
        for name, v in zip(_QINCO_STEP, vals):
            arrays[f"step{i}/{name}"] = v.detach()
    return meta, arrays


def _load_qinco(meta, arrays, device):
    from ..models.qinco import IndexQINCo
    from ..ops.qinco import QINCo

    d, L = int(meta["d"]), int(meta["L"])
    state = {"codebook0.weight": np.asarray(arrays["codebook0"])}
    for i in range(int(meta["M"]) - 1):
        a = {n: np.asarray(arrays[f"step{i}/{n}"], np.float32)
             for n in _QINCO_STEP}
        state[f"steps.{i}.codebook.weight"] = a["codebook"]
        state[f"steps.{i}.MLPconcat.weight"] = np.concatenate(
            [a["w_cb"].T, a["w_xh"].T], axis=1)
        state[f"steps.{i}.MLPconcat.bias"] = a["b"]
        for j in range(L):
            state[f"steps.{i}.residual_blocks.{j}.linear1.weight"] = \
                a["ffn_w1"][j].T
            state[f"steps.{i}.residual_blocks.{j}.linear2.weight"] = \
                a["ffn_w2"][j].T
    net = QINCo(d, int(meta["K"]), L, int(meta["M"]), int(meta["h"]))
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v,
                                                                  np.float32))
                         for k, v in state.items()})
    idx = IndexQINCo(d, int(meta["K"]), L, int(meta["M"]), int(meta["h"]),
                     int(meta["metric"]), net, device=device)
    idx._codes = to_tensor(arrays["codes"], device, np.uint8)
    idx.ntotal = int(meta["ntotal"])
    return idx


def _dump_lattice(index):
    """IxLt: the packed codes and the trained norm range."""
    meta = {"tag": "IxLt", "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "nsq": index.nsq,
            "scale_nbit": index.scale_nbit, "r2": index.zn.r2,
            "is_trained": index.is_trained}
    arrays = {"codes": index._codes}
    if index.trained is not None:
        arrays["trained"] = index.trained
    return meta, arrays


def _load_lattice(meta, arrays, device):
    from ..models.lattice import IndexLattice

    idx = IndexLattice(int(meta["d"]), int(meta["nsq"]),
                       int(meta["scale_nbit"]), int(meta["r2"]),
                       int(meta["metric"]), device=device)
    if "trained" in arrays:
        idx.trained = np.array(arrays["trained"], np.float32)
    idx.is_trained = bool(meta["is_trained"])
    idx._codes = to_tensor(arrays["codes"], device, np.uint8)
    idx.ntotal = int(meta["ntotal"])
    return idx


# --- the binary family (reference :966-1083) --------------------------------

def _dump_binflat(index):
    meta = {"tag": "BxFl", "d": index.d, "ntotal": index.ntotal}
    return meta, ({"codes": index.codes} if index.ntotal else {})


def _load_binflat(meta, arrays, device):
    from ..models.binary import IndexBinaryFlat

    idx = IndexBinaryFlat(int(meta["d"]), device=device)
    if "codes" in arrays:
        idx.add(np.asarray(arrays["codes"]))
    return idx


def _dump_binivf(index):
    """BwFl: the quantizer, nested, and the host store (codes and ids); a
    reopened index packs its lists at its first search, as the reference
    repacks at load."""
    meta = {"tag": "BwFl", "d": index.d, "ntotal": index.ntotal,
            "nlist": index.nlist, "nprobe": index.nprobe,
            "is_trained": index.is_trained}
    arrays: dict = {}
    _flatten("quantizer", *dump_index(index.quantizer), meta, arrays)
    if index.ntotal:
        arrays["codes"] = np.concatenate(index._codes_host)
        arrays["ids"] = np.concatenate(index._ids_host)
    return meta, arrays


def _load_binivf(meta, arrays, device):
    from ..models.binary import IndexBinaryIVF

    idx = IndexBinaryIVF(load_index(*_sub("quantizer", meta, arrays),
                                    device=device),
                         int(meta["d"]), int(meta["nlist"]), device=device)
    idx.nprobe = int(meta["nprobe"])
    idx.is_trained = bool(meta["is_trained"])
    if "codes" in arrays:
        idx._codes_host = [np.array(arrays["codes"], np.uint8)]
        idx._ids_host = [np.array(arrays["ids"], np.int64)]
        idx.ntotal = int(meta["ntotal"])
        idx._dirty = True
    return idx


def _dump_binhnsw(index):
    meta = {"tag": "BxHN", "d": index.d, "ntotal": index.ntotal}
    arrays: dict = {"codes": index._codes} if index.ntotal else {}
    _flatten("sub", *dump_index(index.index), meta, arrays)
    return meta, arrays


def _load_binhnsw(meta, arrays, device):
    from ..models.binary import IndexBinaryHNSW

    idx = IndexBinaryHNSW(int(meta["d"]), device=device)
    idx.index = load_index(*_sub("sub", meta, arrays), device=device)
    if "codes" in arrays:
        idx._codes = to_tensor(arrays["codes"], device, np.uint8)
    idx.ntotal = int(meta["ntotal"])
    return idx


def _dump_binhash(index):
    from ..models.binary import IndexBinaryMultiHash

    meta = {"d": index.d, "ntotal": index.ntotal, "b": index.b,
            "nflip": index.nflip}
    if isinstance(index, IndexBinaryMultiHash):
        meta.update(tag="BxMH", nhash=index.nhash)
    else:
        meta["tag"] = "BxHs"
    return meta, ({"codes": index._codes} if index.ntotal else {})


def _load_binhash(meta, arrays, device):
    """BxHs / BxMH: the codes; the tables are rebuilt from them."""
    from ..models.binary import IndexBinaryHash, IndexBinaryMultiHash

    if meta["tag"] == "BxMH":
        idx = IndexBinaryMultiHash(int(meta["d"]), int(meta["nhash"]),
                                   int(meta["b"]), device=device)
    else:
        idx = IndexBinaryHash(int(meta["d"]), int(meta["b"]), device=device)
    idx.nflip = int(meta["nflip"])
    if "codes" in arrays:
        idx.add(np.asarray(arrays["codes"]))
    return idx


def _dump_binfromfloat(index):
    meta = {"tag": "BxFF", "d": index.d, "ntotal": index.ntotal}
    arrays: dict = {}
    _flatten("sub", *dump_index(index.index), meta, arrays)
    return meta, arrays


def _load_binfromfloat(meta, arrays, device):
    from ..models.binary import IndexBinaryFromFloat

    idx = IndexBinaryFromFloat(load_index(*_sub("sub", meta, arrays),
                                          device=device))
    idx.ntotal = int(meta["ntotal"])
    return idx


# --- the long-tail float indexes (reference :1085-1256) ---------------------

def _dump_lsh(index):
    meta = {"tag": "IxLs", "d": index.d, "ntotal": index.ntotal,
            "nbits": index.nbits, "rotate_data": bool(index.rotate_data),
            "train_thresholds": bool(index.train_thresholds),
            "is_trained": index.is_trained}
    arrays = {"P": index.P, "thresholds": index.thresholds}
    if index.ntotal:
        arrays["codes"] = index._bin.codes
    return meta, arrays


def _load_lsh(meta, arrays, device):
    from ..models.extra import IndexLSH

    idx = IndexLSH(int(meta["d"]), int(meta["nbits"]),
                   bool(meta["rotate_data"]), bool(meta["train_thresholds"]),
                   device=device)
    idx.P = np.array(arrays["P"], np.float32)
    idx.thresholds = np.array(arrays["thresholds"], np.float32)
    idx.is_trained = bool(meta["is_trained"])
    if "codes" in arrays:
        idx._bin.add(np.asarray(arrays["codes"]))
        idx.ntotal = idx._bin.ntotal
    return idx


def _dump_minmax(index):
    meta = {"tag": "IxMM", "d": index.d, "ntotal": index.ntotal}
    arrays: dict = {}
    if index.ntotal:
        arrays.update(mins=index._mins, scales=index._scales)
    _flatten("sub", *dump_index(index.index), meta, arrays)
    return meta, arrays


def _load_minmax(meta, arrays, device):
    from ..models.extra import IndexRowwiseMinMax

    idx = IndexRowwiseMinMax(load_index(*_sub("sub", meta, arrays),
                                        device=device))
    if "mins" in arrays:
        idx._mins = to_tensor(arrays["mins"], device, np.float32)
        idx._scales = to_tensor(arrays["scales"], device, np.float32)
    idx.ntotal = int(meta["ntotal"])
    return idx


def _dump_imi(index):
    meta = {"tag": "IxMI", "d": index.d, "ntotal": index.ntotal,
            "M": index.M, "nbits": index.nbits,
            "is_trained": index.is_trained}
    return meta, ({"centroids": index.pq.centroids}
                  if index.pq is not None else {})


def _load_imi(meta, arrays, device):
    from ..models.extra import MultiIndexQuantizer

    idx = MultiIndexQuantizer(int(meta["d"]), int(meta["M"]),
                              int(meta["nbits"]), device=device)
    if "centroids" in arrays:
        idx._set_codec(np.array(arrays["centroids"], np.float32))
    return idx


def _dump_split(index):
    meta = {"tag": "IxSV", "d": index.d, "ntotal": index.ntotal,
            "nsub": len(index.sub_indexes)}
    arrays: dict = {}
    for i, sub in enumerate(index.sub_indexes):
        _flatten(f"sub{i}", *dump_index(sub), meta, arrays)
    return meta, arrays


def _load_split(meta, arrays, device):
    from ..models.extra import IndexSplitVectors

    idx = IndexSplitVectors(int(meta["d"]), device=device)
    for i in range(int(meta["nsub"])):
        idx.add_sub_index(load_index(*_sub(f"sub{i}", meta, arrays),
                                     device=device))
    idx.ntotal = int(meta["ntotal"])
    return idx


def _dump_random(index):
    return ({"tag": "IxRn", "d": index.d, "ntotal": index.ntotal,
             "seed": int(index.seed)}, {})


def _load_random(meta, arrays, device):
    from ..models.extra import IndexRandom

    return IndexRandom(int(meta["d"]), int(meta["ntotal"]),
                       int(meta["seed"]), device=device)


# --- the graph indexes (reference :1259-1411) -------------------------------

def _graph_meta(index, tag: str) -> dict:
    return {"tag": tag, "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "efSearch": int(index.efSearch)}


def _dump_nsg(index):
    """IxNS / IxNP / IxNQ: the graph, the medoid and the storage (the
    flat rows, or the codes and their codec)."""
    from ..models.nsg import IndexNSGPQ, IndexNSGSQ

    meta = _graph_meta(index, "IxNS")
    meta.update(R=index.R, GK=index.GK, medoid=int(index.medoid))
    arrays: dict = {}
    if isinstance(index, IndexNSGPQ):
        meta.update(tag="IxNP", pq_m=index.pq_m, nbits=index.nbits,
                    is_trained=index.is_trained)
        if index.pq is not None:
            arrays["centroids"] = index.pq.centroids
    elif isinstance(index, IndexNSGSQ):
        meta.update(tag="IxNQ", qtype=index.qtype,
                    is_trained=index.is_trained)
        if index.sq is not None and index.sq.vmin is not None:
            arrays["sq_vmin"] = np.asarray(index.sq.vmin, np.float32)
            arrays["sq_vdiff"] = np.asarray(index.sq.vdiff, np.float32)
    if meta["tag"] == "IxNS":
        if index.ntotal:
            arrays["xb"] = index.storage.vectors
    elif index._codes is not None:
        arrays["codes"] = index._codes
    if index.graph is not None:
        arrays["graph"] = index.graph
    return meta, arrays


def _load_nsg(meta, arrays, device):
    from ..models import nsg as NSG
    from ..ops.sq import SQCodec

    d, R, metric = int(meta["d"]), int(meta["R"]), int(meta["metric"])
    tag = meta["tag"]
    if tag == "IxNP":
        idx = NSG.IndexNSGPQ(d, int(meta["pq_m"]), R, int(meta["nbits"]),
                             metric, device=device)
        if "centroids" in arrays:
            idx._set_codec(np.array(arrays["centroids"], np.float32))
    elif tag == "IxNQ":
        idx = NSG.IndexNSGSQ(d, int(meta["qtype"]), R, metric,
                             device=device)
        if "sq_vmin" in arrays:
            idx.sq = SQCodec(qtype=idx.qtype, d=d,
                             vmin=np.array(arrays["sq_vmin"], np.float32),
                             vdiff=np.array(arrays["sq_vdiff"], np.float32))
    else:
        idx = NSG.IndexNSGFlat(d, R, metric, device=device)
    idx.GK = int(meta["GK"])
    idx.medoid = int(meta["medoid"])
    if "is_trained" in meta:
        idx.is_trained = bool(meta["is_trained"])
    if "codes" in arrays:
        idx._set_codes(to_tensor(arrays["codes"], device))
    return _graph_shell(idx, meta, arrays, device)


def _graph_shell(idx, meta, arrays, device):
    idx.efSearch = int(meta["efSearch"])
    if "xb" in arrays:
        idx.storage.add(np.asarray(arrays["xb"]))
        idx.ntotal = idx.storage.ntotal
    if "graph" in arrays:
        idx.graph = to_tensor(arrays["graph"], device, np.int32)
    return idx


def _dump_nnd(index):
    meta = _graph_meta(index, "IxND")
    meta["K"] = index.K
    arrays: dict = {}
    if index.ntotal:
        arrays["xb"] = index.storage.vectors
    if index.graph is not None:
        arrays["graph"] = index.graph
    return meta, arrays


def _load_nnd(meta, arrays, device):
    from ..models.nsg import IndexNNDescentFlat

    idx = IndexNNDescentFlat(int(meta["d"]), int(meta["K"]),
                             int(meta["metric"]), device=device)
    return _graph_shell(idx, meta, arrays, device)


# --- the IVF couplings (reference :1447-1527) -------------------------------

def _dump_spectralhash(index):
    """IwSH: the IVF arrays (the code lists), nbit, period, the threshold
    type, the thresholds and the projection (``vt``)."""
    meta, arrays = _dump_ivf_common(index)
    meta.update(tag="IwSH", nbit=index.nbit, period=index.period,
                threshold_type=index.threshold_type)
    _dump_vt_at(index.vt, "vt", meta, arrays)
    if index.trained is not None:
        arrays["trained"] = np.asarray(index.trained, np.float32)
    return meta, arrays


def _load_spectralhash(meta, arrays, device):
    from ..models.flat import IndexFlat
    from ..models.ivf_extra import IndexIVFSpectralHash

    d, metric = int(meta["d"]), int(meta["metric"])
    idx = IndexIVFSpectralHash(
        IndexFlat(d, metric, device=device), d, int(meta["nlist"]),
        int(meta["nbit"]), float(meta["period"]), metric,
        int(meta["block_size"]), device=device)
    idx.threshold_type = meta["threshold_type"]
    idx.vt = _load_vt_at("vt", meta.get("vt_cls"), meta, arrays, device)
    if "trained" in arrays:
        idx.trained = np.array(arrays["trained"], np.float32)
    return _restore_ivf_common(idx, meta, arrays, device)


def _dump_independent(index):
    meta = {"tag": "IwIQ", "d": index.d, "metric": index.metric_type,
            "ntotal": index.ntotal, "is_trained": index.is_trained,
            "has_vt": index.vt is not None}
    arrays: dict = {}
    _flatten("quantizer", *dump_index(index.quantizer), meta, arrays)
    _flatten("payload", *dump_index(index.index_ivf), meta, arrays)
    if index.vt is not None:
        _dump_vt_at(index.vt, "vt", meta, arrays)
    return meta, arrays


def _load_independent(meta, arrays, device):
    from ..models.ivf_extra import IndexIVFIndependentQuantizer

    vt = _load_vt_at("vt", meta.get("vt_cls"), meta, arrays, device) \
        if meta.get("has_vt") else None
    idx = IndexIVFIndependentQuantizer(
        load_index(*_sub("quantizer", meta, arrays), device=device),
        load_index(*_sub("payload", meta, arrays), device=device), vt)
    idx.is_trained = bool(meta["is_trained"])
    idx.ntotal = int(meta["ntotal"])
    return idx


def _register(cls_name: str, tag: str, dump, load) -> None:
    _DUMPERS[cls_name] = dump
    _LOADERS[tag] = load


_register("IndexFlat", "IxFl", _dump_flat, _load_flat)
_register("IndexFlatL2", "IxFl", _dump_flat, _load_flat)
_register("IndexFlatIP", "IxFl", _dump_flat, _load_flat)
_register("IndexFlat1D", "IxF1", _dump_flat1d, _load_flat1d)
_register("IndexHNSW", "IHNf", _dump_hnsw, _load_hnsw)
_register("IndexHNSWFlat", "IHNf", _dump_hnsw, _load_hnsw)
_register("IndexHNSWSQ", "IHNs", _dump_hnswsq, _load_hnswsq)
_register("IndexHNSWPQ", "IHNq", _dump_hnswpq, _load_hnswpq)
_register("IndexHNSW2Level", "IHN2", _dump_hnsw2level, _load_hnsw2level)
_register("Index2Layer", "Ix2L", _dump_2layer, _load_2layer)
_register("IndexIVF", "IwFl", _dump_ivfflat, _load_ivfflat)
_register("IndexIVFFlat", "IwFl", _dump_ivfflat, _load_ivfflat)
_register("IndexIVFFlatDedup", "IwFD", _dump_ivfdedup, _load_ivfdedup)
_register("IndexIVFHNSW", "IwHn", _dump_ivfhnsw, _load_ivfhnsw)
_register("IndexIVFFlatPaged", "IwPG", _dump_ivf_paged, _load_ivf_paged)
_register("IndexScalarQuantizer", "IxSQ", _dump_sq, _load_sq)
_register("IndexIVFScalarQuantizer", "IwSQ", _dump_ivfsq, _load_ivfsq)
_register("IndexPQ", "IxPQ", _dump_pq, _load_pq)
_register("IndexIVFPQ", "IwPQ", _dump_ivfpq, _load_ivfpq)
_register("IndexIVFPQR", "IwPR", _dump_ivfpqr, _load_ivfpqr)
_register("IndexRefine", "IxRF", _dump_refine, _load_refine)
_register("IndexRefineFlat", "IxRF", _dump_refine, _load_refine)
_register("IndexRefineSQ8Tier", "IxRT", _dump_refine_sq8_tier,
          _load_refine_sq8_tier)
_register("IndexPreTransform", "IxPT", _dump_pretransform,
          _load_pretransform)
_register("IndexIDMap", "IxMp", _dump_idmap, _load_idmap)
_register("IndexIDMap2", "IxM2", _dump_idmap, _load_idmap)
_register("IndexShards", "IxSh", _dump_shards, _load_shards)
_register("IndexReplicas", "IxRp", _dump_replicas, _load_replicas)
for _cls in ("IndexResidualQuantizer", "IndexAdditiveQuantizer",
             "IndexLocalSearchQuantizer",
             "IndexProductResidualQuantizer",
             "IndexProductLocalSearchQuantizer"):
    _register(_cls, "IxRQ", _dump_rq, _load_rq)
for _cls in ("IndexIVFResidualQuantizer", "IndexIVFLocalSearchQuantizer",
             "IndexIVFProductResidualQuantizer",
             "IndexIVFProductLocalSearchQuantizer"):
    _register(_cls, "IwRQ", _dump_ivfrq, _load_ivfrq)
for _cls in ("ResidualCoarseQuantizer", "LocalSearchCoarseQuantizer"):
    _register(_cls, "IxCQ", _dump_coarse_aq, _load_coarse_aq)
_register("IndexQINCo", "IxQN", _dump_qinco, _load_qinco)
_register("IndexLattice", "IxLt", _dump_lattice, _load_lattice)

_register("IndexBinaryFlat", "BxFl", _dump_binflat, _load_binflat)
_register("IndexBinaryIVF", "BwFl", _dump_binivf, _load_binivf)
_register("IndexBinaryHNSW", "BxHN", _dump_binhnsw, _load_binhnsw)
_register("IndexBinaryHash", "BxHs", _dump_binhash, _load_binhash)
_register("IndexBinaryMultiHash", "BxMH", _dump_binhash, _load_binhash)
_register("IndexBinaryFromFloat", "BxFF", _dump_binfromfloat,
          _load_binfromfloat)
_register("IndexLSH", "IxLs", _dump_lsh, _load_lsh)
_register("IndexRowwiseMinMax", "IxMM", _dump_minmax, _load_minmax)
_register("MultiIndexQuantizer", "IxMI", _dump_imi, _load_imi)
_register("IndexSplitVectors", "IxSV", _dump_split, _load_split)
_register("IndexRandom", "IxRn", _dump_random, _load_random)
_register("IndexNSGFlat", "IxNS", _dump_nsg, _load_nsg)
_register("IndexNSGPQ", "IxNP", _dump_nsg, _load_nsg)
_register("IndexNSGSQ", "IxNQ", _dump_nsg, _load_nsg)
_register("IndexNNDescentFlat", "IxND", _dump_nnd, _load_nnd)
_register("IndexIVFSpectralHash", "IwSH", _dump_spectralhash,
          _load_spectralhash)
_register("IndexIVFIndependentQuantizer", "IwIQ", _dump_independent,
          _load_independent)


def dump_index(index) -> Tuple[dict, dict]:
    name = type(index).__name__
    if name not in _DUMPERS:
        raise TypeError(f"don't know how to serialize {name}")
    return _DUMPERS[name](index)


def load_index(meta: dict, arrays: dict, *, device="cuda"):
    tag = meta["tag"]
    if tag not in _LOADERS:
        raise ValueError(f"unknown index tag {tag!r}")
    return _LOADERS[tag](meta, arrays, device)


# ---------------------------------------------------------------------------
# public API (index_io.h:39-70; reference :474-498, 1668-1687)
# ---------------------------------------------------------------------------

def write_index(index, path: str) -> None:
    meta, arrays = dump_index(index)
    _write_container(path, meta, arrays)


def read_index(path: str, mmap: bool = False, *, device="cuda"):
    """Load an index onto ``device``. ``mmap=True`` maps the file's blobs
    (the IO_FLAG_MMAP analog): host memory holds the pages an upload or a
    repack touches; what goes to the device is unchanged."""
    meta, arrays = _read_container(path, mmap=mmap)
    return load_index(meta, arrays, device=device)


def clone_index(index):
    """A deep copy through the serialized state, in memory, on the index's
    device (faiss clone_index): the clone shares no array with the
    original."""
    def host_copy(v):
        dstr, a = _blob(v)
        a = np.array(a, copy=True)
        return a.view(np.uint16).view(Bf16Array) if dstr == BF16 else a

    meta, arrays = dump_index(index)
    arrays = {k: host_copy(v) for k, v in arrays.items()}
    return load_index(copy.deepcopy(meta), arrays, device=index.device)


def serialize_index(index) -> np.ndarray:
    """Index -> uint8 array of the container's bytes (faiss
    serialize_index), e.g. to ship an index over a socket."""
    buf = io.BytesIO()
    meta, arrays = dump_index(index)
    _write_container(buf, meta, arrays)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


def deserialize_index(buf, *, device="cuda"):
    """uint8 array (or bytes) -> Index (faiss deserialize_index)."""
    meta, arrays = _read_container(buf)
    return load_index(meta, arrays, device=device)
