"""Inverted-list sources, composition views, the on-disk slot allocator
and the streaming on-disk merge — the port's copy of
`tpu_ann/utils/invlists_io.py` (numpy on the host; no device work).

The reference's read-only invlist views (faiss/invlists/InvertedLists.h:
306-401 — HStack / VStack / Slice / Masked / StopWords) and
`OnDiskInvertedLists::merge_from_multiple` (OnDiskInvertedLists.h:104-111,
contrib/ondisk.py) are expressed one level below the index: a host-side
*source* protocol (`list_size` / `get_list`) with lazy per-list reads,
views that compose sources, and a streaming writer that turns any source
into a standard packed index file (`utils.index_io`'s format) without
holding more than one list in host memory. `read_index(path, mmap=True)`
of either package then opens the merged file.

Peak host memory of `merge_ondisk` = O(largest single list), as in the
reference's merge, which moves one list at a time.
"""

from __future__ import annotations

import json
from typing import List, Sequence, Tuple

import numpy as np

from . import index_io as iio


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

class InvlistSource:
    """Read-only per-list access to inverted lists.

    Attributes:
      nlist: number of lists.
      coded: False -> `get_list` yields (sz, d) float32 vectors;
             True  -> (sz, code_width) uint8 codes.
      width: d (raw) or code bytes per vector (coded).
    """

    nlist: int = 0
    coded: bool = False
    width: int = 0

    def list_size(self, i: int) -> int:
        raise NotImplementedError

    def get_list(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (payload (sz, width), user ids (sz,) int64)."""
        raise NotImplementedError

    # convenience
    @property
    def ntotal(self) -> int:
        return sum(self.list_size(i) for i in range(self.nlist))


class ArraySource(InvlistSource):
    """Source over in-RAM per-list arrays (the ArrayInvertedLists analog)."""

    def __init__(self, payloads: Sequence[np.ndarray],
                 ids: Sequence[np.ndarray], coded: bool = False):
        self.nlist = len(payloads)
        self._p = [np.asarray(p) for p in payloads]
        self._i = [np.asarray(x, np.int64) for x in ids]
        self.coded = coded
        self.width = self._p[0].shape[1] if self.nlist else 0

    def list_size(self, i):
        return len(self._p[i])

    def get_list(self, i):
        return self._p[i], self._i[i]


class IndexInvlistSource(InvlistSource):
    """Source over a live IndexIVF's host store (grouped once by list)."""

    def __init__(self, index):
        index._maybe_repack()
        self.nlist = index.nlist
        if index._xb_host:
            # backfill missing per-chunk assignments (indexes loaded from
            # disk restore the host store with assign=None)
            for j, a in enumerate(index._assign_host):
                if a is None:
                    index._assign_host[j] = np.asarray(
                        index._assign(index._xb_host[j]), np.int64)
            x = np.concatenate(index._xb_host, axis=0)
            ids = np.concatenate(index._ids_host)
            assign = np.concatenate([
                np.asarray(a, np.int64) for a in index._assign_host])
        else:
            x = np.zeros((0, index.d), np.float32)
            ids = np.zeros(0, np.int64)
            assign = np.zeros(0, np.int64)
        order = np.argsort(assign, kind="stable")
        self._x = x[order]
        self._ids = np.asarray(ids, np.int64)[order]
        sizes = np.bincount(assign, minlength=self.nlist)
        self._starts = np.zeros(self.nlist + 1, np.int64)
        np.cumsum(sizes, out=self._starts[1:])
        self.width = x.shape[1]
        # payload is always the RAW host vectors, even for coded indexes
        # (merge_ondisk re-encodes per list when the destination is coded)
        self.coded = False

    def list_size(self, i):
        return int(self._starts[i + 1] - self._starts[i])

    def get_list(self, i):
        s, e = self._starts[i], self._starts[i + 1]
        return self._x[s:e], self._ids[s:e]


class FileInvlistSource(InvlistSource):
    """Source over a saved IndexIVF* file, reading per-list slices through
    mmap — the OnDiskInvertedLists read path (one list touched => one
    list's pages faulted in)."""

    def __init__(self, path: str):
        meta, arrays = iio._read_container(path, mmap=True)
        self.meta = meta
        if "il_data" in arrays:
            self._host_form = False
            self.coded = bool(meta.get("il_coded"))
            self._data = arrays["il_data"]        # (nb+1, B, w) mmap
            self._rowids = arrays["il_ids"]       # (nb+1, B) int32 row idx
            self._start = np.asarray(arrays["il_start"], np.int64)
            self._nblk = np.asarray(arrays["il_nblocks"], np.int64)
            self._user_ids = (np.asarray(arrays["ids_host"], np.int64)
                              if "ids_host" in arrays else None)
            self.nlist = len(self._start)
            self.B = self._data.shape[1]
            self.width = self._data.shape[2]
            # valid rows are the first `size` slots of the block range
            # (pack_invlists fills rank-contiguously); count via ids >= 0
            self._sizes = None
            return
        # Host-form IVF file: the il_from_host save path
        # (index_io._dump_ivf_common) skips the packed device layout for
        # raw-float invlists and stores the host vector store + per-row
        # coarse assignments instead. Per-list access is served by a
        # counting-sorted row-order table over the mmapped store — no
        # reordered copy is materialized (one list touched => one list's
        # rows gathered), keeping the OnDiskInvertedLists paging contract.
        if not (meta.get("il_from_host") and "xb_host" in arrays
                and "assign_host" in arrays):
            raise ValueError(f"{path}: no packed invlists in file")
        self._host_form = True
        self.coded = False
        self._xb = arrays["xb_host"]              # (n, d) mmap
        self._user_ids = np.asarray(arrays["ids_host"], np.int64)
        assign = np.asarray(arrays["assign_host"], np.int64)
        self.nlist = int(meta["nlist"])
        self.width = int(self._xb.shape[1])
        self._order = np.argsort(assign, kind="stable")
        sizes = np.bincount(assign, minlength=self.nlist)
        self._row_start = np.zeros(self.nlist + 1, np.int64)
        np.cumsum(sizes, out=self._row_start[1:])

    def list_size(self, i):
        if self._host_form:
            return int(self._row_start[i + 1] - self._row_start[i])
        if self._sizes is None:
            self._sizes = np.empty(self.nlist, np.int64)
            for l in range(self.nlist):
                s, nb = self._start[l], self._nblk[l]
                if nb == 0:
                    self._sizes[l] = 0
                else:
                    ids = np.asarray(self._rowids[s:s + nb]).reshape(-1)
                    self._sizes[l] = int((ids >= 0).sum())
        return int(self._sizes[i])

    def get_list(self, i):
        if self._host_form:
            rows = self._order[self._row_start[i]:self._row_start[i + 1]]
            rows = np.sort(rows)   # mmap gather in file order
            return (np.asarray(self._xb[rows]), self._user_ids[rows])
        s, nb = self._start[i], self._nblk[i]
        if nb == 0:
            return (np.zeros((0, self.width), self._data.dtype),
                    np.zeros(0, np.int64))
        sz = self.list_size(i)
        payload = np.asarray(
            self._data[s:s + nb]).reshape(-1, self.width)[:sz]
        rows = np.asarray(self._rowids[s:s + nb]).reshape(-1)[:sz]
        rows = rows.astype(np.int64)
        if self._user_ids is not None:
            return payload, self._user_ids[rows]
        return payload, rows


# ---------------------------------------------------------------------------
# composition views (InvertedLists.h:306-401 semantics)
# ---------------------------------------------------------------------------

def _check_compat(sources: Sequence[InvlistSource]):
    if not sources:
        raise ValueError("need at least one source")
    for s in sources[1:]:
        if s.coded != sources[0].coded or s.width != sources[0].width:
            raise ValueError("incompatible sources")


class HStackInvlists(InvlistSource):
    """List i = concatenation of list i from every component
    (HStackInvertedLists — the shard-merge view)."""

    def __init__(self, sources: Sequence[InvlistSource]):
        _check_compat(sources)
        nl = sources[0].nlist
        for s in sources:
            if s.nlist != nl:
                raise ValueError("HStack: nlist mismatch")
        self.sources = list(sources)
        self.nlist = nl
        self.coded = sources[0].coded
        self.width = sources[0].width

    def list_size(self, i):
        return sum(s.list_size(i) for s in self.sources)

    def get_list(self, i):
        parts = [s.get_list(i) for s in self.sources]
        return (np.concatenate([p for p, _ in parts], axis=0),
                np.concatenate([x for _, x in parts]))


class VStackInvlists(InvlistSource):
    """Lists partitioned among components: component j owns lists
    [cum_j, cum_{j+1}) (VStackInvertedLists)."""

    def __init__(self, sources: Sequence[InvlistSource]):
        _check_compat(sources)
        self.sources = list(sources)
        self._cum = np.zeros(len(sources) + 1, np.int64)
        np.cumsum([s.nlist for s in sources], out=self._cum[1:])
        self.nlist = int(self._cum[-1])
        self.coded = sources[0].coded
        self.width = sources[0].width

    def _loc(self, i):
        j = int(np.searchsorted(self._cum, i, side="right")) - 1
        return self.sources[j], i - int(self._cum[j])

    def list_size(self, i):
        s, li = self._loc(i)
        return s.list_size(li)

    def get_list(self, i):
        s, li = self._loc(i)
        return s.get_list(li)


class SliceInvlists(InvlistSource):
    """Lists [i0, i1) of another source (SliceInvertedLists /
    OnDiskInvertedLists::crop_invlists)."""

    def __init__(self, src: InvlistSource, i0: int, i1: int):
        if not 0 <= i0 <= i1 <= src.nlist:
            raise ValueError("bad slice")
        self.src, self.i0 = src, i0
        self.nlist = i1 - i0
        self.coded, self.width = src.coded, src.width

    def list_size(self, i):
        return self.src.list_size(self.i0 + i)

    def get_list(self, i):
        return self.src.get_list(self.i0 + i)


class MaskedInvlists(InvlistSource):
    """il0's list when non-empty, else il1's (MaskedInvertedLists)."""

    def __init__(self, il0: InvlistSource, il1: InvlistSource):
        _check_compat([il0, il1])
        if il0.nlist != il1.nlist:
            raise ValueError("Masked: nlist mismatch")
        self.il0, self.il1 = il0, il1
        self.nlist = il0.nlist
        self.coded, self.width = il0.coded, il0.width

    def list_size(self, i):
        s0 = self.il0.list_size(i)
        return s0 if s0 > 0 else self.il1.list_size(i)

    def get_list(self, i):
        if self.il0.list_size(i) > 0:
            return self.il0.get_list(i)
        return self.il1.get_list(i)


class StopWordsInvlists(InvlistSource):
    """Hide lists longer than maxsize (StopWordsInvertedLists)."""

    def __init__(self, src: InvlistSource, maxsize: int):
        self.src, self.maxsize = src, int(maxsize)
        self.nlist = src.nlist
        self.coded, self.width = src.coded, src.width

    def list_size(self, i):
        s = self.src.list_size(i)
        return s if s <= self.maxsize else 0

    def get_list(self, i):
        if self.src.list_size(i) > self.maxsize:
            return (np.zeros((0, self.width),
                             np.float32 if not self.coded else np.uint8),
                    np.zeros(0, np.int64))
        return self.src.get_list(i)


class _OneListCache(InvlistSource):
    """Memoize the list read last (the reference's). merge_ondisk's
    streams each walk all the lists in turn, one after another, so a list
    is still read once a stream: the memo saves only repeated reads of one
    list within a stream."""

    def __init__(self, src: InvlistSource):
        self.src = src
        self.nlist = src.nlist
        self.coded, self.width = src.coded, src.width
        self._i = -1
        self._val = None

    def list_size(self, i):
        return self.src.list_size(i)

    def get_list(self, i):
        if i != self._i:
            self._i, self._val = i, self.src.get_list(i)
        return self._val


# ---------------------------------------------------------------------------
# mutable on-disk inverted lists (slot allocator)
# ---------------------------------------------------------------------------

class OnDiskInvertedLists(InvlistSource):
    """Mutable on-disk inverted lists with block-granular slot
    allocation — the incremental half of the reference's
    OnDiskInvertedLists (OnDiskInvertedLists.h:132-133 allocate_slot /
    free_slot, free-slot list at :46-50): chunked adds append into each
    list's block padding, new blocks come from the free list or the end
    of the file, and nothing else is rewritten — no full regeneration.

    Layout: a data file of fixed-size block records (payload (B, width)
    + ids (B,) int64, ids -1 = free slot) and a JSON sidecar holding the
    per-list block chains, fills, and the free-block list. Unlike the
    searchable packed file (contiguous blocks per list), chains may be
    non-contiguous on disk — the `to_index_file` step (or merge_ondisk
    over this source) lays them out contiguously for the device scan,
    mirroring the reference split between its on-disk allocator and its
    search path.

    Implements the InvlistSource protocol, so it composes with
    HStack/VStack/Masked views and merge_ondisk directly.
    """

    MAGIC = "TODL0001"

    def __init__(self, path: str, *, nlist: int = 0, width: int = 0,
                 dtype: str = "<f4", coded: bool = False,
                 block_size: int = 128, _create: bool = False):
        self.path = path
        self.meta_path = path + ".meta.json"
        if _create:
            self.nlist = int(nlist)
            self.width = int(width)
            self.coded = bool(coded)
            self.dtype = np.dtype(dtype)
            self.block_size = int(block_size)
            self.chains: List[List[int]] = [[] for _ in range(self.nlist)]
            self.fills: List[int] = [0] * self.nlist
            self.free_blocks: List[int] = []
            self.nblocks = 0
            with open(path, "wb"):
                pass
            self.flush()
        else:
            with open(self.meta_path) as f:
                m = json.load(f)
            if m.get("magic") != self.MAGIC:
                raise ValueError(f"{path}: not an OnDiskInvertedLists")
            self.nlist = m["nlist"]
            self.width = m["width"]
            self.coded = m["coded"]
            self.dtype = np.dtype(m["dtype"])
            self.block_size = m["block_size"]
            self.chains = m["chains"]
            self.fills = m["fills"]
            self.free_blocks = m["free_blocks"]
            self.nblocks = m["nblocks"]

    @classmethod
    def create(cls, path: str, nlist: int, width: int, *,
               dtype="float32", coded: bool = False,
               block_size: int = 128) -> "OnDiskInvertedLists":
        return cls(path, nlist=nlist, width=width,
                   dtype=np.dtype(dtype).str, coded=coded,
                   block_size=block_size, _create=True)

    # --- block record layout ---------------------------------------------
    @property
    def _payload_bytes(self) -> int:
        return self.block_size * self.width * self.dtype.itemsize

    @property
    def _block_bytes(self) -> int:
        return self._payload_bytes + self.block_size * 8

    def _read_block(self, b: int):
        with open(self.path, "rb") as f:
            f.seek(b * self._block_bytes)
            buf = f.read(self._block_bytes)
        payload = np.frombuffer(
            buf[: self._payload_bytes], self.dtype
        ).reshape(self.block_size, self.width)
        ids = np.frombuffer(buf[self._payload_bytes:], np.int64)
        return payload, ids

    def _write_block(self, b: int, payload: np.ndarray, ids: np.ndarray):
        with open(self.path, "r+b") as f:
            f.seek(b * self._block_bytes)
            f.write(np.ascontiguousarray(payload, self.dtype).tobytes())
            f.write(np.ascontiguousarray(ids, np.int64).tobytes())

    def _allocate_block(self) -> int:
        """allocate_slot: reuse a freed block, else extend the file."""
        if self.free_blocks:
            return self.free_blocks.pop()
        b = self.nblocks
        self.nblocks += 1
        with open(self.path, "r+b") as f:
            f.truncate(self.nblocks * self._block_bytes)
        # initialize ids of the fresh block to -1 (free slots)
        self._write_block(
            b, np.zeros((self.block_size, self.width), self.dtype),
            np.full(self.block_size, -1, np.int64))
        return b

    # --- mutation ---------------------------------------------------------
    def add_entries(self, list_no: int, payload: np.ndarray,
                    ids: np.ndarray) -> None:
        """Append rows to one list, filling block padding first then
        allocating blocks — only the touched blocks are written."""
        payload = np.asarray(payload)
        ids = np.asarray(ids, np.int64)
        if payload.shape != (len(ids), self.width):
            raise ValueError("payload shape mismatch")
        B = self.block_size
        pos = 0
        while pos < len(ids):
            fill = self.fills[list_no]      # append cursor, not size
            if fill == len(self.chains[list_no]) * B:
                self.chains[list_no].append(self._allocate_block())
            b = self.chains[list_no][fill // B]
            off = fill % B
            take = min(B - off, len(ids) - pos)
            bp, bi = self._read_block(b)
            bp = bp.copy()
            bi = bi.copy()
            bp[off:off + take] = payload[pos:pos + take]
            bi[off:off + take] = ids[pos:pos + take]
            self._write_block(b, bp, bi)
            self.fills[list_no] = fill + take
            pos += take

    def remove_entries(self, list_no: int, sel_ids: np.ndarray) -> int:
        """free_slot: clear matching ids (slots become holes); a block
        whose ids are all cleared returns to the free list."""
        sel = np.asarray(sel_ids, np.int64)
        removed = 0
        chain = self.chains[list_no]
        for ci in reversed(range(len(chain))):
            b = chain[ci]
            bp, bi = self._read_block(b)
            m = np.isin(bi, sel)
            if not m.any():
                continue
            bi = bi.copy()
            bi[m] = -1
            removed += int(m.sum())
            if (bi < 0).all():
                chain.pop(ci)
                self.free_blocks.append(b)
                # append cursor moves to the (block-aligned) chain end;
                # mid-chain holes stay holes until a rewrite
                self.fills[list_no] = len(chain) * self.block_size
            else:
                self._write_block(b, bp, bi)
        return removed

    def flush(self) -> None:
        with open(self.meta_path, "w") as f:
            json.dump({
                "magic": self.MAGIC, "nlist": self.nlist,
                "width": self.width, "coded": self.coded,
                "dtype": self.dtype.str, "block_size": self.block_size,
                "chains": self.chains, "fills": self.fills,
                "free_blocks": self.free_blocks, "nblocks": self.nblocks,
            }, f)

    # --- InvlistSource protocol ------------------------------------------
    def list_size(self, i):
        # fills count appended rows; removals leave -1 holes inside
        sz = 0
        for b in self.chains[i]:
            _, bi = self._read_block(b)
            sz += int((bi >= 0).sum())
        return sz

    def get_list(self, i):
        pays, idss = [], []
        for b in self.chains[i]:
            bp, bi = self._read_block(b)
            keep = bi >= 0
            pays.append(bp[keep])
            idss.append(bi[keep])
        if not pays:
            return (np.zeros((0, self.width), self.dtype),
                    np.zeros(0, np.int64))
        return np.concatenate(pays), np.concatenate(idss)


# ---------------------------------------------------------------------------
# streaming container writer
# ---------------------------------------------------------------------------

class _Streamed:
    """A container array whose bytes are produced by a chunk generator."""

    def __init__(self, dtype, shape, gen):
        self.dtype = np.dtype(dtype)
        self.shape = tuple(int(s) for s in shape)
        self.gen = gen  # callable -> iterator of np arrays (flattened ok)

    @property
    def nbytes(self):
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize


def _write_container_streamed(path: str, meta, arrays) -> None:
    """index_io's container writer, whose values may be _Streamed."""
    iio._write_container(path, meta, arrays)


# ---------------------------------------------------------------------------
# on-disk merge
# ---------------------------------------------------------------------------

def merge_ondisk(index, sources, dst_path: str,
                 block_size: int = None) -> int:
    """Stream-merge inverted lists into a standard index file.

    `index`: a TRAINED IndexIVF* of the target type (its quantizer and
    codec parameters are serialized as-is; its own invlists are ignored —
    pass an empty trained index, like contrib/ondisk.py merge_ondisk).
    `sources`: one InvlistSource, or a list (HStack-merged).
    Returns ntotal of the merged file.

    The merged file is loadable with read_index(dst_path, mmap=True) —
    the OnDiskInvertedLists::merge_from_multiple + IO_FLAG_MMAP workflow
    without the host ever holding more than one list.
    """
    if isinstance(sources, (list, tuple)):
        src = sources[0] if len(sources) == 1 else HStackInvlists(sources)
    else:
        src = sources
    src = _OneListCache(src)   # data/norms/xb streams re-read each list
    B = int(block_size or getattr(index, "block_size", 128))
    nlist = src.nlist
    if nlist != index.nlist:
        raise ValueError("source nlist != index nlist")

    sizes = np.array([src.list_size(i) for i in range(nlist)], np.int64)
    nblk = -(-sizes // B)
    starts = np.zeros(nlist, np.int64)
    np.cumsum(nblk[:-1], out=starts[1:])
    nb_total = int(nblk.sum())
    n = int(sizes.sum())
    empty_starts = starts.copy()
    empty_starts[nblk == 0] = nb_total
    row0 = np.zeros(nlist + 1, np.int64)
    np.cumsum(sizes, out=row0[1:])

    coded = src.coded
    w = src.width

    # codedness contract: the written payload must match what the
    # destination type's scans expect. A coded destination (overridden
    # _pack) needs coded sources with the SAME codec (e.g.
    # FileInvlistSource over shards of that index type); a raw
    # destination needs raw sources.
    from ..models.ivf import IndexIVF

    dst_coded = type(index)._pack is not IndexIVF._pack
    if dst_coded != coded:
        raise ValueError(
            f"merge_ondisk: destination {type(index).__name__} expects "
            f"{'coded' if dst_coded else 'raw'} invlist payloads but the "
            f"source yields {'coded' if coded else 'raw'} ones; merge "
            "matching shard files, or add raw data via add_preassigned")

    # meta from the index's own dumper (quantizer + codec params),
    # with the invlist fields overridden
    meta, arrays = iio.dump_index(index)
    for k in [a for a in arrays if a.startswith(("il_", "xb_host",
                                                 "ids_host", "assign_host"))]:
        del arrays[k]
    meta["il_from_host"] = False      # the merged lists are written packed
    meta["ntotal"] = n
    meta["has_invlists"] = True
    meta["il_coded"] = coded
    meta["max_nblocks"] = max(int(nblk.max(initial=0)), 1)
    meta["block_size"] = B

    def pad_rows(a, rows, fill=0):
        out = np.full((rows, a.shape[1]), fill, a.dtype)
        out[:len(a)] = a
        return out

    def gen_data():
        for l in range(nlist):
            if nblk[l] == 0:
                continue
            p, _ = src.get_list(l)
            yield pad_rows(p, int(nblk[l]) * B)
        yield np.zeros((B, w), np.uint8 if coded else np.float32)  # dummy

    def gen_rowids():
        for l in range(nlist):
            if nblk[l] == 0:
                continue
            out = np.full(int(nblk[l]) * B, -1, np.int32)
            out[:sizes[l]] = np.arange(row0[l], row0[l + 1], dtype=np.int32)
            yield out
        yield np.full(B, -1, np.int32)

    def gen_norms():
        for l in range(nlist):
            if nblk[l] == 0:
                continue
            p, _ = src.get_list(l)
            nr = (p.astype(np.float64) ** 2).sum(-1).astype(np.float32)
            out = np.zeros(int(nblk[l]) * B, np.float32)
            out[:sizes[l]] = nr
            yield out
        yield np.zeros(B, np.float32)

    def gen_xb():
        for l in range(nlist):
            if sizes[l]:
                yield src.get_list(l)[0]

    def gen_ids():
        for l in range(nlist):
            if sizes[l]:
                yield src.get_list(l)[1]

    dt = np.uint8 if coded else np.float32
    arrays["il_data"] = _Streamed(dt, (nb_total + 1, B, w), gen_data)
    arrays["il_ids"] = _Streamed(np.int32, (nb_total + 1, B), gen_rowids)
    if not coded:
        arrays["il_norms"] = _Streamed(np.float32, (nb_total + 1, B),
                                       gen_norms)
        # raw sources keep the host store so the loaded index supports
        # add/remove/reconstruct; coded merges are search-only (the
        # reference's merged OnDisk indexes are likewise effectively
        # read-only once mmapped)
        arrays["xb_host"] = _Streamed(np.float32, (n, w), gen_xb)
    arrays["il_start"] = empty_starts.astype(np.int32)
    arrays["il_nblocks"] = nblk.astype(np.int32)
    arrays["ids_host"] = _Streamed(np.int64, (n,), gen_ids)

    if n > 2**31 - 1:
        raise ValueError("merged row count exceeds int32 packed-slot range")
    _write_container_streamed(dst_path, meta, arrays)
    return n
