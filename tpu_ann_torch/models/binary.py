"""Binary (Hamming-space) indexes — PyTorch counterpart of
`tpu_ann/models/binary.py` (faiss `IndexBinary`, `IndexBinaryFlat`,
`IndexBinaryIVF`, `IndexBinaryFromFloat`, `IndexBinaryHNSW`,
`IndexBinaryHash`, `IndexBinaryMultiHash`).

``d`` counts bits (a multiple of 8); codes are (n, d / 8) uint8 rows,
least significant bit first, held on the index's device. Distances are
int32 Hamming distances; an empty result slot holds (32767, -1), the
reference's sentinel. The public methods take and return numpy arrays.

Every route computes the same integers: the flat scan by one product of
the 0/1 bits (`ops.hamming.knn_hamming`), the IVF lists and the hash
buckets by the popcount of the XOR of each query with its own rows
(`ops.hamming.hamming_rows`). Where distances tie, results are ordered by
distance, then by scan order (the list's blocks in probe order; a hash
table's candidates by bucket, a multi-hash's by id), stably: the
reference orders its buckets' ties with a non-stable ``argsort``.

- IndexBinaryIVF trains float k-means (`ops.kmeans`) on the unpacked bits
  and binarizes the centroids by majority (``cent > 0.5``, reference
  :172-181); its lists are 64-row blocks of codes (`pack_code_invlists`),
  scanned by the query-major driver `ops.ivf_scan._scan_compacted` with a
  Hamming score. A search always returns (nq, k), padded where the probed
  lists hold fewer than k codes (the reference returns fewer columns).
- IndexBinaryFromFloat and IndexBinaryHNSW search a float index over the
  unpacked 0/1 rows, whose L2 distance is the Hamming distance exactly
  (IndexBinaryHNSW: an IndexHNSWSQ of bf16 rows, exact on 0/1).
- IndexBinaryHash / IndexBinaryMultiHash keep each table as the row ids
  sorted by bucket key; a search looks up every key within ``nflip`` bit
  flips with ``searchsorted``, so the candidates are the reference's
  dict buckets, gathered on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..ops import hamming as H
from ..ops import ivf_scan
from ..ops.kmeans import ClusteringParameters, kmeans
from ..ops.range_search import csr_from_hits
from ..ops.topk import chunk_starts
from .base import SearchStats, Timer

# the distance of an empty result slot (the reference's sentinel)
EMPTY = 32767
# candidates (query, row) gathered at once by the hash searches
CAND_BUDGET = 1 << 24


def _hash_flips(b: int, nflip: int) -> List[int]:
    """The XOR masks of the bucket keys within ``nflip`` bit flips of a
    b-bit key, in the reference's order (`_hash_flips`, :26-35): the key,
    then each single flip, then each pair i < j."""
    out = [0]
    if nflip >= 1:
        out += [1 << i for i in range(b)]
    if nflip >= 2:
        out += [(1 << i) | (1 << j) for i in range(b)
                for j in range(i + 1, b)]
    return out


def _check_codes(x, d: int) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.ascontiguousarray(x, np.uint8)
    if not x.flags.writeable:         # e.g. a view of a jax array
        x = x.copy()
    if x.ndim == 1:
        x = x[None]
    if x.shape[1] != d // 8:
        raise ValueError(f"expected {d // 8} code bytes, got {x.shape[1]}")
    return x


def _empty_result(nq: int, k: int):
    return (np.full((nq, k), EMPTY, np.int32),
            np.full((nq, k), -1, np.int64))


def _rank(q: torch.Tensor, ids: torch.Tensor, dis: torch.Tensor, nq: int,
          k: int):
    """(D (nq, k) int32, I (nq, k) int64) of candidate triples (query,
    id, distance) in scan order: each query's k smallest distances, ties
    in scan order (two stable sorts)."""
    dev = dis.device
    Dv = torch.full((nq, k), EMPTY, dtype=torch.int32, device=dev)
    Iv = torch.full((nq, k), -1, dtype=torch.long, device=dev)
    if dis.numel() == 0:
        return Dv, Iv
    o1 = torch.argsort(dis, stable=True)
    perm = o1[torch.argsort(q[o1], stable=True)]
    qs = q[perm]
    cnt = torch.bincount(qs, minlength=nq)
    first = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(len(qs), device=dev) - first[qs]
    keep = rank < k
    Dv[qs[keep], rank[keep]] = dis[perm][keep]
    Iv[qs[keep], rank[keep]] = ids[perm][keep]
    return Dv, Iv


class IndexBinary:
    """Base (faiss IndexBinary: d bits, code_size = d / 8, int32
    distances), on one device (``device="cuda"`` by default)."""

    def __init__(self, d: int, *, device="cuda"):
        if d % 8:
            raise ValueError("binary d must be a multiple of 8")
        self.d = int(d)
        self.code_size = d // 8
        self.ntotal = 0
        self.is_trained = True
        self.verbose = False
        self.device = torch.device(device)

    def train(self, x) -> None:
        pass

    def add(self, x) -> None:
        raise NotImplementedError

    def search(self, x, k: int):
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def _codes_dev(self, x) -> torch.Tensor:
        """(n, d / 8) uint8 code rows on the device."""
        return torch.from_numpy(_check_codes(x, self.d)).to(self.device)


class IndexBinaryFlat(IndexBinary):
    """Exhaustive Hamming search (faiss IndexBinaryFlat): `knn_hamming` in
    query chunks of ``search_chunk``."""

    search_chunk = 16384

    def __init__(self, d: int, *, device="cuda"):
        super().__init__(d, device=device)
        self._codes = torch.zeros((0, self.code_size), dtype=torch.uint8,
                                  device=self.device)

    @property
    def codes(self) -> torch.Tensor:
        """The stored (ntotal, d / 8) uint8 codes on the device."""
        return self._codes

    def add(self, x) -> None:
        self._codes = torch.cat([self._codes, self._codes_dev(x)])
        self.ntotal = self._codes.shape[0]

    def search_device(self, xq: torch.Tensor, k: int):
        """Device-in / device-out search of (nq, d / 8) uint8 codes: (D
        int32, I int64) tensors."""
        outs = [H.knn_hamming(xq[i:i + self.search_chunk], self._codes, k)
                for i in chunk_starts(xq.shape[0], self.search_chunk)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def search(self, x, k: int):
        x = _check_codes(x, self.d)
        if self.ntotal == 0:
            return _empty_result(len(x), k)
        Dv, Iv = self.search_device(self._codes_dev(x), k)
        return Dv.cpu().numpy(), Iv.cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        return self._codes[key].cpu().numpy()

    def range_search(self, x, radius: int):
        """All codes at Hamming distance < radius (IndexBinaryFlat::
        range_search, utils/hamming.cpp:307 keeps ``dis < radius``):
        (lims, D int32, I int64), each query's hits in id order."""
        x = _check_codes(x, self.d)
        nq = len(x)
        hits = ([], [], [])
        xq = self._codes_dev(x)
        for q0 in range(0, nq, 1024):
            for b0 in range(0, self.ntotal, H.DB_BLOCK):
                dis = H.hamming_distances(xq[q0:q0 + 1024],
                                          self._codes[b0:b0 + H.DB_BLOCK])
                qi, bi = torch.nonzero(dis < radius, as_tuple=True)
                hits[0].append(qi + q0)
                hits[1].append(dis[qi, bi])
                hits[2].append(bi + b0)
        res = csr_from_hits(nq, *hits)
        return res.lims, res.distances.astype(np.int32), res.labels

    def remove_ids(self, sel) -> int:
        """Remove the matching codes; the survivors are renumbered in order
        (IndexBinaryFlat::remove_ids). ``sel`` is an IDSelector or an array
        of positions."""
        if self.ntotal == 0:
            return 0
        if hasattr(sel, "make_bitmap"):
            keep = sel.make_bitmap(self.ntotal) == 0
        else:
            keep = np.ones(self.ntotal, bool)
            keep[np.asarray(sel, np.int64)] = False
        self._codes = self._codes[torch.from_numpy(keep).to(self.device)]
        removed = self.ntotal - self._codes.shape[0]
        self.ntotal = self._codes.shape[0]
        return removed

    def reset(self) -> None:
        self._codes = self._codes[:0]
        self.ntotal = 0


class IndexBinaryIVF(IndexBinary):
    """IVF in Hamming space (faiss IndexBinaryIVF). The quantizer is an
    IndexBinaryFlat (default) or an IndexBinaryHNSW over the nlist binary
    centroids."""

    block_size = 64

    def __init__(self, quantizer: Optional[IndexBinary], d: int,
                 nlist: int, *, device="cuda"):
        super().__init__(d, device=device)
        self.quantizer = quantizer or IndexBinaryFlat(d, device=device)
        if self.quantizer.device != self.device:
            raise ValueError("quantizer must live on the index's device")
        self.nlist = int(nlist)
        self.nprobe = 1
        self.is_trained = False
        self.cp = ClusteringParameters(niter=10)
        self._codes_host: List[np.ndarray] = []
        self._ids_host: List[np.ndarray] = []
        self._dirty = False
        self.invlists: Optional[ivf_scan.PackedCodeInvLists] = None

    def train(self, x) -> None:
        """Float k-means on the unpacked bits, the centroids binarized by
        majority (IndexBinaryIVF::train over binary_to_real rows)."""
        xf = H.unpack_bits(self._codes_dev(x)).cpu().numpy()
        cent, _ = kmeans(xf, self.nlist, self.cp, device=self.device)
        cent01 = torch.from_numpy(cent > 0.5).to(self.device)
        self.quantizer.reset()
        self.quantizer.add(H.pack_bits(cent01).cpu().numpy())
        self.is_trained = True

    def add(self, x) -> None:
        """Appends to the host store; the lists are packed again at the
        next search (one O(ntotal) repack for many adds)."""
        if not self.is_trained:
            raise RuntimeError("train() before add()")
        x = _check_codes(x, self.d)
        self._codes_host.append(x)
        self._ids_host.append(np.arange(self.ntotal, self.ntotal + len(x),
                                        dtype=np.int64))
        self.ntotal += len(x)
        self._dirty = True

    def _ready(self) -> None:
        if self._dirty:
            self._repack()
        if self.invlists is None:
            if not self.is_trained:
                raise RuntimeError("empty index")
            self._repack()          # trained, no rows: the empty stream

    def _repack(self) -> None:
        self._dirty = False
        codes = np.concatenate(self._codes_host) if self._codes_host \
            else np.zeros((0, self.code_size), np.uint8)
        ids = np.concatenate(self._ids_host) if self._ids_host \
            else np.zeros(0, np.int64)
        _, a = self.quantizer.search_device(
            torch.from_numpy(codes).to(self.device), 1)
        il = ivf_scan.pack_code_invlists(
            codes, ids, a[:, 0].cpu().numpy(), self.nlist,
            block_size=self.block_size, device=self.device)
        self.invlists = il
        self._max_nb = il.max_nblocks_per_list
        # the lists the scans read: one more, empty (the dummy block), that
        # a -1 probe reads (an HNSW quantizer that found fewer lists), as
        # the reference's guard (:227-231)
        self._scan_lists = dataclasses.replace(
            il, list_block_start=torch.cat([
                il.list_block_start, il.list_block_start.new_tensor(
                    [il.nblocks])]),
            list_nblocks=torch.cat([il.list_nblocks,
                                    il.list_nblocks.new_zeros(1)]))

    def _probes(self, xq: torch.Tensor) -> torch.Tensor:
        """(nq, nprobe) probed lists, a -1 (no list) as the empty list
        nlist of ``_scan_lists``."""
        _, probes = self.quantizer.search_device(
            xq, min(self.nprobe, self.nlist))
        return torch.where(probes >= 0, probes, self.nlist)

    def search_device(self, xq: torch.Tensor, k: int, probes=None):
        """The probed lists' codes scanned query by query (the
        BinaryInvertedListScanner role): (D int32, I int64, ndis). An
        empty slot is (32767, -1)."""
        il = self._scan_lists
        if probes is None:
            probes = self._probes(xq)

        def score(q, bids):
            codes = il.codes[bids]                     # (qt, cb, B, bytes)
            q8 = q.to(torch.uint8)[:, None, None, :]
            return H.hamming_rows(q8, codes).float(), il.ids[bids]

        Dv, Iv, ndis = ivf_scan._scan_compacted(
            xq.float(), probes, il, score, k, False,
            max_nblocks=self._max_nb, chunk_blocks=8)
        full = torch.isfinite(Dv)
        return (torch.where(full, Dv, EMPTY).to(torch.int32),
                torch.where(full, Iv.long(), -1), ndis)

    def search(self, x, k: int):
        x = _check_codes(x, self.d)
        self._ready()
        Dv, Iv, _ = self.search_device(self._codes_dev(x), k)
        return Dv.cpu().numpy(), Iv.cpu().numpy()

    def range_search(self, x, radius: int):
        """Hits at Hamming distance < radius in the probed lists
        (IndexBinaryIVF::range_search), each query's hits in scan order."""
        x = _check_codes(x, self.d)
        self._ready()
        il = self._scan_lists
        xq = self._codes_dev(x)
        nq = len(x)
        buffer, total = ivf_scan._compact_block_table(
            self._probes(xq), il.list_block_start, il.list_nblocks,
            self._max_nb, il.nblocks)
        hits = ([], [], [])
        qt, cb = 1024, 64
        for q0 in range(0, nq, qt):
            blk = buffer[q0:q0 + qt]
            for c0 in range(0, int(total[q0:q0 + qt].max()), cb):
                bids = blk[:, c0:c0 + cb]
                dis = H.hamming_rows(xq[q0:q0 + qt, None, None, :],
                                     il.codes[bids])
                vids = il.ids[bids]
                qi, ci, li = torch.nonzero((dis < radius) & (vids >= 0),
                                           as_tuple=True)
                hits[0].append(qi + q0)
                hits[1].append(dis[qi, ci, li])
                hits[2].append(vids[qi, ci, li].long())
        res = csr_from_hits(nq, *hits)
        return res.lims, res.distances.astype(np.int32), res.labels

    def reset(self) -> None:
        self._codes_host, self._ids_host = [], []
        self.invlists = None
        self.ntotal = 0
        self._dirty = False


class IndexBinaryFromFloat(IndexBinary):
    """A float index over the unpacked 0/1 rows (faiss
    IndexBinaryFromFloat): its L2 distances are the Hamming distances,
    rounded to int32 as the reference does (:303-308)."""

    def __init__(self, float_index):
        super().__init__(float_index.d, device=float_index.device)
        self.index = float_index
        self.is_trained = float_index.is_trained

    def _rows(self, x) -> torch.Tensor:
        return H.unpack_bits(self._codes_dev(x))

    def train(self, x) -> None:
        self.index.train(self._rows(x))
        self.is_trained = True

    def add(self, x) -> None:
        self.index.add(self._rows(x))
        self.ntotal = self.index.ntotal

    def search(self, x, k: int):
        Dv, Iv = self.index.search(self._rows(x), k)
        return np.round(Dv).astype(np.int32), Iv

    def reset(self) -> None:
        self.index.reset()
        self.ntotal = 0


class IndexBinaryHNSW(IndexBinary):
    """HNSW in Hamming space (faiss IndexBinaryHNSW): an IndexHNSWSQ of
    bf16 rows over the unpacked 0/1 rows (exact in bf16; from its
    tile_threshold on, its fused tiles run K3 on d-wide rows). The packed
    codes are kept in one device array for reconstruction."""

    def __init__(self, d: int, M: int = 16, *, device="cuda"):
        super().__init__(d, device=device)
        from .hnsw import IndexHNSWSQ

        self._codes = torch.zeros((0, self.code_size), dtype=torch.uint8,
                                  device=self.device)
        self.index = IndexHNSWSQ(d, "bfloat16", M, device=device)

    @property
    def hnsw(self):
        return self.index.hnsw

    def add(self, x) -> None:
        codes = self._codes_dev(x)
        self._codes = torch.cat([self._codes, codes])
        self.index.add(H.unpack_bits(codes))
        self.ntotal = self.index.ntotal

    def search_device(self, xq: torch.Tensor, k: int, params=None):
        Dv, Iv = self.index.search_device(H.unpack_bits(xq), k,
                                          params=params)
        return torch.round(Dv).to(torch.int32), Iv.long()

    def search(self, x, k: int, *, params=None):
        Dv, Iv = self.index.search(H.unpack_bits(self._codes_dev(x)), k,
                                   params=params)
        return np.round(Dv).astype(np.int32), Iv

    def reconstruct(self, key: int) -> np.ndarray:
        return self._codes[key].cpu().numpy()

    def reset(self) -> None:
        self.index.reset()
        self._codes = self._codes[:0]
        self.ntotal = 0


class _BucketTables(IndexBinary):
    """Hash tables of codes on the device, shared by IndexBinaryHash and
    IndexBinaryMultiHash: table h keys each row by the b bits starting
    at bit ``h * b`` (little-endian, the reference's ``_hash``), and holds
    its row ids sorted by key, ties in id order (a dict bucket's order)."""

    def __init__(self, d: int, nhash: int, b: int, *, device="cuda"):
        super().__init__(d, device=device)
        if b > 24:
            raise ValueError("hash prefix b too large (max 24)")
        if nhash * b > d:
            raise ValueError("nhash * b must be <= d")
        self.nhash = int(nhash)
        self.b = int(b)
        self.nflip = 1
        self._codes = torch.zeros((0, self.code_size), dtype=torch.uint8,
                                  device=self.device)
        self._tables = None       # (sorted keys (nhash, n), ids (nhash, n))

    def _keys(self, codes: torch.Tensor) -> torch.Tensor:
        """(n, nhash) int64 bucket keys of (n, d / 8) codes."""
        nb = self.nhash * self.b
        bits = H.unpack_bits(codes[:, :-(-nb // 8)])[:, :nb].long()
        w = 1 << torch.arange(self.b, device=codes.device)
        return (bits.reshape(-1, self.nhash, self.b) * w).sum(2)

    def _add_codes(self, x) -> None:
        self._codes = torch.cat([self._codes, self._codes_dev(x)])
        self.ntotal = self._codes.shape[0]
        self._tables = None

    def _ensure_tables(self):
        if self._tables is None:
            keys = self._keys(self._codes).T.contiguous()  # (nhash, n)
            sk, order = torch.sort(keys, dim=1, stable=True)
            self._tables = (sk, order)
        return self._tables

    def hashtable_size(self) -> int:
        """The non-empty buckets of all the tables."""
        sk, _ = self._ensure_tables()
        if sk.shape[1] == 0:
            return 0
        return int((sk[:, 1:] != sk[:, :-1]).sum()) + self.nhash

    def _candidates(self, xq: torch.Tensor):
        """Yields (q0, q1, q, ids, dis) over chunks [q0, q1) of queries:
        every (query, row) the probed buckets hold (the keys within nflip
        flips of each of the query's keys), in table, flip and bucket
        order; ``q`` counts from q0."""
        sk, order = self._ensure_tables()
        dev = self.device
        n = sk.shape[1]
        flips = torch.tensor(_hash_flips(self.b, self.nflip),
                             dtype=torch.long, device=dev)
        keys = self._keys(xq)[:, :, None] ^ flips     # (nq, nhash, F)
        keys = [keys[:, h].contiguous() for h in range(self.nhash)]
        lo = torch.stack([torch.searchsorted(sk[h], keys[h])
                          for h in range(self.nhash)], 1)
        hi = torch.stack([torch.searchsorted(sk[h], keys[h], right=True)
                          for h in range(self.nhash)], 1)
        base = (torch.arange(self.nhash, device=dev) * n)[None, :, None]
        lo = (lo + base).flatten(1)
        cnt = (hi + base).flatten(1) - lo
        per_q = cnt.sum(1).cpu().numpy()
        flat_order = order.reshape(-1)
        q0 = 0
        while q0 < len(xq):
            q1 = q0 + 1
            run = per_q[q0]
            while q1 < len(xq) and run + per_q[q1] <= CAND_BUDGET:
                run += per_q[q1]
                q1 += 1
            c = cnt[q0:q1].reshape(-1)
            pair = torch.repeat_interleave(
                torch.arange(c.numel(), device=dev), c)
            start = torch.cumsum(c, 0) - c
            pos = lo[q0:q1].reshape(-1)[pair] + \
                torch.arange(pair.numel(), device=dev) - start[pair]
            q = pair // lo.shape[1]
            ids = flat_order[pos]
            q, ids = self._dedupe(q, ids)
            dis = H.hamming_rows(xq[q0:q1][q], self._codes[ids])
            yield q0, q1, q, ids, dis
            q0 = q1

    def _dedupe(self, q, ids):
        return q, ids

    def search_stats(self, x, k: int):
        """search + SearchStats: ``ndis`` is the candidates scored."""
        x = _check_codes(x, self.d)
        nq = len(x)
        with Timer(self.device) as t:
            if self.ntotal == 0 or nq == 0:
                Dv, Iv = _empty_result(nq, k)
                ndis = 0
            else:
                parts, ndis = [], 0
                for q0, q1, q, ids, dis in self._candidates(
                        self._codes_dev(x)):
                    parts.append(_rank(q, ids, dis, q1 - q0, k))
                    ndis += dis.numel()
                Dv = torch.cat([p[0] for p in parts]).cpu().numpy()
                Iv = torch.cat([p[1] for p in parts]).cpu().numpy()
        return Dv, Iv, SearchStats(nq=nq, total_us=t.us, list_scan_us=t.us,
                                   ndis=ndis)

    def search(self, x, k: int):
        Dv, Iv, _ = self.search_stats(x, k)
        return Dv, Iv

    def range_search(self, x, radius: int):
        """Hits at Hamming distance < radius among the candidates
        (IndexBinaryHash::range_search, IndexBinaryHash.cpp:204), each
        query's hits in candidate order."""
        x = _check_codes(x, self.d)
        nq = len(x)
        hits = ([], [], [])
        if self.ntotal:
            for q0, _, q, ids, dis in self._candidates(self._codes_dev(x)):
                m = dis < radius
                hits[0].append(q[m] + q0)
                hits[1].append(dis[m])
                hits[2].append(ids[m])
        res = csr_from_hits(nq, *hits)
        return res.lims, res.distances.astype(np.int32), res.labels

    def reset(self) -> None:
        self._codes = self._codes[:0]
        self._tables = None
        self.ntotal = 0


class IndexBinaryHash(_BucketTables):
    """Prefix-hash buckets (faiss IndexBinaryHash): rows bucketed by their
    first b bits; a search takes the buckets within ``nflip`` bit flips of
    the query's prefix and ranks their rows by Hamming distance."""

    def __init__(self, d: int, b: int, *, device="cuda"):
        super().__init__(d, 1, b, device=device)

    def add(self, x) -> None:
        self._add_codes(x)


class IndexBinaryMultiHash(_BucketTables):
    """nhash hash tables over consecutive b-bit slices of the code (faiss
    IndexBinaryMultiHash, IndexBinaryHash.h:83-123): a search takes the
    union of every table's candidates within ``nflip`` flips (each row
    once, in id order) and ranks them against the flat ``storage``."""

    def __init__(self, d: int, nhash: int, b: int, *, device="cuda"):
        super().__init__(d, nhash, b, device=device)
        self.storage = IndexBinaryFlat(d, device=device)

    def add(self, x) -> None:
        self.storage.add(x)
        self._codes = self.storage.codes
        self.ntotal = self.storage.ntotal
        self._tables = None

    def _dedupe(self, q, ids):
        u = torch.unique(q * max(self.ntotal, 1) + ids)
        return u // max(self.ntotal, 1), u % max(self.ntotal, 1)

    def reset(self) -> None:
        super().reset()
        self.storage.reset()
