"""Zn-sphere lattice codec — the port's copy of `tpu_ann/ops/lattice.py`
(faiss `impl/lattice_Zn.{h,cpp}`), host numpy as the reference.

A direction vector is quantized to the nearest point of the integer lattice
Z^dim on the sphere ||c||^2 = r2 and coded enumeratively in
ceil(log2(nv)) bits, nv the number of lattice points on the sphere:
  * "atoms" are the non-increasing non-negative representatives of sphere
    points; the best atom by dot product with the sorted |x| is the exact
    nearest sphere point (ZnSphereSearch::search);
  * a point factors as (atom, permutation of its entries, signs of its
    non-zeros): code = offset[atom] + perm_rank * 2^nnz + sign bits, the
    permutation ranked lexicographically among its multiset's.

The reference ranks and unranks one row at a time with Python integers.
Here, wherever nv * dim fits int64, encode and decode run over all rows at
once: the multinomial count of the remaining slots is carried per row and
updated by exact integer division (multinomial(rem - 1; counts - e_v) =
multinomial(rem; counts) * counts_v / rem), which gives the reference's
codes byte for byte; above that bound the reference's row loops run.
`ZnSphereCodecRec` (the recursive codec of power-of-2 dims) and
`ZnSphereCodecAlt` are copied as they are.
"""

from __future__ import annotations

from math import comb, isqrt
from typing import Dict, List, Tuple

import numpy as np


def sphere_atoms(dim: int, r2: int) -> np.ndarray:
    """All non-increasing sequences of non-negative ints with
    sum(x^2) == r2 (the sphere's canonical representatives)."""
    out: List[Tuple[int, ...]] = []

    def rec(prefix, remaining, maxv, slots):
        if remaining == 0:
            out.append(tuple(prefix + [0] * slots))
            return
        if slots == 0:
            return
        v = min(int(np.sqrt(remaining)), maxv)
        for val in range(v, 0, -1):
            rec(prefix + [val], remaining - val * val, val, slots - 1)

    rec([], r2, int(np.sqrt(r2)), dim)
    if not out:
        raise ValueError(f"no Z^{dim} points with squared norm {r2}")
    return np.array(out, np.int64)


def _perm_count(atom: np.ndarray) -> int:
    """Number of distinct permutations of the multiset ``atom``."""
    total = 1
    remaining = len(atom)
    for v in np.unique(atom):
        c = int((atom == v).sum())
        total *= comb(remaining, c)
        remaining -= c
    return total


_PERM_CACHE: Dict[Tuple[Tuple[int, ...], int], int] = {}


def _perms_of_counts(counts: np.ndarray, slots: int) -> int:
    """Distinct arrangements of the multiset ``counts`` into ``slots``
    positions (sum(counts) == slots)."""
    key = (tuple(int(c) for c in counts), slots)
    v = _PERM_CACHE.get(key)
    if v is not None:
        return v
    total = 1
    rem = slots
    for c in counts:
        if c:
            total *= comb(rem, int(c))
            rem -= int(c)
    _PERM_CACHE[key] = total
    return total


class ZnSphereCodec:
    """ZnSphereSearch and the enumerative codec (lattice_Zn.h:25-137)."""

    def __init__(self, dim: int, r2: int):
        self.dim = int(dim)
        self.r2 = int(r2)
        self.atoms = sphere_atoms(dim, r2)                  # (na, dim)
        self.natom = len(self.atoms)
        self.nnz = (self.atoms > 0).sum(1).astype(np.int64)
        self.perms = np.array([_perm_count(a) for a in self.atoms],
                              np.object_)
        sizes = [int(p) << int(z) for p, z in zip(self.perms, self.nnz)]
        self.offsets = np.zeros(self.natom + 1, np.object_)
        for i, s in enumerate(sizes):
            self.offsets[i + 1] = self.offsets[i] + s
        self.nv = int(self.offsets[-1])
        self.nbits = max(int(self.nv - 1).bit_length(), 1)
        self._atoms_f = self.atoms.astype(np.float32)
        self._vmax = isqrt(self.r2) + 1
        # the vectorized route: every count and code fits int64
        self._vec = self.nv * max(self.dim, 2) < (1 << 62) and \
            self._vmax ** self.dim < (1 << 62)
        if self._vec:
            self._perms64 = self.perms.astype(np.int64)
            self._offs64 = self.offsets.astype(np.int64)
            keys = self._keys(self.atoms)
            self._key_order = np.argsort(keys)
            self._keys_sorted = keys[self._key_order]

    # --- nearest sphere point (ZnSphereSearch::search) -------------------
    def search(self, x: np.ndarray) -> np.ndarray:
        """(n, dim) float -> (n, dim) int lattice points on the sphere,
        nearest in L2 (equivalently the largest dot product)."""
        x = np.asarray(x, np.float32)
        ax = np.abs(x)
        order = np.argsort(-ax, axis=1, kind="stable")
        xs = np.take_along_axis(ax, order, axis=1)          # sorted desc
        best = np.argmax(xs @ self._atoms_f.T, axis=1)
        c_sorted = self.atoms[best]
        c = np.zeros_like(c_sorted)
        np.put_along_axis(c, order, c_sorted, axis=1)
        sign = np.where(x < 0, -1, 1).astype(np.int64)
        return c * sign

    # --- the vectorized (int64) ranking ----------------------------------
    def _keys(self, smag: np.ndarray) -> np.ndarray:
        """Rows of values < vmax -> int64 keys (base vmax digits)."""
        key = np.zeros(len(smag), np.int64)
        for i in range(self.dim):
            key = key * self._vmax + smag[:, i]
        return key

    def _counts(self, mag: np.ndarray) -> np.ndarray:
        return np.stack([(mag == v).sum(1) for v in range(self._vmax)],
                        1).astype(np.int64)

    def _encode_vec(self, c: np.ndarray) -> np.ndarray:
        n, dim = c.shape
        mag = np.abs(c)
        smag = -np.sort(-mag, axis=1)
        keys = self._keys(smag)
        pos = np.searchsorted(self._keys_sorted, keys)
        pos = np.minimum(pos, len(self._keys_sorted) - 1)
        if not np.array_equal(self._keys_sorted[pos], keys):
            raise ValueError("not a sphere point at this radius")
        atom_id = self._key_order[pos]
        rows = np.arange(n)
        counts = self._counts(mag)
        mult = self._perms64[atom_id].copy()
        rank = np.zeros(n, np.int64)
        for p in range(dim):
            rem = dim - p
            cur = mag[:, p]
            for v in range(self._vmax):
                take = (counts[:, v] > 0) & (v < cur)
                rank += np.where(take, mult * counts[:, v] // rem, 0)
            mult = mult * counts[rows, cur] // rem
            counts[rows, cur] -= 1
        nzidx = np.cumsum(mag > 0, axis=1) - 1
        bits = np.where(c < 0, np.left_shift(1, np.maximum(nzidx, 0)),
                        0).sum(1)
        return (self._offs64[atom_id] + (rank << self.nnz[atom_id])
                + bits).astype(np.uint64)

    def _decode_vec(self, codes: np.ndarray) -> np.ndarray:
        codes = codes.astype(np.int64)
        n = len(codes)
        atom_id = np.searchsorted(self._offs64[1:], codes, side="right")
        res = codes - self._offs64[atom_id]
        nnz = self.nnz[atom_id]
        signs = res & ((np.int64(1) << nnz) - 1)
        pr = res >> nnz
        counts = self._counts(self.atoms[atom_id])
        mult = self._perms64[atom_id].copy()
        rows = np.arange(n)
        out = np.zeros((n, self.dim), np.int64)
        for p in range(self.dim):
            rem = self.dim - p
            done = np.zeros(n, bool)
            for v in range(self._vmax):
                active = ~done & (counts[:, v] > 0)
                block = mult * counts[:, v] // rem
                pick = active & (pr < block)
                out[pick, p] = v
                done |= pick
                pr = np.where(active & ~pick, pr - block, pr)
            cur = out[:, p]
            mult = mult * counts[rows, cur] // rem
            counts[rows, cur] -= 1
        nzidx = np.cumsum(out > 0, axis=1) - 1
        neg = (out > 0) & (((signs[:, None] >> np.maximum(nzidx, 0)) & 1)
                           == 1)
        return np.where(neg, -out, out)

    # --- the reference's row loops (codes beyond int64) ------------------
    def _rank_perm(self, mag: np.ndarray) -> np.ndarray:
        n, dim = mag.shape
        rank = np.array([0] * n, np.object_)
        vmax = self._vmax
        counts = self._counts(mag)
        for pos in range(dim):
            rem = dim - pos
            cur = mag[:, pos]
            for v in range(vmax):
                take = (counts[:, v] > 0) & (v < cur)
                for i in np.nonzero(take)[0]:
                    c2 = counts[i].copy()
                    c2[v] -= 1
                    rank[i] += _perms_of_counts(c2, rem - 1)
            counts[np.arange(n), cur] -= 1
        return rank

    def _unrank_perm(self, rank: np.ndarray, atom: np.ndarray) -> np.ndarray:
        n = len(rank)
        dim = self.dim
        out = np.zeros((n, dim), np.int64)
        counts = self._counts(atom)
        rank = rank.copy()
        for pos in range(dim):
            rem = dim - pos
            for i in range(n):
                for v in range(self._vmax):
                    if counts[i, v] == 0:
                        continue
                    c2 = counts[i].copy()
                    c2[v] -= 1
                    block = _perms_of_counts(c2, rem - 1)
                    if rank[i] < block:
                        out[i, pos] = v
                        counts[i, v] -= 1
                        break
                    rank[i] -= block
        return out

    # --- enumerative encode / decode (the EnumeratedVectors API) ---------
    def encode(self, c: np.ndarray) -> np.ndarray:
        """(n, dim) lattice points -> uint64 ids < nv."""
        c = np.asarray(c, np.int64)
        if self._vec:
            return self._encode_vec(c)
        mag = np.abs(c)
        smag = -np.sort(-mag, axis=1)
        index = {tuple(int(v) for v in a): i
                 for i, a in enumerate(self.atoms)}
        atom_id = np.array([index[tuple(int(v) for v in row)]
                            for row in smag], np.int64)
        pr = self._rank_perm(mag)
        codes = np.zeros(len(c), np.object_)
        for i in range(len(c)):
            nz = np.nonzero(mag[i])[0]
            bits = 0
            for j, p in enumerate(nz):
                if c[i, p] < 0:
                    bits |= 1 << j
            codes[i] = (int(self.offsets[atom_id[i]])
                        + int(pr[i]) * (1 << len(nz)) + bits)
        return codes.astype(np.uint64)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """uint64 ids -> (n, dim) int64 lattice points."""
        codes = np.asarray(codes, np.uint64)
        if self._vec:
            return self._decode_vec(codes)
        n = len(codes)
        offs = np.array([int(o) for o in self.offsets[1:]], np.object_)
        atom_id = np.array([int(np.searchsorted(offs, int(cd), side="right"))
                            for cd in codes], np.int64)
        res = np.array([int(cd) - int(self.offsets[a])
                        for cd, a in zip(codes, atom_id)], np.object_)
        nnz = self.nnz[atom_id]
        signs = np.array([r & ((1 << int(z)) - 1)
                          for r, z in zip(res, nnz)], np.object_)
        pr = np.array([r >> int(z) for r, z in zip(res, nnz)], np.object_)
        out = self._unrank_perm(pr, self.atoms[atom_id])
        for i in range(n):
            nz = np.nonzero(out[i])[0]
            for j, p in enumerate(nz):
                if (int(signs[i]) >> j) & 1:
                    out[i, p] = -out[i, p]
        return out


class ZnSphereCodecRec:
    """The recursive sphere codec of power-of-2 dims (faiss
    ZnSphereCodecRec, lattice_Zn.h:116-143): a point factors as (the split
    of r2 between its halves, the left half's code, the right half's).
    Codes have ZnSphereCodec's size but not its values, as in faiss."""

    def __init__(self, dim: int, r2: int):
        if dim & (dim - 1) or dim <= 0:
            raise ValueError("ZnSphereCodecRec requires a power-of-2 dim")
        self.dim = int(dim)
        self.r2 = int(r2)
        self.log2_dim = dim.bit_length() - 1
        # all_nv[ld][s] = points of Z^(2^ld) with squared norm exactly s
        L = self.log2_dim
        nv = [[0] * (r2 + 1) for _ in range(L + 1)]
        for s in range(r2 + 1):
            r = int(np.sqrt(s))
            nv[0][s] = 1 if s == 0 else (2 if r * r == s else 0)
        for ld in range(1, L + 1):
            for s in range(r2 + 1):
                nv[ld][s] = sum(nv[ld - 1][a] * nv[ld - 1][s - a]
                                for a in range(s + 1))
        self.all_nv = nv
        self.nv = int(nv[L][r2])
        if self.nv == 0:
            raise ValueError(f"no Z^{dim} points with squared norm {r2}")
        self.nbits = max(int(self.nv - 1).bit_length(), 1)
        self.code_size = -(-self.nbits // 8)

    def get_nv(self, ld: int, r2a: int) -> int:
        if r2a < 0 or r2a > self.r2:
            return 0
        return self.all_nv[ld][r2a]

    def _encode_rec(self, c: np.ndarray, ld: int, r2a: int) -> int:
        if ld == 0:
            v = int(c[0])
            if v * v != r2a:
                raise ValueError("not a sphere point at this radius")
            return 0 if v >= 0 else 1
        half = 1 << (ld - 1)
        a, b = c[:half], c[half:]
        ra = int((a.astype(np.int64) ** 2).sum())
        rb = r2a - ra
        off = sum(self.get_nv(ld - 1, s) * self.get_nv(ld - 1, r2a - s)
                  for s in range(ra))
        ca = self._encode_rec(a, ld - 1, ra)
        cb = self._encode_rec(b, ld - 1, rb)
        return off + ca * self.get_nv(ld - 1, rb) + cb

    def encode_centroid(self, c: np.ndarray) -> np.ndarray:
        """(n, dim) exact sphere points -> uint64 ids < nv."""
        c = np.atleast_2d(np.asarray(c, np.int64))
        return np.array(
            [self._encode_rec(row, self.log2_dim, self.r2) for row in c],
            np.uint64)

    encode = encode_centroid

    def _decode_rec(self, code: int, ld: int, r2a: int,
                    out: np.ndarray) -> None:
        if ld == 0:
            r = int(np.sqrt(r2a))
            out[0] = -r if code else r
            return
        half = 1 << (ld - 1)
        ra = 0
        while True:
            blk = self.get_nv(ld - 1, ra) * self.get_nv(ld - 1, r2a - ra)
            if code < blk:
                break
            code -= blk
            ra += 1
        rb = r2a - ra
        nb = self.get_nv(ld - 1, rb)
        self._decode_rec(code // nb, ld - 1, ra, out[:half])
        self._decode_rec(code % nb, ld - 1, rb, out[half:])

    def decode(self, codes: np.ndarray) -> np.ndarray:
        codes = np.atleast_1d(np.asarray(codes, np.uint64))
        out = np.zeros((len(codes), self.dim), np.int64)
        for i, cd in enumerate(codes):
            self._decode_rec(int(cd), self.log2_dim, self.r2, out[i])
        return out


class ZnSphereCodecAlt(ZnSphereCodec):
    """faiss ZnSphereCodecAlt (lattice_Zn.h:145+): the recursive codec
    for a power-of-2 dim, the permutation codec otherwise; encode takes
    arbitrary vectors (the nearest sphere point first)."""

    def __init__(self, dim: int, r2: int):
        super().__init__(dim, r2)
        self.use_rec = dim & (dim - 1) == 0
        self.znc_rec = ZnSphereCodecRec(dim, r2) if self.use_rec else None

    def encode(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x))
        c = self.search(x) if np.issubdtype(x.dtype, np.floating) \
            else x.astype(np.int64)
        if self.use_rec:
            return self.znc_rec.encode_centroid(c)
        return super().encode(c)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        if self.use_rec:
            return self.znc_rec.decode(codes)
        return super().decode(codes)
