"""ID selectors — faiss `impl/IDSelector.{h,cpp}`; a numpy copy of
`tpu_ann/models/selectors.py` (the port may not import the JAX package).

Search-time result filters (`IDSelectorRange/Array/Batch/Bitmap/All/Not/
And/Or/XOr`), passed via `SearchParameters.sel` (faiss/Index.h:64-69).
Every selector lowers to one uint8 bitmap over the id space
(`make_bitmap`); `IndexFlat` turns it into the fused scan's `id_mask`,
which folds into the streamed bias plane as +inf for masked-out rows.
"""


from __future__ import annotations

from typing import Sequence

import numpy as np


class IDSelector:
    """Base: subclasses implement is_member (host), member_array
    (vectorized membership over an arbitrary id array — used to build the
    per-ROW device mask, so sparse 64-bit id spaces never materialize a
    dense bitmap), and make_bitmap (dense mask over [0, n))."""

    def is_member(self, i: int) -> bool:
        raise NotImplementedError

    def member_array(self, ids: np.ndarray) -> np.ndarray:
        """(len(ids),) bool membership of each id (vectorized is_member)."""
        return np.fromiter((self.is_member(int(i)) for i in ids),
                           bool, count=len(ids))

    def make_bitmap(self, n: int) -> np.ndarray:
        """(n,) uint8 allow-mask over internal ids [0, n)."""
        return self.member_array(np.arange(n, dtype=np.int64)).astype(
            np.uint8)


class IDSelectorRange(IDSelector):
    """imin <= id < imax (IDSelectorRange)."""

    def __init__(self, imin: int, imax: int):
        self.imin, self.imax = int(imin), int(imax)

    def is_member(self, i: int) -> bool:
        return self.imin <= i < self.imax

    def member_array(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        return (ids >= self.imin) & (ids < self.imax)

    def make_bitmap(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.uint8)
        out[max(self.imin, 0) : max(min(self.imax, n), 0)] = 1
        return out


class IDSelectorArray(IDSelector):
    """Explicit id list (IDSelectorArray / IDSelectorBatch)."""

    def __init__(self, ids: Sequence[int]):
        self.ids = np.asarray(ids, np.int64)

    def is_member(self, i: int) -> bool:
        return bool((self.ids == i).any())

    def member_array(self, ids: np.ndarray) -> np.ndarray:
        return np.isin(np.asarray(ids, np.int64), self.ids)

    def make_bitmap(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.uint8)
        sel = self.ids[(self.ids >= 0) & (self.ids < n)]
        out[sel] = 1
        return out


IDSelectorBatch = IDSelectorArray


class IDSelectorBitmap(IDSelector):
    """Bit-packed selector (IDSelectorBitmap: byte i>>3, bit i&7)."""

    def __init__(self, bitmap: np.ndarray):
        self.bitmap = np.asarray(bitmap, np.uint8)

    def is_member(self, i: int) -> bool:
        return bool((self.bitmap[i >> 3] >> (i & 7)) & 1)

    def member_array(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        inb = (ids >= 0) & ((ids >> 3) < len(self.bitmap))
        safe = np.where(inb, ids, 0)
        bit = (self.bitmap[safe >> 3] >> (safe & 7)) & 1
        return (bit.astype(bool)) & inb

    def make_bitmap(self, n: int) -> np.ndarray:
        idx = np.arange(n)
        return ((self.bitmap[idx >> 3] >> (idx & 7)) & 1).astype(np.uint8)


class IDSelectorAll(IDSelector):
    def is_member(self, i: int) -> bool:
        return True

    def member_array(self, ids: np.ndarray) -> np.ndarray:
        return np.ones(len(ids), bool)

    def make_bitmap(self, n: int) -> np.ndarray:
        return np.ones(n, np.uint8)


class IDSelectorNot(IDSelector):
    def __init__(self, sel: IDSelector):
        self.sel = sel

    def is_member(self, i: int) -> bool:
        return not self.sel.is_member(i)

    def member_array(self, ids: np.ndarray) -> np.ndarray:
        return ~self.sel.member_array(ids)

    def make_bitmap(self, n: int) -> np.ndarray:
        return (1 - self.sel.make_bitmap(n)).astype(np.uint8)


class IDSelectorAnd(IDSelector):
    def __init__(self, lhs: IDSelector, rhs: IDSelector):
        self.lhs, self.rhs = lhs, rhs

    def is_member(self, i: int) -> bool:
        return self.lhs.is_member(i) and self.rhs.is_member(i)

    def member_array(self, ids: np.ndarray) -> np.ndarray:
        return self.lhs.member_array(ids) & self.rhs.member_array(ids)

    def make_bitmap(self, n: int) -> np.ndarray:
        return (self.lhs.make_bitmap(n) & self.rhs.make_bitmap(n))


class IDSelectorOr(IDSelector):
    def __init__(self, lhs: IDSelector, rhs: IDSelector):
        self.lhs, self.rhs = lhs, rhs

    def is_member(self, i: int) -> bool:
        return self.lhs.is_member(i) or self.rhs.is_member(i)

    def member_array(self, ids: np.ndarray) -> np.ndarray:
        return self.lhs.member_array(ids) | self.rhs.member_array(ids)

    def make_bitmap(self, n: int) -> np.ndarray:
        return (self.lhs.make_bitmap(n) | self.rhs.make_bitmap(n))


class IDSelectorXOr(IDSelector):
    def __init__(self, lhs: IDSelector, rhs: IDSelector):
        self.lhs, self.rhs = lhs, rhs

    def is_member(self, i: int) -> bool:
        return self.lhs.is_member(i) != self.rhs.is_member(i)

    def member_array(self, ids: np.ndarray) -> np.ndarray:
        return self.lhs.member_array(ids) ^ self.rhs.member_array(ids)

    def make_bitmap(self, n: int) -> np.ndarray:
        return (self.lhs.make_bitmap(n) ^ self.rhs.make_bitmap(n))
