"""Contrib helpers — the part of `tpu_ann/utils/contrib.py` that the IVF
API, ivflib and the index files need: `merge_indexes`, `add_preassigned`,
the inspect tools
`get_invlist` / `get_invlist_sizes`, and `get_linear_transform` /
`make_LinearTransform_matrix` (the rest of that module is tooling, ROADMAP
queue 1 item 11)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def merge_indexes(dst, srcs) -> None:
    """Merge IVF shards into ``dst`` (IndexIVF::merge_from /
    contrib.ondisk.merge_ondisk; reference :172-184). All must share the
    trained quantizer, so each shard's host chunks move over with their
    cached coarse assignments, and ``dst`` repacks once."""
    for src in srcs:
        if src.nlist != dst.nlist or src.d != dst.d:
            raise ValueError("incompatible shard")
        if src._pending_removals():
            # compact first: the reference merges the removed rows of its
            # host store back in
            src._repack()
        else:
            src._maybe_repack()
        for xs, ids, a in zip(src._xb_host, src._ids_host,
                              src._assign_host):
            dst._append_chunk(xs, ids, a)
    dst._repack()


def add_preassigned(index_ivf, x: np.ndarray, a: np.ndarray,
                    ids: Optional[np.ndarray] = None) -> None:
    """Add rows with their coarse assignment given (contrib/ivf_tools.py
    add_preassigned; reference :157-169): the chunk keeps ``a`` as its
    cached assignment, so the repack assigns nothing."""
    x = np.ascontiguousarray(x, np.float32)
    if ids is None:
        ids = np.arange(index_ivf.ntotal, index_ivf.ntotal + len(x),
                        dtype=np.int64)
    index_ivf._append_chunk(x.copy(), np.asarray(ids, np.int64).copy(),
                            np.asarray(a, np.int64))
    index_ivf._repack()


# ---------------------------------------------------------------------------
# inspect tools (contrib/inspect_tools.py; reference :246-283, 601)
# ---------------------------------------------------------------------------

def get_invlist(index_ivf, l: int) -> Tuple[np.ndarray, np.ndarray]:
    """(user ids, stored rows or codes) of inverted list ``l``, as numpy:
    the raw f32 rows of a Flat IVF, the codes of a coded one."""
    index_ivf._maybe_repack()
    il = index_ivf.invlists
    payload = il.data if hasattr(il, "data") else il.codes
    width = payload.shape[2]
    b0, nb = int(il.list_block_start[l]), int(il.list_nblocks[l])
    if nb == 0:
        return np.zeros(0, np.int64), payload[:0, 0].cpu().numpy()
    ids = il.ids[b0:b0 + nb].reshape(-1).cpu().numpy()
    rows = payload[b0:b0 + nb].reshape(-1, width).cpu().numpy()
    keep = ids >= 0
    return index_ivf._map_ids(ids[keep]), rows[keep]


def get_invlist_sizes(index_ivf) -> np.ndarray:
    return index_ivf.list_sizes


def get_linear_transform(vt) -> Tuple[np.ndarray, np.ndarray]:
    """(A, b) of a LinearTransform, y = x @ A.T + b
    (inspect_tools.get_LinearTransform_matrix)."""
    A = np.asarray(vt.A, np.float32)
    b = getattr(vt, "b", None)
    b = (np.zeros(A.shape[0], np.float32) if b is None
         else np.asarray(b, np.float32))
    return A, b


def make_LinearTransform_matrix(A: np.ndarray,
                                b: Optional[np.ndarray] = None, *,
                                device="cuda"):
    """A LinearTransform from an explicit (d_out, d_in) matrix and an
    optional bias (inspect_tools.py:71)."""
    from ..models.transforms import LinearTransform

    A = np.ascontiguousarray(A, np.float32)
    d_out, d_in = A.shape
    vt = LinearTransform(d_in, d_out, device=device)
    vt.A = A
    vt.b = (np.zeros(d_out, np.float32) if b is None
            else np.ascontiguousarray(b, np.float32))
    vt.is_trained = True
    return vt
