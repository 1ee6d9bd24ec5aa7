"""Contrib helpers — the part of `tpu_ann/utils/contrib.py` that the IVF
API needs (the rest of that module is tooling, ROADMAP queue 1 item 11)."""

from __future__ import annotations


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
