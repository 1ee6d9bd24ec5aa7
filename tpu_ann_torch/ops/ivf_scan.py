"""IVF inverted-list storage — PyTorch counterpart of the packed layout of
`tpu_ann/ops/ivf_scan.py` (faiss `invlists/InvertedLists.h`).

Every list is packed into fixed-size blocks of ``block_size`` rows, lists
in id order, each list's blocks contiguous:

  data      (nblocks+1, B, d) float32   block-padded vectors; the last
  data_bf16 (nblocks+1, B, d) bfloat16  block is a shared empty "dummy"
  ids       (nblocks+1, B)    int32     block (ids = -1) that empty lists
  norms     (nblocks+1, B)    float32   point at.
  list_block_start (nlist,) int32       first block of each list
  list_nblocks     (nlist,) int32       number of blocks of each list

The layout is byte-identical to the reference's, so stream positions
(block * B + lane) mean the same thing in both packages. ``data_bf16`` is
the stream the fused scan reads; it is cast once here, at pack time,
instead of on every search.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PackedInvLists:
    """Block-padded inverted lists on one device (see module docstring)."""

    data: torch.Tensor
    data_bf16: torch.Tensor
    ids: torch.Tensor
    norms: torch.Tensor
    list_block_start: torch.Tensor
    list_nblocks: torch.Tensor

    @property
    def nlist(self) -> int:
        return self.list_block_start.shape[0]

    @property
    def block_size(self) -> int:
        return self.data.shape[1]

    @property
    def nblocks(self) -> int:
        return self.data.shape[0] - 1  # excluding the dummy block

    def rows_at(self, pos: torch.Tensor):
        """The f32 rows and norms at stream positions ``pos`` (>= 0)."""
        return (self.data.view(-1, self.data.shape[-1])[pos],
                self.norms.view(-1)[pos])

    def ids_at(self, pos: torch.Tensor) -> torch.Tensor:
        """The stored ids (int64) at stream positions ``pos`` (>= 0)."""
        return self.ids.view(-1)[pos].long()

    @classmethod
    def from_arrays(cls, data, ids, norms, list_block_start, list_nblocks,
                    *, device) -> "PackedInvLists":
        """Copy host arrays of the packed layout to ``device`` and cast the
        bf16 stream."""
        def up(a, dtype):
            return torch.tensor(np.asarray(a, dtype), device=device)

        data = up(data, np.float32)
        return cls(data=data, data_bf16=data.to(torch.bfloat16),
                   ids=up(ids, np.int32), norms=up(norms, np.float32),
                   list_block_start=up(list_block_start, np.int32),
                   list_nblocks=up(list_nblocks, np.int32))


def pack_invlists(
    x: np.ndarray,
    xids: np.ndarray,
    assign: np.ndarray,
    nlist: int,
    block_size: int = 128,
    *,
    device="cuda",
) -> PackedInvLists:
    """Build the packed layout on the host from an assignment (counting
    sort by list — the batch form of `InvertedLists::add_entries`) and
    upload it to ``device``."""
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    xids = np.asarray(xids, np.int32)
    assign = np.asarray(assign, np.int64)
    if n and (assign.min() < 0 or assign.max() >= nlist):
        raise ValueError(
            f"pack_invlists: assignments must be in [0, {nlist}); "
            f"got [{assign.min()}, {assign.max()}]")
    B = block_size

    order = np.argsort(assign, kind="stable")
    sizes = np.bincount(assign, minlength=nlist)
    nblocks_per_list = -(-sizes // B)  # ceil; empty lists get 0 blocks
    starts_blocks = np.zeros(nlist, np.int64)
    np.cumsum(nblocks_per_list[:-1], out=starts_blocks[1:])
    nb_total = int(nblocks_per_list.sum())

    data = np.zeros((nb_total + 1, B, d), np.float32)
    ids = np.full((nb_total + 1, B), -1, np.int32)

    # row r (in list order) lands at slot starts_blocks[list]*B + rank
    a_sorted = assign[order]
    src_starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(sizes, out=src_starts[1:])
    rank = np.arange(n, dtype=np.int64) - src_starts[a_sorted]
    slot = starts_blocks[a_sorted] * B + rank
    data.reshape(-1, d)[slot] = x[order]
    ids.reshape(-1)[slot] = xids[order]

    norms = (data.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    # dummy block: already zero data / -1 ids; empty lists point at it
    starts_blocks[nblocks_per_list == 0] = nb_total
    return PackedInvLists.from_arrays(data, ids, norms, starts_blocks,
                                      nblocks_per_list, device=device)
