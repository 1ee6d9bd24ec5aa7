"""IVF inverted-list storage — PyTorch counterpart of the packed layouts of
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

Coded lists (`PackedCodeInvLists`) keep the same layout with a codec's code
rows in place of the vectors. `PackedInvListsSQ8` is the 8-bit scalar-
quantized stream of the fused scan: uint8 codes (half the bytes of bf16)
with a per-dim affine x = bias + code * scale that the scan folds into the
queries, and the exact norms of the dequantized rows.
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


def _block_slots(assign: np.ndarray, nlist: int, B: int, what: str):
    """The counting sort by list (the batch form of
    `InvertedLists::add_entries`): returns (order, slot, starts_blocks,
    nblocks_per_list, nb_total); row order[i] lands at flat slot slot[i].
    Empty lists get 0 blocks and start at the dummy block nb_total."""
    n = len(assign)
    if n and (assign.min() < 0 or assign.max() >= nlist):
        raise ValueError(
            f"{what}: assignments must be in [0, {nlist}); "
            f"got [{assign.min()}, {assign.max()}]")
    order = np.argsort(assign, kind="stable")
    sizes = np.bincount(assign, minlength=nlist)
    nblocks_per_list = -(-sizes // B)  # ceil; empty lists get 0 blocks
    starts_blocks = np.zeros(nlist, np.int64)
    np.cumsum(nblocks_per_list[:-1], out=starts_blocks[1:])
    nb_total = int(nblocks_per_list.sum())
    # row r (in list order) lands at slot starts_blocks[list]*B + rank
    a_sorted = assign[order]
    src_starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(sizes, out=src_starts[1:])
    rank = np.arange(n, dtype=np.int64) - src_starts[a_sorted]
    slot = starts_blocks[a_sorted] * B + rank
    starts_blocks[nblocks_per_list == 0] = nb_total
    return order, slot, starts_blocks, nblocks_per_list, nb_total


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
    sort by list) and upload it to ``device``."""
    x = np.ascontiguousarray(x, np.float32)
    d = x.shape[1]
    xids = np.asarray(xids, np.int32)
    B = block_size
    order, slot, starts_blocks, nblocks_per_list, nb_total = _block_slots(
        np.asarray(assign, np.int64), nlist, B, "pack_invlists")
    data = np.zeros((nb_total + 1, B, d), np.float32)
    ids = np.full((nb_total + 1, B), -1, np.int32)
    data.reshape(-1, d)[slot] = x[order]
    ids.reshape(-1)[slot] = xids[order]
    norms = (data.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    return PackedInvLists.from_arrays(data, ids, norms, starts_blocks,
                                      nblocks_per_list, device=device)


# ---------------------------------------------------------------------------
# coded inverted lists (SQ / PQ codes instead of raw vectors)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedCodeInvLists:
    """Block-padded inverted lists of codes — the layout of PackedInvLists
    with the codec's per-vector code row (uint8 / fp16 / bf16) in place of
    the vector, the role of `ArrayInvertedLists::codes` for IVFPQ / IVFSQ
    (invlists/InvertedLists.h:37-130)."""

    codes: torch.Tensor             # (nblocks+1, B, code_width)
    ids: torch.Tensor               # (nblocks+1, B) int32, -1 = padding
    list_block_start: torch.Tensor  # (nlist,) int32
    list_nblocks: torch.Tensor      # (nlist,) int32

    @property
    def nlist(self) -> int:
        return self.list_block_start.shape[0]

    @property
    def block_size(self) -> int:
        return self.codes.shape[1]

    @property
    def nblocks(self) -> int:
        return self.codes.shape[0] - 1


def pack_code_invlists(
    codes,
    xids: np.ndarray,
    assign: np.ndarray,
    nlist: int,
    block_size: int = 128,
    *,
    device="cuda",
) -> PackedCodeInvLists:
    """Counting-sort code rows ((n, code_width) tensor or numpy array, any
    code dtype) into the block-padded layout on ``device``. The slots come
    from the host sort; the rows are scattered on the device."""
    codes = torch.as_tensor(codes).to(device)
    n, cw = codes.shape
    B = block_size
    order, slot, starts_blocks, nblocks_per_list, nb_total = _block_slots(
        np.asarray(assign, np.int64), nlist, B, "pack_code_invlists")
    cdata = torch.zeros((nb_total + 1, B, cw), dtype=codes.dtype,
                        device=device)
    ids = np.full((nb_total + 1, B), -1, np.int32)
    ids.reshape(-1)[slot] = np.asarray(xids, np.int32)[order]
    if n:
        cdata.view(-1, cw)[torch.from_numpy(slot).to(device)] = \
            codes[torch.from_numpy(order).to(device)]
    return PackedCodeInvLists(
        codes=cdata, ids=torch.from_numpy(ids).to(device),
        list_block_start=torch.tensor(starts_blocks, dtype=torch.int32,
                                      device=device),
        list_nblocks=torch.tensor(nblocks_per_list, dtype=torch.int32,
                                  device=device))


# ---------------------------------------------------------------------------
# the SQ8 stream of the fused scan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedInvListsSQ8:
    """Block-padded invlists of 8-bit scalar-quantized vectors: ``codes``
    uint8 (nblocks+1, B, d), (``sq_bias``, ``sq_scale``) f32 (d,) the per-
    dim dequant affine x = bias + code * scale, ``norms`` the EXACT norms of
    the dequantized rows. The fused scan streams the codes (half the bytes
    of bf16) and folds the affine into the queries; no f32 or bf16 copy of
    the stream exists."""

    codes: torch.Tensor             # (nblocks+1, B, d) uint8
    ids: torch.Tensor               # (nblocks+1, B) int32
    norms: torch.Tensor             # (nblocks+1, B) f32 (dequantized)
    list_block_start: torch.Tensor  # (nlist,) int32
    list_nblocks: torch.Tensor      # (nlist,) int32
    sq_bias: torch.Tensor           # (d,) f32: x = bias + scale * code
    sq_scale: torch.Tensor          # (d,) f32

    nlist = PackedCodeInvLists.nlist
    block_size = PackedCodeInvLists.block_size
    nblocks = PackedCodeInvLists.nblocks

    def rows_at(self, pos: torch.Tensor):
        """The dequantized f32 rows (code * scale + bias, the reference's
        order) and their norms at stream positions ``pos`` (>= 0)."""
        rows = self.codes.view(-1, self.codes.shape[-1])[pos]
        return (rows.float() * self.sq_scale + self.sq_bias,
                self.norms.view(-1)[pos])

    ids_at = PackedInvLists.ids_at


def sq8_view_from_codes(invlists: PackedCodeInvLists, bias, scale,
                        chunk_blocks: int = 512) -> PackedInvListsSQ8:
    """Wrap 8-bit SQ code invlists (codes of width d) as the SQ8 stream
    without copying the codes; only the exact dequantized norms
    sum((bias + code * scale)^2) are computed, chunk by chunk."""
    codes = invlists.codes
    total, B, d = codes.shape
    dev = codes.device
    bias = torch.as_tensor(bias, dtype=torch.float32,
                           device=dev).broadcast_to((d,)).contiguous()
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=dev).broadcast_to((d,)).contiguous()
    norms = torch.empty((total, B), dtype=torch.float32, device=dev)
    for s in range(0, total, chunk_blocks):
        x = bias + codes[s:s + chunk_blocks].float() * scale
        norms[s:s + chunk_blocks] = (x * x).sum(2)
    return PackedInvListsSQ8(
        codes=codes, ids=invlists.ids, norms=norms,
        list_block_start=invlists.list_block_start,
        list_nblocks=invlists.list_nblocks, sq_bias=bias, sq_scale=scale)


def sq8_requantize_invlists(pil: PackedInvLists,
                            chunk_blocks: int = 512) -> PackedInvListsSQ8:
    """Re-quantize raw packed invlists to the SQ8 stream (per-dim min/max
    over the real rows, scale = vdiff / 255). Norms come from the
    DEQUANTIZED rows, so the exact re-rank holds at the storage
    precision."""
    data = pil.data
    total, B, d = data.shape
    dev = data.device
    vmin = torch.full((d,), float("inf"), device=dev)
    vmax = torch.full((d,), float("-inf"), device=dev)
    for s in range(0, total, chunk_blocks):
        x = data[s:s + chunk_blocks].float()
        valid = (pil.ids[s:s + chunk_blocks] >= 0)[:, :, None]
        vmin = torch.minimum(vmin, torch.where(valid, x, float("inf"))
                             .reshape(-1, d).amin(0))
        vmax = torch.maximum(vmax, torch.where(valid, x, float("-inf"))
                             .reshape(-1, d).amax(0))
    vmin = torch.where(torch.isfinite(vmin), vmin, 0.0)
    vmax = torch.where(torch.isfinite(vmax), vmax, 1.0)
    vdiff = torch.clamp(vmax - vmin, min=1e-12)
    scale = vdiff / 255.0
    # the reference divides by scale inside a jitted function where scale
    # is a constant, which XLA compiles to a product with its reciprocal;
    # the same product here keeps the codes byte-equal
    inv_scale = 1.0 / scale
    codes = torch.empty((total, B, d), dtype=torch.uint8, device=dev)
    norms = torch.empty((total, B), dtype=torch.float32, device=dev)
    for s in range(0, total, chunk_blocks):
        x = data[s:s + chunk_blocks].float()
        c = torch.clamp(torch.round((x - vmin) * inv_scale), 0, 255)
        deq = vmin + c * scale
        codes[s:s + chunk_blocks] = c.to(torch.uint8)
        norms[s:s + chunk_blocks] = (deq * deq).sum(2)
    return PackedInvListsSQ8(
        codes=codes, ids=pil.ids, norms=norms,
        list_block_start=pil.list_block_start,
        list_nblocks=pil.list_nblocks, sq_bias=vmin, sq_scale=scale)
