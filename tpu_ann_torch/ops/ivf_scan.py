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
instead of on every search. A bf16 decoded PQ cache holds its rows once:
its ``data`` is ``data_bf16`` itself, widened where it is read.

Coded lists (`PackedCodeInvLists`) keep the same layout with a codec's code
rows in place of the vectors. `PackedInvListsSQ8` is the 8-bit scalar-
quantized stream of the fused scan: uint8 codes (half the bytes of bf16)
with a per-dim affine x = bias + code * scale that the scan folds into the
queries, and the exact norms of the dequantized rows.

`pack_invlists_device` builds the layout from rows already on the device
(the reference's bucketed block count included), and `scan_invlists` is
the query-major scan over it (`search_preassigned` phase 2,
faiss/IndexIVF.cpp:399-723): a per-query compacted block table, queries
sorted by scan length, exact f32 scores and a running top-k. The HNSW
graph build uses it for its kNN candidates, and IVF searches with an
IDSelector or a max_codes cap take it. `scan_invlists_sq` is the same scan
over SQ code lists (dequantized per chunk), `scan_invlists_pq` over PQ
code lists (the ADC table summed per code), and
`scan_invlists_hash` over spectral-hash code lists (a Hamming score
against each list's thresholds), and `decode_code_invlists_generic` /
`decode_code_invlists` decode code lists into a raw layout (the IVF-SQ
and IVF-PQ range searches', and IVFPQ's decoded cache, which the fused
scan streams).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import distances as D
from . import pq as PQ
from . import topk as TK


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

    @property
    def max_nblocks_per_list(self) -> int:
        """The longest list's block count (at least 1); one host sync."""
        return max(int(self.list_nblocks.max()), 1) if self.nlist else 1

    def rows_at(self, pos: torch.Tensor):
        """The f32 rows (a bf16 ``data`` widened) and norms at stream
        positions ``pos`` (>= 0)."""
        return (self.data.view(-1, self.data.shape[-1])[pos].float(),
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


def pack_invlists_device(rows_dev: torch.Tensor, xids: np.ndarray,
                         assign: np.ndarray, nlist: int,
                         block_size: int = 128) -> PackedInvLists:
    """The packed layout realized on the device from the (n, d) rows
    ``rows_dev`` already there, in ``xids`` order (reference :215-298):
    only the integer counting sort runs on the host, the rows are gathered
    once into their slots.

    The block count is bucketed as the reference's (+1 dummy, then a power
    of two up to 8192 blocks, 8192-block steps above), and empty lists
    point at the last, all-padding block, so the layout equals the
    reference's array for array."""
    if not rows_dev.shape[0]:
        raise ValueError("pack_invlists_device: no rows")
    dev, d = rows_dev.device, rows_dev.shape[1]
    B = block_size
    order, slot, starts_blocks, nblocks_per_list, nb_total = _block_slots(
        np.asarray(assign, np.int64), nlist, B, "pack_invlists_device")
    need = nb_total + 1
    nb_pad = 1 << max(need - 1, 0).bit_length() if need <= 8192 else \
        -(-need // 8192) * 8192
    ids = np.full(nb_pad * B, -1, np.int32)
    ids[slot] = np.asarray(xids, np.int32)[order]
    data = torch.zeros((nb_pad, B, d), dtype=torch.float32, device=dev)
    data.view(-1, d)[torch.from_numpy(slot).to(dev)] = \
        rows_dev[torch.from_numpy(order).to(dev)].float()
    starts_blocks[nblocks_per_list == 0] = nb_pad - 1
    return PackedInvLists(
        data=data, data_bf16=data.to(torch.bfloat16),
        ids=torch.from_numpy(ids.reshape(nb_pad, B)).to(dev),
        norms=(data * data).sum(-1),
        list_block_start=torch.tensor(starts_blocks, dtype=torch.int32,
                                      device=dev),
        list_nblocks=torch.tensor(nblocks_per_list, dtype=torch.int32,
                                  device=dev))


def _compact_block_table(probes, list_block_start, list_nblocks,
                         max_nblocks: int, NB: int):
    """Per-query compacted block table (reference :299): each probe's real
    blocks side by side, buffer[q, offs[q, p] + i] = start[q, p] + i, the
    rest NB (the dummy block). Returns (buffer (nq, nprobe * max_nblocks)
    int64, total (nq,) blocks per query)."""
    nq, nprobe = probes.shape
    probes = probes.long()
    starts = list_block_start.long()[probes]
    nblk = torch.clamp(list_nblocks.long()[probes], max=max_nblocks)
    offs = torch.cumsum(nblk, 1) - nblk                   # exclusive
    total = offs[:, -1] + nblk[:, -1]
    W = nprobe * max_nblocks
    local = torch.arange(max_nblocks, device=probes.device)
    valid = local < nblk[:, :, None]
    pos = torch.where(valid, offs[:, :, None] + local, W)   # invalid -> W
    bid = starts[:, :, None] + local
    buffer = torch.full((nq, W + 1), NB, dtype=torch.long,
                        device=probes.device)
    buffer.scatter_(1, pos.reshape(nq, W), torch.where(
        valid, bid, NB).reshape(nq, W))
    return buffer[:, :W], total


def block_lists(invlists) -> torch.Tensor:
    """(nblocks + 1,) int64: the list that owns each block (lists own
    contiguous block runs in id order; the dummy block and any tail take
    list 0, their ids are -1)."""
    dev = invlists.list_block_start.device
    runs = torch.repeat_interleave(
        torch.arange(invlists.nlist, device=dev),
        invlists.list_nblocks.long())
    out = torch.zeros(invlists.nblocks + 1, dtype=torch.long, device=dev)
    out[:len(runs)] = runs
    return out



# f32 elements of gathered rows per chunk of the query-major scan (bounds
# its query-tile height)
SCAN_BUDGET = 1 << 26


def _scan_compacted(xq: torch.Tensor, probes: torch.Tensor, lists, score,
                    k: int, similarity: bool, *, max_nblocks: int,
                    chunk_blocks: int, id_mask=None):
    """The query-major loop shared by every codec (reference
    `_scan_compacted`, :331-425).

    Queries are sorted by their number of probed blocks; each tile of
    queries walks its compacted table in chunks of ``chunk_blocks`` blocks
    (as many chunks as its longest query needs). ``score(q, bids)`` gives
    one chunk's (dis (qt, cb, B) f32, vids (qt, cb, B) int32); slots with
    an id < 0, or whose row ``id_mask`` (a uint8 bitmap over stored rows,
    an IDSelector's) forbids, get the worst value and are not counted in
    ``ndis``. Each chunk merges into a running top-k (first operand wins
    ties, so the earlier chunk's entry does). The tile height only bounds
    the gathered rows (SCAN_BUDGET f32 elements): it does not change the
    result. Returns (D (nq, k) f32, I (nq, k) int32, ndis 0-d tensor)."""
    nq, d = xq.shape
    bad = -float("inf") if similarity else float("inf")
    dev = xq.device
    xq = xq.float()
    NB = lists.nblocks
    B = lists.block_size
    buffer, total = _compact_block_table(
        probes, lists.list_block_start, lists.list_nblocks, max_nblocks, NB)
    perm = torch.argsort(total, stable=True)
    cb = min(chunk_blocks, buffer.shape[1])
    qt = max(1, min(nq, SCAN_BUDGET // max(cb * B * d, 1)))
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    ndis = torch.zeros((), dtype=torch.long, device=dev)
    nch_all = ((total[perm] + cb - 1) // cb).cpu()        # one host sync
    for t0 in range(0, nq, qt):
        rows = perm[t0:t0 + qt]
        q = xq[rows]
        blk = buffer[rows]
        bd = torch.full((len(rows), k), bad, device=dev)
        bi = torch.full((len(rows), k), -1, dtype=torch.int32, device=dev)
        for c in range(int(nch_all[t0:t0 + qt].max()) if len(rows) else 0):
            bids = blk[:, c * cb:(c + 1) * cb]
            if bids.shape[1] < cb:                    # ragged last chunk
                bids = torch.cat([bids, bids.new_full(
                    (len(rows), cb - bids.shape[1]), NB)], 1)
            dis, vids = score(q, bids)
            valid = vids >= 0
            if id_mask is not None:
                valid &= id_mask[torch.where(valid, vids, 0).long()] != 0
            dis = torch.where(valid, dis, bad)
            ndis += valid.sum()
            bd, bi = TK.merge_topk(bd, bi, dis.view(len(rows), -1),
                                   vids.view(len(rows), -1), k,
                                   similarity=similarity)
        out_d[rows] = bd
        out_i[rows] = bi
    return out_d, out_i, ndis


def _l2_or_ip(q: torch.Tensor, vecs: torch.Tensor, vnorm, similarity: bool):
    """One chunk's f32 scores of queries ``q`` (qt, d) against their rows
    ``vecs`` (qt, cb, B, d): IP q.x, or L2 max(||q||^2 + vnorm - 2 q.x, 0)
    with ``vnorm`` the rows' norms."""
    qt, cb, B, d = vecs.shape
    ip = torch.bmm(vecs.view(qt, -1, d), q[:, :, None]).view(qt, cb, B)
    if similarity:
        return ip
    return torch.clamp((q * q).sum(1)[:, None, None] + vnorm - 2.0 * ip,
                       min=0.0)


def scan_invlists(xq: torch.Tensor, probes: torch.Tensor,
                  invlists: PackedInvLists, k: int,
                  metric: int = D.METRIC_L2, *, max_nblocks: int,
                  chunk_blocks: int = 8, id_mask=None):
    """Query-major scan of the probed lists (reference :433-490), exact f32
    scores over the stored rows and norms (L2: max(||q||^2 + ||x||^2 -
    2 q.x, 0); IP: q.x). ``max_nblocks`` caps the blocks read per list, as
    the reference's static cap does (the role of max_codes); ``id_mask`` is
    an IDSelector's uint8 bitmap over stored rows (SearchParameters.sel).
    A `PackedInvListsSQ8` is dequantized per chunk (bias + code * scale,
    the rows its norms hold), as the reference's is. The per-chunk top-k
    is always exact (the reference's ``approx`` switch is not taken). See
    `_scan_compacted` for the loop.
    Returns (D (nq, k) f32, I (nq, k) int32 stored ids, ndis 0-d tensor:
    the real, allowed rows scored)."""
    similarity = D.is_similarity_metric(metric)
    sq8 = isinstance(invlists, PackedInvListsSQ8)

    def score(q, bids):
        vecs = (invlists.sq_bias + invlists.codes[bids].float()
                * invlists.sq_scale) if sq8 else invlists.data[bids].float()
        return (_l2_or_ip(q, vecs, invlists.norms[bids], similarity),
                invlists.ids[bids])

    return _scan_compacted(xq, probes, invlists, score, k, similarity,
                           max_nblocks=max_nblocks,
                           chunk_blocks=chunk_blocks, id_mask=id_mask)


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

    max_nblocks_per_list = PackedInvLists.max_nblocks_per_list


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


def sq8_requantize_invlists(pil: PackedInvLists, chunk_blocks: int = 512,
                            affine=None) -> PackedInvListsSQ8:
    """Re-quantize raw packed invlists to the SQ8 stream (per-dim min/max
    over the real rows, scale = vdiff / 255). Norms come from the
    DEQUANTIZED rows, so the exact re-rank holds at the storage
    precision. ``affine`` = (bias, scale), if given, replaces the min/max
    (rows already dequantized with it get their codes back)."""
    data = pil.data
    total, d = data.shape[0], data.shape[2]
    dev = data.device
    if affine is not None:
        vmin, scale = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                       for a in affine)
        return _sq8_encode(pil, vmin, scale, chunk_blocks)
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
    return _sq8_encode(pil, vmin, vdiff / 255.0, chunk_blocks)


def _sq8_encode(pil: PackedInvLists, vmin: torch.Tensor, scale: torch.Tensor,
                chunk_blocks: int) -> PackedInvListsSQ8:
    data = pil.data
    total, B, d = data.shape
    dev = data.device
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


# ---------------------------------------------------------------------------
# the query-major scan of SQ code lists, and decoded caches
# ---------------------------------------------------------------------------

def scan_invlists_sq(xq: torch.Tensor, probes: torch.Tensor,
                     invlists: PackedCodeInvLists, vmin: torch.Tensor,
                     vdiff: torch.Tensor, k: int, metric: int = D.METRIC_L2,
                     *, qtype: int, max_nblocks: int, chunk_blocks: int = 8,
                     id_mask=None):
    """Query-major scan of SQ-coded lists (reference :1086-1133, the
    SQDistanceComputer role): each gathered chunk of codes is dequantized
    with `ops.sq.sq_dequant_codes` (the 4-bit and 6-bit codes unpacked),
    then scored in f32; L2 takes the norms of the dequantized rows
    themselves. Same loop, arguments and returns as `scan_invlists`."""
    from . import sq as SQ

    similarity = D.is_similarity_metric(metric)
    d = xq.shape[1]

    def score(q, bids):
        vecs = SQ.sq_dequant_codes(invlists.codes[bids], qtype, d, vmin,
                                   vdiff)
        vnorm = None if similarity else (vecs * vecs).sum(3)
        return _l2_or_ip(q, vecs, vnorm, similarity), invlists.ids[bids]

    return _scan_compacted(xq, probes, invlists, score, k, similarity,
                           max_nblocks=max_nblocks,
                           chunk_blocks=chunk_blocks, id_mask=id_mask)


def decode_code_invlists_generic(invlists: PackedCodeInvLists, decode_rows,
                                 d: int, coarse_centroids=None, *,
                                 chunk_blocks: int = 128,
                                 dtype=torch.float32) -> PackedInvLists:
    """Raw invlists decoded from code lists, chunk by chunk on the codes'
    device (reference :739-804): ``decode_rows((n, code width) codes) ->
    (n, d) f32``; with ``coarse_centroids`` ((nlist, d), for codecs of
    residuals) each row adds its list's centroid. The id plane and list
    ranges are shared with ``invlists``.

    ``dtype`` is the reference's cache dtype: the norms come from the f32
    decode, the rows are rounded to ``dtype``. A bf16 cache holds its rows
    once: ``data`` IS the bf16 stream ``data_bf16``, which the fused scan
    reads and its exact re-rank widens (`PackedInvLists.rows_at`), as the
    reference re-ranks its bf16 rows."""
    codes = invlists.codes
    total, B = codes.shape[:2]
    dev = codes.device
    if coarse_centroids is not None:
        cent = torch.as_tensor(coarse_centroids, dtype=torch.float32,
                               device=dev)
        block2list = block_lists(invlists)
    data = torch.empty((total, B, d), dtype=dtype, device=dev)
    norms = torch.empty((total, B), dtype=torch.float32, device=dev)
    for s in range(0, total, chunk_blocks):
        cblk = codes[s:s + chunk_blocks]
        x = decode_rows(cblk.reshape(-1, cblk.shape[-1])).float()
        x = x.reshape(cblk.shape[0], B, d)
        if coarse_centroids is not None:
            x = x + cent[block2list[s:s + chunk_blocks]][:, None, :]
        norms[s:s + chunk_blocks] = (x * x).sum(2)
        data[s:s + chunk_blocks] = x.to(dtype)
    return PackedInvLists(
        data=data, data_bf16=data if dtype == torch.bfloat16
        else data.to(torch.bfloat16), ids=invlists.ids,
        norms=norms, list_block_start=invlists.list_block_start,
        list_nblocks=invlists.list_nblocks)


def decode_code_invlists(invlists: PackedCodeInvLists, pq_centroids,
                         coarse_centroids=None, *, packed4: bool = False,
                         chunk_blocks: int = 128,
                         dtype=torch.float32) -> PackedInvLists:
    """PQ code lists decoded into a raw PackedInvLists with the same block
    structure, the "decoded cache" (reference :807-856): scanning it with
    the fused scan computes the ADC distance itself (||q - c_l - dec||^2 is
    the summed residual table, the subspaces being orthogonal) at the raw
    scan's speed. ``pq_centroids`` (M, ksub, dsub) f32 on the codes'
    device; ``coarse_centroids`` (nlist, d) for residual codes, None
    otherwise; ``packed4`` for two 4-bit sub-indices a byte; ``dtype`` as
    in `decode_code_invlists_generic`. Padding rows decode whatever their
    zero codes decode to: every scan masks them by id."""
    M, ksub, dsub = pq_centroids.shape

    def decode_rows(flat):
        return PQ.pq_decode(PQ.unpack_codes_4bit(flat) if packed4 else flat,
                            pq_centroids)

    return decode_code_invlists_generic(
        invlists, decode_rows, M * dsub, coarse_centroids,
        chunk_blocks=chunk_blocks, dtype=dtype)


def scan_invlists_pq(xq: torch.Tensor, probes: torch.Tensor,
                     invlists: PackedCodeInvLists, pq_centroids: torch.Tensor,
                     coarse_centroids, k: int, metric: int = D.METRIC_L2, *,
                     by_residual: bool = True, max_nblocks: int,
                     chunk_blocks: int = 8, id_mask=None,
                     packed4: bool = False):
    """ADC scan of PQ code lists (IndexIVFPQ::search_preassigned ->
    scan_list_with_table; reference :865-965), on `_scan_compacted`'s
    loop. With ``by_residual`` on L2 each probed block's table comes from
    r = q - c(its list) (the use_precomputed_table=0 path), the block's
    list from the packed layout's contiguous runs; otherwise one table a
    query. The distance is an f32 gather-and-sum of the table for every
    ksub: the reference's bf16 one-hot contraction for ksub <= 16 (:937-951)
    is an MXU workaround, not taken. ``packed4`` codes are unpacked in the
    gather. Same arguments and returns as `scan_invlists`."""
    similarity = D.is_similarity_metric(metric)
    M, ksub, dsub = pq_centroids.shape
    dev = invlists.codes.device
    use_residual = by_residual and not similarity
    if use_residual:
        cent = torch.as_tensor(coarse_centroids, dtype=torch.float32,
                               device=dev)
        block2list = block_lists(invlists)
    moffs = torch.arange(M, device=dev) * ksub

    def score(q, bids):
        qt, cb = bids.shape
        codes = invlists.codes[bids]                  # (qt, cb, B, M[/2])
        if packed4:
            codes = PQ.unpack_codes_4bit(codes)
        B = codes.shape[2]
        if use_residual:
            resid = q[:, None, :] - cent[block2list[bids]]
            lut = PQ.query_tables(resid.reshape(qt * cb, -1), pq_centroids,
                                  metric).reshape(qt, cb, M * ksub)
        else:
            lut = PQ.query_tables(q, pq_centroids, metric).reshape(
                qt, 1, M * ksub).expand(qt, cb, M * ksub)
        idx = (codes.long() + moffs).view(qt, cb, B * M)
        dis = torch.gather(lut, 2, idx).view(qt, cb, B, M).sum(3)
        return dis, invlists.ids[bids]

    return _scan_compacted(xq, probes, invlists, score, k, similarity,
                           max_nblocks=max_nblocks,
                           chunk_blocks=chunk_blocks, id_mask=id_mask)


def hash_bits(z: torch.Tensor, thresholds: torch.Tensor,
              period: float) -> torch.Tensor:
    """Spectral-hash bits of projections ``z`` against ``thresholds`` (the
    same shape, or broadcast): floor((z - c) * (2 / period)) & 1, in f32
    in the reference's order of operations (binarize_with_freq,
    IndexIVFSpectralHash.cpp:144; a different rounding flips the bits
    that sit on a boundary). Returns int32 0/1."""
    freq = torch.tensor(2.0 / period, dtype=torch.float32, device=z.device)
    return torch.floor((z.float() - thresholds) * freq).to(torch.int32) & 1


def scan_invlists_hash(zq: torch.Tensor, probes: torch.Tensor,
                       invlists: PackedCodeInvLists, trained: torch.Tensor,
                       period: float, k: int, *, max_nblocks: int,
                       chunk_blocks: int = 8, id_mask=None):
    """Hamming scan of spectral-hash code lists (IndexIVFSpectralHash's
    IVFScanner; reference :972-1080) on `_scan_compacted`'s loop: each
    query's projection ``zq`` (nq, nbit) is binarized against the
    thresholds ``trained`` (nlist, nbit) of the list that owns each probed
    block (`block_lists`), packed, and compared to the stored codes by the
    popcount of the XOR: the same integers as the reference's ±1 bf16
    product, as f32 distances. ``id_mask`` and ``ndis`` as in
    `scan_invlists`. Returns (D (nq, k) f32, I (nq, k) int32, ndis)."""
    from . import hamming as H

    owner = block_lists(invlists)

    def score(q, bids):
        bits = hash_bits(q[:, None, :], trained[owner[bids]], period)
        qb = H.pack_bits(bits.view(-1, bits.shape[-1])).view(
            bids.shape + (-1,))
        codes = invlists.codes[bids]                  # (qt, cb, B, bytes)
        return (H.hamming_rows(qb[:, :, None, :], codes).float(),
                invlists.ids[bids])

    return _scan_compacted(zq.float(), probes, invlists, score, k, False,
                           max_nblocks=max_nblocks,
                           chunk_blocks=chunk_blocks, id_mask=id_mask)
