"""Out-of-core paged IVF scan — PyTorch counterpart of
`tpu_ann/ops/ivf_scan_paged.py`: search of inverted lists kept in host
memory or on disk (np.memmap), bigger than device memory (faiss
OnDiskInvertedLists.h:60-136, impl/index_read.cpp:214-226 IO_FLAG_MMAP).
Its kernel (K4) is hand-written in CUDA for Hopper
(``csrc/ivf_scan_paged.cu``, sharing K3's body in ``ivf_scan_core.cuh``).

The packed layout stores each list's blocks contiguously and lists in id
order, so the (query, probe) pairs sorted by list (`ivf_scan_fused.
plan_pairs`) form tiles that each touch one contiguous block range. The
scan slides a window of W consecutive blocks over the union of the probed
ranges, skipping unprobed gaps (`_plan_windows`), and scans every tile
that meets the window, its ranges clamped to it:

    memmap --(staging thread)--> pinned buffer [2]
           --(copy stream, non_blocking)--> device window [2]
           --(K4, current stream)--> running per-pair top-kp

Two buffers on each side: the host copy of window i+1 and its upload
overlap the scan of window i. CUDA events gate the hand-offs: a scan waits
for its window's upload; an upload into a device buffer waits for the last
scan that read it; the staging thread refills a pinned buffer only after
its upload has finished. A tile whose range straddles windows is scanned
in each, and K4 merges each window's rows into the pair's running top-kp
(an earlier window holds lower positions, so the tie rule is that of the
whole-stream scan). Windows inside the resident prefix (`upload_resident`,
the hot tier) are device views, with no copy. After the last window the
pairs are merged per query and the top refine * k candidates re-ranked in
exact f32 against rows gathered from the host f32 store
(`ivf_scan_fused.merge_pairs`).

On CPU tensors (``device="cpu"``) the same planner, staging thread and loop
run with plain copies, no pinned memory and no streams, and K4's plain
version `scan_window_reference` in place of the kernel.

What the port leaves out of the reference: the RW lane-min reservoir (the
per-pair top-kp is exact, as in `ivf_scan_fused`), Pallas interpret mode,
and the CB blocks of over-read padding at the end of every window (K4
clamps every range to the window, so no range reads past the stream).

The on-disk directory is byte-identical to the reference's (bf16 is
written as its raw uint16 bits, rounded to nearest even by
``Tensor.to(torch.bfloat16)``), so each package opens the other's.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import json
import os
import queue
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from . import distances as D
from . import topk as TK
from .ivf_scan_fused import (
    KP_LANE,
    KP_MAX,
    PT,
    PairPlan,
    default_kp,
    merge_pairs,
    plan_pairs,
    scan_pairs_reference,
    scan_pairs_wide,
)

# bf16 on disk, as raw bits (no numpy bf16 dtype is needed)
_BF16_BITS = np.uint16
# K4 launches made by `scan_window` (one per call on a CUDA tensor); of
# them, those of the kernel with two list entries a lane (kp above
# KP_LANE up to KP_MAX) and of the one whose lists live outside the
# registers (kp above KP_MAX)
LAUNCHES = 0
LAUNCHES_WIDE = 0
LAUNCHES_GLOBAL = 0
# host threads of the staging copy and the re-rank's row gather
_COPY_THREADS = max(1, min(8, os.cpu_count() or 1))


def to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even), as uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(_BF16_BITS)


# ---------------------------------------------------------------------------
# host-resident container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedInvLists:
    """Host-resident packed invlists (numpy or np.memmap block streams).

    data_bf16: (nblocks + 1, B, dp) uint16 bf16 bits — the scan stream, d
        zero-padded to a multiple of 128 (the reference's file layout).
    data_f32:  (nblocks + 1, B, d) f32 — the re-rank's row store (gathered
        only for the final candidates); None => re-rank from bf16.
    ids: (nblocks + 1, B) int32 (-1 padding), norms: (nblocks + 1, B) f32.
    list_block_start / list_nblocks: (nlist,) int64 host metadata.

    The layout of PackedInvLists, outside device memory; block nblocks is
    the dummy block that empty lists point at."""

    data_bf16: np.ndarray
    data_f32: Optional[np.ndarray]
    ids: np.ndarray
    norms: np.ndarray
    list_block_start: np.ndarray
    list_nblocks: np.ndarray
    d: int

    @property
    def nlist(self) -> int:
        return self.list_block_start.shape[0]

    @property
    def block_size(self) -> int:
        return self.data_bf16.shape[1]

    @property
    def nblocks(self) -> int:
        return self.data_bf16.shape[0] - 1

    @property
    def dp(self) -> int:
        return self.data_bf16.shape[2]

    @property
    def ntotal(self) -> int:
        return int((np.asarray(self.ids[:-1]) >= 0).sum()) \
            if self.nblocks < (1 << 16) else -1   # cheap only when small

    def nbytes_stream(self) -> int:
        return self.data_bf16.nbytes + self.ids.nbytes + self.norms.nbytes


_PAGED_META = "paged_meta.json"
_FILES = {
    "data_bf16": ("data_bf16.bin", _BF16_BITS),
    "data_f32": ("data_f32.bin", np.float32),
    "ids": ("ids.bin", np.int32),
    "norms": ("norms.bin", np.float32),
}


def _layout(nlist: int, sizes: np.ndarray, B: int):
    nblk = -(-sizes // B)
    starts = np.zeros(nlist, np.int64)
    np.cumsum(nblk[:-1], out=starts[1:])
    nb_total = int(nblk.sum())
    starts[nblk == 0] = nb_total           # empty lists -> dummy block
    return starts, nblk, nb_total


def _open_maps(path: str, meta: dict, mode: str) -> PagedInvLists:
    B, dp, d = meta["block_size"], meta["dp"], meta["d"]
    sizes = np.asarray(meta["list_sizes"], np.int64)
    starts, nblk, nb_total = _layout(meta["nlist"], sizes, B)
    if nb_total != meta["nb_total"]:
        raise ValueError(f"paged invlists: list sizes give {nb_total} "
                         f"blocks, the meta says {meta['nb_total']}")
    shapes = {
        "data_bf16": (nb_total + 1, B, dp),
        "data_f32": (nb_total + 1, B, d),
        "ids": (nb_total + 1, B),
        "norms": (nb_total + 1, B),
    }
    maps = {}
    for key, (fname, dt) in _FILES.items():
        if key == "data_f32" and not meta["keep_f32"]:
            maps[key] = None
            continue
        maps[key] = np.memmap(os.path.join(path, fname), mode=mode, dtype=dt,
                              shape=shapes[key])
    return PagedInvLists(
        data_bf16=maps["data_bf16"], data_f32=maps["data_f32"],
        ids=maps["ids"], norms=maps["norms"],
        list_block_start=starts, list_nblocks=nblk, d=d)


def create_paged_invlists(
    path: str,
    nlist: int,
    list_sizes: np.ndarray,
    d: int,
    block_size: int = 128,
    keep_f32: bool = True,
) -> PagedInvLists:
    """Allocate the on-disk layout for `list_sizes` rows per list and
    return writable memmaps (OnDiskInvertedLists::resize role). Rows are
    then filled streaming via `paged_add_chunk`."""
    os.makedirs(path, exist_ok=True)
    sizes = np.asarray(list_sizes, np.int64)
    if sizes.shape != (nlist,):
        raise ValueError(f"list_sizes must have shape ({nlist},)")
    _, _, nb_total = _layout(nlist, sizes, block_size)
    meta = {"nlist": nlist, "d": d, "block_size": block_size,
            "dp": -(-d // 128) * 128, "nb_total": nb_total,
            "keep_f32": keep_f32, "list_sizes": sizes.tolist()}
    pil = _open_maps(path, meta, "w+")
    # padding slots must read as invalid everywhere
    pil.ids[:] = -1
    with open(os.path.join(path, _PAGED_META), "w") as f:
        json.dump(meta, f)
    return pil


def open_paged_invlists(path: str, mode: str = "r") -> PagedInvLists:
    """mmap-load an on-disk paged index directory (IO_FLAG_MMAP role: host
    memory proportional to the touched pages, device memory independent of
    the index size)."""
    with open(os.path.join(path, _PAGED_META)) as f:
        meta = json.load(f)
    return _open_maps(path, meta, mode)


def paged_add_chunk(
    pil: PagedInvLists,
    fill: np.ndarray,
    x: np.ndarray,
    xids: np.ndarray,
    assign: np.ndarray,
) -> None:
    """Scatter one chunk of rows into the on-disk layout.

    `fill` is the caller-held (nlist,) int64 per-list fill cursor
    (InvertedLists::add_entries role), updated in place. Rows are grouped
    by list on the host (one stable argsort over the chunk)."""
    B = pil.block_size
    d = pil.d
    assign = np.asarray(assign, np.int64)
    order = np.argsort(assign, kind="stable")
    a_s = assign[order]
    x_s = np.asarray(x, np.float32)[order]
    i_s = np.asarray(xids, np.int32)[order]
    # per-row destination slot = start*B + fill + rank-within-chunk
    uniq, first = np.unique(a_s, return_index=True)
    counts = np.diff(np.append(first, len(a_s)))
    rank = np.arange(len(a_s)) - np.repeat(first, counts)
    slot = pil.list_block_start[a_s] * B + fill[a_s] + rank
    fill[uniq] += counts
    bf = to_bf16_bits(x_s)
    if pil.dp != d:
        bf = np.concatenate(
            [bf, np.zeros((len(bf), pil.dp - d), _BF16_BITS)], axis=1)
    pil.data_bf16.reshape(-1, pil.dp)[slot] = bf
    if pil.data_f32 is not None:
        pil.data_f32.reshape(-1, d)[slot] = x_s
    pil.ids.reshape(-1)[slot] = i_s
    pil.norms.reshape(-1)[slot] = (
        (x_s.astype(np.float64) ** 2).sum(-1).astype(np.float32))


# ---------------------------------------------------------------------------
# window planner
# ---------------------------------------------------------------------------

def _plan_windows(
    tile_bs: np.ndarray,      # (ntiles,) int64 first needed block per tile
    tile_be: np.ndarray,      # (ntiles,) int64 end block per tile
    W: int,                   # window width (blocks)
    TB: int,                  # tiles per kernel call
) -> Iterator[Tuple[int, int, int]]:
    """Yield (w0, ta, tb): scan tiles [ta, tb) against window
    [w0, w0 + W). Tiles are span-sorted (pairs sorted by list id =>
    tile spans are non-decreasing), so each window covers a contiguous
    tile range; a tile wider than its window reappears in later windows
    until its span is exhausted. Unprobed gaps are skipped by starting
    each window at the next uncovered tile's first block."""
    ntiles = len(tile_bs)
    t = 0
    spans = tile_be - tile_bs
    while t < ntiles and spans[t] == 0:
        t += 1
    covered = 0            # blocks of tile t already scanned
    while t < ntiles:
        w0 = int(tile_bs[t] + covered)
        w1 = w0 + W
        # tiles fully or partially inside [w0, w1)
        tb = t
        while tb < ntiles and (spans[tb] == 0 or tile_bs[tb] < w1):
            tb += 1
        # split wide tile ranges into TB-sized batches on the same window
        ta = t
        while ta < tb:
            yield w0, ta, min(ta + TB, tb)
            ta += TB
        # advance: tiles whose end lies within this window are done
        nt = t
        while nt < tb and (spans[nt] == 0 or tile_be[nt] <= w1):
            nt += 1
        if nt == t:
            covered = w1 - int(tile_bs[t])     # tile t continues
        else:
            t = nt
            while t < ntiles and spans[t] == 0:
                t += 1
            # the new head tile may already be partly covered by this
            # window: resume past w1, never re-covering blocks (a block
            # scanned twice would give a pair duplicate candidates)
            covered = (max(0, w1 - int(tile_bs[t]))
                       if t < ntiles else 0)


# ---------------------------------------------------------------------------
# windows and the kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    """Consecutive blocks of the stream on one device: data (n, B, dp)
    bfloat16, ids (n, B) int32, norms (n, B) float32."""

    data_bf16: torch.Tensor
    ids: torch.Tensor
    norms: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.data_bf16.shape[1]

    @property
    def nblocks(self) -> int:
        return self.data_bf16.shape[0]

    def blocks(self, w0: int, n: int) -> "Window":
        return Window(self.data_bf16[w0:w0 + n], self.ids[w0:w0 + n],
                      self.norms[w0:w0 + n])


def window_of(pil: PagedInvLists, w0: int, n: int, device) -> Window:
    """Blocks [w0, w0 + n) of the host stream, copied to ``device``."""
    bits = np.array(pil.data_bf16[w0:w0 + n]).view(np.int16)
    return Window(torch.from_numpy(bits).view(torch.bfloat16).to(device),
                  torch.from_numpy(np.array(pil.ids[w0:w0 + n])).to(device),
                  torch.from_numpy(np.array(pil.norms[w0:w0 + n])).to(device))


def upload_resident(pil: PagedInvLists, resident_blocks: int,
                    device="cuda") -> Window:
    """Copy the first `resident_blocks` of the stream to ``device`` once.

    The hot tier: windows that lie inside the resident prefix are served
    by views of it (no host transfer), windows beyond it stream as usual —
    the GPU backend's paging threshold (GpuIndex.h:70+ minPagedSize)
    applied to a prefix of the block stream."""
    return window_of(pil, 0, int(min(resident_blocks, pil.nblocks)), device)


def _window_plan(plan: PairPlan, w0: int, nwin: int, ta: int, tb: int,
                 pt: int) -> PairPlan:
    """The pairs and tiles [ta, tb) of `plan` with their block ranges
    clamped to the window [w0, w0 + nwin) and made window-local."""
    def local(blk):
        return blk.clamp(w0, w0 + nwin) - w0

    bs = local(plan.tile_bs[ta:tb])
    be = local(plan.tile_bs[ta:tb] + plan.tile_nb[ta:tb])
    sl = slice(ta * pt, tb * pt)
    return dataclasses.replace(
        plan, pair_q=plan.pair_q[sl], pstart=local(plan.pstart[sl]),
        pend=local(plan.pend[sl]), tile_bs=bs, tile_nb=be - bs)


def scan_window_reference(xq_bf16: torch.Tensor, qn: torch.Tensor,
                          plan: PairPlan, window: Window, w0: int, ta: int,
                          tb: int, run_d: torch.Tensor, run_p: torch.Tensor,
                          similarity: bool) -> None:
    """Plain torch version of K4: `scan_pairs_reference` over the window's
    rows with every range clamped to the window, then `merge_topk` of the
    running top-kp (first, so it wins ties) with the new one. Updates
    rows [ta * PT, tb * PT) of run_d / run_p (global positions) in
    place."""
    pt = plan.pair_q.shape[0] // max(plan.ntiles, 1)
    kp = run_d.shape[1]
    sub = _window_plan(plan, w0, window.nblocks, ta, tb, pt)
    nd, npos = scan_pairs_reference(xq_bf16, qn, sub, window, kp, similarity)
    npos = torch.where(npos >= 0, npos + w0 * window.block_size, -1)
    sl = slice(ta * pt, tb * pt)
    md, mp = TK.merge_topk(run_d[sl], run_p[sl], nd, npos, kp)
    run_d[sl] = md
    run_p[sl] = mp


def scan_window_wide(xq_bf16: torch.Tensor, qn: torch.Tensor,
                     plan: PairPlan, window: Window, w0: int, ta: int,
                     tb: int, run_d: torch.Tensor, run_p: torch.Tensor,
                     similarity: bool, pair_fn) -> None:
    """K4's function for any kp computed another way: `scan_pairs_wide`
    over the window's rows (every range clamped to the window and made
    window-local), its one call of ``pair_fn`` scanning sub-blocks of at
    most KP_LANE rows, then `merge_topk` of the running top-kp (first, so
    it wins ties) with the window's. No index route takes it:
    `chip_smoke.py` times it with ``pair_fn`` `_launch_fresh` beside K4's
    one launch; the tests give it `scan_pairs_reference`. Updates rows
    [ta * PT, tb * PT) of run_d / run_p in place, as
    `scan_window_reference` does."""
    pt = plan.pair_q.shape[0] // max(plan.ntiles, 1)
    kp = run_d.shape[1]
    sub = _window_plan(plan, w0, window.nblocks, ta, tb, pt)
    nd, npos = scan_pairs_wide(xq_bf16, qn, sub, window, kp, similarity,
                               pair_fn)
    npos = torch.where(npos >= 0, npos + w0 * window.block_size, -1)
    sl = slice(ta * pt, tb * pt)
    md, mp = TK.merge_topk(run_d[sl], run_p[sl], nd, npos, kp)
    run_d[sl] = md
    run_p[sl] = mp


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..kernels import load_library

        lib = load_library("ivf_scan_paged")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ivf_scan_window.argtypes = [vp] * 10 + [ci] * 8 + [vp] * 3
        lib.ivf_scan_window.restype = ci
        lib.ivf_scan_window_tile_pairs.argtypes = []
        lib.ivf_scan_window_tile_pairs.restype = ci
        if lib.ivf_scan_window_tile_pairs() != PT:
            raise RuntimeError("ivf_scan_paged: kernel tile size != PT")
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, dtype, name: str, dev) -> None:
    if t.dtype != dtype or t.device != dev or not t.is_contiguous():
        raise ValueError(f"ivf_scan_paged: {name} must be a contiguous "
                         f"{dtype} tensor on {dev} (got {t.dtype} on "
                         f"{t.device})")


def scan_window(xq_bf16: torch.Tensor, qn: torch.Tensor, plan: PairPlan,
                window: Window, w0: int, ta: int, tb: int,
                run_d: torch.Tensor, run_p: torch.Tensor,
                similarity: bool) -> None:
    """K4: scan tiles [ta, tb) of `plan` (global block ranges) against the
    window of blocks [w0, w0 + window.nblocks) and merge into the running
    per-pair top-kp run_d / run_p ((ntiles * PT, kp), global positions) in
    place. For CUDA tensors one launch of the CUDA kernel over the plan
    itself, at any kp; for CPU tensors the plain version. ``xq_bf16`` is
    (nq, dp), zero-padded like the stream."""
    dev = xq_bf16.device
    if dev.type == "cpu":
        scan_window_reference(xq_bf16, qn, plan, window, w0, ta, tb, run_d,
                              run_p, similarity)
        return
    kp = run_d.shape[1]
    if kp < 1:
        raise ValueError(f"ivf_scan_paged: kp must be >= 1 (got {kp})")
    if plan.pair_q.shape[0] != plan.ntiles * PT:
        raise ValueError(f"ivf_scan_paged: plan must be tiled by PT={PT}")
    if not 0 <= ta <= tb <= plan.ntiles:
        raise ValueError(f"ivf_scan_paged: bad tile range [{ta}, {tb})")
    _check(run_d, torch.float32, "run_d", dev)
    _check(run_p, torch.int32, "run_p", dev)
    if run_d.shape != (plan.ntiles * PT, kp) or run_p.shape != run_d.shape:
        raise ValueError("ivf_scan_paged: running results must be "
                         "(ntiles * PT, kp)")
    if tb == ta:
        return
    _launch(xq_bf16, qn, plan, window, w0, window.nblocks, ta, tb, run_d,
            run_p, similarity, window.block_size)


def _launch_fresh(xq_bf16: torch.Tensor, qn: torch.Tensor, plan: PairPlan,
                  window: Window, kp: int, similarity: bool, B: int):
    """`scan_window_wide`'s pair function on the card (`chip_smoke.py`
    times that route): one K4 launch over ``plan`` (window-local ranges in
    blocks of B rows) from empty running lists. Returns (dist, pos) of
    shape (ntiles * PT, kp), window-local positions."""
    dev = xq_bf16.device
    run_d = torch.full((plan.ntiles * PT, kp), float("inf"), device=dev)
    run_p = torch.full(run_d.shape, -1, dtype=torch.int32, device=dev)
    rows = window.nblocks * window.block_size
    _launch(xq_bf16, qn, plan, window, 0, rows // B, 0, plan.ntiles, run_d,
            run_p, similarity, B)
    return run_d, run_p


def _launch(xq_bf16, qn, plan: PairPlan, window: Window, w0: int, nwin: int,
            ta: int, tb: int, run_d, run_p, similarity: bool, B: int):
    """One K4 launch: tiles [ta, tb) of ``plan``, whose ranges count blocks
    of B rows, against the window's rows as blocks [w0, w0 + nwin) of B
    rows; any kp >= 1."""
    global LAUNCHES, LAUNCHES_WIDE, LAUNCHES_GLOBAL
    dev = xq_bf16.device
    if dev.type != "cuda":
        raise ValueError(f"ivf_scan_paged: unsupported device {dev}")
    dp = xq_bf16.shape[1]
    kp = run_d.shape[1]
    if window.data_bf16.shape[2] != dp or dp % 8:
        raise ValueError(f"ivf_scan_paged: the queries' width {dp} must be "
                         f"the window's and a multiple of 8")
    if kp < 1:
        raise ValueError(f"ivf_scan_paged: kp must be >= 1 (got {kp})")
    if (w0 + nwin) * B >= 2**31:
        raise ValueError("ivf_scan_paged: window exceeds int32 positions")
    _check(xq_bf16, torch.bfloat16, "xq_bf16", dev)
    _check(qn, torch.float32, "qn", dev)
    for name in ("pair_q", "pstart", "pend", "tile_bs", "tile_nb"):
        _check(getattr(plan, name), torch.int32, name, dev)
    _check(window.data_bf16, torch.bfloat16, "window data", dev)
    _check(window.ids, torch.int32, "window ids", dev)
    _check(window.norms, torch.float32, "window norms", dev)
    if window.data_bf16.data_ptr() % 16 or xq_bf16.data_ptr() % 16:
        raise ValueError("ivf_scan_paged: the window and the queries must "
                         "be 16-byte aligned (16-byte row copies)")
    err = _lib().ivf_scan_window(
        xq_bf16.data_ptr(), qn.data_ptr(), plan.pair_q.data_ptr(),
        plan.pstart.data_ptr(), plan.pend.data_ptr(),
        plan.tile_bs.data_ptr(), plan.tile_nb.data_ptr(),
        window.data_bf16.data_ptr(), window.ids.data_ptr(),
        window.norms.data_ptr(), w0, nwin, ta, tb - ta, dp, B, kp,
        int(similarity), run_d.data_ptr(), run_p.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_scan_paged: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    if kp > KP_MAX:
        LAUNCHES_GLOBAL += 1
    elif kp > KP_LANE:
        LAUNCHES_WIDE += 1


# ---------------------------------------------------------------------------
# the host side: staging, upload, re-rank gather
# ---------------------------------------------------------------------------

def _parallel(pool, n: int, fn) -> None:
    """fn(a, b) over a split of range(n) across the pool's threads (numpy
    copies release the interpreter lock)."""
    bounds = np.linspace(0, n, _COPY_THREADS + 1).astype(np.int64)
    futures = [pool.submit(fn, int(a), int(b))
               for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    for f in futures:
        f.result()


def _gather_rows(src: np.ndarray, idx: np.ndarray, out: np.ndarray,
                 pool) -> None:
    """out[i] = src[idx[i]] for sorted idx, split across the pool."""
    def take(a, b):
        np.take(src, idx[a:b], axis=0, out=out[a:b], mode="clip")

    _parallel(pool, len(idx), take)


def host_rows_at(pil: PagedInvLists, pos: torch.Tensor, pool):
    """The re-rank's row source for `merge_pairs`: the f32 rows and norms
    at stream positions ``pos`` (>= 0), read from the host store and put
    on pos.device. The device sorts and dedupes the positions; each is
    read once, in increasing order, by the pool's threads, into pinned
    memory on CUDA; the device puts the rows back in the order asked.
    Without the f32 store the rows come from the bf16 stream."""
    cuda = pos.device.type == "cuda"
    uniq, inv = torch.unique(pos.reshape(-1), sorted=True,
                             return_inverse=True)
    uniq = uniq.cpu().numpy()
    d = pil.d
    if pil.data_f32 is not None:
        src = pil.data_f32.reshape(-1, d)
        rows = torch.empty((len(uniq), d), dtype=torch.float32,
                           pin_memory=cuda)
        _gather_rows(src, uniq, rows.numpy(), pool)
    else:
        src = pil.data_bf16.reshape(-1, pil.dp)
        rows = torch.empty((len(uniq), pil.dp), dtype=torch.bfloat16,
                           pin_memory=cuda)
        _gather_rows(src, uniq,
                     rows.view(torch.int16).numpy().view(_BF16_BITS), pool)
    norms = torch.empty(len(uniq), dtype=torch.float32, pin_memory=cuda)
    _gather_rows(pil.norms.reshape(-1), uniq, norms.numpy(), pool)
    rows = rows.to(pos.device, non_blocking=cuda)[inv]
    norms = norms.to(pos.device, non_blocking=cuda)[inv]
    if rows.dtype != torch.float32:
        rows = rows[:, :d].float()
    return rows.view(*pos.shape, d), norms.view(pos.shape)


def host_ids_at(pil: PagedInvLists, pos: torch.Tensor) -> torch.Tensor:
    """The stored ids (int64) at stream positions ``pos`` (>= 0), from the
    host store."""
    ids = pil.ids.reshape(-1)[pos.cpu().numpy()]
    return torch.from_numpy(ids.astype(np.int64)).to(pos.device)


class _WindowPipeline:
    """Cold windows: memmap -> staging buffer -> device buffer, two of
    each (module docstring). A staging thread fills the host buffers in
    window order; `next` uploads the next one and returns its device
    window. On CUDA the host buffers are pinned and the upload runs on a
    side stream, gated by events; on the CPU the upload is a plain copy."""

    def __init__(self, pil: PagedInvLists, windows, nblk: int, device,
                 pool):
        self.pil, self.pool = pil, pool
        self.device = device
        self.cuda = device.type == "cuda"
        B, dp = pil.block_size, pil.dp
        shapes = ((nblk, B, dp), (nblk, B), (nblk, B))
        dtypes = (torch.bfloat16, torch.int32, torch.float32)

        def bufs(**kw):
            return [tuple(torch.empty(s, dtype=t, **kw)
                          for s, t in zip(shapes, dtypes)) for _ in range(2)]

        self.host = bufs(pin_memory=self.cuda)
        self.dev = bufs(device=device)
        self.bytes = 0
        self.stage_s = 0.0
        self.copy_events = []          # (start, end) of each upload
        if self.cuda:
            self.side = torch.cuda.Stream(device)
            self.scanned = [torch.cuda.Event(), torch.cuda.Event()]
        self.slot = None
        self._ready: queue.Queue = queue.Queue()
        self._free: queue.Queue = queue.Queue()
        for s in (0, 1):
            self._free.put((s, None))
        self._thread = threading.Thread(target=self._stage,
                                        args=(list(windows),), daemon=True)
        self._thread.start()

    def _fill(self, slot: int, w0: int) -> int:
        pil = self.pil
        n = min(self.host[slot][0].shape[0], pil.nblocks - w0)
        data, ids, norms = self.host[slot]
        dst = (data.view(torch.int16).numpy().view(_BF16_BITS), ids.numpy(),
               norms.numpy())
        srcs = (pil.data_bf16, pil.ids, pil.norms)

        def copy(a, b):
            for dd, ss in zip(dst, srcs):
                np.copyto(dd[a:b], ss[w0 + a:w0 + b])

        _parallel(self.pool, n, copy)
        return n

    def _stage(self, windows) -> None:
        try:
            if self.cuda:
                torch.cuda.set_device(self.device)
            for w0 in windows:
                token = self._free.get()
                if token is None:
                    return
                slot, copied = token
                if copied is not None:
                    copied.synchronize()    # the buffer's upload is done
                t0 = time.perf_counter()
                n = self._fill(slot, w0)
                self.stage_s += time.perf_counter() - t0
                self._ready.put((slot, w0, n))
        except BaseException as e:          # handed to the consumer
            self._ready.put(e)

    def next(self, w0: int) -> Window:
        item = self._ready.get()
        if isinstance(item, BaseException):
            raise RuntimeError("ivf_scan_paged: staging failed") from item
        slot, w, n = item
        if w != w0:
            raise RuntimeError("ivf_scan_paged: window plan drift")
        host, dev = self.host[slot], self.dev[slot]
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # the device buffer's last scan must be done before it is
            # overwritten
            self.side.wait_event(self.scanned[slot])
            with torch.cuda.stream(self.side):
                start.record()
                for a, b in zip(dev, host):
                    a[:n].copy_(b[:n], non_blocking=True)
                end.record()
            torch.cuda.current_stream(self.device).wait_event(end)
            self.copy_events.append((start, end))
            self._free.put((slot, end))
        else:
            for a, b in zip(dev, host):
                a[:n].copy_(b[:n])
            self._free.put((slot, None))
        self.bytes += sum(b[:n].nbytes for b in host)
        self.slot = slot
        return Window(*(a[:n] for a in dev))

    def scanned_current(self) -> None:
        """Every scan of the current window has been launched."""
        if self.cuda:
            self.scanned[self.slot].record()

    def upload_ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.copy_events)

    def close(self) -> None:
        self._free.put(None)
        self._thread.join()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scan_invlists_paged(
    xq,
    probes,
    pil: PagedInvLists,
    k: int,
    metric: int = D.METRIC_L2,
    *,
    PT: int = PT,
    TB: int = 4096,
    window_blocks: int = 8192,
    refine: int = 4,
    kp: int = 0,
    resident: Optional[Window] = None,
    stats: Optional[dict] = None,
    device="cuda",
):
    """Search host-resident invlists bigger than device memory (module
    docstring).

    Semantics match `ivf_scan_fused.scan_invlists_fused` over the same
    layout (the same per-pair top-kp, bf16 scan and exact f32 re-rank);
    capacity is bounded by host storage. ``xq`` (nq, d) is a numpy array,
    ``probes`` (nq, nprobe, -1 skipped) a numpy array or a tensor; the scan
    runs on ``device``, or on the resident prefix's device if ``resident``
    is given. TB (tiles
    per kernel launch) and window_blocks do not change the result; PT is
    fixed at 128 on CUDA. ``stats`` receives the reference's keys
    (windows, calls, bytes_uploaded, windows_resident) and the times
    stage_ms (the staging thread's host copies), upload_ms (the uploads'
    device time), windows_ms (the window loop, synchronised), gather_ms
    (the re-rank's host gather and upload) and rerank_ms (the rest of the
    merge).
    Returns (D (nq, k) f32, I (nq, k) int32 row ids, ndis) as numpy arrays
    and an int.
    """
    t_start = time.perf_counter()
    similarity = D.is_similarity_metric(metric)
    dev = resident.data_bf16.device if resident is not None \
        else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    xq = np.ascontiguousarray(xq, np.float32)
    nq, d = xq.shape
    nprobe = np.shape(probes)[1]
    if d != pil.d:
        raise ValueError(f"ivf_scan_paged: query dim {d} != index dim "
                         f"{pil.d}")
    if (pil.nblocks + 1) * pil.block_size >= 2**31:
        raise ValueError("ivf_scan_paged: stream exceeds int32 positions")
    W = int(window_blocks)
    kp = int(kp) if kp else default_kp(k)

    xq_t = torch.from_numpy(xq).to(dev)
    plan = plan_pairs(torch.as_tensor(probes, device=dev).long(), pil, PT)
    qn = torch.zeros(nq, device=dev) if similarity else D.l2_norms(xq_t)
    xq_p = torch.zeros((nq, pil.dp), device=dev)
    xq_p[:, :d] = xq_t
    xq16 = xq_p.to(torch.bfloat16)

    tile_bs = plan.tile_bs.long().cpu().numpy()
    tile_be = tile_bs + plan.tile_nb.long().cpu().numpy()
    entries = list(_plan_windows(tile_bs, tile_be, W, TB))
    rb = resident.nblocks if resident is not None else 0

    def is_resident(w0: int) -> bool:
        return min(w0 + W, pil.nblocks) <= rb

    windows = list(dict.fromkeys(w for w, _, _ in entries))
    cold = [w for w in windows if not is_resident(w)]

    run_d = torch.full((plan.ntiles * PT, kp), float("inf"), device=dev)
    run_p = torch.full((plan.ntiles * PT, kp), -1, dtype=torch.int32,
                       device=dev)
    gather_s = 0.0

    with concurrent.futures.ThreadPoolExecutor(_COPY_THREADS) as pool:
        pipe = (_WindowPipeline(pil, cold, min(W, pil.nblocks), dev, pool)
                if cold else None)
        try:
            cur = None
            for w0, ta, tb in entries:
                if w0 != cur:
                    if cur is not None and not is_resident(cur):
                        pipe.scanned_current()
                    win = (resident.blocks(w0, min(W, pil.nblocks - w0))
                           if is_resident(w0) else pipe.next(w0))
                    cur = w0
                scan_window(xq16, qn, plan, win, w0, ta, tb, run_d, run_p,
                            similarity)
        finally:
            if pipe is not None:
                pipe.close()
        if stats is not None:
            _sync(dev)
        t_windows = time.perf_counter()

        def rows_at(pos):
            nonlocal gather_s
            t0 = time.perf_counter()
            out = host_rows_at(pil, pos, pool)
            if stats is not None:
                _sync(dev)
            gather_s += time.perf_counter() - t0
            return out

        Dv, Iv = merge_pairs(xq_t, run_d, run_p, plan, k, nprobe, similarity,
                             refine, rows_at, lambda p: host_ids_at(pil, p))
        Dv, Iv = Dv.cpu().numpy(), Iv.cpu().numpy().astype(np.int32)
    if stats is not None:
        t_end = time.perf_counter()
        stats["windows"] = len(windows)
        stats["calls"] = len(entries)
        stats["bytes_uploaded"] = pipe.bytes if pipe is not None else 0
        stats["windows_resident"] = len(windows) - len(cold)
        stats["stage_ms"] = pipe.stage_s * 1e3 if pipe is not None else 0.0
        stats["upload_ms"] = pipe.upload_ms() if pipe is not None else 0.0
        stats["windows_ms"] = (t_windows - t_start) * 1e3
        stats["gather_ms"] = gather_s * 1e3
        stats["rerank_ms"] = (t_end - t_windows - gather_s) * 1e3
    return Dv, Iv, int(plan.ndis)
