"""List-major fused IVF scan — PyTorch counterpart of
`scan_invlists_fused` and `scan_invlists_fused_grid` in
`tpu_ann/ops/ivf_scan_pallas.py`, with its kernels hand-written in CUDA for
Hopper: K3 (``csrc/ivf_scan_fused.cu``) on a bf16 stream and K3-SQ8
(``csrc/ivf_scan_sq8.cu``) on the uint8 codes of a `PackedInvListsSQ8`.

With nq queries probing nprobe lists each, a query-major scan reads every
probed list once per (query, probe) pair. Sorting the pairs by list id and
tiling them instead lets one read of a list's rows feed every pair of the
tile on that list. Lists are packed contiguously in id order, so the pairs
of a sorted tile touch one contiguous range of blocks of the stream.

Steps (the wrapper is plain torch around one kernel launch):
  1. sort the pairs by list id (stable), compute each pair's block range
     [pstart, pend) and each tile's range [min pstart, max pend);
  2. the kernel (or, for CPU tensors, its plain version
     `scan_pairs_reference`) computes each pair's exact top-kp over its
     list with bf16 x bf16 -> f32 scores:
       L2: max(qn + ||x||^2 - 2 q.x, 0)      IP: -q.x - qn
     where qn is a per-query offset: ||q||^2 for L2 and 0 for IP on a bf16
     stream. On the SQ8 stream (x = bias + code * scale) the affine folds
     into the queries: q' = bf16(q * scale), rounded once, is multiplied by
     the codes, and qn = ||q||^2 - 2 q.bias for L2, q.bias for IP. Ties go
     to the lower stream position, empty slots are (+inf, -1);
  3. un-sort the pairs, merge per query to the top R candidates, re-rank
     them exactly in f32 against the stored rows (f32 storage, or the
     dequantized codes), map stream positions to row ids, and flip the sign
     back for IP.

The three steps run in the spans ``ivf.plan`` (with the queries' fold),
``ivf.kernel`` and ``ivf.merge`` (`tpu_ann_torch.trace`).

Each library holds three kernels, chosen by kp at launch: the per-pair
lists in registers, one entry a lane up to KP_LANE (32) and two up to
KP_MAX (64), and in the output rows themselves for any kp above (a search
at k >= 59). `scan_pairs_wide` computes the same per-pair top-kp another
way, from one launch over sub-blocks of at most 32 rows and a selection in
torch; no index route takes it, and `chip_smoke.py` times it beside the
kernels.

Unlike the reference, the per-pair top-kp is always exact: the reference's
RW=512 lane-min reservoir (which can drop candidates) exists only because
extraction rounds are expensive on the TPU's vector unit.

K3g (`scan_invlists_fused_grid`) computes the same function on a plan cut
to a static number of chunks per tile; it is served by the same kernels
(see its docstring).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..trace import span
from . import distances as D
from .ivf_scan import PackedInvLists, PackedInvListsSQ8

# pairs per tile: the CUDA kernel is written for this tile (kPT in the .cu)
PT = 128
# per-pair widths the CUDA kernels keep in registers (K3, K3-SQ8, K4):
# KP_LANE with one list entry a lane, KP_MAX with two; a wider kp keeps
# the lists in shared memory (in the output rows past 2969 at d 128).
# `scan_pairs_wide` scans sub-blocks of at most KP_LANE rows.
KP_LANE = 32
KP_MAX = 64
# kernel launches made by `scan_pairs` (one per call on a CUDA tensor):
# K3 on a bf16 stream, K3-SQ8 on a uint8 one; of them, those of the
# kernels with two list entries a lane (kp above KP_LANE up to KP_MAX)
# and of those whose lists live outside the registers (kp above KP_MAX)
LAUNCHES = 0
LAUNCHES_SQ8 = 0
LAUNCHES_WIDE = 0
LAUNCHES_GLOBAL = 0
# the plain version's batches of tiles stay under this many f32 elements
_PLAIN_BUDGET = 1 << 27


@dataclasses.dataclass
class PairPlan:
    """Sorted (query, probe) pairs and their tiles, all on one device.

    Per sorted pair (npairs padded to ntiles * PT): ``pair_q`` its query
    row, ``pstart``/``pend`` its list's block range (padding pairs and -1
    probes get an empty range). Per tile: ``tile_bs``/``tile_nb`` the block
    range its pairs span. ``order`` is the sort permutation of the
    flattened (nq * nprobe) pairs; ``ndis`` the scanned rows including
    block padding (the reference's count)."""

    order: torch.Tensor
    pair_q: torch.Tensor
    pstart: torch.Tensor
    pend: torch.Tensor
    tile_bs: torch.Tensor
    tile_nb: torch.Tensor
    ndis: torch.Tensor

    @property
    def ntiles(self) -> int:
        return self.tile_bs.shape[0]


def plan_pairs(probes: torch.Tensor, invlists, pt: int = PT) -> PairPlan:
    """Step 1: sort pairs by list id and compute pair and tile ranges.

    ``invlists`` is a PackedInvLists or any layout with the same
    ``list_nblocks`` (a tensor or a numpy array), ``nblocks`` and
    ``block_size`` (the out-of-core PagedInvLists)."""
    nq, nprobe = probes.shape
    npairs = nq * nprobe
    nblk = torch.as_tensor(invlists.list_nblocks, device=probes.device).long()
    # contiguous stream starts (empty lists get zero-width ranges)
    sstart = torch.cumsum(nblk, 0) - nblk
    l_flat = probes.reshape(npairs).long()
    order = torch.argsort(l_flat, stable=True)
    ls = l_flat[order]
    valid = ls >= 0
    ls_safe = torch.where(valid, ls, 0)
    p_start = torch.where(valid, sstart[ls_safe], 0)
    p_end = p_start + torch.where(valid, nblk[ls_safe], 0)
    pair_q = order // nprobe
    ndis = torch.where(l_flat >= 0, nblk[l_flat.clamp(min=0)], 0).sum() \
        * invlists.block_size
    return _tiled(order, p_start, p_end, pair_q, pt, invlists.nblocks, ndis)


def _tiled(order, p_start, p_end, pair_q, pt: int, nblocks: int,
           ndis) -> PairPlan:
    """The PairPlan of sorted pairs' ranges [p_start, p_end) (in blocks of
    the scan) and query rows: padded to whole tiles of ``pt`` pairs, with
    each tile's block range."""
    npairs = p_start.shape[0]
    ntiles = -(-npairs // pt)
    pad = ntiles * pt - npairs
    if pad:
        # padding pairs: empty range, query row 0
        z = p_start.new_zeros(pad)
        p_start, p_end, pair_q = (torch.cat([p_start, z]),
                                  torch.cat([p_end, z]),
                                  torch.cat([pair_q, z]))
    ps2 = p_start.view(ntiles, pt)
    pe2 = p_end.view(ntiles, pt)
    real = pe2 > ps2
    tile_be = torch.where(real, pe2, 0).amax(1) if ntiles else pe2[:, 0]
    tile_bs = torch.where(real, ps2, nblocks).amin(1) \
        if ntiles else ps2[:, 0]
    tile_bs = torch.minimum(tile_bs, tile_be)      # empty tile -> 0 length
    i32 = torch.int32
    return PairPlan(order=order, pair_q=pair_q.to(i32),
                    pstart=p_start.to(i32), pend=p_end.to(i32),
                    tile_bs=tile_bs.to(i32),
                    tile_nb=(tile_be - tile_bs).to(i32), ndis=ndis)


# ---------------------------------------------------------------------------
# Step 2: per-pair exact top-kp. `scan_pairs` launches the CUDA kernel on a
# CUDA tensor and takes the plain version only for a CPU tensor.
# ---------------------------------------------------------------------------

def stream_of(invlists) -> torch.Tensor:
    """The (nblocks+1, B, d) stream the kernels read: the uint8 codes of a
    `PackedInvListsSQ8`, else the bf16 rows."""
    if isinstance(invlists, PackedInvListsSQ8):
        return invlists.codes
    return invlists.data_bf16


def scan_pairs_reference(xq_bf16: torch.Tensor, qn: torch.Tensor,
                         plan: PairPlan, invlists: PackedInvLists, kp: int,
                         similarity: bool, B: int = 0):
    """Plain torch version of the kernels: the same per-pair top-kp. The
    plan's ranges count blocks of ``B`` rows (0: the lists' block size).

    Tiles are processed in batches whose gathered rows and scores stay
    under ``_PLAIN_BUDGET`` float32 elements. Scores are f32 products of the
    bf16 queries and the stream's rows widened to f32 (bf16 rows or uint8
    codes, both exact in f32): ``q.float() @ x.float().T``; a bf16 product
    would round the output on the CPU.
    Returns (dist (npairs_pad, kp) f32, pos (npairs_pad, kp) int32)."""
    dev = xq_bf16.device
    d = xq_bf16.shape[1]
    B = B or invlists.block_size
    data = stream_of(invlists).view(-1, d)
    ids = invlists.ids.view(-1)
    norms = invlists.norms.view(-1)
    ntiles = plan.ntiles
    pt = plan.pair_q.shape[0] // max(ntiles, 1)
    out_d = torch.full((ntiles * pt, kp), float("inf"), device=dev)
    out_p = torch.full((ntiles * pt, kp), -1, dtype=torch.int32, device=dev)
    nrows = (plan.tile_nb.long() * B).cpu()
    t0 = 0
    while t0 < ntiles:
        # widest batch of tiles whose padded rows fit the budget
        t1, maxr = t0 + 1, int(nrows[t0])
        while t1 < ntiles:
            m = max(maxr, int(nrows[t1]))
            if (t1 + 1 - t0) * max(m, 1) * (d + pt) > _PLAIN_BUDGET:
                break
            t1, maxr = t1 + 1, m
        T = t1 - t0
        if maxr == 0:
            t0 = t1
            continue
        lane = torch.arange(maxr, device=dev)
        base = plan.tile_bs[t0:t1].long()[:, None] * B
        rows = base + lane[None, :]                               # (T, maxr)
        inrange = lane[None, :] < (plan.tile_nb[t0:t1].long() * B)[:, None]
        rows_c = torch.where(inrange, rows, 0)
        x = data[rows_c].float()                                  # (T, maxr, d)
        pq = plan.pair_q[t0 * pt:t1 * pt].long()
        q = xq_bf16[pq].float().view(T, pt, d)
        ip = torch.bmm(q, x.transpose(1, 2))                      # (T, pt, maxr)
        pqn = qn[pq].view(T, pt, 1)
        if similarity:
            dis = -ip - pqn
        else:
            dis = torch.clamp(pqn + norms[rows_c][:, None, :] - 2.0 * ip,
                              min=0.0)
        lo = plan.pstart[t0 * pt:t1 * pt].long().view(T, pt, 1) * B
        hi = plan.pend[t0 * pt:t1 * pt].long().view(T, pt, 1) * B
        r3 = rows[:, None, :]
        ok = (r3 >= lo) & (r3 < hi) & (ids[rows_c] >= 0)[:, None, :] \
            & inrange[:, None, :]
        dis = torch.where(ok, dis, float("inf"))
        # stable sort: among equal scores the lower stream position wins
        vals, sel = torch.sort(dis, dim=2, stable=True)
        kk = min(kp, maxr)
        vals = vals[:, :, :kk].reshape(T * pt, kk)
        pos = torch.gather(r3.expand(T, pt, maxr), 2, sel[:, :, :kk])
        pos = torch.where(torch.isinf(vals), -1, pos.reshape(T * pt, kk))
        out_d[t0 * pt:t1 * pt, :kk] = vals
        out_p[t0 * pt:t1 * pt, :kk] = pos.to(torch.int32)
        t0 = t1
    return out_d, out_p


_LIBS: dict = {}


def _lib(name: str):
    """The bound kernel ``name`` (ivf_scan_fused: K3, ivf_scan_sq8:
    K3-SQ8); both have the same C signature."""
    if name not in _LIBS:
        from ..kernels import load_library

        lib = load_library(name)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 10 + [ci] * 5 + [vp] * 3
        fn.restype = ci
        tile = getattr(lib, name + "_tile_pairs")
        tile.argtypes = []
        tile.restype = ci
        if tile() != PT:
            raise RuntimeError(f"{name}: kernel tile size != PT")
        _LIBS[name] = fn
    return _LIBS[name]


def _check(t: torch.Tensor, dtype, name: str, dev) -> None:
    if t.dtype != dtype or t.device != dev or not t.is_contiguous():
        raise ValueError(f"ivf_scan_fused: {name} must be a contiguous "
                         f"{dtype} tensor on {dev} (got {t.dtype} on "
                         f"{t.device})")


def scan_pairs(xq_bf16: torch.Tensor, qn: torch.Tensor, plan: PairPlan,
               invlists: PackedInvLists, kp: int, similarity: bool):
    """Per-pair exact top-kp: for CUDA tensors one launch, over the plan
    itself at any kp, of the CUDA kernel of the stream's type (K3 on bf16
    rows, K3-SQ8 on uint8 codes); for CPU tensors the plain version.
    Returns (dist, pos) of shape (npairs_pad, kp)."""
    if xq_bf16.device.type == "cpu":
        return scan_pairs_reference(xq_bf16, qn, plan, invlists, kp,
                                    similarity)
    return _launch(xq_bf16, qn, plan, invlists, kp, similarity)


def _launch(xq_bf16: torch.Tensor, qn: torch.Tensor, plan: PairPlan,
            invlists: PackedInvLists, kp: int, similarity: bool,
            B: int = 0):
    """One launch of the kernel of the stream's type over ``plan``, whose
    ranges count blocks of ``B`` rows (0: the lists' block size); any kp
    >= 1."""
    global LAUNCHES, LAUNCHES_SQ8, LAUNCHES_WIDE, LAUNCHES_GLOBAL
    dev = xq_bf16.device
    if dev.type != "cuda":
        raise ValueError(f"ivf_scan_fused: unsupported device {dev}")
    d = xq_bf16.shape[1]
    B = B or invlists.block_size
    if d % 8:
        raise ValueError(f"ivf_scan_fused: d must be a multiple of 8 "
                         f"(got {d})")
    if kp < 1:
        raise ValueError(f"ivf_scan_fused: kp must be >= 1 (got {kp})")
    if (invlists.nblocks + 1) * invlists.block_size >= 2**31:
        raise ValueError("ivf_scan_fused: stream exceeds int32 positions")
    if plan.pair_q.shape[0] != plan.ntiles * PT:
        raise ValueError(f"ivf_scan_fused: plan must be tiled by PT={PT}")
    _check(xq_bf16, torch.bfloat16, "xq_bf16", dev)
    _check(qn, torch.float32, "qn", dev)
    for name in ("pair_q", "pstart", "pend", "tile_bs", "tile_nb"):
        _check(getattr(plan, name), torch.int32, name, dev)
    stream = stream_of(invlists)
    sq8 = stream.dtype == torch.uint8
    _check(stream, torch.uint8 if sq8 else torch.bfloat16, "stream", dev)
    if stream.shape[-1] != d:
        raise ValueError(f"ivf_scan_fused: stream rows have "
                         f"{stream.shape[-1]} dims, queries {d}")
    if stream.data_ptr() % 16 or xq_bf16.data_ptr() % 16:
        # 16-byte row copies of bf16, 8-byte ones of codes (d % 8 == 0)
        raise ValueError("ivf_scan_fused: the stream and the queries must "
                         "be 16-byte aligned")
    _check(invlists.ids, torch.int32, "ids", dev)
    _check(invlists.norms, torch.float32, "norms", dev)

    fn = _lib("ivf_scan_sq8" if sq8 else "ivf_scan_fused")
    out_d = torch.empty((plan.ntiles * PT, kp), dtype=torch.float32,
                        device=dev)
    out_p = torch.empty((plan.ntiles * PT, kp), dtype=torch.int32,
                        device=dev)
    if plan.ntiles == 0:
        return out_d, out_p
    err = fn(
        xq_bf16.data_ptr(), qn.data_ptr(), plan.pair_q.data_ptr(),
        plan.pstart.data_ptr(), plan.pend.data_ptr(),
        plan.tile_bs.data_ptr(), plan.tile_nb.data_ptr(),
        stream.data_ptr(), invlists.ids.data_ptr(),
        invlists.norms.data_ptr(),
        plan.ntiles, d, B, kp, int(similarity),
        out_d.data_ptr(), out_p.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_scan_fused: kernel launch failed with "
                           f"CUDA error {err}")
    if sq8:
        LAUNCHES_SQ8 += 1
    else:
        LAUNCHES += 1
    if kp > KP_MAX:
        LAUNCHES_GLOBAL += 1
    elif kp > KP_LANE:
        LAUNCHES_WIDE += 1
    return out_d, out_p


def sub_block_rows(B: int) -> int:
    """Rows of the sub-blocks `scan_pairs_wide` cuts lists of block size B
    into: B's largest divisor up to KP_LANE (the one-entry-a-lane
    kernel)."""
    return max(r for r in range(1, KP_LANE + 1) if B % r == 0)


def scan_pairs_wide(xq_bf16: torch.Tensor, qn: torch.Tensor, plan: PairPlan,
                    invlists, kp: int, similarity: bool, pair_fn):
    """Per-pair exact top-kp for any kp from at most ONE call of
    ``pair_fn`` (the kernel's `_launch`, or `scan_pairs_reference`), none
    when no pair has a row, and a selection in torch. No index route takes
    it: `chip_smoke.py` times it beside the kernels' one launch at kp above
    KP_MAX, and the tests hold it to the plain version. each pair's range is cut into sub-blocks of r =
    `sub_block_rows` rows, a sub-pair each that keeps all its rows; the
    sub-pairs, sorted by sub-block so that the pairs of one list share its
    reads, form a plan of their own. Each pair's top-kp is then taken from
    its sub-pairs' rows by (distance, stream position): sub-pairs come in
    stream order and each lists its rows by (distance, position), so a
    stable sort by distance keeps the lower position first on ties, as the
    per-pair scan does. The result equals `scan_pairs_reference` at kp.
    Returns (dist, pos) of shape (npairs_pad, kp)."""
    dev = xq_bf16.device
    r = sub_block_rows(invlists.block_size)
    s = invlists.block_size // r
    ps = plan.pstart.long() * s
    n = torch.clamp(plan.pend.long() * s - ps, min=0)   # sub-pairs a pair
    npp = n.shape[0]
    ends = torch.cumsum(n, 0)
    first = ends - n
    parent = torch.repeat_interleave(torch.arange(npp, device=dev), n)
    ns = parent.shape[0]
    sub = ps[parent] + torch.arange(ns, device=dev) - first[parent]
    out_d = torch.full((npp, kp), float("inf"), device=dev)
    out_p = torch.full((npp, kp), -1, dtype=torch.int32, device=dev)
    if ns == 0:
        return out_d, out_p
    order = torch.argsort(sub, stable=True)
    ss = sub[order]
    splan = _tiled(order, ss, ss + 1, plan.pair_q.long()[parent[order]], PT,
                   invlists.nblocks * s, plan.ndis)
    sd, sp = pair_fn(xq_bf16, qn, splan, invlists, r, similarity, B=r)
    cd = torch.empty((ns, r), dtype=sd.dtype, device=dev)
    cp = torch.empty((ns, r), dtype=sp.dtype, device=dev)
    cd[order] = sd[:ns]                # back to pair-major, stream order
    cp[order] = sp[:ns]
    # pairs in groups whose candidates stay under _PLAIN_BUDGET / 4
    step = max(_PLAIN_BUDGET // (4 * r), 1)
    ends_h = ends.cpu().numpy()
    p0 = 0
    while p0 < npp:
        s0 = int(ends_h[p0 - 1]) if p0 else 0
        p1 = max(int(np.searchsorted(ends_h, s0 + step, side="right")),
                 p0 + 1)
        s1 = int(ends_h[p1 - 1])
        if s1 > s0:
            fd = cd[s0:s1].reshape(-1)
            fp = cp[s0:s1].reshape(-1)
            fpar = parent[s0:s1].repeat_interleave(r)
            o = torch.sort(fd, stable=True)[1]
            o = o[torch.sort(fpar[o], stable=True)[1]]
            par = fpar[o]
            rank = torch.arange(o.shape[0], device=dev) - (first[par] - s0) * r
            keep = rank < kp
            out_d[par[keep], rank[keep]] = fd[o][keep]
            out_p[par[keep], rank[keep]] = fp[o][keep]
        p0 = p1
    return out_d, out_p


# ---------------------------------------------------------------------------
# Step 3 and the public entry points
# ---------------------------------------------------------------------------

def default_kp(k: int) -> int:
    """Per-pair width a bit above k, so the bf16 phase keeps every true
    top-k candidate for the exact re-rank (reference :327)."""
    return max(k, min(2 * k, k + 6))


def merge_pairs(xq: torch.Tensor, pair_dist: torch.Tensor,
                pair_pos: torch.Tensor, plan: PairPlan, k: int, nprobe: int,
                similarity: bool, refine: int, rows_at, ids_at):
    """Step 3: un-sort, merge per query, exact f32 re-rank, map positions
    to row ids. The stored rows come from ``rows_at(pos) -> (rows f32,
    norms f32)`` and ``ids_at(pos) -> int64 ids`` (positions >= 0, results
    on xq's device): `PackedInvLists.rows_at` / ``ids_at`` for the device
    layout, a host gather for the out-of-core one.
    Returns (D (nq, k) f32, I (nq, k) int64)."""
    nq = xq.shape[0]
    kp = pair_dist.shape[1]
    npairs = nq * nprobe
    pd = torch.empty((npairs, kp), dtype=pair_dist.dtype,
                     device=pair_dist.device)
    pp = torch.empty((npairs, kp), dtype=pair_pos.dtype,
                     device=pair_pos.device)
    pd[plan.order] = pair_dist[:npairs]
    pp[plan.order] = pair_pos[:npairs]
    pd = pd.view(nq, nprobe * kp)
    pp = pp.view(nq, nprobe * kp).long()
    width = nprobe * kp
    if refine and refine > 1:
        R = max(min(refine * k, width), min(k, width))
        sel = torch.sort(pd, dim=1, stable=True)[1][:, :R]
        cand = torch.gather(pp, 1, sel)                        # (nq, R)
        safe = cand.clamp(min=0)
        rows, rn = rows_at(safe)                               # (nq, R, d)
        ipx = torch.bmm(rows, xq[:, :, None])[:, :, 0]
        if similarity:
            dis = -ipx
        else:
            qn2 = (xq * xq).sum(1, keepdim=True)
            dis = torch.clamp(qn2 + rn - 2.0 * ipx, min=0.0)
        dis = torch.where(cand >= 0, dis, float("inf"))
        kk = min(k, R)
        out_d, sel2 = torch.sort(dis, dim=1, stable=True)
        out_d, out_p = out_d[:, :kk], torch.gather(cand, 1, sel2[:, :kk])
    else:
        kk = min(k, width)
        out_d, sel = torch.sort(pd, dim=1, stable=True)
        out_d, out_p = out_d[:, :kk], torch.gather(pp, 1, sel[:, :kk])
    if kk < k:
        out_d = torch.cat([out_d, out_d.new_full((nq, k - kk),
                                                 float("inf"))], 1)
        out_p = torch.cat([out_p, out_p.new_full((nq, k - kk), -1)], 1)
    out_i = torch.where(out_p >= 0, ids_at(out_p.clamp(min=0)), -1)
    out_d = torch.where(out_p >= 0, out_d, float("inf"))
    if similarity:
        out_d = -out_d                 # back to user-facing (descending)
    return out_d, out_i


def fold_queries(xq: torch.Tensor, invlists, similarity: bool):
    """The bf16 queries the kernel multiplies and the per-query offset qn
    (f32) for ``invlists``' stream (see the module docstring, step 2). On
    the SQ8 stream: <q, x> = <q, bias> + <q * scale, code>, with q * scale
    computed in f32 and rounded to bf16 once."""
    xq = xq.float()
    if isinstance(invlists, PackedInvListsSQ8):
        qconst = xq @ invlists.sq_bias
        q = (xq * invlists.sq_scale).to(torch.bfloat16)
        qn = qconst if similarity else D.l2_norms(xq) - 2.0 * qconst
    else:
        q = xq.to(torch.bfloat16)
        qn = torch.zeros(xq.shape[0], device=xq.device) if similarity \
            else D.l2_norms(xq)
    return q.contiguous(), qn.contiguous()


def _scan(xq, probes, invlists, k, metric, refine, kp, pair_fn, pt,
          cut=None):
    similarity = D.is_similarity_metric(metric)
    xq = xq.float()
    kp = int(kp) if kp else default_kp(k)
    with span("ivf.plan"):
        plan = plan_pairs(probes, invlists, pt)
        if cut is not None:
            plan = truncate_plan(plan, *cut)
        q, qn = fold_queries(xq, invlists, similarity)
    with span("ivf.kernel"):
        pd, pp = pair_fn(q, qn, plan, invlists, kp, similarity)
    with span("ivf.merge"):
        Dv, Iv = merge_pairs(xq, pd, pp, plan, k, probes.shape[1],
                             similarity, refine, invlists.rows_at,
                             invlists.ids_at)
    return Dv, Iv, plan.ndis


def scan_invlists_fused(xq: torch.Tensor, probes: torch.Tensor,
                        invlists: PackedInvLists, k: int,
                        metric: int = D.METRIC_L2, *, refine: int = 4,
                        kp: int = 0):
    """List-major fused IVF scan (see module docstring).

    Args:
      xq: (nq, d) queries on the invlists' device. invlists: a
        PackedInvLists (bf16 stream, K3) or a PackedInvListsSQ8 (uint8
        codes, K3-SQ8). probes: (nq, nprobe)
        list ids, -1 entries skipped. refine: the top refine*k merged
        candidates are re-ranked in exact f32 (refine <= 1 keeps the bf16
        distances). kp: per-pair width (0 = default_kp(k)), any kp >= 1
        in one launch.
    Returns (D, I, ndis): (nq, k) distances and stored row ids (int64,
    -1 for empty slots) and the scanned row count as a 0-d tensor.
    """
    return _scan(xq, probes, invlists, k, metric, refine, kp, scan_pairs, PT)


def scan_invlists_fused_reference(xq: torch.Tensor, probes: torch.Tensor,
                                  invlists: PackedInvLists, k: int,
                                  metric: int = D.METRIC_L2, *,
                                  refine: int = 4, kp: int = 0,
                                  pt: int = PT, maxc: int = 0, CB: int = 8):
    """`scan_invlists_fused` with the plain version in place of the kernels
    on any device; the result does not depend on the tile size ``pt``.
    ``maxc`` > 0 scans K3g's cut plan instead (`truncate_plan`), as
    `scan_invlists_fused_grid` does."""
    return _scan(xq, probes, invlists, k, metric, refine, kp,
                 scan_pairs_reference, pt, cut=(maxc, CB) if maxc else None)


# ---------------------------------------------------------------------------
# K3g: the 2-D grid schedule's function (reference :629-870)
# ---------------------------------------------------------------------------

def truncate_plan(plan: PairPlan, maxc: int, CB: int = 8) -> PairPlan:
    """K3g's cut of a plan: each tile's block range ends with the maxc-th
    CB-block chunk from the chunk that holds its first block, i.e. becomes
    [tile_bs, min(tile_bs + tile_nb, (tile_bs // CB + maxc) * CB)) — the
    reference's truncation "from the far end" (:725-728). Pair ranges are
    clipped to their tile's."""
    bs = plan.tile_bs.long()
    end = torch.minimum(bs + plan.tile_nb.long(), (bs // CB + maxc) * CB)
    nb = torch.clamp(end - bs, min=0)
    pt = plan.pair_q.shape[0] // max(plan.ntiles, 1)
    pend = torch.minimum(plan.pend.long(), (bs + nb).repeat_interleave(pt))
    pstart = torch.minimum(plan.pstart.long(), pend)
    i32 = torch.int32
    return dataclasses.replace(plan, pstart=pstart.to(i32),
                               pend=pend.to(i32), tile_nb=nb.to(i32))


def scan_invlists_fused_grid(xq: torch.Tensor, probes: torch.Tensor,
                             invlists, k: int, metric: int = D.METRIC_L2,
                             *, maxc: int, PT: int = PT, CB: int = 8,
                             refine: int = 4, kp: int = 0, RW: int = 512):
    """K3g: the reference's 2-D grid scan (tile x chunk), which gives every
    tile a static ``maxc`` chunk steps of CB blocks from its CB-aligned
    start; a tile range longer than that is cut from the far end
    (`truncate_plan`). ``grid2d_maxc`` sizes maxc so that nothing is cut.

    The cut plan goes through the same kernels as `scan_invlists_fused`
    (K3 on a bf16 stream, K3-SQ8 on uint8 codes) and the same merge, so the
    result is K3's over the cut ranges. Ignored arguments: ``RW`` (the
    reference's lane-min reservoir, which can drop candidates; the per-pair
    top-kp here is exact). The grid, its static step count and Mosaic's
    automatic pipelining of the chunk fetches are TPU schedule choices:
    the kernels walk each tile's range with a runtime loop, so ``maxc``
    only sets the cut. ``PT`` tiles the plan; the CUDA kernels take 128.
    Same returns as `scan_invlists_fused` (ndis counts the whole probed
    lists, as the reference's)."""
    del RW
    return _scan(xq, probes, invlists, k, metric, refine, kp, scan_pairs,
                 PT, cut=(maxc, CB))


def grid2d_maxc(invlists, probes_np, PT: int = PT, CB: int = 8,
                slack: int = 1) -> int:
    """Static per-tile chunk bound for `scan_invlists_fused_grid`: the
    max CB-chunk span over the pair tiles of THIS probe layout, host-
    computed, plus ``slack``, bucketed to the next power of two (the
    reference's ints, :837-871)."""
    if isinstance(probes_np, torch.Tensor):
        probes_np = probes_np.cpu().numpy()
    probes_np = np.asarray(probes_np)
    nblk = np.asarray(torch.as_tensor(invlists.list_nblocks).cpu())
    sstart = np.cumsum(nblk) - nblk
    npairs = probes_np.size
    l_flat = probes_np.reshape(-1).astype(np.int64)
    order = np.argsort(l_flat, kind="stable")
    ls = l_flat[order]
    valid = ls >= 0
    lss = np.where(valid, ls, 0)
    p_start = np.where(valid, sstart[lss], 0)
    p_end = p_start + np.where(valid, nblk[lss], 0)
    ntiles = -(-npairs // PT)
    pad = ntiles * PT - npairs
    if pad:
        p_start = np.pad(p_start, (0, pad))
        p_end = np.pad(p_end, (0, pad))
    ps = p_start.reshape(ntiles, PT)
    pe = p_end.reshape(ntiles, PT)
    w = pe - ps
    bs = np.where(w > 0, ps, np.iinfo(np.int64).max).min(1)
    be = np.where(w > 0, pe, 0).max(1)
    bs = np.minimum(bs, be)
    c0 = bs // CB
    spans = np.maximum(be - c0 * CB, 0)
    mc = int(-(-spans.max(initial=1) // CB)) + slack
    p2 = 1
    while p2 < mc:
        p2 *= 2
    return p2
