"""Fused flat k-NN — PyTorch counterpart of `tpu_ann/ops/flat_knn_pallas.py`,
with its two kernels hand-written in CUDA for Hopper:
``csrc/flat_knn_fused.cu`` (K1, the reservoir scan) and
``csrc/reservoir_topk.cu`` (K2, the per-row top-k of a reservoir).

The brute-force scan never writes the (nq, nb) score matrix. Each query
keeps a W-wide "lane-min" reservoir: row r of the database goes to lane
r mod W, and lane j holds the best row among those mapped to it (strict
``<``, so on a tie the earlier row stays). A true top-k entry is lost only
when two of the true best collide in one lane; the caller then selects
refine*k candidates from the reservoir and re-ranks them in exact f32, or,
on integer data where the bf16 scores are exact, selects k straight away.

Steps of `flat_knn_fused`:
  1. the database is packed once (`pack_flat_db`): bf16 rows zero-padded to
     dp = d rounded up to 16 (the tensor-core depth), and an f32 bias plane
     (L2: ||x||^2, IP: 0; +inf for padding, rows >= valid_n and masked
     rows). Queries are pre-scaled (-2q for L2, -q for IP) and cast to bf16,
     so a score is just bias + q'.x, and ||q||^2 is dropped (it cannot
     change a query's order);
  2. K1 (`flat_reservoir`; plain version `flat_reservoir_reference`) folds
     every score into the (nq, W) reservoir of values and row positions;
  3. K2 (`reservoir_topk`; plain version `reservoir_topk_reference`) or a
     stable sort selects the candidates; the epilogue re-ranks them in
     exact f32 (refine > 1) or adds ||q||^2 back (refine <= 1).

The wrappers take the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. The reference's schedules (grid / fori /
pipe, unroll) and merges (serial / tree) are loop strategies of the TPU
kernel that compute the same reservoir; here the one K1 kernel serves all
of them. ``merge="packed"`` computes a different reservoir: K1p
(`flat_reservoir_packed`, ``csrc/flat_knn_variants.cu``) keeps one int32 a
lane, the top 16 bits of a shifted score and its group index, folded with
one integer min (grid and fori at any unroll: a min over the reference's U
accumulators is the min over one).

`flat_probe_scan` (B1, the same library) runs the flat-kernel ceiling
ladder of the round-4 harness: K1's products with the fold cut to the
first group of every chunk ("min1"), a plain lane-min of every group
("minall") or K1's own fold ("serial").
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import distances as D

# kernel launches made by `flat_reservoir` (K1), `reservoir_topk` (K2),
# `flat_reservoir_packed` (K1p) and `flat_probe_scan` (B1, one count per
# fold)
LAUNCHES = {"flat_knn_fused": 0, "reservoir_topk": 0, "flat_knn_packed": 0,
            "flat_probe_min1": 0, "flat_probe_minall": 0,
            "flat_probe_serial": 0}
# widest reservoir and largest k the K2 kernel takes
TOPK_W_MAX = 4096
TOPK_K_MAX = 128
# widest padded dimension the K1 kernel keeps in shared memory, and its
# CTA tile: queries x reservoir lanes
DP_MAX = 1024
_CTA_Q, _CTA_LANES = 64, 128
# the plain reservoir's score blocks: queries x rows per block
_PLAIN_Q, _PLAIN_ROWS = 1024, 8192

# K1p's reservoir: the empty lane, the mask of a score's top 16 bits, and
# the most groups its low 16 bits can name
PACKED_INIT = 0x7FFFFFFF
HI_MASK = -65536                        # 0xFFFF0000 as int32
PACKED_GROUPS_MAX = 65536
# B1's folds, in the C entry point's numbering
PROBE_FOLDS = ("min1", "minall", "serial")

SCHEDULES = ("grid", "fori", "pipe")
MERGES = ("serial", "tree", "packed")
SELECTS = ("exact", "approx", "kernel")


def padded_dim(d: int) -> int:
    """d rounded up to the tensor-core depth (16 bf16 values)."""
    return -(-d // 16) * 16


def pack_flat_db(xb: torch.Tensor, metric: int = D.METRIC_L2, *,
                 xb_norms: Optional[torch.Tensor] = None,
                 valid_n: Optional[int] = None, R: int = 8192,
                 unroll: int = 1):
    """The fused scan's streamed database layout, built once per database.

    Returns (data, bias):
      data: (nchunks, R, dp) bf16, zero-padded rows and dimensions;
      bias: (nchunks, 1, R) f32, L2 row norms or IP zeros; +inf for padded
        rows and rows >= valid_n (valid_n is baked in: repack after adds).
    """
    nb, d = xb.shape
    dp = padded_dim(d)
    dev = xb.device
    if D.is_similarity_metric(metric):
        bias = torch.zeros(nb, dtype=torch.float32, device=dev)
    else:
        bias = D.l2_norms(xb) if xb_norms is None else xb_norms.float()
    if valid_n is not None:
        rows = torch.arange(nb, device=dev)
        bias = torch.where(rows < int(valid_n), bias, float("inf"))
    nchunks = max(-(-nb // R), 1)
    if unroll > 1:
        nchunks = -(-nchunks // unroll) * unroll
    data = torch.zeros((nchunks * R, dp), dtype=torch.bfloat16, device=dev)
    data[:nb, :d] = xb.to(torch.bfloat16)
    bias_p = torch.full((nchunks * R,), float("inf"), device=dev)
    bias_p[:nb] = bias
    return data.view(nchunks, R, dp), bias_p.view(nchunks, 1, R)


# ---------------------------------------------------------------------------
# K1: the reservoir scan
# ---------------------------------------------------------------------------

def flat_reservoir_reference(qv: torch.Tensor, data: torch.Tensor,
                             bias: torch.Tensor, W: int):
    """Plain torch version of K1: the same (nq, W) lane-min reservoir.

    Scores are f32 products of the bf16 operands
    (``qv.float() @ x.float().T``, as the kernel's f32 accumulation), plus
    the bias. Blocks of _PLAIN_Q queries x _PLAIN_ROWS rows bound the
    memory. Within a block, each lane's minimum over its groups takes the
    first group on a tie; across blocks a strict ``<`` keeps the earlier
    row. Returns (values f32, positions int32), (+inf, -1) where no finite
    score reached a lane."""
    nq = qv.shape[0]
    dp = data.shape[-1]
    x = data.reshape(-1, dp)
    b = bias.reshape(-1)
    n = x.shape[0]
    rows = max(_PLAIN_ROWS // W, 1) * W
    dev = qv.device
    resv = torch.full((nq, W), float("inf"), device=dev)
    resp = torch.full((nq, W), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(W, dtype=torch.int32, device=dev)
    for q0 in range(0, nq, _PLAIN_Q):
        q = qv[q0:q0 + _PLAIN_Q].float()
        av, ap = resv[q0:q0 + _PLAIN_Q], resp[q0:q0 + _PLAIN_Q]
        for r0 in range(0, n, rows):
            xr = x[r0:r0 + rows]
            s = (b[r0:r0 + rows][None, :] + q @ xr.float().T).view(
                len(q), -1, W)
            m = s.amin(dim=1)
            g = (s == m[:, None, :]).to(torch.uint8).argmax(dim=1)
            upd = m < av
            av.copy_(torch.where(upd, m, av))
            ap.copy_(torch.where(upd, (r0 + g * W + lane).to(torch.int32),
                                 ap))
    return resv, resp


def _plain_blocks(qv: torch.Tensor, data: torch.Tensor, bias: torch.Tensor,
                  W: int):
    """The plain versions' score blocks: yields (q0, g0, s) with s the
    (queries, groups, W) f32 scores ``bias + qv.float() @ x.float().T`` of
    _PLAIN_Q queries from q0 and whole groups from group g0."""
    nq = qv.shape[0]
    dp = data.shape[-1]
    x = data.reshape(-1, dp)
    b = bias.reshape(-1)
    rows = max(_PLAIN_ROWS // W, 1) * W
    for q0 in range(0, nq, _PLAIN_Q):
        q = qv[q0:q0 + _PLAIN_Q].float()
        for r0 in range(0, x.shape[0], rows):
            s = b[r0:r0 + rows][None, :] + q @ x[r0:r0 + rows].float().T
            yield q0, r0 // W, s.view(len(q), -1, W)


def flat_reservoir_packed_reference(qv: torch.Tensor, data: torch.Tensor,
                                    bias: torch.Tensor, W: int):
    """Plain torch version of K1p: the (nq, W) int32 packed reservoir,
    min over groups g of (bits(score) & 0xFFFF0000) + g from PACKED_INIT,
    with K1's f32 scores (the bias already shifted by the caller)."""
    acc = torch.full((qv.shape[0], W), PACKED_INIT, dtype=torch.int32,
                     device=qv.device)
    for q0, g0, s in _plain_blocks(qv, data, bias, W):
        g = torch.arange(g0, g0 + s.shape[1], dtype=torch.int32,
                         device=s.device)
        bits = s.contiguous().view(torch.int32)
        packed = (bits & HI_MASK) + g[None, :, None]
        a = acc[q0:q0 + s.shape[0]]
        a.copy_(torch.minimum(a, packed.amin(dim=1)))
    return acc


def packed_shift(xq: torch.Tensor, xb: torch.Tensor,
                 similarity: bool) -> torch.Tensor:
    """K1p's shift C, added to every score so it is non-negative and its
    f32 bits order like the value as int32 (reference :619-644): max||q||^2
    + 1 for L2, sqrt(max||q||^2) sqrt(max||x||^2) + 1 for IP. A constant
    over the batch changes no query's order."""
    xq = xq.float()
    qn_max = (xq * xq).sum(1).max()
    if not similarity:
        return qn_max + 1.0
    return torch.sqrt(qn_max) * torch.sqrt((xb.float() ** 2).sum(1).max()) \
        + 1.0


def decode_packed(acc: torch.Tensor, W: int, C):
    """K1p's reservoir as K1's (values f32, positions int32): value =
    bits(acc & 0xFFFF0000) - C, position = (acc & 0xFFFF) * W + lane;
    (+inf, -1) for lanes no finite score reached (reference :755-761)."""
    val = (acc & HI_MASK).view(torch.float32)
    lane = torch.arange(W, dtype=torch.int32, device=acc.device)
    pos = (acc & 0xFFFF) * W + lane
    alive = torch.isfinite(val) & (acc != PACKED_INIT)
    return (torch.where(alive, val - C, float("inf")),
            torch.where(alive, pos, -1))


def flat_probe_scan_reference(qv: torch.Tensor, data: torch.Tensor,
                              bias: torch.Tensor, W: int,
                              fold: str = "min1"):
    """Plain torch version of B1 (see `flat_probe_scan`)."""
    if fold == "serial":
        return flat_reservoir_reference(qv, data, bias, W)
    gpc = data.shape[1] // W
    resv = torch.full((qv.shape[0], W), float("inf"), device=qv.device)
    for q0, g0, s in _plain_blocks(qv, data, bias, W):
        if fold == "min1":
            g = torch.arange(g0, g0 + s.shape[1], device=s.device)
            s = s[:, g % gpc == 0]
        if s.shape[1]:
            a = resv[q0:q0 + s.shape[0]]
            a.copy_(torch.minimum(a, s.amin(dim=1)))
    return resv, torch.full(resv.shape, -1, dtype=torch.int32,
                            device=qv.device)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
# each C entry point's arguments: pointers and the stream as void*, ints
_ARGTYPES = {
    "flat_knn_fused": [_VP] * 3 + [_CI] * 4 + [_VP] * 3,
    "reservoir_topk": [_VP] * 2 + [_CI] * 3 + [_VP] * 3,
    "flat_knn_packed": [_VP] * 3 + [_CI] * 4 + [_VP] * 2,
    "flat_probe_scan": [_VP] * 3 + [_CI] * 6 + [_VP] * 3,
}
# the library (csrc/<library>.cu) of each entry point not in its own
_LIBRARY = {"flat_knn_packed": "flat_knn_variants",
            "flat_probe_scan": "flat_knn_variants"}
_FNS: dict = {}


def _fn(name: str):
    """Build the library of entry point ``name`` and bind it (once per
    process)."""
    if name not in _FNS:
        from ..kernels import load_library

        fn = getattr(load_library(_LIBRARY.get(name, name)), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _CI
        _FNS[name] = fn
    return _FNS[name]


def _check(t: torch.Tensor, dtype, name: str, dev, kernel: str) -> None:
    if t.dtype != dtype or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous {dtype} "
                         f"tensor on {dev} (got {t.dtype} on {t.device})")


def _check_scan(qv: torch.Tensor, data: torch.Tensor, bias: torch.Tensor,
                W: int, kernel: str):
    """The CUDA scan's argument checks (K1, K1p, B1); returns (nq, n, dp)
    with n the packed rows."""
    dev = qv.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {dev}")
    nq, dp = qv.shape
    if data.shape[-1] != dp or dp % 16 or not 0 < dp <= DP_MAX:
        raise ValueError(f"{kernel}: dp must be a multiple of 16 in "
                         f"(0, {DP_MAX}], the same for queries and data "
                         f"(got {dp} and {data.shape[-1]})")
    n = data.numel() // dp                      # packed rows
    if W % 128 or n % W or bias.numel() != n:
        raise ValueError(f"{kernel}: W={W} must be a multiple of 128 "
                         f"dividing the {n} packed rows, with one bias each")
    ctas = -(-nq // _CTA_Q) * (W // _CTA_LANES)
    if max(n, nq + _CTA_Q, ctas) >= 2**31:
        raise ValueError(f"{kernel}: rows, queries or CTAs exceed int32")
    _check(qv, torch.bfloat16, "qv", dev, kernel)
    _check(data, torch.bfloat16, "data", dev, kernel)
    _check(bias, torch.float32, "bias", dev, kernel)
    return nq, n, dp


def _launched(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES[kernel] += 1


def flat_reservoir(qv: torch.Tensor, data: torch.Tensor, bias: torch.Tensor,
                   W: int):
    """K1: the (nq, W) lane-min reservoir of pre-scaled bf16 queries ``qv``
    (nq, dp) over the packed ``data`` (nchunks, R, dp) and ``bias``
    (nchunks, 1, R). The CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns (values f32, positions int32)."""
    dev = qv.device
    if dev.type == "cpu":
        return flat_reservoir_reference(qv, data, bias, W)
    nq, n, dp = _check_scan(qv, data, bias, W, "flat_knn_fused")
    fn = _fn("flat_knn_fused")
    resv = torch.empty((nq, W), dtype=torch.float32, device=dev)
    resp = torch.empty((nq, W), dtype=torch.int32, device=dev)
    if nq == 0:
        return resv, resp
    _launched(fn(qv.data_ptr(), data.data_ptr(), bias.data_ptr(), nq, n, dp,
                 W, resv.data_ptr(), resp.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream),
              "flat_knn_fused")
    return resv, resp


def _check_groups(n: int, W: int) -> None:
    if n // W > PACKED_GROUPS_MAX:
        raise ValueError(f"merge='packed' holds the group index in 16 bits: "
                         f"nb must be <= {PACKED_GROUPS_MAX}*W rows "
                         f"({n // W} groups at W={W})")


def flat_reservoir_packed(qv: torch.Tensor, data: torch.Tensor,
                          bias: torch.Tensor, W: int) -> torch.Tensor:
    """K1p: the (nq, W) int32 packed reservoir (see the module docstring;
    ``bias`` already shifted so every score is non-negative, at most
    65536 groups of W rows). The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; `decode_packed` turns it into values and
    positions."""
    dev = qv.device
    _check_groups(data.numel() // data.shape[-1], W)
    if dev.type == "cpu":
        return flat_reservoir_packed_reference(qv, data, bias, W)
    nq, n, dp = _check_scan(qv, data, bias, W, "flat_knn_packed")
    fn = _fn("flat_knn_packed")
    out = torch.empty((nq, W), dtype=torch.int32, device=dev)
    if nq == 0:
        return out
    _launched(fn(qv.data_ptr(), data.data_ptr(), bias.data_ptr(), nq, n, dp,
                 W, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream),
              "flat_knn_packed")
    return out


def flat_probe_scan(qv: torch.Tensor, data: torch.Tensor, bias: torch.Tensor,
                    W: int, fold: str = "min1"):
    """B1, the flat-kernel ceiling probes (benchs/r4/r4_queue4.py:133-141):
    K1's products over the packed ``data`` (nchunks, R, dp) with the fold
    ``fold``:
      "min1":   the f32 lane-min of the first W-wide group of every R-row
                chunk only (groups g % (R / W) == 0), positions -1;
      "minall": the f32 lane-min of every group, positions -1;
      "serial": K1's reservoir (values and positions).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Returns (values f32, positions int32), each (nq, W)."""
    if fold not in PROBE_FOLDS:
        raise ValueError(f"flat_probe_scan: unknown fold {fold!r}")
    if data.dim() != 3 or data.shape[1] % W:
        raise ValueError(f"flat_probe_scan: data must be (nchunks, R, dp) "
                         f"with R % W == 0 (got {tuple(data.shape)}, W={W})")
    dev = qv.device
    if dev.type == "cpu":
        return flat_probe_scan_reference(qv, data, bias, W, fold)
    nq, n, dp = _check_scan(qv, data, bias, W, "flat_probe_scan")
    fn = _fn("flat_probe_scan")
    resv = torch.empty((nq, W), dtype=torch.float32, device=dev)
    resp = torch.empty((nq, W), dtype=torch.int32, device=dev)
    if nq == 0:
        return resv, resp
    _launched(fn(qv.data_ptr(), data.data_ptr(), bias.data_ptr(), nq, n, dp,
                 W, data.shape[1] // W, PROBE_FOLDS.index(fold),
                 resv.data_ptr(), resp.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream),
              "flat_probe_" + fold)
    return resv, resp


# ---------------------------------------------------------------------------
# K2: per-row top-k of a reservoir
# ---------------------------------------------------------------------------

def reservoir_topk_reference(resv: torch.Tensor, resp: torch.Tensor, k: int):
    """Plain torch version of K2: each row's k smallest (value, position),
    ascending; a stable sort lets the lowest lane win a tie. Non-finite
    values give (+inf, -1)."""
    vals, sel = torch.sort(resv, dim=1, stable=True)
    vals, pos = vals[:, :k], torch.gather(resp, 1, sel[:, :k])
    ok = torch.isfinite(vals)
    return (torch.where(ok, vals, float("inf")),
            torch.where(ok, pos, -1))


def reservoir_topk(resv: torch.Tensor, resp: torch.Tensor, k: int):
    """K2: (nq, W) reservoir -> (nq, k) smallest (values f32, positions
    int32). The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    dev = resv.device
    if dev.type == "cpu":
        return reservoir_topk_reference(resv, resp, k)
    if dev.type != "cuda":
        raise ValueError(f"reservoir_topk: unsupported device {dev}")
    nq, W = resv.shape
    if not 1 <= k <= min(TOPK_K_MAX, W) or not 0 < W <= TOPK_W_MAX:
        raise ValueError(f"reservoir_topk: needs 1 <= k <= "
                         f"min({TOPK_K_MAX}, W) and W <= {TOPK_W_MAX} "
                         f"(got k={k}, W={W})")
    if resp.shape != resv.shape:
        raise ValueError("reservoir_topk: values and positions differ in "
                         "shape")
    _check(resv, torch.float32, "resv", dev, "reservoir_topk")
    _check(resp, torch.int32, "resp", dev, "reservoir_topk")
    fn = _fn("reservoir_topk")
    outv = torch.empty((nq, k), dtype=torch.float32, device=dev)
    outp = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return outv, outp
    _launched(fn(resv.data_ptr(), resp.data_ptr(), nq, W, k, outv.data_ptr(),
                 outp.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
              "reservoir_topk")
    return outv, outp


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def _stable_topk(vals: torch.Tensor, pos: torch.Tensor, k: int):
    """k smallest values and their positions; the lower column wins a tie
    (as ``lax.top_k`` of the negated values)."""
    v, sel = torch.sort(vals, dim=1, stable=True)
    return v[:, :k], torch.gather(pos, 1, sel[:, :k])


def flat_knn_fused(
    xq: torch.Tensor,
    xb: torch.Tensor,
    k: int,
    metric: int = D.METRIC_L2,
    *,
    xb_norms: Optional[torch.Tensor] = None,
    valid_n: Optional[int] = None,
    id_mask: Optional[torch.Tensor] = None,
    packed=None,
    Q: int = 256,
    R: int = 2048,
    W: int = 1024,
    refine: int = 4,
    schedule: str = "fori",
    unroll: int = 1,
    merge: str = "serial",
    sel: str = "exact",
    sel_recall: float = 0.95,
):
    """Fused brute-force k-NN (see the module docstring).

    Args:
      xq: (nq, d) queries. xb: (nb, d) database (streamed as bf16; the
        re-rank reads it as f32). xb_norms: optional (nb,) ||x||^2.
      valid_n / id_mask: as in `ops.distances.knn`; both fold into the
        bias plane.
      packed: optional `pack_flat_db(xb, ..., R=R)` result, built with
        valid_n baked in; an id_mask still composes per call.
      Q / R / W: query tile, database chunk and reservoir width of the
        reference's layout; R % W == 0, W % 128 == 0, k <= W. Q and R do
        not change the result (the reservoir depends on W alone).
      refine: > 1 re-ranks refine*k reservoir candidates in exact f32;
        0 / 1 returns the reservoir's bf16 scores.
      schedule, unroll, merge ('serial' / 'tree'): the reference's loop
        strategies, all served by the one K1 kernel (same reservoir);
        merge='packed' runs K1p instead (schedule 'grid' or 'fori', any
        unroll; at most 65536 groups of W rows): the bias is shifted by
        C (max||q||^2 + 1 for L2, sqrt(max||q||^2) sqrt(max||x||^2) + 1
        for IP) so every score is non-negative, and the decoded values
        keep the top 16 bits of each score.
      sel: 'kernel' selects with K2 when the width is <= 128; 'exact' and
        'approx' (no approximate select in torch; sel_recall is unused)
        take a stable sort.
    Returns (D, I): (nq, k) L2 ascending distances / IP descending
      similarities, int64 row ids (-1 and the worst value on empty slots).
    """
    del sel_recall
    if R % W or W % 128 or k > W or Q <= 0:
        raise ValueError(f"flat_knn_fused: needs R % W == 0, W % 128 == 0, "
                         f"k <= W and Q > 0 (got Q={Q}, R={R}, W={W}, k={k})")
    if schedule not in SCHEDULES or merge not in MERGES or sel not in SELECTS:
        raise ValueError(f"flat_knn_fused: unknown schedule / merge / sel "
                         f"{schedule!r} / {merge!r} / {sel!r}")
    if merge == "packed" and schedule not in ("grid", "fori"):
        raise ValueError("flat_knn_fused: merge='packed' takes schedule "
                         "'grid' or 'fori'")
    nq, d = xq.shape
    nb = xb.shape[0]
    dp = padded_dim(d)
    similarity = D.is_similarity_metric(metric)
    xq = xq.float()

    if packed is not None:
        data, bias_p = packed
        if data.shape[1] != R or data.shape[2] != dp:
            raise ValueError(f"flat_knn_fused: packed layout {tuple(data.shape)}"
                             f" mismatches R={R}, dp={dp}")
        if valid_n is not None:
            raise ValueError("flat_knn_fused: bake valid_n into pack_flat_db")
    else:
        data, bias_p = pack_flat_db(xb, metric, xb_norms=xb_norms,
                                    valid_n=valid_n, R=R)
    if id_mask is not None:
        # per-call selector: rebuild only the bias plane
        keep = torch.zeros(bias_p.numel(), dtype=torch.bool, device=xq.device)
        keep[:nb] = id_mask[:nb] != 0
        bias_p = torch.where(keep, bias_p.reshape(-1), float("inf")).view(
            bias_p.shape)

    # pre-scale so the in-kernel score is bias + dot; ||q||^2 comes back
    # only when the reservoir values are returned un-refined
    qv = torch.zeros((nq, dp), dtype=torch.float32, device=xq.device)
    qv[:, :d] = (-1.0 if similarity else -2.0) * xq
    qv = qv.to(torch.bfloat16)
    if merge == "packed":
        C = packed_shift(xq, xb, similarity)
        acc = flat_reservoir_packed(qv, data, (bias_p + C).contiguous(), W)
        resv, resp = decode_packed(acc, W, C)
    else:
        resv, resp = flat_reservoir(qv, data, bias_p.contiguous(), W)

    bad = D.worst_value(metric)
    if refine and refine > 1:
        Rk = min(refine * k, W)
        if sel == "kernel" and Rk <= TOPK_K_MAX:
            rv, cand = reservoir_topk(resv, resp, Rk)
        else:
            rv, cand = _stable_topk(resv, resp, Rk)
        cand = cand.long()
        ok = (cand >= 0) & torch.isfinite(rv)
        vecs = xb[cand.clamp(min=0)].float()                 # (nq, Rk, d)
        ip = torch.bmm(vecs, xq[:, :, None])[:, :, 0]
        if similarity:
            dis = -ip
        else:
            dis = torch.clamp((xq * xq).sum(1, keepdim=True)
                              + (vecs * vecs).sum(2) - 2.0 * ip, min=0.0)
        dis = torch.where(ok, dis, float("inf"))
        kk = min(k, Rk)
        out_d, out_i = _stable_topk(dis, cand, kk)
    else:
        kk = min(k, W)
        if sel == "kernel" and kk <= TOPK_K_MAX:
            out_d, out_i = reservoir_topk(resv, resp, kk)
        else:
            out_d, out_i = _stable_topk(resv, resp, kk)
        out_i = out_i.long()
        if not similarity:
            # reservoir values are ||x||^2 - 2<q,x>: restore ||q||^2
            out_d = out_d + (xq * xq).sum(1, keepdim=True)
    if kk < k:
        out_d = torch.cat([out_d, out_d.new_full((nq, k - kk),
                                                 float("inf"))], 1)
        out_i = torch.cat([out_i, out_i.new_full((nq, k - kk), -1)], 1)
    out_i = torch.where(torch.isfinite(out_d), out_i, -1)
    if similarity:
        out_d = torch.where(out_i >= 0, -out_d, bad)
    else:
        out_d = torch.where(out_i >= 0, torch.clamp(out_d, min=0.0), bad)
    return out_d, out_i
