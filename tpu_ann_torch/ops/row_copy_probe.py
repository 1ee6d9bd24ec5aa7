"""Row-copy issue probe (B2) — PyTorch counterpart of the DMA-issue
microbenchmark of the round-5 harness (`benchs/r5/r5_queue7.py:43-119`,
``kern2``), with its kernel hand-written in CUDA for Hopper:
``csrc/row_copy_probe.cu``.

The kernel copies NR rows ``xb[rows[i]]`` (dp f32 each) into shared
memory, one 1-D bulk copy (TMA) a row completing on an mbarrier, from a
grid sized to the SMs: each CTA takes a contiguous range of i, keeps a
ring of 64 one-row slots full with its issuing lanes, and folds every
landed row into an XOR before it frees the slot. The function is

    out[s] = xb[rows[i_s]],  i_s the last i < NR with i % NS == s
    xor    = XOR of the bit patterns of all NR rows (dp int32 words)

(zeros for slots no copy reached, and for the XOR when NR is 0). The XOR
shows that every row was moved, not only the last NS. What bounds it on
the card is the bytes of the rows; one thread issuing every copy (16
copies, 8 KB, in flight on one SM) is a latency chain, so the kernel
keeps 64 copies in flight a CTA on every SM. The kernel also
returns each CTA's clock64() span; `sm_clock_khz` is the SM clock
cudaDeviceProp reports, to convert a time into cycles, and `cta_copies`
the copies each CTA took. The question it answers: what a row copy costs
when the whole card issues them, against a gather
(`xb.index_select(0, rows)`) of the same rows, before a refine's candidate
gather is folded into a kernel.

The wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

NS_MAX = 32
# kernel launches made by `row_copy_probe`
LAUNCHES = 0
_FN: dict = {}


def xor_rows(x: torch.Tensor) -> torch.Tensor:
    """XOR over the rows of an (n, dp) int32 tensor: (dp,), zeros if n is
    0 (pairwise halving, so log2(n) steps)."""
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1], dtype=torch.int32, device=x.device)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        top = x[:h] ^ x[h:2 * h]
        if x.shape[0] % 2:
            top[0] ^= x[-1]
        x = top
    return x[0]


def row_copy_probe_reference(xb: torch.Tensor, rows: torch.Tensor,
                             ns: int = 16):
    """Plain torch version: the (ns, dp) slots after the copies and the
    (dp,) int32 XOR of all copied rows' bit patterns."""
    nr = rows.shape[0]
    out = torch.zeros((ns, xb.shape[1]), dtype=torch.float32,
                      device=xb.device)
    copied = xb[rows.long()].float()
    if nr:
        last = torch.arange(min(nr, ns), device=rows.device)
        last = last + (nr - 1 - last) // ns * ns  # the last i with i % ns == s
        out[:len(last)] = copied[last]
    return out, xor_rows(copied.view(torch.int32))


def _lib():
    if not _FN:
        from ..kernels import load_library

        lib = load_library("row_copy_probe")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.row_copy_probe.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp]
        lib.row_copy_probe.restype = ci
        lib.row_copy_probe_ctas.argtypes = [ci, ci]
        lib.row_copy_probe_ctas.restype = ci
        lib.row_copy_probe_dp_max.argtypes = []
        lib.row_copy_probe_dp_max.restype = ci
        lib.row_copy_probe_sm_khz.argtypes = [ci]
        lib.row_copy_probe_sm_khz.restype = ci
        _FN["probe"] = lib.row_copy_probe
        _FN["ctas"] = lib.row_copy_probe_ctas
        _FN["dp_max"] = lib.row_copy_probe_dp_max
        _FN["khz"] = lib.row_copy_probe_sm_khz
    return _FN


def sm_clock_khz(device=None) -> int:
    """The SM clock cudaDeviceProp reports for ``device`` (kHz)."""
    dev = torch.device("cuda" if device is None else device)
    return int(_lib()["khz"](dev.index or 0))


def cta_copies(nr: int, ctas: int) -> list:
    """The copies each of ``ctas`` CTAs takes: CTA b the contiguous range
    [b nr / ctas, (b + 1) nr / ctas)."""
    return [(b + 1) * nr // ctas - b * nr // ctas for b in range(ctas)]


def row_copy_probe(xb: torch.Tensor, rows: torch.Tensor, ns: int = 16, *,
                   validate: bool = True):
    """B2: copy rows ``xb[rows[i]]`` (xb (nb, dp) f32, dp a multiple of 4,
    at most 888 on the card; rows (nr,) int32) and keep ``ns`` output slots
    (see the module docstring). The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``validate`` checks that every row lies in
    [0, nb) (one host sync; turn it off inside timing loops).
    Returns (out (ns, dp) f32, xor (dp,) int32, cycles): cycles is an int64
    tensor, each CTA's clock64() span (None on the CPU)."""
    global LAUNCHES
    if not 1 <= ns <= NS_MAX:
        raise ValueError(f"row_copy_probe: ns must be in [1, {NS_MAX}]")
    dev = xb.device
    if dev.type == "cpu":
        return (*row_copy_probe_reference(xb, rows, ns), None)
    if dev.type != "cuda":
        raise ValueError(f"row_copy_probe: unsupported device {dev}")
    nb, dp = xb.shape
    fn = _lib()
    if (xb.dtype != torch.float32 or not xb.is_contiguous() or dp % 4
            or dp > fn["dp_max"]() or xb.data_ptr() % 16):
        raise ValueError(f"row_copy_probe: xb must be a contiguous, 16-byte "
                         f"aligned f32 tensor with dp % 4 == 0 and dp <= "
                         f"{fn['dp_max']()}")
    if rows.dtype != torch.int32 or rows.device != dev or \
            not rows.is_contiguous() or rows.dim() != 1:
        raise ValueError("row_copy_probe: rows must be a contiguous int32 "
                         "vector on xb's device")
    if validate and rows.numel() and \
            not bool(((rows >= 0) & (rows < nb)).all()):
        raise ValueError(f"row_copy_probe: rows must lie in [0, {nb})")
    with torch.cuda.device(dev):
        ctas = fn["ctas"](rows.numel(), dp)
    # the slots and the XOR start at zero: one buffer, one memset
    zeroed = torch.zeros((ns + 1) * dp, dtype=torch.int32, device=dev)
    out = zeroed[:ns * dp].view(torch.float32).view(ns, dp)
    xor = zeroed[ns * dp:]
    cycles = torch.empty(ctas, dtype=torch.int64, device=dev)
    err = fn["probe"](xb.data_ptr(), rows.data_ptr(), rows.numel(), dp, ns,
                      out.data_ptr(), xor.data_ptr(), cycles.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_copy_probe: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out, xor, cycles
