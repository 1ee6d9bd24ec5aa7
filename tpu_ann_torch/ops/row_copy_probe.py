"""Row-copy issue probe (B2) — PyTorch counterpart of the DMA-issue
microbenchmark of the round-5 harness (`benchs/r5/r5_queue7.py:43-119`,
``kern2``), with its kernel hand-written in CUDA for Hopper:
``csrc/row_copy_probe.cu``.

One CTA's single issuing thread copies NR rows ``xb[rows[i]]`` (dp f32
each) into NS shared-memory slots, one 1-D bulk copy (TMA) per row
completing on its slot's mbarrier; it waits for a slot's previous copy
before reusing it and drains every slot at the end. The result is the last
row each slot received, so the function is

    out[s] = xb[rows[i_s]],  i_s the last i < NR with i % NS == s

(zeros for slots no copy reached). The kernel also returns the issuing
thread's clock64() span; `sm_clock_khz` is the SM clock cudaDeviceProp
reports, to convert a time into cycles. The question it answers: what one
row copy costs to issue, against a gather (`xb.index_select(0, rows)`) of
the same rows, before a refine's candidate gather is folded into a kernel.

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


def row_copy_probe_reference(xb: torch.Tensor, rows: torch.Tensor,
                             ns: int = 16) -> torch.Tensor:
    """Plain torch version: the (ns, dp) slots after the copies."""
    nr = rows.shape[0]
    out = torch.zeros((ns, xb.shape[1]), dtype=torch.float32,
                      device=xb.device)
    if nr == 0:
        return out
    last = torch.arange(min(nr, ns), device=rows.device)
    last = last + (nr - 1 - last) // ns * ns      # the last i with i % ns == s
    out[:len(last)] = xb[rows[last].long()].float()
    return out


def _lib():
    if not _FN:
        from ..kernels import load_library

        lib = load_library("row_copy_probe")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.row_copy_probe.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
        lib.row_copy_probe.restype = ci
        lib.row_copy_probe_sm_khz.argtypes = [ci]
        lib.row_copy_probe_sm_khz.restype = ci
        _FN["probe"] = lib.row_copy_probe
        _FN["khz"] = lib.row_copy_probe_sm_khz
    return _FN


def sm_clock_khz(device=None) -> int:
    """The SM clock cudaDeviceProp reports for ``device`` (kHz)."""
    dev = torch.device("cuda" if device is None else device)
    return int(_lib()["khz"](dev.index or 0))


def row_copy_probe(xb: torch.Tensor, rows: torch.Tensor, ns: int = 16, *,
                   validate: bool = True):
    """B2: copy rows ``xb[rows[i]]`` (xb (nb, dp) f32, dp a multiple of 4;
    rows (nr,) int32) through ``ns`` slots (see the module docstring).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``validate`` checks that every row lies in [0, nb) (one host sync;
    turn it off inside timing loops).
    Returns (out (ns, dp) f32, cycles): cycles is a 1-element int64
    tensor, the issuing thread's clock64() span (None on the CPU)."""
    global LAUNCHES
    if not 1 <= ns <= NS_MAX:
        raise ValueError(f"row_copy_probe: ns must be in [1, {NS_MAX}]")
    dev = xb.device
    if dev.type == "cpu":
        return row_copy_probe_reference(xb, rows, ns), None
    if dev.type != "cuda":
        raise ValueError(f"row_copy_probe: unsupported device {dev}")
    nb, dp = xb.shape
    if (xb.dtype != torch.float32 or not xb.is_contiguous() or dp % 4
            or xb.data_ptr() % 16):
        raise ValueError("row_copy_probe: xb must be a contiguous, 16-byte "
                         "aligned f32 tensor with dp % 4 == 0")
    if rows.dtype != torch.int32 or rows.device != dev or \
            not rows.is_contiguous() or rows.dim() != 1:
        raise ValueError("row_copy_probe: rows must be a contiguous int32 "
                         "vector on xb's device")
    if validate and rows.numel() and \
            not bool(((rows >= 0) & (rows < nb)).all()):
        raise ValueError(f"row_copy_probe: rows must lie in [0, {nb})")
    out = torch.empty((ns, dp), dtype=torch.float32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    err = _lib()["probe"](xb.data_ptr(), rows.data_ptr(), rows.numel(), dp,
                          ns, out.data_ptr(), cycles.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_copy_probe: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out, cycles
