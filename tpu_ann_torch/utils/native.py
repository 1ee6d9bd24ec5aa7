"""ctypes bindings of the native host runtime — PyTorch port's counterpart
of `tpu_ann/utils/native.py`, over the same C++ source,
``native/tpu_ann_native.cpp`` (dataset file readers, the counting-sort
invlist scatter, row norms, reverse edges; std::thread, no OpenMP).

These are host helpers, not device kernels. The library is built with
``g++`` and ``native/Makefile``'s flags into ``tpu_ann_torch/_build/``,
keyed by a hash of the source and the flags, at the first use of a
function or of ``HAVE_NATIVE`` (not at import); nothing is written into
``native/``. Each function has the reference's numpy fallback, taken when
the library cannot be built or ``TPU_ANN_DISABLE_NATIVE`` is set;
``HAVE_NATIVE`` says which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
SOURCE = os.path.join(NATIVE_DIR, "tpu_ann_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def make_flags() -> Tuple[str, list, list]:
    """(CXX, CXXFLAGS, LDFLAGS) as native/Makefile sets them (``CXX`` from
    the environment first, as make's ``?=`` takes it)."""
    found = {}
    with open(os.path.join(NATIVE_DIR, "Makefile")) as f:
        for line in f:
            m = re.match(r"\s*(CXX|CXXFLAGS|LDFLAGS)\s*\?=\s*(.*)", line)
            if m:
                found[m.group(1)] = m.group(2).split()
    cxx = os.environ.get("CXX") or found.get("CXX", ["g++"])[0]
    return cxx, found.get("CXXFLAGS", []), found.get("LDFLAGS", [])


def library_path() -> str:
    """Where the library of this source and these flags is built."""
    cxx, cflags, ldflags = make_flags()
    h = hashlib.sha256(" ".join([cxx, *cflags, *ldflags]).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libtpu_ann_native-{h.hexdigest()[:16]}.so")


def _build() -> str:
    so = library_path()
    if os.path.exists(so):
        return so
    cxx, cflags, ldflags = make_flags()
    if shutil.which(cxx) is None:
        raise OSError(f"{cxx} not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    subprocess.run([cxx, *cflags, SOURCE, *ldflags, "-o", tmp], check=True,
                   capture_output=True, timeout=300)
    os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.fbin_header.argtypes = [ctypes.c_char_p, i32p, i32p]
    lib.fbin_read.argtypes = [ctypes.c_char_p, i64, i64, vp]
    lib.fvecs_read.argtypes = [ctypes.c_char_p, i64, i32p, vp]
    lib.fvecs_read.restype = i64
    lib.pack_layout.argtypes = [vp, i64, i64, i64, vp, vp, vp]
    lib.pack_layout.restype = i64
    lib.pack_scatter.argtypes = [vp, i64, vp, vp, i64, i64, vp, vp, vp]
    lib.fvec_norms_l2sqr.argtypes = [vp, i64, i64, vp]
    lib.reverse_edges.argtypes = [vp, vp, i64, i64, i64, vp, vp]
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None where it cannot
    be built or ``TPU_ANN_DISABLE_NATIVE`` is set (numpy fallbacks)."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        if not os.environ.get("TPU_ANN_DISABLE_NATIVE"):
            try:
                _LIB = _bind(ctypes.CDLL(_build()))
            except (OSError, subprocess.SubprocessError):
                _LIB = None
    return _LIB


def __getattr__(name: str):
    if name == "HAVE_NATIVE":
        return _lib() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def read_fbin_native(path: str, start: int = 0,
                     count: Optional[int] = None) -> np.ndarray:
    """Parallel .fbin reader; falls back to utils.datasets.read_fbin."""
    lib = _lib()
    if lib is None:
        from .datasets import read_fbin

        return read_fbin(path, start, count)
    n, d = ctypes.c_int32(), ctypes.c_int32()
    if lib.fbin_header(path.encode(), ctypes.byref(n), ctypes.byref(d)):
        raise IOError(f"cannot read {path}")
    total = n.value - start
    if count is not None:
        total = min(total, count)
    out = np.empty((total, d.value), np.float32)
    if lib.fbin_read(path.encode(), start, total, _ptr(out)):
        raise IOError(f"short read on {path}")
    return out


def read_fvecs_native(path: str, max_rows: int = -1) -> np.ndarray:
    """Parallel .fvecs reader (at most ``max_rows`` rows, all when < 0);
    falls back to utils.datasets.fvecs_read."""
    lib = _lib()
    if lib is None:
        from .datasets import fvecs_read

        x = fvecs_read(path)
        return x if max_rows < 0 else x[:max_rows]
    d = ctypes.c_int32()
    rows = lib.fvecs_read(path.encode(), max_rows, ctypes.byref(d), None)
    if rows < 0:
        raise IOError(f"cannot read {path}")
    out = np.empty((rows, d.value), np.float32)
    if lib.fvecs_read(path.encode(), rows, ctypes.byref(d),
                      _ptr(out)) != rows:
        raise IOError(f"short read on {path}")
    return out


def pack_rows_native(
    x: np.ndarray,
    xids: np.ndarray,
    assign: np.ndarray,
    nlist: int,
    block: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Counting-sort rows into the block-padded invlist layout with the
    native scatter: (data, ids, starts_blocks, nblocks_per_list), or None
    without the library (the caller packs in numpy). ``x`` is any
    row-contiguous 2-D array (f32 rows or uint8 codes)."""
    lib = _lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x)
    n = len(x)
    row_bytes = x.strides[0]
    xids = np.ascontiguousarray(xids, np.int32)
    assign = np.ascontiguousarray(assign, np.int64)
    if n and (assign.min() < 0 or assign.max() >= nlist):
        # the scatter indexes by list: an out-of-range list would write
        # out of bounds
        raise ValueError(f"assignments must be in [0, {nlist})")
    sizes = np.zeros(nlist, np.int64)
    nblocks = np.zeros(nlist, np.int64)
    starts = np.zeros(nlist, np.int64)
    nb_total = lib.pack_layout(_ptr(assign), n, nlist, block, _ptr(sizes),
                               _ptr(nblocks), _ptr(starts))
    data = np.zeros((nb_total + 1) * block * row_bytes, np.uint8)
    ids = np.full((nb_total + 1) * block, -1, np.int32)
    lib.pack_scatter(_ptr(x), row_bytes, _ptr(xids), _ptr(assign), n, block,
                     _ptr(starts), _ptr(data), _ptr(ids))
    data = data.view(x.dtype).reshape(nb_total + 1, block, x.shape[1])
    ids = ids.reshape(nb_total + 1, block)
    starts = starts.copy()
    starts[nblocks == 0] = nb_total      # empty lists -> the dummy block
    return data, ids, starts, nblocks


def norms_l2sqr_native(x: np.ndarray) -> np.ndarray:
    """Row-wise squared L2 norms (f32)."""
    lib = _lib()
    if lib is None:
        return (np.asarray(x, np.float64) ** 2).sum(-1).astype(np.float32)
    x = np.ascontiguousarray(x, np.float32)
    flat = x.reshape(-1, x.shape[-1])
    out = np.empty(len(flat), np.float32)
    lib.fvec_norms_l2sqr(_ptr(flat), len(flat), flat.shape[-1], _ptr(out))
    return out.reshape(x.shape[:-1])


def reverse_edges_native(fwd: np.ndarray, fwd_dis: np.ndarray, cap: int):
    """Reverse-edge table (the first ``cap`` sources a destination, in
    ascending source order) by the native counting scatter, or None
    without the library (the caller takes a numpy sort)."""
    lib = _lib()
    if lib is None:
        return None
    fwd = np.ascontiguousarray(fwd, np.int32)
    fwd_dis = np.ascontiguousarray(fwd_dis, np.float32)
    n, m = fwd.shape
    rev_ids = np.full((n, cap), -1, np.int32)
    rev_dis = np.full((n, cap), np.inf, np.float32)
    lib.reverse_edges(_ptr(fwd), _ptr(fwd_dis), n, m, cap, _ptr(rev_ids),
                      _ptr(rev_dis))
    return rev_ids, rev_dis
