"""Python side of the C API (tpu_ann_torch/c_api/tpu_ann_c.{h,c}) —
PyTorch counterpart of the JAX package's ``capi.py``.

faiss exposes its index API to C callers through hand-written wrappers
per class (`c_api/Index_c.h:72-128`, `index_factory_c.h:24`). Here the C
library embeds CPython and marshals flat buffers through this module:
every function takes/returns only ints, floats, str, and writable
memoryviews, so the C side stays a thin, class-agnostic marshalling layer
— the whole index zoo (everything `index_factory` spells) is reachable
from C through one handle type.

Buffers cross the boundary as memoryviews over caller-owned C memory;
results are written in place (np.frombuffer gives a zero-copy view).
Every index lives on the device `configure_device` selected
(``TPU_ANN_TORCH_DEVICE``, "cuda" when unset).

`build_library` compiles the C library and its example with ``cc`` into
``tpu_ann_torch/_build/`` at first use (nothing is written into
``c_api/``); `example_env` is the environment a standalone C program
needs to embed this interpreter and import the package.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from typing import Dict, Optional

import numpy as np

_handles: dict[int, object] = {}
_next_id = [1]
_device: list = []          # the selected torch.device, once configured

DEVICE_ENV = "TPU_ANN_TORCH_DEVICE"

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_PKG, "c_api")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("tpu_ann_c.h", "tpu_ann_c.c", "example_c.c")


def _new_handle(obj) -> int:
    h = _next_id[0]
    _next_id[0] += 1
    _handles[h] = obj
    return h


def _get(h: int):
    try:
        return _handles[h]
    except KeyError:
        raise ValueError(f"invalid or freed index handle {h}") from None


def _as_f32(buf, n: int, d: int) -> np.ndarray:
    a = np.frombuffer(buf, dtype=np.float32, count=n * d)
    return a.reshape(n, d)


def configure_device() -> str:
    """Select the device every index of the handle lives on: the caller's
    ``TPU_ANN_TORCH_DEVICE`` ("cuda" when unset, "cuda:<i>", "cpu"). Raises
    when CUDA is asked for and there is none; never carries on on the
    CPU. Returns the device's name, e.g. "cuda:0 NVIDIA H100 80GB HBM3" or
    "cpu"."""
    import torch

    dev = torch.device(os.environ.get(DEVICE_ENV) or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{DEVICE_ENV}={dev} asks for CUDA, and there is no CUDA "
                f"device (set {DEVICE_ENV}=cpu to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        name = f"{dev} {torch.cuda.get_device_name(dev)}"
    else:
        name = str(dev)
    _device[:] = [dev]
    return name


def device():
    """The configured device (`configure_device` runs at the first call)."""
    if not _device:
        configure_device()
    return _device[0]


def factory(d: int, description: str, metric: int) -> int:
    from .utils.factory import index_factory

    return _new_handle(index_factory(int(d), description, int(metric),
                                     device=device()))


def free(h: int) -> None:
    _handles.pop(int(h), None)


def train(h: int, x, n: int, d: int) -> None:
    _get(h).train(_as_f32(x, n, d))


def add(h: int, x, n: int, d: int) -> None:
    _get(h).add(_as_f32(x, n, d))


def add_with_ids(h: int, x, n: int, d: int, ids) -> None:
    xs = _as_f32(x, n, d)
    idv = np.frombuffer(ids, dtype=np.int64, count=n)
    _get(h).add_with_ids(xs, idv)


def search(h: int, x, n: int, d: int, k: int, out_d, out_i) -> None:
    D, I = _get(h).search(_as_f32(x, n, d), int(k))
    np.frombuffer(out_d, dtype=np.float32, count=n * k)[:] = (
        np.ascontiguousarray(D, np.float32).reshape(-1))
    np.frombuffer(out_i, dtype=np.int64, count=n * k)[:] = (
        np.ascontiguousarray(I, np.int64).reshape(-1))


def range_search(h: int, x, n: int, d: int, radius: float) -> int:
    """Stage a range search; returns a result handle. Fetch sizes with
    range_result_nnz, payload with range_result_fetch, then free with
    free()."""
    res = _get(h).range_search(_as_f32(x, n, d), float(radius))
    return _new_handle(res)


def range_result_nnz(rh: int) -> int:
    lims, _D, _I = _get(rh)
    return int(lims[-1])


def range_result_fetch(rh: int, nq: int, out_lims, out_d, out_i) -> None:
    lims, D, I = _get(rh)
    nnz = int(lims[-1])
    np.frombuffer(out_lims, dtype=np.int64, count=nq + 1)[:] = (
        np.asarray(lims, np.int64))
    np.frombuffer(out_d, dtype=np.float32, count=nnz)[:] = (
        np.asarray(D, np.float32))
    np.frombuffer(out_i, dtype=np.int64, count=nnz)[:] = (
        np.asarray(I, np.int64))


def reconstruct(h: int, key: int, out) -> None:
    idx = _get(h)
    np.frombuffer(out, dtype=np.float32, count=idx.d)[:] = (
        np.asarray(idx.reconstruct(int(key)), np.float32).reshape(-1))


def remove_ids(h: int, ids, n: int) -> int:
    from .models.selectors import IDSelectorBatch

    sel = IDSelectorBatch(np.frombuffer(ids, dtype=np.int64, count=n))
    return int(_get(h).remove_ids(sel))


def ntotal(h: int) -> int:
    return int(_get(h).ntotal)


def dim(h: int) -> int:
    return int(_get(h).d)


def is_trained(h: int) -> int:
    return 1 if _get(h).is_trained else 0


def metric_type(h: int) -> int:
    return int(_get(h).metric_type)


def set_parameter(h: int, name: str, value: float) -> None:
    from .utils.autotune import set_index_parameter

    set_index_parameter(_get(h), name, value)


def write_index(h: int, path: str) -> None:
    from .utils.index_io import write_index as _w

    _w(_get(h), path)


def read_index(path: str, mmap: int) -> int:
    from .utils.index_io import read_index as _r

    return _new_handle(_r(path, mmap=bool(mmap), device=device()))


def sa_code_size(h: int) -> int:
    return int(_get(h).sa_code_size())


def sa_encode(h: int, x, n: int, d: int, out) -> None:
    codes = _get(h).sa_encode(_as_f32(x, n, d))
    buf = np.frombuffer(out, dtype=np.uint8,
                        count=n * _get(h).sa_code_size())
    buf[:] = np.ascontiguousarray(codes, np.uint8).reshape(-1)


def sa_decode(h: int, codes, n: int, out) -> None:
    idx = _get(h)
    cs = idx.sa_code_size()
    cv = np.frombuffer(codes, dtype=np.uint8, count=n * cs).reshape(n, cs)
    np.frombuffer(out, dtype=np.float32, count=n * idx.d)[:] = (
        np.ascontiguousarray(idx.sa_decode(cv), np.float32).reshape(-1))


# ---------------------------------------------------------------------------
# building the C library and its example
# ---------------------------------------------------------------------------

def embed_flags() -> Dict[str, list]:
    """The compile and link flags that embed this interpreter, from its
    own sysconfig (INCLUDEPY, LIBDIR, LDLIBRARY / LDVERSION, LIBS,
    SYSLIBS): the library must link the libpython of the interpreter that
    owns torch. Raises where that libpython is not a shared library (a
    statically linked interpreter cannot be embedded by a library)."""
    cv = sysconfig.get_config_var
    ldlib = cv("LDLIBRARY") or ""
    libdir = cv("LIBDIR") or ""
    if not cv("Py_ENABLE_SHARED") or not ldlib.endswith(".so"):
        raise RuntimeError(
            f"this Python ({sys.executable}) has no shared libpython "
            f"(LDLIBRARY={ldlib!r}): the C API cannot embed it")
    if not os.path.exists(os.path.join(libdir, ldlib)):
        raise RuntimeError(f"libpython not found at "
                           f"{os.path.join(libdir, ldlib)}")
    libs = (cv("LIBS") or "").split() + (cv("SYSLIBS") or "").split()
    return {"cflags": ["-O2", "-Wall", "-Wextra", "-fPIC",
                       f"-I{cv('INCLUDEPY')}"],
            "ldflags": [f"-L{libdir}", f"-lpython{cv('LDVERSION')}", *libs,
                        f"-Wl,-rpath,{libdir}"]}


def _build_dir(cc: str, flags: Dict[str, list]) -> str:
    h = hashlib.sha256(" ".join([cc, *flags["cflags"],
                                 *flags["ldflags"]]).encode())
    for name in SOURCES:
        with open(os.path.join(SOURCE_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"c_api-{h.hexdigest()[:16]}")


def build_library(cc: Optional[str] = None) -> Dict[str, str]:
    """Compile ``libtpu_ann_c.so`` and ``example_c`` from ``c_api/`` with
    ``cc`` (``$CC`` first) into ``_build/c_api-<hash>/`` (the hash covers
    the sources and the flags), unless they are there already. Returns
    {"library": path, "example": path}."""
    cc = cc or os.environ.get("CC") or "cc"
    if shutil.which(cc) is None:
        raise RuntimeError(f"no C compiler: {cc} not found")
    flags = embed_flags()
    out = _build_dir(cc, flags)
    lib = os.path.join(out, "libtpu_ann_c.so")
    exe = os.path.join(out, "example_c")
    if os.path.exists(lib) and os.path.exists(exe):
        return {"library": lib, "example": exe}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    steps = [
        [cc, *flags["cflags"], "-shared", "-o",
         os.path.join(tmp, "libtpu_ann_c.so"),
         os.path.join(SOURCE_DIR, "tpu_ann_c.c"), *flags["ldflags"]],
        [cc, *flags["cflags"], f"-I{SOURCE_DIR}", "-o",
         os.path.join(tmp, "example_c"),
         os.path.join(SOURCE_DIR, "example_c.c"), f"-L{tmp}", "-ltpu_ann_c",
         "-Wl,-rpath,$ORIGIN", *flags["ldflags"]],
    ]
    try:
        for cmd in steps:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
            if r.returncode:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stderr}")
        try:
            os.replace(tmp, out)
        except OSError:
            if not os.path.exists(lib):      # not built by a racing process
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"library": lib, "example": exe}


def example_env(device_name: Optional[str] = None) -> Dict[str, str]:
    """The environment for a standalone C program linked to the library:
    ``PYTHONPATH`` reaches this package's root and every directory of this
    interpreter's ``sys.path`` (its site-packages, where torch is), and
    ``TPU_ANN_TORCH_DEVICE`` is ``device_name`` when one is given."""
    root = os.path.dirname(_PKG)
    paths = [root] + [p for p in sys.path if p and os.path.isdir(p)
                      and os.path.abspath(p) != root]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(paths)
    if device_name is not None:
        env[DEVICE_ENV] = device_name
    return env
