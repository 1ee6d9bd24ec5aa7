"""Build and load the port's hand-written CUDA kernels.

Each ``tpu_ann_torch/csrc/<name>.cu`` has a plain C interface (no PyTorch
headers) and is compiled at first use by ``nvcc`` into
``tpu_ann_torch/_build/lib<name>-<hash>.so``, keyed by a hash of the
sources and flags, then loaded with ctypes. Callers pass every pointer
and the stream as ``ctypes.c_void_p``. There is no fallback: a missing
``nvcc`` or a failed build raises.

The target is ``sm_90a`` (Hopper with its architecture-specific
instructions); the compiler's resource report (-Xptxas -v: registers,
shared memory, spills) is kept beside each library as ``.log``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
# seconds spent compiling each library in this process (0.0 = found built)
BUILD_SECONDS: dict = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
            "/usr/local/cuda): the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> str:
    """Where the built library for csrc/<name>.cu lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))) + [
            os.path.join(CSRC_DIR, name + ".cu")]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_log(name: str) -> str:
    """The compiler's output for the library (empty if not built here)."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and load it (cached per process)."""
    if name in _LIBS:
        return _LIBS[name]
    so = library_path(name)
    if os.path.exists(so):
        BUILD_SECONDS[name] = 0.0
    else:
        os.makedirs(BUILD_DIR, exist_ok=True)
        src = os.path.join(CSRC_DIR, name + ".cu")
        tmp = f"{so}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        with open(so[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, so)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    _LIBS[name] = lib
    return lib


def load_libraries(names) -> dict:
    """Build (one nvcc per source, all started together) and load several
    libraries; returns {name: library}."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(load_library, n) for n in names}
        return {n: f.result() for n, f in futures.items()}
