"""Cooperative cancellation — PyTorch counterpart of
`tpu_ann/utils/interrupt.py`: faiss `InterruptCallback` /
`TimeoutCallback` / Python `TimeoutGuard`
(impl/AuxIndexStructures.h:135-170, python/__init__.py:341).

The reference polls `InterruptCallback::is_interrupted()` inside long add/
search loops (IndexIVF.cpp:627, IndexHNSW.cpp:188-196). Device programs
are uninterruptible once launched, so the poll points here are the host
boundaries between batches: the iterations of `ops.kmeans.kmeans` and of
`parallel.kmeans_distributed`, and the waves of `ops.hnsw.build_graph` and
`extend_graph`, call `check()`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class InterruptError(RuntimeError):
    """Raised by check() when the current callback reports interruption
    (faiss throws FaissException('computation interrupted'))."""


class InterruptCallback:
    """Global cancellation hook (singleton, like faiss's static instance)."""

    _lock = threading.Lock()
    _instance: Optional["InterruptCallback"] = None

    def want_interrupt(self) -> bool:  # override
        return False

    # --- static API (mirrors InterruptCallback::check / is_interrupted) ---
    @classmethod
    def set(cls, cb: Optional["InterruptCallback"]) -> None:
        with cls._lock:
            cls._instance = cb

    @classmethod
    def get(cls) -> Optional["InterruptCallback"]:
        with cls._lock:
            return cls._instance

    @classmethod
    def is_interrupted(cls) -> bool:
        cb = cls.get()
        return bool(cb and cb.want_interrupt())

    @classmethod
    def check(cls) -> None:
        if cls.is_interrupted():
            raise InterruptError("computation interrupted")

    @classmethod
    def clear(cls) -> None:
        cls.set(None)


class TimeoutCallback(InterruptCallback):
    """Interrupt after a wall-clock budget (impl TimeoutCallback)."""

    def __init__(self, timeout_s: float):
        self.t0 = time.perf_counter()
        self.timeout = float(timeout_s)

    def want_interrupt(self) -> bool:
        return time.perf_counter() - self.t0 > self.timeout


class FunctionInterrupt(InterruptCallback):
    """Adapter: any () -> bool predicate."""

    def __init__(self, fn: Callable[[], bool]):
        self.fn = fn

    def want_interrupt(self) -> bool:
        return bool(self.fn())


class TimeoutGuard:
    """Context manager arming a TimeoutCallback (faiss.TimeoutGuard)."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s

    def __enter__(self):
        InterruptCallback.set(TimeoutCallback(self.timeout_s))
        return self

    def __exit__(self, *exc):
        InterruptCallback.clear()
        return False
