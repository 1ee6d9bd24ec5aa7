"""Memory and energy accounting — PyTorch counterpart of
`tpu_ann/utils/memory.py` (the fork's `AdvancedMemoryMonitor`,
tutorial/python/190-hnsw-ivf-test.py:67-1046, 200-memory.py, and
t-energy.cpp): host RSS from /proc, device memory from the CUDA caching
allocator (`torch.cuda.memory_stats`), phase-marked sampling, and the
host package energy from RAPL.

`index_memory_bytes(index)` counts the device tensors an index really
holds, by component, the equal-memory comparison quantity.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import threading
import time
from typing import Dict, List, Optional

import torch


def host_rss_bytes() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def device_memory_stats(device=None) -> Dict[str, int]:
    """The CUDA caching allocator's counters for ``device`` (the current
    device by default): every integer of `torch.cuda.memory_stats`, and
    ``bytes_in_use`` / ``peak_bytes_in_use`` (the allocated bytes now and
    at their peak, the keys the reference's PJRT stats give). ``{}`` when
    CUDA is not available; a CUDA error raises."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {k: int(v) for k, v in stats.items()
           if isinstance(v, (int, float))}
    out["bytes_in_use"] = out.get("allocated_bytes.all.current", 0)
    out["peak_bytes_in_use"] = out.get("allocated_bytes.all.peak", 0)
    return out


def index_memory_bytes(index) -> Dict[str, int]:
    """Bytes of the tensors ``index`` holds on its device, by component,
    each storage counted once. The reference's keys where it has the
    tensor: ``invlist_codes`` (the f32 rows or the codes of the lists),
    ``invlist_ids``, ``invlist_norms``, ``centroids``, ``quantizer_graph``,
    ``graph``, ``storage`` and ``vectors``. A tensor the reference does not
    have gets a key of its own: ``invlist_bf16`` (the bf16 twin the fused
    scan streams), ``invlist_directory`` (each list's first block and
    block count), ``decoded_cache`` (a codec's decoded lists), ``norms`` /
    ``quantizer_norms`` (an IndexFlat's row norms), and for any other one
    its attribute path. ``total`` is their sum."""
    dev = torch.device(getattr(index, "device", "cpu"))
    out: Dict[str, int] = {}
    seen = set()

    def add(key: str, t) -> None:
        # "cuda" names the current card: match on the type, and on the
        # index only where the index's device gives one
        if not isinstance(t, torch.Tensor) or not t.numel() \
                or t.device.type != dev.type or (
                    dev.index is not None and t.device.index != dev.index):
            return
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            return
        seen.add(ptr)
        out[key] = out.get(key, 0) + t.untyped_storage().nbytes()

    def add_lists(il, prefix: str = "invlist") -> None:
        if il is None:
            return
        payload = getattr(il, "data", None)
        if payload is None:
            payload = getattr(il, "codes", None)
        add(f"{prefix}_codes", payload)
        add(f"{prefix}_bf16", getattr(il, "data_bf16", None))
        add(f"{prefix}_ids", getattr(il, "ids", None))
        add(f"{prefix}_norms", getattr(il, "norms", None))
        add(f"{prefix}_directory", getattr(il, "list_block_start", None))
        add(f"{prefix}_directory", getattr(il, "list_nblocks", None))
        walk(il, prefix)

    def add_graph(g, key: str) -> None:
        if isinstance(g, torch.Tensor):
            add(key, g)
            return
        for name in ("neighbors0", "upper_neighbors", "levels"):
            add(key, getattr(g, name, None))
        walk(g, key)

    def walk(obj, prefix: str, depth: int = 0) -> None:
        """Every other tensor reachable from obj's attributes (and their
        lists, dicts and dataclasses) under its attribute path."""
        if depth > 3 or obj is None:
            return
        items = (obj.items() if isinstance(obj, dict)
                 else enumerate(obj) if isinstance(obj, (list, tuple))
                 else vars(obj).items() if hasattr(obj, "__dict__")
                 else ())
        for name, v in items:
            key = f"{prefix}_{str(name).lstrip('_')}".lstrip("_")
            if isinstance(v, torch.Tensor):
                add(key, v)
            elif isinstance(v, (list, tuple, dict)) or (
                    hasattr(v, "__dict__") and not isinstance(v, type)
                    and not isinstance(v, torch.nn.Module)
                    and type(v).__module__.startswith(
                        __name__.split(".")[0])):
                walk(v, key, depth + 1)

    add_lists(getattr(index, "invlists", None))
    add_lists(getattr(index, "_decoded", None), "decoded_cache")
    q = getattr(index, "quantizer", None)
    if q is not None:
        vecs = getattr(q, "vectors", None)
        if vecs is None and hasattr(q, "storage"):
            vecs = q.storage.vectors
        add("centroids", vecs)
        add("quantizer_norms", getattr(q, "_norms", None))
        if getattr(q, "graph", None) is not None:
            add_graph(q.graph, "quantizer_graph")
        walk(q, "quantizer")
    g = getattr(index, "graph", None)
    if g is not None:
        add_graph(g, "graph")
        storage = getattr(index, "storage", None)
        if storage is not None:
            add("storage", storage.vectors)
            walk(storage, "storage")
    add("vectors", getattr(index, "_xb", None))
    add("norms", getattr(index, "_norms", None))
    walk(index, "")
    out["total"] = sum(out.values())
    return out


@dataclasses.dataclass
class MemorySample:
    t: float
    phase: str
    rss_bytes: int
    hbm_bytes: int


class MemoryMonitor:
    """Phase-marked sampling thread (the AdvancedMemoryMonitor role): host
    RSS and the current card's allocated bytes (``hbm_bytes``, the
    reference's name) every ``interval_s`` and at each phase mark."""

    def __init__(self, interval_s: float = 0.5):
        self.interval = interval_s
        self.samples: List[MemorySample] = []
        self._phase = "init"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()

    def set_phase(self, phase: str) -> None:
        self._phase = phase
        self._sample()

    def _sample(self) -> None:
        hbm = device_memory_stats().get("bytes_in_use", 0)
        self.samples.append(MemorySample(
            t=time.time() - self._t0, phase=self._phase,
            rss_bytes=host_rss_bytes(), hbm_bytes=hbm))

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._sample()

    def __enter__(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self._sample()
        return False

    def peak_rss(self) -> int:
        return max((s.rss_bytes for s in self.samples), default=0)

    def peak_hbm(self) -> int:
        return max((s.hbm_bytes for s in self.samples), default=0)

    def report(self) -> str:
        lines = ["phase            t(s)    RSS(MB)   HBM(MB)"]
        seen = set()
        for s in self.samples:
            if s.phase not in seen:
                seen.add(s.phase)
                lines.append(f"{s.phase:<15} {s.t:7.1f} "
                             f"{s.rss_bytes / 2**20:9.1f}"
                             f" {s.hbm_bytes / 2**20:9.1f}")
        lines.append(f"peak RSS {self.peak_rss() / 2**20:.1f} MB, "
                     f"peak HBM {self.peak_hbm() / 2**20:.1f} MB")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Energy accounting (the fork's t-energy.cpp: RAPL powercap energy_uj
# counters -> J and QPS/W). This is the HOST package's energy; the card's
# power is not read here. The counters are only read, never written.
# ---------------------------------------------------------------------------

_RAPL_ROOT = "/sys/class/powercap"


def rapl_available() -> bool:
    return bool(glob.glob(os.path.join(_RAPL_ROOT, "intel-rapl:*",
                                       "energy_uj")))


def _read_energy_uj() -> int:
    total = 0
    for p in glob.glob(os.path.join(_RAPL_ROOT, "intel-rapl:*",
                                    "energy_uj")):
        try:
            with open(p) as f:
                total += int(f.read().strip())
        except OSError:
            pass
    return total


class EnergyMonitor:
    """Context manager: joules and mean watts over the enclosed block
    (t-energy.cpp:30-71). ``joules`` is None where RAPL is unavailable. One
    counter wraparound is taken as a 32-bit one."""

    def __init__(self):
        self.joules: Optional[float] = None
        self.seconds: float = 0.0

    def __enter__(self):
        self._avail = rapl_available()
        self._t0 = time.time()
        self._e0 = _read_energy_uj() if self._avail else 0
        return self

    def __exit__(self, *exc):
        self.seconds = time.time() - self._t0
        if self._avail:
            de = _read_energy_uj() - self._e0
            if de < 0:
                de += 1 << 32
            self.joules = de / 1e6
        return False

    @property
    def watts(self) -> Optional[float]:
        if self.joules is None or self.seconds <= 0:
            return None
        return self.joules / self.seconds

    def qps_per_watt(self, nq: int) -> Optional[float]:
        w = self.watts
        if not w:
            return None
        return (nq / self.seconds) / w
