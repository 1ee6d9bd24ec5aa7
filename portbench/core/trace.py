"""A stretch of calls under ``torch.profiler``, reduced to a timeline.

The stretch runs inside a ``portbench.window`` range and each call inside a
``portbench.call`` range (``record_function``), so the window's edges and
what the host was doing sit in the same trace as the device's operations.
Device time is the union of the intervals of every operation on the device
(kernels, copies, sets), so nothing is counted twice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

WINDOW = "portbench.window"
CALL = "portbench.call"
# what an idle gap is named by when no host operation of the trace covers it
NO_HOST_OP = {WINDOW: "portbench loop, between calls",
              CALL: "inside the call, no traced host op"}


@dataclasses.dataclass
class Timeline:
    window: tuple            # (start, end), microseconds, profiler clock
    device: list             # [(start, end, name)] device operations
    host: list               # [(start, end, name)] host operations

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations inside the window, merged."""
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(e, w1)) for s, e, _ in self.device
                       if e > w0 and s < w1)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by their short name."""
        by = {}
        for s, e, name in self.device:
            name = short_name(name)
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, seconds]]: the device's idle gaps in
        the window, each named by the innermost host operation that covers
        its middle, summed by name."""
        w0, w1 = self.window
        edges = [w0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(w1)
        hs = np.array([h[0] for h in self.host], np.float64)
        he = np.array([h[1] for h in self.host], np.float64)
        by = {}
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 <= g0:
                continue
            mid = (g0 + g1) / 2
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            if len(cover):
                name = self.host[cover[np.argmin((he - hs)[cover])]][2]
            else:
                name = "outside the traced host ops"
            name = NO_HOST_OP.get(name, name)
            by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name without its return type's ``void`` and
    its argument list (the first ``(`` outside template brackets that
    follows a name)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, c in enumerate(name):
        if c == "<":
            depth += 1
        elif c == ">":
            depth = max(depth - 1, 0)
        elif c == "(" and depth == 0 and i and (
                name[i - 1].isalnum() or name[i - 1] in "_>"):
            name = name[:i]
            break
    return name[:width]


def profiled(stretch, cuda: bool = True):
    """Run ``stretch(mark)`` under the profiler, where ``mark`` is the
    context manager to wrap each call in; returns (its result, the
    Timeline). ``cuda=False`` traces the host alone (CPU tests)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = stretch(lambda: record_function(CALL))
            sync()
    device, host, window = [], [], None
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            # the ranges of record_function show on the device's timeline
            # too; they are not device work
            if not (e.is_user_annotation or e.name in (WINDOW, CALL)):
                device.append(span)
        else:
            host.append(span)
            if e.name == WINDOW:
                window = span[:2]
    if window is None:
        raise RuntimeError("the profiler's trace holds no window range")
    return out, Timeline(window, device, host)
