"""Named spans on the IVF search path, for the profiler and for
``search_stats``.

``span(name)`` marks one step of a search. With no consumer on it costs
one flag check and returns a shared no-op context. It has two consumers:

- ``torch.profiler``: the span is ``record_function(PREFIX + name)``, a
  host range in the profiler's trace, on the clock of the device's
  operations, so each idle gap of the device can be put down to the step
  the host was in;
- a collector that ``collect(stats, device)`` sets for the calling context
  (``IndexIVF.search_stats`` does): the span adds its time, in
  microseconds, to the `SearchStats` fields that `SPANS` gives it, on the
  span's clock:
  - ``FENCED``: the host clock between device syncs at both edges (as
    `models.base.Timer` is), so the interval holds the device work queued
    inside it;
  - ``HOST``: the host clock alone, for a step that starts after a fence
    and blocks the host until its device work is done (the copy out, which
    waits on the stream once its copies are issued);
  - ``DEVICE``: a CUDA event pair around the span, read once the
    enclosing `fence` has synced, so the span adds no sync of its own; on
    a CPU device, the host clock.

A span or fence inside a timed span of the same collector adds nothing (a
scan inside a graph quantizer's coarse step counts as coarse time).
`fence` is a fenced interval with no profiler range (the list scan's part
of ``list_scan_us``). `count` adds to a counter field of the collector's
`SearchStats` (``pinned_bytes``), and is a no-op without one.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

PREFIX = "tpu_ann_torch."
FENCED, HOST, DEVICE = "fenced", "host", "device"

# span name -> (the SearchStats fields it adds to, its clock), in the order
# a search enters them. quantization_us is the coarse span; list_scan_us
# is the scan's fence and the output span.
SPANS = {
    "ivf.search": ((), None),
    "ivf.input": (("input_us",), FENCED),
    "ivf.upload": (("upload_us",), FENCED),
    "ivf.coarse": (("quantization_us",), FENCED),
    "ivf.plan": (("plan_us",), DEVICE),
    "ivf.kernel": ((), None),
    "ivf.merge": (("merge_us",), DEVICE),
    "ivf.output": (("output_us", "list_scan_us"), HOST),
}

_OFF = contextlib.nullcontext()
_collector = contextvars.ContextVar("tpu_ann_torch_span_collector",
                                    default=None)


class _Collector:
    """The `SearchStats` that the spans of one ``collect`` fill."""

    def __init__(self, stats, device: torch.device):
        self.stats = stats
        self.device = device
        self.cuda = device.type == "cuda"
        self.open = 0        # timed spans of this collector now open
        self.pending = []    # (fields, start event, end event), not read yet

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mark(self):
        """A timing event recorded on the device's current stream
        (``torch.Event``: a third of ``torch.cuda.Event``'s host time)."""
        ev = torch.Event(self.device, enable_timing=True)
        ev.record()
        return ev

    def add(self, fields, us: float) -> None:
        for f in fields:
            setattr(self.stats, f, getattr(self.stats, f) + us)

    def settle(self) -> None:
        """Add the event pairs' times (the caller has synced)."""
        for fields, start, end in self.pending:
            self.add(fields, start.elapsed_time(end) * 1e3)
        self.pending.clear()


def _range(name: str):
    return record_function(PREFIX + name) \
        if _profiler._is_profiler_enabled else _OFF


def span(name: str):
    """The context of the step ``name`` of `SPANS` (module docstring)."""
    col = _collector.get()
    if col is None:
        return _range(name)
    return _timed(col, name)


@contextlib.contextmanager
def _timed(col: _Collector, name: str):
    fields, clock = SPANS[name]
    with _range(name):
        if not fields or col.open:
            yield
            return
        col.open += 1
        try:
            if clock == DEVICE and col.cuda:
                start = col.mark()
                yield
                col.pending.append((fields, start, col.mark()))
                return
            if clock == FENCED:
                col.sync()
            t0 = time.perf_counter()
            yield
            if clock == FENCED:
                col.sync()
            col.add(fields, (time.perf_counter() - t0) * 1e6)
        finally:
            col.open -= 1


def fence(field: str):
    """Under a collector and outside its timed spans, add the interval's
    host time to ``field``, fenced by device syncs at both edges, and read
    the event pairs of the spans inside it; otherwise a no-op."""
    col = _collector.get()
    return _OFF if col is None or col.open else _fenced(col, field)


@contextlib.contextmanager
def _fenced(col: _Collector, field: str):
    col.sync()
    t0 = time.perf_counter()
    yield
    col.sync()
    col.add((field,), (time.perf_counter() - t0) * 1e6)
    col.settle()


def count(field: str, n: int) -> None:
    """Under a collector, add ``n`` to its `SearchStats` field ``field``;
    otherwise a no-op."""
    col = _collector.get()
    if col is not None:
        col.add((field,), n)


@contextlib.contextmanager
def collect(stats, device):
    """Let the spans of the calling context fill ``stats`` (a
    `SearchStats`) on ``device``'s clock until the block ends."""
    col = _Collector(stats, torch.device(device))
    token = _collector.set(col)
    try:
        yield stats
    finally:
        _collector.reset(token)
    if col.pending:
        col.sync()
        col.settle()
