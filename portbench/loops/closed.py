"""Closed loop with one client: the next batch is sent when the previous
one has returned.

Batches are taken in order from the query pool, ``batch`` rows at a time,
and the pool is cycled. Each call is timed by the host clock from the call
to the results in hand (the program returns numpy arrays, so they are on
the host). Of every answered batch the loop keeps the answers in full
until the same batch comes round again (so the last full pass over the
pool is kept whole) and ``sample`` rows drawn by ``rng`` from it, for the
comparison after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import traceback

import numpy as np


@dataclasses.dataclass
class Run:
    batch: int
    latencies_s: list
    starts_s: list            # each call's start, from the window's start
    t_start: float
    t_end: float
    queries_answered: int = 0
    queries_failed: int = 0
    errors: list = dataclasses.field(default_factory=list)
    last: list = None         # per pool batch: its latest (D, I)
    sample_rows: list = dataclasses.field(default_factory=list)
    sample_d: list = dataclasses.field(default_factory=list)
    sample_i: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def attempted(self) -> int:
        return self.queries_answered + self.queries_failed


def run(call, pool: np.ndarray, batch: int, *, rng: np.random.Generator,
        seconds: float = None, batches: int = None, sample: int = 16,
        mark=contextlib.nullcontext) -> Run:
    """Send batches to ``call(x) -> (D, I)`` for ``seconds`` (calls are
    sent while the window is open) or for ``batches`` calls. ``mark()``
    wraps each call (a profiler range in a traced run)."""
    nbatch = len(pool) // batch
    views = [pool[j * batch:(j + 1) * batch] for j in range(nbatch)]
    out = Run(batch=batch, latencies_s=[], starts_s=[], t_start=0.0,
              t_end=0.0, last=[None] * nbatch)
    i = 0
    out.t_start = out.t_end = time.perf_counter()
    deadline = out.t_start + seconds if seconds is not None else None
    while (out.t_end < deadline) if deadline is not None else i < batches:
        j = i % nbatch
        t0 = time.perf_counter()
        try:
            with mark():
                d, ids = call(views[j])
            if len(d) != batch or len(ids) != batch:
                raise ValueError(f"{len(d)} / {len(ids)} answers to a batch "
                                 f"of {batch}")
        except Exception:   # a failed call counts its queries as failed
            d = None
            out.errors.append(traceback.format_exc(limit=3))
        out.t_end = time.perf_counter()
        out.latencies_s.append(out.t_end - t0)
        out.starts_s.append(t0 - out.t_start)
        if d is None:
            out.queries_failed += batch
        else:
            out.queries_answered += batch
            out.last[j] = (d, ids)
            r = rng.integers(0, batch, sample)
            out.sample_rows.append(j * batch + r)
            out.sample_d.append(d[r])
            out.sample_i.append(ids[r])
        i += 1
    return out
