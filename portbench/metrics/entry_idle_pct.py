"""entry_idle_pct: the share of the traced stretch of ``search`` calls in
which the device is idle while the host is inside the program's entry
steps, in percent: the spans ``tpu_ann_torch.ivf.input`` (checks and
parameters), ``.upload`` (the queries' copy to the card) and ``.output``
(the results' copy to the host and the map to user ids) of
``models/ivf.py`` ``IndexIVF.search``.

Idle time is the complement of the union of the device's operations over
the window (``Timeline.busy_intervals``, as ``device_idle_pct`` reads
it). Each idle instant goes to the innermost ``tpu_ann_torch.`` host
span that covers it, by exact intersection of intervals, so no instant is
counted twice and this share plus ``launch_idle_pct`` is at most
``device_idle_pct``; the rest is idle outside the program's spans (the
loop between calls, the call's own Python around its steps). Reads
nothing when the trace holds no device operation or no
``tpu_ann_torch.`` span."""

import numpy as np

UNIT = "%"
LAYER = "entry"
MOVES = "qps"
SOURCE = "device_trace"
PREFIX = "tpu_ann_torch."
SPANS = ("ivf.input", "ivf.upload", "ivf.output")


def idle_intervals(timeline) -> list:
    """[(start, end)] of the window in which no device operation runs."""
    w0, w1 = timeline.window
    out, t = [], w0
    for s, e in timeline.busy_intervals():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < w1:
        out.append((t, w1))
    return out


def idle_by_span(timeline):
    """{span name without the prefix: idle microseconds under it as the
    innermost ``tpu_ann_torch.`` span}, or None when the trace holds no device
    operation or no such span."""
    spans = [h for h in timeline.host if h[2].startswith(PREFIX)]
    if not spans or not timeline.device:
        return None
    hs = np.array([h[0] for h in spans], np.float64)
    he = np.array([h[1] for h in spans], np.float64)
    length = he - hs
    edges = np.concatenate((hs, he))
    by = {}
    for g0, g1 in idle_intervals(timeline):
        cuts = np.unique(np.concatenate(
            ([g0, g1], edges[(edges > g0) & (edges < g1)])))
        for a, b in zip(cuts[:-1], cuts[1:]):
            cover = np.nonzero((hs <= a) & (he >= b))[0]
            if len(cover):
                name = spans[cover[np.argmin(length[cover])]][2]
                name = name[len(PREFIX):]
                by[name] = by.get(name, 0.0) + float(b - a)
    return by


def share(timeline, names) -> float:
    """Percent of the window that is idle under the spans ``names``, or
    None (see ``idle_by_span``)."""
    by = idle_by_span(timeline)
    w = timeline.window[1] - timeline.window[0]
    if by is None or w <= 0:
        return None
    return 100.0 * sum(by.get(n, 0.0) for n in names) / w


def read(obs):
    return share(obs.timeline, SPANS)
