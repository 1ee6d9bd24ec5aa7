"""launch_idle_pct: the share of the traced stretch of ``search`` calls in
which the device is idle while the host is inside the steps that launch
its work, in percent: the spans ``tpu_ann_torch.ivf.coarse`` (the coarse
product and its top-nprobe), ``.plan`` (the pair plan and the queries'
fold), ``.kernel`` (the scan kernel's launch) and ``.merge`` (merge,
re-rank, the map to row ids) of ``models/ivf.py`` and
``ops/ivf_scan_fused.py``: the card waiting on the host's launches,
allocations and Python between kernels.

Counted as ``entry_idle_pct`` counts (its ``idle_by_span``: each idle
instant once, by the innermost ``tpu_ann_torch.`` span); reads nothing when the
trace holds no device operation or no ``tpu_ann_torch.`` span."""

from portbench.metrics.entry_idle_pct import share

UNIT = "%"
LAYER = "device"
MOVES = "qps"
SOURCE = "device_trace"
SPANS = ("ivf.coarse", "ivf.plan", "ivf.kernel", "ivf.merge")


def read(obs):
    return share(obs.timeline, SPANS)
