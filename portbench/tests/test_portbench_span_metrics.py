"""The four readers of the program's spans (``entry_ms``,
``scan_glue_ms``, ``entry_idle_pct``, ``launch_idle_pct``) on a synthetic
timeline and fake search stats: exact values, no idle instant counted
twice, and nothing read where the program has no spans."""

import os
import types

import numpy as np
import pytest

from portbench.core import spec, trace

from .conftest import ROOT

PB = os.path.join(ROOT, "portbench")


def reader(name):
    return spec.load_module(os.path.join(PB, "metrics", name + ".py"))


def span(name, s, e):
    return (float(s), float(e), "tpu_ann_torch." + name)


# device busy on [10, 30) and [50, 60) of a window [0, 100); one call
# whose steps are spans, an aten op inside the output (not a span), and
# idle time outside every span at [0, 5) and [95, 100)
TIMELINE = trace.Timeline(
    window=(0.0, 100.0),
    device=[(10.0, 20.0, "k1"), (15.0, 30.0, "k2"), (50.0, 60.0, "k3")],
    host=[(0.0, 100.0, trace.WINDOW), (4.0, 96.0, trace.CALL),
          span("ivf.search", 5, 95), span("ivf.input", 5, 15),
          span("ivf.upload", 15, 25), span("ivf.coarse", 25, 40),
          span("ivf.plan", 40, 45), span("ivf.kernel", 45, 55),
          span("ivf.merge", 55, 70), span("ivf.output", 70, 88),
          (72.0, 80.0, "aten::copy_")])


def obs(timeline=TIMELINE, stats=()):
    return types.SimpleNamespace(timeline=timeline, stats=list(stats))


def test_idle_shares_exact():
    # entry: input [5, 10), output [70, 88)
    assert reader("entry_idle_pct").read(obs()) == pytest.approx(23.0)
    # launch: coarse [30, 40), plan [40, 45), kernel [45, 50),
    # merge [60, 70)
    assert reader("launch_idle_pct").read(obs()) == pytest.approx(30.0)
    assert reader("device_idle_pct").read(obs()) == pytest.approx(70.0)


def test_each_idle_instant_goes_to_its_innermost_span_once():
    by = reader("entry_idle_pct").idle_by_span(TIMELINE)
    assert by == {"ivf.input": 5.0, "ivf.coarse": 10.0, "ivf.plan": 5.0,
                  "ivf.kernel": 5.0, "ivf.merge": 10.0,
                  "ivf.output": 18.0, "ivf.search": 7.0}
    # with the 10 us outside every span, the whole idle time, once
    assert sum(by.values()) + 10.0 == pytest.approx(70.0)


@pytest.mark.parametrize("seed", range(8))
def test_shares_never_exceed_the_idle_time(seed):
    """Random calls of nested spans over random device operations: the
    idle time under the spans never passes the device's idle time, and
    the two shares never pass device_idle_pct."""
    rs = np.random.RandomState(seed)
    host, device, t = [(0.0, 1000.0, trace.WINDOW)], [], 0.0
    while t < 950:
        s0 = t + rs.uniform(0, 10)
        edges = np.sort(rs.uniform(s0, s0 + 60, 8))
        host.append(span("ivf.search", edges[0], edges[-1]))
        names = ("ivf.input", "ivf.upload", "ivf.coarse", "ivf.plan",
                 "ivf.kernel", "ivf.merge", "ivf.output")
        for n, a, b in zip(names, edges[:-1], edges[1:]):
            host.append(span(n, a, b))
            if rs.rand() < 0.3:       # a nested chunk's span
                host.append(span("ivf.plan", a, (a + b) / 2))
        t = edges[-1]
    for _ in range(120):
        s = rs.uniform(-20, 1000)
        device.append((s, s + rs.exponential(6), "k"))
    tl = trace.Timeline((0.0, 1000.0), device, host)
    idle_us = 1000.0 - tl.busy_s * 1e6
    by = reader("entry_idle_pct").idle_by_span(tl)
    assert sum(by.values()) <= idle_us + 1e-6
    e = reader("entry_idle_pct").read(obs(tl))
    la = reader("launch_idle_pct").read(obs(tl))
    assert 0 <= e and 0 <= la
    assert e + la <= reader("device_idle_pct").read(obs(tl)) + 1e-9


def test_idle_shares_read_nothing_without_spans_or_device():
    no_spans = trace.Timeline(
        TIMELINE.window, TIMELINE.device,
        [h for h in TIMELINE.host if not h[2].startswith("tpu_ann_torch.")])
    no_device = trace.Timeline(TIMELINE.window, [], TIMELINE.host)
    for name in ("entry_idle_pct", "launch_idle_pct"):
        assert reader(name).read(obs(no_spans)) is None
        assert reader(name).read(obs(no_device)) is None


def fake_stats(**fields):
    return types.SimpleNamespace(**fields)


def test_span_ms_exact():
    stats = [fake_stats(input_us=100.0, upload_us=1000.0, output_us=4000.0,
                        plan_us=2000.0, merge_us=3000.0),
             fake_stats(input_us=300.0, upload_us=1200.0, output_us=5000.0,
                        plan_us=2500.0, merge_us=3500.0)]
    assert reader("entry_ms").read(obs(stats=stats)) == pytest.approx(5.8)
    assert reader("scan_glue_ms").read(obs(stats=stats)) == \
        pytest.approx(5.5)


def test_span_ms_read_nothing_without_stats_or_fields():
    # a program without the spans: its stats hold the fork's fields alone
    old = [fake_stats(quantization_us=10.0, list_scan_us=20.0)]
    for name in ("entry_ms", "scan_glue_ms"):
        assert reader(name).read(obs(stats=())) is None
        assert reader(name).read(obs(stats=old)) is None
