"""The spans of tpu_ann_torch's IVF search (tpu_ann_torch.trace): what the
profiler sees of one search, that they cost nothing with no consumer, and
the SearchStats fields that search_stats fills from them, on a small CPU
IndexIVFFlat (the fused scan's plain version). The tests marked ``cuda``
check the CUDA event clock on the card and skip without one:
    python -m pytest --noconftest -q tests/test_torch_trace.py -m cuda
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_ann_torch as T
from tpu_ann_torch import trace
from tpu_ann_torch.models import base as tbase

N, NQ, D, K, NLIST, NPROBE = 2000, 16, 16, 5, 16, 4
NEW_FIELDS = ("input_us", "upload_us", "plan_us", "merge_us", "output_us",
              "pinned_bytes")
SCAN_PARTS = ("plan_us", "merge_us", "output_us")


def _index(device):
    rs = np.random.RandomState(3)
    xb = rs.randint(0, 64, (N, D)).astype(np.float32)
    xq = rs.randint(0, 64, (NQ, D)).astype(np.float32)
    index = T.make_ivf_flat(D, NLIST, device=device)
    index.cp.niter = 3
    index.train(xb)
    index.add_with_ids(xb, 100 + np.arange(N, dtype=np.int64))
    index.nprobe = NPROBE
    return index, xq


@pytest.fixture(scope="module")
def ivf():
    return _index("cpu")


def _spans(prof):
    """[(name without the prefix, start, end)] of the search's spans, in
    the order they start."""
    out = [(e.name[len(trace.PREFIX):], e.time_range.start,
            e.time_range.end) for e in prof.events()
           if e.name.startswith(trace.PREFIX)]
    return sorted(out, key=lambda s: s[1])


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, prof


def test_profiler_sees_each_span_once_inside_the_call_in_order(ivf):
    index, xq = ivf
    _, prof = _profiled(lambda: index.search(xq, K))
    spans = _spans(prof)
    assert [s[0] for s in spans] == list(trace.SPANS)
    _, s0, e0 = spans[0]
    for name, s, e in spans[1:]:
        assert s0 <= s <= e <= e0, name
    for (_, _, e), (name, s, _) in zip(spans[1:], spans[2:]):
        assert e <= s, f"{name} starts before the step ahead of it ends"


def test_no_consumer_enters_no_record_function(ivf, monkeypatch):
    """With no profiler and no collector a span is the shared no-op
    context; under the profiler the same search enters one range a
    span."""
    index, xq = ivf
    entered = []
    real = trace.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(trace, "record_function", counting)
    assert trace.span("ivf.plan") is trace._OFF
    index.search(xq, K)
    assert entered == []
    _profiled(lambda: index.search(xq, K))
    assert sorted(entered) == sorted(trace.PREFIX + n for n in trace.SPANS)


def test_results_do_not_depend_on_the_profiler(ivf):
    index, xq = ivf
    D0, I0 = index.search(xq, K)
    (D1, I1), _ = _profiled(lambda: index.search(xq, K))
    (D2, I2, _), _ = _profiled(lambda: index.search_stats(xq, K))
    for Dx, Ix in ((D1, I1), (D2, I2)):
        np.testing.assert_array_equal(Dx, D0)
        np.testing.assert_array_equal(Ix, I0)
    assert I0.min() >= 100                        # user ids, not rows


def test_search_stats_fills_accumulates_and_lists_the_new_fields(ivf):
    index, xq = ivf
    _, _, st = index.search_stats(xq, K)
    for f in NEW_FIELDS:
        assert getattr(st, f) >= 0, f
    for f in ("plan_us", "merge_us", "output_us", "upload_us"):
        assert getattr(st, f) > 0, f
    assert st.total_us == pytest.approx(st.quantization_us
                                        + st.list_scan_us)
    listed = st.as_dict()
    assert set(NEW_FIELDS) <= set(listed)
    total = T.SearchStats()
    total.accumulate(st)
    total.accumulate(st)
    for f in NEW_FIELDS:
        assert getattr(total, f) == pytest.approx(2 * listed[f]), f
    total.reset()
    assert all(getattr(total, f) == 0 for f in NEW_FIELDS)


def test_search_stats_sums_lists_and_resets_pinned_bytes():
    st = T.SearchStats(nq=4, pinned_bytes=4 * D * 4 + 4 * K * 12)
    assert st.as_dict()["pinned_bytes"] == 4 * D * 4 + 4 * K * 12
    total = T.SearchStats()
    total.accumulate(st)
    total.accumulate(st)
    assert total.pinned_bytes == 2 * st.pinned_bytes
    total.reset()
    assert total.pinned_bytes == 0 and type(total.pinned_bytes) is int


def test_pinned_bytes_is_zero_on_a_cpu_device(ivf):
    """A CPU index copies nothing through page-locked memory, whatever the
    input: a numpy array, a read-only one, a tensor."""
    index, xq = ivf
    ro = xq.copy()
    ro.flags.writeable = False
    D0, I0 = index.search(xq, K)
    for x in (xq, ro, torch.from_numpy(xq)):
        Dx, Ix, st = index.search_stats(x, K)
        assert st.pinned_bytes == 0 and st.nq == NQ
        np.testing.assert_array_equal(Dx, D0)
        np.testing.assert_array_equal(Ix, I0)


def test_count_adds_only_under_a_collector():
    """trace.count is a no-op without a collector; under one it adds to
    the field, inside a timed span too (a count is no time)."""
    trace.count("pinned_bytes", 100)
    st = T.SearchStats()
    with trace.collect(st, "cpu"):
        trace.count("pinned_bytes", 100)
        with trace.span("ivf.output"):
            trace.count("pinned_bytes", 20)
    trace.count("pinned_bytes", 100)
    assert st.pinned_bytes == 120 and type(st.pinned_bytes) is int


def test_scan_parts_lie_within_list_scan_us(ivf):
    index, xq = ivf
    for _ in range(3):
        _, _, st = index.search_stats(xq, K)
        parts = sum(getattr(st, f) for f in SCAN_PARTS)
        assert 0 < parts <= st.list_scan_us + 1.0, st


def test_global_stats_sum_the_new_fields(ivf):
    index, xq = ivf
    tbase.indexIVF_stats.reset()
    _, _, a = index.search_stats(xq, K)
    _, _, b = index.search_stats(xq, K)
    g = tbase.indexIVF_stats
    assert g.nq == 2 * NQ
    for f in NEW_FIELDS:
        assert getattr(g, f) == pytest.approx(getattr(a, f) + getattr(b, f))


def test_query_major_route_has_no_fused_scan_parts(ivf):
    """A selector sends the search to the query-major scan: no plan,
    kernel or merge span runs, the entry fields and the fence still
    fill."""
    index, xq = ivf
    params = T.SearchParametersIVF(
        nprobe=NPROBE, sel=T.IDSelectorRange(100, 100 + N // 2))
    _, _, st = index.search_stats(xq, K, params=params)
    assert st.plan_us == st.merge_us == 0
    assert st.input_us > 0 and st.upload_us > 0 and st.output_us > 0
    assert st.list_scan_us > st.output_us
    _, prof = _profiled(lambda: index.search(xq, K, params=params))
    names = [s[0] for s in _spans(prof)]
    assert "ivf.kernel" not in names and "ivf.output" in names


def test_chunked_search_runs_the_steps_once_a_chunk(ivf):
    index, xq = ivf
    D0, I0 = index.search(xq, K)
    index.search_chunk = 6
    try:
        (D1, I1), prof = _profiled(lambda: index.search(xq, K))
    finally:
        index.search_chunk = 0
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)
    names = [s[0] for s in _spans(prof)]
    chunks = -(-NQ // 6)
    assert names.count("ivf.search") == names.count("ivf.input") == 1
    for n in ("ivf.upload", "ivf.coarse", "ivf.kernel", "ivf.output"):
        assert names.count(n) == chunks, n


def test_search_device_runs_the_device_steps_spans(ivf):
    """search_device shares search's coarse step and scan: the same rows,
    under the profiler the coarse, plan, kernel and merge spans alone."""
    index, xq = ivf
    D0, I0 = index.search(xq, K)
    (Dv, Iv), prof = _profiled(
        lambda: index.search_device(torch.from_numpy(xq), K))
    np.testing.assert_array_equal(Dv.numpy(), D0)
    np.testing.assert_array_equal(index._map_ids(Iv.numpy()), I0)
    assert [s[0] for s in _spans(prof)] == [
        "ivf.coarse", "ivf.plan", "ivf.kernel", "ivf.merge"]


def test_a_span_inside_a_timed_span_adds_nothing():
    """A scan run inside the coarse step (an IVF quantizer's) counts as
    coarse time alone, its fence too; a fence outside a collector, and a
    span of no field, are no-ops."""
    st = T.SearchStats()
    with trace.collect(st, "cpu"):
        with trace.span("ivf.search"):
            with trace.span("ivf.coarse"):
                with trace.fence("list_scan_us"):
                    with trace.span("ivf.plan"):
                        sum(range(1000))
    assert st.quantization_us > 0
    assert st.plan_us == st.list_scan_us == 0
    assert trace.fence("list_scan_us") is trace._OFF


def test_collector_is_cleared_after_an_error(ivf):
    index, _ = ivf
    with pytest.raises(ValueError):
        index.search_stats(np.zeros((2, D + 1), np.float32), K)
    assert trace.span("ivf.kernel") is trace._OFF


@pytest.mark.cuda
def test_device_clock_on_the_card():
    """On the card, plan and merge read CUDA event pairs inside the list
    scan's fenced interval, the output the host clock after it: their sum
    stays within list_scan_us, and the spans' ranges on the device's
    timeline are annotations, not device work."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from torch.autograd import DeviceType

    index, xq = _index("cuda")
    D0, I0 = index.search(xq, K)
    for _ in range(3):
        D1, I1, st = index.search_stats(xq, K)
        parts = sum(getattr(st, f) for f in SCAN_PARTS)
        assert st.plan_us > 0 and parts <= st.list_scan_us, st
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)
    (D2, _), prof = _profiled(lambda: index.search(xq, K),
                              (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    np.testing.assert_array_equal(D2, D0)
    assert [s[0] for s in _spans(prof) if s[0] in trace.SPANS]
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                e.name.startswith(trace.PREFIX):
            assert e.is_user_annotation, e.name
