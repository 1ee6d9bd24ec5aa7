"""scan_ms: milliseconds a batch spends in the list scan, the mean of
``search_stats(...).list_scan_us`` over the stats stretch
(``ops/ivf_scan_fused.py``: pair plan, kernel, merge, re-rank). The
program's span also holds the copy of the results to the host and the map
to user ids, so it measures more than the scan."""

UNIT = "ms"
LAYER = "list scan"
MOVES = "qps"
SOURCE = "program_span"


def read(obs):
    if not obs.stats:
        return None
    return sum(s.list_scan_us for s in obs.stats) / len(obs.stats) / 1e3
