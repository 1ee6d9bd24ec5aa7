"""scan_glue_ms: milliseconds a batch spends in the list scan's plain
torch around its kernel, the mean over the stats stretch of
``search_stats(...)``'s ``plan_us + merge_us``: the pair plan with the
queries' fold, and the merge, exact re-rank and map to row ids
(``ops/ivf_scan_fused.py`` ``_scan``). Each is the program's span on the
device's clock (a CUDA event pair, read after the list scan's closing
sync), so it holds the device's idle time between the step's operations.
Reads nothing when the stats hold no such fields (a program without the
spans)."""

UNIT = "ms"
LAYER = "list scan"
MOVES = "qps"
SOURCE = "program_span"
FIELDS = ("plan_us", "merge_us")


def read(obs):
    if not obs.stats or not all(hasattr(obs.stats[0], f) for f in FIELDS):
        return None
    return sum(getattr(s, f) for s in obs.stats
               for f in FIELDS) / len(obs.stats) / 1e3
