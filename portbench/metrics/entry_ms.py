"""entry_ms: milliseconds a batch spends in the entry steps of
``models/ivf.py`` ``IndexIVF.search``, the mean over the stats stretch of
``search_stats(...)``'s ``input_us + upload_us + output_us``: the checks
and parameters, the queries' copy to the card, and the results' copy to
the host with the map to user ids. Each is the program's span on the host
clock: the first two fenced by device syncs, the last starting after the
list scan's closing sync (the copy blocks the host until it is done).
Reads nothing when the stats hold no such fields (a program without the
spans)."""

UNIT = "ms"
LAYER = "entry"
MOVES = "qps"
SOURCE = "program_span"
FIELDS = ("input_us", "upload_us", "output_us")


def read(obs):
    if not obs.stats or not all(hasattr(obs.stats[0], f) for f in FIELDS):
        return None
    return sum(getattr(s, f) for s in obs.stats
               for f in FIELDS) / len(obs.stats) / 1e3
