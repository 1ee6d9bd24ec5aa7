"""coarse_ms: milliseconds a batch spends in coarse quantization, the mean
of ``search_stats(...).quantization_us`` over the stats stretch (the
exact product over the centroids and its top-nprobe,
``models/ivf.py`` ``_coarse_search_device``; the program's own span,
fenced by device syncs)."""

UNIT = "ms"
LAYER = "coarse quantizer"
MOVES = "qps"
SOURCE = "program_span"


def read(obs):
    if not obs.stats:
        return None
    return sum(s.quantization_us for s in obs.stats) / len(obs.stats) / 1e3
