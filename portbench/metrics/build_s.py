"""build_s: seconds to build the index, the host clock around the
program's ``train`` (its own k-means, and for IVFHNSW the graph over its
centroids) and around the window index's build from the benchmark's
centroids (the quantizer's ``add``, then ``add`` of the base rows:
``models/ivf.py`` ``add`` / ``_repack``, ``ops/ivf_scan.pack_invlists``),
each ended by a device sync."""

UNIT = "s"
LAYER = "index build"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(obs):
    return obs.build_s
