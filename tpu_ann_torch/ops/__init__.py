"""Operators: distances, k-means, packed invlists and the fused IVF scan."""

from . import distances, ivf_scan, ivf_scan_fused, kmeans  # noqa: F401
