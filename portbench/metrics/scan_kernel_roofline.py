"""scan_kernel_roofline: the list-scan kernels' share of their
roofline over the traced stretch, in percent: the least time the work
needs (its bytes over the card's peak bandwidth; the scan is bound by
bytes) over the device time of the kernels named below.

The bytes come from each call's probes and the lists' sizes, not from the
kernels' block layout (`portbench.core.work.ivf_scan_bytes`). The peak is
the H100 SXM's at 700 W; the run states the card's power limit beside it.
Reads nothing (the metric is left out) when none of the kernels ran."""

import re

from portbench.core import work

UNIT = "%"
LAYER = "scan kernels"
MOVES = "qps"
SOURCE = "device_trace"
# K3 at kp <= 32, 33-64 and >= 65 (csrc/ivf_scan_fused.cu)
KERNELS = ("ivf_scan_fused_kernel", "ivf_scan_fused_wide_kernel",
           "ivf_scan_fused_global_kernel")
_NAMED = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def read(obs):
    us = sum(e - s for s, e, name in obs.timeline.device
             if _NAMED.search(name))
    if us <= 0 or not obs.call_probes:
        return None
    nbytes = sum(work.ivf_scan_bytes(p, obs.list_sizes, obs.d, obs.k)
                 for p in obs.call_probes)
    return 100.0 * nbytes / work.PEAK_HBM_BYTES_S / (us / 1e6)
