"""device_idle_pct: the share of the traced stretch of ``search`` calls in
which no operation runs on the device (100 minus the union of the
intervals of its kernels, copies and sets over the stretch), in percent.
It stands for the entry layer (``models/ivf.py`` ``search``: the upload,
the map to user ids, the copy out) until the program has spans there."""

UNIT = "%"
LAYER = "device"
MOVES = "qps"
SOURCE = "device_trace"


def read(obs):
    w = obs.timeline.window_s
    if w <= 0 or not obs.timeline.device:
        return None
    return 100.0 * (1.0 - obs.timeline.busy_s / w)
