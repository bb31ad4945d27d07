"""The 95th percentile of all the window's request times, nearest rank:
from a request's first dispatch to its last pose on the host."""

import math

UNIT = "ms"


def read(win):
    lat = sorted(win.latencies_ms)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
