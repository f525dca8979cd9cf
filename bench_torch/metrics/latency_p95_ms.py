"""95th percentile over all calls of the window of each call's time from
when it was due to when its result was on the host (nearest rank)."""

import math


def read(r):
    lat = sorted(r.window["latency_ms"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
