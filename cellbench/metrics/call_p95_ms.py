"""``call_p95_ms``: the 95th percentile (nearest rank) of the latency of
every call in the window, each from its issue until its result is
synchronised, read from two CUDA events on the device's clock."""

import math


def read(rec: dict):
    lat = sorted(rec.get("latency_ms") or [])
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
