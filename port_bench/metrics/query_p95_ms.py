"""query_p95_ms.<analytic>: the 95th percentile (nearest rank) of the latency of
every query in the window, from the call to the result being ready."""

import math


def read(rec):
    lat = sorted(rec["latencies_s"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
