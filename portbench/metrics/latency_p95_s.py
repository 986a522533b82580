"""latency_p95_s: the 95th percentile (nearest rank) of submit -> last
token over every request completed in the window."""
import math


def read(run):
    lat = sorted(run.latencies)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
