"""latency_p95_ms (end to end, host clock): the 95th percentile (nearest
rank) over every picture due in the window of the time from when it was
due to when its frame was synchronized on the device and handed back."""
import math


def read(w):
    lat = sorted(w.latencies_s)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
