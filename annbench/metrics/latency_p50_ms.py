"""latency_p50_ms: the median latency of every request due in the window,
each timed from its due time to the ids' return (an open loop)."""
import numpy as np


def read(r):
    if r.latencies_s is None or not len(r.latencies_s):
        return None
    return float(np.percentile(r.latencies_s, 50)) * 1e3
