"""latency_p95_ms: the 95th percentile of the same latencies: all of the
window's requests, not a summary of pieces."""
import numpy as np


def read(r):
    if r.latencies_s is None or not len(r.latencies_s):
        return None
    return float(np.percentile(r.latencies_s, 95)) * 1e3
