"""loop_device_ms_per_query: device time of every operation of the
replayed calls that is not the hop, distance-table or rerank kernel (the
search loop's sorts, gathers, scatters and copies), per query served."""
from annbench import trace


def read(r):
    w = r.window
    if w is None or not r.traced_queries:
        return None
    rest = w.op_seconds() - sum(w.op_seconds(k) for k in
                                (trace.HOP, trace.LUT, trace.RERANK))
    return rest * 1e3 / r.traced_queries
