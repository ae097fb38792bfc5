"""hop_roofline: the least time the card could take for the hops' work
(`roofline.hop_work` over the live frontier rows the reference expanded
for the replayed calls' queries) over the hop kernel's profiled device
time in those calls, in percent."""
from annbench import roofline, trace


def read(r):
    w = r.window
    if w is None or not r.lanes:
        return None
    t = w.op_seconds(trace.HOP)
    bound = roofline.bound_s(r.device_kind, roofline.hop_work(
        r.config, r.lanes, r.query_hops))
    if bound is None or t <= 0:
        return None
    return 100.0 * bound / t
