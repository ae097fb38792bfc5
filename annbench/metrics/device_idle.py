"""device_idle: the share of the wall time of the window's last calls in
which no operation ran on the device, in percent: their device busy time
from the profiled replay of the same calls, over the span they took in
the window."""


def read(r):
    w = r.window
    if w is None or r.traced_span_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / r.traced_span_s)
