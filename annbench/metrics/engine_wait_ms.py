"""engine_wait_ms: the mean wait of a request of the window, from its due
time to the start of the search call that serves it (generator lateness,
the engine's queue and its batching wait)."""


def read(r):
    if r.waits_s is None or not len(r.waits_s):
        return None
    return float(r.waits_s.mean()) * 1e3
