"""batch_mean: requests a search call over the window, as the engine
batched them."""


def read(r):
    if r.traffic["kind"] != "open" or not r.calls:
        return None
    return r.completed / r.calls
