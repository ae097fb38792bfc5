"""qps: queries completed in the window over the window's seconds (a
closed loop: the window runs from the first call's start to the last
call's return)."""


def read(r):
    if r.traffic["kind"] != "closed" or r.window_s <= 0:
        return None
    return r.completed / r.window_s
