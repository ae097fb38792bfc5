"""setup_s: process start to the window's first query (drawing the
inputs, packing the index, warming up and capturing every shape)."""


def read(r):
    return r.setup_s
