"""CUDA graphs of the port's fixed-shape paths: the search loop's hops
(`core.device_index`) and the retrieval request (`models.recsys`).

A graph replays its captured launches with one host call, so a path of
many small kernels and torch ops stops waiting on the host between them.
The kernel wrappers count their launches per replay: a capture records
them (`_build.recorded_launches`) and `Graph.replay` adds them to
`_build.launch_counts`. A capture that fails raises; nothing falls back
to eager launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def warm_up(*fns) -> None:
    """Run each fn once on a side stream, as a capture needs: it builds the
    kernel library and makes cuBLAS and the sorts allocate their workspaces
    before the graph fixes its memory."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)


class Graph:
    """fn captured once on the current device; `replay()` runs it again on
    the tensors it captured. `out` is what fn returned at capture: tensors
    that every replay overwrites. `pool` shares one memory pool between
    graphs that run one after another (`other.pool`)."""

    def __init__(self, fn, *, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        with _build.recorded_launches() as launches:
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.out = fn()
        self.launches = dict(launches)

    @property
    def pool(self):
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()
        _build.count_replay(self.launches)
