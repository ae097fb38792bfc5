"""Pipeline parallelism: the GPipe microbatch schedule over a `pp` grid
axis (port of `repro.distributed.pipeline`, on point-to-point sends where
the reference uses `shard_map` and `ppermute`).

Layers are stacked (L, ...) and cut into S stages of L/S layers; the rank
at stage s of the ("pp", "data") grid holds stage s's slice. M
microbatches flow through the S stages in S + M - 1 ticks: at tick t
stage 0 takes microbatch t, each stage applies its layers to what it
holds and sends the result to the next stage of its `data` column, and
the last stage banks its output for microbatch t - (S - 1). At the end
the last stage broadcasts the M outputs over `pp`. A stage runs only on
ticks where it holds a microbatch (the reference also computes on the
idle ticks and discards the results).

Only the forward is ported: a gradient through the schedule (which the
reference gets from `lax.scan`'s transpose) is an open item, so the
schedule runs without autograd.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch.mesh import ProcessGrid, broadcast, isend, recv


def make_pp_grid(n_stages: int, n_data: int = 1) -> ProcessGrid:
    """The ("pp", "data") grid of n_stages x n_data ranks."""
    return ProcessGrid((n_stages, n_data), ("pp", "data"))


def pipeline_forward(grid: ProcessGrid, stage_fn: Callable,
                     n_microbatches: int) -> Callable:
    """Returns fn(stage_params, x) running the GPipe schedule.

    stage_fn(params, x_mb) -> y_mb of x_mb's shape and dtype, applied by
    each rank to its own stage's params (its block over `pp` of the
    stacked layers, the leading stage dim dropped); x: (M, mb, ...) the
    microbatched inputs, the same on every rank (stage 0 reads them).
    Returns the last stage's (M, mb, ...) outputs on every rank. A
    collective: every rank of the grid calls it together."""
    S = grid.sizes["pp"]
    M = n_microbatches
    stage = grid.coords()[grid.axis_names.index("pp")]
    group, members = grid.group(("pp",))

    @torch.no_grad()
    def fn(params, x):
        if x.shape[0] != M:
            raise ValueError(f"x has {x.shape[0]} microbatches, not {M}")
        like = torch.empty_like(x[0])
        outs = torch.zeros_like(x)
        sends = []
        for t in range(S + M - 1):
            mb = t - stage                      # the microbatch held now
            if not 0 <= mb < M:
                continue
            buf = x[mb] if stage == 0 else recv(like, grid.rank_at(
                pp=stage - 1))
            y = stage_fn(params, buf)
            if stage == S - 1:
                outs[mb] = y
            else:
                sends.append(isend(y, grid.rank_at(pp=stage + 1)))
        for work, _ in sends:
            work.wait()
        return broadcast(outs, members[-1], group)

    return fn
