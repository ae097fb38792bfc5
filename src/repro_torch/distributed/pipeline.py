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

The schedule is differentiable (`torch.autograd.Function`, GPipe's
backward): the forward keeps each stage's received input for each
microbatch; the backward runs the ticks from the last stage to the
first, in microbatch order. At its tick a stage recomputes `stage_fn` on
its kept input under autograd, takes its output's cotangent (the last
stage: the output's own, which is replicated, so taken once and not once
a stage; the others: received from the next stage), sends its input's
cotangent to the previous stage and adds its parameters' gradients in
microbatch order. Stage 0's input cotangents are x's gradient,
broadcast over `pp` (x is replicated). This is the gradient of the
stages applied in sequence, and `jax.grad` through the reference's
schedule gives the same (`tests/test_torch_pipeline.py` holds both).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import ProcessGrid, broadcast, isend, recv


def make_pp_grid(n_stages: int, n_data: int = 1) -> ProcessGrid:
    """The ("pp", "data") grid of n_stages x n_data ranks."""
    return ProcessGrid((n_stages, n_data), ("pp", "data"))


def pipeline_forward(grid: ProcessGrid, stage_fn: Callable,
                     n_microbatches: int) -> Callable:
    """Returns fn(stage_params, x) running the GPipe schedule.

    stage_fn(params, x_mb) -> y_mb of x_mb's shape and dtype, applied by
    each rank to its own stage's params (a tensor or a tree of tensors:
    its block over `pp` of the stacked layers, the leading stage dim
    dropped); x: (M, mb, ...) the microbatched inputs, the same on every
    rank (stage 0 reads them). Returns the last stage's (M, mb, ...)
    outputs on every rank, differentiable in the params and x (module
    docstring). A collective: every rank of the grid calls it together,
    and, under autograd, runs the backward together."""
    S = grid.sizes["pp"]
    M = n_microbatches
    stage = grid.coords()[grid.axis_names.index("pp")]
    group, members = grid.group(("pp",))
    prev_rank = grid.rank_at(pp=stage - 1) if stage > 0 else None
    next_rank = grid.rank_at(pp=stage + 1) if stage < S - 1 else None

    class _Schedule(torch.autograd.Function):
        @staticmethod
        def forward(ctx, spec, x, *leaves):
            params = pytree.tree_unflatten(list(leaves), spec)
            like = torch.empty_like(x[0])
            outs = torch.zeros_like(x)
            kept = [None] * M
            sends = []
            for t in range(S + M - 1):
                mb = t - stage                  # the microbatch held now
                if not 0 <= mb < M:
                    continue
                buf = x[mb] if stage == 0 else recv(like, prev_rank)
                kept[mb] = buf
                y = stage_fn(params, buf)
                if stage == S - 1:
                    outs[mb] = y
                else:
                    sends.append(isend(y, next_rank))
            for work, _ in sends:
                work.wait()
            ctx.spec, ctx.kept = spec, kept
            ctx.save_for_backward(*leaves)
            return broadcast(outs, members[-1], group)

        @staticmethod
        def backward(ctx, g_out):
            leaves = ctx.saved_tensors
            like = torch.empty_like(ctx.kept[0])
            g_x = torch.zeros((M,) + tuple(like.shape), dtype=g_out.dtype,
                              device=g_out.device)
            g_leaves = [None] * len(leaves)
            sends = []
            # the last stage takes microbatch t at tick t, stage s at tick
            # t + (S - 1 - s): each stage sees its microbatches in order
            for t in range(S + M - 1):
                mb = t - (S - 1 - stage)
                if not 0 <= mb < M:
                    continue
                cot = g_out[mb] if stage == S - 1 else recv(like, next_rank)
                with torch.enable_grad():
                    xin = ctx.kept[mb].detach().requires_grad_(True)
                    ps = [p.detach().requires_grad_(p.requires_grad)
                          for p in leaves]
                    y = stage_fn(pytree.tree_unflatten(ps, ctx.spec), xin)
                    wrt = [xin] + [p for p in ps if p.requires_grad]
                    # sum(y * cot)'s gradient in y is cot exactly; given as
                    # grad_outputs, torch's first call imports ~500
                    # modules (seconds a stage, one stage after another)
                    got = list(torch.autograd.grad((y * cot).sum(), wrt,
                                                   allow_unused=True))
                g_in = got.pop(0)
                g_in = torch.zeros_like(xin) if g_in is None else g_in
                for i, p in enumerate(ps):
                    if p.requires_grad:
                        g = got.pop(0)
                        if g is not None:
                            g_leaves[i] = g if g_leaves[i] is None \
                                else g_leaves[i] + g
                if stage == 0:
                    g_x[mb] = g_in
                else:
                    sends.append(isend(g_in.contiguous(), prev_rank))
            for work, _ in sends:
                work.wait()
            ctx.kept = None
            g_x = broadcast(g_x, members[0], group)
            return (None, g_x, *g_leaves)

    def fn(params, x):
        if x.shape[0] != M:
            raise ValueError(f"x has {x.shape[0]} microbatches, not {M}")
        leaves, spec = pytree.tree_flatten(params)
        return _Schedule.apply(spec, x, *leaves)

    return fn
