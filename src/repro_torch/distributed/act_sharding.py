"""The process-wide sharding policy that model code reads (port of
`repro.distributed.act_sharding`).

`set_policy(grid, cp_attention=)` installs the grid that
`models.moe.moe_apply_ep` (expert parallelism) and `cp_attention_wrap`
(context-parallel attention) run on, as the reference's launchers install
their mesh; `set_policy(None)` clears it (unit-test mode), and the model
code then runs unsharded. The reference's activation specs pin GSPMD's
layouts at a few points; torch has no layout propagation, so the port
has no specs and `constrain` is the identity.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.launch.mesh import ProcessGrid, all_gather, \
    reduce_backward

_GRID: Optional[ProcessGrid] = None
_CP_ATTENTION = False       # context-parallel attention over `model`


def set_policy(grid: Optional[ProcessGrid], cp_attention: bool = False
               ) -> None:
    """Install `grid` as the process-wide policy (None clears it).
    `cp_attention` turns on sequence-sharded attention over `model`."""
    global _GRID, _CP_ATTENTION
    _GRID = grid
    _CP_ATTENTION = bool(cp_attention) and grid is not None \
        and "model" in grid.axis_names


def grid() -> Optional[ProcessGrid]:
    """The installed grid, or None."""
    return _GRID


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """The identity. The reference pins GSPMD's layout of `x` to its
    policy's spec `name` here; torch propagates no layouts, so the call
    stays only so that the model code reads like the reference's."""
    return x


class _SliceRows(torch.autograd.Function):
    """Forward: this rank's rows [lo, lo + n) of dim 1. Backward: the
    ranks' slices of the gradient all-gathered, the full gradient on
    every rank (q is replicated; each rank's rows are its own)."""

    @staticmethod
    def forward(ctx, x, lo, n, group, members):
        ctx.group, ctx.members = group, members
        return x[:, lo:lo + n]

    @staticmethod
    def backward(ctx, g):
        return _cat_rows(g, ctx.group, ctx.members), None, None, None, None


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows, concatenated along dim 1. Backward:
    this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, lo, group, members):
        ctx.lo, ctx.n = lo, x.shape[1]
        return _cat_rows(x, group, members)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.lo:ctx.lo + ctx.n].contiguous(), None, None, None


def _cat_rows(x: torch.Tensor, group, members) -> torch.Tensor:
    got = all_gather(x.contiguous(), group, members)     # (ways, B, n, ...)
    return torch.cat(list(got.unbind(0)), dim=1)


def cp_attention_wrap(attn_fn: Callable, seq_len: int) -> Optional[Callable]:
    """Context-parallel attention: the q sequence sharded over `model`.

    attn_fn(q, k, v, q_off) with q (B, S_local, H, hd) and k, v the full
    sequence. Returns fn(q, k, v) -> out (B, S, H, hd): this rank computes
    its S/ways query rows at q_off = rank * S_local against the full K and
    V, and the outputs are all-gathered. Under autograd the output's
    gradient comes back as this rank's slice, q's gradient is the ranks'
    slices gathered, and the K/V gradients are summed over `model`, so
    every rank gets the unsharded gradients. Returns None when CP does not
    apply: no policy, or S not divisible by the axis, or fewer than 128
    rows a rank (the reference's conditions)."""
    if not _CP_ATTENTION or _GRID is None:
        return None
    ways = _GRID.sizes["model"]
    if seq_len % ways or seq_len // ways < 128:
        return None
    group, members = _GRID.group(("model",))
    s_local = seq_len // ways
    off = _GRID.index(("model",)) * s_local

    def fn(q, k, v):
        ql = _SliceRows.apply(q, off, s_local, group, members)
        out = attn_fn(ql, reduce_backward(k, group),
                      reduce_backward(v, group), off)
        return _GatherRows.apply(out, off, group, members)

    return fn
