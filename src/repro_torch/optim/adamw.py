"""Optimizers: AdamW (float32 master) and row-wise Adagrad for the huge
embedding tables, chosen per parameter by its tree path; global-norm
clipping and a warmup-cosine learning rate (port of `repro.optim.adamw`).

Row-wise Adagrad keeps ONE accumulator a row (state of V floats, not
V * D). A table whose gradient is a sparse COO tensor (the recommender's
embedding bags give one: the touched rows and their gradients) is updated
on its touched rows only. That computes the dense update exactly: a row
with a zero gradient adds 0 to its accumulator and moves by 0. Duplicate
ids are summed (coalesced) before anything squares them.

The state mirrors the reference's leaf for leaf, so checkpoints
interoperate: an AdamW leaf has full-shape `m` and `v`, a row-Adagrad leaf
`m` of shape (1,) (a placeholder) and `v` of shape (V,), and `master` is
(0,) for a float32 parameter. Parameters are named by the reference's tree
path (`param_tree`). `update` writes the new parameters and state into
the given tensors in place (the reference's train step donates them), and
returns them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn


class OptState(NamedTuple):
    step: torch.Tensor                # () int32
    m: Dict[str, torch.Tensor]        # AdamW first moment (placeholder for
                                      # row-Adagrad leaves)
    v: Dict[str, torch.Tensor]        # AdamW second moment / row accumulator
    master: Dict[str, torch.Tensor]   # float32 master copy ((0,) if the
                                      # parameter is float32 already)


def _path_key(path: str):
    # the reference's flatten order: dict keys sorted, list items by index
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in path.split("/"))


def param_tree(module: nn.Module) -> Dict[str, nn.Parameter]:
    """The module's parameters named by the reference's tree paths
    (`tables/0`, `blocks/1/ff/0/w`, `wide/3`, `item_proj`, `cross/2/b`,
    ...), in the order `jax.tree_util` flattens the reference's pytree."""
    named = {n.replace(".", "/"): p for n, p in module.named_parameters()}
    return {n: named[n] for n in sorted(named, key=_path_key)}


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable:
    """step (int tensor) -> float32 learning rate: linear warmup, then a
    cosine down to min_frac * base_lr, in float32 as the reference."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def is_embedding(path: str) -> bool:
    # the reference's rule, kept as it is: paths have no leading slash, so
    # Wide&Deep's `wide/i` never match "/wide/" (ROADMAP.md §3)
    return "tables" in path or path.endswith("embed") or "/wide/" in path


def _coalesced(g: torch.Tensor) -> torch.Tensor:
    return g.coalesce() if g.is_sparse else g


def global_norm(grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32. A sparse
    gradient is coalesced first (duplicate ids summed, then squared); a
    None gradient (an unused parameter) counts as zeros."""
    total = None
    for g in grads.values():
        if g is None:
            continue
        g = _coalesced(g)
        vals = g.values() if g.is_sparse else g
        sq = torch.sum(vals.to(torch.float32) ** 2)
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def make_optimizer(lr_fn: Callable, *, b1: float = 0.9, b2: float = 0.95,
                   eps: float = 1e-8, weight_decay: float = 0.1,
                   clip_norm: float = 1.0,
                   embedding_rule: str = "row_adagrad"):
    """Returns (init(params) -> OptState, update(grads, state, params) ->
    (params, state, stats)). `params` is a module or a {path: tensor}
    dict; `grads` a {path: tensor or None} dict (dense or sparse COO)."""

    def rule_for(path: str) -> str:
        return embedding_rule if is_embedding(path) else "adamw"

    def _params(params) -> Dict[str, torch.Tensor]:
        return param_tree(params) if isinstance(params, nn.Module) \
            else params

    def init(params) -> OptState:
        m, v, master = {}, {}, {}
        for n, p in _params(params).items():
            z = dict(dtype=torch.float32, device=p.device)
            if rule_for(n) == "row_adagrad":
                m[n] = torch.zeros((1,), **z)          # unused placeholder
                v[n] = torch.zeros(p.shape[:1], **z)   # per-row accumulator
            else:
                m[n] = torch.zeros(p.shape, **z)
                v[n] = torch.zeros(p.shape, **z)
            # zero-size sentinel == "param already fp32, no master needed"
            master[n] = (p.detach().to(torch.float32).clone()
                         if p.dtype != torch.float32
                         else torch.zeros((0,), **z))
        dev = next(iter(m.values())).device if m else None
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        m, v, master)

    @torch.no_grad()
    def update(grads, state: OptState, params,
               grad_norm: Optional[torch.Tensor] = None,
               row_mean: Optional[Callable] = None):
        """`grad_norm`: the clip's global norm when the caller knows it (a
        sharded step: the norm over every rank's blocks), else the norm
        of `grads`. `row_mean(path, g)`: a row-Adagrad leaf's mean square
        over each whole row, for a caller whose blocks cut the rows (else
        the mean over g's own columns)."""
        ps = _params(params)
        grads = {n: None if g is None else _coalesced(g)
                 for n, g in grads.items()}
        gn = (global_norm(grads) if grad_norm is None else grad_norm) \
            .to(state.step.device)
        scale = (torch.clamp(clip_norm / (gn + 1e-9), max=1.0)
                 if clip_norm else None)
        step = state.step + 1
        lr = lr_fn(step)
        stepf = step.to(torch.float32)
        bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf
        rows_touched = 0
        for n, p in ps.items():
            g = grads.get(n)
            m, v, master = state.m[n], state.v[n], state.master[n]
            has_master = master.numel() != 0
            x = master if has_master else p
            if g is None:                      # unused: a zero gradient
                g = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if rule_for(n) == "row_adagrad":
                # the touched rows of a sparse gradient, every row of a
                # dense one: an untouched row would add 0 and move by 0
                rows = (g.indices()[0] if g.is_sparse else
                        torch.arange(g.shape[0], device=g.device))
                gv = (g.values() if g.is_sparse else g).to(torch.float32)
                if scale is not None:
                    gv = gv * scale
                rows_touched += rows.numel()
                row_sq = (row_mean(n, gv) if row_mean is not None else
                          torch.mean(gv * gv, dim=tuple(range(1, gv.ndim))))
                v2 = v[rows] + row_sq
                v.index_copy_(0, rows, v2)
                denom = torch.sqrt(v2) + eps
                x2 = x[rows] - lr * gv / denom.reshape(
                    (-1,) + (1,) * (gv.ndim - 1))
                x.index_copy_(0, rows, x2)
                if has_master:
                    p.index_copy_(0, rows, x2.to(p.dtype))
                continue
            # AdamW moves every row: a sparse gradient is densified
            g = (g.to_dense() if g.is_sparse else g).to(torch.float32)
            if scale is not None:
                g = g * scale
            xf = x.to(torch.float32)
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            mh = m2 / bc1
            vh = v2 / bc2
            x2 = xf - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * xf)
            m.copy_(m2)
            v.copy_(v2)
            if has_master:
                master.copy_(x2)
            p.copy_(x2.to(p.dtype))
        state.step.copy_(step)
        return params, state, {"grad_norm": gn, "lr": lr,
                               "rows_touched": rows_touched}

    return init, update
