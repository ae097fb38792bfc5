"""Train state and the train / serve step factories of the recommender,
language-model and GNN families (port of `repro.distributed.train_step`).

The reference picks the GNN's sharded full-graph loss from the
environment (`REPRO_GNN=sharded`) and its global mesh; the port takes the
process grid as an argument (`grid=`, a `core.sharded_search.
ProcessGrid`). A train step runs the loss
forward and backward (autograd; the recommender tables get sparse
gradients, an LM's embedding a dense one) and the optimizer, which
updates the parameters and its state in place, as the reference's jitted
step does with its donated state.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device, to_tensor
from repro_torch.optim.adamw import (OptState, make_optimizer, param_tree,
                                     warmup_cosine)


class TrainState(NamedTuple):
    params: Any           # the model (an nn.Module), named by param_tree
    opt: OptState


def default_optimizer(total_steps: int = 10000, base_lr: float = 3e-4):
    return make_optimizer(warmup_cosine(base_lr, min(2000, total_steps // 10),
                                        total_steps))


def make_loss_fn(arch: ArchConfig, shape: ShapeConfig,
                 grid=None) -> Callable:
    """The family's loss(params, batch) -> (loss, metrics). A GNN
    full-graph shape with a `grid` takes the partitioned loss
    (`gnn_sharded.sharded_full_loss_fn`; batch["edges"] from
    `partition_edges`)."""
    if arch.family == "lm":
        from repro_torch.models.transformer import lm_loss
        return lambda p, b: lm_loss(p, b, arch.model)
    if arch.family == "recsys":
        from repro_torch.models.recsys import rec_loss
        return lambda p, b: rec_loss(p, b, arch.model)
    if arch.family == "gnn":
        from repro_torch.models import gnn as G
        if shape.kind == "gnn_minibatch":
            return lambda p, b: G.gnn_minibatch_loss(p, b, arch.model)
        if shape.kind == "gnn_batched":
            return lambda p, b: G.gnn_batched_loss(p, b, arch.model)
        if grid is not None:
            from repro_torch.models.gnn_sharded import sharded_full_loss_fn
            return sharded_full_loss_fn(grid, arch.model, shape.n_nodes)
        return lambda p, b: G.gnn_full_loss(p, b, arch.model)
    raise ValueError(arch.family)


def _grads(loss_fn, params: nn.Module, batch: dict):
    tree = param_tree(params)
    loss, metrics = loss_fn(params, batch)
    gs = torch.autograd.grad(loss, list(tree.values()), allow_unused=True)
    grads = dict(zip(tree, gs))
    for n, g in grads.items():
        # the recommender tables train on the rows `recsys.lookup` read; a
        # dense gradient would double their size. (An LM's `embed`, also a
        # row-wise leaf, gets a dense one: tied, it is the unembedding too.)
        if n.startswith("tables/") and g is not None and not g.is_sparse:
            raise RuntimeError(f"{n}: a dense gradient of shape "
                               f"{tuple(g.shape)}; tables train on "
                               "sparse gradients")
    return loss.detach(), metrics, grads


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    """a + b with None as zeros; two sparse gradients concatenate (the
    optimizer's coalesce sums their duplicate rows)."""
    if a is None or b is None:
        return b if a is None else a
    return a + b


def make_train_step(arch: ArchConfig, shape: ShapeConfig, optimizer=None,
                    microbatches: int = 1, grid=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); the state is
    updated in place. With `microbatches` > 1 the batch is cut into that
    many consecutive slices; their float32 gradients are summed and
    divided by the count, the loss is the mean of theirs and the other
    metrics are the last slice's. `grid`: see `make_loss_fn`."""
    loss_fn = make_loss_fn(arch, shape, grid)
    _, opt_update = optimizer or default_optimizer()

    def train_step(state: TrainState, batch: dict):
        if microbatches == 1:
            loss, metrics, grads = _grads(loss_fn, state.params, batch)
        else:
            g_sum: Dict[str, Optional[torch.Tensor]] = {}
            l_sum = None
            for i in range(microbatches):
                def sl(x):
                    per = x.shape[0] // microbatches
                    return x[i * per:(i + 1) * per]
                loss, metrics, g = _grads(loss_fn, state.params,
                                          {k: sl(v) for k, v in batch.items()})
                g_sum = {n: _add(g_sum.get(n), x) for n, x in g.items()}
                l_sum = loss if l_sum is None else l_sum + loss
            grads = {n: None if x is None else
                     (x.coalesce() if x.is_sparse else x) / microbatches
                     for n, x in g_sum.items()}
            loss = l_sum / microbatches
        _, _, stats = opt_update(grads, state.opt, state.params)
        return state, {"loss": loss, **metrics, **stats}

    return train_step


def make_serve_step(arch: ArchConfig, shape: ShapeConfig) -> Callable:
    """lm: `lm_prefill` (p, b) -> logits, or `lm_decode_step` as
    step(p, cache, b) -> (logits, cache); gnn: the full-graph, batched or
    minibatch forward's logits; recsys: CTR logits or the retrieval
    top-100."""
    if arch.family == "lm":
        from repro_torch.models import transformer as T
        if shape.kind == "lm_prefill":
            return lambda p, b: T.lm_prefill(p, b["tokens"], arch.model)
        if shape.kind == "lm_decode":
            def step(p, cache, b):
                return T.lm_decode_step(p, cache, b["token"], b["pos"],
                                        arch.model)
            return step
        raise ValueError((arch.family, shape.kind))
    if arch.family == "gnn":
        from repro_torch.models import gnn as G
        if shape.kind == "gnn_full":
            return lambda p, b: G.gnn_full_forward(
                p, b["feats"], b["edges"], arch.model, csr=b.get("csr"))
        if shape.kind == "gnn_batched":
            return lambda p, b: G.gnn_batched_forward(
                p, b["feats"], b["edges"], arch.model, csr=b.get("csr"))
        return lambda p, b: G.gnn_minibatch_forward(p, b, arch.model)
    if arch.family != "recsys":
        raise ValueError((arch.family, shape.kind))
    from repro_torch.models import recsys as R
    if shape.kind == "rec_retrieval":
        return lambda p, b: R.retrieval_topk(p, b, arch.model, k=100)
    return lambda p, b: R.rec_forward(p, b, arch.model)


def state_to(state: TrainState, device: DeviceLike = None) -> TrainState:
    """A copy of `state` on `device` (default: the card)."""
    dev = resolve_device(device)
    opt = OptState(state.opt.step.to(dev, copy=True),
                   *({n: t.to(dev, copy=True) for n, t in d.items()}
                     for d in (state.opt.m, state.opt.v, state.opt.master)))
    return TrainState(copy.deepcopy(state.params).to(dev), opt)


def _leaves(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{path: array} of a nested dict / list of arrays (a reference tree)."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def train_state_from_jax(state, *, device: DeviceLike = None) -> TrainState:
    """The reference's TrainState (params and OptState, as numpy arrays or
    anything `np.asarray` takes) as the port's, on `device`: an LM's
    (params with `embed` and `layers`), a GNN's (`layers` and `w_out`) or
    a recommender's."""
    dev = resolve_device(device)
    if "embed" in state.params and "layers" in state.params:
        from repro_torch.models.transformer import lm_params_from_jax
        params = lm_params_from_jax(state.params, device=dev)
    elif "w_out" in state.params and "layers" in state.params:
        from repro_torch.models.gnn import gnn_params_from_jax
        params = gnn_params_from_jax(state.params, device=dev)
    else:
        from repro_torch.models.recsys import recsys_params_from_jax
        params = recsys_params_from_jax(state.params, device=dev)
    names = list(param_tree(params))

    def opt_dict(tree):
        leaves = _leaves(tree)
        return {n: to_tensor(leaves[n], dev) for n in names}
    opt = state.opt
    return TrainState(params, OptState(
        to_tensor(np.asarray(opt.step), dev, torch.int32),
        opt_dict(opt.m), opt_dict(opt.v), opt_dict(opt.master)))
