"""Train state and the train / serve step factories of the recommender,
language-model and GNN families (port of `repro.distributed.train_step`).

A train step runs the loss forward and backward (autograd; the
recommender tables get sparse gradients, an LM's embedding a dense one)
and the optimizer, which updates the parameters and its state in place,
as the reference's jitted step does with its donated state.

On a process grid (`grid=`, a `launch.mesh.ProcessGrid`; the reference's
mesh) the state is sharded as `distributed.sharding`'s rules say
(`Placement`, `shard_state`) and the step is the counterpart of the
reference's GSPMD step:
  * the global batch is split over the dp axes (`batch_specs`);
  * an LM leaf sharded by `lm_param_rule` is gathered at use, one layer at
    a time, and its gradient is averaged over dp and cut to this rank's
    block in the backward (`sharding.LeafGather`);
  * a row-sharded recommender table is read through its own rows and a
    sum over `model` (`recsys.table_rows`, `recsys.bags`); its sparse
    gradient, by local row, is exchanged over dp (ids and values
    all-gathered), never densified;
  * the other (replicated) dense gradients are averaged over dp with a
    float32 all-reduce (`compression.make_compressed_dp_grads` is the
    separate int8 entry point);
  * the clip's global norm sums the squares of every block once (a
    replicated block on the rank whose other coordinates are 0);
  * the GNN's full-graph step keeps its partitioned loss (`gnn_sharded`,
    picked by `make_loss_fn(arch, shape, grid)`), whose gradients are the
    global ones already; its sampled-minibatch and batched-graph steps
    are data parallel like the others.
The optimizer then updates each rank's blocks: AdamW and row-wise Adagrad
are elementwise and row-wise, so the blocks of the update are the update
of the blocks. No tensor-parallel arithmetic: the ranks of a `model` group
compute the same activations.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device, to_tensor
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import all_gather_ragged, all_reduce
from repro_torch.optim.adamw import (OptState, make_optimizer, param_tree,
                                     warmup_cosine)


class TrainState(NamedTuple):
    params: Any           # the model (an nn.Module), named by param_tree
    opt: OptState


def default_optimizer(total_steps: int = 10000, base_lr: float = 3e-4):
    return make_optimizer(warmup_cosine(base_lr, min(2000, total_steps // 10),
                                        total_steps))


def make_loss_fn(arch: ArchConfig, shape: ShapeConfig, grid=None,
                 wire_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """The family's loss(params, batch) -> (loss, metrics). A GNN
    full-graph shape with a `grid` takes the partitioned loss
    (`gnn_sharded.sharded_full_loss_fn` with its states gathered in
    `wire_dtype`; batch["edges"] from `partition_edges`)."""
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
            return sharded_full_loss_fn(grid, arch.model, shape.n_nodes,
                                        wire_dtype=wire_dtype)
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


class Placement(NamedTuple):
    """Where a sharded train state lives: the grid, the parameters' specs
    and full shapes (by `param_tree` path), the optimizer state's specs,
    and {checkpoint leaf name: (spec, full shape)} for `ckpt.save` and
    `ckpt.restore` on the grid."""
    grid: Any
    family: str
    params: Dict[str, tuple]
    shapes: Dict[str, tuple]
    opt: OptState
    leaves: Dict[str, Tuple[tuple, tuple]]


def placement(family: str, grid, skeleton: "TrainState",
              **rule_kw) -> Placement:
    """The placement of a state like `skeleton` (a full state, e.g. on the
    meta device; its `opt` None for parameters alone) under the family's
    rule (`rule_kw`: `rec_param_rule`'s `tablewise`, ...)."""
    tree = param_tree(skeleton.params)
    shapes = {n: tuple(t.shape) for n, t in tree.items()}
    specs = SH.spec_tree(shapes, SH.param_rule(family, grid, **rule_kw))
    opt = (None if skeleton.opt is None else
           SH.opt_state_specs(specs, shapes, skeleton.opt))
    if grid.live:
        # the process groups the sharded step and init use, made now: a
        # group is made by every rank together, in one order
        for axes in sorted({SH.spec_axes(sp[i:]) for sp in specs.values()
                            for i in (0, 1)} | {SH.dp_axes(grid)}):
            if axes:
                grid.group(axes)
    # the checkpoint's leaf names (`ckpt._flatten` of a TrainState)
    leaves = {f".params/{n}": (specs[n], shapes[n]) for n in tree}
    if opt is not None:
        leaves[".opt/.step"] = (opt.step, tuple(skeleton.opt.step.shape))
        for f in ("m", "v", "master"):
            for n, t in getattr(skeleton.opt, f).items():
                leaves[f".opt/.{f}/{n}"] = (getattr(opt, f)[n],
                                            tuple(t.shape))
    return Placement(grid, family, specs, shapes, opt, leaves)


def serve_placement(arch: ArchConfig, shape: ShapeConfig, grid,
                    skeleton: nn.Module) -> Placement:
    """The placement of a model's parameters for serving `shape` on
    `grid`: the recommenders' serve and retrieval kinds replicate their
    small tables (`rec_param_rule(tablewise=True)`), as the reference's
    serve cells do; everything else as in training."""
    kw = ({"tablewise": True} if arch.family == "recsys"
          and shape.kind != "rec_train" else {})
    return placement(arch.family, grid, TrainState(skeleton, None), **kw)


def reshard(params: nn.Module, old: Placement, new: Placement
            ) -> nn.Module:
    """Move a sharded model from `old`'s specs to `new`'s (one grid), in
    place: a leaf whose spec changes is gathered and cut again."""
    grid = new.grid
    for name, p in list(params.named_parameters()):
        path = name.replace(".", "/")
        if old.params[path] == new.params[path]:
            continue
        full = SH.unshard(p.detach(), old.params[path], grid,
                          old.shapes[path])
        block = SH.shard(full, new.params[path], grid)
        mod, _, attr = name.rpartition(".")
        setattr(params.get_submodule(mod), attr, nn.Parameter(
            block if block.shape == full.shape else block.clone(),
            requires_grad=p.requires_grad))
    params.shards = params.gather = None
    return attach(params, new)


def attach(params: nn.Module, place: Placement) -> nn.Module:
    """Mark a module that holds only its blocks: an LM gathers its leaves
    at use (`LeafGather`), a recommender reads its row-sharded tables
    through `TableShards`."""
    grid = place.grid
    if place.family == "lm":
        params.gather = SH.LeafGather(place.params, place.shapes, grid)
    elif place.family == "recsys":
        from repro_torch.models.recsys import TableShards
        starts = {n: SH.block_slices(place.shapes[n], sp, grid)[0].start
                  for n, sp in place.params.items() if SH.spec_axes(sp)}
        if starts:
            axes = {SH.spec_axes(place.params[n]) for n in starts}
            if len(axes) != 1:
                raise ValueError(f"tables sharded over {axes}: one axis "
                                 "group expected")
            params.shards = TableShards(starts, grid.group(axes.pop())[0])
    return params


def shard_params(params: nn.Module, place: Placement) -> nn.Module:
    """This rank's blocks of a full model (its parameters replaced in
    place), marked for the sharded forward: `shard_state` for a model
    without an optimizer state (`serve_placement`'s)."""
    return attach(SH.shard_module(params, place.params, place.grid), place)


def shard_state(state: "TrainState", place: Placement) -> "TrainState":
    """This rank's blocks of a full state (its module's parameters are
    replaced in place, so the full tensors can go; the optimizer leaves
    are copied), marked for the sharded forward (`attach`)."""
    grid = place.grid
    params = shard_params(state.params, place)

    def blocks(d, specs):
        out = {}
        for n, t in d.items():
            b = SH.shard(t, specs[n], grid)
            out[n] = t if b.shape == t.shape else b.clone()
        return out
    opt = OptState(state.opt.step, blocks(state.opt.m, place.opt.m),
                   blocks(state.opt.v, place.opt.v),
                   blocks(state.opt.master, place.opt.master))
    return TrainState(params, opt)


def _dp_group(grid):
    dp = SH.dp_axes(grid)
    return grid.group(dp) if dp and grid.size(dp) > 1 else None


def _reduce_grads(grads: Dict, place: Optional[Placement], grid) -> Dict:
    """Average this rank's gradients over the dp group: a sparse one by
    exchanging its ids and values (all-gathered, concatenated by rank); a
    leaf gathered at use arrives averaged already."""
    group = _dp_group(grid)
    if group is None:
        return grads
    g_dp, members = group
    n = len(members)
    out = {}
    for name, g in grads.items():
        if g is None or (place is not None and place.family == "lm"
                         and SH.spec_axes(place.params[name])):
            out[name] = g
        elif g.is_sparse:
            g = g.coalesce()
            idx = all_gather_ragged(g.indices().t().contiguous(), g_dp,
                                    members)
            val = all_gather_ragged(g.values(), g_dp, members)
            out[name] = torch.sparse_coo_tensor(
                torch.cat(idx).t(), torch.cat(val) / n, g.shape,
                check_invariants=False)
        else:
            out[name] = all_reduce(g, g_dp) / n
    return out


def _global_norm(grads: Dict, place: Optional[Placement], grid
                 ) -> torch.Tensor:
    """sqrt of the sum of the squares of every block of every gradient
    once, over the grid: each rank adds the leaves whose block it owns
    (`sharding.owner`), in `optim.adamw.global_norm`'s order, and the
    world sums the ranks' totals."""
    total = None
    for name, g in grads.items():
        spec = () if place is None else place.params[name]
        if g is None or not SH.owner(spec, grid):
            continue
        g = g.coalesce() if g.is_sparse else g
        vals = g.values() if g.is_sparse else g
        sq = torch.sum(vals.to(torch.float32) ** 2)
        total = sq if total is None else total + sq
    dev = next((g.device for g in grads.values() if g is not None), None)
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.sqrt(all_reduce(total, dist.group.WORLD))


def make_train_step(arch: ArchConfig, shape: ShapeConfig, optimizer=None,
                    microbatches: int = 1, grid=None,
                    place: Optional[Placement] = None,
                    wire_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); the state is
    updated in place. With `microbatches` > 1 the batch is cut into that
    many consecutive slices; their float32 gradients are summed and
    divided by the count, the loss is the mean of theirs and the other
    metrics are the last slice's.

    `grid`: the sharded step (module docstring) on every rank of the grid
    together; the state is `place`'s (`shard_state`), the batch the global
    one, and the loss the mean over dp (the other metrics are this rank's).
    A GNN's state is replicated (`place` may be None); its full-graph
    loss is the partitioned one, its states gathered in `wire_dtype`, and
    its sampled-minibatch and batched-graph steps are data parallel (the
    batch over dp, the gradients averaged over dp)."""
    loss_fn = make_loss_fn(arch, shape, grid, wire_dtype)
    _, opt_update = optimizer or default_optimizer()
    gnn = arch.family == "gnn"
    # the partitioned full-graph loss takes the rank's own edges, and its
    # gradients are the global ones already
    partitioned = gnn and shape.kind == "gnn_full"
    if grid is not None and place is None and not gnn:
        raise ValueError("a sharded step needs the state's Placement")

    def row_mean(name: str, g: torch.Tensor) -> torch.Tensor:
        """A row-Adagrad leaf's mean square over whole rows: the sum over
        this rank's columns, summed over the axes that cut the columns."""
        dims = tuple(range(1, g.ndim))
        cut = SH.spec_axes(place.params[name][1:]) if place else ()
        if not cut:
            return torch.mean(g * g, dim=dims)
        width = int(np.prod(place.shapes[name][1:]))
        return all_reduce(torch.sum(g * g, dim=dims),
                          grid.group(cut)[0]) / width

    def train_step(state: TrainState, batch: dict):
        if grid is not None and not partitioned:
            batch = SH.shard_batch(batch, shape.kind, grid)
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
        gn = None
        if grid is not None:
            if not partitioned:
                grads = _reduce_grads(grads, place, grid)
                group = _dp_group(grid)
                if group is not None:
                    loss = all_reduce(loss, group[0]) / len(group[1])
            gn = _global_norm(grads, place, grid)
        _, _, stats = opt_update(grads, state.opt, state.params,
                                 grad_norm=gn,
                                 row_mean=None if grid is None else row_mean)
        return state, {"loss": loss, **metrics, **stats}

    return train_step


def make_serve_step(arch: ArchConfig, shape: ShapeConfig,
                    grid=None) -> Callable:
    """lm: `lm_prefill` (p, b) -> logits, or `lm_decode_step` as
    step(p, cache, b) -> (logits, cache); gnn: the full-graph, batched or
    minibatch forward's logits; recsys: CTR logits or the retrieval
    top-100.

    `grid` (LM and recommenders): every rank of the grid serves
    together; the parameters are this rank's blocks under
    `serve_placement` (`shard_state`, `reshard`), the batch the global one,
    of which the step takes this rank's dp block (`batch_specs`), and
    the answer is that block's. Decode takes this rank's block of the KV
    cache: its dp block of the batch where the batch divides over dp
    (else the whole batch, replicated, as the reference's long_500k
    cell), and its `model` block of the sequence, attended to in
    parallel (`transformer.lm_decode_step(..., seq_group=)`). Retrieval
    (one user, the candidates replicated) runs on every rank alike: the
    user's and the candidates' rows of a row-sharded table are read
    through `recsys.table_rows` / `bags` (sums over `model`), so every
    rank returns the unsharded top-k."""
    if grid is not None:
        if arch.family == "gnn":
            raise ValueError(f"no sharded serve step for {shape.kind}")
        step = make_serve_step(arch, shape)
        if shape.kind == "lm_decode":
            return _sp_decode_step(arch, grid)
        return lambda p, b: step(p, SH.shard_batch(b, shape.kind, grid))
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


def _sp_decode_step(arch: ArchConfig, grid) -> Callable:
    """step(p, cache, b) on a rank's block of the KV cache (L, B_l, T_l,
    KVH, hd): B_l the dp block of the batch (or all of it), T_l the
    `model` block of the sequence."""
    from repro_torch.models import transformer as T
    dp = SH.dp_axes(grid)
    seq_group = grid.group(("model",)) if "model" in grid.axis_names \
        else None

    def step(p, cache, b):
        B = b["token"].shape[0]
        bax = dp if dp and B % grid.size(dp) == 0 else None
        token = SH.shard(b["token"], SH.P(bax), grid)
        lo = 0
        if seq_group is not None:
            lo = grid.index(("model",)) * cache.k.shape[2]
        return T.lm_decode_step(p, cache, token, b["pos"], arch.model,
                                seq_group=seq_group, seq_lo=lo)
    return step


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
