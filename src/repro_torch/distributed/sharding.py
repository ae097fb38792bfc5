"""Sharding rules as data: tree path + shape -> spec, per model family
(port of `repro.distributed.sharding`), and the placement functions that
stand in for `jax.device_put(x, NamedSharding(mesh, spec))`.

A spec is a tuple with one entry a dimension: None (whole), an axis name,
or a tuple of axis names (the dimension split over their product, the
first axis major): the reference's `PartitionSpec`. `shard(t, spec,
grid)` is this rank's block; a dimension that does not divide by its
axes' product splits as `numpy.array_split` splits it (the first blocks
one longer). `unshard(block, spec, grid)` all-gathers the full tensor.

Strategy (the reference's):
  * `model`: expert parallelism over MoE experts, row-sharded recommender
    tables, the vocab and projection dims of an LM;
  * `data`: batch data parallelism and FSDP (an LM leaf sharded over it
    is gathered at use, one layer at a time: `LeafGather`);
  * `pod`: pure data parallelism across pods.
The port has no tensor-parallel arithmetic: a leaf sharded over `model`
is gathered at use like an FSDP leaf, and the ranks of a `model` group
compute the same activations.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.launch.mesh import ProcessGrid, all_gather, all_reduce
from repro_torch.optim.adamw import OptState, param_tree

Spec = Tuple


def P(*entries) -> Spec:
    """A spec from its entries, normalised as the reference's
    `PartitionSpec(...)` is: an entry of one axis is its name, an empty
    tuple of axes is None."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            return None if not e else e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(norm(e) for e in entries)


def dp_axes(grid) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in grid.axis_names)


def fsdp_axis(grid) -> str:
    return "data"


def spec_tree(params, rule: Callable[[str, tuple], Spec]) -> Dict[str, Spec]:
    """{path: spec} of a module (its `param_tree` paths) or of a {path:
    tensor or shape} dict."""
    tree = param_tree(params) if isinstance(params, nn.Module) else params
    return {n: rule(n, tuple(getattr(t, "shape", t))) for n, t in
            tree.items()}


# ---------------------------------------------------------------------------
# per-family parameter rules
# ---------------------------------------------------------------------------


def lm_param_rule(grid) -> Callable:
    fs = fsdp_axis(grid)

    def rule(path: str, shape: tuple) -> Spec:
        nd = len(shape)
        if path.endswith("embed"):
            return P("model", fs)
        if path.endswith("lm_head"):
            return P(fs, "model")
        if re.search(r"attn/w_[qkv]$", path):
            return P(None, fs, "model")
        if path.endswith("attn/w_o"):
            return P(None, "model", fs)
        if re.search(r"attn/b_[qkv]$", path):
            return P(None, "model")
        if "moe/router" in path:
            return P(None, fs, None)
        if "moe/w_gate" in path or "moe/w_up" in path:
            if nd == 4:                       # (L, E, D, F): EP on experts
                return P(None, "model", fs, None)
            return P(None, fs, "model")       # shared expert (L, D, F)
        if "moe/w_down" in path:
            if nd == 4:
                return P(None, "model", None, fs)
            return P(None, "model", fs)
        if "shared/w_gate" in path or "shared/w_up" in path:
            return P(None, fs, "model")
        if "shared/w_down" in path:
            return P(None, "model", fs)
        if re.search(r"ffn/w_(gate|up)$", path):
            return P(None, fs, "model")
        if path.endswith("ffn/w_down"):
            return P(None, "model", fs)
        return P(*([None] * nd))              # norms, scales

    return rule


def rec_param_rule(grid, replicate_small_mb: float = 64.0,
                   tablewise: bool = False) -> Callable:
    """Embedding tables (and Wide&Deep's `wide/i`): row-sharded over
    `model`; with `tablewise` (the reference's serve cells), a table under
    `replicate_small_mb` MB is replicated and its lookups stay local.
    Training keeps row-sharding (the reference measured tablewise 1.5x
    slower on wide-deep train)."""
    thresh = replicate_small_mb * 1e6

    def rule(path: str, shape: tuple) -> Spec:
        nd = len(shape)
        if "tables/" in path or "/wide/" in path or path.startswith("wide"):
            nbytes = float(np.prod(shape)) * 4
            if tablewise and nbytes < thresh:
                return P(*([None] * nd))              # replicated table
            return P("model", *([None] * (nd - 1)))   # row-sharded table
        return P(*([None] * nd))
    return rule


def gnn_param_rule(grid) -> Callable:
    def rule(path: str, shape: tuple) -> Spec:
        return P(*([None] * len(shape)))
    return rule


def param_rule(family: str, grid, **kw) -> Callable:
    return {"lm": lm_param_rule, "gnn": gnn_param_rule,
            "recsys": rec_param_rule}[family](grid, **kw)


# ---------------------------------------------------------------------------
# optimizer-state, batch and cache specs
# ---------------------------------------------------------------------------


def opt_state_specs(param_specs: Dict[str, Spec], param_shapes,
                    opt: OptState) -> OptState:
    """The OptState's specs, leaf for leaf: `m` and `v` take the
    parameter's spec where they have its shape (an AdamW leaf, Wide&Deep's
    `wide/i` among them); a row-Adagrad leaf's `m` placeholder (1,) is
    replicated and its (V,) accumulator keeps the parameter's dim-0 spec;
    a float32 parameter's (0,) `master` sentinel is replicated."""
    shapes = {n: tuple(getattr(t, "shape", t)) for n, t in
              (param_tree(param_shapes) if isinstance(param_shapes, nn.Module)
               else param_shapes).items()}

    def m_spec(n):
        return P(None) if tuple(opt.m[n].shape) == (1,) else param_specs[n]

    def v_spec(n):
        if tuple(opt.v[n].shape) == shapes[n]:
            return param_specs[n]
        ps = param_specs[n]
        return P(ps[0] if len(ps) else None)

    def master_spec(n):
        return P(None) if tuple(opt.master[n].shape) == (0,) \
            else param_specs[n]

    return OptState(step=P(), m={n: m_spec(n) for n in opt.m},
                    v={n: v_spec(n) for n in opt.v},
                    master={n: master_spec(n) for n in opt.master})


def batch_specs(kind: str, grid) -> Dict[str, Spec]:
    dp = dp_axes(grid)
    if kind == "lm_train":
        return {"tokens": P(dp, None), "labels": P(dp, None)}
    if kind == "lm_prefill":
        return {"tokens": P(dp, None)}
    if kind == "lm_decode":
        return {"token": P(dp), "pos": P()}
    if kind in ("gnn_full",):
        return {"feats": P(), "edges": P(dp, None), "labels": P(),
                "mask": P()}
    if kind == "gnn_minibatch":
        return {"seed_feats": P(dp, None), "nbr1_feats": P(dp, None, None),
                "nbr2_feats": P(dp, None, None, None), "labels": P(dp)}
    if kind == "gnn_batched":
        return {"feats": P(dp, None, None), "edges": P(dp, None, None),
                "labels": P(dp)}
    if kind == "rec_train":
        return {"dense": P(dp, None), "sparse": P(dp, None, None),
                "label": P(dp), "seq": P(dp, None), "pos_items": P(dp, None),
                "neg_items": P(dp, None), "seq_mask": P(dp, None),
                "target": P(dp)}
    if kind == "rec_serve":
        return {"dense": P(dp, None), "sparse": P(dp, None, None),
                "seq": P(dp, None), "target": P(dp)}
    if kind == "rec_retrieval":
        return {"dense": P(None, None), "sparse": P(None, None, None),
                "seq": P(None, None), "cand_ids": P(None)}
    raise ValueError(kind)


def cache_spec(grid) -> Spec:
    """Decode KV cache (L, B, T, KVH, hd): batch over dp, seq over model."""
    return P(None, dp_axes(grid), "model", None, None)


# ---------------------------------------------------------------------------
# placement: shard / unshard
# ---------------------------------------------------------------------------


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec names, in order."""
    return tuple(a for e in spec for a in _axes(e))


def split_bounds(n: int, k: int, i: int) -> Tuple[int, int]:
    """[lo, hi) of block i of n split into k as `numpy.array_split`."""
    q, r = divmod(n, k)
    lo = i * q + min(i, r)
    return lo, lo + q + (i < r)


def block_slices(shape: Sequence[int], spec: Spec, grid,
                 rank: Optional[int] = None) -> Tuple[slice, ...]:
    """The slices of `rank`'s block (default: the grid's own rank)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    ent = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(slice(*split_bounds(int(n), grid.size(_axes(e)),
                                     grid.index(_axes(e), rank)))
                 for n, e in zip(shape, ent))


def shard(t, spec: Spec, grid, rank: Optional[int] = None):
    """This rank's block of t (a view of it): the counterpart of placing t
    with NamedSharding(mesh, spec)."""
    return t[block_slices(t.shape, spec, grid, rank)]


def owner(spec: Spec, grid) -> bool:
    """Whether this rank holds its block first: its coordinates on every
    axis the spec does not name are 0 (a replicated block counts once)."""
    named = set(spec_axes(spec))
    return all(c == 0 for a, c in zip(grid.axis_names, grid.coords())
               if a not in named)


def assemble(blocks: Dict[int, torch.Tensor], shape: Sequence[int],
             spec: Spec, grid) -> torch.Tensor:
    """The full tensor from {rank: block}, one block per distinct place
    (ranks missing from `blocks` are skipped)."""
    first = next(iter(blocks.values()))
    out = first.new_empty(tuple(shape))
    for r, b in blocks.items():
        out[block_slices(shape, spec, grid, r)] = b
    return out


def unshard(block: torch.Tensor, spec: Spec, grid: ProcessGrid,
            shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The full tensor on every rank: this rank's `block` all-gathered
    over the axes of `spec` (a collective of those axes' group). `shape`
    is the full shape (from the blocks when not given: exact for splits
    that divide evenly)."""
    axes = spec_axes(spec)
    if not axes:
        return block
    group, members = grid.group(axes)
    if shape is None:
        shape = list(block.shape)
        for d, e in enumerate(spec):
            shape[d] *= grid.size(_axes(e))
    shape = tuple(int(s) for s in shape)
    if block.is_meta:
        # a shape trace (`launch.dryrun`): the gathered stack alive while
        # the full tensor is filled from it, as below, in one copy in
        # place of one a block
        got = all_gather(block, group, members)
        out = block.new_empty(shape)
        return out.copy_(got.flatten()[:out.numel()].view(shape))
    # blocks of an uneven split differ by one: gather them padded to the
    # first (the longest), then cut each to its own size
    first = block_slices(shape, spec, grid, members[0])
    pad = []
    for d in reversed(range(len(shape))):
        pad += [0, first[d].stop - first[d].start - block.shape[d]]
    padded = torch.nn.functional.pad(block, pad) if any(pad) else block
    got = all_gather(padded, group, members)
    blocks = {r: got[i][tuple(slice(0, s.stop - s.start) for s in
                              block_slices(shape, spec, grid, r))]
              for i, r in enumerate(members)}
    return assemble(blocks, shape, spec, grid)


def shard_batch(batch: Dict, kind: str, grid) -> Dict:
    """This rank's slice of a global batch, as `batch_specs(kind)` says."""
    specs = batch_specs(kind, grid)
    return {k: shard(v, specs[k], grid) if hasattr(v, "shape") else v
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# FSDP: gather a leaf at use
# ---------------------------------------------------------------------------


class _GatherAtUse(torch.autograd.Function):
    """Forward: the full tensor from this rank's block. The backward
    keeps only the block: the full gradient (this rank's batch slice's) is
    averaged over the dp group and this rank's block of it returned (an
    all-reduce and a slice: gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, block, spec, grid, shape, dp_group):
        ctx.spec, ctx.grid, ctx.dp_group = spec, grid, dp_group
        return unshard(block.detach(), spec, grid, shape)

    @staticmethod
    def backward(ctx, g):
        if ctx.dp_group is not None:
            g = all_reduce(g.contiguous(), ctx.dp_group[0])
            g = g / len(ctx.dp_group[1])
        return (shard(g, ctx.spec, ctx.grid).contiguous(),
                None, None, None, None)


class LeafGather:
    """Gathers sharded leaves at use for a model that holds only its
    blocks: `__call__(path, block)` -> the full leaf (the identity for a
    replicated one). `per_layer` drops a stacked leaf's leading layer dim
    from its spec and shape, so a layer's view is gathered on its own.
    The gathers' backward averages the gradient over the dp axes, so a
    gathered leaf's gradient arrives averaged."""

    def __init__(self, specs: Dict[str, Spec], shapes: Dict[str, tuple],
                 grid: ProcessGrid):
        self.specs, self.shapes, self.grid = specs, shapes, grid
        dp = dp_axes(grid)
        self.dp_group = grid.group(dp) if dp and grid.size(dp) > 1 else None

    def __call__(self, path: str, block: torch.Tensor,
                 per_layer: bool = False) -> torch.Tensor:
        spec, shape = self.specs[path], self.shapes[path]
        if per_layer:
            spec, shape = spec[1:], shape[1:]
        if not spec_axes(spec):
            return block
        return _GatherAtUse.apply(block, spec, self.grid, shape,
                                  self.dp_group)

    def tree(self, prefix: str, tree: Dict) -> Dict:
        """A layer's nested dict of per-layer blocks, gathered."""
        return {k: self.tree(f"{prefix}/{k}", v) if isinstance(v, dict)
                else self(f"{prefix}/{k}", v, per_layer=True)
                for k, v in tree.items()}


def shard_module(module: nn.Module, specs: Dict[str, Spec], grid,
                 shapes: Optional[Dict[str, tuple]] = None) -> nn.Module:
    """Replace every sharded parameter of `module` by its block (a copy,
    so the full tensor can go), in place; returns the module. With the
    full `shapes`, a parameter that is not of its full shape is taken as
    a block already."""
    for name, p in list(module.named_parameters()):
        path = name.replace(".", "/")
        if shapes is not None and tuple(p.shape) != tuple(shapes[path]):
            continue
        block = shard(p.detach(), specs[path], grid)
        if block.shape == p.shape:
            continue
        mod, _, attr = name.rpartition(".")
        setattr(module.get_submodule(mod), attr, nn.Parameter(
            block.clone(memory_format=torch.contiguous_format),
            requires_grad=p.requires_grad))
    return module
