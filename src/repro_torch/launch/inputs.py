"""Dry-run cells: (arch x shape x process grid) -> the step a rank runs,
its inputs at their global shapes on the meta device, and where each
input lives (port of `repro.launch.inputs`).

`input_specs(arch, shape)` gives a meta tensor for every input of a cell
(the reference's `ShapeDtypeStruct`s: shape and dtype, no storage);
`build_cell(arch_id, shape_name, grid)` bundles them with the step and
the specs of `distributed.sharding` (the reference's `NamedSharding`s);
`local_args(cell, grid)` cuts them into one rank's blocks
(`sharding.block_slices`) where `cell.fn` takes blocks, and
`local_bytes` counts a rank's bytes of every input:

  * a train cell: fn(state, batch) is `train_step.make_train_step(...,
    grid=, place=)`'s step; the state is the rank's blocks of a
    `TrainState` (`shard_state` under `train_step.placement`: an LM
    gathers its leaves at use, a recommender reads its row-sharded tables
    through `recsys.table_rows`), the batch the global one (the step
    takes the rank's dp block);
  * a serve cell: fn(params, batch), or fn(params, cache, batch) for
    decode, is `make_serve_step(..., grid=)`'s step on the rank's blocks
    of the parameters under `serve_placement` (the recommenders' small
    tables replicated) and of the KV cache (batch over dp where it
    divides, the sequence over `model`);
  * an ANN cell: fn(arrays, queries) is `core.sharded_search.
    sharded_search_fn`'s search on the rank's shard of the chunk table
    and its block of the queries.

A GNN full-graph step is the port's partitioned loss (`gnn_sharded`):
with `REPRO_GNN=sharded` the edges come grouped by destination shard, as
in the reference; otherwise the step takes the whole edge list and keeps
its destinations' edges (`local_csr`), where the reference's GSPMD sums
the partial aggregations of each rank's dp block of the edges (that
block is what `local_bytes` counts). The steps are made at their first
call, so a cell
builds on a grid that describes one rank without a world
(`ProcessGrid(..., rank=)`), for its specs and blocks.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs import ArchConfig, IndexConfig, ShapeConfig, \
    get_arch
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import ProcessGrid
from repro_torch.optim.adamw import param_tree

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: the reference's ShapeDtypeStruct."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


class Cell(NamedTuple):
    arch_id: str
    shape_name: str
    fn: Callable                  # fn(*local_args(cell, grid))
    args: tuple                   # tree of meta tensors, global shapes
    in_specs: tuple               # tree of sharding specs, as args
    out_specs: Any
    meta: dict                    # model_flops, microbatches, params, ...
    donate: tuple = ()            # donated arg indices (state / cache)
    place: Any = None             # the parameters' train_step.Placement
    whole: tuple = ()             # arg indices fn takes at global shape


# ---------------------------------------------------------------------------
# per-family batch specs (meta tensors)
# ---------------------------------------------------------------------------


def lm_batch_sds(arch: ArchConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "lm_train":
        return {"tokens": _sds((B, S), torch.int32),
                "labels": _sds((B, S), torch.int32)}
    if shape.kind == "lm_prefill":
        return {"tokens": _sds((B, S), torch.int32)}
    if shape.kind == "lm_decode":
        return {"token": _sds((B,), torch.int32),
                "pos": _sds((), torch.int32)}
    raise ValueError(shape.kind)


def gnn_batch_sds(arch: ArchConfig, shape: ShapeConfig, ways: int = 512
                  ) -> dict:
    f32, i32 = torch.float32, torch.int32
    if shape.kind == "gnn_full":
        if os.environ.get("REPRO_GNN") == "sharded":
            # pre-partitioned by destination shard (gnn_sharded.
            # partition_edges)
            e_pad = -(-int(shape.n_edges * 1.25) // ways // 8) * 8
            return {"feats": _sds((shape.n_nodes, shape.d_feat), f32),
                    "edges": _sds((ways, e_pad, 2), i32),
                    "labels": _sds((shape.n_nodes,), i32),
                    "mask": _sds((shape.n_nodes,), f32)}
        # edge list padded to a shardable multiple (gnn.pad_edges)
        ne = -(-shape.n_edges // 512) * 512
        return {"feats": _sds((shape.n_nodes, shape.d_feat), f32),
                "edges": _sds((ne, 2), i32),
                "labels": _sds((shape.n_nodes,), i32),
                "mask": _sds((shape.n_nodes,), f32)}
    if shape.kind == "gnn_minibatch":
        B, (f1, f2), F = shape.batch_nodes, shape.fanout, shape.d_feat
        return {"seed_feats": _sds((B, F), f32),
                "nbr1_feats": _sds((B, f1, F), f32),
                "nbr2_feats": _sds((B, f1, f2, F), f32),
                "labels": _sds((B,), i32)}
    if shape.kind == "gnn_batched":
        G = shape.batch_graphs
        return {"feats": _sds((G, shape.n_nodes, shape.d_feat), f32),
                "edges": _sds((G, shape.n_edges, 2), i32),
                "labels": _sds((G,), i32)}
    raise ValueError(shape.kind)


def rec_batch_sds(arch: ArchConfig, shape: ShapeConfig) -> dict:
    cfg = arch.model
    f32, i32 = torch.float32, torch.int32
    B = shape.batch
    if cfg.kind == "sasrec":
        S = cfg.seq_len
        b = {"seq": _sds((B, S), i32)}
        if shape.kind == "rec_train":
            b.update({"pos_items": _sds((B, S), i32),
                      "neg_items": _sds((B, S), i32),
                      "seq_mask": _sds((B, S), f32)})
        elif shape.kind == "rec_serve":
            b["target"] = _sds((B,), i32)
        elif shape.kind == "rec_retrieval":
            b = {"seq": _sds((1, S), i32),
                 "cand_ids": _sds((shape.n_candidates,), i32)}
        return b
    hot = cfg.multi_hot
    b = {"sparse": _sds((B, cfg.n_sparse, hot), i32)}
    if cfg.n_dense:
        b["dense"] = _sds((B, cfg.n_dense), f32)
    if shape.kind == "rec_train":
        b["label"] = _sds((B,), i32)
    if shape.kind == "rec_retrieval":
        b = {"sparse": _sds((1, cfg.n_sparse, hot), i32),
             "cand_ids": _sds((shape.n_candidates,), i32)}
        if cfg.n_dense:
            b["dense"] = _sds((1, cfg.n_dense), f32)
    return b


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> dict:
    if arch.family == "lm":
        return lm_batch_sds(arch, shape)
    if arch.family == "gnn":
        return gnn_batch_sds(arch, shape)
    if arch.family == "recsys":
        return rec_batch_sds(arch, shape)
    if arch.family == "ann":
        cfg: IndexConfig = arch.model
        return {"queries": _sds((shape.batch, cfg.dim), torch.float32)}
    raise ValueError(arch.family)


# ---------------------------------------------------------------------------
# model FLOPs (the "useful work" yardstick)
# ---------------------------------------------------------------------------


def model_flops(arch: ArchConfig, shape: ShapeConfig) -> float:
    if arch.family == "lm":
        cfg = arch.model
        n_act = cfg.n_active_params()
        if shape.kind == "lm_train":
            return 6.0 * n_act * shape.global_batch * shape.seq_len
        if shape.kind == "lm_prefill":
            return 2.0 * n_act * shape.global_batch * shape.seq_len
        return 2.0 * n_act * shape.global_batch        # decode: per token
    if arch.family == "gnn":
        cfg = arch.model
        H = cfg.d_hidden
        if shape.kind == "gnn_full":
            per_layer = 2 * shape.n_edges * H + 4 * shape.n_nodes * H * H
            fwd = cfg.n_layers * per_layer + 2 * shape.n_nodes * shape.d_feat * H
            return 3.0 * fwd
        if shape.kind == "gnn_minibatch":
            B, (f1, f2) = shape.batch_nodes, shape.fanout
            nodes = B * (1 + f1 + f1 * f2)
            return 3.0 * (4 * nodes * shape.d_feat * H + 4 * B * H * H)
        nodes = shape.batch_graphs * shape.n_nodes
        return 3.0 * cfg.n_layers * 4 * nodes * cfg.d_hidden * shape.d_feat
    if arch.family == "recsys":
        cfg = arch.model
        B = shape.batch
        if shape.kind == "rec_retrieval":
            return 2.0 * shape.n_candidates * cfg.embed_dim
        dims = []
        if cfg.kind == "dlrm":
            dims = list(zip((cfg.n_dense,) + cfg.bot_mlp[:-1], cfg.bot_mlp))
            f = cfg.n_sparse + 1
            d_int = f * (f - 1) // 2 + cfg.bot_mlp[-1]
            dims += list(zip((d_int,) + cfg.top_mlp[:-1], cfg.top_mlp))
            dims += [(f * cfg.embed_dim, f)]          # interaction
        elif cfg.kind in ("dcnv2", "widedeep"):
            d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
            dims = list(zip((d0,) + cfg.mlp, cfg.mlp + (1,)))
            dims += [(d0, d0)] * cfg.n_cross_layers
        else:  # sasrec
            S, D = cfg.seq_len, cfg.embed_dim
            per_tok = 4 * D * D + 2 * S * D + 2 * D * D
            dims = [(S * per_tok // 2, 1)]
        mults = sum(a * b for a, b in dims)
        fac = 6.0 if shape.kind == "rec_train" else 2.0
        return fac * B * mults
    if arch.family == "ann":
        cfg = arch.model
        # per query: ~hops * w * (R * m ADC adds + exact dist) + LUT
        hops, w = 64, cfg.beamwidth
        per_q = hops * w * (cfg.R * cfg.pq_m * 2 + 2 * cfg.dim) \
            + 2 * cfg.dim * cfg.pq_ks
        return float(shape.batch * per_q)
    raise ValueError(arch.family)


# ---------------------------------------------------------------------------
# cell builder
# ---------------------------------------------------------------------------

TRAIN_KINDS = ("lm_train", "gnn_full", "gnn_minibatch", "gnn_batched",
               "rec_train")


def _lazy(make: Callable[[], Callable]) -> Callable:
    """fn(*args) that calls make()'s function, made at the first call."""
    held = []

    def fn(*args):
        if not held:
            held.append(make())
        return held[0](*args)
    return fn


def build_cell(arch_id: str, shape_name: str, grid: ProcessGrid) -> Cell:
    from repro_torch.distributed.train_step import (
        TrainState, default_optimizer, make_serve_step, make_train_step,
        placement, serve_placement)
    arch = get_arch(arch_id)
    shape = arch.shape(shape_name)
    fam = arch.family
    meta = {"model_flops": model_flops(arch, shape)}

    if fam == "ann":
        return _build_ann_cell(arch, shape, grid, meta)

    params = _make_init(arch, shape, grid)()
    gnn_sharded = (os.environ.get("REPRO_GNN") == "sharded"
                   and shape.kind == "gnn_full")
    if gnn_sharded:
        batch_sds = gnn_batch_sds(arch, shape, ways=grid.world)
    else:
        batch_sds = input_specs(arch, shape)
    bspec_all = SH.batch_specs(shape.kind, grid)
    b_specs = {k: bspec_all[k] for k in batch_sds}
    if gnn_sharded:
        b_specs["edges"] = P(tuple(grid.axis_names), None, None)

    if shape.kind in TRAIN_KINDS:
        # the recommenders' tables stay row-sharded in training
        opt_init, _ = default_optimizer()
        state = TrainState(params, opt_init(params))
        place = placement(fam, grid, state)
        # microbatch LM training so the layers' residuals (L x B_mb x S x
        # D bf16) stay under the budget (REPRO_MB_BUDGET_GB, the
        # reference's knob)
        n_mb = 1
        if shape.kind == "lm_train":
            budget = float(os.environ.get("REPRO_MB_BUDGET_GB", "4")) * 1e9
            b_local = shape.global_batch // grid.size(SH.dp_axes(grid))
            cfg = arch.model
            resid_per_seq = 2 * cfg.n_layers * shape.seq_len * cfg.d_model
            b_mb_max = max(1, int(budget // resid_per_seq))
            n_mb = max(1, -(-b_local // b_mb_max))
            while b_local % n_mb:
                n_mb += 1
        fn = _lazy(lambda: make_train_step(
            arch, shape, microbatches=n_mb, grid=grid, place=place))
        meta["microbatches"] = n_mb
        meta["params"] = _tree_bytes(params)
        specs = (TrainState(place.params, place.opt), b_specs)
        return Cell(arch.arch_id, shape.name, fn, (state, batch_sds),
                    specs, (specs[0], None), meta, donate=(0,),
                    place=place, whole=(1,))

    # ---- serve cells ------------------------------------------------------
    place = serve_placement(arch, shape, grid, params)
    fn = _lazy(lambda: make_serve_step(arch, shape, grid=grid))
    if shape.kind == "lm_decode":
        from repro_torch.models.transformer import init_cache
        cache = init_cache(arch.model, shape.global_batch, shape.seq_len,
                           device=META)
        # the batch shards over dp only where it divides (long_500k has
        # B = 1: replicated, the KV sequence over `model`, SP decode)
        dp = SH.dp_axes(grid)
        bax = dp if shape.global_batch % grid.size(dp) == 0 else None
        cspec = P(None, bax, "model", None, None)
        cache_specs = type(cache)(cspec, cspec)
        b_specs = {"token": P(bax), "pos": P()}
        return Cell(arch.arch_id, shape.name, fn,
                    (params, cache, batch_sds),
                    (place.params, cache_specs, b_specs),
                    (None, cache_specs), meta, donate=(1,), place=place,
                    whole=(2,))
    return Cell(arch.arch_id, shape.name, fn, (params, batch_sds),
                (place.params, b_specs), None, meta, place=place,
                whole=(1,))


def _make_init(arch: ArchConfig, shape: ShapeConfig, grid: ProcessGrid
               ) -> Callable[[], nn.Module]:
    """() -> the family's parameters on the meta device (shapes and
    dtypes, no storage); an LM's experts padded to a multiple of the
    grid's `model` size (`ep`)."""
    from repro_torch.launch.train import _make_init as init_of
    ep = grid.sizes.get("model", 1) if arch.family == "lm" else 1
    init = init_of(arch, shape, ep=ep)
    return lambda: init(torch.Generator("cpu"), META)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree))


# ---------------------------------------------------------------------------
# trees: leaves, blocks
# ---------------------------------------------------------------------------


def _children(tree, specs=None):
    """[(name, child, child's spec)] of a tuple, NamedTuple, list or dict;
    a module's parameters by `param_tree` path."""
    def sp(key):
        return None if specs is None else specs[key]
    if isinstance(tree, nn.Module):
        return [(n, t, sp(n)) for n, t in param_tree(tree).items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f),
                 None if specs is None else getattr(specs, f))
                for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), t, sp(i)) for i, t in enumerate(tree)]
    if isinstance(tree, dict):
        return [(str(k), t, sp(k)) for k, t in tree.items()]
    raise TypeError(type(tree))


def _leaves(tree, specs=None, prefix: str = ""):
    """(path, tensor) of every tensor of the tree, depth first, or (path,
    tensor, spec) with `specs`; paths join names with "/" (the
    reference's key paths)."""
    if isinstance(tree, torch.Tensor):
        yield (prefix, tree) if specs is None else (prefix, tree, specs)
        return
    if tree is None:
        return
    for name, child, spec in _children(tree, specs):
        yield from _leaves(child, spec,
                           f"{prefix}/{name}" if prefix else name)


def arg_leaves(cell: Cell):
    """[(path, global meta tensor, spec)] of every input of the cell."""
    return list(_leaves(cell.args, cell.in_specs))


def _block(t: torch.Tensor, spec, grid, rank) -> torch.Tensor:
    """The rank's block of t: a new meta tensor of the block's shape for
    a meta t (a view would keep the global storage alive, and the dry
    run's peak counts storages), a view of t otherwise (`sharding.shard`)."""
    sl = SH.block_slices(t.shape, spec, grid, rank)
    if t.is_meta:
        return torch.empty(tuple(s.stop - s.start for s in sl),
                           dtype=t.dtype, device=META)
    return t[sl]


def _blocks(tree, specs, grid, rank):
    if isinstance(tree, torch.Tensor):
        return _block(tree, specs, grid, rank)
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        mod = copy.deepcopy(tree)
        for name, p in list(mod.named_parameters()):
            path = name.replace(".", "/")
            owner, _, attr = name.rpartition(".")
            setattr(mod.get_submodule(owner), attr, nn.Parameter(
                _block(p.detach(), specs[path], grid, rank),
                requires_grad=p.requires_grad))
        return mod
    kids = [(n, _blocks(c, s, grid, rank))
            for n, c, s in _children(tree, specs)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(b for _, b in kids))
    if isinstance(tree, (tuple, list)):
        return type(tree)(b for _, b in kids)
    return {k: b for (_, b), k in zip(kids, tree)}


def local_args(cell: Cell, grid: ProcessGrid, rank: Optional[int] = None
               ) -> tuple:
    """The cell's inputs as `cell.fn` takes them on `rank` (default: the
    grid's own rank), meta tensors: the rank's blocks, except the args in
    `cell.whole` (the batch of a train or serve step, which the step cuts
    to its dp block itself), passed at their global shapes. On a grid
    with a world and its own rank, the parameters are marked for the
    sharded forward (`train_step.attach`), as `shard_state` marks them."""
    out = tuple(a if i in cell.whole else _blocks(a, s, grid, rank)
                for i, (a, s) in enumerate(zip(cell.args, cell.in_specs)))
    if cell.place is not None and grid.live and rank in (None, grid.rank):
        from repro_torch.distributed.train_step import attach
        for a in out:
            mod = getattr(a, "params", a)
            if isinstance(mod, nn.Module):
                attach(mod, cell.place)
    return out


def local_bytes(cell: Cell, grid: ProcessGrid,
                rank: Optional[int] = None) -> int:
    """The bytes of a rank's blocks of every input, the batch's too (the
    reference's argument bytes a device; exact: no storage is made)."""
    return sum(_block(t, s, grid, rank).numel() * t.element_size()
               for _, t, s in arg_leaves(cell))


# ---------------------------------------------------------------------------
# ANN cells (the paper's own architecture)
# ---------------------------------------------------------------------------

CHUNK_GB_PER_DEV = 8.0     # GB of device memory the chunk table may take


def _build_ann_cell(arch: ArchConfig, shape: ShapeConfig, grid: ProcessGrid,
                    meta: dict) -> Cell:
    from repro_torch.core.chunk_layout import layout_for
    from repro_torch.core.sharded_search import ShardedIndexArrays, \
        sharded_search_fn

    cfg: IndexConfig = arch.model
    layout = layout_for(cfg, "aisaq")
    W = layout.device_stride // 4
    total_chunk_gb = cfg.n_vectors * layout.device_stride / 1e9
    # mode A: the index shards over `model` only, queries over dp;
    # mode B: the index shards over every axis, queries replicated and
    # searched in chunks
    mode_b = total_chunk_gb / grid.sizes["model"] > CHUNK_GB_PER_DEV
    if mode_b:
        shard_axes = tuple(grid.axis_names)
        query_axes: tuple = ()
    else:
        shard_axes = ("model",)
        query_axes = SH.dp_axes(grid)
    n_shards = grid.size(shard_axes)
    N_s = -(-cfg.n_vectors // n_shards)
    m, ks = cfg.pq_m, cfg.pq_ks
    dsub = cfg.dim // m
    i32 = torch.int32
    arrays = ShardedIndexArrays(
        chunk_words=_sds((n_shards, N_s, W), i32),
        centroids=_sds((m, ks, dsub), torch.float32),
        ep_ids=_sds((n_shards, cfg.n_ep), i32),
        ep_codes=_sds((n_shards, cfg.n_ep, m), i32),
        offsets=_sds((n_shards,), i32))
    queries = _sds((shape.batch, cfg.dim), torch.float32)
    qchunk = 128 if (mode_b and shape.batch > 128) else 0
    search = _lazy(lambda: sharded_search_fn(
        grid, k=10, L=128, w=cfg.beamwidth, max_hops=cfg.max_hops,
        layout=layout, metric=cfg.metric, query_axes=query_axes,
        shard_axes=shard_axes, query_chunk=qchunk))
    sspec = P(shard_axes, None, None)
    arr_specs = ShardedIndexArrays(
        chunk_words=sspec, centroids=P(), ep_ids=P(shard_axes, None),
        ep_codes=P(shard_axes, None, None), offsets=P(shard_axes))
    qspec = P(query_axes, None)
    meta.update(mode="B" if mode_b else "A", n_shards=n_shards,
                chunk_gb_per_dev=total_chunk_gb / n_shards)
    return Cell(arch.arch_id, shape.name, search, (arrays, queries),
                (arr_specs, qspec), None, meta)
