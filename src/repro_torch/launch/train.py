"""Training launcher of the recommender towers, the language models and
the GNN: state init, checkpoint and restart, heartbeats, deterministic
data resume (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \
        --shape train_batch --steps 100 [--ckpt-dir DIR] [--scale tiny|full]
        [--lr 3e-3] [--device cuda|cpu] [--batch N]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --shape train_4k --steps 100

Recommenders: `--scale tiny` keeps every width and cuts each table to at
most 2,000 rows and the batch to at most 64, as the reference does;
`--scale full` trains the published cardinalities at the shape's batch
(train_batch: 65,536). LMs: `--scale tiny` is the reference's `tiny_lm`
(4 layers, d_model 128, vocab 2,048, float32, no MoE) at sequence 128
and batch 4; `--scale full` keeps the published model and the shape's
sequence. `--batch` cuts the shape's batch (train_4k's is 256). GNN
(`--arch graphsage-reddit --shape full_graph_sm`, or `ogb_products`):
`--scale tiny` is the reference's (d_hidden 32, 8 classes, a 256-node
graph of 2,048 edges, 32 features), `--scale full` the published model on
the shape's node count; the data is one `make_graph` draw, placed on the
device with its CSRs once and fed at every step. The reference's launcher
has no stream of sampled blocks or of batched graphs, so `minibatch_lg`
and `molecule` raise ValueError here (the reference fails later, in its
loss).
Parameters are drawn from a seeded `torch.Generator`, or come from a
reference state (`train_state_from_jax`, or a checkpoint of either package
in `--ckpt-dir`, which a run resumes from).

`build_trainer(..., grid=)` and `train_loop(..., grid=)` (the reference's
`mesh=`) train on a process grid: the policy is installed
(`act_sharding.set_policy`), the state is sharded as
`distributed.sharding`'s rules say (each rank holds exactly the blocks
that `sharding.shard` takes from the unsharded state of the same seed),
the step is `train_step`'s sharded step and the checkpoints are elastic.
Every rank of the grid calls them together; initialising the process
group is the caller's job, and the CLI, like the reference's, has no grid.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, \
    restore, save
from repro_torch.configs import get_arch
from repro_torch.device import DeviceLike, resolve_device, to_tensor
from repro_torch.distributed.fault_tolerance import Heartbeat, WorkerFailure
from repro_torch.distributed.train_step import (TrainState, attach,
                                                default_optimizer,
                                                make_train_step, placement,
                                                shard_state)


def tiny_lm(cfg):
    return cfg.scaled(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=2048,
                      window=min(cfg.window, 64) if cfg.window else 0,
                      moe=None, dtype="float32")


def _make_init(arch, shape=None, ep: int = 1):
    """(generator, device, keep=None) -> parameters (the reference's
    `launch.inputs._make_init`); a GNN's input width is the shape's
    d_feat, an LM's experts are padded to a multiple of `ep`. `keep`
    (recommenders): keep(path, table) -> what to hold of each table as it
    is drawn."""
    if arch.family == "lm":
        from repro_torch.models.transformer import init_lm
        return lambda generator, device, keep=None: init_lm(
            arch.model, generator=generator, device=device, ep=ep)
    if arch.family == "gnn":
        from repro_torch.models.gnn import init_gnn
        return lambda generator, device, keep=None: init_gnn(
            arch.model, shape.d_feat, generator=generator, device=device)
    from repro_torch.models.recsys import init_recsys
    return lambda generator, device, keep=None: init_recsys(
        arch.model, generator=generator, device=device, keep=keep)


def build_trainer(arch_id: str, shape_name: str, *, scale: str = "tiny",
                  microbatches: int = 1, lr: float = 3e-3, steps: int = 100,
                  device: DeviceLike = None, batch: Optional[int] = None,
                  grid=None, model_overrides: Optional[dict] = None):
    """Returns (arch, state_init, step_fn, data_gen). `state_init(generator
    =None, device=None)` draws the parameters from `generator` (default: a
    generator on the device seeded with 0) and a fresh optimizer state, on
    `device` (default: the trainer's; "meta" gives a skeleton that
    allocates nothing, for `restore` to fill). `batch`, when given, cuts
    the shape's batch (an LM's global_batch, a recommender's batch);
    `model_overrides` replaces fields of the model config after the scale
    (`{"n_layers": 4, "dtype": "float32"}` cuts an LM's depth).

    With `grid`, state_init gives this rank's blocks (`state_init.
    placement` says where each leaf lives): the ranks take turns at the
    draw (a rank draws every leaf as the unsharded init does and keeps
    its blocks, a recommender's tables one at a time), so ranks that share
    a card never hold two whole tables at once; `state_init(from_state=
    full)` shards a full state instead (e.g. `train_state_from_jax`'s).
    The step is the sharded one; the data is the global batch (the step
    takes this rank's dp slice), a GNN's graph this rank's partition
    (`partition_edges`, `local_csr`), its states gathered in float32 so
    the losses stay within 1e-4 of the unsharded trainer's."""
    from repro_torch.distributed.act_sharding import set_policy
    dev = resolve_device(device)
    set_policy(grid)
    arch = get_arch(arch_id)
    if arch.family not in ("lm", "recsys", "gnn"):
        raise ValueError(f"{arch_id} ({arch.family}) has no training path")
    shape = arch.shape(shape_name)
    if arch.family == "gnn" and shape.kind != "gnn_full":
        raise ValueError(
            f"{arch_id} {shape_name} ({shape.kind}) needs a stream of "
            + ("sampled blocks (NeighborSampler.sample_blocks)"
               if shape.kind == "gnn_minibatch" else "batched graphs")
            + ", which the launcher does not have: it feeds one whole "
            "graph (make_graph)")
    if scale == "tiny":
        if arch.family == "lm":
            arch = dataclasses.replace(arch, model=tiny_lm(arch.model))
            shape = dataclasses.replace(shape, seq_len=128, global_batch=max(
                4, grid.sizes.get("data", 1) if grid else 4))
        elif arch.family == "gnn":
            arch = dataclasses.replace(
                arch, model=arch.model.scaled(d_hidden=32, n_classes=8))
            shape = dataclasses.replace(shape, n_nodes=256, n_edges=2048,
                                        d_feat=32)
        else:
            # keep embed_dim (DLRM ties it to bot_mlp[-1]); shrink tables
            arch = dataclasses.replace(arch, model=arch.model.scaled(
                vocab_sizes=tuple(min(v, 2000)
                                  for v in arch.model.vocab_sizes)))
            shape = dataclasses.replace(shape, batch=min(shape.batch, 64))
    if model_overrides:
        arch = dataclasses.replace(arch, model=arch.model.scaled(
            **model_overrides))
    if batch is not None:
        shape = dataclasses.replace(
            shape, **{"global_batch" if arch.family == "lm" else "batch":
                      batch})
    ep = grid.sizes.get("model", 1) if grid is not None else 1
    init_fn = _make_init(arch, shape, ep=ep if arch.family == "lm" else 1)
    opt = default_optimizer(total_steps=steps, base_lr=lr)
    opt_init, _ = opt
    place = None
    if grid is not None:
        meta = init_fn(torch.Generator("cpu"), "meta")
        place = placement(arch.family, grid, TrainState(meta,
                                                        opt_init(meta)))
        del meta
    step_fn = make_train_step(arch, shape, optimizer=opt,
                              microbatches=microbatches, grid=grid,
                              place=place, wire_dtype=torch.float32)
    from repro_torch.data.pipeline import ClickStream, SasrecStream, \
        TokenStream, make_graph
    if arch.family == "gnn":
        from repro_torch.kernels.segment import prepare_csr
        g = make_graph(shape.n_nodes, max(2, shape.n_edges // shape.n_nodes),
                       shape.d_feat, arch.model.n_classes)
        graph = {k: to_tensor(v, dev) for k, v in g.items()}
        if grid is None:
            graph["csr"] = prepare_csr(graph["edges"], shape.n_nodes)
        else:
            from repro_torch.models.gnn_sharded import local_csr, \
                partition_edges
            part, _ = partition_edges(g["edges"], shape.n_nodes, grid.world)
            graph["edges"] = to_tensor(part[grid.rank], dev)
            graph["csr"] = local_csr(graph["edges"], shape.n_nodes,
                                     grid.world, grid.rank)
        data_gen = lambda step: graph              # noqa: E731
    elif arch.family == "lm":
        data_gen = TokenStream(arch.model.vocab_size, shape.seq_len,
                               shape.global_batch).batch_at
    elif arch.model.kind == "sasrec":
        data_gen = SasrecStream(arch.model, shape.batch).batch_at
    else:
        data_gen = ClickStream(arch.model, shape.batch).batch_at

    def state_init(generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None,
                   from_state: Optional[TrainState] = None) -> TrainState:
        if from_state is not None:
            return from_state if grid is None else \
                shard_state(from_state, place)
        d = dev if device is None else torch.device(device)
        g = generator or torch.Generator(
            "cpu" if d.type == "meta" else d).manual_seed(0)
        if grid is None:
            params = init_fn(g, d)
            return TrainState(params, opt_init(params))
        return _sharded_init(init_fn, opt_init, g, d, place)

    state_init.placement = place
    return arch, state_init, step_fn, data_gen


def _sharded_init(init_fn, opt_init, g, d, place) -> TrainState:
    """This rank's blocks of the unsharded init drawn from `g`: the ranks
    take turns (a barrier between turns), each drawing every leaf in the
    unsharded order and keeping its blocks of the recommender tables as
    they come and of the other leaves after."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    grid = place.grid

    def keep(path, t):
        b = SH.shard(t, place.params[path], grid)
        return t if b.shape == t.shape else b.clone()

    state = None
    for turn in range(grid.world):
        if turn == grid.rank:
            params = SH.shard_module(init_fn(g, d, keep=keep), place.params,
                                     grid, place.shapes)
            state = TrainState(attach(params, place), opt_init(params))
            if d.type == "cuda":
                # the whole tables this rank drew go back to the card for
                # the next rank's turn, not to this rank's cache
                torch.cuda.synchronize(d)
                torch.cuda.empty_cache()
        if d.type != "meta":
            dist.barrier()
    return state


def train_loop(arch_id: str, shape_name: str, *, steps: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
               scale: str = "tiny", resume: bool = True,
               fail_at_step: Optional[int] = None, verbose: bool = True,
               lr: float = 3e-3, device: DeviceLike = None,
               init_state: Optional[TrainState] = None,
               batch: Optional[int] = None, grid=None,
               model_overrides: Optional[dict] = None):
    """Run training with checkpoint/restart support. Returns the history
    dict (losses, final_step, wall_s, step_s: each step's seconds to its
    loss on the host) and the final `state`.

    The run starts from the newest checkpoint in `ckpt_dir` when there is
    one (and `resume`), else from `init_state`, else from `state_init()`.
    `fail_at_step` injects a WorkerFailure before that step runs (the
    fault-tolerance tests); a checkpoint in flight is finished first.

    `grid`: every rank of the grid runs the loop together (`build_trainer`);
    `init_state` is a full state, which each rank shards; the state
    returned is this rank's blocks; a checkpoint is saved by every rank
    (synchronously: its barriers are collectives) and a resume reads each
    rank's blocks, from a checkpoint of any grid."""
    dev = resolve_device(device)
    arch, state_init, step_fn, data_gen = build_trainer(
        arch_id, shape_name, scale=scale, steps=steps, lr=lr, device=dev,
        batch=batch, grid=grid, model_overrides=model_overrides)
    place = state_init.placement
    on_grid = dict(grid=grid, layout=place.leaves) if grid is not None \
        else {}
    start = latest_step(ckpt_dir) if ckpt_dir and resume else None
    if start is not None:
        # the checkpoint fills `init_state` in place, or a skeleton on the
        # meta device: no draw, and no second copy of the state
        like = (state_init(from_state=init_state) if init_state is not None
                else state_init(device="meta"))
        state = restore(ckpt_dir, like, step=start, device=dev, **on_grid)
        if verbose:
            print(f"[train] resumed from step {start}")
    else:
        start = 0
        state = state_init(from_state=init_state) if init_state is not None \
            else state_init()
    ck = AsyncCheckpointer()
    hb = Heartbeat(ckpt_dir, grid.rank if grid is not None else 0) \
        if ckpt_dir else None

    def checkpoint(step: int):
        if grid is None:
            ck.save(ckpt_dir, state, step=step)
        else:
            save(ckpt_dir, state, step=step, **on_grid)

    losses, step_s = [], []
    t0 = time.time()
    try:
        for step in range(start, steps):
            # arrays go to the device; a graph's CSRs are there already
            batch = {k: to_tensor(v, dev) if hasattr(v, "shape") else v
                     for k, v in data_gen(step).items()}
            if fail_at_step is not None and step == fail_at_step:
                err = WorkerFailure(f"injected failure at step {step}")
                err.last_step = step
                raise err
            t_step = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t_step)
            if hb:
                hb.beat(step)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                checkpoint(step + 1)
            if verbose and step % 10 == 0:
                print(f"[train] step {step} loss {losses[-1]:.4f} "
                      f"({(time.time() - t0):.1f}s)", flush=True)
    finally:
        ck.wait()
    if ckpt_dir:
        checkpoint(steps)
        ck.wait()
    return {"losses": losses, "final_step": steps,
            "wall_s": time.time() - t0, "step_s": step_s, "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sasrec")
    ap.add_argument("--shape", default="train_batch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--scale", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    ap.add_argument("--batch", type=int,
                    help="cut the shape's batch to this many rows")
    args = ap.parse_args(argv)
    hist = train_loop(args.arch, args.shape, steps=args.steps,
                      ckpt_dir=args.ckpt_dir, scale=args.scale, lr=args.lr,
                      device=args.device, batch=args.batch)
    print(f"final loss {hist['losses'][-1]:.4f} after {args.steps} steps "
          f"in {hist['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
