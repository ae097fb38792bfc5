"""Sharded training (`repro_torch.launch.train.train_loop(grid=)`, the
sharded `distributed.train_step`) against the JAX package's unsharded
trainer, and elastic checkpoints (`checkpoint.ckpt` on a grid).

- Parity: tiny qwen3-1.7b, tiny DLRM-rm2 and tiny graphsage-reddit, from
  the reference's initial state (`train_state_from_jax`), 3 steps of
  `train_loop(grid=)` on grids (2, 2) and (1, 4) against the reference's
  `train_loop`: each loss within 1e-4, the parameters after 3 steps
  (gathered by `unshard`) within 1e-4 absolute (Adam's first steps move
  an element by about lr whatever its gradient's size, so a last-bit
  difference in a near-zero gradient shows at that scale). Every rank
  reports the same losses.
- Elastic checkpoints: a (2, 2) save of a trained qwen3 state is
  file-for-file byte-equal to an unsharded save of the same (gathered)
  state (the manifest's clock held still); it restores onto (1, 4) and
  onto one process bit for bit, and the JAX package's `restore` loads it.
  A resume of `train_loop(grid=)` on (1, 4) from the (2, 2) run's step-2
  checkpoint continues with that run's losses within 1e-4.
- The sharded init (the ranks taking turns at the draw, a recommender
  keeping its table rows as each table is drawn) gives every rank
  exactly `shard` of the unsharded init of the same seed, every leaf of
  the state (DLRM-rm2 on (1, 4), Wide&Deep on (2, 2), qwen3-1.7b on
  (2, 2)).
- Serving on a grid: a trained tiny DLRM-rm2 and Wide&Deep moved from the
  training placement to `serve_placement` (`rec_param_rule(tablewise=
  True)`; Wide&Deep's with a threshold that replicates its `wide/i` and
  row-shards its tables) by `reshard`, served by `make_serve_step(grid=)`:
  each rank's logits within 1e-5 of the unsharded model's on its block.

Gloo ranks on the CPU, world 4, spawned once (every wait and join with a
limit). jax is imported inside the tests: the spawned ranks import this
module and need only torch.
"""
import os

import numpy as np
import pytest

from torch_world import World

STEPS = 3
TOL = 1e-4
ARCHS = {"qwen3-1.7b": "train_4k", "dlrm-rm2": "train_batch",
         "graphsage-reddit": "full_graph_sm"}


def _full_tree(state, place, grid):
    """{checkpoint leaf name: full tensor} of a sharded state."""
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.distributed import sharding as SH
    return {n: SH.unshard(t.detach(), *place.leaves[n][:1], grid,
                          place.leaves[n][1])
            for n, t in _flatten(state).items()}


def rank_train(rank, aid, shape, init, ckpt_dir=None, steps=STEPS):
    from repro_torch.distributed.train_step import train_state_from_jax
    from repro_torch.launch import train
    from repro_torch.launch.mesh import ProcessGrid
    grid = ProcessGrid(shape)
    st = train_state_from_jax(init, device="cpu")
    h = train.train_loop(aid, ARCHS[aid], steps=steps, verbose=False,
                         device="cpu", grid=grid, init_state=st,
                         ckpt_dir=ckpt_dir, ckpt_every=2)
    place = train.build_trainer(aid, ARCHS[aid], steps=steps, device="cpu",
                                grid=grid)[1].placement
    full = _full_tree(h["state"], place, grid)
    return h["losses"], {n[len(".params/"):]: t.numpy()
                         for n, t in full.items() if n.startswith(".params")}


def rank_elastic_save(rank, init, run_dir, out_sharded, out_full):
    """4 steps on (2, 2) with a checkpoint every 2 in `run_dir`, then the
    final state saved on the grid and, by rank 0, its gathered copy by
    the unsharded save (both with the manifest's clock held still)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed.train_step import TrainState, \
        train_state_from_jax
    from repro_torch.launch import train
    from repro_torch.launch.mesh import ProcessGrid
    from repro_torch.optim.adamw import OptState
    grid = ProcessGrid((2, 2))
    aid = "qwen3-1.7b"
    h = train.train_loop(aid, ARCHS[aid], steps=4, verbose=False,
                         device="cpu", grid=grid, ckpt_dir=run_dir,
                         ckpt_every=2,
                         init_state=train_state_from_jax(init, device="cpu"))
    place = train.build_trainer(aid, ARCHS[aid], steps=4, device="cpu",
                                grid=grid)[1].placement
    meta = {"time": 0.0}
    ckpt.save(out_sharded, h["state"], step=4, extra_meta=meta, grid=grid,
              layout=place.leaves)
    full = _full_tree(h["state"], place, grid)
    if rank == 0:
        def part(prefix):
            return {n[len(prefix):]: t for n, t in full.items()
                    if n.startswith(prefix)}
        tree = TrainState(part(".params/"), OptState(
            full[".opt/.step"], part(".opt/.m/"), part(".opt/.v/"),
            part(".opt/.master/")))
        ckpt.save(out_full, tree, step=4, extra_meta=meta)
    return {n: t.numpy() for n, t in full.items()}, h["losses"]


def rank_elastic_restore(rank, path):
    """The (2, 2) checkpoint restored onto (1, 4), each rank reading its
    blocks into a skeleton, then gathered."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    from repro_torch.launch.mesh import ProcessGrid
    grid = ProcessGrid((1, 4))
    aid = "qwen3-1.7b"
    _, init, _, _ = train.build_trainer(aid, ARCHS[aid], steps=4,
                                        device="cpu", grid=grid)
    st = ckpt.restore(path, init(device="meta"), device="cpu", grid=grid,
                      layout=init.placement.leaves)
    return {n: t.numpy() for n, t in
            _full_tree(st, init.placement, grid).items()}


def rank_resume(rank, run_dir, shape):
    """train_loop(grid=) over 4 steps, resumed from the (2, 2) run's
    step-2 checkpoint (copied into a fresh directory)."""
    import shutil

    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.launch.mesh import ProcessGrid
    d = run_dir + f"_resume{shape[0]}x{shape[1]}"
    if rank == 0:
        shutil.copytree(os.path.join(run_dir, "step_00000002"),
                        os.path.join(d, "step_00000002"))
    dist.barrier()
    aid = "qwen3-1.7b"
    h = train.train_loop(aid, ARCHS[aid], steps=4, verbose=False,
                         device="cpu", grid=ProcessGrid(shape), ckpt_dir=d)
    return h["losses"]


def rank_serve(rank, aid, shape, threshold_mb):
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import train_step as ts
    from repro_torch.launch import train
    from repro_torch.launch.mesh import ProcessGrid
    from repro_torch.models.recsys import rec_forward
    grid = ProcessGrid(shape)
    arch, init, step, data = train.build_trainer(aid, "train_batch",
                                                 device="cpu", grid=grid)
    state = init()
    step(state, data(0))                           # a trained state
    _, full_init, _, _ = train.build_trainer(aid, "train_batch",
                                             device="cpu")
    full = full_init().params
    tree = dict(zip(full.state_dict(), full.parameters()))
    for n, p in state.params.named_parameters():
        with torch.no_grad():                      # the same trained model
            tree[n].copy_(SH.unshard(p.detach(), init.placement.params[
                n.replace(".", "/")], grid, tree[n].shape))
    serve_shape = dataclasses.replace(get_arch(aid).shape("serve_p99"),
                                      batch=64)
    meta = train._make_init(arch, None)(torch.Generator("cpu"), "meta")
    place = (ts.serve_placement(arch, serve_shape, grid, meta)
             if threshold_mb is None else
             ts.placement(arch.family, grid, ts.TrainState(meta, None),
                          tablewise=True, replicate_small_mb=threshold_mb))
    params = ts.reshard(state.params, init.placement, place)
    b = {k: v for k, v in data(1).items() if k != "label"}
    got = ts.make_serve_step(arch, serve_shape, grid=grid)(params, b)
    want = rec_forward(full, b, arch.model)
    block = SH.shard(want, (SH.dp_axes(grid),), grid)
    sharded = sorted(n for n, sp in place.params.items() if SH.spec_axes(sp))
    return float((got - block).abs().max()), got.shape[0], sharded


@pytest.mark.parametrize("aid,shape,mb", [
    ("dlrm-rm2", (2, 2), None), ("wide-deep", (2, 2), 0.1),
    ("wide-deep", (1, 4), 0.1)], ids=["dlrm_2x2", "widedeep_2x2",
                                      "widedeep_1x4"])
def test_tablewise_serving_after_training(world, aid, shape, mb):
    got = world.run(__name__, "rank_serve", aid, shape, mb)
    for err, rows, sharded in got.values():
        assert err < 1e-5
        assert rows == 64 // shape[0]
        if mb is None:
            assert sharded == []            # tiny tables: all replicated
        else:
            assert sharded and all(n.startswith("tables/") for n in sharded)


def rank_init(rank, aid, shape):
    """This rank's blocks of `build_trainer(grid=)`'s draw (the ranks
    taking turns) against `shard` of the unsharded draw of the same seed,
    every leaf of the state, bit for bit."""
    import torch
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train
    from repro_torch.launch.mesh import ProcessGrid
    grid = ProcessGrid(shape)
    name = ARCHS.get(aid, "train_batch")
    _, init, _, _ = train.build_trainer(aid, name, device="cpu", grid=grid)
    mine = _flatten(init())
    _, full_init, _, _ = train.build_trainer(aid, name, device="cpu")
    full = _flatten(full_init())
    bad = [n for n, t in mine.items() if not torch.equal(
        t.detach(), SH.shard(full[n].detach(),
                             init.placement.leaves[n][0], grid))]
    cut = sum(t.numel() < full[n].numel() for n, t in mine.items())
    return bad, cut


@pytest.mark.parametrize("aid,shape", [
    ("dlrm-rm2", (1, 4)), ("wide-deep", (2, 2)), ("qwen3-1.7b", (2, 2))],
    ids=["dlrm_1x4", "widedeep_2x2", "qwen3_2x2"])
def test_sharded_init_is_shard_of_the_unsharded_init(world, aid, shape):
    got = world.run(__name__, "rank_init", aid, shape)
    for bad, cut in got.values():
        assert bad == [] and cut > 0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("gloo_dist_train")))
    yield w
    w.close()


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{aid: (initial state as numpy, losses, {path: final param})} of the
    reference's train_loop (its final checkpoint read back)."""
    import jax
    from repro.checkpoint import ckpt as jckpt
    from repro.launch import train as jtrain
    out = {}
    for aid, shape in ARCHS.items():
        _, init, _, _, _ = jtrain.build_trainer(aid, shape, steps=STEPS)
        st0 = _np(init())
        d = str(tmp_path_factory.mktemp("jax_" + aid))
        h = jtrain.train_loop(aid, shape, steps=STEPS, ckpt_dir=d,
                              verbose=False)
        final = _np(jckpt.restore(d, init()))
        flat, _ = jax.tree_util.tree_flatten_with_path(final.params)
        params = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path): a for path, a in flat}
        out[aid] = (st0, h["losses"], params)
    return out


CASES = [(aid, shape) for aid in ARCHS for shape in ((2, 2), (1, 4))]


@pytest.mark.parametrize("aid,shape", CASES,
                         ids=[f"{a}_{s[0]}x{s[1]}" for a, s in CASES])
def test_sharded_train_loop_matches_the_reference(world, reference, aid,
                                                  shape):
    st0, losses, params = reference[aid]
    got = world.run(__name__, "rank_train", aid, shape, st0)
    l0 = got[0][0]
    for losses_r, _ in got.values():
        assert losses_r == l0
    np.testing.assert_allclose(l0, losses, rtol=0, atol=TOL)
    full = got[0][1]
    assert sorted(full) == sorted(params)
    for n, a in params.items():
        np.testing.assert_allclose(full[n], a, rtol=0, atol=TOL, err_msg=n)


@pytest.fixture(scope="module")
def elastic(world, reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    run, sharded, full = (str(d / n) for n in ("run", "sharded", "full"))
    got = world.run(__name__, "rank_elastic_save",
                    reference["qwen3-1.7b"][0], run, sharded, full)
    for tree, losses in got.values():
        assert losses == got[0][1]
    return run, sharded, full, got[0][0], got[0][1]


def test_sharded_save_is_the_unsharded_save_byte_for_byte(elastic):
    _, sharded, full, _, _ = elastic
    a, b = (os.path.join(p, "step_00000004") for p in (sharded, full))
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    assert len(names) > 20
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_elastic_restore_onto_another_grid_and_one_process(world, elastic):
    from repro_torch.checkpoint import ckpt
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.launch import train
    _, sharded, _, want, _ = elastic
    got = world.run(__name__, "rank_elastic_restore", sharded)
    for ans in got.values():
        assert sorted(ans) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(ans[n], want[n], err_msg=n)
    _, init, _, _ = train.build_trainer("qwen3-1.7b", "train_4k", steps=4,
                                        device="cpu")
    one = _flatten(ckpt.restore(sharded, init(device="meta"), device="cpu"))
    for n in want:
        np.testing.assert_array_equal(one[n].detach().numpy(), want[n],
                                      err_msg=n)


def test_the_reference_restores_a_sharded_save(elastic):
    import jax
    from repro.checkpoint import ckpt as jckpt
    from repro.launch import train as jtrain
    _, sharded, _, want, _ = elastic
    _, init, _, _, _ = jtrain.build_trainer("qwen3-1.7b", "train_4k",
                                            steps=4)
    st = jckpt.restore(sharded, init())
    flat, _ = jax.tree_util.tree_flatten_with_path(st)
    got = {"/".join(("." + k.name) if hasattr(k, "name") else
                    str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path): np.asarray(a) for path, a in flat}
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_a_resume_on_another_grid_continues_the_run(world, elastic):
    run, _, _, _, losses = elastic
    got = world.run(__name__, "rank_resume", run, (1, 4))
    for resumed in got.values():
        assert len(resumed) == 2
        np.testing.assert_allclose(resumed, losses[2:], rtol=0, atol=TOL)
