"""The port's partitioned full-graph GNN loss (`repro_torch.models.
gnn_sharded`, on torch.distributed) against the JAX package's unsharded
`gnn_full_loss`, as tests/test_distributed.py holds the reference's own
sharded loss: the loss within 1e-4, every gradient within 1e-3 of the
largest of its leaf. Gloo ranks on the CPU, spawned once per world size
(every wait and join with a limit), at grids (1, 2) and (2, 2) with a
float32 wire; the bfloat16 wire (its bytes gathered as uint8), the wire
of `train_step.make_loss_fn(arch, shape, grid)`, through that factory,
within 5e-3 of the loss (bfloat16 keeps ~3 significant digits of the
states); and one `make_train_step(..., grid=)` step on every rank.

jax is imported inside the tests: the spawned ranks import this module
and need only torch.
"""
import multiprocessing as mp
import queue

import numpy as np
import pytest
import torch

from repro_torch.configs import GNNConfig

WAIT_S = 120
N, D_FEAT, CLASSES = 200, 24, 7
CFG = dict(name="t", n_layers=2, d_hidden=32, n_classes=CLASSES)


def _arch_shape():
    """graphsage-reddit at the tests' size, for the step factories."""
    import dataclasses

    from repro_torch.configs import get_arch
    arch = get_arch("graphsage-reddit")
    arch = dataclasses.replace(arch, model=GNNConfig(**CFG))
    return arch, dataclasses.replace(arch.shape("full_graph_sm"), n_nodes=N,
                                     d_feat=D_FEAT)


def _rank_case(rank: int, kind: str, grid_shape, wire: str, path: str):
    """One rank's answer. kind "loss": its loss, accuracy and gradients (by
    `param_tree` path), through `sharded_full_loss_fn` with a float32 wire
    and through `make_loss_fn(arch, shape, grid)` (bfloat16) otherwise;
    kind "step": one `make_train_step(..., grid=)` step's loss, the
    parameters after it, and the parameters that the same optimizer makes
    of `sharded_full_loss_fn`'s gradients."""
    from repro_torch.core.sharded_search import ProcessGrid
    from repro_torch.distributed import train_step as ts
    from repro_torch.models.gnn import gnn_params_from_jax
    from repro_torch.models.gnn_sharded import sharded_full_loss_fn
    from repro_torch.optim.adamw import param_tree
    z = np.load(path)

    def load():
        return gnn_params_from_jax(
            {"layers": [{k: z[f"layers/{i}/{k}"]
                         for k in ("w_self", "w_neigh", "b")}
                        for i in range(CFG["n_layers"])],
             "w_out": z["w_out"]}, device="cpu")
    params = load()
    grid = ProcessGrid(grid_shape)
    arch, shape = _arch_shape()
    direct = sharded_full_loss_fn(grid, GNNConfig(**CFG), N,
                                  wire_dtype=getattr(torch, wire))
    batch = {k: torch.from_numpy(z[k]) for k in ("feats", "labels", "mask")}
    batch["edges"] = z["edges_part"]
    tree = param_tree(params)
    if kind == "step":
        opt = ts.default_optimizer(total_steps=10, base_lr=1e-2)
        init, update = opt
        state = ts.TrainState(params, init(params))
        step = ts.make_train_step(arch, shape, optimizer=opt, grid=grid)
        state, m = step(state, batch)
        twin = load()
        t_tree = param_tree(twin)
        loss, _ = direct(twin, batch)
        grads = torch.autograd.grad(loss, list(t_tree.values()))
        update(dict(zip(t_tree, grads)), init(twin), twin)
        return (float(m["loss"]),
                {k: t.detach().numpy() for k, t in tree.items()},
                {k: t.detach().numpy() for k, t in t_tree.items()})
    fn = direct if wire == "float32" else ts.make_loss_fn(arch, shape, grid)
    loss, m = fn(params, batch)
    grads = torch.autograd.grad(loss, list(tree.values()))
    return (float(loss), float(m["acc"]),
            {k: g.numpy() for k, g in zip(tree, grads)})


def _rank_main(rank: int, world: int, store: str, inbox, outbox) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        while True:
            job = inbox.get(timeout=WAIT_S * 4)
            if job is None:
                break
            try:
                outbox.put((rank, _rank_case(rank, *job)))
            except Exception as e:              # reported, not hung
                outbox.put((rank, f"{type(e).__name__}: {e}"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Gloo worlds of 2 and 4 spawned CPU ranks, started once;
    `worlds(n)(job)` sends a job to every rank of the n-rank world and
    returns their answers by rank."""
    ctx = mp.get_context("spawn")
    made = {}

    def start(n):
        store = str(tmp_path_factory.mktemp(f"gloo{n}") / "store")
        inboxes = [ctx.Queue() for _ in range(n)]
        outbox = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, store, inboxes[r], outbox))
                 for r in range(n)]
        for p in procs:
            p.start()
        made[n] = (inboxes, outbox, procs)

    def get(n):
        if n not in made:
            start(n)
        inboxes, outbox, _ = made[n]

        def run(job):
            for box in inboxes:
                box.put(job)
            got = {}
            while len(got) < n:
                try:
                    rank, ans = outbox.get(timeout=WAIT_S)
                except queue.Empty:
                    raise AssertionError(f"ranks {sorted(got)} answered "
                                         f"in {WAIT_S} s") from None
                assert not isinstance(ans, str), f"rank {rank}: {ans}"
                got[rank] = ans
            return got
        return run

    yield get
    for inboxes, _, procs in made.values():
        for box in inboxes:
            box.put(None)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in procs)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's graph, parameters, loss and gradients, and one npz
    per world size with the graph partitioned for it."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import GNNConfig as JGNNConfig
    from repro.data.pipeline import make_graph
    from repro.models import gnn as JG
    from repro.models.gnn_sharded import partition_edges
    cfg = JGNNConfig(**CFG)
    g = make_graph(N, 6, D_FEAT, CLASSES, seed=0)
    g["mask"] = (np.arange(N) % 4 != 1).astype(np.float32)
    p = JG.init_gnn(jax.random.PRNGKey(0), cfg, d_feat=D_FEAT)
    batch = {k: jnp.asarray(v) for k, v in g.items()}
    (loss, aux), grads = jax.value_and_grad(
        lambda q: JG.gnn_full_loss(q, batch, cfg), has_aux=True)(p)
    flat = {"w_out": np.asarray(p["w_out"])}
    gflat = {"w_out": np.asarray(grads["w_out"])}
    for i, (lp, lg) in enumerate(zip(p["layers"], grads["layers"])):
        for k in lp:
            flat[f"layers/{i}/{k}"] = np.asarray(lp[k])
            gflat[f"layers/{i}/{k}"] = np.asarray(lg[k])
    paths = {}
    for ways in (2, 4):
        part, _ = partition_edges(g["edges"], N, ways)
        paths[ways] = str(tmp_path_factory.mktemp("gnn") / f"g{ways}.npz")
        np.savez(paths[ways], edges_part=part, **flat,
                 **{k: g[k] for k in ("feats", "labels", "mask")})
    return dict(loss=float(loss), acc=float(aux["acc"]), grads=gflat,
                paths=paths)


CASES = (((1, 2), "float32"), ((2, 2), "float32"), ((2, 2), "bfloat16"))


@pytest.mark.parametrize("grid,wire", CASES,
                         ids=[f"{g[0]}x{g[1]}_{w}" for g, w in CASES])
def test_sharded_loss_and_gradients_match_the_unsharded_reference(
        worlds, reference, grid, wire):
    ways = grid[0] * grid[1]
    got = worlds(ways)(("loss", grid, wire, reference["paths"][ways]))
    assert sorted(got) == list(range(ways))
    loss0, acc0, g0 = got[0]
    for loss, acc, grads in got.values():      # every rank, the same
        assert loss == loss0 and acc == acc0
        for k in g0:
            np.testing.assert_array_equal(grads[k], g0[k], err_msg=k)
    if wire == "bfloat16":
        assert abs(loss0 - reference["loss"]) < 5e-3
        return
    assert abs(loss0 - reference["loss"]) < 1e-4
    assert acc0 == pytest.approx(reference["acc"], abs=1e-6)
    assert sorted(g0) == sorted(reference["grads"])
    rel = max(float(np.abs(g0[k] - ref).max() / (np.abs(ref).max() + 1e-9))
              for k, ref in reference["grads"].items())
    assert rel < 1e-3, rel


def test_make_train_step_with_a_grid_takes_the_sharded_loss(worlds,
                                                            reference):
    """`make_train_step(arch, shape, grid=)` on a (2, 2) world: every rank
    holds the same parameters after the step, they are the optimizer's
    update from the bfloat16-wire sharded gradients, and the step's loss is
    the unsharded reference's within the bfloat16 bar."""
    got = worlds(4)(("step", (2, 2), "bfloat16", reference["paths"][4]))
    loss0, p0, _ = got[0]
    assert abs(loss0 - reference["loss"]) < 5e-3
    for loss, params, twin in got.values():
        assert loss == loss0
        for k in p0:
            np.testing.assert_array_equal(params[k], p0[k], err_msg=k)
            np.testing.assert_array_equal(params[k], twin[k], err_msg=k)
    with np.load(reference["paths"][4]) as z:
        assert any(not np.array_equal(p0[k], z[k]) for k in p0)


def test_partition_edges_and_local_csr_cover_every_edge_once():
    """The ranks' CSRs hold every real edge once, on the rank that owns
    its destination, with the destination made local; the dummies none."""
    from repro_torch.data.pipeline import make_graph
    from repro_torch.models.gnn_sharded import local_csr, partition_edges
    g = make_graph(101, 5, 3, 4, seed=1)
    part, n_local = partition_edges(g["edges"], 101, 4)
    seen = []
    for rank in range(4):
        csr = local_csr(part, 101, 4, rank, device="cpu")
        d = csr.by_dst
        dst = d.rows().numpy() + rank * n_local
        seen.append(np.stack([d.col.numpy(), dst], 1))
        assert csr.deg.shape == (n_local,)
    seen = np.concatenate(seen)
    want = g["edges"][np.lexsort((np.arange(len(g["edges"])),
                                  g["edges"][:, 1]))]
    np.testing.assert_array_equal(seen, want)
