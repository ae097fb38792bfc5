"""The port's expert-parallel MoE (`repro_torch.models.moe.moe_apply_ep`)
against the JAX package's `moe_apply`, as tests/test_distributed.py holds
the reference's `moe_apply_ep`: the reference test's MoEConfig (8
experts, top-2, d_expert 32, capacity factor 16, one shared expert of
32), d_model 48, 64 tokens, the loss (out ** 2).sum(). On 4 spawned gloo
CPU ranks (every wait and join with a limit), grids (1, 4) and (2, 2)
(tokens split over `data`, experts over `model`), and 6 experts padded to
8: the output within 1e-5 relative of `moe_apply`'s and every gradient
within 1e-4 relative (the reference's bars). The aux loss is the mean of
the dp blocks' (the reference's `pmean`). With no grid installed
`moe_apply_ep` is `moe_apply`. Through the transformer (`REPRO_MOE=ep`,
the reference's `_moe_fn`), a two-layer MoE LM's loss and gradients on a
(1, 4) grid equal the global dispatch's within the same bars.

jax is imported inside the tests: the spawned ranks import this module
and need only torch.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import MoEConfig
from repro_torch.distributed import act_sharding as AS
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import ProcessGrid, all_reduce
from repro_torch.models import moe as PM
from torch_world import World

D_MODEL, T = 48, 64
CFG = dict(n_experts=8, top_k=2, d_expert=32, capacity_factor=16.0,
           n_shared_experts=1, d_shared=32)
# (grid, experts, padding experts)
CASES = (((1, 4), 8, 0), ((2, 2), 8, 0), ((1, 4), 6, 2))


def _flat(p, prefix="", leaf=np.asarray):
    """{path: leaf(value)} of a nested dict."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/", leaf))
        else:
            out[prefix + k] = leaf(v)
    return out


def _tree(flat):
    p = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = p
        for c in parts[:-1]:
            d = d.setdefault(c, {})
        d[parts[-1]] = torch.tensor(v, requires_grad=True)
    return p


def rank_moe(rank, shape, flat, x, n_experts, n_pad):
    grid = ProcessGrid(shape)
    cfg = MoEConfig(**dict(CFG, n_experts=n_experts))
    p = _tree(flat)
    leaves = _flat(p, leaf=lambda t: t)
    AS.set_policy(grid)
    try:
        xl = SH.shard(torch.from_numpy(x), SH.P(SH.dp_axes(grid), None), grid)
        out, aux = PM.moe_apply_ep(p, xl, cfg, n_pad_experts=n_pad)
        gs = torch.autograd.grad((out ** 2).sum(), list(leaves.values()))
    finally:
        AS.set_policy(None)
    world, _ = grid.group(grid.axis_names)
    dp, _ = grid.group(("data",))
    grads = {}
    for (k, g) in zip(leaves, gs):
        # an expert's rows come from its `model` rank (zeros elsewhere),
        # summed over the dp blocks; the rest over the dp blocks only
        expert = k in ("w_gate", "w_up", "w_down")
        grads[k] = all_reduce(g, world if expert else dp).numpy()
    return out.detach().numpy(), float(aux), grads


def rank_lm(rank):
    """A two-layer MoE LM: lm_loss and its gradients with REPRO_MOE=ep on
    the (1, 4) grid and with the global dispatch, both on this rank."""
    from repro_torch.configs import LMConfig
    from repro_torch.models import transformer as TR
    from repro_torch.optim.adamw import param_tree
    grid = ProcessGrid((1, 4))
    cfg = LMConfig(name="t", n_layers=2, d_model=D_MODEL, n_heads=4,
                   n_kv_heads=2, head_dim=12, d_ff=64, vocab_size=256,
                   moe=MoEConfig(**CFG), dtype="float32")
    p = TR.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu", ep=4)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, size=(2, 64)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    tree = param_tree(p)

    def run():
        loss, _ = TR.lm_loss(p, batch, cfg)
        return float(loss), torch.autograd.grad(loss, list(tree.values()))
    want, gw = run()
    AS.set_policy(grid)
    os.environ["REPRO_MOE"] = "ep"
    try:
        got, gg = run()
    finally:
        del os.environ["REPRO_MOE"]
        AS.set_policy(None)
    model, _ = grid.group(("model",))
    out = {}
    for k, a, b in zip(tree, gg, gw):
        if "moe/w_" in k:
            a = all_reduce(a, model)
        out[k] = (a.numpy(), b.numpy())
    return got, want, out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("gloo_moe_ep")))
    yield w
    w.close()


def _reference(n_experts, n_pad):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JMoE
    from repro.models import moe as JM
    mc = JMoE(**dict(CFG, n_experts=n_experts))
    p = JM.init_moe(jax.random.PRNGKey(0), D_MODEL, mc, jnp.float32,
                    n_pad_experts=n_pad)
    x = np.random.default_rng(0).normal(size=(T, D_MODEL)).astype(
        np.float32)

    def f(q, xx):
        return JM.moe_apply(q, xx, mc, n_pad_experts=n_pad)
    out, aux = jax.jit(f)(p, jnp.asarray(x))
    g = jax.jit(jax.grad(lambda q: (f(q, jnp.asarray(x))[0] ** 2).sum()))(p)
    half_aux = [float(jax.jit(f)(p, jnp.asarray(h))[1])
                for h in np.split(x, 2)]
    return (_flat(jax.tree_util.tree_map(np.asarray, p)), x,
            np.asarray(out), float(aux), _flat(g), half_aux)


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("shape,n_experts,n_pad", CASES,
                         ids=["1x4", "2x2", "1x4_padded"])
def test_moe_ep_matches_the_global_dispatch(world, shape, n_experts, n_pad):
    flat, x, out_ref, aux_ref, g_ref, half_aux = _reference(n_experts, n_pad)
    got = world.run(__name__, "rank_moe", shape, flat, x, n_experts, n_pad)
    dp = shape[0]
    blocks = {}
    for rank, (out, aux, grads) in got.items():
        blocks.setdefault(rank // shape[1], out)
        np.testing.assert_array_equal(out, blocks[rank // shape[1]])
        for k, g in g_ref.items():
            assert _rel(grads[k], g) < 1e-4, (rank, k, _rel(grads[k], g))
        want_aux = aux_ref if dp == 1 else float(np.mean(half_aux))
        assert aux == pytest.approx(want_aux, rel=1e-5, abs=1e-8)
    out = np.concatenate([blocks[b] for b in range(dp)])
    assert _rel(out, out_ref) < 1e-5


def test_without_a_grid_moe_apply_ep_is_moe_apply():
    flat, x, *_ = _reference(8, 0)
    cfg = MoEConfig(**CFG)
    AS.set_policy(None)
    p = _tree(flat)
    a, aa = PM.moe_apply_ep(p, torch.from_numpy(x), cfg)
    b, bb = PM.moe_apply(p, torch.from_numpy(x), cfg)
    assert torch.equal(a, b) and torch.equal(aa, bb)


def test_transformer_takes_ep_under_repro_moe(world):
    got = world.run(__name__, "rank_lm")
    for loss, want, grads in got.values():
        assert loss == pytest.approx(want, rel=1e-5)
        for k, (a, b) in grads.items():
            assert _rel(a, b) < 1e-4, (k, _rel(a, b))
