"""Context-parallel attention (`repro_torch.distributed.act_sharding.
cp_attention_wrap`, wired into `models.transformer`'s training and
prefill attention) against the JAX package's unsharded loss, as
tests/test_distributed.py holds the reference's: its config (2 layers,
d_model 64, 4 heads of 16 over 2 KV heads, sliding window 256, vocab 512,
float32), tokens (4, 1024). On 4 spawned gloo CPU ranks (every wait and
join with a limit), under `set_policy(grid, cp_attention=True)` with
`model` = 4 (and = 2 on a (2, 2) grid): the loss within 1e-4 of the
reference's and every gradient within 5e-3 relative (the reference's
bars), the same on every rank; the prefill logits within 1e-4 of the
unsharded prefill's. The wrap returns None where the reference's does.

jax is imported inside the tests: the spawned ranks import this module
and need only torch.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import LMConfig
from repro_torch.distributed import act_sharding as AS
from repro_torch.launch.mesh import ProcessGrid
from torch_world import World

CFG = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           head_dim=16, d_ff=128, vocab_size=512, attention="sliding",
           window=256, dtype="float32")


def rank_cp(rank, shape, flat, toks):
    from repro_torch.models import transformer as TR
    from repro_torch.optim.adamw import param_tree
    cfg = LMConfig(**CFG)
    p = TR.lm_params_from_jax(_tree(flat), device="cpu")
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    tree = param_tree(p)
    grid = ProcessGrid(shape)
    AS.set_policy(grid, cp_attention=True)
    try:
        wrap = AS.cp_attention_wrap(lambda *a: None, toks.shape[1])
        loss, _ = TR.lm_loss(p, batch, cfg)
        grads = torch.autograd.grad(loss, list(tree.values()))
        logits = TR.lm_prefill(p, toks[:, :512], cfg)
    finally:
        AS.set_policy(None)
    plain = TR.lm_prefill(p, toks[:, :512], cfg)
    return (float(loss), {k: g.numpy() for k, g in zip(tree, grads)},
            wrap is not None, float((logits - plain).abs().max()))


def _tree(flat):
    out = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for c in parts[:-1]:
            d = d.setdefault(c, {})
        d[parts[-1]] = v
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("gloo_cp")))
    yield w
    w.close()


@pytest.fixture(scope="module")
def reference():
    import jax
    import jax.numpy as jnp
    from repro.configs.base import LMConfig as JLM
    from repro.distributed.act_sharding import set_policy
    from repro.models import transformer as JT
    cfg = JLM(**CFG)
    p = JT.init_lm(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 1024), 0, 512)
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    set_policy(None)
    loss = jax.jit(lambda q: JT.lm_loss(q, batch, cfg)[0])(p)
    g = jax.jit(jax.grad(lambda q: JT.lm_loss(q, batch, cfg)[0]))(p)

    def flat(tree):
        got, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(k.key) for k in path): np.asarray(a)
                for path, a in got}
    return flat(p), np.asarray(toks), float(loss), flat(g)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_cp_lm_loss_and_gradients_match_the_reference(world, reference,
                                                      shape):
    flat, toks, loss_ref, g_ref = reference
    got = world.run(__name__, "rank_cp", shape, flat, toks)
    loss0, g0, _, _ = got[0]
    for loss, grads, applied, prefill_err in got.values():
        assert applied
        assert loss == loss0
        assert abs(loss - loss_ref) < 1e-4
        for k, g in g_ref.items():
            rel = np.abs(grads[k] - g).max() / (np.abs(g).max() + 1e-9)
            assert rel < 5e-3, (k, rel)
            np.testing.assert_array_equal(grads[k], g0[k])
        assert prefill_err < 1e-4


def test_cp_attention_wrap_applies_where_the_reference_does():
    grid = ProcessGrid((1, 4), rank=0)
    AS.set_policy(None)
    assert AS.cp_attention_wrap(None, 1024) is None
    AS.set_policy(grid)                       # cp_attention off
    assert AS.cp_attention_wrap(None, 1024) is None
    AS.set_policy(grid, cp_attention=True)
    try:
        assert AS.cp_attention_wrap(None, 1022) is None     # 4 does not
        assert AS.cp_attention_wrap(None, 256) is None      # 64 rows < 128
        x = torch.ones(3)
        assert AS.constrain(x, "hidden") is x
    finally:
        AS.set_policy(None)
    AS.set_policy(ProcessGrid((4,), ("data",), rank=0), cp_attention=True)
    assert AS.cp_attention_wrap(None, 1024) is None         # no `model`
    AS.set_policy(None)
    assert AS.grid() is None
