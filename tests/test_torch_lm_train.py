"""The port's LM training path (`distributed.train_step`'s lm branches,
`launch.train`'s `tiny_lm` trainer, `checkpoint.ckpt` with bfloat16
leaves) against the JAX package.

Tolerances:
  * 3 train steps from the reference's initial state (carried by
    `train_state_from_jax`): the loss within 1e-4 each step; after each
    step, per leaf, parameters within 1e-4 absolute (Adam's first steps
    move an element by about lr whatever its gradient's size, so a
    last-bit difference in a near-zero gradient shows at that scale);
  * checkpoints of a bfloat16 LM state: each package restores the
    other's, every leaf bit-equal (bfloat16 parameters, float32 master
    weights and moments, the step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_arch as jget_arch
from repro.configs import registry as jregistry
from repro.distributed import train_step as jts
from repro.launch import train as jtrain
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.distributed import train_step as ts
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import param_tree

TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_tiny_state(aid, steps, lr):
    """The reference's `build_trainer(aid, "train_4k", scale="tiny")`
    initial state and its jitted step."""
    _, init, step, data, _ = jtrain.build_trainer(aid, "train_4k",
                                                  steps=steps, lr=lr)
    return init(), step, data


@pytest.mark.parametrize("aid", ["qwen3-1.7b", "llama4-scout-17b-a16e"])
def test_three_train_steps_match_the_reference(aid):
    """tiny_lm keeps each arch's attention (qwen3: full with qk-norm and
    tied embeddings; Scout: chunked local layers and a global NoPE one,
    an untied head)."""
    jstate, jstep, jdata = _jax_tiny_state(aid, steps=3, lr=3e-3)
    arch, _, step, data = train.build_trainer(aid, "train_4k", steps=3,
                                              lr=3e-3, device="cpu")
    assert arch.model.n_layers == 4 and arch.model.d_model == 128
    state = ts.train_state_from_jax(_np_tree(jstate), device="cpu")
    for s in range(3):
        b = data(s)
        for k, v in jdata(s).items():
            np.testing.assert_array_equal(v, b[k])
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, b)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=TOL)
        want = jax.tree_util.tree_flatten_with_path(_np_tree(jstate.params))
        want = {"/".join(str(k.key) for k in path): a
                for path, a in want[0]}
        got = param_tree(state.params)
        assert list(got) == list(want)
        for n, a in want.items():
            np.testing.assert_allclose(got[n].detach().numpy(), a, rtol=0,
                                       atol=TOL, err_msg=f"step {s} {n}")
    assert int(state.opt.step) == 3


def test_lm_embedding_trains_on_a_dense_gradient():
    """`embed` is a row-wise Adagrad leaf that gets a dense gradient (tied,
    it is the unembedding too): the step takes it, and an untouched row
    moves by 0 as in the reference; a recommender table still refuses a
    dense one."""
    _, init, step, data = train.build_trainer("qwen3-1.7b", "train_4k",
                                              steps=2, device="cpu")
    state = init(torch.Generator().manual_seed(0))
    before = state.params.embed.detach().clone()
    b = data(0)
    step(state, b)
    moved = (state.params.embed != before).any(1)
    assert int(moved.sum()) == before.shape[0]    # tied: every row moves
    cfg = configs.get_arch("qwen2-moe-a2.7b").model
    untied = train.tiny_lm(cfg).scaled(tie_embeddings=False)
    arch = dataclasses.replace(configs.get_arch("qwen2-moe-a2.7b"),
                               model=untied)
    p = T.init_lm(untied, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    opt_init, opt_update = ts.default_optimizer(2, 3e-3)
    st = ts.TrainState(p, opt_init(p))
    before = p.embed.detach().clone()
    loss_fn = ts.make_loss_fn(arch, arch.shape("train_4k"))
    _, _, grads = ts._grads(loss_fn, p, b)
    assert not grads["embed"].is_sparse
    opt_update(grads, st.opt, p)
    seen = np.zeros(untied.vocab_size, bool)
    seen[b["tokens"].reshape(-1)] = True
    moved = (p.embed != before).any(1).numpy()
    assert not moved[~seen].any() and moved[seen].all()
    rec = configs.get_arch("dcn-v2")
    with pytest.raises(RuntimeError, match="dense gradient"):
        ts._grads(lambda p, b: ((p.tables[0] ** 2).sum(), {}),
                  train._make_init(dataclasses.replace(
                      rec, model=rec.model.scaled(vocab_sizes=(10,) * 26)))(
                      torch.Generator().manual_seed(0), "cpu"), {})


def test_serve_steps_and_trainer_take_the_lm_family():
    arch = configs.get_arch("qwen3-1.7b")
    cfg = train.tiny_lm(arch.model)
    arch = dataclasses.replace(arch, model=cfg)
    p = T.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    prefill = ts.make_serve_step(arch, arch.shape("prefill_32k"))
    decode = ts.make_serve_step(arch, arch.shape("decode_32k"))
    pre = prefill(p, {"tokens": toks})
    cache = T.init_cache(cfg, 2, 8, device="cpu")
    for t in range(8):
        logits, cache = decode(p, cache, {"token": toks[:, t], "pos": t})
    np.testing.assert_allclose(logits.numpy(), pre.numpy(), rtol=2e-3,
                               atol=2e-3)
    with pytest.raises(ValueError):
        ts.make_serve_step(arch, arch.shape("train_4k"))
    _, _, _, data = train.build_trainer("h2o-danube-1.8b", "train_4k",
                                        device="cpu", batch=2)
    assert data(0)["tokens"].shape == (2, 128)
    # the GNN id, ported since, is the reference's too
    assert dataclasses.asdict(configs.get_arch("graphsage-reddit")) == \
        dataclasses.asdict(jget_arch("graphsage-reddit"))
    assert configs.list_archs() == jregistry.list_archs()


def _bits(a):
    """A leaf as comparable numpy: bfloat16 as its 16-bit pattern."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return a.numpy(), str(a.numpy().dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _same(a: dict, b: dict):
    assert list(a) == list(b)
    for n in a:
        (x, dx), (y, dy) = _bits(a[n]), _bits(b[n])
        assert dx == dy and x.shape == y.shape, n
        np.testing.assert_array_equal(x, y, err_msg=n)


def test_lm_checkpoints_cross_between_the_packages_in_bfloat16(tmp_path):
    """A bfloat16 reduced qwen2-moe state (QKV bias, routed and shared
    experts, float32 master weights), stepped so that its moments are not
    zero: the reference's checkpoint restores into the port's state in
    place, the port's into the reference's, leaf for leaf."""
    jcfg = jget_arch("qwen2-moe-a2.7b").model.scaled(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=48, vocab_size=256, dtype="bfloat16",
        moe=dataclasses.replace(jget_arch("qwen2-moe-a2.7b").model.moe,
                                n_experts=4, d_expert=16, d_shared=16))
    jp = jax.jit(jT.init_lm, static_argnums=(1,))(jax.random.PRNGKey(0),
                                                   jcfg)
    init, _ = jts.default_optimizer(10, 3e-3)
    init = jax.jit(init)
    jstate = jts.TrainState(jp, init(jp))
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree_util.tree_map(lambda x: x + 0.5, jstate.opt.m),
        v=jax.tree_util.tree_map(lambda x: x + 0.25, jstate.opt.v)))
    jckpt.save(str(tmp_path / "jax"), jstate, step=3)
    fresh = jts.TrainState(jp, init(jp))
    like = ts.train_state_from_jax(_np_tree(fresh), device="cpu")
    assert like.params.embed.dtype == torch.bfloat16
    ptr = like.params.layers.moe.w_gate.data_ptr()
    got = ckpt.restore(str(tmp_path / "jax"), like, device="cpu")
    assert got.params.layers.moe.w_gate.data_ptr() == ptr   # in place
    jflat, _ = jckpt._flatten(_np_tree(jstate))
    _same(ckpt._flatten(got), jflat)
    ckpt.save(str(tmp_path / "port"), got, step=4)
    back = jckpt.restore(str(tmp_path / "port"), fresh)
    bflat, _ = jckpt._flatten(_np_tree(back))
    _same(bflat, ckpt._flatten(got))
