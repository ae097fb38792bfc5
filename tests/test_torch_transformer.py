"""The port's decoder-only LM (`repro_torch.models.transformer`) against
the JAX package's, for each of the five LM archs at the reference
test's `reduced_lm` scale (tests/test_smoke_archs.py: every structural
feature kept, MoE cut to 8 experts, Scout to 4 layers so that layer 3 is
global), float32, with the reference's parameters carried across by
`lm_params_from_jax`.

Tolerances:
  * `lm_hidden` (and its aux loss), `lm_loss`, `lm_prefill`, and the
    logits of 9 `lm_decode_step` calls: 1e-4 absolute;
  * decode against prefill, the reference's own bar
    (tests/test_models_lm.py): rtol = atol = 2e-3. An MoE arch drops
    other (token, expert) pairs in a 9-token prefill than in a decode of
    one token a step (capacity counts this call's tokens), so there its
    capacity factor is raised until nothing drops;
  * carried parameters: bit-equal, bfloat16 included; the port's own
    init: the reference's tree paths, shapes and dtypes, standard
    deviations within 10%.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as jT
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.models.moe import count_drops
from repro_torch.optim.adamw import param_tree
from test_smoke_archs import reduced_lm      # either package's config

LM_ARCHS = ("qwen3-1.7b", "h2o-danube-1.8b", "qwen2-1.5b",
            "qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
TOL = 1e-4
TOL_DECODE = 2e-3


@functools.partial(jax.jit, static_argnums=(2,))
def _jforward(p, batch, cfg):
    h, aux = jT.lm_hidden(p, batch["tokens"], cfg)
    loss, mets = jT.lm_loss(p, batch, cfg)
    return h, aux, loss, jT.lm_prefill(p, batch["tokens"], cfg)


_jdecode = jax.jit(jT.lm_decode_step, static_argnums=(4,))
_jinit = jax.jit(jT.init_lm, static_argnums=(1,))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(a) for path, a in flat}


@functools.lru_cache(maxsize=None)
def _setup(aid):
    jcfg, cfg = reduced_lm(jget_arch(aid).model), reduced_lm(
        get_arch(aid).model)
    jp = _np_tree(_jinit(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("aid", LM_ARCHS)
def test_forward_loss_prefill_and_decode_match_the_reference(aid):
    jcfg, cfg, jp = _setup(aid)
    p = T.lm_params_from_jax(jp, device="cpu")
    toks = _tokens(cfg, (2, 40), seed=1)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jh, jaux, jloss, jpre = _jforward(
        jax.tree_util.tree_map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.no_grad():
        h, aux = T.lm_hidden(p, toks, cfg)
        loss, mets = T.lm_loss(p, batch, cfg)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=TOL)
    assert float(mets["xent"]) + float(mets["aux"]) == \
        pytest.approx(float(loss), abs=1e-6)
    np.testing.assert_allclose(T.lm_prefill(p, toks, cfg).numpy(),
                               np.asarray(jpre), rtol=0, atol=TOL)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    jcache = jT.init_cache(jcfg, 2, 16)
    jpp = jax.tree_util.tree_map(jnp.asarray, jp)
    for t in range(9):
        logits, cache2 = T.lm_decode_step(p, cache, toks[:, t], t, cfg)
        assert cache2.k is cache.k               # updated in place
        jlogits, jcache = _jdecode(jpp, jcache, jnp.asarray(toks[:, t]),
                                   jnp.int32(t), jcfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=TOL, err_msg=f"step {t}")
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("aid", LM_ARCHS)
def test_decode_matches_prefill(aid):
    cfg = reduced_lm(get_arch(aid).model)
    if cfg.moe is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe,
                                                 capacity_factor=8.0))
    p = T.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    toks = _tokens(cfg, (2, 9), seed=2)
    with count_drops() as drops:
        pre = T.lm_prefill(p, toks, cfg)
        cache = T.init_cache(cfg, 2, 16, device="cpu")
        for t in range(toks.shape[1]):
            logits, cache = T.lm_decode_step(p, cache, toks[:, t], t, cfg)
    assert sum(int(d) for d, _ in drops) == 0
    np.testing.assert_allclose(logits.numpy(), pre.numpy(), rtol=TOL_DECODE,
                               atol=TOL_DECODE)


def test_windowed_decode_matches_prefill_past_the_window():
    """Sliding and chunked windows that the sequence outgrows (13 tokens,
    windows of 6 and 8, as tests/test_models_lm.py)."""
    base = get_arch("qwen3-1.7b").model.scaled(
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
        d_ff=96, vocab_size=256, dtype="float32", qk_norm=False)
    for attn, window in (("sliding", 6), ("chunked_global", 8)):
        cfg = base.scaled(attention=attn, window=window, global_every=2)
        p = T.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
        toks = _tokens(cfg, (1, 13), seed=3)
        pre = T.lm_prefill(p, toks, cfg)
        cache = T.init_cache(cfg, 1, 16, device="cpu")
        for t in range(13):
            logits, cache = T.lm_decode_step(p, cache, toks[:, t], t, cfg)
        np.testing.assert_allclose(logits.numpy(), pre.numpy(),
                                   rtol=TOL_DECODE, atol=TOL_DECODE)


def test_llama4_global_layers_skip_rope_and_the_chunk_mask():
    cfg = get_arch("llama4-scout-17b-a16e").model
    assert [T._is_global_layer(cfg, li) for li in range(8)] == \
        [False, False, False, True] * 2
    assert T._mask_of(cfg, 3) == (0, False, True)
    assert T._mask_of(cfg, 2) == (cfg.window, True, False)
    assert T._mask_of(get_arch("h2o-danube-1.8b").model, 0) == \
        (4096, False, False)


@pytest.mark.parametrize("aid", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_params_carry_across_leaf_for_leaf_in_bfloat16(aid):
    jcfg = reduced_lm(jget_arch(aid).model).scaled(dtype="bfloat16")
    jp = _np_tree(_jinit(jax.random.PRNGKey(1), jcfg))
    want = _paths(jp)
    p = T.lm_params_from_jax(jp, device="cpu")
    got = param_tree(p)
    # the reference's tree paths, in its flatten order
    assert list(got) == list(want)
    for n, t in got.items():
        a = want[n]
        assert tuple(t.shape) == a.shape, n
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, n
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), a.view(np.int16), err_msg=n)
        else:
            assert t.dtype == torch.float32, n
            np.testing.assert_array_equal(t.detach().numpy(), a, err_msg=n)


@pytest.mark.parametrize("aid", LM_ARCHS)
def test_init_lm_matches_the_reference_shapes_dtypes_and_scales(aid):
    """Full-width widths, depth cut to 2 layers (a global one for
    Scout's 4): paths, shapes, dtypes and standard deviations."""
    cfg = get_arch(aid).model
    n = 4 if cfg.attention == "chunked_global" else 2
    small = dict(n_layers=n, vocab_size=512)
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(cfg.moe, d_expert=64,
                                           d_shared=64 if cfg.moe.d_shared
                                           else 0)
    cfg = cfg.scaled(**small)
    jcfg = jget_arch(aid).model.scaled(**{
        k: (dataclasses.replace(jget_arch(aid).model.moe,
                                **{f: getattr(v, f) for f in
                                   ("d_expert", "d_shared")})
            if k == "moe" else v) for k, v in small.items()})
    want = jax.eval_shape(lambda k: jT.init_lm(k, jcfg),
                          jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in path): a for path, a in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    p = T.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    got = param_tree(p)
    assert list(got) == list(want)
    D = cfg.d_model
    for name, t in got.items():
        a = want[name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).split(".")[1] == str(a.dtype), name
    # truncated normal(scale): std = 0.8796 * scale
    for name, scale in (("embed", 0.02), ("layers/attn/w_q", D ** -0.5),
                        ("layers/attn/w_o", cfg.q_dim ** -0.5)):
        s = float(got[name].detach().float().std())
        assert abs(s - 0.8796 * scale) <= 0.1 * 0.8796 * scale, name
    assert float(got["final_norm"].detach().min()) == 1.0
    meta = T.init_lm(cfg, generator=torch.Generator(), device="meta")
    assert all(t.is_meta for t in meta.parameters())


def test_remat_and_chunked_loss_keep_the_values_and_gradients():
    """`cfg.remat` checkpoints each layer and each loss chunk: the loss
    and every gradient equal those of the same model without it."""
    _, cfg, jp = _setup("qwen3-1.7b")
    toks = _tokens(cfg, (2, 1024), seed=4)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    out = []
    for remat in (True, False):
        p = T.lm_params_from_jax(jp, device="cpu")
        loss, _ = T.lm_loss(p, batch, cfg.scaled(remat=remat))
        tree = param_tree(p)
        out.append((loss, torch.autograd.grad(loss, list(tree.values()))))
    assert float(out[0][0].detach()) == pytest.approx(
        float(out[1][0].detach()), abs=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
