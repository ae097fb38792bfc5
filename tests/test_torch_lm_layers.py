"""The port's LM layers (`repro_torch.models.layers`: rms_norm, rope,
flash_attention, flash_attention_vjp, decode_attention, swiglu) against
the JAX package on the same numpy-seeded float32 inputs.

Tolerances:
  * rms_norm, rope, flash_attention (full, sliding and chunked masks;
    padded query and key blocks; a query offset), decode_attention,
    swiglu: 2e-5 absolute;
  * flash_attention_vjp: the output at 2e-5, its gradients against
    `jax.grad` of the reference's custom VJP at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro_torch.models import layers as L

TOL = 2e-5
TOL_GRAD = 1e-4


def _np(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def test_rms_norm_and_rope():
    x = _np(2, 9, 4, 16, seed=1)
    scale = _np(16, seed=2) + 1.0
    np.testing.assert_allclose(
        L.rms_norm(_t(x), _t(scale), 1e-6).numpy(),
        np.asarray(jL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
        rtol=0, atol=TOL)
    pos = np.broadcast_to(np.arange(300, 309, dtype=np.int32), (2, 9))
    for theta in (10_000.0, 1_000_000.0):
        got = L.rope(_t(x), torch.from_numpy(pos.copy()), theta).numpy()
        want = np.asarray(jL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_rope_and_rms_norm_keep_bfloat16():
    x = torch.from_numpy(_np(1, 5, 2, 8, seed=3)).to(torch.bfloat16)
    pos = torch.arange(5)[None]
    assert L.rope(x, pos, 1e4).dtype == torch.bfloat16
    assert L.rms_norm(x, torch.ones(8)).dtype == torch.bfloat16


# (mask, window, chunked), (Sq, Skv, q_offset, block_q, block_kv)
MASKS = [("full", 0, False), ("sliding", 40, False), ("chunked", 64, True)]
GEOMS = [(300, 300, 0, 64, 128),      # padded last q and kv blocks
         (300, 300, 0, 128, 64),
         (100, 337, 37, 64, 128)]     # queries after a 37-token prefix


def _qkv(Sq, Skv, seed, H=4, KVH=2, hd=16):
    return (_np(2, Sq, H, hd, seed=seed), _np(2, Skv, KVH, hd, seed=seed + 1),
            _np(2, Skv, KVH, hd, seed=seed + 2))


@pytest.mark.parametrize("mask", MASKS, ids=[m[0] for m in MASKS])
@pytest.mark.parametrize("geom", GEOMS, ids=["sq300_64_128", "sq300_128_64",
                                             "offset37"])
def test_flash_attention_matches_the_reference(mask, geom):
    _, window, chunked = mask
    Sq, Skv, off, bq, bk = geom
    q, k, v = _qkv(Sq, Skv, seed=10)
    kw = dict(causal=True, window=window, chunked=chunked, block_q=bq,
              block_kv=bk)
    # the reference jits q_offset as a traced value: pass it only when set
    want = np.asarray(jL.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw,
        **({"q_offset": off} if off else {})))
    got = L.flash_attention(_t(q), _t(k), _t(v), q_offset=off, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_flash_attention_without_causal_mask():
    q, k, v = _qkv(70, 90, seed=20)
    for window, chunked in ((0, False), (32, True)):
        kw = dict(causal=False, window=window, chunked=chunked, block_q=32,
                  block_kv=32)
        want = np.asarray(jL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), **kw))
        got = L.flash_attention(_t(q), _t(k), _t(v), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("mask", MASKS, ids=[m[0] for m in MASKS])
@pytest.mark.parametrize("geom", GEOMS[1:], ids=["sq300_128_64",
                                                 "offset37"])
def test_flash_vjp_gradients_match_jax_grad(mask, geom):
    _, window, chunked = mask
    Sq, Skv, off, bq, bk = geom
    q, k, v = _qkv(Sq, Skv, seed=30)
    dout = _np(2, Sq, 4, 16, seed=33)

    def jf(q, k, v):
        o = jL.flash_attention_vjp(q, k, v, jnp.int32(off), True, window,
                                   chunked, bq, bk)
        return jnp.sum(o * jnp.asarray(dout)), o

    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o = L.flash_attention_vjp(tq, tk, tv, off, True, window, chunked, bq, bk)
    o.backward(_t(dout))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=TOL)
    for name, want, got in zip("qkv", jg, (tq, tk, tv)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=0, atol=TOL_GRAD, err_msg=name)


def test_flash_vjp_gradients_match_autograd_of_the_forward():
    """The hand-written backward against autograd through the blockwise
    forward (the reference's naive baseline)."""
    q, k, v = _qkv(48, 48, seed=40)
    a = [_t(x).requires_grad_() for x in (q, k, v)]
    b = [_t(x).requires_grad_() for x in (q, k, v)]
    (L.flash_attention(*a, window=16, block_q=16, block_kv=16) ** 2) \
        .sum().backward()
    (L.flash_attention_vjp(*b, 0, True, 16, False, 16, 16) ** 2) \
        .sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=0,
                                   atol=TOL_GRAD)


def test_gqa_query_head_serves_kv_head_h_div_g():
    """Query head h reads KV head h // G (kv-major): with every KV head
    but one zeroed, only that head's G query heads see its values."""
    B, S, H, KVH, hd = 1, 8, 6, 3, 4
    q = torch.zeros(B, S, H, hd)
    k = torch.zeros(B, S, KVH, hd)
    v = torch.zeros(B, S, KVH, hd)
    v[:, :, 1] = 1.0                          # only KV head 1 is non-zero
    out = L.flash_attention(q, k, v, block_q=4, block_kv=4)
    live = out.abs().sum(dim=(0, 1, 3)) > 0
    assert live.tolist() == [h // (H // KVH) == 1 for h in range(H)]
    dec = L.decode_attention(q[:, :1], k, v, torch.full((B,), S))
    assert ((dec.abs().sum(dim=(0, 1, 3)) > 0) == live).all()


def test_block_plan_stays_inside_the_reference_band():
    """Every KV block the plan visits lies in the reference's
    `_band_bounds` range, and the plan visits every block that holds an
    allowed (query, key) pair."""
    for window, chunked in ((0, False), (40, False), (64, True)):
        for Sq, Skv, off, bq, bk in GEOMS:
            plan = L._block_plan(Sq, Skv, off, True, window, chunked, bq, bk)
            nk = -(-Skv // bk)
            for qi, blocks in enumerate(plan):
                lo, hi = L._band_bounds(qi, off, causal=True, window=window,
                                        chunked=chunked, block_q=bq,
                                        block_kv=bk, nk=nk)
                assert all(lo <= ki < hi for ki, _ in blocks)
                q_pos = torch.arange(qi * bq, min(qi * bq + bq, Sq)) + off
                for ki in range(nk):
                    k_pos = torch.arange(ki * bk, min(ki * bk + bk, Skv))
                    m = L._block_mask(q_pos, k_pos, causal=True,
                                      window=window, chunked=chunked)
                    visited = dict(blocks)
                    assert bool(m.any()) == (ki in visited)
                    if ki in visited and visited[ki]:
                        assert bool(m.all()) and len(q_pos) == bq


@pytest.mark.parametrize("window,chunked", [(0, False), (5, False),
                                            (8, True)])
def test_decode_attention_matches_the_reference(window, chunked):
    B, T, H, KVH, hd = 3, 24, 4, 2, 16
    q = _np(B, 1, H, hd, seed=50)
    kc, vc = _np(B, T, KVH, hd, seed=51), _np(B, T, KVH, hd, seed=52)
    clen = np.array([1, 13, 24], np.int32)
    want = np.asarray(jL.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(clen),
        window=window, chunked=chunked))
    got = L.decode_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(clen),
                             window=window, chunked=chunked)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_swiglu_matches_the_reference():
    x = _np(5, 32, seed=60)
    p = {"w_gate": _np(32, 48, seed=61, scale=0.2),
         "w_up": _np(32, 48, seed=62, scale=0.2),
         "w_down": _np(48, 32, seed=63, scale=0.2)}
    want = np.asarray(jL.swiglu({n: jnp.asarray(a) for n, a in p.items()},
                                jnp.asarray(x)))
    got = L.swiglu({n: _t(a) for n, a in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    ps = L.init_swiglu(32, 48, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert {n: tuple(t.shape) for n, t in ps.items()} == \
        {"w_gate": (32, 48), "w_up": (32, 48), "w_down": (48, 32)}


def test_bfloat16_products_accumulate_in_float32():
    """Two bfloat16 operands give float32 products equal to the float32
    product of their widened values (no bfloat16 rounding of the sum)."""
    a = torch.from_numpy(_np(2, 8, 300, seed=70)).to(torch.bfloat16)
    b = torch.from_numpy(_np(2, 300, 5, seed=71)).to(torch.bfloat16)
    got = L.mm_f32(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(a.float(), b.float()))
    assert L.bf16_bmm_route(torch.device("cpu")) == "widen"
