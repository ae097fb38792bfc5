"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's `init_moe` / `moe_apply` on the same parameters (carried
across) and numpy-seeded float32 tokens.

Tolerances: output and aux loss 1e-5 absolute; the routed experts, each
pair's position in its expert and the set of dropped (token, expert)
pairs equal, also at a capacity that drops and with tied router
probabilities (ties go to the lower expert id, as `lax.top_k`'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs import MoEConfig
from repro_torch.models import moe

TOL = 1e-5

# one compile a case instead of one a primitive
_jmoe_apply = jax.jit(jmoe.moe_apply, static_argnums=(2,),
                      static_argnames=("capacity", "n_pad_experts"))
_jinit_moe = jax.jit(jmoe.init_moe, static_argnums=(1, 2, 3),
                     static_argnames=("n_pad_experts",))

CASES = {
    # name: (config kwargs, d_model, tokens, padding experts, capacity)
    "shared_pad": (dict(n_experts=6, top_k=2, d_expert=32,
                        n_shared_experts=1, d_shared=32), 48, 64, 2, None),
    "drops": (dict(n_experts=4, top_k=2, d_expert=16,
                   capacity_factor=0.5), 24, 96, 0, None),
    "top1_shared": (dict(n_experts=8, top_k=1, d_expert=16,
                         n_shared_experts=1, d_shared=16), 32, 40, 0, None),
    "capacity_3": (dict(n_experts=5, top_k=3, d_expert=8), 16, 30, 0, 3),
}


def _top_and_pos(logits, *, k, E):
    _, top = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    flat = top.reshape(-1)
    oh = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, 0) - oh, flat[:, None], 1)[:, 0]
    return top, pos


_jtop_and_pos = jax.jit(_top_and_pos, static_argnames=("k", "E"))


def _reference_routing(p, x, mc, n_pad, capacity):
    """The reference's routing steps (`moe_apply` :46-67) on its arrays:
    experts a token picks, positions in experts, kept pairs."""
    T = x.shape[0]
    E = mc.n_experts + n_pad
    if capacity is None:
        capacity = max(8, int(mc.capacity_factor * T * mc.top_k
                              / mc.n_experts))
    logits = np.asarray(x) @ p["router"]
    if n_pad:
        logits = np.where(np.arange(E)[None] >= mc.n_experts, -1e30, logits)
    top, pos = _jtop_and_pos(jnp.asarray(logits, jnp.float32), k=mc.top_k,
                             E=E)
    pos = np.asarray(pos)
    return np.asarray(top), pos, pos < capacity


def _case(name, tie=False):
    kw, D, T, n_pad, cap = CASES[name]
    jmc, mc = JMoEConfig(**kw), MoEConfig(**kw)
    jp = _jinit_moe(jax.random.PRNGKey(0), D, jmc, jnp.float32,
                    n_pad_experts=n_pad)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    if tie:
        # experts 1 and 2 get the same router column: equal probabilities
        r = jp["router"].copy()
        r[:, 2] = r[:, 1]
        jp = dict(jp, router=r)
    x = np.random.default_rng(1).normal(size=(T, D)).astype(np.float32)
    return jmc, mc, jp, x, n_pad, cap


def _port_params(jp):
    return {n: (_port_params(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v))) for n, v in jp.items()}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "tied"])
def test_moe_apply_matches_the_reference(name, tie):
    jmc, mc, jp, x, n_pad, cap = _case(name, tie)
    jout, jaux = _jmoe_apply({n: jax.tree_util.tree_map(jnp.asarray, v)
                                 for n, v in jp.items()}, jnp.asarray(x),
                                jmc, capacity=cap, n_pad_experts=n_pad)
    p = _port_params(jp)
    out, aux = moe.moe_apply(p, torch.from_numpy(x), mc, capacity=cap,
                             n_pad_experts=n_pad)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=TOL)
    top, pos, keep = _reference_routing(jp, jnp.asarray(x), jmc, n_pad, cap)
    r = moe.route(p, torch.from_numpy(x), mc, capacity=cap,
                  n_pad_experts=n_pad)
    np.testing.assert_array_equal(r.top_ids.numpy(), top)
    np.testing.assert_array_equal(r.pos_in_e.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    dropped = set(np.flatnonzero(~keep).tolist())
    assert set(np.flatnonzero(~r.keep.numpy()).tolist()) == dropped
    if name in ("drops", "capacity_3"):
        assert dropped, "this case must drop pairs"
    if tie:
        # a token whose top choices tie picks expert 1 before expert 2
        both = (top == 1).any(1) & (top == 2).any(1)
        for row in np.flatnonzero(both):
            ids = list(top[row])
            assert ids.index(1) < ids.index(2)


def test_padding_experts_get_no_tokens_and_drops_are_counted():
    jmc, mc, jp, x, n_pad, _ = _case("shared_pad")
    p = _port_params(jp)
    r = moe.route(p, torch.from_numpy(x), mc, n_pad_experts=n_pad)
    assert int(r.top_ids.max()) < mc.n_experts
    jmc, mc, jp, x, n_pad, _ = _case("drops")
    p = _port_params(jp)
    with moe.count_drops() as drops:
        moe.moe_apply(p, torch.from_numpy(x), mc)
    r = moe.route(p, torch.from_numpy(x), mc)
    assert [(int(d), n) for d, n in drops] == \
        [(int((~r.keep).sum()), x.shape[0] * mc.top_k)]
    assert moe._DROPS is None


def test_init_moe_shapes_dtypes_and_scales():
    mc = MoEConfig(n_experts=6, top_k=2, d_expert=64, n_shared_experts=1,
                   d_shared=96)
    jp = _jinit_moe(jax.random.PRNGKey(0), 128, JMoEConfig(
        **{f: getattr(mc, f) for f in mc.__dataclass_fields__}),
        jnp.bfloat16, n_pad_experts=2)
    p = moe.init_moe(128, mc, generator=torch.Generator().manual_seed(0),
                     device="cpu", dtype=torch.bfloat16, n_pad_experts=2)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {"/".join(str(k.key) for k in path): a for path, a in flat}
    got = {("shared/" + n if isinstance(v, torch.Tensor) and s else n): v
           for s, d in ((False, p), (True, p["shared"]))
           for n, v in d.items() if isinstance(v, torch.Tensor)}
    assert sorted(got) == sorted(want)
    for n, a in want.items():
        t = got[n]
        assert tuple(t.shape) == a.shape, n
        assert str(t.dtype).split(".")[1] == str(a.dtype), n
        sa = float(np.asarray(a, np.float32).std())
        assert abs(float(t.float().std()) - sa) <= 0.1 * sa, n
