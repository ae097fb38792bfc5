"""The port's SASRec retrieval (`repro_torch.models.recsys`) against
`repro.models.recsys` at a small size: vocab 2000, seq_len 8, the full
width (embed_dim 50, 2 blocks, 1 head). Parameters come from the JAX
package's init through `recsys_params_from_jax`; PQ codebooks and codes
(m=10) from its `pq.train_codebooks` / `encode`. Tolerances: 1e-5 for
hidden states and scores, exact ids."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import REC_SHAPES
from repro.configs.dcn_v2 import MODEL as JDCN
from repro.configs.dlrm_rm2 import MODEL as JDLRM
from repro.configs.sasrec import MODEL as JSASREC
from repro.configs.wide_deep import MODEL as JWD
from repro.core import pq as jpq
from repro.models import layers as jlayers
from repro.models import recsys as jrec
from repro_torch import configs
from repro_torch.models import layers, recsys

V, S, B = 2000, 8, 4
JCFG = JSASREC.scaled(vocab_sizes=(V,), seq_len=S)
CFG = configs.SASREC.scaled(vocab_sizes=(V,), seq_len=S)


@pytest.fixture(scope="module")
def model():
    jp = jrec.init_recsys(jax.random.PRNGKey(0), JCFG)
    p = recsys.recsys_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
    return jp, p


@pytest.fixture(scope="module")
def pq_model(model):
    jp, _ = model
    cand = np.asarray(jnp.take(jp["tables"][0], jnp.arange(V), axis=0)
                      @ jp["item_proj"])
    cb = jpq.train_codebooks(jax.random.PRNGKey(1), cand, m=10, iters=6)
    return np.asarray(cb.centroids), np.asarray(jpq.encode(cb, cand))


def _seq(seed, b=B):
    return np.random.default_rng(seed).integers(0, V, (b, S)).astype(
        np.int32)


def _jbatch(seq):
    return {"seq": jnp.asarray(seq), "cand_ids": jnp.arange(V,
                                                            dtype=jnp.int32)}


def _batch(seq):
    return {"seq": seq, "cand_ids": np.arange(V)}


def test_configs_are_copies():
    assert dataclasses.asdict(configs.SASREC) == dataclasses.asdict(JSASREC)
    for mine, theirs in ((configs.DLRM_RM2, JDLRM), (configs.DCN_V2, JDCN),
                         (configs.WIDE_DEEP, JWD)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    cand = [s for s in REC_SHAPES if s.name == "retrieval_cand"][0]
    assert dataclasses.asdict(configs.RETRIEVAL_CAND) == \
        dataclasses.asdict(cand)
    assert [dataclasses.asdict(s) for s in configs.REC_SHAPES] == \
        [dataclasses.asdict(s) for s in REC_SHAPES]
    assert CFG.scaled(name="x").name == "x"


def test_params_from_jax_carry_every_array(model):
    jp, p = model
    np.testing.assert_array_equal(p.tables[0].detach().numpy(),
                                  np.asarray(jp["tables"][0]))
    np.testing.assert_array_equal(p.pos.detach().numpy(),
                                  np.asarray(jp["pos"]))
    np.testing.assert_array_equal(p.item_proj.detach().numpy(),
                                  np.asarray(jp["item_proj"]))
    assert len(p.blocks) == len(jp["blocks"]) == 2
    for b, jb in zip(p.blocks, jp["blocks"]):
        for name in ("wq", "wk", "wv", "ln1", "ln2"):
            np.testing.assert_array_equal(getattr(b, name).detach().numpy(),
                                          np.asarray(jb[name]))
        for l, jl in zip(b.ff, jb["ff"]):
            np.testing.assert_array_equal(l["w"].detach().numpy(),
                                          np.asarray(jl["w"]))
            np.testing.assert_array_equal(l["b"].detach().numpy(),
                                          np.asarray(jl["b"]))


def test_init_recsys_matches_jax_shapes_and_scales(model):
    """Same shapes as the JAX init; the truncated normals have the
    reference's distribution (bounded by 2 scales, the truncated std)."""
    jp, _ = model
    g = torch.Generator().manual_seed(0)
    p = recsys.init_recsys(CFG, generator=g, device="cpu")
    assert p.tables[0].shape == (recsys.padded_vocab(V), 50) \
        == jp["tables"][0].shape
    assert p.pos.shape == jp["pos"].shape
    for b, jb in zip(p.blocks, jp["blocks"]):
        assert b.wq.shape == jb["wq"].shape
        assert [tuple(l["w"].shape) for l in b.ff] == \
            [l["w"].shape for l in jb["ff"]]
        assert torch.equal(b.ln1, torch.ones(50))
    for mine, theirs, scale in ((p.tables[0], jp["tables"][0], 0.05),
                                (p.item_proj, jp["item_proj"], 50 ** -0.5)):
        mine = mine.detach().numpy()
        theirs = np.asarray(theirs)
        assert np.abs(mine).max() <= 2 * scale * (1 + 1e-6)
        assert abs(mine.std() - theirs.std()) <= 0.1 * theirs.std()
    # a seed gives the same parameters again, bit for bit (compared with
    # zero tolerance by assert_close, whose message names the mismatched
    # elements and the largest difference)
    again = recsys.init_recsys(CFG, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    for (name, a), b in zip(p.named_parameters(), again.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=lambda m:
                                   f"{name}: {m}")


def test_truncnorm_init_distribution():
    """A large draw against JAX's: mean, std and the [-2, 2] bounds."""
    x = layers.truncnorm_init((200_000,), 1.0,
                              generator=torch.Generator().manual_seed(3),
                              device="cpu").numpy()
    y = np.asarray(jlayers.truncnorm_init(jax.random.PRNGKey(3), (200_000,),
                                          1.0, jnp.float32))
    assert x.min() >= -2.0 and x.max() <= 2.0
    assert abs(x.mean()) < 0.01 and abs(x.mean() - y.mean()) < 0.01
    assert abs(x.std() - y.std()) < 0.01


@pytest.mark.parametrize("shape,scale", [((37, 11), 0.05), ((1000,), 1.0),
                                         ((64, 64), 64 ** -0.5)])
def test_truncnorm_init_in_place_is_bit_equal_to_the_expression(shape, scale):
    """The in-place draw (uniform_, erfinv_, mul_, clamp_, mul_ on one
    buffer) gives the bits of the three-buffer expression it replaced."""
    import math
    hi = math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape).uniform_(-hi, hi,
                                    generator=torch.Generator().manual_seed(7))
    want = scale * torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    got = layers.truncnorm_init(shape, scale,
                                generator=torch.Generator().manual_seed(7),
                                device="cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    half = layers.truncnorm_init(shape, scale, dtype=torch.float16,
                                 generator=torch.Generator().manual_seed(7),
                                 device="cpu")
    assert torch.equal(half, want.to(torch.float16))


def test_mlp_apply_matches_jax():
    rng = np.random.default_rng(4)
    ws = [rng.normal(size=(6, 5)), rng.normal(size=(5, 3))]
    bs = [rng.normal(size=5), rng.normal(size=3)]
    x = rng.normal(size=(7, 6)).astype(np.float32)
    jl = [{"w": jnp.asarray(w, jnp.float32), "b": jnp.asarray(b, jnp.float32)}
          for w, b in zip(ws, bs)]
    tl = [{"w": torch.tensor(w, dtype=torch.float32),
           "b": torch.tensor(b, dtype=torch.float32)} for w, b in zip(ws, bs)]
    for final in (False, True):
        np.testing.assert_allclose(
            layers.mlp_apply(tl, torch.from_numpy(x), final_act=final)
            .numpy(),
            np.asarray(jlayers.mlp_apply(jl, jnp.asarray(x), final_act=final)),
            rtol=1e-5, atol=1e-5)


def test_embedding_bag_and_padded_vocab_match_jax():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(40, 6)).astype(np.float32)
    idx = rng.integers(0, 40, (3, 4, 5))
    for comb in ("sum", "mean"):
        np.testing.assert_allclose(
            recsys.embedding_bag(torch.from_numpy(table),
                                 torch.from_numpy(idx), comb).numpy(),
            np.asarray(jrec.embedding_bag(jnp.asarray(table),
                                          jnp.asarray(idx), comb)),
            rtol=1e-6, atol=1e-6)
    for v in (1, 2048, 2049, 1_000_000):
        assert recsys.padded_vocab(v) == jrec.padded_vocab(v)
    assert recsys.padded_vocab(1_000_000) == 1_001_472


def test_sasrec_hidden_and_user_tower_match_jax(model):
    jp, p = model
    seq = _seq(0)
    want = np.asarray(jrec.sasrec_hidden(jp, jnp.asarray(seq), JCFG))
    with torch.no_grad():
        mine = recsys.sasrec_hidden(p, torch.from_numpy(seq), CFG).numpy()
    assert mine.shape == (B, S, 50)
    np.testing.assert_allclose(mine, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        recsys.user_tower(p, _batch(seq), CFG).numpy(),
        np.asarray(jrec.user_tower(jp, _jbatch(seq), JCFG)),
        rtol=1e-5, atol=1e-5)


def test_retrieval_topk_matches_jax(model):
    jp, p = model
    seq = _seq(1)
    np.testing.assert_allclose(
        recsys.retrieval_scores(p, _batch(seq), CFG).numpy(),
        np.asarray(jrec.retrieval_scores(jp, _jbatch(seq), JCFG)),
        rtol=1e-5, atol=1e-5)
    ids, vals = recsys.retrieval_topk(p, _batch(seq), CFG, k=100)
    jids, jvals = jrec.retrieval_topk(jp, _jbatch(seq), JCFG, k=100)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_retrieval_topk_pq_matches_jax(model, pq_model, seed):
    jp, p = model
    cents, codes = pq_model
    seq = _seq(seed, b=1)
    jids, jvals = jrec.retrieval_topk_pq(jp, _jbatch(seq), JCFG,
                                         jnp.asarray(codes),
                                         jnp.asarray(cents), k=100)
    for backend in ("auto", "ref"):
        ids, vals = recsys.retrieval_topk_pq(
            p, _batch(seq), CFG, torch.from_numpy(codes.copy()),
            torch.from_numpy(cents.copy()), k=100, rerank_mult=4,
            backend=backend)
        assert ids.shape == (1, 100) and vals.shape == (1, 100)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(vals.numpy(), np.asarray(jvals),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [2, 5])
def test_make_retrieval_fn_on_the_cpu_matches_jax(model, pq_model, seed):
    """On the CPU the request runs eagerly: the same answer as
    retrieval_topk_pq and the reference, request after request."""
    jp, p = model
    cents, codes = pq_model
    fn = recsys.make_retrieval_fn(p, CFG, torch.from_numpy(codes.copy()),
                                  torch.from_numpy(cents.copy()), k=100,
                                  rerank_mult=4)
    for s in (seed, seed + 10):
        seq = _seq(s, b=1)
        ids, vals = fn(_batch(seq))
        want = recsys.retrieval_topk_pq(
            p, _batch(seq), CFG, torch.from_numpy(codes.copy()),
            torch.from_numpy(cents.copy()), k=100, rerank_mult=4)
        assert torch.equal(ids, want[0]) and torch.equal(vals, want[1])
        jids, _ = jrec.retrieval_topk_pq(jp, _jbatch(seq), JCFG,
                                         jnp.asarray(codes),
                                         jnp.asarray(cents), k=100)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("kind,scale", [
    ("dlrm", 0.05), ("dcnv2", 0.05), ("widedeep", 0.05), ("sasrec", 0.05)])
def test_init_recsys_of_every_kind_bounds_its_tables(kind, scale):
    """Each kind (the towers at the reference's published shapes, cut to
    two 10-row fields) draws its tables at the padded size within 2
    scales, the item projection within 2 / sqrt(D), on the CPU."""
    cfg = {"dlrm": configs.DLRM_RM2, "dcnv2": configs.DCN_V2,
           "widedeep": configs.WIDE_DEEP, "sasrec": CFG}[kind]
    if kind != "sasrec":
        cfg = cfg.scaled(vocab_sizes=(10, 10))
    p = recsys.init_recsys(cfg, generator=torch.Generator().manual_seed(1),
                           device="cpu")
    D = cfg.embed_dim
    for t, v in zip(p.tables, cfg.vocab_sizes):
        assert tuple(t.shape) == (recsys.padded_vocab(v), D)
        assert float(t.detach().abs().max()) <= 2 * scale * (1 + 1e-6)
    assert tuple(p.item_proj.shape) == (D, D)
    assert float(p.item_proj.detach().abs().max()) \
        <= 2 * D ** -0.5 * (1 + 1e-6)
