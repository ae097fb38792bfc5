"""The port's DLRM, DCN-v2 and Wide&Deep towers (`repro_torch.models.recsys`)
against `repro.models.recsys` at narrow widths: embed_dim 8, 4-6 sparse
fields with table 0 at 2000 rows (the retrieval candidates), MLPs of width
16, 13 dense features where the kind has them, multi_hot 2 for
Wide&Deep. Parameters come from the JAX package's init through
`recsys_params_from_jax`; PQ codebooks and codes (m=4, dsub 2) from its
`pq.train_codebooks` / `encode`. Tolerances: rtol = atol = 1e-5 for
logits, losses and user vectors; exact ids for every retrieval path.
SASRec's CTR forward and loss are held the same way at its full width."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dcn_v2 as jdcn
from repro.configs import dlrm_rm2 as jdlrm
from repro.configs import registry as jregistry
from repro.configs import sasrec as jsasrec
from repro.configs import wide_deep as jwd
from repro.configs.base import REC_SHAPES
from repro.core import pq as jpq
from repro.models import recsys as jrec
from repro_torch import configs
from repro_torch.models import recsys

TOL = dict(rtol=1e-5, atol=1e-5)
B, C, D = 6, 2000, 8
VOCABS = (C, 50, 7, 300, 1000, 3)

# kind -> (reference config, port config, the narrow widths of both)
NARROW = {
    "dlrm": (jdlrm.MODEL, configs.DLRM_RM2, dict(
        embed_dim=D, vocab_sizes=VOCABS[:5], bot_mlp=(16, D),
        top_mlp=(16, 16, 1))),
    "dcnv2": (jdcn.MODEL, configs.DCN_V2, dict(
        embed_dim=D, vocab_sizes=VOCABS[:4], mlp=(16, 16))),
    "widedeep": (jwd.MODEL, configs.WIDE_DEEP, dict(
        embed_dim=D, vocab_sizes=VOCABS, mlp=(16, 16))),
    "sasrec": (jsasrec.MODEL, configs.SASREC, dict(
        vocab_sizes=(C,), seq_len=8)),
}
KINDS = ("dlrm", "dcnv2", "widedeep")


def _cfgs(kind):
    jcfg, cfg, kw = NARROW[kind]
    return jcfg.scaled(**kw), cfg.scaled(**kw)


@functools.lru_cache(maxsize=None)
def _model(kind):
    jcfg, cfg = _cfgs(kind)
    jp = jrec.init_recsys(jax.random.PRNGKey(0), jcfg)
    p = recsys.recsys_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
    return kind, jcfg, cfg, jp, p


@pytest.fixture(scope="module", params=KINDS + ("sasrec",))
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module", params=KINDS)
def tower(request):
    """The three towers (SASRec's retrieval is test_torch_recsys.py's)."""
    return _model(request.param)


@pytest.fixture(scope="module")
def pq_model(tower):
    _, _, _, jp, _ = tower
    cand = np.asarray(jnp.take(jp["tables"][0], jnp.arange(C), axis=0)
                      @ jp["item_proj"])
    cb = jpq.train_codebooks(jax.random.PRNGKey(1), cand, m=4, iters=6)
    return np.asarray(cb.centroids), np.asarray(jpq.encode(cb, cand))


def _inputs(cfg, seed, b=B):
    """numpy batch: dense, sparse, label (the CTR kinds) or seq, target,
    pos/neg items and mask (SASRec); cand_ids for retrieval."""
    rng = np.random.default_rng(seed)
    out = {"cand_ids": np.arange(C, dtype=np.int32)}
    if cfg.kind == "sasrec":
        S = cfg.seq_len
        out.update(seq=rng.integers(0, C, (b, S)),
                   target=rng.integers(0, C, (b,)),
                   pos_items=rng.integers(0, C, (b, S)),
                   neg_items=rng.integers(0, C, (b, S)),
                   seq_mask=(rng.random((b, S)) < 0.8).astype(np.float32))
    else:
        out.update(
            dense=rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
            sparse=np.stack([rng.integers(0, v, (b, cfg.multi_hot))
                             for v in cfg.vocab_sizes], axis=1),
            label=rng.integers(0, 2, (b,)))
    return {k: v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in out.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_configs_are_copies_of_the_three_towers_and_rec_shapes():
    for kind in KINDS:
        jcfg, cfg, _ = NARROW[kind]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert configs.CRITEO_TB_VOCABS == jdlrm.CRITEO_TB_VOCABS
    assert configs.WD_VOCABS == jwd.WD_VOCABS
    assert [dataclasses.asdict(s) for s in configs.REC_SHAPES] == \
        [dataclasses.asdict(s) for s in REC_SHAPES]
    assert (configs.SERVE_P99.batch, configs.SERVE_BULK.batch,
            configs.TRAIN_BATCH.batch) == (512, 262_144, 65_536)


def test_published_table_sizes():
    """The padded row counts the docstrings state: 48.08 GB of DLRM-rm2
    tables (D=64), 12.02 GB of DCN-v2's (D=16), 11.38 + 0.36 GB of
    Wide&Deep's (D=32 deep tables, 1-wide wide ones)."""
    crit = sum(recsys.padded_vocab(v) for v in configs.CRITEO_TB_VOCABS)
    wd = sum(recsys.padded_vocab(v) for v in configs.WD_VOCABS)
    assert crit == 187_801_600 and wd == 88_915_968
    assert sum(configs.CRITEO_TB_VOCABS) == 187_767_399
    assert round(crit * 64 * 4 / 1e9, 2) == 48.08
    assert round(crit * 16 * 4 / 1e9, 2) == 12.02
    assert round(wd * 33 * 4 / 1e9, 2) == 11.74


@pytest.mark.parametrize("arch", ["dlrm-rm2", "sasrec", "dcn-v2",
                                  "wide-deep", "aisaq-sift1m",
                                  "aisaq-sift1b", "aisaq-kilt-e5"])
def test_get_arch_equals_the_reference_registry(arch):
    assert dataclasses.asdict(configs.get_arch(arch)) == \
        dataclasses.asdict(jregistry.get_arch(arch))


def test_registry_lists_and_refusals():
    assert configs.list_archs() == jregistry.list_archs()
    assert configs.list_archs(False) == jregistry.list_archs(False)
    assert configs.ASSIGNED_ARCHS == jregistry.ASSIGNED_ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        jregistry.get_arch("no-such-arch")
    # the GNN and LM ids are ported: each equals the reference's
    for arch in ("graphsage-reddit", "qwen3-1.7b", "llama4-scout-17b-a16e"):
        assert configs.get_arch(arch).family == jregistry.get_arch(
            arch).family
        assert dataclasses.asdict(configs.get_arch(arch)) == \
            dataclasses.asdict(jregistry.get_arch(arch))
    assert configs.get_arch("sasrec").shape("serve_p99").batch == 512


def _np(t):
    return t.detach().cpu().numpy()


def test_params_from_jax_carry_every_array(model):
    kind, _, _, jp, p = model
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_p = list(p.parameters())
    assert len(flat_p) == len(flat_j)
    np.testing.assert_array_equal(_np(p.tables[0]), np.asarray(jp["tables"][0]))
    np.testing.assert_array_equal(_np(p.item_proj), np.asarray(jp["item_proj"]))
    names = {"dlrm": ("bot", "top"), "dcnv2": ("cross", "mlp"),
             "widedeep": ("mlp",), "sasrec": ()}[kind]
    pairs = [(name, getattr(p, name)) for name in names]
    for name, layers in pairs:
        assert len(layers) == len(jp[name])
        for l, jl in zip(layers, jp[name]):
            np.testing.assert_array_equal(_np(l["w"]), np.asarray(jl["w"]))
            np.testing.assert_array_equal(_np(l["b"]), np.asarray(jl["b"]))
    if kind == "widedeep":
        for w, jw in zip(p.wide, jp["wide"]):
            np.testing.assert_array_equal(_np(w), np.asarray(jw))


@pytest.mark.parametrize("kind", KINDS)
def test_init_recsys_matches_jax_shapes_and_scales(kind):
    """Same parameter shapes, in the same order, as the JAX init; every
    truncated normal within 2 scales; the tables' and the projection's
    spread within 10% of the reference's; zero biases; a seed gives the
    same parameters again."""
    jcfg, cfg = _cfgs(kind)
    jp = jrec.init_recsys(jax.random.PRNGKey(0), jcfg)
    p = recsys.init_recsys(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert type(p).__name__ == {"dlrm": "DLRM", "dcnv2": "DCNv2",
                                "widedeep": "WideDeep"}[kind]
    mine = {".".join(map(str, path)): t for path, t in _named(p)}
    theirs = {jax.tree_util.keystr(path): np.asarray(a)
              for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert sorted(t.shape for t in mine.values()) == \
        sorted(tuple(a.shape) for a in theirs.values())
    for t in p.tables:
        assert _np(t).shape[0] % recsys.VOCAB_PAD == 0
        assert np.abs(_np(t)).max() <= 2 * 0.05 * (1 + 1e-6)
    for name, t in mine.items():
        if name.endswith(".b"):
            assert not _np(t).any(), name
    a, b = _np(p.tables[0]), np.asarray(jp["tables"][0])
    assert abs(a.std() - b.std()) <= 0.1 * b.std()
    # every dense weight over its scale fan_in ** -0.5, pooled (one small
    # matrix alone is too few draws to judge a spread)
    def pooled(ws):
        return np.concatenate([w.ravel() * np.sqrt(w.shape[0]) for w in ws])
    a = pooled([_np(t) for n, t in mine.items()
                if n.endswith(".w") or n in ("item_proj",)])
    b = pooled([a_ for n, a_ in theirs.items()
                if n.endswith("['w']") or n == "['item_proj']"])
    assert a.size == b.size and np.abs(a).max() <= 2 * (1 + 1e-6)
    assert abs(a.std() - b.std()) <= 0.1 * b.std()
    if kind == "widedeep":
        for w in p.wide:
            assert w.shape[1] == 1 and np.abs(_np(w)).max() <= 0.02 * 1.000001
    again = recsys.init_recsys(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                 again.parameters()))


def _named(p):
    for name, t in p.named_parameters():
        yield name.split("."), t


def test_unknown_kind_raises():
    cfg = configs.RecsysConfig(name="x", kind="fm", embed_dim=4,
                               vocab_sizes=(10,))
    with pytest.raises(ValueError, match="fm"):
        recsys.init_recsys(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="no recommender kind"):
        recsys.recsys_params_from_jax({"tables": [], "item_proj": np.eye(2)},
                                      device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_rec_forward_and_loss_match_jax(model, seed):
    kind, jcfg, cfg, jp, p = model
    batch = _inputs(cfg, seed)
    logits = recsys.rec_forward(p, batch, cfg)
    want = np.asarray(jrec.rec_forward(jp, _j(batch), jcfg))
    assert logits.shape == (B,) and np.isfinite(_np(logits)).all()
    np.testing.assert_allclose(_np(logits), want, **TOL)
    loss, aux = recsys.rec_loss(p, batch, cfg)
    jloss, jaux = jrec.rec_loss(jp, _j(batch), jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert set(aux) == set(jaux)
    for name in aux:
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]), **TOL)


def test_dlrm_interaction_pairs_are_row_major():
    """torch.triu_indices(f, f, 1) lists the pairs in jnp.triu_indices(f,
    k=1)'s order, which the top MLP's weights assume."""
    for f in (2, 6, 27):
        iu, ju = torch.triu_indices(f, f, 1)
        jiu, jju = jnp.triu_indices(f, k=1)
        np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
        np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))


def test_user_tower_and_exact_retrieval_match_jax(tower):
    kind, jcfg, cfg, jp, p = tower
    batch = _inputs(cfg, 2)
    u = recsys.user_tower(p, batch, cfg)
    assert u.shape == (B, D)
    np.testing.assert_allclose(
        _np(u), np.asarray(jrec.user_tower(jp, _j(batch), jcfg)), **TOL)
    np.testing.assert_allclose(
        _np(recsys.retrieval_scores(p, batch, cfg)),
        np.asarray(jrec.retrieval_scores(jp, _j(batch), jcfg)), **TOL)
    ids, vals = recsys.retrieval_topk(p, batch, cfg, k=100)
    jids, jvals = jrec.retrieval_topk(jp, _j(batch), jcfg, k=100)
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    np.testing.assert_allclose(_np(vals), np.asarray(jvals), **TOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_retrieval_topk_pq_matches_jax(tower, pq_model, seed):
    kind, jcfg, cfg, jp, p = tower
    cents, codes = pq_model
    batch = _inputs(cfg, seed, b=1)
    jids, jvals = jrec.retrieval_topk_pq(jp, _j(batch), jcfg,
                                         jnp.asarray(codes),
                                         jnp.asarray(cents), k=100)
    for backend in ("auto", "ref"):
        ids, vals = recsys.retrieval_topk_pq(
            p, batch, cfg, torch.from_numpy(codes.copy()),
            torch.from_numpy(cents.copy()), k=100, rerank_mult=4,
            backend=backend)
        assert ids.shape == (1, 100) and vals.shape == (1, 100)
        np.testing.assert_array_equal(_np(ids), np.asarray(jids))
        np.testing.assert_allclose(_np(vals), np.asarray(jvals), **TOL)


def test_make_retrieval_fn_on_the_cpu_matches_jax(tower, pq_model):
    """On the CPU the request runs eagerly with the tower's own inputs:
    the same answer as retrieval_topk_pq and the reference."""
    kind, jcfg, cfg, jp, p = tower
    cents, codes = pq_model
    assert recsys.TOWER_INPUTS[kind] == (("dense", "sparse") if kind == "dlrm"
                                         else ("sparse",))
    fn = recsys.make_retrieval_fn(p, cfg, torch.from_numpy(codes.copy()),
                                  torch.from_numpy(cents.copy()), k=100,
                                  rerank_mult=4)
    for seed in (5, 6):
        batch = _inputs(cfg, seed, b=1)
        request = {k: batch[k] for k in recsys.TOWER_INPUTS[kind]}
        ids, vals = fn(request)
        want = recsys.retrieval_topk_pq(
            p, batch, cfg, torch.from_numpy(codes.copy()),
            torch.from_numpy(cents.copy()), k=100, rerank_mult=4)
        assert torch.equal(ids, want[0]) and torch.equal(vals, want[1])
        jids, _ = jrec.retrieval_topk_pq(jp, _j(batch), jcfg,
                                         jnp.asarray(codes),
                                         jnp.asarray(cents), k=100)
        np.testing.assert_array_equal(_np(ids), np.asarray(jids))


@pytest.mark.parametrize("kind", KINDS)
def test_init_recsys_needs_a_card_or_device_cpu(kind):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    _, cfg = _cfgs(kind)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys.init_recsys(cfg, generator=torch.Generator())
    _, _, _, jp, _ = _model(kind)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys.recsys_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp))
