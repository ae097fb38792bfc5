"""The port's recommender training path (`repro_torch.data.pipeline`,
`optim.adamw`, `models.recsys.rec_loss`'s gradient and
`distributed.train_step`) against the JAX package at the reference's tiny
scale: every width kept, tables cut to 2,000 rows, batch 64. Parameters
and optimizer state come from the reference's init through
`train_state_from_jax`.

Tolerances:
  * data streams, `host_slice`: bit-equal;
  * gradients: per leaf, |port - reference| <= 1e-5 * max|reference| (the
    port's sparse table gradients densified);
  * one train step: the loss and the global norm within rtol 1e-5; per
    leaf, parameters within 1e-4 absolute (3% of one step at lr 3e-3:
    Adam's first step is g / (|g| + eps), so a gradient near 0 moves its
    element by a sizeable share of lr on a last-bit difference), `m`
    within 1e-4 * max|m|, `v` within 1e-4 * max|v|, the step equal;
  * `warmup_cosine`: rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import pipeline as jpipe
from repro.distributed import train_step as jts
from repro.models import recsys as jrec
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.distributed import train_step as ts
from repro_torch.models import recsys
from repro_torch.optim import adamw

ARCHS = ("sasrec", "dlrm-rm2", "dcn-v2", "wide-deep")
B = 64
LR = 3e-3


def _tiny(arch):
    return dataclasses.replace(arch, model=arch.model.scaled(
        vocab_sizes=tuple(min(v, 2000) for v in arch.model.vocab_sizes)))


def _archs(aid):
    return _tiny(jget_arch(aid)), _tiny(configs.get_arch(aid))


def _stream(cfg, seed=0):
    return (jpipe.SasrecStream(cfg, B, seed) if cfg.kind == "sasrec"
            else jpipe.ClickStream(cfg, B, seed))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _dense(g):
    return g.to_dense() if g.is_sparse else g


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _equal_batches(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("aid", ARCHS)
def test_rec_streams_equal_the_reference(aid):
    jarch, arch = _archs(aid)
    for seed in (0, 5):
        mine = (pipeline.SasrecStream(arch.model, B, seed)
                if aid == "sasrec" else
                pipeline.ClickStream(arch.model, B, seed))
        theirs = _stream(jarch.model, seed)
        for step in (0, 1, 7, 1000):
            _equal_batches(mine.batch_at(step), theirs.batch_at(step))


def test_full_width_click_stream_equals_the_reference():
    """The published cardinalities (ids up to 39.98M), a few rows."""
    mine = pipeline.ClickStream(configs.DLRM_RM2, 8)
    theirs = jpipe.ClickStream(jget_arch("dlrm-rm2").model, 8)
    for step in (0, 3):
        _equal_batches(mine.batch_at(step), theirs.batch_at(step))


def test_token_stream_and_graph_equal_the_reference():
    for step in (0, 2, 9):
        _equal_batches(
            pipeline.TokenStream(2048, 16, 4, seed=1).batch_at(step),
            jpipe.TokenStream(2048, 16, 4, seed=1).batch_at(step))
    _equal_batches(pipeline.make_graph(200, 4, 8, 5, seed=3),
                   jpipe.make_graph(200, 4, 8, 5, seed=3))


def test_host_slice():
    b = _stream(_archs("dcn-v2")[1].model).batch_at(0)
    _equal_batches(pipeline.host_slice(b), b)    # no process group: (0, 1)
    for pi in range(4):
        _equal_batches(pipeline.host_slice(b, pi, 4),
                       jpipe.host_slice(b, pi, 4))


def test_prefetcher_moves_batches_to_the_device():
    ds = _stream(_archs("sasrec")[1].model)
    pf = pipeline.Prefetcher(ds.batch_at, depth=2, device="cpu")
    try:
        for step in range(3):
            got = next(pf)
            want = ds.batch_at(step)
            for k in want:
                assert isinstance(got[k], torch.Tensor)
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    finally:
        pf.stop()
    assert not pf._t.is_alive()


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def tiny_model(request):
    jarch, arch = _archs(request.param)
    jp = jrec.init_recsys(jax.random.PRNGKey(0), jarch.model)
    return request.param, jarch, arch, jp


def test_param_tree_is_the_reference_flatten_order(tiny_model):
    aid, jarch, arch, jp = tiny_model
    p = recsys.recsys_params_from_jax(_np_tree(jp), device="cpu")
    names = list(adamw.param_tree(p))
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert names == want
    assert [tuple(t.shape) for t in adamw.param_tree(p).values()] == \
        [x.shape for x in jax.tree_util.tree_leaves(jp)]


@pytest.mark.parametrize("step", [0, 4])
def test_rec_loss_gradients_match_jax(tiny_model, step):
    aid, jarch, arch, jp = tiny_model
    p = recsys.recsys_params_from_jax(_np_tree(jp), device="cpu")
    b = _stream(jarch.model).batch_at(step)
    (jloss, jaux), jg = jax.value_and_grad(jrec.rec_loss, has_aux=True)(
        jp, _jbatch(b), jarch.model)
    tree = adamw.param_tree(p)
    loss, aux = recsys.rec_loss(p, b, arch.model)
    grads = torch.autograd.grad(loss, list(tree.values()), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(aux) == set(jaux)
    want = ts._leaves(_np_tree(jg))
    for (name, t), g in zip(tree.items(), grads):
        ref = want[name]
        got = (np.zeros(ref.shape, np.float32) if g is None
               else _dense(g).numpy())
        if name.split("/")[0] in ("tables", "wide"):
            assert g.is_sparse, name
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


def test_sasrec_item_table_gradient_sums_its_three_reads():
    """The sequence, pos_items and neg_items all read table 0: their
    gradients meet in the one sparse gradient, whose rows are the ids read
    (the JAX comparison above checks the values)."""
    jarch, arch = _archs("sasrec")
    p = recsys.init_recsys(arch.model, generator=torch.Generator()
                           .manual_seed(0), device="cpu")
    b = _stream(jarch.model).batch_at(1)
    loss, _ = recsys.rec_loss(p, b, arch.model)
    (g,) = torch.autograd.grad(loss, [p.tables[0]])
    assert g.is_sparse
    c = g.coalesce()
    ids = np.unique(np.concatenate([b[k].ravel() for k in
                                    ("seq", "pos_items", "neg_items")]))
    np.testing.assert_array_equal(c.indices()[0].numpy(), ids)
    assert (c.values().abs().sum(1) > 0).all()


def test_lookup_without_autograd_is_the_same_gather():
    """The serving paths (no autograd) take the plain gather; training
    takes `F.embedding`: the same values, and a sparse gradient."""
    table = torch.nn.Parameter(torch.randn(30, 5))
    idx = torch.tensor([[3, 7], [3, 29]], dtype=torch.int32)
    with torch.no_grad():
        plain = recsys.lookup(table, idx)
    rows = recsys.lookup(table, idx)
    assert rows.requires_grad and not plain.requires_grad
    assert torch.equal(plain, rows.detach())
    assert torch.equal(plain, table.detach()[idx.long()])
    (g,) = torch.autograd.grad(rows.sum(), [table])
    assert g.is_sparse
    want = torch.zeros(30, 5)
    want[3], want[7], want[29] = 2.0, 1.0, 1.0
    assert torch.equal(g.to_dense(), want)


def test_a_dense_table_gradient_is_refused(tiny_model):
    aid, jarch, arch, jp = tiny_model
    p = recsys.recsys_params_from_jax(_np_tree(jp), device="cpu")

    def dense_loss(p, b):          # plain indexing: a dense (V, D) gradient
        return p.tables[0][torch.zeros(3, dtype=torch.long)].sum(), {}
    with pytest.raises(RuntimeError, match="dense gradient"):
        ts._grads(dense_loss, p, {})


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_warmup_cosine_matches_the_reference():
    for warmup, total in ((1, 10), (7, 100), (2000, 10000)):
        jfn = jadamw.warmup_cosine(LR, warmup, total)
        fn = adamw.warmup_cosine(LR, warmup, total)
        for step in (0, warmup, warmup + 1, total):
            got = fn(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                float(got), float(jfn(jnp.asarray(step, jnp.int32))),
                rtol=1e-6)


def test_wide_tables_are_adamw_leaves_in_both_packages():
    """The reference's rule matches "/wide/", which no path has (they
    start with "wide/"): Wide&Deep's wide terms train under AdamW."""
    jarch, arch = _archs("wide-deep")
    jp = jrec.init_recsys(jax.random.PRNGKey(0), jarch.model)
    jinit, _ = jts.default_optimizer()
    jst = _np_tree(jinit(jp))
    st = ts.train_state_from_jax(jts.TrainState(_np_tree(jp), jst),
                                 device="cpu")
    init, _ = ts.default_optimizer()
    mine = init(st.params)
    jv = ts._leaves(jst.v)
    for name, v in mine.v.items():
        assert tuple(v.shape) == jv[name].shape, name
        assert adamw.is_embedding(name) == jadamw._is_embedding(name)
    wide = [n for n in mine.v if n.startswith("wide/")]
    assert len(wide) == arch.model.n_sparse
    for n in wide:
        assert mine.v[n].shape == (2048, 1) == mine.m[n].shape
    assert mine.v["tables/0"].shape == (2048,)
    assert mine.m["tables/0"].shape == (1,)
    assert all(x.shape == (0,) for x in mine.master.values())


def test_global_norm_of_sparse_gradients_sums_duplicates_first():
    g = torch.sparse_coo_tensor(torch.tensor([[3, 1, 3]]),
                                torch.tensor([[1.0, 2.0], [0.5, 0.0],
                                              [2.0, -1.0]]), (5, 2),
                                check_invariants=True)
    dense = g.to_dense()
    assert float(adamw.global_norm({"a": g})) == pytest.approx(
        float(torch.sqrt((dense ** 2).sum())), rel=1e-7)
    np.testing.assert_allclose(
        float(adamw.global_norm({"a": g, "b": None, "c": torch.ones(3)})),
        float(jadamw.global_norm({"a": jnp.asarray(dense.numpy()),
                                  "c": jnp.ones(3)})), rtol=1e-7)


def test_sparse_row_update_equals_the_dense_one():
    """Row-wise Adagrad on the touched rows only gives the dense update's
    numbers: untouched rows and their accumulators keep their bits."""
    torch.manual_seed(0)
    table = torch.randn(50, 4)
    ids = torch.tensor([7, 3, 7, 40, 3, 3])
    vals = torch.randn(6, 4)
    sparse = torch.sparse_coo_tensor(ids[None], vals, (50, 4),
                                     check_invariants=True)
    init, update = adamw.make_optimizer(adamw.warmup_cosine(0.1, 1, 10),
                                        clip_norm=0.5)
    out = []
    for g in (sparse, sparse.to_dense()):
        p = {"tables/0": table.clone(), "w": torch.ones(3)}
        st = init(p)
        st.v["tables/0"].uniform_(0, 1, generator=torch.Generator()
                                  .manual_seed(1))
        p, st, stats = update({"tables/0": g, "w": None}, st, p)
        out.append((p["tables/0"], st.v["tables/0"], p["w"],
                    stats["grad_norm"]))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    untouched = torch.ones(50, dtype=torch.bool)
    untouched[ids] = False
    assert torch.equal(out[0][0][untouched], table[untouched])


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------


STEP_CASES = [(aid, mb, clip, repeat) for aid in ARCHS
              for mb, clip, repeat in ((1, 1.0, False), (2, 1.0, False),
                                       (1, 1e-3, False), (1, 1.0, True))]


def _repeated_ids(b):
    """Every row's ids from the first 4 rows: each id many times over."""
    b = dict(b)
    for k in ("sparse", "seq", "pos_items", "neg_items"):
        if k in b:
            b[k] = b[k][np.arange(len(b[k])) % 4]
    return b


@pytest.mark.parametrize("aid,mb,clip,repeat", STEP_CASES,
                         ids=[f"{a}-mb{m}-clip{c}{'-repeat' if r else ''}"
                              for a, m, c, r in STEP_CASES])
def test_train_step_matches_the_reference(aid, mb, clip, repeat):
    jarch, arch = _archs(aid)
    jshape, shape = jarch.shape("train_batch"), arch.shape("train_batch")
    jopt = jadamw.make_optimizer(jadamw.warmup_cosine(LR, 1, 10),
                                 clip_norm=clip)
    opt = adamw.make_optimizer(adamw.warmup_cosine(LR, 1, 10),
                               clip_norm=clip)
    jp = jrec.init_recsys(jax.random.PRNGKey(0), jarch.model)
    jstate = jts.TrainState(jp, jopt[0](jp))
    state = ts.train_state_from_jax(_np_tree(jstate), device="cpu")
    b = _stream(jarch.model).batch_at(2)
    if repeat:
        b = _repeated_ids(b)
    jstep = jax.jit(jts.make_train_step(jarch, jshape, optimizer=jopt,
                                        microbatches=mb))
    step = ts.make_train_step(arch, shape, optimizer=opt, microbatches=mb)
    jstate, jm = jstep(jstate, _jbatch(b))
    state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    if clip < 1:
        assert float(jm["grad_norm"]) > 100 * clip      # the clip binds
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert set(jm) <= set(m)
    jn = _np_tree(jstate)
    assert int(state.opt.step) == int(jn.opt.step) == 1
    for part, theirs, mine in (
            ("params", jn.params, adamw.param_tree(state.params)),
            ("m", jn.opt.m, state.opt.m), ("v", jn.opt.v, state.opt.v),
            ("master", jn.opt.master, state.opt.master)):
        want = ts._leaves(theirs)
        assert list(want) == list(mine), part
        for name, t in mine.items():
            got, ref = t.detach().numpy(), want[name]
            assert got.shape == ref.shape and got.dtype == ref.dtype, name
            atol = 1e-4 if part == "params" else \
                1e-4 * (np.abs(ref).max() if ref.size else 0)
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                       err_msg=f"{part} {name}")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aid,shape", [("qwen3-1.7b", "train_4k"),
                                       ("graphsage-reddit", "full_graph_sm")])
def test_lm_and_gnn_archs_raise_not_implemented(aid, shape):
    """The LM and GNN families, once refused, are ported: each trains one
    tiny step, and its loss and train step factories take it (and the
    GNN's serve step factory its full-graph shape)."""
    from repro_torch.launch import train
    hist = train.train_loop(aid, shape, steps=1, device="cpu",
                            verbose=False)
    assert np.isfinite(hist["losses"][0])
    arch = configs.get_arch(aid)
    assert arch.family == jget_arch(aid).family
    fns = (ts.make_loss_fn, ts.make_train_step)
    if arch.family == "gnn":
        fns += (ts.make_serve_step,)
    for fn in fns:
        assert callable(fn(arch, arch.shape(shape)))


def test_serve_steps_are_the_serving_functions(tiny_model):
    aid, jarch, arch, jp = tiny_model
    p = recsys.recsys_params_from_jax(_np_tree(jp), device="cpu")
    b = _stream(jarch.model).batch_at(0)
    if aid == "sasrec":
        b = {"seq": b["seq"], "target": b["pos_items"][:, -1]}
    got = ts.make_serve_step(arch, arch.shape("serve_p99"))(p, b)
    assert torch.equal(got, recsys.rec_forward(p, b, arch.model))
    req = {k: v[:1] for k, v in b.items() if k != "target"}
    req["cand_ids"] = np.arange(2000)
    ids, _ = ts.make_serve_step(arch, arch.shape("retrieval_cand"))(p, req)
    assert torch.equal(ids, recsys.retrieval_topk(p, req, arch.model, k=100)
                       [0])
