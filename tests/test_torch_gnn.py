"""The port's GNN family (`repro_torch.models.gnn`, `kernels.segment`,
`data.pipeline.make_graph`) against the JAX package on the CPU, where the
segment sum runs its plain version (`ref.segment_sum_ref`).

Parameters come from the reference's `init_gnn` (`gnn_params_from_jax`);
graphs, features and sampled ids from numpy seeds. Tolerances:
  * `make_graph`, `pad_edges`, `partition_edges`, the sampler's CSR and
    ids: bit-equal;
  * aggregation (sum, mean, max) and every forward, loss and gradient:
    rtol = atol = 1e-5 (float32 sums and products in other orders); max
    equal where the values are not finite (-inf for an empty segment, NaN).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JGNNConfig
from repro.data import pipeline as jpipe
from repro.models import gnn as JG
from repro.models import gnn_sharded as JGS
from repro_torch.configs import GNNConfig
from repro_torch.data import pipeline
from repro_torch.kernels import ref, segment
from repro_torch.models import gnn as G
from repro_torch.models import gnn_sharded as GS
from repro_torch.optim.adamw import param_tree

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    base = dict(name="t", n_layers=2, d_hidden=32, n_classes=7)
    base.update(kw)
    return JGNNConfig(**base), GNNConfig(**base)


def _params(jcfg, d_feat, seed=0):
    jp = JG.init_gnn(jax.random.PRNGKey(seed), jcfg, d_feat)
    return jp, G.gnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: np.asarray(tree)}


def _close(got, want, what=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), err_msg=what, **TOL)


def _grads_close(p, loss, jgrads):
    tree = param_tree(p)
    gs = torch.autograd.grad(loss, list(tree.values()))
    want = _leaves(jgrads)
    assert sorted(want) == sorted(tree)
    for (name, _), g in zip(tree.items(), gs):
        _close(g, want[name], name)


# ---------------------------------------------------------------------------
# data: make_graph, pad_edges, partition_edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(256, 8, 8, 8), (2708, 4, 41, 41),
                                  (20000, 25, 41, 41)])
def test_make_graph_is_bit_equal_to_the_reference(args):
    mine = pipeline.make_graph(*args, seed=1)
    theirs = jpipe.make_graph(*args, seed=1)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    assert mine["edges"].dtype == np.int32


@pytest.mark.parametrize("n,n_classes", [(300, 5), (5000, 41)])
def test_vectorised_rewiring_draws_what_the_loop_draws(n, n_classes):
    """One `integers(0, counts[lab])` call draws the reference's per-edge
    `integers(0, len(pool))` numbers, and leaves the generator where the
    loop leaves it (the next draws equal)."""
    rng = np.random.default_rng(7)
    labels = rng.integers(0, n_classes, n)
    lab = labels[rng.integers(0, n, 4 * n)]
    pools = {c: np.flatnonzero(labels == c) for c in range(n_classes)}
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    loop = np.array([pools[c][a.integers(0, len(pools[c]))] for c in lab])
    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=n_classes)
    starts = np.cumsum(counts) - counts
    vec = order[starts[lab] + b.integers(0, counts[lab])]
    np.testing.assert_array_equal(vec, loop)
    np.testing.assert_array_equal(a.normal(size=5), b.normal(size=5))


@pytest.mark.parametrize("e,multiple", [(37, 8), (40, 8), (5, 512)])
def test_pad_edges_equals_the_reference(e, multiple):
    edges = np.random.default_rng(e).integers(0, 30, (e, 2)).astype(np.int32)
    got, want = G.pad_edges(edges, multiple, 30), \
        JG.pad_edges(edges, multiple, 30)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ways", [1, 2, 4, 3])
def test_partition_edges_equals_the_reference(ways):
    g = jpipe.make_graph(200, 6, 4, 7, seed=0)
    got, n_local = GS.partition_edges(g["edges"], 200, ways)
    want, j_local = JGS.partition_edges(g["edges"], 200, ways)
    assert n_local == j_local and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the segment sum and the aggregators
# ---------------------------------------------------------------------------


def _messy_edges(n, e, seed):
    """Random edges, a tenth repeated, self-loops, no edge into the last
    fifth of the nodes, and (n, n) dummies."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, int(n * 0.8), e)
    dup = rng.integers(0, e, e // 10)
    loops = rng.integers(0, int(n * 0.8), 5)
    edges = np.stack([np.concatenate([src, src[dup], loops]),
                      np.concatenate([dst, dst[dup], loops])], 1)
    return G.pad_edges(edges.astype(np.int32), 64, n)


@pytest.mark.parametrize("kind", ["sum", "mean", "max"])
@pytest.mark.parametrize("F", [1, 7, 33])
def test_aggregate_matches_jax_ops(kind, F):
    n = 60
    edges = _messy_edges(n, 300, F)
    x = np.random.default_rng(F).normal(size=(n, F)).astype(np.float32)
    x[3, 0] = np.nan                      # propagates through every kind
    want = JG._aggregate(jnp.asarray(x)[jnp.asarray(edges[:, 0])],
                         jnp.asarray(edges[:, 1]), n, kind)
    csr = segment.prepare_csr(torch.from_numpy(edges), n)
    got = G._aggregate(torch.from_numpy(x), csr, kind).numpy()
    want = np.asarray(want)
    if kind == "max":
        assert np.isneginf(want).any()    # the empty segments
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


def test_segment_sum_gradient_and_out_of_range_ids_match_jax():
    """Sources past the end or negative: the forward reads the clamped
    (wrapped) row as JAX's gather does, the backward drops them as the
    gather's transpose does; destinations out of range are dropped."""
    n = 40
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(-n - 5, n + 5, 400),
                      rng.integers(-3, n + 3, 400)], 1).astype(np.int32)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    w = rng.normal(size=(n, 5)).astype(np.float32)

    def jf(x):
        return jax.ops.segment_sum(x[jnp.asarray(edges[:, 0])],
                                   jnp.asarray(edges[:, 1]), num_segments=n)
    xt = torch.from_numpy(x).requires_grad_()
    out = segment.segment_sum(xt, segment.prepare_csr(edges, n,
                                                      device="cpu"))
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, jf(jnp.asarray(x)))
    _close(xt.grad, jax.grad(lambda x: (jf(x) * w).sum())(jnp.asarray(x)))


def test_degrees_count_every_edge_with_a_valid_destination():
    edges = _messy_edges(50, 200, 1)
    csr = segment.prepare_csr(torch.from_numpy(edges), 50)
    want = jax.ops.segment_sum(jnp.ones(edges.shape[0]),
                               jnp.asarray(edges[:, 1]), num_segments=50)
    np.testing.assert_array_equal(csr.deg.numpy(), np.asarray(want))
    assert csr.n_edges == int(np.asarray(want).sum())


def _plan_sum(x, csr):
    """The kernel's two passes in numpy from the CSR's hub plan: rows of at
    most CHUNK edges summed in order, each hub chunk into its partial,
    then each hub's partials in chunk order."""
    ip, col = csr.indptr.numpy(), csr.col.numpy()
    out = np.zeros((csr.n_rows, x.shape[1]), np.float64)
    for r in range(csr.n_rows):
        if ip[r + 1] - ip[r] <= segment.CHUNK:
            out[r] = x[col[ip[r]:ip[r + 1]]].sum(0)
    part = np.zeros((csr.n_chunks, x.shape[1]))
    for k, (row, beg) in enumerate(zip(csr.chunk_row.numpy(),
                                       csr.chunk_beg.numpy())):
        end = min(beg + segment.CHUNK, ip[row + 1])
        part[k] = x[col[beg:end]].sum(0)
    first = csr.hub_first.numpy()
    for h, row in enumerate(csr.hub_rows.numpy()):
        out[row] = part[first[h]:first[h + 1]].sum(0)
    return out


def test_hub_plan_covers_each_hub_row_in_chunk_order(monkeypatch):
    """With CHUNK = 8, a zipf graph has hub rows both ways; the plan's two
    passes give the plain sums, and every hub edge lies in exactly one
    chunk of its row, chunks in edge order."""
    monkeypatch.setattr(segment, "CHUNK", 8)
    g = pipeline.make_graph(300, 6, 3, 4, seed=2)
    csr = segment.prepare_csr(torch.from_numpy(g["edges"]), 300)
    x = g["feats"].astype(np.float64)
    for d in (csr.by_dst, csr.by_src):
        assert d.hub_rows.numel() > 0
        ip = d.indptr.numpy()
        for h, row in enumerate(d.hub_rows.numpy()):
            ks = range(int(d.hub_first[h]), int(d.hub_first[h + 1]))
            begs = [int(d.chunk_beg[k]) for k in ks]
            assert all(int(d.chunk_row[k]) == row for k in ks)
            assert begs == list(range(ip[row], ip[row + 1], 8))
        want = ref.segment_sum_ref(torch.from_numpy(x), d.col, d.rows(),
                                   d.n_rows).numpy()
        np.testing.assert_allclose(_plan_sum(x, d), want, rtol=1e-12)


def test_csr_sum_checks_its_input():
    csr = segment.prepare_csr(np.array([[0, 1]], np.int32), 3,
                              device="cpu")
    with pytest.raises(ValueError, match="source rows"):
        segment.csr_sum(torch.zeros(4, 2), csr.by_dst)
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        segment.csr_sum(torch.zeros(3, 2, device="meta"), csr.by_dst)


# ---------------------------------------------------------------------------
# the three regimes against the reference
# ---------------------------------------------------------------------------


def test_init_gnn_shapes_scales_and_paths():
    jcfg, cfg = _cfgs(d_hidden=64)
    jp = JG.init_gnn(jax.random.PRNGKey(0), jcfg, 300)
    p = G.init_gnn(cfg, 300, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    want = _leaves(jp)
    tree = param_tree(p)
    assert list(tree) == sorted(want, key=lambda k: (
        [(0, int(c)) if c.isdigit() else (1, c) for c in k.split("/")]))
    std = 0.8796                          # N(0, 1) truncated to [-2, 2]
    for name, t in tree.items():
        assert tuple(t.shape) == want[name].shape, name
        assert t.dtype == torch.float32
        if name.endswith("/b"):
            assert not t.any()
            continue
        scale = t.shape[0] ** -0.5
        assert float(t.abs().max()) <= 2 * scale + 1e-6, name
        assert abs(float(t.std()) / (scale * std) - 1) < 0.1, name


@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_full_forward_loss_and_gradients_match_jax(agg):
    jcfg, cfg = _cfgs(aggregator=agg)
    g = jpipe.make_graph(200, 6, 24, 7, seed=0)
    g["mask"] = (np.arange(200) % 3 != 0).astype(np.float32)
    g["edges"] = JG.pad_edges(g["edges"], 512, 200)
    jp, p = _params(jcfg, 24)
    jb = {k: jnp.asarray(v) for k, v in g.items()}
    b = {k: torch.from_numpy(v) for k, v in g.items()}
    b["csr"] = segment.prepare_csr(b["edges"], 200)
    _close(G.gnn_full_forward(p, b["feats"], b["edges"], cfg),
           JG.gnn_full_forward(jp, jb["feats"], jb["edges"], jcfg))
    (jl, jm), jg = jax.value_and_grad(
        lambda q: JG.gnn_full_loss(q, jb, jcfg), has_aux=True)(jp)
    loss, m = G.gnn_full_loss(p, b, cfg)
    _close(loss, jl)
    _close(m["acc"], jm["acc"])
    _grads_close(p, loss, jg)


def test_full_forward_max_matches_jax():
    jcfg, cfg = _cfgs(aggregator="max")
    g = jpipe.make_graph(150, 5, 16, 7, seed=4)
    jp, p = _params(jcfg, 16)
    want = JG.gnn_full_forward(jp, jnp.asarray(g["feats"]),
                               jnp.asarray(g["edges"]), jcfg)
    got = G.gnn_full_forward(p, torch.from_numpy(g["feats"]),
                             torch.from_numpy(g["edges"]), cfg)
    _close(got, want)


def test_neighbor_sampler_draws_the_reference_ids():
    g = jpipe.make_graph(500, 6, 12, 7, seed=3)
    edges = g["edges"].copy()
    edges[edges[:, 1] == 9, 1] = 10        # node 9 isolated: a self-loop
    mine = G.NeighborSampler.from_edges(edges, 500, seed=5)
    theirs = JG.NeighborSampler.from_edges(edges, 500, seed=5)
    np.testing.assert_array_equal(mine.indptr, theirs.indptr)
    np.testing.assert_array_equal(mine.indices, theirs.indices)
    assert mine.indptr.dtype == theirs.indptr.dtype
    seeds = np.array([9, 0, 499, 17, 9, 250])
    for fanout in (5, 3):
        a, b = mine.sample(seeds, fanout), theirs.sample(seeds, fanout)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (mine.sample(np.array([9]), 4) == 9).all()
    got = mine.sample_blocks(seeds, (4, 3), g["feats"], device="cpu")
    want = theirs.sample_blocks(seeds, (4, 3), g["feats"])
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    on_tensor = G.NeighborSampler.from_edges(edges, 500, seed=5)
    on_tensor.sample(seeds, 5)
    on_tensor.sample(seeds, 3)
    got = on_tensor.sample_blocks(seeds, (4, 3),
                                  torch.from_numpy(g["feats"]))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_minibatch_forward_loss_and_gradients_match_jax():
    jcfg, cfg = _cfgs()
    g = jpipe.make_graph(400, 8, 20, 7, seed=1)
    seeds = np.arange(0, 400, 13)
    blocks = JG.NeighborSampler.from_edges(g["edges"], 400, seed=2) \
        .sample_blocks(seeds, (6, 4), g["feats"])
    blocks = {k: np.asarray(v) for k, v in blocks.items()}
    blocks["labels"] = g["labels"][seeds]
    jp, p = _params(jcfg, 20)
    jb = {k: jnp.asarray(v) for k, v in blocks.items()}
    b = {k: torch.from_numpy(v) for k, v in blocks.items()}
    _close(G.gnn_minibatch_forward(p, b, cfg),
           JG.gnn_minibatch_forward(jp, jb, jcfg))
    (jl, jm), jg = jax.value_and_grad(
        lambda q: JG.gnn_minibatch_loss(q, jb, jcfg), has_aux=True)(jp)
    loss, m = G.gnn_minibatch_loss(p, b, cfg)
    _close(loss, jl)
    _close(m["acc"], jm["acc"])
    _grads_close(p, loss, jg)


@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_batched_forward_loss_and_gradients_match_jax(agg):
    """12 graphs of 15 nodes as one block-diagonal graph, with ids out of
    range in some graphs (each graph's own clamp and drop)."""
    jcfg, cfg = _cfgs(aggregator=agg)
    rng = np.random.default_rng(6)
    Gr, n = 12, 15
    batch = {"feats": rng.normal(size=(Gr, n, 10)).astype(np.float32),
             "edges": rng.integers(-2, n + 2, (Gr, 40, 2)).astype(np.int32),
             "labels": rng.integers(0, 7, Gr).astype(np.int32)}
    jp, p = _params(jcfg, 10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    _close(G.gnn_batched_forward(p, b["feats"], b["edges"], cfg),
           JG.gnn_batched_forward(jp, jb["feats"], jb["edges"], jcfg))
    (jl, jm), jg = jax.value_and_grad(
        lambda q: JG.gnn_batched_loss(q, jb, jcfg), has_aux=True)(jp)
    b["csr"] = G.batched_csr(b["edges"], n)
    loss, m = G.gnn_batched_loss(p, b, cfg)
    _close(loss, jl)
    _close(m["acc"], jm["acc"])
    _grads_close(p, loss, jg)
