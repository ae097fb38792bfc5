"""The port's process grids and sharding rules (`repro_torch.launch.mesh`,
`repro_torch.distributed.sharding`) against the JAX package's.

- Specs: `spec_tree` of every arch of the registry (five LMs, four
  recommenders with `tablewise` off and on, graphsage-reddit) and its
  `opt_state_specs`, `batch_specs` of every kind and `cache_spec`, equal
  to the reference's PartitionSpecs leaf for leaf on grids (2, 4),
  (16, 16) and (2, 16, 16). The rules read only the axis names, so the
  reference gets a stand-in mesh and the port a grid without a world.
- `shard` / `unshard`: on a world of 4 spawned gloo CPU ranks (every wait
  and join with a limit), `unshard(shard(t))` returns t bit for bit on
  every 4-rank grid (("data", "model") 2x2 and 1x4, ("data",),
  ("pod", "data", "model"), ("pp", "data") 4x1 and 2x2) for specs over
  one and two axes, tuples of axes and uneven splits; on the large grids
  the blocks of all 256 or 512 ranks reassemble t.

jax is imported inside the tests: the spawned ranks import this module
and need only torch.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from torch_world import World

GRIDS = (((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
         ((2, 16, 16), ("pod", "data", "model")))
LM_ARCHS = ("qwen3-1.7b", "h2o-danube-1.8b", "qwen2-1.5b", "qwen2-moe-a2.7b",
            "llama4-scout-17b-a16e")
REC_ARCHS = ("dlrm-rm2", "sasrec", "dcn-v2", "wide-deep")
KINDS = ("lm_train", "lm_prefill", "lm_decode", "gnn_full", "gnn_minibatch",
         "gnn_batched", "rec_train", "rec_serve", "rec_retrieval")


class _Mesh:
    """The reference rules' view of a mesh: its axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _ref_tree(tree):
    """{path: spec as a tuple} of a reference spec tree."""
    import jax
    from jax.sharding import PartitionSpec as P
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _shape_for(arch):
    kind = {"lm": "train_4k", "gnn": "full_graph_sm",
            "recsys": "train_batch"}[arch.family]
    return arch.shape(kind)


CASES = [(a, {}) for a in LM_ARCHS] + [("graphsage-reddit", {})] + [
    (a, {"tablewise": tw}) for a in REC_ARCHS for tw in (False, True)]


@pytest.mark.parametrize("grid_i", range(len(GRIDS)),
                         ids=["x".join(map(str, g[0])) for g in GRIDS])
@pytest.mark.parametrize("aid,kw", CASES,
                         ids=[a + ("_tablewise" if kw.get("tablewise") else "")
                              for a, kw in CASES])
def test_param_and_opt_specs_match_the_reference(aid, kw, grid_i):
    import jax
    from repro.configs import get_arch as jget_arch
    from repro.distributed import sharding as JSH
    from repro.distributed.train_step import default_optimizer as jopt
    from repro.launch.inputs import _make_init as jmake_init
    from repro_torch.configs import get_arch
    from repro_torch.distributed.train_step import default_optimizer
    from repro_torch.launch.train import _make_init
    from repro_torch.optim.adamw import param_tree
    shape, axes = GRIDS[grid_i]
    mesh = _Mesh(shape, axes)
    grid = M.ProcessGrid(shape, axes, rank=0)
    jarch = jget_arch(aid)
    jshape = _shape_for(jarch)
    jrule = {"lm": JSH.lm_param_rule, "gnn": JSH.gnn_param_rule,
             "recsys": JSH.rec_param_rule}[jarch.family](mesh, **kw)
    p_shapes = jax.eval_shape(jmake_init(jarch, jshape, mesh),
                              jax.random.PRNGKey(0))
    j_specs = JSH.spec_tree(p_shapes, jrule)
    o_shapes = jax.eval_shape(jopt()[0], p_shapes)
    j_opt = JSH.opt_state_specs(j_specs, p_shapes, o_shapes)

    arch = get_arch(aid)
    ep = grid.sizes["model"] if arch.family == "lm" else 1
    params = _make_init(arch, _shape_for(arch), ep=ep)(
        torch.Generator("cpu"), "meta")
    specs = SH.spec_tree(params, SH.param_rule(arch.family, grid, **kw))
    assert specs == _ref_tree(j_specs)
    opt = SH.opt_state_specs(specs, params, default_optimizer()[0](params))
    assert opt.step == tuple(j_opt.step)
    for field in ("m", "v", "master"):
        assert getattr(opt, field) == _ref_tree(getattr(j_opt, field)), \
            field
    # the shapes the specs were taken from are the reference's
    assert {n: tuple(t.shape) for n, t in param_tree(params).items()} == \
        {n: tuple(s.shape) for n, s in _ref_tree_shapes(p_shapes).items()}


def _ref_tree_shapes(tree):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): s for path, s in flat}


@pytest.mark.parametrize("grid_i", range(len(GRIDS)),
                         ids=["x".join(map(str, g[0])) for g in GRIDS])
def test_batch_and_cache_specs_match_the_reference(grid_i):
    from repro.distributed import sharding as JSH
    shape, axes = GRIDS[grid_i]
    mesh = _Mesh(shape, axes)
    grid = M.ProcessGrid(shape, axes, rank=0)
    for kind in KINDS:
        want = {k: tuple(v) for k, v in JSH.batch_specs(kind, mesh).items()}
        assert SH.batch_specs(kind, grid) == want, kind
    assert SH.cache_spec(grid) == tuple(JSH.cache_spec(mesh))
    assert SH.dp_axes(grid) == JSH.dp_axes(mesh)
    assert SH.fsdp_axis(grid) == JSH.fsdp_axis(mesh)
    with pytest.raises(ValueError):
        SH.batch_specs("no_such_kind", grid)


#: (full shape, spec) cases for the shard/unshard round trips
SPECS = (((8, 6), ("model", "data")), ((7, 5), ("data", None)),
         ((3, 9, 4), (None, "data", "model")),
         ((10, 3), (("data", "model"), None)), ((5,), ("model",)),
         ((6, 4), (None, None)), ((9, 2), ("pod", None)),
         ((11, 3), (("pod", "data"), "model")), ((13,), ("pp",)),
         ((4, 6), ("pp", "data")))


def _fits(spec, axes):
    return all(a in axes for a in SH.spec_axes(spec))


@pytest.mark.parametrize("grid_i", range(len(GRIDS)),
                         ids=["x".join(map(str, g[0])) for g in GRIDS])
def test_blocks_of_every_rank_reassemble_on_the_large_grids(grid_i):
    shape, axes = GRIDS[grid_i]
    n = int(np.prod(shape))
    rng = np.random.default_rng(grid_i)
    for full, spec in SPECS + (((40, 33), ("data", "model")),):
        if not _fits(spec, axes):
            continue
        t = torch.from_numpy(rng.normal(size=full).astype(np.float32))
        blocks = {r: SH.shard(t, spec, M.ProcessGrid(shape, axes, rank=r))
                  for r in range(n)}
        got = SH.assemble(blocks, full, spec, M.ProcessGrid(shape, axes,
                                                            rank=0))
        assert torch.equal(got, t), (full, spec)
        sizes = sorted({b.shape for b in blocks.values()})
        assert len(sizes) <= 2 ** len(full)


def test_split_bounds_are_numpy_array_split():
    for n in (0, 1, 7, 16, 33):
        for k in (1, 2, 3, 4, 16):
            want = [len(a) for a in np.array_split(np.arange(n), k)]
            got = [SH.split_bounds(n, k, i) for i in range(k)]
            assert [hi - lo for lo, hi in got] == want
            assert got[0][0] == 0 and got[-1][1] == n


def test_owner_counts_each_block_once():
    grid = M.ProcessGrid((2, 2), ("data", "model"), rank=0)
    for spec, owners in ((("model", None), 2), ((None, None), 1),
                         (("model", "data"), 4), (("data",), 2)):
        n = sum(SH.owner(spec, M.ProcessGrid((2, 2), ("data", "model"),
                                             rank=r)) for r in range(4))
        assert n == owners, spec
    assert SH.owner(("model", None), grid)


def test_grid_layout_without_a_world():
    g = M.ProcessGrid((2, 3, 4), ("pod", "data", "model"), rank=17)
    assert g.coords() == (1, 1, 1)
    assert g.sizes == {"pod": 2, "data": 3, "model": 4}
    assert g.index(("data", "model")) == 5
    assert g.index(("pod", "data")) == 4
    assert g.size(("pod", "model")) == 8
    assert g.rank_at(model=3) == 19 and g.rank_at(pod=0, data=0) == 1
    with pytest.raises(RuntimeError, match="no world"):
        g.group(("model",))
    with pytest.raises(ValueError):
        M.ProcessGrid((2, 2), ("data",), rank=0)
    with pytest.raises(ValueError):
        M.ProcessGrid((2, 2), ("data", "data"), rank=0)


def test_grids_refuse_without_a_world():
    for make in (lambda: M.make_grid((2, 2), ("data", "model")),
                 M.make_test_grid, M.make_production_grid,
                 lambda: M.make_production_grid(multi_pod=True)):
        with pytest.raises(RuntimeError, match="init_process_group"):
            make()


# ---------------------------------------------------------------------------
# on a world of 4 ranks
# ---------------------------------------------------------------------------

WORLD_GRIDS = (((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
               ((4,), ("data",)), ((1, 2, 2), ("pod", "data", "model")),
               ((4, 1), ("pp", "data")), ((2, 2), ("pp", "data")))


def rank_round_trips(rank, seed):
    """Every (spec, grid) case that fits the grid: unshard(shard(t)) and
    the grid helpers' view of this rank."""
    out = {}
    rng = np.random.default_rng(seed)
    ts = {full: rng.normal(size=full).astype(np.float32)
          for full, _ in SPECS}
    for gi, (shape, axes) in enumerate(WORLD_GRIDS):
        grid = M.ProcessGrid(shape, axes)
        for si, (full, spec) in enumerate(SPECS):
            if not _fits(spec, axes):
                continue
            t = torch.from_numpy(ts[full])
            block = SH.shard(t, spec, grid).contiguous()
            back = SH.unshard(block, spec, grid, full)
            out[(gi, si)] = bool(torch.equal(back, t))
            if all(n % grid.size(SH._axes(e)) == 0
                   for n, e in zip(full, spec)):
                # an even split needs no shape
                out[(gi, si, "noshape")] = bool(torch.equal(
                    SH.unshard(block, spec, grid), t))
        bf = torch.arange(24, dtype=torch.bfloat16).reshape(4, 6)
        spec = (axes[0], None)
        out[(gi, "bf16")] = bool(torch.equal(
            SH.unshard(SH.shard(bf, spec, grid).contiguous(), spec, grid,
                       (4, 6)), bf))
        out[(gi, "coords")] = grid.coords()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("gloo_sharding")))
    yield w
    w.close()


def test_unshard_of_shard_is_bit_equal_on_every_grid(world):
    got = world.run(__name__, "rank_round_trips", 0)
    for rank, ans in got.items():
        bad = [k for k, v in ans.items() if v is False]
        assert not bad, (rank, bad)
        for gi, (shape, _) in enumerate(WORLD_GRIDS):
            assert ans[(gi, "coords")] == tuple(
                int(c) for c in np.unravel_index(rank, shape))
    n_cases = sum(1 for k in got[0] if len(k) == 2 and k[1] != "coords")
    assert n_cases >= 30


def rank_production_grid(rank):
    """The production grids need 256 or 512 ranks: on a world of 4 they
    raise; make_test_grid and make_grid build."""
    out = []
    for multi in (False, True):
        try:
            M.make_production_grid(multi_pod=multi)
            out.append("built")
        except ValueError as e:
            out.append(str(e))
    g = M.make_test_grid()
    h = M.make_grid((4,), ("data",))
    return out, g.shape, g.axis_names, h.group(("data",))[1]


def test_production_grids_need_their_world(world):
    got = world.run(__name__, "rank_production_grid")
    for out, shape, axes, members in got.values():
        assert "needs 256 ranks" in out[0] and "needs 512 ranks" in out[1]
        assert shape == (2, 2) and axes == ("data", "model")
        assert members == [0, 1, 2, 3]


def test_the_search_grid_is_the_mesh_grid():
    from repro_torch.core import sharded_search as ss
    assert ss.ProcessGrid is M.ProcessGrid
