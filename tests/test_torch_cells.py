"""The port's dry-run cells (`repro_torch.launch.inputs.build_cell`)
against the reference's, cell for cell, on both production grids: 256
ranks as (data 16, model 16) and 512 as (pod 2, data 16, model 16).

The reference's `build_cell` runs once a grid in a subprocess with that
many virtual CPU devices (as `tests/test_distributed.py` runs its
meshes); it dumps each cell's `meta`, every input leaf's global shape and
dtype, and the index ranges (`NamedSharding.devices_indices_map`) of the
blocks at mesh coordinates (0, ..., 0) and at the last coordinates. The
port builds the same cell on a `ProcessGrid(shape, axes, rank=...)` (no
world: the specs and blocks only) and must give equal `meta` (model
flops, microbatches, parameter bytes; an ANN cell's mode, shard count and
chunk GB a device), equal leaf paths, shapes and dtypes, and equal blocks
at rank 0 and at the last rank (`sharding.block_slices`). Every
dimension of these cells divides by its axes, so the port's
`numpy.array_split` blocks and the reference's ceil-sized ones coincide;
the test names the leaf and both rules if one ever does not.
`REPRO_GNN=sharded` (edges pre-partitioned by destination, padded to
the world's ways) is covered for ogb_products and full_graph_sm.

jax runs only in the subprocess: this module imports torch and the port.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_arch, list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import ProcessGrid

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

GRIDS = {"pod1": ((16, 16), ("data", "model")),
         "pod2": ((2, 16, 16), ("pod", "data", "model"))}
SHARDED_GNN = ("full_graph_sm", "ogb_products")

_DUMP = r"""
import json, os, sys
import jax
from jax.sharding import NamedSharding
from repro.configs.registry import ASSIGNED_ARCHS, get_arch
from repro.launch.inputs import build_cell
from repro.launch.mesh import make_production_mesh

def keyname(k):
    for a in ("key", "idx", "name"):
        if hasattr(k, a):
            return str(getattr(k, a))
    return str(k)

def dump(cell, mesh):
    leaves = jax.tree_util.tree_flatten_with_path(cell.args)[0]
    shs = jax.tree_util.tree_leaves(
        cell.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs), (len(leaves), len(shs))
    devs = mesh.devices.flat
    first, last = devs[0], list(mesh.devices.flat)[-1]
    out = []
    for (kp, s), ns in zip(leaves, shs):
        idx = ns.devices_indices_map(tuple(s.shape))
        def rng(d):
            return [list(sl.indices(n)[:2]) for sl, n in zip(idx[d], s.shape)]
        out.append({"path": "/".join(keyname(k) for k in kp),
                    "shape": list(s.shape), "dtype": str(s.dtype),
                    "first": rng(first), "last": rng(last)})
    return {"meta": {k: v for k, v in cell.meta.items()}, "leaves": out}

mesh = make_production_mesh(multi_pod=sys.argv[2] == "pod2")
cells = {}
for aid in ASSIGNED_ARCHS + ["aisaq-sift1m", "aisaq-sift1b", "aisaq-kilt-e5"]:
    arch = get_arch(aid)
    for s in arch.shapes:
        if s.name in arch.skip_shapes:
            continue
        cells[f"{aid}:{s.name}"] = dump(build_cell(aid, s.name, mesh), mesh)
os.environ["REPRO_GNN"] = "sharded"
for s in ("full_graph_sm", "ogb_products"):
    cells[f"sharded:graphsage-reddit:{s}"] = dump(
        build_cell("graphsage-reddit", s, mesh), mesh)
json.dump(cells, open(sys.argv[1], "w"))
"""


def _cells():
    out = []
    for aid in list_archs():
        arch = get_arch(aid)
        out += [(aid, s.name) for s in arch.shapes
                if s.name not in arch.skip_shapes]
    return out


CELLS = _cells()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{grid tag: {"arch:shape": dump}} from the reference's build_cell."""
    tmp = tmp_path_factory.mktemp("ref_cells")
    got = {}
    for tag, (shape, _) in GRIDS.items():
        path = str(tmp / f"{tag}.json")
        n = 1
        for d in shape:
            n *= d
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
        env.pop("REPRO_GNN", None)
        env.pop("REPRO_MB_BUDGET_GB", None)
        r = subprocess.run([sys.executable, "-c", _DUMP, path, tag],
                           env=env, capture_output=True, text=True,
                           timeout=400)
        assert r.returncode == 0, r.stderr[-3000:]
        with open(path) as f:
            got[tag] = json.load(f)
    return got


def _compare(ref: dict, cell: "I.Cell", shape, axes):
    world = 1
    for d in shape:
        world *= d
    for key in ("model_flops", "microbatches", "params", "mode",
                "n_shards", "chunk_gb_per_dev"):
        assert (key in ref["meta"]) == (key in cell.meta), key
        if key in ref["meta"]:
            assert cell.meta[key] == pytest.approx(ref["meta"][key],
                                                   rel=1e-12), key
    mine = I.arg_leaves(cell)
    refs = {leaf["path"]: leaf for leaf in ref["leaves"]}
    # jax flattens a dict's keys sorted, the port in their order
    assert sorted(p for p, _, _ in mine) == sorted(refs)
    for path, t, spec in mine:
        leaf = refs[path]
        assert list(t.shape) == leaf["shape"], path
        assert str(t.dtype).split(".")[1] == leaf["dtype"], path
        for which, rank in (("first", 0), ("last", world - 1)):
            grid = ProcessGrid(shape, axes, rank=rank)
            got = [[s.start, s.stop] for s in
                   SH.block_slices(t.shape, spec, grid)]
            if got == leaf[which]:
                continue
            uneven = [d for d, (n, e) in enumerate(zip(
                t.shape, tuple(spec) + (None,) * t.ndim))
                if n % grid.size(SH._axes(e))]
            pytest.fail(f"{path} ({which} block): the port's "
                        f"numpy.array_split block {got} (spec {spec}), the "
                        f"reference's ceil-sized block {leaf[which]}; "
                        f"dims that do not divide: {uneven}")


@pytest.mark.parametrize("tag", list(GRIDS))
@pytest.mark.parametrize("arch_id,shape_name", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_matches_the_reference(reference, tag, arch_id, shape_name,
                                    monkeypatch):
    monkeypatch.delenv("REPRO_GNN", raising=False)
    monkeypatch.delenv("REPRO_MB_BUDGET_GB", raising=False)
    shape, axes = GRIDS[tag]
    cell = I.build_cell(arch_id, shape_name,
                        ProcessGrid(shape, axes, rank=0))
    _compare(reference[tag][f"{arch_id}:{shape_name}"], cell, shape, axes)


@pytest.mark.parametrize("tag", list(GRIDS))
@pytest.mark.parametrize("shape_name", SHARDED_GNN)
def test_sharded_gnn_cell_matches_the_reference(reference, tag, shape_name,
                                                monkeypatch):
    monkeypatch.setenv("REPRO_GNN", "sharded")
    shape, axes = GRIDS[tag]
    cell = I.build_cell("graphsage-reddit", shape_name,
                        ProcessGrid(shape, axes, rank=0))
    ref = reference[tag][f"sharded:graphsage-reddit:{shape_name}"]
    _compare(ref, cell, shape, axes)
    edges = [t for p, t, _ in I.arg_leaves(cell) if p == "1/edges"][0]
    assert edges.shape[0] == cell.place.grid.world


def test_every_cell_is_listed():
    """43 cells that are not documented skips, as the reference lists."""
    assert len(CELLS) == 43


def test_local_args_are_the_blocks_of_the_specs():
    """local_args cuts every leaf of the state (a module's parameters
    too) to the blocks block_slices gives, at any rank, and passes the
    batch whole (the step takes its dp block); local_bytes counts the
    batch's block too."""
    shape, axes = GRIDS["pod1"]
    grid = ProcessGrid(shape, axes, rank=0)
    cell = I.build_cell("qwen3-1.7b", "train_4k", grid)
    for rank in (0, 37, 255):
        local = I.local_args(cell, grid, rank)
        mine = {p: t for p, t in I._leaves(local)}
        for path, t, spec in I.arg_leaves(cell):
            want = tuple(s.stop - s.start for s in
                         SH.block_slices(t.shape, spec, grid, rank))
            if path.startswith("1/"):   # the batch: the step cuts it
                want = tuple(t.shape)
            assert tuple(mine[path].shape) == want, (rank, path)
            assert mine[path].device.type == "meta"
    assert I.local_bytes(cell, grid) == 86_412_392
