"""Import boundary of the port: `repro_torch`, `chip_smoke.py` and the
port's examples (`examples/*_torch.py`) import neither jax nor the JAX
package, its kernel modules import without nvcc, and its entry points
refuse to run on the CPU unless asked to."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "examples").glob("*_torch.py"))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_and_repro_unloaded():
    mods = ["repro_torch." + ".".join(p.relative_to(PORT).with_suffix("")
                                      .parts)
            for p in sorted(PORT.rglob("*.py")) if p.name != "__init__.py"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              f"{FORBIDDEN!r})\nprint(bad)\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout


#: the modules of the storage-backed search slice and of the write half
STORAGE_MODULES = ("obs", "obs.metrics", "obs.trace", "core.adc",
                   "core.block_cache", "core.nav", "core.traversal",
                   "core.index_io", "core.index_switch", "serving.pool",
                   "serving.engine", "launch.serve", "core.wal",
                   "core.faults", "core.dynamic", "core.shard_math",
                   "serving", "serving.service", "serving.protocol",
                   "serving.router", "serving.cluster")

#: the modules of the recommender training slice
TRAIN_MODULES = ("data.pipeline", "optim", "optim.adamw", "checkpoint",
                 "checkpoint.ckpt", "distributed", "distributed.train_step",
                 "distributed.fault_tolerance", "launch.train")

#: the modules of the language-model slice
LM_MODULES = ("configs", "models.layers", "models.moe", "models.transformer")

#: the modules of the GNN slice
GNN_MODULES = ("kernels.segment", "models.gnn", "models.gnn_sharded",
               "launch.flops", "launch.inputs")

#: the modules of the distributed scaffolding
DIST_MODULES = ("launch.mesh", "distributed.sharding",
                "distributed.act_sharding", "distributed.compression",
                "distributed.pipeline")

#: the modules of the dry-run cells
CELL_MODULES = ("launch.inputs", "launch.dryrun")

_BLOCKER = """
import importlib, json, sys
class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {forbidden!r}:
            raise ImportError('blocked: ' + name)
        return None
sys.meta_path.insert(0, _Blocked())
out = {{}}
for m in {modules!r}:
    try:
        importlib.import_module('repro_torch.' + m)
        out[m] = 'ok'
    except Exception as e:
        out[m] = repr(e)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def blocked_imports():
    """One process where any import of jax or repro raises imports each
    storage module in turn: module -> 'ok' or the error."""
    code = _BLOCKER.format(forbidden=set(FORBIDDEN),
                           modules=STORAGE_MODULES + TRAIN_MODULES
                           + LM_MODULES + GNN_MODULES + DIST_MODULES
                           + CELL_MODULES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", STORAGE_MODULES)
def test_storage_modules_import_with_jax_and_repro_blocked(blocked_imports,
                                                           module):
    assert blocked_imports[module] == "ok"


@pytest.mark.parametrize("module", TRAIN_MODULES)
def test_train_modules_import_with_jax_and_repro_blocked(blocked_imports,
                                                         module):
    assert blocked_imports[module] == "ok"


@pytest.mark.parametrize("module", LM_MODULES)
def test_lm_modules_import_with_jax_and_repro_blocked(blocked_imports,
                                                      module):
    assert blocked_imports[module] == "ok"


@pytest.mark.parametrize("module", GNN_MODULES)
def test_gnn_modules_import_with_jax_and_repro_blocked(blocked_imports,
                                                       module):
    assert blocked_imports[module] == "ok"


@pytest.mark.parametrize("module", DIST_MODULES)
def test_dist_modules_import_with_jax_and_repro_blocked(blocked_imports,
                                                        module):
    assert blocked_imports[module] == "ok"


@pytest.mark.parametrize("module", CELL_MODULES)
def test_cell_modules_import_with_jax_and_repro_blocked(blocked_imports,
                                                        module):
    assert blocked_imports[module] == "ok"


def test_the_dry_run_needs_no_card():
    """Cells build and their blocks cut on the meta device: no card, no
    world (a grid of one described rank)."""
    from repro_torch.launch import inputs as I
    from repro_torch.launch.mesh import ProcessGrid
    grid = ProcessGrid((16, 16), ("data", "model"), rank=5)
    cell = I.build_cell("dcn-v2", "serve_p99", grid)
    for t in I._leaves(I.local_args(cell, grid)):
        assert t[1].device.type == "meta"


def test_grid_entry_points_need_a_card_or_device_cpu(tmp_path):
    """`restore(grid=)`, like the plain restore, reads onto the card unless
    asked for the CPU; the grid trainer's device is the trainer's."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.mesh import ProcessGrid
    ckpt.save(str(tmp_path), {"a": torch.arange(4.0)}, step=1)
    grid = ProcessGrid((1, 2), rank=1)
    kw = dict(grid=grid, layout={"a": (("model",), (4,))})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore(str(tmp_path), {"a": torch.ones(2)}, **kw)
    got = ckpt.restore(str(tmp_path), {"a": torch.ones(2)}, device="cpu",
                       **kw)
    assert got["a"].tolist() == [2.0, 3.0]


def test_gnn_entry_points_need_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from repro_torch.configs import get_arch
    from repro_torch.kernels.segment import prepare_csr
    from repro_torch.launch import train
    from repro_torch.models import gnn as G
    from repro_torch.models.gnn_sharded import local_csr
    cfg = get_arch("graphsage-reddit").model
    edges = np.array([[0, 1], [2, 1]], np.int32)
    sampler = G.NeighborSampler.from_edges(edges, 3)
    g = torch.Generator().manual_seed(0)
    calls = [
        lambda **kw: G.init_gnn(cfg, 4, generator=g, **kw),
        lambda **kw: prepare_csr(edges, 3, **kw),
        lambda **kw: local_csr(edges[None], 3, 1, 0, **kw),
        lambda **kw: sampler.sample_blocks(np.array([1]), (2, 2),
                                           np.ones((3, 4), np.float32), **kw),
        lambda **kw: train.build_trainer("graphsage-reddit", "full_graph_sm",
                                         **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    p = G.init_gnn(cfg, 4, generator=g, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.gnn_params_from_jax({"layers": [
            {k: t.detach().numpy() for k, t in lp.items()}
            for lp in p.layers], "w_out": p.w_out.detach().numpy()})


def test_lm_entry_points_need_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from repro_torch.configs import get_arch
    from repro_torch.distributed import train_step as ts
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    cfg = train.tiny_lm(get_arch("qwen3-1.7b").model)
    mc = get_arch("qwen2-moe-a2.7b").model.moe
    g = torch.Generator().manual_seed(0)
    calls = [
        lambda **kw: T.init_lm(cfg, generator=g, **kw),
        lambda **kw: T.init_cache(cfg, 1, 4, **kw),
        lambda **kw: moe.init_moe(8, mc, generator=g, **kw),
        lambda **kw: train.build_trainer("qwen3-1.7b", "train_4k", **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    p = T.init_lm(cfg, generator=g, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.lm_params_from_jax({n: t.detach().numpy() for n, t in
                              [("embed", p.embed),
                               ("final_norm", p.final_norm)]}
                             | {"layers": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                    "--steps", "1"])
    _, init, _, _ = train.build_trainer("qwen3-1.7b", "train_4k",
                                        device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.state_to(init())


def test_train_entry_points_need_a_card_or_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.distributed import train_step as ts
    from repro_torch.launch import train
    ckpt.save(str(tmp_path), {"a": torch.ones(2)}, step=1)
    calls = [
        lambda **kw: train.build_trainer("dcn-v2", "train_batch", **kw),
        lambda **kw: train.train_loop("dcn-v2", "train_batch", steps=1,
                                      verbose=False, **kw),
        lambda **kw: Prefetcher(lambda s: {"x": np.ones(2)}, **kw).stop(),
        lambda **kw: ckpt.restore(str(tmp_path), {"a": torch.ones(2)}, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    _, init, _, _ = train.build_trainer("dcn-v2", "train_batch",
                                        device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.state_to(init())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "dcn-v2", "--steps", "1"])


def test_kernel_modules_import_without_building():
    """Nothing is compiled at import: the library is built at first launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunk_adc, ops, pq_lut, rerank  # noqa
    from repro_torch.kernels import segment  # noqa

    assert _build._lib is None
    assert _build.library_path().name.startswith("aisaq_kernels_")
    assert str(_build.BUILD_DIR.relative_to(ROOT)) in \
        (ROOT / ".gitignore").read_text()


def test_chip_smoke_refuses_to_run_without_a_card():
    """No card: non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "no CUDA device" in res.stderr


def test_entry_points_need_a_card_or_device_cpu(small_corpus, built_graph,
                                                pq_artifacts, index_dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from repro_torch.core import pq
    from repro_torch.core.device_index import from_arrays, \
        load_device_index
    from repro_torch.serving.engine import make_device_search_fn
    base, q, _ = small_corpus
    cents, codes = pq_artifacts
    calls = [
        lambda **kw: from_arrays(base, built_graph, cents, codes, **kw),
        lambda **kw: load_device_index(index_dirs["aisaq"], **kw),
        lambda **kw: pq.train_codebooks(base, m=12, iters=1,
                                        init_idx=np.arange(256), **kw),
        lambda **kw: pq.encode(cents, base, **kw),
        lambda **kw: pq.groundtruth(q, base, 10, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    idx, lay = from_arrays(base, built_graph, cents, codes, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_device_search_fn(idx, lay)
    from repro_torch.core.index_io import HostIndex
    from repro_torch.core.index_switch import IndexManager
    from repro_torch.core.vamana import random_regular_graph
    from repro_torch.launch import serve
    from repro_torch.serving.pool import WarmIndexPool
    paths = {"a": index_dirs["aisaq"]}
    storage = [
        lambda **kw: HostIndex.load(index_dirs["aisaq"], **kw).close(),
        lambda **kw: WarmIndexPool(paths, **kw).close(),
        lambda **kw: IndexManager(paths, **kw).close(),
        lambda **kw: random_regular_graph(100, 8, **kw),
    ]
    for call in storage:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--queries", "2", "--corpora",
                    f"a={index_dirs['aisaq']}"])
    from repro_torch.core.dynamic import DynamicHostIndex
    from repro_torch.serving.cluster import ShardCluster
    import tempfile
    socks = tempfile.mkdtemp(prefix="socks")
    write_half = [
        lambda **kw: DynamicHostIndex.load(index_dirs["aisaq"], **kw).close(),
        lambda **kw: ShardCluster([paths], socket_dir=socks, **kw),
    ]
    for call in write_half:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    assert make_device_search_fn(idx, lay, device="cpu")(q[:2], 5).shape \
        == (2, 5)


#: each port example, the arguments its `main` gets after --device cpu,
#: and the tiny sizes its `run` is cut to for the CPU
EXAMPLES = {
    "quickstart_torch": ([], dict(n=300, d=16, nq=4, R=8, pq_m=4,
                                  build_L=16, L=16)),
    "dynamic_corpus_torch": ([], dict(n_base=300, n_new=10, d=16, R=8,
                                      pq_m=4, build_L=16, L=16, probe=305,
                                      deleted=(300, 303))),
    "rag_retrieval_torch": ([], dict(d=16, n_per=300, pq_m=4, R=8,
                                     build_L=16)),
    "distributed_search_torch": ([], dict(n=300, d=16, m=4, R=8, nq=4,
                                          grid=(1, 2))),
    "train_lm_torch": (["--steps", "3"], dict(widths=None)),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_need_a_card_or_device_cpu(name, tmp_path, monkeypatch,
                                            capsys):
    """main([]) raises before any work without a card; with --device cpu
    (its run cut to tiny sizes) it runs and prints the original's lines."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the examples run on it")
    import functools
    import importlib
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    mod = importlib.import_module(name)
    argv, tiny = EXAMPLES[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    monkeypatch.setattr(mod, "run", functools.partial(
        mod.run, workdir=str(tmp_path), **tiny))
    mod.main(["--device", "cpu"] + argv)
    out = capsys.readouterr().out
    first = {"quickstart_torch": "== corpus: 300 x 16",
             "dynamic_corpus_torch": "== building initial 300-doc index",
             "rag_retrieval_torch": "== building 3 corpora",
             "distributed_search_torch": "== 300 vectors over 2 index",
             "train_lm_torch": "training 48M-param LM for 3 steps"}[name]
    assert first in out
