"""Import boundary of the port: `repro_torch` and `chip_smoke.py` import
neither jax nor the JAX package, its kernel modules import without nvcc,
and its entry points refuse to run on the CPU unless asked to."""
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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


#: the modules of the storage-backed search slice
STORAGE_MODULES = ("obs", "obs.metrics", "obs.trace", "core.adc",
                   "core.block_cache", "core.nav", "core.traversal",
                   "core.index_io", "core.index_switch", "serving.pool",
                   "serving.engine", "launch.serve")

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
                           modules=STORAGE_MODULES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", STORAGE_MODULES)
def test_storage_modules_import_with_jax_and_repro_blocked(blocked_imports,
                                                           module):
    assert blocked_imports[module] == "ok"


def test_kernel_modules_import_without_building():
    """Nothing is compiled at import: the library is built at first launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunk_adc, ops, pq_lut, rerank  # noqa

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
    assert make_device_search_fn(idx, lay, device="cpu")(q[:2], 5).shape \
        == (2, 5)
