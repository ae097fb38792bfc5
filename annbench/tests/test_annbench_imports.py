"""The import rule: JAX, jaxlib, flax and the JAX package `repro` are
refused by whole top-level name; the port `repro_torch` is not `repro`."""
import ast
from pathlib import Path

import pytest

from annbench import harness

HERE = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client",
                                  "flax", "flax.linen", "repro",
                                  "repro.core.device_index"])
def test_refused(name):
    assert harness.forbidden_modules(["torch", name]) == [name]


@pytest.mark.parametrize("name", ["repro_torch", "repro_torch.core",
                                  "jaxtyping", "reprolib", "flaxen",
                                  "numpy"])
def test_accepted(name):
    assert harness.forbidden_modules([name]) == []


def test_no_harness_source_imports_them():
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            assert not harness.forbidden_modules(names), (path, names)
