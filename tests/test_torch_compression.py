"""The port's int8 compressed all-reduce (`repro_torch.distributed.
compression`) against the JAX package's.

- `quantize_int8` / `dequantize_int8`: bit-equal to the reference's.
- `compressed_psum` on 4 spawned gloo CPU ranks (every wait and join with
  a limit): bit-equal to the reference's `compressed_psum` run without
  `jit` under `jax.vmap(axis_name="data")` on one device (which gives the
  bits of the reference test's 8-device `shard_map`), on 4,096 elements
  (the reference test's leaf), a (64, 96) leaf, a leaf of zeros and a
  leaf of mixed magnitudes; within 0.02 relative of the mean (the
  reference's bar, tests/test_distributed.py:133); a leaf under 1,024
  elements takes the float32 mean (within 1e-6 of numpy's).
- `make_compressed_dp_grads` on grids (4,) and (2, 2) over `data`: the
  loss is the full batch's and every gradient within 0.02 relative of the
  full batch's.

jax is imported inside the tests: the spawned ranks import this module
and need only torch.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import compression as C
from repro_torch.launch.mesh import ProcessGrid
from torch_world import World

WORLD = 4
SHAPES = {"g": (4096,), "w": (64, 96), "zero": (2048,), "mixed": (3000,),
          "bias": (100,), "norm": (1023,)}


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    out = {k: rng.normal(size=(WORLD,) + s).astype(np.float32)
           for k, s in SHAPES.items()}
    out["zero"][:] = 0.0
    out["mixed"] *= np.float32(10.0) ** rng.integers(
        -6, 3, size=out["mixed"].shape).astype(np.float32)
    return out


def rank_psum(rank, seed):
    grid = ProcessGrid((WORLD,), ("data",))
    group, _ = grid.group(("data",))
    x = _inputs(seed)
    got = C.compressed_psum({k: torch.from_numpy(v[rank])
                             for k, v in x.items()}, group)
    return {k: v.numpy() for k, v in got.items()}


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w1 = torch.nn.Parameter(torch.randn(32, 64, generator=g) * .2)
        self.b1 = torch.nn.Parameter(torch.zeros(64))
        self.w2 = torch.nn.Parameter(torch.randn(64, 24, generator=g) * .2)


def _loss(p, b):
    y = torch.tanh(b["x"] @ p.w1 + p.b1) @ p.w2
    return ((y - b["y"]) ** 2).mean(), {}


def rank_dp_grads(rank, shape):
    from repro_torch.optim.adamw import param_tree
    grid = ProcessGrid(shape, ("data", "model")[:len(shape)])
    rng = np.random.default_rng(1)
    batch = {"x": torch.from_numpy(rng.normal(size=(16, 32))
                                   .astype(np.float32)),
             "y": torch.from_numpy(rng.normal(size=(16, 24))
                                   .astype(np.float32))}
    p = _MLP()
    fn = C.make_compressed_dp_grads(_loss, grid, dp_axis="data")
    loss, grads = fn(p, batch)
    full, _ = _loss(p, batch)
    tree = param_tree(p)
    want = torch.autograd.grad(full, list(tree.values()))
    return (float(loss), float(full),
            {k: (grads[k].numpy(), w.numpy()) for k, w in zip(tree, want)})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(WORLD, str(tmp_path_factory.mktemp("gloo_compression")))
    yield w
    w.close()


def _reference(x):
    import jax
    import jax.numpy as jnp
    from repro.distributed.compression import compressed_psum
    fn = jax.vmap(lambda t: compressed_psum(t, "data"), axis_name="data")
    out = fn({k: jnp.asarray(v) for k, v in x.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def test_quantize_and_dequantize_are_the_references():
    import jax.numpy as jnp
    from repro.distributed import compression as JC
    rng = np.random.default_rng(3)
    x = rng.normal(size=5000).astype(np.float32)
    x[:7] = [0.5, -0.5, 1.5, 2.5, -2.5, 0.0, 1e-30]
    for scale in (np.float32(3.1), np.float32(np.abs(x).max()),
                  np.float32(0.0)):
        q = C.quantize_int8(torch.from_numpy(x), torch.tensor(scale))
        jq = JC.quantize_int8(jnp.asarray(x), jnp.float32(scale))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        s = np.float32(scale) if scale else np.float32(1.0)
        tot = rng.integers(-508, 509, size=4096).astype(np.int32)
        np.testing.assert_array_equal(
            C.dequantize_int8(torch.from_numpy(tot), torch.tensor(s))
            .numpy(),
            np.asarray(JC.dequantize_int8(jnp.asarray(tot), jnp.float32(s))))


@pytest.mark.parametrize("seed", [0, 1])
def test_compressed_psum_is_the_references_bit_for_bit(world, seed):
    x = _inputs(seed)
    want = _reference(x)
    got = world.run(__name__, "rank_psum", seed)
    for rank, ans in got.items():
        for k in SHAPES:
            if np.prod(SHAPES[k]) < C.SMALL:
                # the float32 mean: the order of the sum is the backend's
                np.testing.assert_allclose(ans[k], x[k].mean(0), rtol=0,
                                           atol=1e-6, err_msg=k)
                np.testing.assert_allclose(ans[k], want[k][rank], rtol=0,
                                           atol=1e-6, err_msg=k)
                continue
            np.testing.assert_array_equal(ans[k], want[k][rank],
                                          err_msg=f"rank {rank} {k}")
            mean = x[k].mean(0)
            rel = np.abs(ans[k] - mean).max() / (np.abs(mean).max() + 1e-9)
            assert rel < 0.02, (k, rel)
    assert not np.any(got[0]["zero"])


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4", "2x2"])
def test_compressed_dp_grads_are_the_full_batch_gradients(world, shape):
    got = world.run(__name__, "rank_dp_grads", shape)
    for loss, full, grads in got.values():
        assert loss == pytest.approx(full, abs=1e-6)
        for k, (g, want) in grads.items():
            rel = np.abs(g - want).max() / (np.abs(want).max() + 1e-9)
            assert rel < 0.02, (k, rel)
        np.testing.assert_array_equal(grads["w1"][0], got[0][2]["w1"][0])
