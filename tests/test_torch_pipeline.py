"""The port's GPipe schedule (`repro_torch.distributed.pipeline`) on 4
spawned gloo CPU ranks (every wait and join with a limit), as
tests/test_distributed.py holds the reference's: 8 layers of
tanh(h @ w) (d = 16, weights * 0.3), 8 microbatches of 2 rows, on grids
("pp", "data") (4, 1) and (2, 2). The outputs are within 2e-4 of the JAX
package's sequential `stage_fn` over all 8 layers (the reference's bar)
and bit-equal to the port's own stages run in sequence on each
microbatch; every rank returns the same outputs, and each stage applied
its layers to each microbatch once.

jax is imported inside the tests: the spawned ranks import this module
and need only torch.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import pipeline as PP
from repro_torch.distributed import sharding as SH
from torch_world import World

S_LAYERS, M, MB, D = 8, 8, 2, 16


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(S_LAYERS, D, D)).astype(np.float32)
         * np.float32(0.3))
    x = rng.normal(size=(M * MB, D)).astype(np.float32)
    return w, x


def stage_fn(params, xb):
    h = xb
    for w in params:
        h = torch.tanh(h @ w)
    return h


def rank_pipeline(rank, shape):
    grid = PP.make_pp_grid(*shape)
    S = shape[0]
    w, x = _inputs()
    stacked = torch.from_numpy(w).reshape(S, S_LAYERS // S, D, D)
    mine = SH.shard(stacked, ("pp",), grid)[0]
    calls = []

    def counted(p, xb):
        calls.append(xb.shape)
        return stage_fn(p, xb)
    out = PP.pipeline_forward(grid, counted, M)(
        mine, torch.from_numpy(x).reshape(M, MB, D))
    seq = []
    for m in range(M):
        h = torch.from_numpy(x).reshape(M, MB, D)[m]
        for s in range(S):
            h = stage_fn(stacked[s], h)
        seq.append(h)
    return out.numpy(), torch.stack(seq).numpy(), len(calls)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("gloo_pipeline")))
    yield w
    w.close()


@pytest.fixture(scope="module")
def reference():
    import jax
    import jax.numpy as jnp
    w, x = _inputs()

    def jstage(params, xb):
        def body(h, wl):
            return jnp.tanh(h @ wl), None
        h, _ = jax.lax.scan(body, xb, params)
        return h
    return np.asarray(jstage(jnp.asarray(w), jnp.asarray(x))).reshape(
        M, MB, D)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_pipeline_matches_the_sequential_stages(world, reference, shape):
    got = world.run(__name__, "rank_pipeline", shape)
    out0 = got[0][0]
    for out, seq, calls in got.values():
        np.testing.assert_array_equal(out, out0)
        np.testing.assert_array_equal(out, seq)
        assert calls == M
    np.testing.assert_allclose(out0, reference, rtol=2e-4, atol=2e-4)


def test_the_schedule_needs_a_live_world():
    grid = PP.ProcessGrid((1, 1), ("pp", "data"), rank=0)
    with pytest.raises(RuntimeError, match="no world"):
        PP.pipeline_forward(grid, stage_fn, M)
