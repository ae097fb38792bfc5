"""The port's GPipe schedule (`repro_torch.distributed.pipeline`) on 4
spawned gloo CPU ranks (every wait and join with a limit), as
tests/test_distributed.py holds the reference's: 8 layers of
tanh(h @ w) (d = 16, weights * 0.3), 8 microbatches of 2 rows, on grids
("pp", "data") (4, 1) and (2, 2). The outputs are within 2e-4 of the JAX
package's sequential `stage_fn` over all 8 layers (the reference's bar)
and bit-equal to the port's own stages run in sequence on each
microbatch; every rank returns the same outputs, and each stage applied
its layers to each microbatch once.

The schedule's gradients (of sum(out * R) for a fixed random R) of the
stage weights and of x: within 2e-4 of `jax.grad` of the reference's
sequential `stage_fn` over all 8 layers, within 1e-6 relative of torch
autograd through the port's stages in sequence, and the reference's own
`jax.grad` through its `pipeline_forward` (4 virtual CPU devices in a
subprocess) equals the sequence's too, within the same 2e-4: its final
masked `psum` does not count the replicated cotangent once a stage.

jax is imported inside the tests: the spawned ranks import this module
and need only torch.
"""
import os
import subprocess
import sys

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


def _cotangent():
    """R: the loss is sum(out * R), so R is the output's cotangent."""
    return np.random.default_rng(1).normal(size=(M, MB, D)).astype(
        np.float32)


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


def rank_pipeline_grads(rank, shape):
    """This rank's stage-weight gradient and x's through the schedule,
    and the same from autograd through the stages in sequence."""
    grid = PP.make_pp_grid(*shape)
    S = shape[0]
    w, x = _inputs()
    R = torch.from_numpy(_cotangent())
    stacked = torch.from_numpy(w).reshape(S, S_LAYERS // S, D, D)
    stage = grid.coords()[0]
    mine = SH.shard(stacked, ("pp",), grid)[0].clone().requires_grad_(True)
    xs = torch.from_numpy(x).reshape(M, MB, D).clone().requires_grad_(True)
    out = PP.pipeline_forward(grid, stage_fn, M)(mine, xs)
    gw, gx = torch.autograd.grad((out * R).sum(), [mine, xs])
    ws = torch.from_numpy(w).clone().requires_grad_(True)
    xq = torch.from_numpy(x).reshape(M, MB, D).clone().requires_grad_(True)
    seq = stage_fn(ws, xq.reshape(M * MB, D)).reshape(M, MB, D)
    sw, sx = torch.autograd.grad((seq * R).sum(), [ws, xq])
    per = S_LAYERS // S
    return (gw.numpy(), gx.numpy(), sw[stage * per:(stage + 1) * per]
            .numpy(), sx.numpy(), stage)


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


@pytest.fixture(scope="module")
def reference_grads():
    """jax.grad of sum(stage_fn(W, x) * R) over all 8 layers in sequence."""
    import jax
    import jax.numpy as jnp
    w, x = _inputs()
    R = jnp.asarray(_cotangent().reshape(M * MB, D))

    def jstage(params, xb):
        def body(h, wl):
            return jnp.tanh(h @ wl), None
        h, _ = jax.lax.scan(body, xb, params)
        return h
    gw, gx = jax.grad(lambda a, b: jnp.sum(jstage(a, b) * R), (0, 1))(
        jnp.asarray(w), jnp.asarray(x))
    return np.asarray(gw), np.asarray(gx).reshape(M, MB, D)


_JAX_PIPE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.distributed.pipeline import make_pp_mesh, pipeline_forward
S, nd = {S}, {nd}
M, mb, d = {M}, {MB}, {D}
w = np.load(sys.argv[1]); x = np.load(sys.argv[2]); R = np.load(sys.argv[3])
mesh = make_pp_mesh(S, nd)
def stage_fn(params, xb):
    def body(h, wl):
        return jnp.tanh(h @ wl), None
    h, _ = jax.lax.scan(body, xb, params)
    return h
pipe = pipeline_forward(mesh, stage_fn, M)
def loss(W, X):
    return jnp.sum(pipe(W.reshape(S, -1, d, d), X.reshape(M, mb, d)) * R)
gw, gx = jax.jit(jax.grad(loss, (0, 1)))(jnp.asarray(w), jnp.asarray(x))
np.save(sys.argv[4], np.asarray(gw)); np.save(sys.argv[5], np.asarray(gx))
"""


def _jax_pipeline_grads(shape, tmp):
    """jax.grad through the reference's `pipeline_forward` on a (S, nd)
    mesh of virtual CPU devices, in a subprocess."""
    w, x = _inputs()
    paths = [os.path.join(tmp, f) for f in ("w.npy", "x.npy", "r.npy",
                                            "gw.npy", "gx.npy")]
    for pth, a in zip(paths, (w, x, _cotangent())):
        np.save(pth, a)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{shape[0] * shape[1]}")
    r = subprocess.run([sys.executable, "-c", _JAX_PIPE.format(
        S=shape[0], nd=shape[1], M=M, MB=MB, D=D)] + paths, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return np.load(paths[3]), np.load(paths[4]).reshape(M, MB, D)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_pipeline_gradients(world, reference_grads, shape, tmp_path):
    got = world.run(__name__, "rank_pipeline_grads", shape)
    ref_w, ref_x = reference_grads
    S = shape[0]
    per = S_LAYERS // S
    for gw, gx, sw, sx, stage in got.values():
        # the schedule against the port's stages in sequence
        for a, b in ((gw, sw), (gx, sx)):
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())
        # against jax.grad of the reference's sequential stage_fn
        np.testing.assert_allclose(
            gw, ref_w[stage * per:(stage + 1) * per], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(gx, ref_x, rtol=2e-4, atol=2e-4)
    # jax.grad through the reference's own schedule: the sequence's too
    # (a factor S would show a cotangent counted once a stage)
    jw, jx = _jax_pipeline_grads(shape, str(tmp_path))
    np.testing.assert_allclose(jw, ref_w, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(jx, ref_x, rtol=2e-4, atol=2e-4)


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
