"""The port's GNN training path (`distributed.train_step`'s GNN branches,
`launch.train`'s GNN branch) against the JAX package at the reference's
tiny scale (d_hidden 32, 8 classes, a 256-node graph of 2,048 edges, 32
features), on the CPU.

Tolerances: parameters within 1e-4 absolute after each of 3 steps (the
CPU tests' bar for a train step: Adam's first steps move an element by a
sizeable share of lr on a last-bit gradient difference), the loss within
rtol 1e-5; the 30-step loss bar of tests/test_system.py; a restart
bit-equal to an uninterrupted run.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import pipeline as jpipe
from repro.distributed import train_step as jts
from repro.models import gnn as JG
from repro_torch import configs
from repro_torch.distributed import train_step as ts
from repro_torch.kernels.segment import prepare_csr
from repro_torch.launch import train
from repro_torch.optim.adamw import param_tree

ARCH = "graphsage-reddit"


def _tiny(arch):
    arch = dataclasses.replace(arch, model=arch.model.scaled(d_hidden=32,
                                                             n_classes=8))
    shape = dataclasses.replace(arch.shape("full_graph_sm"), n_nodes=256,
                                n_edges=2048, d_feat=32)
    return arch, shape


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def test_three_steps_match_the_reference_train_step():
    (jarch, jshape), (arch, shape) = _tiny(jget_arch(ARCH)), \
        _tiny(configs.get_arch(ARCH))
    jopt = jts.default_optimizer(total_steps=3, base_lr=3e-3)
    opt = ts.default_optimizer(total_steps=3, base_lr=3e-3)
    jp = JG.init_gnn(jax.random.PRNGKey(0), jarch.model, jshape.d_feat)
    jstate = jts.TrainState(jp, jopt[0](jp))
    state = ts.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    g = jpipe.make_graph(256, 8, 32, 8)
    jb = {k: jax.numpy.asarray(v) for k, v in g.items()}
    b = {k: torch.from_numpy(v) for k, v in g.items()}
    b["csr"] = prepare_csr(b["edges"], 256)
    jstep = jax.jit(jts.make_train_step(jarch, jshape, optimizer=jopt))
    step = ts.make_train_step(arch, shape, optimizer=opt)
    for i in range(3):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        want = _leaves(jax.tree_util.tree_map(np.asarray, jstate.params))
        mine = param_tree(state.params)
        assert sorted(want) == sorted(mine)
        for name, t in mine.items():
            np.testing.assert_allclose(t.detach().numpy(), want[name],
                                       rtol=0, atol=1e-4,
                                       err_msg=f"step {i} {name}")


def test_train_loop_meets_the_reference_loss_bar():
    h = train.train_loop(ARCH, "full_graph_sm", steps=30, lr=1e-2,
                         device="cpu", verbose=False)
    assert len(h["losses"]) == 30
    assert h["losses"][-1] < h["losses"][0] * 0.8


def test_restart_resumes_bit_equal(tmp_path):
    """tests/test_fault_tolerance.py's case on the port: a run killed at
    step 12 and restarted resumes from its last checkpoint, ends at the
    same step, and its final state is bit-equal to the uninterrupted
    run's."""
    from repro_torch.checkpoint.ckpt import _flatten, latest_step
    from repro_torch.distributed.fault_tolerance import run_with_restarts
    kw = dict(steps=24, ckpt_every=6, verbose=False, device="cpu")
    ref = train.train_loop(ARCH, "full_graph_sm",
                           ckpt_dir=str(tmp_path / "ref"), **kw)
    restarts = []

    def segment(resume_step):
        h = train.train_loop(ARCH, "full_graph_sm",
                             ckpt_dir=str(tmp_path / "ft"),
                             fail_at_step=12 if not restarts else None, **kw)
        segment.hist = h
        return h["final_step"]

    final = run_with_restarts(segment, max_restarts=2,
                              on_restart=lambda n: restarts.append(n))
    assert final == 24 and restarts == [1]
    assert latest_step(str(tmp_path / "ft")) == 24
    assert segment.hist["losses"] == ref["losses"][12:]
    a, b = _flatten(ref["state"]), _flatten(segment.hist["state"])
    assert list(a) == list(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("shape", ["minibatch_lg", "molecule"])
def test_launcher_refuses_shapes_it_has_no_stream_for(shape):
    with pytest.raises(ValueError, match="sampled blocks" if shape ==
                       "minibatch_lg" else "batched graphs"):
        train.build_trainer(ARCH, shape, device="cpu")


def test_train_data_is_one_graph_with_its_csrs_on_the_device():
    arch, init, step, data = train.build_trainer(ARCH, "full_graph_sm",
                                                 device="cpu")
    b = data(0)
    assert data(7) is b
    want = jpipe.make_graph(256, 8, 32, 8)
    for k, v in want.items():
        np.testing.assert_array_equal(b[k].numpy(), v, err_msg=k)
    assert b["csr"].n_rows == 256 and b["csr"].n_edges == 2048
    assert arch.model.d_hidden == 32 and arch.model.n_classes == 8
    assert tuple(init().params.layers[0]["w_self"].shape) == (32, 32)
