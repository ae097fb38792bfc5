"""The port's checkpoints, restart and training loop
(`repro_torch.checkpoint.ckpt`, `distributed.fault_tolerance`,
`launch.train`) against the JAX package at the reference's tiny scale.

Tolerances:
  * checkpoints: each package restores the other's leaf for leaf,
    bit-equal; the port's files are byte-equal to the reference's for the
    same state, the manifest equal apart from its `time`;
  * 10 steps of `train_loop` from the reference's initial state: every
    loss within 1e-4 of the reference's;
  * restart after an injected failure: the final parameters and optimizer
    state bit-equal to an uninterrupted run's.
"""
import dataclasses
import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_arch as jget_arch
from repro.distributed import train_step as jts
from repro.launch import train as jtrain
from repro.models import recsys as jrec
from repro_torch.checkpoint import ckpt
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import train_step as ts
from repro_torch.launch import train
from repro_torch.optim import adamw

ARCHS = ("sasrec", "dlrm-rm2", "dcn-v2", "wide-deep")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(aid, steps=10, lr=3e-3):
    """The reference's initial train state of `train_loop(aid, scale=
    "tiny", steps=steps)`: PRNGKey(0) parameters and a fresh OptState."""
    jarch = jget_arch(aid)
    jarch = dataclasses.replace(jarch, model=jarch.model.scaled(
        vocab_sizes=tuple(min(v, 2000) for v in jarch.model.vocab_sizes)))
    p = jrec.init_recsys(jax.random.PRNGKey(0), jarch.model)
    init, _ = jts.default_optimizer(total_steps=steps, base_lr=lr)
    return jts.TrainState(p, init(p))


def _jax_leaves(state):
    flat, _ = jckpt._flatten(_np_tree(state))
    return flat


def _port_leaves(state):
    return {n: (t.detach().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t))
            for n, t in ckpt._flatten(state).items()}


def _assert_same(a: dict, b: dict):
    assert list(a) == list(b)
    for n in a:
        assert a[n].dtype == b[n].dtype and a[n].shape == b[n].shape, n
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


@pytest.fixture(scope="module", params=ARCHS)
def states(request):
    jstate = _jax_state(request.param)
    # a state that has trained: nonzero moments and step
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree_util.tree_map(lambda x: x + 0.5, jstate.opt.m),
        v=jax.tree_util.tree_map(lambda x: x + 0.25, jstate.opt.v)))
    return request.param, jstate, ts.train_state_from_jax(
        _np_tree(jstate), device="cpu")


def test_port_names_every_leaf_as_the_reference(states):
    _, jstate, state = states
    _assert_same(_port_leaves(state), _jax_leaves(jstate))
    names = list(_port_leaves(state))
    assert ".params/item_proj" in names and ".opt/.step" in names
    assert any(n.startswith(".opt/.master/") for n in names)


def test_port_files_are_byte_equal_to_the_reference(states, tmp_path):
    _, jstate, state = states
    jdir = jckpt.save(str(tmp_path / "jax"), jstate, step=3,
                      extra_meta={"arch": "x"})
    pdir = ckpt.save(str(tmp_path / "port"), state, step=3,
                     extra_meta={"arch": "x"})
    assert os.path.basename(jdir) == os.path.basename(pdir) == \
        "step_00000003"
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(pdir))
    for fn in files:
        if fn != "manifest.json":
            assert filecmp.cmp(os.path.join(jdir, fn), os.path.join(pdir, fn),
                               shallow=False), fn
    jm, pm = (json.load(open(os.path.join(d, "manifest.json")))
              for d in (jdir, pdir))
    jm.pop("time"), pm.pop("time")
    assert json.dumps(jm) == json.dumps(pm)       # same keys, same order


def test_each_package_restores_the_others_checkpoint(states, tmp_path):
    aid, jstate, state = states
    jckpt.save(str(tmp_path / "jax"), jstate, step=3)
    like = ts.train_state_from_jax(_np_tree(_jax_state(aid)), device="cpu")
    got = ckpt.restore(str(tmp_path / "jax"), like, device="cpu")
    assert got.params is like.params             # restored in place
    _assert_same(_port_leaves(got), _jax_leaves(jstate))
    ckpt.save(str(tmp_path / "port"), state, step=3)
    back = jckpt.restore(str(tmp_path / "port"), _jax_state(aid))
    _assert_same(_jax_leaves(back), _port_leaves(state))


def test_restore_fills_a_live_state_in_place_or_a_meta_skeleton(
        states, tmp_path, monkeypatch):
    """A live state's tensors are overwritten where they lie (a resume
    holds no second copy); a skeleton on the meta device, which a resumed
    `train_loop` restores into, gets new tensors on the device. Each leaf
    crosses in slabs of rows (here a few bytes each)."""
    aid, _, state = states
    monkeypatch.setattr(ckpt, "_SLAB_BYTES", 100)
    ckpt.save(str(tmp_path), state, step=3)
    like = ts.train_state_from_jax(_np_tree(_jax_state(aid)), device="cpu")
    ptrs = {n: t.data_ptr() for n, t in ckpt._flatten(like).items()
            if t.numel()}
    got = ckpt.restore(str(tmp_path), like, device="cpu")
    assert {n: t.data_ptr() for n, t in ckpt._flatten(got).items()
            if t.numel()} == ptrs
    _assert_same(_port_leaves(got), _port_leaves(state))
    _, state_init, _, _ = train.build_trainer(aid, "train_batch",
                                              device="cpu")
    skeleton = state_init(device="meta")
    got = ckpt.restore(str(tmp_path), skeleton, device="cpu")
    assert all(t.device.type == "cpu" for t in ckpt._flatten(got).values())
    assert all(p.requires_grad for p in got.params.parameters())
    _assert_same(_port_leaves(got), _port_leaves(state))


def test_bfloat16_leaves_cross_as_raw_bits(tmp_path):
    bits = np.arange(-3, 9, dtype=np.float32)
    jtree = {"w": jnp.asarray(bits, jnp.bfloat16), "s": jnp.ones(2)}
    jckpt.save(str(tmp_path / "jax"), jtree, step=1)
    like = {"w": torch.zeros(12, dtype=torch.bfloat16), "s": torch.zeros(2)}
    got = ckpt.restore(str(tmp_path / "jax"), like, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.from_numpy(bits))
    ckpt.save(str(tmp_path / "port"), got, step=2)
    m = json.load(open(tmp_path / "port" / "step_00000002" /
                       "manifest.json"))
    assert m["leaves"]["w"]["dtype"] == "bfloat16"
    assert filecmp.cmp(tmp_path / "jax" / "step_00000001" / "w.npy",
                       tmp_path / "port" / "step_00000002" / "w.npy",
                       shallow=False)
    back = jckpt.restore(str(tmp_path / "port"), jtree)
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32), bits)


def test_latest_step_skips_unfinished_saves(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d + "/none") is None
    ckpt.save(d, {"a": torch.ones(2)}, step=4)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_00000008"))      # no manifest
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 4
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), {"a": torch.ones(2)},
                     device="cpu")


def test_async_save_snapshots_before_returning(tmp_path):
    t = torch.zeros(1000)
    ck = ckpt.AsyncCheckpointer()
    ck.save(str(tmp_path), {"t": t}, step=1)
    t.add_(1.0)                  # the next step updates in place
    ck.wait()
    got = ckpt.restore(str(tmp_path), {"t": t}, device="cpu")
    assert torch.equal(got["t"], torch.zeros(1000))
    assert ck.last_path.endswith("step_00000001")


# ---------------------------------------------------------------------------
# the training loop, restart and fault tolerance
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_losses(aid):
    return tuple(jtrain.train_loop(aid, "train_batch", steps=10,
                                   scale="tiny", verbose=False)["losses"])


@pytest.mark.parametrize("route", ["checkpoint", "state"])
@pytest.mark.parametrize("aid", ARCHS)
def test_train_loop_losses_match_the_reference(aid, route, tmp_path):
    """The port starts from the reference's initial state, written as a
    JAX checkpoint at step 0 (which it resumes from) or carried across by
    `train_state_from_jax`, and takes the reference's 10 steps."""
    kw = dict(steps=10, scale="tiny", verbose=False, device="cpu")
    if route == "checkpoint":
        jckpt.save(str(tmp_path), _jax_state(aid), step=0)
        hist = train.train_loop(aid, "train_batch", ckpt_dir=str(tmp_path),
                                ckpt_every=4, **kw)
        assert ckpt.latest_step(str(tmp_path)) == 10
        assert sorted(os.listdir(tmp_path)) == [
            "heartbeat_0.json", "step_00000000", "step_00000004",
            "step_00000008", "step_00000010"]
    else:
        hist = train.train_loop(aid, "train_batch", init_state=ts.
                                train_state_from_jax(_np_tree(_jax_state(
                                    aid)), device="cpu"), **kw)
    assert len(hist["losses"]) == 10
    np.testing.assert_allclose(hist["losses"], _reference_losses(aid),
                               rtol=0, atol=1e-4)


def test_restart_after_a_failure_resumes_bit_equal(tmp_path):
    kw = dict(steps=10, scale="tiny", verbose=False, device="cpu",
              ckpt_every=4)
    whole = train.train_loop("sasrec", "train_batch", **kw)
    calls = []

    def segment(resume_step):
        calls.append(resume_step)
        hist = train.train_loop("sasrec", "train_batch",
                                ckpt_dir=str(tmp_path),
                                fail_at_step=6 if len(calls) == 1 else None,
                                **kw)
        segment.hist = hist
        return hist["final_step"]

    assert ft.run_with_restarts(segment, max_restarts=1) == 10
    assert calls == [None, 6]
    assert segment.hist["losses"] == whole["losses"][4:]
    _assert_same(_port_leaves(segment.hist["state"]),
                 _port_leaves(whole["state"]))
    hb = json.load(open(tmp_path / "heartbeat_0.json"))
    assert hb["step"] == 9
    assert ft.Heartbeat.dead_workers(str(tmp_path), timeout_s=3600) == []
    assert ft.Heartbeat.dead_workers(str(tmp_path), timeout_s=-1) == [
        "heartbeat_0.json"]


def test_run_with_restarts_gives_up_after_max_restarts():
    seen = []

    def always_fails(resume):
        err = ft.WorkerFailure("down")
        err.last_step = len(seen)
        seen.append(resume)
        raise err
    with pytest.raises(ft.WorkerFailure):
        ft.run_with_restarts(always_fails, max_restarts=2,
                             on_restart=lambda n: seen.append(f"r{n}"))
    assert seen == [None, "r1", 0, "r2", 2]


def test_state_to_copies_the_state():
    _, state_init, _, _ = train.build_trainer("dcn-v2", "train_batch",
                                              device="cpu")
    a = state_init()
    b = ts.state_to(a, "cpu")
    _assert_same(_port_leaves(a), _port_leaves(b))
    adamw.param_tree(b.params)["item_proj"].data.add_(1.0)
    b.opt.step.add_(1)
    assert int(a.opt.step) == 0
    assert not torch.equal(adamw.param_tree(a.params)["item_proj"],
                           adamw.param_tree(b.params)["item_proj"])
