"""The port's dry run (`repro_torch.launch.dryrun`) and the sharded serve
steps it traces, on the CPU.

- Eight cells at full production widths on the fake 256-rank world (meta
  tensors, one subprocess: the fake process group stays out of this
  process): qwen3-1.7b decode_32k, dcn-v2 serve_p99, graphsage-reddit
  full_graph_sm, aisaq-sift1b serve_q1k and the four recommenders'
  train_batch. Each record has every section without an error, its
  argument bytes are the rank's blocks (`inputs.local_bytes`), its
  collectives are those of the step, and each record carries the
  reference's peak, temp and alias bytes (alias: the donated state or
  cache), bytes accessed and transcendentals, with their notes (the ANN
  cell's through the stand-ins of its kernels, `launch.ann_trace`). The
  training cells' sparse gradients trace through the dry run's own
  sparse meta kernels, which importing the served modules does not
  register.
- The collective recorder (`launch.mesh.record_collectives`) on a real
  world of 4 gloo CPU ranks against the same steps of reduced archs on a
  fake 4-rank world with meta tensors (a subprocess): equal counts and
  bytes for a tiny LM's sharded train step, sequence-parallel decode, a
  tiny DCN-v2's row-sharded serve step and the pipeline's forward.
- The sharded `rec_retrieval` step on 4 gloo ranks against the unsharded
  `retrieval_topk`: equal ids (row-sharded and tablewise placements).
- Sequence-parallel decode (the KV cache cut over `model`) on 4 gloo
  ranks against the unsharded `lm_decode_step`: logits within 1e-5, the
  new keys and values written at the same place within 1e-5 and the rest
  of the cache unchanged (full and sliding attention).

Every wait has a limit; the ranks import only torch and the port.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import ProcessGrid, record_collectives
from torch_world import World

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HERE = os.path.dirname(__file__)

DRY_CELLS = [("qwen3-1.7b", "decode_32k"), ("dcn-v2", "serve_p99"),
             ("graphsage-reddit", "full_graph_sm"),
             ("aisaq-sift1b", "serve_q1k"), ("dlrm-rm2", "train_batch"),
             ("sasrec", "train_batch"), ("dcn-v2", "train_batch"),
             ("wide-deep", "train_batch")]


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]))
    env.pop("REPRO_GNN", None)
    env.pop("REPRO_MB_BUDGET_GB", None)
    return env


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    code = ("import sys\nfrom repro_torch.launch import dryrun\n"
            "for a, s in %r:\n"
            "    assert dryrun.main(['--arch', a, '--shape', s, '--out', "
            "sys.argv[1]]) == 0\n" % (DRY_CELLS,))
    r = subprocess.run([sys.executable, "-c", code, out], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    got = {}
    for a, s in DRY_CELLS:
        with open(os.path.join(out, f"{a}__{s}__pod1.json")) as f:
            got[(a, s)] = json.load(f)
    return got


@pytest.mark.parametrize("arch_id,shape_name", DRY_CELLS,
                         ids=[f"{a}-{s}" for a, s in DRY_CELLS])
def test_dryrun_record_on_the_fake_256_rank_world(records, arch_id,
                                                  shape_name):
    rec = records[(arch_id, shape_name)]
    assert rec["n_devices"] == 256 and rec["mesh"] == [16, 16]
    assert rec["mesh_axes"] == ["data", "model"]
    for section in ("memory", "cost", "collectives"):
        assert "error" not in rec[section], (section, rec[section])
    grid = ProcessGrid((16, 16), ("data", "model"), rank=0)
    cell = I.build_cell(arch_id, shape_name, grid)
    assert rec["memory"]["argument_size_in_bytes"] == I.local_bytes(cell,
                                                                   grid)
    assert rec["meta"]["model_flops"] == cell.meta["model_flops"]
    coll = rec["collectives"]
    mem, cost = rec["memory"], rec["cost"]
    # the reference's memory and cost fields: temp is the peak less the
    # outputs the step made; alias the outputs in argument storage (the
    # cache written in place, the trained state)
    made = mem["output_size_in_bytes"] - mem["alias_size_in_bytes"]
    assert mem["temp_size_in_bytes"] == max(0, mem["peak_bytes"] - made)
    assert 0 < mem["peak_bytes"] < 80e9
    assert cost["bytes accessed"] > mem["peak_bytes"]
    assert cost["transcendentals"] >= 0
    assert mem["peak_note"].startswith(dryrun.PEAK_NOTE)
    assert cost["note"].startswith(dryrun.BYTES_NOTE)
    donated = sum(I._block(t, s, grid, None).numel() * t.element_size()
                  for p, t, s in I.arg_leaves(cell)
                  if int(p.split("/")[0]) in cell.donate)
    assert mem["alias_size_in_bytes"] == donated
    if arch_id == "aisaq-sift1b":
        # mode B: 256 shards, the 1,024 queries replicated and searched
        # in 8 chunks of 128, traced through the kernels' stand-ins (one
        # hop a chunk); two gathers of (256, 1024, 10) int32 / float32
        assert rec["meta"]["mode"] == "B"
        assert dryrun.ANN_NOTE in mem["peak_note"]
        assert dryrun.ANN_NOTE in cost["note"]
        assert cost["hops_counted"] == 1
        assert cost["kernels"]["fused_hop_f32"]["launches"] == 8
        assert cost["kernels"]["pq_lut"]["launches"] == 8
        assert mem["output_size_in_bytes"] == 1024 * 10 * 8
        # every chunk's visited set: 128 queries x ceil(N_s / 32) int32
        # words, alive one chunk at a time
        cfg = get_arch(arch_id).model
        n_s = -(-cfg.n_vectors // 256)
        assert mem["peak_bytes"] > 128 * -(-n_s // 32) * 4
        assert coll == {"all-gather": {"count": 2,
                                       "bytes": 2 * 256 * 1024 * 10 * 4}}
        # the rank's shard of the chunk table, the centroids, its entry
        # points and offset, and all the queries
        from repro_torch.core.chunk_layout import layout_for
        stride = layout_for(cfg, "aisaq").device_stride
        assert rec["memory"]["argument_size_in_bytes"] == 4 * (
            -(-cfg.n_vectors // 256) * stride // 4 + cfg.dim * cfg.pq_ks
            + cfg.n_ep * (1 + cfg.pq_m) + 1 + 1024 * cfg.dim)
        return
    assert rec["cost"]["flops"] > 0
    ratio = rec["cost"]["flops_x_ranks_over_model"]
    assert ratio == pytest.approx(rec["cost"]["flops"] * 256
                                  / cell.meta["model_flops"])
    if arch_id == "qwen3-1.7b":
        # per layer: 7 leaves gathered at use, and the sequence-parallel
        # softmax's two all-reduces over `model`
        cfg = get_arch(arch_id).model
        assert coll["all-reduce"]["count"] == 2 * cfg.n_layers
        assert coll["all-gather"]["count"] > 7 * cfg.n_layers
        # the 16 ranks of a `model` group compute the same activations
        assert ratio > 8
    if (arch_id, shape_name) == ("dcn-v2", "serve_p99"):
        # the row-sharded tables' bags summed in one all-reduce over
        # `model`: the rank's 32 rows x 26 fields x 16 float32
        sharded = sum(1 for n, sp in cell.place.params.items()
                      if n.startswith("tables/") and any(sp))
        assert coll == {"all-reduce": {"count": 1,
                                       "bytes": 32 * sharded * 16 * 4}}
    if arch_id == "graphsage-reddit":
        assert set(coll) == {"all-gather", "all-reduce"}
    if shape_name == "train_batch":
        # the sparse gradients' nnz is an upper bound, and both sections
        # say so (the cost's and the peak's notes with the rest); the
        # gradients are averaged over `data`
        assert coll["note"] == dryrun.NNZ_NOTE
        assert dryrun.NNZ_NOTE in cost["note"]
        assert dryrun.NNZ_NOTE in mem["peak_note"]
        assert "upper bound" in coll["note"]
        assert coll["all-reduce"]["count"] > 0


_SERVED = """
import torch
import repro_torch.optim.adamw, repro_torch.models.recsys
import repro_torch.distributed.train_step
has = torch._C._dispatch_has_kernel_for_dispatch_key
print(has("aten::_coalesce", "SparseMeta"), has("aten::_to_dense",
                                                "SparseMeta"))
from repro_torch.launch import dryrun
dryrun.install_sparse_meta()
dryrun.install_sparse_meta()
print(has("aten::_coalesce", "SparseMeta"), has("aten::_to_dense",
                                                "SparseMeta"))
i = torch.empty((1, 7), dtype=torch.int64, device="meta")
g = torch.sparse_coo_tensor(i, torch.empty((7, 3), device="meta"), (10, 3))
c = g.coalesce()
print(c.is_coalesced(), tuple(c.indices().shape), tuple(c.values().shape),
      tuple(g.to_dense().shape), g.to_dense().layout)
"""


def test_sparse_meta_kernels_are_the_dry_runs_alone():
    """Importing the training and serving modules registers no SparseMeta
    coalesce or densify; `dryrun.install_sparse_meta` registers both (a
    second call is a no-op), the coalesce keeping its input's nnz."""
    r = subprocess.run([sys.executable, "-c", _SERVED], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-3:] == [
        "False False", "True True",
        "True (1, 7) (7, 3) (10, 3) torch.strided"]


# ---------------------------------------------------------------------------
# the recorder: a real gloo world against the fake one with meta tensors
# ---------------------------------------------------------------------------

def _tiny(arch_id: str, **kw):
    arch = get_arch(arch_id)
    return dataclasses.replace(arch, model=arch.model.scaled(**kw))


TINY_LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
               head_dim=16, d_ff=128, vocab_size=256, dtype="float32")


def recorded_steps(rank, device: str, seed: int = 0):
    """{step: {op: {count, bytes}}} of the four steps on a (2, 2) or
    (4, 1) grid of the live world, with real CPU tensors or meta ones."""
    from repro_torch.distributed import pipeline as PP
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.act_sharding import set_policy
    from repro_torch.distributed.train_step import (
        TrainState, default_optimizer, make_serve_step, make_train_step,
        placement, serve_placement, shard_params, shard_state)
    from repro_torch.launch.train import _make_init
    from repro_torch.models.transformer import init_cache

    def on(t):
        return torch.empty_like(t, device="meta") if device == "meta" \
            else t
    dev = torch.device(device)
    out = {}
    grid = ProcessGrid((2, 2), ("data", "model"))
    set_policy(grid)
    g = torch.Generator("cpu").manual_seed(seed)
    try:
        # a tiny LM's sharded train step
        arch = _tiny("qwen3-1.7b", **TINY_LM)
        shape = dataclasses.replace(arch.shape("train_4k"), seq_len=32,
                                    global_batch=4)
        init = _make_init(arch, shape, ep=2)
        opt_init, _ = default_optimizer()
        params = init(g, dev)
        state = TrainState(params, opt_init(params))
        place = placement("lm", grid, state)
        state = shard_state(state, place)
        rng = np.random.default_rng(seed)
        toks = torch.from_numpy(rng.integers(0, 256, (4, 33)).astype(
            np.int32))
        batch = {"tokens": on(toks[:, :-1]), "labels": on(toks[:, 1:])}
        step = make_train_step(arch, shape, grid=grid, place=place)
        with record_collectives() as rec:
            step(state, batch)
        out["lm_train"] = rec
        # sequence-parallel decode over `model` on the cache's blocks
        dshape = dataclasses.replace(arch.shape("decode_32k"), seq_len=64,
                                     global_batch=4)
        params = init(g, dev)
        params = shard_params(params, serve_placement(arch, dshape, grid,
                                                      params))
        cache = init_cache(arch.model, 4, 64, device=dev)
        spec = SH.P(None, ("data",), "model", None, None)
        cache = type(cache)(*(SH.shard(c, spec, grid).clone()
                              for c in cache))
        b = {"token": on(torch.arange(4, dtype=torch.int32)),
             "pos": on(torch.tensor(40, dtype=torch.int32))}
        with record_collectives() as rec:
            make_serve_step(arch, dshape, grid=grid)(params, cache, b)
        out["lm_decode"] = rec
        # a tiny DCN-v2 serving on row-sharded tables
        rarch = _tiny("dcn-v2", vocab_sizes=(3000, 5000, 100))
        rshape = dataclasses.replace(rarch.shape("serve_p99"), batch=8)
        rinit = _make_init(rarch, rshape)
        rp = rinit(g, dev)
        rp = shard_params(rp, placement("recsys", grid, TrainState(rp,
                                                                  None)))
        rb = {"dense": on(torch.from_numpy(rng.normal(size=(8, 13)).astype(
                  np.float32))),
              "sparse": on(torch.from_numpy(rng.integers(
                  0, 100, (8, 3, 1)).astype(np.int32)))}
        with record_collectives() as rec:
            make_serve_step(rarch, rshape, grid=grid)(rp, rb)
        out["rec_serve"] = rec
    finally:
        set_policy(None)
    # the pipeline's forward over 4 stages
    pgrid = PP.make_pp_grid(4, 1)
    w = torch.zeros((2, 8, 8), device=dev)
    x = torch.zeros((4, 2, 8), device=dev)
    with record_collectives() as rec:
        PP.pipeline_forward(pgrid, lambda p, h: torch.tanh(h @ p[0]) @ p[1],
                            4)(w, x)
    out["pipeline"] = rec
    return out


_FAKE = """
import json, sys
import torch.distributed as dist
from repro_torch.launch.mesh import fake_world
import test_torch_dryrun as T
fake_world(4, rank=int(sys.argv[1]))
print(json.dumps(T.recorded_steps(int(sys.argv[1]), "meta")))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("gloo_dryrun")))
    yield w
    w.close()


def test_recorder_counts_equal_on_gloo_and_on_the_fake_world(world):
    real = world.run(__name__, "recorded_steps", "cpu")
    for rank in (0, 3):
        r = subprocess.run([sys.executable, "-c", _FAKE, str(rank)],
                           env=_env(), capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        fake = json.loads(r.stdout.strip().splitlines()[-1])
        assert fake == real[rank], (rank, fake, real[rank])
    ops = real[0]
    assert set(ops["lm_train"]) == {"all-gather", "all-reduce"}
    assert ops["lm_decode"]["all-reduce"]["count"] == 2 * 2    # 2 layers
    assert set(ops["rec_serve"]) == {"all-reduce"}
    # stage 0 of 4 sends 4 microbatches and takes part in one broadcast
    assert ops["pipeline"]["collective-permute"]["count"] == 4
    assert ops["pipeline"]["broadcast"] == {"count": 1,
                                            "bytes": 4 * 2 * 8 * 4}


# ---------------------------------------------------------------------------
# the sharded retrieval step and sequence-parallel decode
# ---------------------------------------------------------------------------

def rank_retrieval(rank, arch_id: str, tablewise: bool):
    """(sharded ids, scores; unsharded ids, scores) of one user against
    600 candidates, the tables row-sharded over `model` of (2, 2) (or
    the small ones replicated with `tablewise`)."""
    from repro_torch.distributed.train_step import (
        TrainState, make_serve_step, placement, shard_params)
    from repro_torch.launch.train import _make_init
    from repro_torch.models import recsys as R
    grid = ProcessGrid((2, 2), ("data", "model"))
    kw = {"vocab_sizes": (3000, 5000, 100)} if arch_id != "sasrec" else \
        {"vocab_sizes": (6000,)}
    arch = _tiny(arch_id, **kw)
    shape = arch.shape("retrieval_cand")
    init = _make_init(arch, shape)
    full = init(torch.Generator("cpu").manual_seed(0), "cpu")
    ref = init(torch.Generator("cpu").manual_seed(0), "cpu")
    place = placement("recsys", grid, TrainState(full, None),
                      tablewise=tablewise)
    params = shard_params(full, place)
    rng = np.random.default_rng(1)
    cfg = arch.model
    b = {"cand_ids": torch.from_numpy(rng.choice(
        cfg.vocab_sizes[0], 600, replace=False).astype(np.int32))}
    if cfg.kind == "sasrec":
        b["seq"] = torch.from_numpy(rng.integers(
            1, cfg.vocab_sizes[0], (1, cfg.seq_len)).astype(np.int32))
    else:
        b["sparse"] = torch.from_numpy(np.stack(
            [rng.integers(0, v, (1, cfg.multi_hot)) for v in
             cfg.vocab_sizes], 1).astype(np.int32))
        if cfg.n_dense:
            b["dense"] = torch.from_numpy(rng.normal(
                size=(1, cfg.n_dense)).astype(np.float32))
    ids, vals = make_serve_step(arch, shape, grid=grid)(params, b)
    rids, rvals = R.retrieval_topk(ref, b, cfg, k=100)
    sharded = sum(1 for sp in place.params.values() if any(sp))
    return ids.numpy(), vals.numpy(), rids.numpy(), rvals.numpy(), sharded


@pytest.mark.parametrize("tablewise", [False, True],
                         ids=["row_sharded", "tablewise"])
@pytest.mark.parametrize("arch_id", ["sasrec", "dlrm-rm2", "dcn-v2",
                                     "wide-deep"])
def test_sharded_retrieval_equals_the_unsharded_topk(world, arch_id,
                                                     tablewise):
    got = world.run(__name__, "rank_retrieval", arch_id, tablewise)
    for ids, vals, rids, rvals, sharded in got.values():
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_allclose(vals, rvals, rtol=1e-5, atol=1e-5)
        assert (sharded > 0) != tablewise


def rank_sp_decode(rank, arch_id: str):
    """(sharded logits, the rank's cache block after the step; unsharded
    logits, that block of the unsharded cache) for a tiny LM decoding 4
    tokens at position 45 of a 64-long cache cut over `model` of (2, 2)
    (the batch over `data`)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.train_step import make_serve_step, \
        serve_placement, shard_params
    from repro_torch.launch.train import _make_init
    from repro_torch.models import transformer as T
    grid = ProcessGrid((2, 2), ("data", "model"))
    extra = {"window": 16} if arch_id == "h2o-danube-1.8b" else {}
    arch = _tiny(arch_id, **TINY_LM, **extra)
    shape = dataclasses.replace(arch.shape("decode_32k"), seq_len=64,
                                global_batch=4)
    init = _make_init(arch, shape)
    full = init(torch.Generator("cpu").manual_seed(0), "cpu")
    ref = init(torch.Generator("cpu").manual_seed(0), "cpu")
    params = shard_params(full, serve_placement(arch, shape, grid, full))
    rng = np.random.default_rng(2)
    kv = [torch.from_numpy(rng.normal(size=(2, 4, 64, 2, 16)).astype(
        np.float32)) for _ in range(2)]
    spec = SH.P(None, ("data",), "model", None, None)
    cache = T.DecodeCache(*(SH.shard(c, spec, grid).clone() for c in kv))
    rcache = T.DecodeCache(*(c.clone() for c in kv))
    token = torch.from_numpy(rng.integers(0, 256, 4).astype(np.int32))
    b = {"token": token, "pos": torch.tensor(45, dtype=torch.int32)}
    logits, cache = make_serve_step(arch, shape, grid=grid)(params, cache, b)
    rlogits, rcache = T.lm_decode_step(ref, rcache, token, 45, arch.model)
    bl = SH.block_slices((4,), SH.P(("data",)), grid)[0]
    lo = SH.block_slices((64,), SH.P("model"), grid)[0].start
    return (logits.numpy(), rlogits[bl].numpy(), cache.k.numpy(),
            SH.shard(rcache.k, spec, grid).numpy(), cache.v.numpy(),
            SH.shard(rcache.v, spec, grid).numpy(), lo)


@pytest.mark.parametrize("arch_id", ["qwen3-1.7b", "h2o-danube-1.8b"])
def test_sequence_parallel_decode_equals_the_unsharded_step(world, arch_id):
    got = world.run(__name__, "rank_sp_decode", arch_id)
    for logits, rlogits, k, rk, v, rv, lo in got.values():
        np.testing.assert_allclose(logits, rlogits, rtol=1e-5, atol=1e-5)
        # the rank holding position 45 wrote it (its keys and values from
        # the rank's rows of the batch: within float32 rounding of the
        # whole batch's product), every other entry is as it was
        at = 45 - lo
        for c, rc in ((k, rk), (v, rv)):
            if 0 <= at < c.shape[2]:
                np.testing.assert_allclose(c[:, :, at], rc[:, :, at],
                                           rtol=1e-5, atol=1e-5)
                c, rc = np.delete(c, at, 2), np.delete(rc, at, 2)
            np.testing.assert_array_equal(c, rc)


# ---------------------------------------------------------------------------
# the GNN's sampled-minibatch and batched-graph steps on a grid
# ---------------------------------------------------------------------------

def _gnn_batch(kind: str, rng):
    if kind == "gnn_minibatch":
        B, f1, f2, F = 8, 3, 2, 6
        return {"seed_feats": rng.normal(size=(B, F)),
                "nbr1_feats": rng.normal(size=(B, f1, F)),
                "nbr2_feats": rng.normal(size=(B, f1, f2, F)),
                "labels": rng.integers(0, 5, B)}, F
    G, n, e, F = 4, 6, 10, 6
    return {"feats": rng.normal(size=(G, n, F)),
            "edges": rng.integers(0, n, (G, e, 2)),
            "labels": rng.integers(0, 5, G)}, F


def rank_gnn_step(rank, kind: str):
    """{leaf: parameter} after two data-parallel steps on (2, 2) and after
    the unsharded steps on the whole batch, from one init; and the
    collectives of the data-parallel steps."""
    from repro_torch.distributed.train_step import (
        TrainState, default_optimizer, make_train_step, placement)
    from repro_torch.models.gnn import init_gnn
    from repro_torch.optim.adamw import param_tree
    arch = get_arch("graphsage-reddit")
    arch = dataclasses.replace(arch, model=arch.model.scaled(
        d_hidden=8, n_classes=5))
    shape = next(s for s in arch.shapes if s.kind == kind)
    rng = np.random.default_rng(3)
    raw, F = _gnn_batch(kind, rng)
    batch = {k: torch.from_numpy(np.asarray(
        v, np.int32 if k in ("labels", "edges") else np.float32))
        for k, v in raw.items()}
    opt_init, _ = default_optimizer(base_lr=1e-2)
    out, recs = [], []
    for grid in (ProcessGrid((2, 2), ("data", "model")), None):
        p = init_gnn(arch.model, F, generator=torch.Generator(
            "cpu").manual_seed(0), device="cpu")
        st = TrainState(p, opt_init(p))
        place = None if grid is None else placement("gnn", grid, st)
        step = make_train_step(arch, shape, grid=grid, place=place,
                               optimizer=default_optimizer(base_lr=1e-2))
        with record_collectives() as rec:
            for _ in range(2):
                step(st, batch)
        out.append({n: t.detach().numpy().copy()
                    for n, t in param_tree(st.params).items()})
        recs.append(rec)
    return out + recs[:1]


@pytest.mark.parametrize("kind", ["gnn_minibatch", "gnn_batched"])
def test_gnn_data_parallel_steps_equal_the_unsharded_step(world, kind):
    """The batch cut over `data` (2 blocks), the gradients averaged over
    dp: two steps give the unsharded steps' parameters (the mean of the
    blocks' mean losses is the batch's)."""
    got = world.run(__name__, "rank_gnn_step", kind)
    for sharded, whole, rec in got.values():
        # a step: each gradient leaf averaged over dp, the loss too, and
        # the clip's norm over the world
        assert rec["all-reduce"]["count"] == 2 * (len(whole) + 2)
        assert sharded.keys() == whole.keys()
        for n in whole:
            np.testing.assert_allclose(sharded[n], whole[n], rtol=1e-5,
                                       atol=1e-6, err_msg=n)
