"""The port's sharded device search (`repro_torch.core.sharded_search`, the
paper's Fig. 5 on torch.distributed) and `vamana.build_sharded` against
the JAX package's, on the CPU.

- `build_sharded`: byte-equal (offset, data, graph) triples (600 vectors,
  3 shards, R=12, L=24), also when built in 2 processes.
- `stack_shards`: every array equal to the reference's, an even and a
  ragged (padded) split.
- The merge: equal to `jax.lax.top_k(-d, k)` on hand-made (S, B, k)
  lists with ties within and across shards, -1 ids and +inf distances;
  `shard_math.merge_topk` (dist, then id) differs on them.
- `sharded_search_fn`: one module-scoped world of 4 spawned gloo CPU
  processes (every join and every wait with a timeout) against the
  reference's `sharded_search_fn` on 4 virtual XLA CPU devices in a
  subprocess (`backend="ref"`, as tests/test_distributed.py runs it), on
  grids (1, 4) and (2, 2), f32 and int8, with and without query_chunk, and
  mode B (queries replicated, shards over both axes). Ids equal;
  distances within rtol 1e-5, atol 1e-4.

jax is imported inside the tests: the spawned ranks import this module
and need only torch.
"""
import multiprocessing as mp
import os
import queue
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import sharded_search as ss
from repro_torch.core import vamana
from repro_torch.core.chunk_layout import ChunkLayout
from repro_torch.core.shard_math import merge_topk

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD = 4
WAIT_S = 180              # longest wait for one case's answers
N, DIM, R, M = 1200, 32, 16, 8
N_Q = 16
SEARCH = dict(k=10, L=48, w=4, max_hops=64, metric="l2")
RTOL, ATOL = 1e-5, 1e-4

# (name, grid, query_axes, shard_axes, shards built, adc, query_chunk)
CASES = (
    ("1x4_f32", (1, 4), ("data",), ("model",), 4, "f32", 0),
    ("1x4_int8_chunked", (1, 4), ("data",), ("model",), 4, "int8", 8),
    ("2x2_f32_chunked", (2, 2), ("data",), ("model",), 2, "f32", 4),
    ("2x2_int8", (2, 2), ("data",), ("model",), 2, "int8", 0),
    ("2x2_modeB_f32_chunked", (2, 2), (), ("data", "model"), 4, "f32", 8),
    ("2x2_modeB_int8", (2, 2), (), ("data", "model"), 4, "int8", 0),
)


def _layout():
    return ChunkLayout("aisaq", DIM, "float32", R, M)


# ---------------------------------------------------------------------------
# build_sharded and stack_shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("processes", [1, 2])
def test_build_sharded_is_byte_equal_to_the_reference(processes):
    from repro.core import vamana as jvamana
    from repro_torch.data.vectors import make_clustered
    data = make_clustered(600, 16, seed=3)
    mine = vamana.build_sharded(data, 3, R=12, L=24, seed=0,
                                processes=processes)
    theirs = jvamana.build_sharded(data, 3, R=12, L=24, seed=0)
    assert len(mine) == len(theirs) == 3
    for (o, d, g), (jo, jd, jg) in zip(mine, theirs):
        assert o == jo and type(o) is type(jo)
        assert d.dtype == jd.dtype and d.tobytes() == jd.tobytes()
        assert g.dtype == jg.dtype and g.shape == jg.shape
        assert g.tobytes() == jg.tobytes()
    assert list(vamana.shard_bounds(600, 3)) == [0, 200, 400, 600]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference's corpus, PQ and sharded builds (4 and 2 shards),
    and the port's stacked arrays of each, written for the ranks and the
    reference subprocess."""
    import jax
    from repro.core import pq
    from repro.core.vamana import build_sharded
    from repro.data.vectors import make_clustered, make_queries
    base = make_clustered(N, DIM, seed=0)
    q = make_queries(N_Q, base)
    cb = pq.train_codebooks(jax.random.PRNGKey(0), base, m=M, iters=6)
    cents = np.asarray(cb.centroids)
    codes = np.asarray(pq.encode(cb, base))
    shards = {s: build_sharded(base, s, R=R, L=32, seed=0) for s in (4, 2)}
    path = str(tmp_path_factory.mktemp("sharded") / "corpus.npz")
    arrays = {}
    for s, sh in shards.items():
        a = ss.stack_shards(sh, cents, codes, _layout(), device="cpu")
        arrays[s] = a
        for f in a._fields:
            arrays[f"{f}_{s}"] = getattr(a, f).numpy()
    np.savez(path, base=base, queries=q, cents=cents, codes=codes,
             **{k: v for k, v in arrays.items() if isinstance(k, str)})
    return dict(path=path, base=base, queries=q, cents=cents, codes=codes,
                shards=shards, arrays=arrays)


@pytest.mark.parametrize("n_shards", [4, 2, 3])
def test_stack_shards_arrays_equal_the_reference(corpus, n_shards):
    """4 and 2 shards split 1200 rows evenly; 3 shards of 1,000 rows
    (333 / 333 / 334) pad the first two with one zero row."""
    from repro.core.chunk_layout import ChunkLayout as JLayout
    from repro.core.sharded_search import stack_shards as jstack
    from repro.core.vamana import build_sharded
    if n_shards == 3:
        sh = build_sharded(corpus["base"][:1000], 3, R=R, L=32, seed=0)
    else:
        sh = corpus["shards"][n_shards]
    want = jstack(sh, corpus["cents"], corpus["codes"],
                  JLayout("aisaq", DIM, "float32", R, M))
    got = ss.stack_shards(sh, corpus["cents"], corpus["codes"], _layout(),
                          device="cpu")
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    if n_shards == 3:
        assert got.chunk_words.shape[1] == 334
        assert not got.chunk_words[0, 333].any()


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------


def _merge_cases():
    inf = np.inf
    # (S=3, B=3, k=4): row 0 ties inside shard 1 with its ids out of order
    # (7 before 5) and across shards 0 and 2 at 2.0; row 1 has -1/+inf
    # padding in two shards; row 2 is all ties at 1.0
    ids = np.array([
        [[10, 11, 12, 13], [20, 21, -1, -1], [30, 31, 32, 33]],
        [[7, 5, 8, 9], [40, -1, -1, -1], [4, 6, 3, 2]],
        [[1, 2, 3, 4], [9, 8, 7, 6], [0, 11, 12, 13]]], np.int32)
    d = np.array([
        [[0.5, 2.0, 3.0, 4.0], [0.25, 5.0, inf, inf], [1.0, 1.5, 6.0, 7.0]],
        [[1.0, 1.0, 2.0, 9.0], [0.5, inf, inf, inf], [2.0, 2.0, 3.0, 3.0]],
        [[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0]]],
        np.float32)
    return ids, d


@pytest.mark.parametrize("k", [1, 4, 7, 12])
def test_merge_is_lax_top_k_not_merge_topk(k):
    """The hand-made lists are (B, S, k) per query; the device tier sees
    them as (S, B, k). Equal to lax.top_k(-d) over the shard-major
    concatenation, ids and distances, for every k up to S*k."""
    import jax
    import jax.numpy as jnp
    ids, d = _merge_cases()                    # (B, S, kk)
    all_ids = np.ascontiguousarray(ids.transpose(1, 0, 2))
    all_d = np.ascontiguousarray(d.transpose(1, 0, 2))
    got_ids, got_d = ss.merge_shards(torch.from_numpy(all_ids),
                                     torch.from_numpy(all_d), k)
    flat_ids = ids.reshape(ids.shape[0], -1)
    flat_d = d.reshape(d.shape[0], -1)
    negd, pos = jax.lax.top_k(-jnp.asarray(flat_d), k)
    np.testing.assert_array_equal(
        got_ids.numpy(), np.take_along_axis(flat_ids, np.asarray(pos), 1))
    np.testing.assert_array_equal(got_d.numpy(), -np.asarray(negd))
    if k == 4:
        # row 1: the two 1.0 ties of shard 0 come as listed (7, 5), and
        # the 2.0 tie goes to shard 0's 8 before shard 2's ids 4 and 6
        assert got_ids[1].tolist() == [40, 7, 5, 8]
        # merge_topk breaks the same ties by id: 5 before 7, and the 2.0
        # tie to shard 2's id 4 before shard 0's 8
        m_ids, _ = merge_topk(list(ids[1]), list(d[1]), 4)
        assert m_ids.tolist() == [40, 5, 7, 4]


# ---------------------------------------------------------------------------
# the sharded search against the reference's
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.core.chunk_layout import ChunkLayout
from repro.core.sharded_search import (ShardedIndexArrays, sharded_search_fn,
                                       input_sharding)
from repro.launch.mesh import make_mesh_compat
src, out, cases, search = sys.argv[1], sys.argv[2], eval(sys.argv[3]), \
    eval(sys.argv[4])
z = np.load(src)
lay = ChunkLayout('aisaq', %(dim)d, 'float32', %(R)d, %(M)d)
res = {}
for name, grid, qaxes, saxes, n_sh, adc, chunk in cases:
    arrays = ShardedIndexArrays(*(jnp.asarray(z[f + '_' + str(n_sh)])
                                  for f in ShardedIndexArrays._fields))
    mesh = make_mesh_compat(grid, ('data', 'model'))
    fn = sharded_search_fn(mesh, layout=lay, backend='ref',
                           query_axes=qaxes or (None,), shard_axes=saxes,
                           query_chunk=chunk, adc_dtype=adc, **search)
    ash, qsh = input_sharding(mesh, query_axes=qaxes or (None,),
                              shard_axes=saxes)
    arrays = jax.tree.map(lambda a, s: jax.device_put(a, s), arrays, ash)
    q = jax.device_put(jnp.asarray(z['queries']), qsh)
    ids, d = jax.jit(fn)(arrays, q)
    res[name + '_ids'] = np.asarray(ids)
    res[name + '_d'] = np.asarray(d)
np.savez(out, **res)
print('reference cases', len(cases))
""" % dict(dim=DIM, R=R, M=M)


@pytest.fixture(scope="module")
def reference(corpus, tmp_path_factory):
    """The reference's answers to every case, from one subprocess with 4
    virtual CPU devices."""
    out = str(tmp_path_factory.mktemp("sharded_ref") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, corpus["path"],
                        out, repr(CASES), repr(SEARCH)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    return dict(np.load(out))


def _rank_case(rank: int, case, path: str):
    """One rank's answer to one case: (its query block, ids, d)."""
    name, shape, qaxes, saxes, n_sh, adc, chunk = case
    z = np.load(path)
    grid = ss.ProcessGrid(shape)
    arrays = ss.ShardedIndexArrays(*(torch.from_numpy(z[f"{f}_{n_sh}"])
                                     for f in ss.ShardedIndexArrays._fields))
    place_arrays, place_queries = ss.input_sharding(
        grid, query_axes=qaxes, shard_axes=saxes, device="cpu")
    fn = ss.sharded_search_fn(grid, layout=_layout(), backend="auto",
                              query_axes=qaxes, shard_axes=saxes,
                              query_chunk=chunk, adc_dtype=adc, **SEARCH)
    ids, d = fn(place_arrays(arrays), place_queries(z["queries"]))
    return grid.index(qaxes), grid.size(qaxes), ids.numpy(), d.numpy()


def _rank_main(rank: int, store: str, inbox, outbox) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        while True:
            job = inbox.get(timeout=WAIT_S * 4)
            if job is None:
                break
            try:
                outbox.put((rank, _rank_case(rank, *job)))
            except Exception as e:              # reported, not hung
                outbox.put((rank, f"{type(e).__name__}: {e}"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """4 spawned gloo ranks on the CPU, started once; `run(case, path)`
    sends a case to every rank and returns their answers by rank."""
    ctx = mp.get_context("spawn")
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    inboxes = [ctx.Queue() for _ in range(WORLD)]
    outbox = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, store, inboxes[r],
                                                  outbox), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()

    def run(case, path):
        for box in inboxes:
            box.put((case, path))
        got = {}
        while len(got) < WORLD:
            try:
                rank, ans = outbox.get(timeout=WAIT_S)
            except queue.Empty:
                raise AssertionError(f"{case[0]}: ranks {sorted(got)} "
                                     f"answered in {WAIT_S} s") from None
            assert not isinstance(ans, str), f"rank {rank}: {ans}"
            got[rank] = ans
        return got

    yield run
    for box in inboxes:
        box.put(None)
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_search_matches_the_reference(world, corpus, reference, case):
    name = case[0]
    got = world(case, corpus["path"])
    want_ids, want_d = reference[name + "_ids"], reference[name + "_d"]
    assert want_ids.shape == (N_Q, SEARCH["k"])
    rows = N_Q // got[0][1]
    blocks = {}
    for rank, (block, _, ids, d) in got.items():
        sl = slice(block * rows, (block + 1) * rows)
        assert ids.shape == (rows, SEARCH["k"]) and ids.dtype == np.int32
        np.testing.assert_array_equal(ids, want_ids[sl],
                                      err_msg=f"{name} rank {rank}")
        np.testing.assert_allclose(d, want_d[sl], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} rank {rank}")
        blocks[block] = ids
    # the blocks cover every query, and the answer is a good one (the
    # repo's search-level recall limit)
    from repro_torch.core.pq import groundtruth, recall_at
    full = np.concatenate([blocks[b] for b in sorted(blocks)])
    gt = groundtruth(corpus["queries"], corpus["base"], 10, device="cpu")
    assert full.shape == (N_Q, SEARCH["k"])
    assert recall_at(full, gt, 10) >= 0.8


def test_grid_refuses_without_a_world():
    """The grid needs an initialised world; outside one it refuses."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        ss.ProcessGrid((1, 4))


def test_stack_shards_and_input_sharding_need_a_card_or_device_cpu(corpus):
    """Like every entry point, stack_shards places its tensors on the card
    unless asked for the CPU, and raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    sh = corpus["shards"][2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ss.stack_shards(sh, corpus["cents"], corpus["codes"], _layout())
    got = ss.stack_shards(sh, corpus["cents"], corpus["codes"], _layout(),
                          device="cpu")
    assert got.chunk_words.device.type == "cpu"
