"""Multi-process sharded AiSAQ search on the PyTorch/CUDA port — the
paper's Fig. 5 multi-server system as a local world of 8 processes (2 data
x 4 model), the port's `examples/distributed_search.py`.

    PYTHONPATH=src python examples/distributed_search_torch.py [--device cpu]

Each of the 4 `model`-axis ranks owns a dataset shard with its own
sub-index (exactly the paper's per-server layout); queries split over the
`data` axis; results merge via all-gather + global top-k. The ranks are
spawned gloo processes (a FileStore in a temporary directory), all on one
card (`cuda:0`) or, with `--device cpu`, on the CPU; each searches its
shard with the port's kernels on the card. Every wait and join has a time
limit, and a rank that raises fails the run with its traceback.

The codebooks start from the rows `core.build.draw_init_idx(n, 256, 0)`
picks, where the reference seeds them with `jax.random.PRNGKey(0)`: given
the reference's rows (`run(init_idx=...)`) the answer is the original's.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import pq
from repro_torch.core.build import draw_init_idx
from repro_torch.core.chunk_layout import ChunkLayout
from repro_torch.core.sharded_search import ShardedIndexArrays, stack_shards
from repro_torch.core.vamana import build_sharded
from repro_torch.data.vectors import make_clustered, make_queries
from repro_torch.device import resolve_device

WAIT_S = 600          # longest wait for the ranks to start and answer
SEARCH = dict(k=10, L=48, w=4, max_hops=64)       # each rank's search


def _rank(rank: int, world: int, store: str, job: dict, outbox) -> None:
    """One rank: join the gloo world, search its shard for its query block
    once to capture (the reference's compile), then once timed, with the
    kernels' launch counts read around the timed search."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    try:
        if job["device"] == "cuda":
            torch.cuda.set_device(0)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=WAIT_S))
        from repro_torch.core.sharded_search import (input_sharding,
                                                     sharded_search_fn)
        from repro_torch.kernels import _build
        from repro_torch.launch.mesh import make_test_grid
        grid = make_test_grid(job["grid"], ("data", "model"))
        search = sharded_search_fn(grid, layout=ChunkLayout(*job["layout"]),
                                   metric="l2", **job["search"])
        place_arrays, place_queries = input_sharding(grid,
                                                     device=job["device"])
        z = np.load(job["path"])
        arrays = place_arrays(ShardedIndexArrays(
            *(torch.from_numpy(z[f]) for f in ShardedIndexArrays._fields)))
        q = place_queries(z["queries"])
        search(arrays, q)                                # capture
        dist.barrier()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        ids, d = search(arrays, q)
        ids, d = ids.cpu().numpy(), d.cpu().numpy()
        dt = time.perf_counter() - t0
        outbox.put((rank, {"block": grid.index(("data",)), "ids": ids,
                           "d": d, "search_s": dt,
                           "launches": dict(_build.launch_counts)}))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        outbox.put((rank, traceback.format_exc()))


def _run_world(n: int, store: str, job: dict) -> dict:
    """`n` spawned ranks doing `job`; their answers by rank. Raises if a
    rank fails or does not answer in WAIT_S; stops every process."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    outbox = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, n, store, job, outbox),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    got, t_end = {}, time.time() + WAIT_S
    try:
        while len(got) < n:
            try:
                rank, ans = outbox.get(timeout=max(1.0, t_end - time.time()))
            except queue.Empty:
                raise RuntimeError(f"only ranks {sorted(got)} of {n} "
                                   f"answered in {WAIT_S} s") from None
            if isinstance(ans, str):
                raise RuntimeError(f"rank {rank} failed:\n{ans}")
            got[rank] = ans
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return got


def run(*, device=None, n=4000, d=48, m=12, R=20, nq=16, grid=(2, 4),
        init_idx=None, workdir=None) -> dict:
    """Train PQ, build one Vamana sub-index a `model` shard (in as many
    spawned processes, up to 4), stack the shards, and search them from a
    world of grid[0] * grid[1] ranks. Returns the gathered ids and
    distances (query blocks in order), recalls, each rank's answer (its
    block, ids, seconds and kernel launches) and the stacked arrays."""
    dev = resolve_device(device)
    base = make_clustered(n, d, seed=0)
    queries = make_queries(nq, base)
    gt = pq.groundtruth(queries, base, SEARCH["k"], device=dev)
    rows = draw_init_idx(n, 256, 0) if init_idx is None else init_idx
    cents = pq.train_codebooks(base, m=m, init_idx=rows, device=dev)
    codes = pq.encode(cents, base, device=dev)
    layout = ("aisaq", d, "float32", R, m)
    n_shards = grid[1]
    shards = build_sharded(base, n_shards, R=R, L=32, seed=0,
                           processes=min(4, n_shards))
    arrays = stack_shards(shards, cents, codes, ChunkLayout(*layout),
                          device=dev)
    arrays = ShardedIndexArrays(*(t.cpu().numpy() for t in arrays))
    with tempfile.TemporaryDirectory(prefix="dist_search_",
                                     dir=workdir) as tmp:
        path = os.path.join(tmp, "shards.npz")
        np.savez(path, queries=queries, **arrays._asdict())
        ranks = _run_world(
            grid[0] * grid[1], os.path.join(tmp, "store"),
            {"device": dev.type, "grid": tuple(grid), "layout": layout,
             "path": path, "search": SEARCH})
    blocks = {}
    for r, a in sorted(ranks.items()):
        if a["block"] in blocks and not np.array_equal(
                blocks[a["block"]]["ids"], a["ids"]):
            raise RuntimeError(f"ranks of query block {a['block']} "
                               "disagree")
        blocks.setdefault(a["block"], a)
    ids = np.concatenate([blocks[b]["ids"] for b in sorted(blocks)])
    dists = np.concatenate([blocks[b]["d"] for b in sorted(blocks)])
    return {"n": n, "grid": tuple(grid), "n_shards": n_shards,
            "queries": queries, "gt": gt, "ids": ids, "d": dists,
            "recall1": pq.recall_at(ids, gt, 1),
            "recall10": pq.recall_at(ids, gt, SEARCH["k"]),
            "batch_ms": max(a["search_s"] for a in ranks.values()) * 1e3,
            "ranks": ranks, "arrays": arrays, "layout": layout,
            "search": SEARCH}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where PQ and the ranks' searches run")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    g = out["grid"]
    print(f"== {out['n']} vectors over {out['n_shards']} index shards, "
          f"{g[0] * g[1]} ranks ==")
    print(f"recall@1 = {out['recall1']:.3f}   "
          f"recall@10 = {out['recall10']:.3f}")
    print(f"batch latency {out['batch_ms']:.1f} ms for "
          f"{out['queries'].shape[0]} queries across {out['n_shards']} "
          f"shards x {g[0]} query groups")
    print("per-shard fast-tier residency is (R + n_ep) codes + centroids — "
          "independent of shard size (the paper's scale-out claim)")


if __name__ == "__main__":
    main()
