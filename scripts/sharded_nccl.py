#!/usr/bin/env python3
"""The sharded device search with one rank a card over NCCL (the paper's
Fig. 5 as four servers), against the same search with the four ranks
sharing one card over gloo and the unsharded search on one card.

    python3 scripts/sharded_nccl.py        # needs 4 CUDA cards

The 1M-vector corpus of `chip_smoke.py`'s deployment phase (SIFT1M
widths, PQ trained on the first card) in 4 shards of 250,000 rows, each
over its own random R-regular graph (seeded by its rank; recall is not
judged, as at 1M); grid (1, 4) with the queries replicated, f32, k=100,
batches 64 and 256. Prints one `[sharded_nccl]` line a batch and world:
wall, QPS, each rank's search alone and the gather, and whether the ids
equal the same shards searched one after another on the first card and
merged. Fails if they differ or if a rank launched no `fused_hop`.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

N, SHARDS, BATCHES = 1_000_000, 4, (64, 256)


def one_process(paths: dict, k: int) -> dict:
    """The four shards packed on the first card (the ranks' own graphs)
    and searched one after another, merged: ids by batch."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.chunk_layout import layout_for
    from repro_torch.core.sharded_search import stack_shards
    from repro_torch.core.vamana import random_regular_graph, shard_bounds
    base = np.load(paths["base"], mmap_mode="r")
    codes = np.load(paths["codes"], mmap_mode="r")
    cents = np.load(paths["cents"])
    queries = np.load(paths["queries"])
    b = shard_bounds(N, SHARDS)
    shards = [(int(b[r]), np.ascontiguousarray(base[b[r]:b[r + 1]]),
               random_regular_graph(int(b[r + 1] - b[r]), cfg.R, seed=r,
                                    device="cuda"))
              for r in range(SHARDS)]
    arrays = stack_shards(shards, cents, codes, layout_for(cfg),
                          device="cuda")
    del shards
    indexes = cs.shard_indexes(arrays)
    out = {nq: cs.one_process_merge(
        indexes, torch.from_numpy(queries[:nq]).cuda(), k, "f32")
        for nq in BATCHES}
    del indexes, arrays
    torch.cuda.empty_cache()
    return out


def unsharded_ms(paths: dict, k: int) -> dict:
    """The whole 1M table on the first card over one random graph."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.device_index import from_arrays
    from repro_torch.core.vamana import random_regular_graph
    base = np.load(paths["base"])
    graph = random_regular_graph(N, cfg.R, seed=0, device="cuda")
    idx, lay = from_arrays(base, graph, np.load(paths["cents"]),
                           np.load(paths["codes"]), device="cuda")
    del graph
    out = cs.unsharded_search_ms(idx, lay, np.load(paths["queries"]), k)
    del idx
    torch.cuda.empty_cache()
    return out


def world_run(root: str, backend: str, paths: dict, want: dict, k: int):
    world = cs.RankWorld(SHARDS, root, backend, backend=backend)
    try:
        world.run({"op": "load1m", "name": "s1m", "n_shards": SHARDS,
                   **paths}, timeout=600)
        rows = {}
        for nq in BATCHES:
            ans = world.run({"op": "search", "arrays": "s1m",
                             "grid": (1, SHARDS), "qaxes": (),
                             "saxes": ("model",), "batch": nq, "adc": "f32",
                             "k": k}, timeout=600)
            ids = cs.gathered(ans)
            wall = max(a["wall_s"] for a in ans.values())
            alone = [a["alone_s"] * 1e3 for _, a in sorted(ans.items())]
            same = bool(np.array_equal(ids, want[nq]))
            rows[nq] = dict(
                wall_ms=round(wall * 1e3, 3), qps=round(nq / wall, 1),
                rank_alone_ms=[round(t, 3) for t in alone],
                gather_ms=round(max(a["gather_s"] for a in ans.values())
                                * 1e3, 3),
                equal_to_one_process_merge=same)
            cs.require(same, f"{backend} batch {nq}: ids differ from the "
                       "one-process merge")
            cs.require(all(a["launches"].get("fused_hop_f32", 0) > 0
                           for a in ans.values()),
                       f"{backend}: a rank launched no fused_hop_f32")
        return world.start_s, rows
    finally:
        world.close()


def corpus_1m(root: str) -> dict:
    """The deployment phase's corpus and PQ (chip_smoke.phase_deployment's
    seeds), written as the npy files the ranks read."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.pq import encode, train_codebooks
    from repro_torch.data.vectors import make_clustered, make_queries
    base = make_clustered(N, cfg.dim, seed=2)
    queries = make_queries(256, base, seed=3)
    vecs = torch.from_numpy(base).cuda()
    rng = np.random.default_rng(0)
    sample = torch.from_numpy(rng.choice(N, 100_000, replace=False)).cuda()
    cents = train_codebooks(vecs[sample], m=cfg.pq_m,
                            init_idx=rng.choice(100_000, cfg.pq_ks,
                                                replace=False),
                            ks=cfg.pq_ks, iters=12, device="cuda")
    codes = encode(cents, vecs, device="cuda")
    del vecs
    return cs.save_1m((base, None, cents.cpu().numpy(), codes.cpu().numpy()),
                      queries, root)


def main() -> int:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < SHARDS:
        print(f"sharded_nccl: needs {SHARDS} CUDA cards", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    k = cs.RERANK
    root = tempfile.mkdtemp(prefix="sharded_nccl_")
    try:
        paths = corpus_1m(root)
        want = one_process(paths, k)
        alone = unsharded_ms(paths, k)
        for nq in BATCHES:
            cs.log("sharded_nccl", world="unsharded_card0", batch=nq,
                   k=k, wall_ms=f"{alone[nq]:.3f}",
                   qps=f"{nq / alone[nq] * 1e3:.1f}")
        for backend in ("nccl", "gloo"):
            start_s, rows = world_run(root, backend, paths, want, k)
            for nq, row in rows.items():
                cs.log("sharded_nccl", world=f"{backend} x{SHARDS}",
                       cards=SHARDS if backend == "nccl" else 1, batch=nq,
                       k=k, world_start_s=f"{start_s:.2f}",
                       **{key: cs.compact(v) if isinstance(v, list) else v
                          for key, v in row.items()})
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().replace("\n", "; "), flush=True)
        return 0
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
