"""Serving launcher: storage-backed AiSAQ retrieval with batching,
multi-corpus switching and latency reporting (port of
`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        [--corpora a=path1 b=path2] [--queries 200] [--L 48] [--hedge 2] \
        [--device cuda|cpu]

If no corpora are given, builds a demo index first (4000 clustered
vectors, d=64) through `core.build.build_index` in a temporary directory,
removed at exit. The indices are served from their files through
`IndexManager` -> `HostIndex.search_batch`, whose arithmetic runs on
--device (the card by default).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import IndexConfig
from repro_torch.core.build import build_index
from repro_torch.core.index_switch import IndexManager
from repro_torch.data.vectors import make_clustered, make_queries
from repro_torch.serving.engine import ServingEngine


def main(argv=None) -> dict:
    """Run the launcher; prints its report and returns it as a dict (qps,
    latency percentiles, switch count and median, resident bytes)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpora", nargs="*", default=None,
                    help="name=path pairs of index dirs")
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--L", type=int, default=48)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--hedge", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where the search arithmetic runs (cuda or cpu)")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="serve_") as root:
        if args.corpora:
            paths = dict(c.split("=", 1) for c in args.corpora)
            with open(os.path.join(next(iter(paths.values())),
                                   "meta.json")) as f:
                dim = json.load(f)["dim"]
            base = None
        else:
            print("no corpora given — building a demo index ...")
            dim = 64
            base = make_clustered(4000, dim, seed=0)
            cfg = IndexConfig(name="demo", n_vectors=4000, dim=dim, R=24,
                              pq_m=16, build_L=48)
            build_index(os.path.join(root, "demo"), base, cfg,
                        mode="aisaq", device=args.device)
            paths = {"demo": os.path.join(root, "demo")}
        return _serve(args, paths, dim, base)


def _serve(args, paths: dict, dim: int, base) -> dict:
    """Serve args.queries requests round-robin over the corpora."""
    mgr = IndexManager(paths, device=args.device)

    def search(queries, k):
        ids, _ = mgr.search_batch(queries, k, L=max(args.L, k))
        return ids

    eng = ServingEngine({c: search for c in paths}, switch_fn=mgr.switch,
                        max_batch=args.max_batch, hedge=args.hedge,
                        replicas=[search] * max(1, args.hedge))
    try:
        if base is not None:
            queries = make_queries(args.queries, base, seed=2)
        else:
            rng = np.random.default_rng(0)
            queries = rng.normal(size=(args.queries, dim)) \
                .astype(np.float32)
        corpora = list(paths)
        t0 = time.time()
        reqs = [eng.submit(queries[i], corpus=corpora[i % len(corpora)],
                           k=args.k) for i in range(args.queries)]
        for r in reqs:
            if not r.event.wait(30):
                raise TimeoutError("a request was not served in 30 s")
            if r.error is not None:
                raise r.error
        wall = time.time() - t0
        report = dict(queries=args.queries, wall_s=wall,
                      qps=args.queries / wall,
                      latency=eng.latency_percentiles(),
                      switches=len(eng.switch_times),
                      switch_median_ms=float(np.median(eng.switch_times))
                      * 1e3 if eng.switch_times else 0.0,
                      resident_bytes=mgr.resident_bytes(),
                      device=str(mgr.pool.device))
        print(f"served {args.queries} queries in {wall:.2f}s "
              f"({report['qps']:.0f} qps) on {report['device']}")
        print("latency:", report["latency"])
        if eng.switch_times:
            print(f"index switches: {report['switches']}, median "
                  f"{report['switch_median_ms']:.2f} ms")
        print(f"resident: {report['resident_bytes'] / 1e3:.1f} KB")
        return report
    finally:
        eng.stop()
        mgr.close()


if __name__ == "__main__":
    main()
