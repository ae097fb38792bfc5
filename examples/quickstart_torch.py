"""Quickstart on the PyTorch/CUDA port: build an AiSAQ index, search it,
compare with DiskANN mode (the port's `examples/quickstart.py`).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Demonstrates the paper's three headline claims at laptop scale:
  1. identical recall to DiskANN (same graph topology),
  2. ~N-independent RAM residency (only centroids + entry-point codes),
  3. near-zero index load time.

PQ is trained on `--device` (the card by default, raising without one);
each hop's arithmetic runs there too (the fused hop and LUT kernels on
the card). The initial centroid rows come from `core.build.draw_init_idx`
(the reference draws them with jax.random), so ids can differ from
`examples/quickstart.py`'s unless `run(init_idx=...)` is given its rows.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import IndexConfig
from repro_torch.core import pq
from repro_torch.core.build import build_index
from repro_torch.core.index_io import HostIndex
from repro_torch.data.vectors import make_clustered, make_queries
from repro_torch.device import resolve_device


def run(*, device=None, n=5000, d=64, nq=32, R=24, pq_m=16, build_L=48,
        L=48, init_idx=None, workdir=None) -> dict:
    """Build the AiSAQ index (with its navigation tier) and its DiskANN
    twin under `workdir` (a new temporary directory if None, kept), then
    search each with the medoid entry, with prefetch 4, and the AiSAQ one
    from the navigation tier's entries. Returns the corpus's recall
    inputs and, by mode, the ids and figures the original prints."""
    dev = resolve_device(device)
    base = make_clustered(n, d, seed=0)
    queries = make_queries(nq, base)
    gt = pq.groundtruth(queries, base, 10, device=dev)
    cfg = IndexConfig(name="quickstart", n_vectors=n, dim=d, R=R,
                      pq_m=pq_m, build_L=build_L)
    root = workdir or tempfile.mkdtemp(prefix="aisaq_quickstart_")
    out = {"n": n, "d": d, "gt": gt, "root": root, "modes": {}}
    for mode in ("aisaq", "diskann"):
        path = os.path.join(root, mode)
        t0 = time.time()
        # nav=True packs the in-RAM navigation tier (docs/navigation.md)
        # alongside the AiSAQ index; the DiskANN twin stays plain
        meta = build_index(path, base, cfg, mode=mode, seed=0,
                           nav=(mode == "aisaq"), init_idx=init_idx,
                           device=dev)
        r = {"build_s": time.time() - t0, "chunk_bytes": meta["chunk_bytes"],
             "io_bytes": meta["io_bytes"]}
        idx = HostIndex.load(path, device=dev)
        r.update(load_ms=idx.load_time_s * 1e3,
                 resident_kb=idx.resident_bytes() / 1e3)
        # entry="medoid" pins the classic fixed-seed traversal so the
        # AiSAQ/DiskANN comparison stays apples-to-apples (the nav demo
        # below opts in explicitly)
        ids, stats = idx.search_batch(queries, 10, L=L, entry="medoid")
        r.update(ids=ids, recall1=pq.recall_at(ids, gt, 1),
                 recall10=pq.recall_at(ids, gt, 10),
                 latency_ms=np.mean([s.latency_s for s in stats]) * 1e3,
                 ios=np.mean([s.ios for s in stats]),
                 hops=np.median([s.hops for s in stats]),
                 converged=np.median([s.convergence_hop for s in stats]))
        # the pipelined traversal engine (core.traversal): prefetch>0
        # turns on the two-hop in-flight path — identical ids, reads off
        # the critical path; overlap is visible in the lead query's stats
        idx.cache.clear()
        ids_p, stats_p = idx.search_batch(queries, 10, L=L, prefetch=4,
                                          entry="medoid")
        r.update(ids_prefetch=ids_p,
                 blocked_ms=stats_p[0].blocked_wait_s * 1e3,
                 compute_ms=stats_p[0].compute_s * 1e3)
        if idx.nav is not None:
            # the navigation tier: an in-RAM beam over ~2% pivot nodes
            # replaces the fixed medoid seed with per-query entry
            # vertices — fewer on-disk hops, zero extra storage I/O
            ids_n, st_n = idx.search_batch(queries, 10, L=L, entry="nav")
            r.update(ids_nav=ids_n, nav_recall10=pq.recall_at(ids_n, gt, 10),
                     nav_hops=np.median([s.hops for s in st_n]),
                     nav_converged=np.median([s.convergence_hop
                                              for s in st_n]),
                     nav_kb=idx.nav.resident_nbytes() / 1e3,
                     nav_pivots=idx.nav.params["pivots"])
        idx.close()
        out["modes"][mode] = r
    out["same"] = bool(np.array_equal(out["modes"]["aisaq"]["ids"],
                                      out["modes"]["diskann"]["ids"]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where PQ and each hop's arithmetic run")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print(f"== corpus: {out['n']} x {out['d']} clustered vectors ==")
    for mode, r in out["modes"].items():
        print(f"\n[{mode}] built in {r['build_s']:.1f}s  "
              f"chunk={r['chunk_bytes']}B  io/hop={r['io_bytes']}B")
        print(f"[{mode}] load time     : {r['load_ms']:.2f} ms")
        print(f"[{mode}] resident bytes: {r['resident_kb']:.1f} KB")
        print(f"[{mode}] recall@1={r['recall1']:.3f} "
              f"recall@10={r['recall10']:.3f} "
              f"mean latency={r['latency_ms']:.2f} ms "
              f"ios/query={r['ios']:.0f} "
              f"hops/query={r['hops']:.0f} "
              f"(converged by hop {r['converged']:.0f})")
        assert np.array_equal(r["ids"], r["ids_prefetch"])
        print(f"[{mode}] pipelined: blocked wait {r['blocked_ms']:.2f} ms "
              f"vs compute {r['compute_ms']:.2f} ms (whole batch, "
              f"results identical)")
        if "ids_nav" in r:
            print(f"[{mode}] nav entry: hops/query={r['nav_hops']:.0f} "
                  f"(converged by hop {r['nav_converged']:.0f}) "
                  f"recall@10={r['nav_recall10']:.3f}  "
                  f"[nav tier: {r['nav_kb']:.1f} KB, "
                  f"{r['nav_pivots']} pivots]")
    print(f"\nAiSAQ results identical to DiskANN (same topology): "
          f"{out['same']}")


if __name__ == "__main__":
    main()
