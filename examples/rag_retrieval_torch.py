"""RAG-style multi-corpus retrieval (paper §2.2 / Table 4) on the
PyTorch/CUDA port, served by the multi-tenant `RetrievalService` (the
port's `examples/rag_retrieval.py`): a warm-index pool keeps every corpus
open under one DRAM budget (shared PQ centroids charged once), per-corpus
queues serve tenants concurrently, and the exact rerank tier rescores
candidates with the full-precision vectors already sitting in the
traversal chunks.

    PYTHONPATH=src python examples/rag_retrieval_torch.py [--device cpu]

A simulated LLM chain issues retrievals against three different corpora
(news / docs / code) that share one embedding space, so their AiSAQ indices
share PQ centroids — co-residency costs one centroid table + ~KBs per
corpus. PQ is trained and each hop's arithmetic runs on `--device` (the
card by default, raising without one).

The shared codebooks start from the rows `core.build.draw_init_idx(n, 256,
0)` picks, where the reference seeds them with `jax.random.PRNGKey(0)`: at
the default settings the ids therefore differ from the original's. Given
the reference's rows (`init_idx`), `run` answers as the original does.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import IndexConfig
from repro_torch.core import pq
from repro_torch.core.build import build_index, draw_init_idx
from repro_torch.data.vectors import make_clustered, make_queries
from repro_torch.device import resolve_device
from repro_torch.serving import RetrievalService, WarmIndexPool

CORPORA = ("news", "docs", "code")
CHAIN = ["news", "docs", "docs", "code", "news", "code"] * 2
L, K, RERANK = 32, 5, 20        # the service's list, answer and rerank


def run(*, device=None, d=64, n_per=3000, pq_m=16, R=20, build_L=32,
        init_idx=None, workdir=None) -> dict:
    """Build the three corpora under `workdir` (a new temporary directory
    if None, kept) on one shared codebook, serve the 12-step chain through
    the pool and the service, and return each step's answer with the
    service's and the pool's statistics."""
    dev = resolve_device(device)
    everything = make_clustered(len(CORPORA) * n_per, d, seed=0)
    rows = draw_init_idx(len(everything), 256, 0) if init_idx is None \
        else init_idx
    cents = pq.train_codebooks(everything, m=pq_m, init_idx=rows,
                               device=dev).cpu().numpy()
    root = workdir or tempfile.mkdtemp(prefix="rag_")
    cfg = IndexConfig(name="rag", n_vectors=n_per, dim=d, R=R, pq_m=pq_m,
                      build_L=build_L)
    corpora = {}
    for i, name in enumerate(CORPORA):
        p = os.path.join(root, name)
        build_index(p, everything[i * n_per:(i + 1) * n_per], cfg,
                    mode="aisaq", shared_centroids=cents, device=dev)
        corpora[name] = p

    # budget generous enough for all three corpora: every index stays warm
    pool = WarmIndexPool(corpora, budget_bytes=64 << 20,
                         cache_bytes=2 << 20, device=dev)
    svc = RetrievalService(pool, num_workers=2, max_wait_ms=1.0, L=L,
                           rerank=RERANK)        # exact rerank tier on
    queries = make_queries(len(CHAIN), everything, seed=3)
    try:
        answers, latency_ms = [], []
        for step, corpus in enumerate(CHAIN):
            r = svc.submit_wait(queries[step], corpus=corpus, k=K)
            answers.append(np.asarray(r.result))
            latency_ms.append(r.latency_s * 1e3)
        st = svc.stats()
    finally:
        svc.stop()
        pool.close()
    return {"corpora": corpora, "chain": list(CHAIN), "queries": queries,
            "answers": answers, "latency_ms": latency_ms,
            "service": st["corpora"], "pool": st["pool"],
            "L": L, "k": K, "rerank": RERANK}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where PQ and each hop's arithmetic run")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print("== building 3 corpora sharing one vector space ==")
    for name in out["corpora"]:
        print(f"  built {name}")
    print("\n== simulated RAG chain: 12 retrievals across corpora ==")
    for step, corpus in enumerate(out["chain"]):
        print(f"  step {step:2d} [{corpus:4s}] top-5 ids "
              f"{out['answers'][step].tolist()} "
              f"latency {out['latency_ms'][step]:.2f} ms")
    ps = out["pool"]
    print("\nper-corpus serving stats:")
    for name, c in out["service"].items():
        print(f"  {name:4s} completed={c['completed']} "
              f"switches={c['switches']} p50={c.get('p50_ms', 0):.2f}ms")
    print(f"pool: open={ps['open']}/{ps['registered']} warm, "
          f"hits={ps['hits']} misses={ps['misses']} "
          f"evictions={ps['evictions']}")
    print(f"shared-centroid dedup: {ps['centroid_shares']} corpora reuse "
          f"one {ps['centroid_bytes']/1e3:.1f} KB table")
    print(f"DRAM for ALL {ps['open']} warm corpora: "
          f"{ps['used_bytes']/1e6:.2f} MB (vs one-at-a-time switching — "
          "that's the point)")


if __name__ == "__main__":
    main()
