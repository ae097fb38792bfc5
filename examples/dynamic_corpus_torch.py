"""Dynamic RAG corpus on the PyTorch/CUDA port: live insertion + deletion +
filtered retrieval (the port's `examples/dynamic_corpus.py`).

    PYTHONPATH=src python examples/dynamic_corpus_torch.py [--device cpu]

The paper's conclusion says AiSAQ's near-zero load time "will enable LLMs
with RAG to employ more simple index addition or filter search algorithms" —
this example exercises exactly that: documents stream into a live index
(in-place chunk appends + reverse-edge patches), stale documents are
tombstoned, and queries filter by a freshness predicate. Each search's
arithmetic runs on `--device` (the card by default, raising without one).
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import IndexConfig
from repro_torch.core.build import build_index
from repro_torch.core.dynamic import DynamicHostIndex
from repro_torch.data.vectors import make_clustered
from repro_torch.device import resolve_device


def run(*, device=None, n_base=1500, n_new=100, d=48, R=16, pq_m=12,
        build_L=32, L=48, probe=1550, deleted=(1500, 1510),
        init_idx=None, workdir=None) -> dict:
    """Build `n_base` docs under `workdir` (a new temporary directory if
    None, kept), stream `n_new` more into the live index, search for doc
    `probe`, tombstone labels [deleted[0], deleted[1]), search again, keep
    only even ids, flush, and reload to search the filtered query again.
    Returns each step's ids and flags."""
    dev = resolve_device(device)
    base = make_clustered(n_base + n_new, d, seed=0)
    cfg = IndexConfig(name="dyn", n_vectors=n_base, dim=d, R=R, pq_m=pq_m,
                      build_L=build_L)
    root = workdir or tempfile.mkdtemp(prefix="dyn_")
    path = os.path.join(root, "corpus")
    build_index(path, base[:n_base], cfg, mode="aisaq", seed=0,
                init_idx=init_idx, device=dev)
    idx = DynamicHostIndex.load(path, device=dev)
    out = {"n_base": n_base, "n_new": n_new}

    t0 = time.perf_counter()
    out["labels"] = [idx.insert(base[n_base + i]) for i in range(n_new)]
    out["insert_ms"] = (time.perf_counter() - t0) / n_new * 1e3

    q = base[probe].astype(np.float32)
    ids, _ = idx.search(q, 5, L=L)
    out.update(ids_fresh=ids, fresh_found=probe in set(int(i) for i in ids))

    gone = set(range(*deleted))
    for v in sorted(gone):
        idx.delete(v)
    ids, _ = idx.search(base[(deleted[0] + deleted[1]) // 2]
                        .astype(np.float32), 5, L=L)
    out.update(ids_deleted=ids,
               deleted_excluded=not (gone & set(int(i) for i in ids)))

    even = lambda i: i % 2 == 0       # noqa: E731  (the 'fresh' docs)
    ids, _ = idx.search(q, 5, L=L, predicate=even)
    out.update(ids_filtered=ids,
               all_even=all(int(i) % 2 == 0 for i in ids))

    idx.flush()
    idx.close()
    idx = DynamicHostIndex.load(path, device=dev)
    ids, _ = idx.search(q, 5, L=L, predicate=even)
    out.update(ids_reloaded=ids, reload_n=idx.n,
               reload_same=bool(np.array_equal(ids, out["ids_filtered"])))
    idx.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where each search's arithmetic runs")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print(f"== building initial {out['n_base']}-doc index ==")
    print(f"== streaming {out['n_new']} new documents into the live index "
          "==")
    print(f"   mean insert latency: {out['insert_ms']:.1f} ms/doc "
          f"(search + <=R reverse-edge chunk patches)")
    print(f"   freshly-inserted doc findable: {out['fresh_found']} "
          f"(top-5 {out['ids_fresh'].tolist()})")
    print("== tombstoning 10 stale docs ==")
    print(f"   deleted docs excluded: {out['deleted_excluded']}")
    print("== filtered retrieval (only even-id 'fresh' docs) ==")
    print(f"   filtered top-5: {out['ids_filtered'].tolist()} (all even: "
          f"{out['all_even']})")
    print("flushed: appended codes + tombstones persist across reloads")


if __name__ == "__main__":
    main()
