"""Index-construction launcher (port of `repro.launch.build_index`).

    PYTHONPATH=src python -m repro_torch.launch.build_index --out /tmp/idx \
        [--n 20000 --dim 96 --mode aisaq --R 24 --pq-m 16] \
        [--shards 4] [--metric l2|mips] [--device cuda|cpu]

Builds synthetic corpora by default; pass --data <file.npy> for real
vectors. With --shards > 1 builds the per-shard sub-indices of the paper's
Fig.-5 multi-server layout. PQ training and encoding run on --device (the
card by default); the directories are in the reference's format.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--data", help=".npy of vectors (else synthetic)")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--mode", default="aisaq", choices=["aisaq", "diskann"])
    ap.add_argument("--metric", default="l2", choices=["l2", "mips"])
    ap.add_argument("--R", type=int, default=24)
    ap.add_argument("--pq-m", type=int, default=16)
    ap.add_argument("--build-L", type=int, default=40)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where PQ is trained and encoded (cuda or cpu)")
    args = ap.parse_args(argv)

    from repro_torch.configs import IndexConfig
    from repro_torch.core.build import build_index
    from repro_torch.data.vectors import make_clustered

    if args.data:
        vectors = np.load(args.data)
    else:
        vectors = make_clustered(args.n, args.dim, seed=args.seed)
    n, dim = vectors.shape
    cfg = IndexConfig(name=os.path.basename(args.out), n_vectors=n, dim=dim,
                      data_dtype="uint8" if vectors.dtype == np.uint8
                      else "float32",
                      metric=args.metric, R=args.R, pq_m=args.pq_m,
                      build_L=args.build_L, mode=args.mode)
    t0 = time.time()
    if args.shards == 1:
        meta = build_index(args.out, vectors, cfg, seed=args.seed,
                           verbose=True, device=args.device)
        print(f"built {args.out}: chunk={meta['chunk_bytes']}B "
              f"io/hop={meta['io_bytes']}B in {time.time()-t0:.0f}s")
    else:
        bounds = np.linspace(0, n, args.shards + 1).astype(int)
        for s in range(args.shards):
            sub = vectors[bounds[s]:bounds[s + 1]]
            scfg = cfg.scaled(n_vectors=sub.shape[0])
            build_index(os.path.join(args.out, f"shard{s}"), sub, scfg,
                        seed=args.seed + s, verbose=True, device=args.device)
        print(f"built {args.shards} shard indices under {args.out} "
              f"in {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
