"""Readings of the control: the reference in bfloat16 put in the
program's place, judged by the same comparison as a run.

    python3 annbench/control.py --workload <name> --seconds <s> \
        --seeds <n> <n> ...

For each seed, the cell's inputs are drawn as a run draws them, the
queries a run would sample are searched by the float32 reference and by
the same reference computing every distance of the search (each query's
table, the hops' exact distances, the rerank) in bfloat16, the precision
below the configuration's float32. Both start from the one entry row the
reference picks in float64, so what the control reads is the search's
precision alone. `harness.verdict` judges the reading against the cell's
limit as a run's `correct` does; the control must come out not correct on
every seed. Runs no part of the program. Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent.parent / "src")]


def control_reading(cell: dict, seed: int, seconds: float, device) -> dict:
    import numpy as np
    import torch
    from annbench import harness, inputs, reference
    cfg, tr = cell["config"], cell["traffic"]
    inp = inputs.draw_index(cfg, seed, device)
    n_pool = len(harness.arrivals(tr, seconds, seed)) \
        if tr["kind"] == "open" else tr["query_pool"]
    pool = inputs.draw_queries(cfg, n_pool, inp["vectors"], seed)
    rows = harness.sample_rows(np.arange(n_pool), tr["sample"], seed)
    q = pool[torch.from_numpy(rows).to(pool.device)]
    ep = reference.entry_point(inp["vectors"])
    ref = reference.search(inp, q, cfg, ep=ep).ids.cpu().numpy()
    low = reference.search(inp, q, cfg, ep=ep,
                           dtype=torch.bfloat16).ids.cpu().numpy()
    checks = {"answers_differing": {
        "value": harness.answers_differing(low, ref),
        "limit": cfg["check"]["answers_differing_max"]}}
    return {"seed": seed, "queries": len(rows), "entry": ep,
            "correct": harness.verdict(checks), "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from annbench import harness
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        row = control_reading(cell, seed, args.seconds, args.device)
        row["s"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
