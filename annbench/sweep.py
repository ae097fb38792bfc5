"""Find an open-loop cell's knee: the highest offered rate the program
sustains, stepping the rate in one process on one set-up.

    python3 annbench/sweep.py --workload <name> --seed <n> --seconds <s> \
        --rates 1000 1100 ...

Each step offers its rate for `--seconds` through the cell's own engine
settings (arrivals as `harness.arrivals` draws them) and reports the
share of the offered requests completed by the step's close, the latency
median and 95th percentile from the due time, the mean batch, and how the
queue grew: the median latency of the requests due in the step's second
half over that of those due in its first half. The knee is the highest
rate whose queue did not grow over the step: a share of at least 0.99
and a growth of at most 1.2 (near capacity a queue grows slowly, so the
share alone passed rates whose median latency had tripled). The sweep
stops after two steps in a row below it.
Prints one JSON line a step, then one with the knee.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent.parent / "src")]


def sweep(cell: dict, seed: int, seconds: float, rates, device) -> list:
    """One row a step (rate, offered, share completed in the step, latency
    p50 / p95 from the due time, mean batch), then {"knee_per_s": ...}."""
    import numpy as np
    from annbench import harness
    tr = cell["traffic"]
    if tr["kind"] != "open":
        raise ValueError(f"{cell['name']} is not an open-loop cell")
    top = dict(tr, rate_per_s=max(rates))
    st = harness.prepare(dict(cell, traffic=top), seed, seconds, device)
    fn, k = st["program"][2], cell["config"]["k"]
    harness.freeze_heap()
    rows, knee, misses = [], None, 0
    for rate in rates:
        mix = dict(tr, rate_per_s=rate)
        due = harness.arrivals(mix, seconds, seed)
        rec = harness.Recorder(fn, st["pool"])
        t = time.perf_counter()
        res = harness.open_loop(rec, st["pool"], due, k, mix, seconds)
        lat = res["all_latencies_s"]
        share = float((due + lat <= seconds).mean())
        late_half = due >= seconds / 2
        growth = float(np.median(lat[late_half]) / np.median(lat[~late_half]))
        sizes = [c[3] for c in rec.calls]
        rows.append({"rate_per_s": rate, "offered": len(due),
                     "completed_in_window": share, "failed": res["failed"],
                     "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
                     "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                     "batch_mean": float(np.mean(sizes)) if sizes else 0.0,
                     "growth": growth,
                     "step_s": time.perf_counter() - t})
        print(json.dumps(rows[-1]), flush=True)
        if share >= 0.99 and growth <= 1.2 and not res["failed"]:
            knee, misses = rate, 0
        else:
            misses += 1
            if misses == 2:
                break
    rows.append({"knee_per_s": knee, "kind": st["kind"],
                 "workload": cell["name"], "seed": seed, "seconds": seconds})
    print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from annbench import harness
    if not torch.cuda.is_available():
        harness.log("sweep: no CUDA device")
        return 1
    sweep(harness.load_cell(args.workload), args.seed, args.seconds,
          args.rates, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
