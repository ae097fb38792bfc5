#!/usr/bin/env python3
"""Where a full-width training step of the recommender towers spends its
time, on one CUDA card.

    python3 scripts/train_profile.py [--arch dlrm-rm2 wide-deep ...]

For each arch: `repro_torch.launch.train.build_trainer(scale="full")`
(the published cardinalities, train_batch = 65,536 rows), two warm-up
steps, then one step under torch.profiler (CPU and CUDA). Prints one
`[train_profile]` line an arch: the step's wall, the device's busy time
(the union of its kernels' intervals) and idle share, the device ops,
and the top kernels by device time; and one `[train_profile_cpu]` line:
the top host ops by self CPU time. Ends with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def busy_ms(events) -> float:
    """Union of the device intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def profile_arch(aid: str, top: int):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.device import to_tensor
    from repro_torch.launch import train
    dev = torch.device("cuda")
    _, init, step_fn, data = train.build_trainer(aid, "train_batch",
                                                 scale="full", steps=3,
                                                 device=dev)
    state = init()
    for step in range(2):
        state, _ = step_fn(state, {k: to_tensor(v, dev)
                                   for k, v in data(step).items()})
    batch = {k: to_tensor(v, dev) for k, v in data(2).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(dev_events)
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_time_total > 0),
                     key=lambda r: -r[1])[:top]
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()),
                  key=lambda r: -r[1])[:top]
    print(f"[train_profile] arch={aid} wall_ms={wall:.3f} "
          f"device_busy_ms={busy:.3f} idle_share={1 - busy / wall:.4f} "
          f"device_ops={len(dev_events)} loss={float(m['loss']):.5f} "
          "top=" + json.dumps([[k[:48], round(t, 3), c]
                               for k, t, c in kernels]), flush=True)
    print(f"[train_profile_cpu] arch={aid} top_self_cpu_ms=" + json.dumps(
        [[k[:48], round(t, 3), c] for k, t, c in host]), flush=True)
    del state, step_fn, init, data, batch
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["dlrm-rm2", "dcn-v2", "wide-deep", "sasrec"])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for aid in args.arch:
        profile_arch(aid, args.top)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
