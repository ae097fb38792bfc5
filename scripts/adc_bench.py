#!/usr/bin/env python3
"""Time the port's bulk ADC kernels (`pq_adc`, `pq_adc_q8`) of one source
tree on the card.

    python3 scripts/adc_bench.py [--root DIR] [--label NAME]

DIR is the root of a checkout (default: this one); its `src/repro_torch`
is imported and its kernels are built there. To compare two commits on
one card, unpack the other into a directory that .gitignore lists (`git
archive`) and run both in one command, in turns: parent, change, change,
parent.

Shapes: the retrieval shape (1 query, 1,000,000 rows, m=10), the bulk
shape (8, 1,000,000, 16) and the wide shape (4, 50,000, 128), u8 codes.
Each time is the device time of one call from a CUDA graph of 8 calls,
each with its own LUT and the codes rotated over copies that together
exceed the 50 MB L2, replayed three times and timed with CUDA events (the
method of chip_smoke.py `device_ms`). Prints the card line, then one JSON
object a shape and kernel.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = (("retrieval", 1, 1_000_000, 10), ("bulk", 8, 1_000_000, 16),
          ("wide", 4, 50_000, 128))
CALLS = 8
L2_BYTES = 50 * 2 ** 20


def device_ms(fns) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 3
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("adc_bench: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels.pq_adc import pq_adc, pq_adc_q8
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    for name, nq, n, m in SHAPES:
        luts = torch.rand((CALLS, nq, m, 256), generator=g, device=dev) * 3
        codes = torch.randint(0, 256, (n, m), generator=g, device=dev,
                              dtype=torch.uint8)
        copies = [codes.clone()
                  for _ in range(min(CALLS, L2_BYTES // (n * m) + 1))]
        for kernel, fn in (("pq_adc", pq_adc), ("pq_adc_q8", pq_adc_q8)):
            ms = device_ms([lambda i=i: fn(luts[i], copies[i % len(copies)])
                            for i in range(CALLS)])
            print(json.dumps({"label": args.label or args.root,
                              "shape": name, "nq": nq, "n": n, "m": m,
                              "kernel": kernel, "ms": ms}), flush=True)
        del copies
    return 0


if __name__ == "__main__":
    sys.exit(main())
