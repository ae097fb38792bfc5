#!/usr/bin/env python3
"""Time the port's bulk ADC (`pq_adc`, `pq_adc_q8`), `pq_lut` and `rerank`
kernels of one source tree on the card.

    python3 scripts/adc_bench.py [--root DIR] [--label NAME]
                                 [--only {adc,lut,rerank} ...]

DIR is the root of a checkout (default: this one); its `src/repro_torch`
is imported and its kernels are built there. To compare two commits on
one card, unpack the other into a directory that .gitignore lists (`git
archive`) and run both in one command, in turns: parent, change, change,
parent.

Cases:
  adc: the retrieval shape (1 query, 1,000,000 rows, m=10), the bulk
  shape (8, 1,000,000, 16) and the wide shape (4, 50,000, 128), u8 codes;
  each of 8 calls has its own LUT, and the codes rotate over copies that
  together exceed the 50 MB L2;
  lut: pq_lut at SIFT1M widths (m=128, dsub=1, l2) at batches 1, 64 and
  256, and at the SASRec retrieval shape (1 query, m=10, dsub=5, mips);
  rerank: rerank of gathered candidates, 64 queries x 100 x d=128; the
  serving rerank step on a 10,000-row SIFT1M-width chunk table, 64
  queries x 100 ids: the route of clamp, index_select of the rows, the
  vector slice and its copy, `rerank` and where (every tree), and one
  `rerank_rows` call (trees that have it).
Each time is the device time of one call from a CUDA graph of the calls
(8 for adc, 20 otherwise, each with its own inputs where the inputs are
LUTs, ids or candidates), replayed three times and timed with CUDA events
(the method of chip_smoke.py `device_ms`). Prints the card line, then one
JSON object a case.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = (("retrieval", 1, 1_000_000, 10), ("bulk", 8, 1_000_000, 16),
          ("wide", 4, 50_000, 128))
ADC_CALLS = 8
CALLS = 20
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


def bench_adc(emit, g) -> None:
    import torch
    from repro_torch.kernels.pq_adc import pq_adc, pq_adc_q8
    dev = g.device
    for name, nq, n, m in SHAPES:
        luts = torch.rand((ADC_CALLS, nq, m, 256), generator=g,
                          device=dev) * 3
        codes = torch.randint(0, 256, (n, m), generator=g, device=dev,
                              dtype=torch.uint8)
        copies = [codes.clone()
                  for _ in range(min(ADC_CALLS, L2_BYTES // (n * m) + 1))]
        for kernel, fn in (("pq_adc", pq_adc), ("pq_adc_q8", pq_adc_q8)):
            ms = device_ms([lambda i=i: fn(luts[i], copies[i % len(copies)])
                            for i in range(ADC_CALLS)])
            emit(kernel, f"{name} nq={nq} n={n} m={m}", ms)
        del copies


def bench_lut(emit, g) -> None:
    import torch
    from repro_torch.kernels.pq_lut import pq_lut
    for name, nq, m, dsub, metric in (
            ("sift1m", 1, 128, 1, "l2"), ("sift1m", 64, 128, 1, "l2"),
            ("sift1m", 256, 128, 1, "l2"), ("sasrec", 1, 10, 5, "mips")):
        q = torch.randn((nq, m * dsub), generator=g, device=g.device)
        cents = torch.randn((m, 256, dsub), generator=g, device=g.device)
        emit("pq_lut", f"{name} nq={nq}",
             device_ms([lambda: pq_lut(q, cents, metric=metric)] * CALLS))


def bench_rerank(emit, g) -> None:
    import torch
    from repro_torch.core.chunk_layout import ChunkLayout
    from repro_torch.kernels import rerank
    dev = g.device
    nq, c, d, n = 64, 100, 128, 10_000
    q = torch.randn((nq, d), generator=g, device=dev)
    cands = [torch.randn((nq, c, d), generator=g, device=dev)
             for _ in range(CALLS)]
    emit("rerank", "gathered 64x100x128",
         device_ms([lambda x=x: rerank.rerank(q, x) for x in cands]))
    lay = ChunkLayout("aisaq", d, "float32", 56, 128)
    vec_words = lay.padded_vec_bytes // 4
    words = torch.randint(-2 ** 31, 2 ** 31 - 1,
                          (n, lay.device_stride // 4), generator=g,
                          device=dev, dtype=torch.int32)
    words[:, :d] = torch.randn((n, d), generator=g, device=dev) \
        .view(torch.int32)
    ids = [torch.randint(0, n, (nq, c), generator=g, device=dev,
                         dtype=torch.int32) for _ in range(CALLS)]

    def route(i):
        rows = words.index_select(0, i.clamp(0, n - 1).reshape(-1).long())
        cand = rows[:, :vec_words][:, :d].contiguous() \
            .view(torch.float32).reshape(nq, c, d)
        return torch.where(i >= 0, rerank.rerank(q, cand), torch.inf)

    emit("rerank", "serving step route 64x100 10k",
         device_ms([lambda i=i: route(i) for i in ids]))
    if hasattr(rerank, "rerank_rows"):
        got = rerank.rerank_rows(q, words, ids[0], lay)
        if not torch.allclose(got, route(ids[0]), rtol=1e-4, atol=1e-4):
            raise AssertionError("rerank_rows differs from the route")
        emit("rerank", "serving step rerank_rows 64x100 10k",
             device_ms([lambda i=i: rerank.rerank_rows(q, words, i, lay)
                        for i in ids]))


BENCHES = {"adc": bench_adc, "lut": bench_lut, "rerank": bench_rerank}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", nargs="+", choices=tuple(BENCHES),
                    default=list(BENCHES))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("adc_bench: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    label = args.label or args.root

    def emit(kernel, case, ms):
        print(json.dumps({"label": label, "kernel": kernel, "case": case,
                          "ms": ms}), flush=True)

    g = torch.Generator(device=torch.device("cuda")).manual_seed(3)
    for name in args.only:
        BENCHES[name](emit, g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
