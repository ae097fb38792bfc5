#!/usr/bin/env python3
"""Why searches and inserts slow down when several threads share one index.

    python3 scripts/ingest_contention.py [--device cuda] [--n 3000]

Builds an index of `--n` clustered vectors at SIFT1M widths (d=128, R=56,
pq_m=128) with the port's `build_index` under a temporary directory, then
measures, on `--device` (the card unless asked otherwise), with the
process's search gate (`core.traversal.SEARCH_GATE`: one search at a time)
switched off ("free") and on ("gated"):

  readers   1, 2 and 3 threads searching one `HostIndex` (L=256, k=10) for
            `--seconds` each: total QPS, wall ms and thread-CPU ms a search
            (`time.thread_time`: a thread's own CPU time, so wall minus it
            is time spent waiting: the GIL, a lock or the card);
  switch    3 free readers with `sys.setswitchinterval` at 0.1 ms and at
            50 ms (the default is 5 ms): whether forced GIL switches matter;
  inserts   `--inserts` `DynamicHostIndex.insert`s alone, then as many under
            3 readers, free and gated, each split into its candidate
            search, its wait for the write lock and the rest (the wait for
            the search gate, host reads, RobustPrune, writes);
  sample    free inserts under 3 readers once more, with the top Python
            frame of every thread sampled each millisecond
            (`sys._current_frames`): the lines the threads sit on, most
            frequent first (the sampler's own work slows this run, so it
            is not timed).

Prints the card's name and power limit, then one JSON object per
measurement, and all of them to `chiprun_out/ingest_contention.json`.
Needs nothing but torch and numpy.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

OUT = []


def emit(kind: str, **kw):
    rec = dict(kind=kind, **kw)
    OUT.append(rec)
    print(json.dumps(rec), flush=True)


def run_readers(idx, queries, n_threads: int, seconds: float, L: int):
    """n_threads searching idx for `seconds`; returns (qps, wall ms a
    search, thread-CPU ms a search)."""
    stop = threading.Event()
    wall = [0.0] * n_threads
    cpu = [0.0] * n_threads
    done = [0] * n_threads

    def reader(r):
        i = r
        while not stop.is_set():
            t0, c0 = time.perf_counter(), time.thread_time()
            idx.search(queries[i % len(queries)], 10, L=L)
            wall[r] += time.perf_counter() - t0
            cpu[r] += time.thread_time() - c0
            done[r] += 1
            i += n_threads

    ts = [threading.Thread(target=reader, args=(r,))
          for r in range(n_threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in ts:
        t.join()
    span = time.perf_counter() - t0
    n = sum(done)
    return n / span, sum(wall) / n * 1e3, sum(cpu) / n * 1e3


@contextlib.contextmanager
def gate_off():
    """The search gate switched off: every search enters at once."""
    from repro_torch.core.traversal import SEARCH_GATE
    SEARCH_GATE.hold = lambda ahead=False: contextlib.nullcontext()
    try:
        yield
    finally:
        del SEARCH_GATE.hold


class InsertClock:
    """Splits the writer thread's inserts into candidate search, write-lock
    wait and the rest."""

    def __init__(self, idx):
        self.t = collections.Counter()
        self.writer = None
        cand, write = idx._candidates, idx._rw.write

        def timed_cand(*a, **k):
            t0 = time.perf_counter()
            try:
                return cand(*a, **k)
            finally:
                self.t["search_ms"] += time.perf_counter() - t0

        @contextlib.contextmanager
        def timed_write():
            t0 = time.perf_counter()
            with write():
                if threading.get_ident() == self.writer:
                    self.t["write_lock_wait_ms"] += time.perf_counter() - t0
                yield

        idx._candidates, idx._rw.write = timed_cand, timed_write

    def run(self, idx, vecs):
        self.t.clear()
        self.writer = threading.get_ident()
        lat = []
        for v in vecs:
            t0 = time.perf_counter()
            idx.insert(v)
            lat.append(time.perf_counter() - t0)
        n = len(vecs)
        parts = {k: round(v / n * 1e3, 3) for k, v in self.t.items()}
        parts["rest_ms"] = round(sum(lat) / n * 1e3 - sum(parts.values()), 3)
        return dict(p50_ms=round(float(np.median(lat)) * 1e3, 3),
                    mean_ms=round(float(np.mean(lat)) * 1e3, 3), **parts)


def sample_frames(threads, seconds: float):
    """Top frames of `threads` (idents), sampled every millisecond."""
    seen = collections.Counter()
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for tid, f in sys._current_frames().items():
            if tid in threads:
                st = traceback.extract_stack(f, limit=2)
                top = st[-1]
                seen[f"{threads[tid]} {os.path.basename(top.filename)}:"
                     f"{top.lineno} {top.name}"] += 1
                n += 1
        time.sleep(0.001)
    return {k: round(v / n, 4) for k, v in seen.most_common(20)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--inserts", type=int, default=24)
    ap.add_argument("--L", type=int, default=256)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args()
    from repro_torch.configs import SIFT1M
    from repro_torch.core.build import build_index
    from repro_torch.core.dynamic import DynamicHostIndex
    from repro_torch.core.index_io import HostIndex
    from repro_torch.data.vectors import make_clustered, make_queries
    from repro_torch.device import resolve_device
    dev = str(resolve_device(args.device))
    if dev.startswith("cuda"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    root = tempfile.mkdtemp(prefix="ingest_contention_")
    try:
        base = make_clustered(args.n + 4 * args.inserts, SIFT1M.dim, seed=0)
        queries = make_queries(64, base[:args.n], seed=1)
        src = os.path.join(root, "src")
        t0 = time.perf_counter()
        build_index(src, base[:args.n],
                    SIFT1M.scaled(n_vectors=args.n, build_L=64),
                    mode="aisaq", seed=0, device=dev)
        emit("build", device=dev, n=args.n,
             seconds=round(time.perf_counter() - t0, 2),
             switchinterval_s=sys.getswitchinterval())
        idx = HostIndex.load(src, device=dev)
        idx.search(queries[0], 10, L=args.L)            # warm-up
        with gate_off():
            for nt in (1, 2, 3):
                qps, wall, cpu = run_readers(idx, queries, nt, args.seconds,
                                             args.L)
                emit("readers", gate="free", threads=nt, qps=round(qps, 2),
                     wall_ms=round(wall, 3), thread_cpu_ms=round(cpu, 3))
            default = sys.getswitchinterval()
            for si in (1e-4, 5e-2):
                sys.setswitchinterval(si)
                qps, wall, cpu = run_readers(idx, queries, 3, args.seconds,
                                             args.L)
                emit("switch", gate="free", threads=3, switchinterval_s=si,
                     qps=round(qps, 2), wall_ms=round(wall, 3),
                     thread_cpu_ms=round(cpu, 3))
            sys.setswitchinterval(default)
        qps, wall, cpu = run_readers(idx, queries, 3, args.seconds, args.L)
        emit("readers", gate="gated", threads=3, qps=round(qps, 2),
             wall_ms=round(wall, 3), thread_cpu_ms=round(cpu, 3))
        idx.close()

        dst = os.path.join(root, "dyn")
        shutil.copytree(src, dst)
        dyn = DynamicHostIndex.load(dst, device=dev)
        clock = InsertClock(dyn)
        held = iter(base[args.n:])
        emit("inserts", readers=0, **clock.run(
            dyn, [next(held) for _ in range(args.inserts)]))
        # timed free and gated, then free again under the frame sampler
        # (whose own Python work would perturb the timed runs)
        for mode, sampled in (("free", False), ("gated", False),
                              ("free", True)):
            stop = threading.Event()
            names, box = {}, {}
            served = [0] * 3

            def reader(r):
                i = r
                while not stop.is_set():
                    dyn.search(queries[i % len(queries)], 10, L=args.L)
                    served[r] += 1
                    i += 3

            vecs = [next(held) for _ in range(args.inserts)]
            with gate_off() if mode == "free" else contextlib.nullcontext():
                ts = [threading.Thread(target=reader, args=(r,))
                      for r in range(3)]
                for r, t in enumerate(ts):
                    t.start()
                    names[t.ident] = f"reader{r}"
                t0 = time.perf_counter()
                w = threading.Thread(target=lambda: box.update(
                    clock.run(dyn, vecs)))
                w.start()
                names[w.ident] = "writer"
                frames = sample_frames(names, args.seconds) \
                    if sampled else None
                w.join()
                span = time.perf_counter() - t0
                stop.set()
                for t in ts:
                    t.join()
            if sampled:
                emit("sample", gate=mode, seconds=args.seconds,
                     frames=frames)
            else:
                emit("inserts", readers=3, gate=mode,
                     reader_qps=round(sum(served) / span, 2), **box)
        dyn.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "ingest_contention.json"),
                  "w") as f:
            json.dump(OUT, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
