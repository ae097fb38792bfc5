#!/usr/bin/env python3
"""Time the port's segment sum (`kernels/segment.py`, `csrc/gnn_kernels.cu`)
of one or more source trees on the card, at ogb_products' full size.

    python3 scripts/segment_bench.py [--root DIR ...] [--bands MB ...]
                                     [--profile]

Each DIR is the root of a checkout (default: this one); its
`src/repro_torch` is imported, and its kernels built, in a process of its
own. To compare two commits on one card, unpack the other into a
directory that .gitignore lists (`git archive`) and name both roots in
turns: parent, change, change, parent.

The graph is graphsage-reddit's `make_graph` draw at ogb_products' size
(2,449,029 nodes, 61,225,725 edges, as `chip_smoke.py` draws it), made
once on the host and shared by every root. Each root
builds its two CSRs on the card (`prepare_csr`, seconds printed) and
times, with CUDA events over 10 calls after a warm-up:
  - the forward (the destination CSR) at F = 100 (the features' width)
    and F = 128 (the hidden width), and the backward (the source CSR) at
    F = 128, on seeded normal inputs;
  - the library's one call for each (`torch.sparse.mm` of the CSR's
    adjacency, cuSPARSE's SpMM);
  - bytes of the bound: x and the sum (2 N F 4), the row pointers
    ((N + 1) 8) and the column ids (E 4), over 3.35 TB/s; the adds (E F)
    over 67 TFLOP/s;
  - a checksum of each output's bits (equal checksums: bit-equal sums at
    the same inputs, as between two trees with the same summation order).
`--bands MB ...`: the backward again with the source CSR rebuilt at each
destination band (trees with `segment.BAND_ROWS`; 0 = no bands).
Trees whose destination CSR stages hot sources also time that forward
with nothing staged. `--profile`: one forward and one backward under
torch.profiler, each kernel's device time. Prints the card line, then one JSON object a root
and case.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HBM = 3.35e12
F32_FLOPS = 67e12
REPS = 10


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def draw(out: str) -> None:
    """ogb_products' graph as chip_smoke.py draws it, saved as npy."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_graph
    arch = get_arch("graphsage-reddit")
    s = arch.shape("ogb_products")
    g = make_graph(s.n_nodes, max(2, s.n_edges // s.n_nodes), s.d_feat,
                   arch.model.n_classes)
    np.save(os.path.join(out, "edges.npy"), g["edges"])
    with open(os.path.join(out, "n.json"), "w") as f:
        json.dump({"n": s.n_nodes, "d_feat": s.d_feat}, f)


def cuda_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def checksum(t) -> int:
    import torch
    w = t.view(torch.int32).long()
    return int((w * torch.arange(1, w.shape[1] + 1, device=w.device)).sum())


def bound(N: int, E: int, F: int) -> dict:
    nbytes = 2 * N * F * 4 + (N + 1) * 8 + E * 4
    t_b, t_o = nbytes / HBM * 1e3, E * F / F32_FLOPS * 1e3
    return dict(nbytes=nbytes, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def worker(root: str, graph: str, label: str, bands, profile: bool) -> None:
    import time

    import numpy as np
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels import segment
    from repro_torch.kernels.segment import csr_sum, prepare_csr
    card = card_line()
    with open(os.path.join(graph, "n.json")) as f:
        N = json.load(f)["n"]
    edges = torch.from_numpy(np.load(os.path.join(graph, "edges.npy"))
                             ).cuda()

    def build():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        csr = prepare_csr(edges, N)
        torch.cuda.synchronize()
        return csr, time.perf_counter() - t0

    csr, csr_s = build()
    csr_s2 = build()[1]               # the second build: no first-use cost
    gen = torch.Generator("cuda").manual_seed(0)
    x = {F: torch.randn((N, F), generator=gen, device="cuda")
         for F in (100, 128)}

    def emit(case, **kw):
        print(json.dumps(dict(root=label, case=case, **kw, card=card)),
              flush=True)

    def adjacency(c):
        return torch.sparse_csr_tensor(
            c.indptr.to(torch.int32), c.col,
            torch.ones(c.col.shape[0], dtype=torch.float32, device="cuda"),
            (c.n_rows, c.n_cols))

    plans = {}
    for name, c in (("by_dst", csr.by_dst), ("by_src", csr.by_src)):
        plans[name] = dict(rows=c.n_rows, nnz=int(c.col.shape[0]),
                           hub_rows=int(c.hub_rows.shape[0]),
                           chunks=c.n_chunks)
        for k in ("n_hot", "band_rows"):
            if hasattr(c, k):
                plans[name][k] = int(getattr(c, k))
    emit("csr", csr_build_s=round(csr_s, 3), csr_build_again_s=round(
        csr_s2, 3), **plans)
    for case, c, F in (("forward", csr.by_dst, 100),
                       ("forward", csr.by_dst, 128),
                       ("backward", csr.by_src, 128)):
        xs = x[F]
        out = csr_sum(xs, c)
        ms = cuda_ms(lambda: csr_sum(xs, c))
        adj = adjacency(c)
        lib_ms = cuda_ms(lambda: torch.sparse.mm(adj, xs))
        diff = float((torch.sparse.mm(adj, xs) - out).abs().max())
        del adj
        emit(case, F=F, ms=ms, library_ms=lib_ms, library_max_diff=diff,
             checksum=checksum(out), **bound(N, int(c.col.shape[0]), F))
        del out
    if hasattr(csr.by_dst, "hot_ids"):
        # the same forward with nothing staged
        cold = csr.by_dst._replace(hot_ids=csr.by_dst.hot_ids[:0],
                                   hot_col=csr.by_dst.col)
        emit("forward_unstaged", F=128, ms=cuda_ms(lambda: csr_sum(x[128],
                                                                  cold)),
             checksum=checksum(csr_sum(x[128], cold)))
        del cold
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        for case, c, F in (("forward", csr.by_dst, 128),
                           ("backward", csr.by_src, 128)):
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
                csr_sum(x[F], c)
                torch.cuda.synchronize()
            kern = {}
            for e in p.key_averages():
                t = getattr(e, "device_time_total", None)
                if t is None:
                    t = getattr(e, "cuda_time_total", 0)
                if t and ("segment" in e.key or "emset" in e.key):
                    kern[e.key[:80]] = round(t / 1e3, 5)
            emit("profile_" + case, F=F, device_ms_by_kernel=kern)
    if bands and hasattr(segment, "BAND_ROWS"):
        del csr
        torch.cuda.empty_cache()
        keep = segment.BAND_ROWS
        for mb in bands:
            segment.BAND_ROWS = int(mb * 2 ** 20) // (128 * 4)
            c = prepare_csr(edges, N).by_src
            n_bands = (int(c.col.max()) // segment.BAND_ROWS + 1
                       if segment.BAND_ROWS else 0)
            ms = cuda_ms(lambda: csr_sum(x[128], c))
            emit("backward_band", band_mb=mb, band_rows=segment.BAND_ROWS,
                 bands=n_bands, chunks=c.n_chunks, ms=ms,
                 checksum=checksum(csr_sum(x[128], c)))
            del c
            torch.cuda.empty_cache()
        segment.BAND_ROWS = keep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", nargs="*", default=[ROOT])
    ap.add_argument("--bands", nargs="*", type=float, default=[])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--worker", nargs=3, metavar=("ROOT", "GRAPH", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker, args.bands, args.profile)
        return 0
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory() as graph:
        draw(graph)
        for i, root in enumerate(args.root):
            label = f"{i}:{os.path.relpath(os.path.abspath(root), ROOT)}"
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   os.path.abspath(root), graph, label, "--bands",
                   *map(str, args.bands)]
            if args.profile:
                cmd.append("--profile")
            r = subprocess.run(cmd, timeout=1200)
            if r.returncode:
                print(f"root {root} failed ({r.returncode})", flush=True)
                return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
