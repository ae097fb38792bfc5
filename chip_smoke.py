#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failed check raises, so the exit code is
non-zero):
  1. environment: card name and power limit, torch/CUDA versions, nvcc build
     of `src/repro_torch/kernels/csrc/aisaq_kernels.cu`;
  2. kernel parity: every CUDA kernel against its plain PyTorch version on
     the card, at SIFT1M widths (f32, l2; batches of 1, 64 and 256),
     SIFT1B widths (u8, mips), KILT-E5-22M widths (d=1024, R=69, mips) and
     an m=80 layout whose last LUT slab is short, each with a query whose
     frontier is all -1; the int8 hop bit-equal to int32 sums of
     `ref.quantize_lut`'s codes rescaled by scale * INV127; the hop's
     shared-memory plan and occupancy; pq_lut and
     rerank (as a tensor and by id from f32 and u8 chunk rows, with ids
     < 0 and past the table, and d not a multiple of 4) at every width
     and the SASRec one, batches of 1, 64 and 256; the `[lut]` and
     `[rerank]` plan lines; and the bulk ADC at every
     `ADC_CASES` shape (f32 and int8 LUT, u8 and i32 codes; pq_adc_q8
     bit-equal to its int32 recomputation), a table at an odd byte offset
     and an all-zero LUT;
  3. the main path: a 10k-vector SIFT1M-width index (Vamana graph, PQ
     trained on the card, chunk table packed on the card) served through
     `ServingEngine` + `make_device_search_fn(L=256, rerank=100)`, f32 and
     int8, the search loop running as CUDA graphs of K hops; recall@10
     against brute-force groundtruth, agreement with the plain
     (`backend="ref"`) search, and every kernel's launch count (a graph
     replay counts each launch it holds); one
     served batch profiled (its device ops: one rerank_kernel and no
     chunk-row copy); then the `[hop]` lines: the fused hop's time with
     one LUT and with the LUT rotated out of L2, its registers, shared
     memory and resident CTAs; the `[lut]` and `[rerank]` times (pq_lut
     at batch 64 and 256, rerank of gathered
     candidates, and the serving rerank step: the gather route that
     served it before rerank_rows (index_select, slice, rerank, where)
     against one rerank_rows); the `[search_graph]` line: the graph
     search against the same steps launched eagerly with one read a hop
     (ids, distances and hops equal; batches 64, 37 and 1), the host syncs
     of a search (at most ceil(hops / K) + 1) and each graph's capture
     time; the `[write_load]` line: the index written by the port's
     `write_index`, reloaded by `load_device_index` (same table, same
     answers), and built again by `build_index` on the card;
  4. DiskANN placement: the same 10k vectors, graph and codes re-packed
     with mode="diskann" and served the same way; recall@10, agreement with
     phase 3, fast-tier bytes of both placements at batch 64, the time of
     each placement's hop alone and per hop of a batch-64 search (the
     graph search equal to the eager one in both placements);
  5. deployment size: a 1M-node SIFT1M-width chunk table (7.94 GB) on the
     card over the random R-regular start graph, served in batches of 64
     and 256; QPS, hops, the graph search's wall time against the eager
     one-read-a-hop search's (equal answers), host syncs a search, time
     per hop, fused_hop bytes/s, peak memory, and one profiled search each
     for f32 and int8 at both batches: device busy time by kernel, idle
     share, device ops per hop, and the device time of the same graph
     replays back to back from CUDA events; the f32 batch-64 search's
     wall time at K = 2, 4, 8 and 16 hops a replay (`[search_k]`);
  6. recommender retrieval: SASRec at full width (embed_dim 50, seq_len 50,
     2 blocks) against 1,000,000 candidates (retrieval_cand), PQ m=10
     trained and encoded on the card, 64 one-user requests through
     `make_retrieval_fn` (the request as one CUDA graph: pq_lut + pq_adc
     kernels) and through the eager `retrieval_topk_pq`; latency p50/p99
     of both, agreement with the plain path, overlap with exact top-100,
     launches, one request's wall against the device busy time of the
     same request launched eagerly under the profiler and the replay's
     device time from CUDA events, and the path's own LUTs and ADC
     distances against their plain versions;
  7. bulk ADC: 8 queries against 1,000,000 codes at m=16 through `ops.adc`
     and `pq_adc_q8`; the int8 error bound and top-10 overlap;
  8. the `[adc]` lines: for the retrieval, bulk and wide shapes and each
     LUT dtype, `adc_plan`'s plan, registers, spills, resident CTAs, the
     time at the shape and at one tile a CTA (mostly the LUT staging),
     and one device op a call;
  9. `[storage]`: the 10k index of phase 3 as written to disk (and its
     DiskANN placement) searched from its files by
     `HostIndex(device="cuda")` — chunks read through the block cache,
     each hop's arithmetic on the card (`fused_hop` over the staged rows,
     the int8 ADC as a gather, the DiskANN frontier through `rerank`):
     256 queries in batches of 64 at L=256, rerank 100, f32 and int8,
     prefetch 0 and 4; agreement with device="cpu", recall, the int8 gap,
     equal ids with and without prefetch, QPS, hops / reads / bytes a
     query, load time, resident bytes, the peak device bytes of one
     batch, busy and idle share from the profiler, and the launches of
     the path;
 10. `[storage1m]`: phase 5's 1M index written through the port's
     `write_index` (8.19 GB of chunks; N cut in steps of 100k if the disk
     lacks room) and searched at batches of 64 and 256, f32 and int8,
     once with the file's pages dropped and once warm; the same figures
     (recall not judged), and the peak device bytes of one batch-64
     search within 1 MB of the 10k one and at most 32 MB;
 11. `[switch]`: `IndexManager` over two 10k indices sharing centroids,
     then over the 10k and 1M indices: median switch time, load times;
 12. `[serve_launch]`: `repro_torch.launch.serve.main` on the card over
     its demo index: QPS and latency as it prints them.
Each path's launch counts are reset just before it and read just after;
the kernels line gives the main path's as `launches` and the storage
path's as `launches_storage`. The run's index directories live in one
temporary directory, removed at exit.
Each profiled window whose counts are checked (the device ops of a
kernel call, the served batch) must show every launch the wrappers
counted in it (`profile_window`); the other windows (the profiled
searches and the serving rerank step at 1M nodes, the SASRec request)
print how many they show. On
the H100 host a window opened after a minute without one lost device
events, whole windows or parts of them, for the rest of the process,
while a fresh process did not: so the first window opens after the 10k
build's two host-only minutes, CUPTI stays up between windows, and a
window that lost a launch is run again (up to 4 times).
Then the card line, the `kernels` JSON line (times at each kernel's path
shapes) and the result line.

Needs a CUDA card and the CUDA toolkit (`nvcc`); without a card it exits
non-zero and prints no result.
"""
from __future__ import annotations

import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet) for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores

SRC = "src/repro_torch/kernels/csrc/aisaq_kernels.cu"
REPLACES = {
    "fused_hop_f32": "src/repro/kernels/chunk_adc.py:49",
    "fused_hop_int8": "src/repro/kernels/chunk_adc.py:161",
    "pq_lut": "src/repro/kernels/pq_lut.py:17",
    "rerank": "src/repro/kernels/rerank.py:14",
    "pq_adc": "src/repro/kernels/pq_adc.py:19",
    "pq_adc_q8": "src/repro/kernels/pq_adc.py:37",
}
# search list size L and rerank depth of the served configuration. At
# SIFT1M widths (m=128 subspaces of one dimension) the reference's int8 LUT
# recipe (one scale per query) costs recall during traversal; a longer list
# absorbs it: the int8 recall gap at L=100 is printed beside the served one.
SEARCH_L = 256
RERANK = 100
# the kernels of the ANN search path (phase 3)
SEARCH_KERNELS = ("fused_hop_f32", "fused_hop_int8", "pq_lut", "rerank")
# the name each kernel has in a profile (every kernel of the port)
PORT_SYMBOLS = ("hop_kernel", "pq_lut_kernel", "rerank_kernel",
                "pq_adc_kernel")
TOL_DIST = 1e-4          # pq_lut / rerank rtol, atol (tests/test_kernels.py)
TOL_HOP = 2e-6           # fused_hop scaled atol (tests/test_kernels.py)
HOP_REPEATS = 20         # repeats of each parity hop that must match bits
# PQ of the SASRec candidates: m=10 (dsub 5), 6 Lloyd iterations, as
# benchmarks/bench_device.py recsys_pq_retrieval trains them
RECSYS_PQ_M = 10
RECSYS_PQ_ITERS = 6
TOL_ADC = (1e-5, 1e-4)   # pq_adc rtol, atol (tests/test_kernels.py)
# (nq, n, m) of the ADC parity cases: the retrieval shape (one SASRec user
# against 1M candidates, m=10), the bulk-scoring shape (8 queries, m=16),
# a wide LUT (m=128: one f32 query a group, all four int8 queries), n not a
# multiple of the tile, n below one tile (and n = 1), 20 queries (several
# groups), m=50, and LUTs too wide for shared memory (f32 at m=256, both
# dtypes at m=1024: the global-LUT path). Every case runs u8 and i32 codes.
ADC_CASES = ((1, 1_000_000, 10), (8, 1_000_000, 16), (4, 50_000, 128),
             (2, 100_003, 16), (3, 100, 16), (2, 1, 10), (20, 30_000, 16),
             (4, 20_000, 50), (1, 5_000, 256), (2, 3_000, 1024))
RETRIEVAL_SHAPE, BULK_SHAPE, WIDE_SHAPE = ADC_CASES[:3]


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def device_ms(fns) -> float:
    """Device time of one call, from a CUDA graph of len(fns) calls (each
    its own inputs, so gathered rows are not served from L2 by the previous
    call), replayed three times and timed with CUDA events."""
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


def host_syncs(fn):
    """How many times fn made the host wait for the card, and fn's result:
    torch.cuda's sync debug mode warns once at each synchronizing call (a
    copy to the host, `.item()`, `.tolist()`)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n = sum("called a synchronizing CUDA operation" in str(w.message)
            for w in caught)
    return n, out


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def close_err(a, b) -> float:
    """Max |a-b|; raises past rtol/atol TOL_DIST."""
    import torch
    a, b = a.float(), b.float()
    err = (a - b).abs()
    lim = TOL_DIST + TOL_DIST * b.abs()
    require(bool((err <= lim).all()),
            f"mismatch beyond rtol=atol={TOL_DIST}: max err "
            f"{float(err.max())}")
    return float(err.max())


def hop_err(got, want) -> float:
    """fused_hop outputs: ids equal, finite masks equal, distances within
    scaled atol TOL_HOP. Returns the max abs distance error."""
    import torch
    e1, i1, d1 = got
    e2, i2, d2 = want
    require(torch.equal(i1, i2), "fused_hop ids differ from plain version")
    worst = 0.0
    for a, b in ((e1, e2), (d1, d2)):
        fin = torch.isfinite(b)
        require(torch.equal(torch.isfinite(a), fin),
                "fused_hop +inf pattern differs from plain version")
        scale = float(b[fin].abs().max()) + 1e-6
        err = float((a[fin] - b[fin]).abs().max())
        require(err / scale <= TOL_HOP,
                f"fused_hop distance err {err} > {TOL_HOP} * {scale}")
        worst = max(worst, err)
    return worst


def adc_err(got, want) -> float:
    """pq_adc output against its plain version: max abs error; raises past
    rtol, atol TOL_ADC."""
    rtol, atol = TOL_ADC
    err = (got - want).abs()
    require(bool((err <= atol + rtol * want.abs()).all()),
            f"pq_adc mismatch beyond rtol={rtol}, atol={atol}: max err "
            f"{float(err.max())}")
    return float(err.max())


def q8_err(got, want) -> float:
    """pq_adc_q8 output against `ref.pq_adc_q8_ref` (int32 sums of
    `ref.quantize_lut`'s codes, rescaled by scale * INV127): bit-equal, or
    raises. Returns the max abs error (0.0)."""
    import torch
    if not torch.equal(got, want):
        diff = (got - want).abs()
        raise AssertionError(
            f"pq_adc_q8 differs from the int32 recomputation: "
            f"{int((diff > 0).sum())} of {diff.numel()} differ, max "
            f"{float(diff.max())}")
    return 0.0


def adc_parity():
    """pq_adc and pq_adc_q8 against their plain versions on the card, u8
    and i32 codes, at every ADC_CASES shape; a 2-D LUT gives row 0; a
    table at an odd byte offset (codes[1:], read with plain loads); an
    all-zero LUT for pq_adc_q8 (the 1e-20 clamp). Returns the max abs error
    of pq_adc at the retrieval shape and of pq_adc_q8 at the bulk shape, u8
    codes (where each runs)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pq_adc import adc_plan, pq_adc, pq_adc_q8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    errs = {}

    def check(lut, codes, what):
        got, want = pq_adc(lut, codes), ref.adc_ref(lut, codes)
        err = adc_err(got, want)
        q8 = pq_adc_q8(lut, codes)
        err_q8 = q8_err(q8, ref.pq_adc_q8_ref(lut, codes))
        bound = lut.shape[1] * float(lut.abs().max()) / 127
        require(float((q8 - want).abs().max()) <= bound + 1e-3,
                f"pq_adc_q8 {what}: past the int8 bound {bound}")
        require(torch.equal(pq_adc(lut[0], codes), got[0])
                and torch.equal(pq_adc_q8(lut[0], codes), q8[0]),
                f"{what}: a 2-D LUT does not give the first query's row")
        return err, err_q8

    for nq, n, m in ADC_CASES:
        lut = torch.rand((nq, m, 256), generator=g, device=dev) * 3
        codes8 = torch.randint(0, 256, (n, m), generator=g, device=dev,
                               dtype=torch.uint8)
        for codes in (codes8, codes8.to(torch.int32)):
            err, err_q8 = check(lut, codes, f"{nq}x{n}x{m}")
            if codes.dtype == torch.uint8:
                if (nq, n, m) == RETRIEVAL_SHAPE:
                    errs["pq_adc"] = err
                if (nq, n, m) == BULK_SHAPE:
                    errs["pq_adc_q8"] = err_q8
            plans = {dt: adc_plan(nq, m, 256, codes.dtype, dt)
                     for dt in ("f32", "int8")}
            log("parity", kernel="pq_adc", nq=nq, n=n, m=m,
                codes=str(codes.dtype).split(".")[1],
                groups=f"{plans['f32'].n_groups}/{plans['int8'].n_groups}",
                global_lut=f"{plans['f32'].global_lut}/"
                           f"{plans['int8'].global_lut}",
                pq_adc_err=err, pq_adc_q8_err=err_q8)
    # a table that does not start 16-byte aligned (m=10, one row in)
    lut = torch.rand((3, 10, 256), generator=g, device=dev) * 3
    codes = torch.randint(0, 256, (40_001, 10), generator=g, device=dev,
                          dtype=torch.uint8)[1:]
    require(codes.data_ptr() % 16 != 0, "codes[1:] should be misaligned")
    err, err_q8 = check(lut, codes, "codes[1:]")
    # an all-zero LUT: scale 0, clamped to 1e-20, every distance 0
    zero = torch.zeros((2, 16, 256), device=dev)
    q8 = pq_adc_q8(zero, torch.randint(0, 256, (5_000, 16), generator=g,
                                       device=dev, dtype=torch.uint8))
    require(bool((q8 == 0).all()), "pq_adc_q8 of an all-zero LUT is not 0")
    log("parity", kernel="pq_adc", note="odd byte offset and zero LUT",
        offset=codes.data_ptr() % 16, pq_adc_err=err, pq_adc_q8_err=err_q8,
        zero_lut_q8_max=float(q8.abs().max()))
    return errs


def random_table(N, d, dtype, R, m, device, seed):
    import torch
    from repro_torch.core.chunk_layout import ChunkLayout, \
        pack_chunks_device, pack_chunks_torch
    rng = np.random.default_rng(seed)
    lay = ChunkLayout("aisaq", d, dtype, R, m)
    vecs = (rng.integers(0, 255, (N, d)).astype(np.uint8) if dtype == "uint8"
            else rng.normal(size=(N, d)).astype(np.float32))
    adj = rng.integers(-1, N, (N, R)).astype(np.int32)
    codes = rng.integers(0, 256, (N, m)).astype(np.uint8)
    words = pack_chunks_torch(torch.from_numpy(vecs).to(device),
                              torch.from_numpy(adj).to(device),
                              torch.from_numpy(codes).to(device), lay)
    ref = np.ascontiguousarray(pack_chunks_device(vecs, adj, codes, lay))
    require(np.array_equal(words.cpu().numpy().view(np.uint8).reshape(N, -1),
                           ref), "device packer bytes differ from numpy's")
    return lay, words


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env():
    import torch
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    log("env", card=repr(card_line()), torch=torch.__version__,
        cuda=torch.version.cuda, device=repr(torch.cuda.get_device_name(0)),
        nvcc_build_s=f"{_build.build_seconds}",
        load_s=f"{time.perf_counter() - t0:.3f}")


def hop_q8_exact(words, fids, lut, q, lay, metric):
    """The int8 hop's nbr_d rebuilt from `ref.quantize_lut`'s codes: int32
    sums on the card, times scale * INV127 in float32, +inf where
    invalid."""
    import torch
    from repro_torch.kernels import ref
    lut_q8, scale = ref.quantize_lut(lut)
    _, _, codes, nvalid = ref.expand_rows_ref(words, fids, q, lay,
                                              metric=metric)
    nq, w, R, m = codes.shape
    ks = lut.shape[-1]
    idx = codes.long() + torch.arange(m, device=lut.device) * ks
    flat = lut_q8.reshape(nq, 1, 1, m * ks).expand(nq, w, R, m * ks)
    acc = torch.gather(flat, 3, idx).sum(-1, dtype=torch.int32)
    # scale times float32(1/127), as the reference rescales under jax.jit
    # (XLA multiplies by the rounded reciprocal; a true quotient differs in
    # the last bit on ~4% of scales)
    d = acc.float() * ref.rescale127(scale)[:, None, None]
    return torch.where(nvalid, d, torch.inf)


def hop_parity(words, lay, lut, q, fids, metric):
    """fused_hop f32 and int8 against the plain version, and repeated
    HOP_REPEATS times to the same bits; the int8 nbr_d also bit-equal to
    `hop_q8_exact` and within the int8 bound of f32. Returns the max abs
    error of each dtype."""
    import torch
    from repro_torch.kernels import ops
    errs = {}
    args = (words, fids, lut, q)
    for adc in ("f32", "int8"):
        kw = dict(layout=lay, metric=metric, adc_dtype=adc)
        got = ops.fused_hop(*args, **kw)
        errs[adc] = hop_err(got, ops.fused_hop(*args, backend="ref", **kw))
        for _ in range(HOP_REPEATS):       # the same bits every time
            require(all(torch.equal(a, b) for a, b in
                        zip(ops.fused_hop(*args, **kw), got)),
                    f"fused_hop {adc} is not deterministic")
        if adc == "int8":
            want = hop_q8_exact(*args, lay, metric)
            if not torch.equal(got[2], want):
                fin = torch.isfinite(want)
                diff = (got[2][fin] - want[fin]).abs()
                step = float(lut.abs().amax() / 127)
                raise AssertionError(
                    f"int8 hop differs from the int32 sums of "
                    f"ref.quantize_lut's codes: {int((diff > 0).sum())} of "
                    f"{diff.numel()} differ, max {float(diff.max())}, "
                    f"max rel {float((diff / want[fin].abs()).max())}, "
                    f"quantization step ~{step}")
            _, _, d32 = ops.fused_hop(*args, backend="ref", layout=lay,
                                      metric=metric)
            fin = torch.isfinite(d32)
            bound = lay.pq_m * float(lut.abs().max()) / 127
            qerr = float((got[2][fin] - d32[fin]).abs().max())
            require(qerr <= bound + 1e-3,
                    f"int8 hop err {qerr} > bound {bound}")
    return errs


def rows_err(got, want) -> float:
    """rerank_rows output against its plain version: the same +inf
    pattern (ids < 0) and the finite entries within rtol/atol TOL_DIST."""
    import torch
    fin = torch.isfinite(want)
    require(torch.equal(torch.isfinite(got), fin),
            "rerank_rows +inf pattern differs from the plain version")
    return close_err(got[fin], want[fin])


def lut_rerank_parity():
    """pq_lut and rerank (candidates as a tensor, and by id from f32 and u8
    chunk rows) against their plain versions at every `[parity]` width,
    the SASRec retrieval width (m=10, dsub=5) and d not a multiple of 4,
    batches of 1, 64 and 256. Ids run from -1 past the table's end (clamped to its last
    row). Returns the max abs error of each kernel at SIFT1M widths, batch
    64 (the main path's shape; every other case is on its line)."""
    import torch
    from repro_torch.configs import KILT_E5_22M, SIFT1B, SIFT1M
    from repro_torch.kernels import ops, pq_lut
    from repro_torch.kernels.rerank import rerank_rows
    dev = torch.device("cuda")
    errs = {}
    # (name, d, data dtype, R, pq_m, metric); the odd widths have dsub 13
    # (above the 8 of a register-unrolled case) and 5
    widths = (("sift1m", SIFT1M.dim, "float32", SIFT1M.R, SIFT1M.pq_m, "l2"),
              ("sift1b", SIFT1B.dim, "uint8", SIFT1B.R, SIFT1B.pq_m, "mips"),
              ("sift1b-l2", SIFT1B.dim, "uint8", SIFT1B.R, SIFT1B.pq_m, "l2"),
              ("kilt-e5-22m", KILT_E5_22M.dim, "float32", KILT_E5_22M.R,
               KILT_E5_22M.pq_m, "mips"),
              ("short-slab", 160, "float32", 20, 80, "l2"),
              ("sasrec", 50, "float32", 8, RECSYS_PQ_M, "mips"),
              ("odd-f32", 130, "float32", 20, 10, "l2"),
              ("odd-u8", 50, "uint8", 16, 10, "mips"))
    for name, d, dt, R, m, metric in widths:
        N = 4096
        lay, words = random_table(N, d, dt, R, m, dev, 13)
        rng = np.random.default_rng(d + R)
        for nq in (1, 64, 256):
            q = torch.from_numpy(rng.normal(size=(nq, d))
                                 .astype(np.float32)).to(dev)
            if dt == "uint8":
                q = q * 40 + 128
            cents = torch.from_numpy(rng.normal(size=(m, 256, d // m))
                                     .astype(np.float32)).to(dev)
            want = ops.build_lut(q, cents, metric=metric, backend="ref")
            e_lut = close_err(pq_lut.pq_lut(q, cents, metric=metric), want)
            ids = rng.integers(-1, N + 3, (nq, RERANK)).astype(np.int32)
            ids[0, :3] = -1
            ids = torch.from_numpy(ids).to(dev)
            e_rows = rows_err(rerank_rows(q, words, ids, lay, metric=metric),
                              ops.rerank_rows(q, words, ids, lay,
                                              metric=metric, backend="ref"))
            cand = (torch.randint(0, 256, (nq, RERANK, d), device=dev)
                    .float() if dt == "uint8"
                    else torch.randn((nq, RERANK, d), device=dev))
            e_rr = close_err(ops.rerank(q, cand, metric=metric),
                             ops.rerank(q, cand, metric=metric,
                                        backend="ref"))
            # one set shared by all queries, at an odd float offset (scalar
            # loads)
            buf = torch.empty(RERANK * d + 1, device=dev)
            shared = buf[1:].view(RERANK, d)
            shared.copy_(cand[0])
            e_sh = close_err(ops.rerank(q, shared, metric=metric),
                             ops.rerank(q, shared, metric=metric,
                                        backend="ref"))
            if (name, nq) == ("sift1m", 64):
                errs = {"pq_lut": e_lut, "rerank": max(e_rows, e_rr, e_sh)}
            log("parity", kernel="pq_lut+rerank", widths=name, d=d,
                data=dt, metric=metric, nq=nq, pq_m=m,
                pq_lut_err=e_lut,
                rerank_rows_err=e_rows, rerank_err=e_rr,
                rerank_shared_odd_offset_err=e_sh)
    # a mismatched shape is refused by the launcher itself
    from repro_torch.kernels import _build
    q = torch.zeros((2, 128), device=dev)
    out = torch.empty((2, 128, 256), device=dev)
    cents = torch.zeros((128, 256, 1), device=dev)
    err = _build.lib().aisaq_pq_lut(q.data_ptr(), 2, 127, cents.data_ptr(),
                                    128, 256, 1, 0, out.data_ptr(),
                                    _build.stream())
    require(err == 1, f"pq_lut launcher took d=127 for m*dsub=128: {err}")
    return errs


def phase_parity():
    """Every kernel against its plain version at the Table-1 widths
    (SIFT1M, SIFT1B, KILT-E5-22M), batches of 1, 64 and 256 queries, and
    an m whose last LUT slab is short. Every frontier has one query whose
    row is all -1. Returns the max abs error of each kernel at SIFT1M
    widths, batch 64."""
    import torch
    from repro_torch.configs import KILT_E5_22M, SIFT1B, SIFT1M
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunk_adc import hop_occupancy
    dev = torch.device("cuda")
    errs = {}
    # m=80: slabs of 32, 32 and 16 subspaces (ring reuse and a short slab)
    short = SIFT1M.scaled(name="short-slab", dim=160, R=20, pq_m=80)
    cases = ((SIFT1M, "l2", 64), (SIFT1B, "mips", 64),
             (KILT_E5_22M, "mips", 64), (SIFT1M, "l2", 1),
             (SIFT1M, "l2", 256), (short, "l2", 64))
    for cfg, metric, nq in cases:
        rng = np.random.default_rng(7)
        w, N, ks = cfg.beamwidth, 4096, cfg.pq_ks
        d, m = cfg.dim, cfg.pq_m
        lay, words = random_table(N, d, cfg.data_dtype, cfg.R, m, dev, 11)
        q = torch.from_numpy(rng.normal(size=(nq, d)).astype(np.float32)) \
            .to(dev)
        if cfg.data_dtype == "uint8":
            q = q * 40 + 128
        cents = torch.from_numpy(rng.normal(size=(m, ks, d // m))
                                 .astype(np.float32)).to(dev)
        e_lut = close_err(ops.build_lut(q, cents, metric=metric),
                          ops.build_lut(q, cents, metric=metric,
                                        backend="ref"))
        lut = ops.build_lut(q, cents, metric=metric, backend="ref")
        fids = rng.integers(-1, N, (nq, w)).astype(np.int32)
        if nq > 1:
            fids[0] = -1                   # a query with no frontier row
        fids = torch.from_numpy(fids).to(dev)
        hop = hop_parity(words, lay, lut, q, fids, metric)
        # candidates drawn like the index's own vectors (u8 values in the
        # u8 case), so mips sums do not cancel below the tolerance
        cand = (rng.integers(0, 256, (nq, 100, d)) if cfg.data_dtype == "uint8"
                else rng.normal(size=(nq, 100, d)))
        cand = torch.from_numpy(cand.astype(np.float32)).to(dev)
        e_rr = close_err(ops.rerank(q, cand, metric=metric),
                         ops.rerank(q, cand, metric=metric, backend="ref"))
        shared = cand[0]
        close_err(ops.rerank(q, shared, metric=metric),
                  ops.rerank(q, shared, metric=metric, backend="ref"))
        occ = hop_occupancy(lay, "f32", ks, w)
        log("parity", widths=cfg.name, metric=metric, nq=nq, R=cfg.R, m=m,
            d=d, hop_group=occ["group"], hop_slabs=occ["n_slabs"],
            hop_smem=occ["dynamic_smem"], hop_ctas_per_sm=occ["ctas_per_sm"],
            hop_clusters=occ["clusters"], pq_lut_err=e_lut,
            fused_hop_f32_err=hop["f32"], fused_hop_int8_err=hop["int8"],
            int8_bit_exact=True, rerank_err=e_rr)
        if (cfg, nq) == (SIFT1M, 64):
            errs = {"pq_lut": e_lut, "fused_hop_f32": hop["f32"],
                    "fused_hop_int8": hop["int8"], "rerank": e_rr}
    for name, err in lut_rerank_parity().items():
        errs[name] = max(errs[name], err)
    errs.update(adc_parity())
    return errs


def build_index_10k(seed: int = 0):
    """The main path's index: 10k clustered vectors at SIFT1M widths."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.device_index import from_arrays
    from repro_torch.core.pq import encode, groundtruth, train_codebooks
    from repro_torch.core.vamana import build_vamana
    from repro_torch.data.vectors import make_clustered, make_queries
    n = 10_000
    base = make_clustered(n, cfg.dim, seed=seed)
    queries = make_queries(256, base, seed=seed + 1)
    t0 = time.perf_counter()
    graph = build_vamana(base, R=cfg.R, L=64, alpha=cfg.alpha, seed=seed,
                         two_pass=False)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    init = np.random.default_rng(seed).choice(n, cfg.pq_ks, replace=False)
    cents = train_codebooks(base, m=cfg.pq_m, init_idx=init, ks=cfg.pq_ks,
                            iters=12, device="cuda")
    codes = encode(cents, base, device="cuda")
    idx, lay = from_arrays(base, graph, cents, codes, device="cuda")
    gt = groundtruth(queries, base, 10, device="cuda")
    torch.cuda.synchronize()
    log("build10k", n=n, vamana_s=f"{t_graph:.1f}",
        pq_pack_gt_s=f"{time.perf_counter() - t0:.2f}",
        table_bytes=idx.chunk_words.numel() * 4,
        device_stride=lay.device_stride)
    return idx, lay, queries, gt, (base, graph, cents, codes)


def phase_main_path(idx, lay, queries, gt):
    """Serve the queries end to end, f32 and int8, with counts reset just
    before and read just after."""
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.pq import recall_at
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServingEngine, \
        make_device_search_fn
    kw = dict(metric="l2", L=SEARCH_L, w=cfg.beamwidth,
              max_hops=cfg.max_hops, rerank=RERANK)
    fns = {adc: make_device_search_fn(idx, lay, adc_dtype=adc, **kw)
           for adc in ("f32", "int8")}
    _build.reset_launch_counts()
    eng = ServingEngine(fns, max_batch=64, max_wait_ms=2.0)
    t0 = time.perf_counter()
    try:
        reqs = {adc: [eng.submit(q, corpus=adc, k=10) for q in queries]
                for adc in fns}
        for rs in reqs.values():
            for r in rs:
                require(r.event.wait(120.0), "request timed out")
                if r.error is not None:
                    raise r.error
    finally:
        eng.stop()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    ids = {adc: np.stack([r.result for r in rs]) for adc, rs in reqs.items()}
    rec = {adc: recall_at(v, gt, 10) for adc, v in ids.items()}
    lat = eng.latency_percentiles()
    agree = {}
    for adc in fns:
        ref_fn = make_device_search_fn(idx, lay, adc_dtype=adc,
                                       backend="ref", **kw)
        ref_ids = np.concatenate([ref_fn(queries[s:s + 64], 10)
                                  for s in range(0, len(queries), 64)])
        agree[adc] = float(np.mean([len(set(a) & set(b)) / 10.0
                                    for a, b in zip(ids[adc], ref_ids)]))
    log("main_path", requests=2 * len(queries), wall_s=f"{wall:.3f}",
        recall10_f32=rec["f32"], recall10_int8=rec["int8"],
        recall1_f32=recall_at(ids["f32"], gt, 1),
        ref_agreement_f32=agree["f32"], ref_agreement_int8=agree["int8"],
        p50_ms=f"{lat['p50_ms']:.2f}", p99_ms=f"{lat['p99_ms']:.2f}",
        launches=json.dumps(launches, separators=(",", ":")))
    require(rec["f32"] >= 0.8, f"recall@10 {rec['f32']} < 0.8")
    require(abs(rec["f32"] - rec["int8"]) <= 0.01,
            f"int8 recall gap {abs(rec['f32'] - rec['int8'])} > 0.01")
    require(min(agree.values()) >= 0.99,
            f"top-10 agreement with the plain search {agree} < 0.99")
    require(all(launches[k] > 0 for k in SEARCH_KERNELS),
            f"a kernel was not launched on the main path: {launches}")
    short = {}
    for adc in fns:
        fn = make_device_search_fn(idx, lay, adc_dtype=adc,
                                   **dict(kw, L=RERANK))
        short[adc] = recall_at(np.concatenate(
            [fn(queries[s:s + 64], 10) for s in range(0, len(queries), 64)]),
            gt, 10)
    log("main_path", note="shorter list", L=RERANK,
        recall10_f32=short["f32"], recall10_int8=short["int8"])
    serving_batch_profile(fns["f32"], queries[:64])
    return launches, ids["f32"]


def serving_batch_profile(fn, queries):
    """One served batch (64 queries, f32, rerank 100) under torch.profiler:
    its device ops by name. The rerank step is one rerank_kernel launch;
    no index_select of chunk rows and no copy of their vectors remain."""
    fn(queries, 10)                                         # warm
    rows, ids = profile_window(lambda: fn(queries, 10))
    n_rerank = sum(c for _, k, c in rows if "rerank_kernel" in k)
    n_select = sum(c for _, k, c in rows
                   if "indexselect" in k.lower().replace("_", ""))
    n_hops = sum(c for _, k, c in rows if "hop_kernel" in k)
    log("serve_profile", batch=len(queries), rerank=RERANK,
        device_ops=sum(r[2] for r in rows), hop_launches=n_hops,
        rerank_kernel_ops=n_rerank, index_select_ops=n_select,
        device_busy_ms=f"{sum(r[0] for r in rows):.4f}",
        profiled_launches=profiled_last(),
        ops=json.dumps([[k[:48], round(t, 4), c] for t, k, c in rows]))
    require(ids.shape == (len(queries), 10), "served batch shape")
    require(n_rerank == 1 and n_select == 0,
            f"the served batch's rerank step ran {n_rerank} rerank kernels "
            f"and {n_select} index_select ops")


def same_search(got, want, what: str) -> int:
    """Two beam_search_device results: ids, distances and hops equal, or
    raises. Returns the hops."""
    import torch
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and got[2] == want[2],
            f"{what}: the graph search differs from the eager one (hops "
            f"{got[2]} vs {want[2]})")
    return got[2]


def search_syncs(idx, lay, q, **kw):
    """Host syncs of one search and the copy of its ids to the host (the
    graphs already captured); raises past ceil(hops / K) + 1. Returns
    (syncs, hops)."""
    import math
    from repro_torch.core.device_index import HOPS_PER_SYNC, \
        beam_search_device
    hops = []

    def run():
        ids, _, h = beam_search_device(idx, q, layout=lay, **kw)
        hops.append(h)
        return ids.cpu()

    n, _ = host_syncs(run)
    cap = math.ceil(hops[0] / HOPS_PER_SYNC) + 1
    require(1 <= n <= cap, f"a search synced {n} times; hops {hops[0]}, "
            f"at most {cap}")
    return n, hops[0]


def phase_search_graph(idx, lay, queries):
    """The search loop on the card as CUDA graphs (K = HOPS_PER_SYNC hops a
    replay) against the same steps launched eagerly with one read a hop
    (K=1) on the 10k index: ids, distances and hops equal, f32 and int8,
    at batches of 64, 37 (padded to 64) and 1; the host syncs of a search
    (sync debug mode); the capture time of each graph the index holds."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.device_index import HOPS_PER_SYNC, \
        beam_search_device
    qt = torch.from_numpy(queries).cuda()
    out = {}
    for adc in ("f32", "int8"):
        kw = dict(k=RERANK, L=SEARCH_L, w=cfg.beamwidth,
                  max_hops=cfg.max_hops, metric="l2", adc_dtype=adc)
        for nq in (64, 37, 1):
            q = qt[:nq]
            hops = same_search(
                beam_search_device(idx, q, layout=lay, **kw),
                beam_search_device(idx, q, layout=lay, hops_per_sync=1,
                                   cuda_graph=False, **kw),
                f"10k {adc} batch {nq}")
            syncs, _ = search_syncs(idx, lay, q, **kw)
            out[adc, nq] = (hops, syncs)
    captures = sorted((k[0], k[6], k[8], round(g.capture_s, 4))
                      for k, g in idx.graphs.items())
    log("search_graph", K=HOPS_PER_SYNC, equal_to_eager_k1=True,
        hops_syncs=json.dumps({f"{a}/{n}": v for (a, n), v in out.items()}),
        graphs=len(idx.graphs),
        capture_s_by_batch_adc_backend=json.dumps(captures))


def phase_write_load(idx, lay, queries, arrays, root):
    """The 10k index written by the port's `write_index` into `root` (the
    run's temporary directory; the storage phases read it there) and
    reloaded with `load_device_index`: the same chunk table
    and the same answers as the in-memory index. Then `build_index` on the
    card from the same graph and initial centroid rows: PQ trained and
    encoded again (the card's float sums may reorder, so its codes are
    judged by top-10 agreement, not bits)."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.build import build_index
    from repro_torch.core.device_index import beam_search_device, \
        load_device_index
    from repro_torch.core.index_io import load_meta, write_index
    base, graph, cents, codes = arrays
    init = np.random.default_rng(0).choice(len(base), cfg.pq_ks,
                                           replace=False)
    kw = dict(k=10, L=SEARCH_L, w=cfg.beamwidth, max_hops=cfg.max_hops,
              metric="l2")
    q = torch.from_numpy(queries).cuda()
    want = beam_search_device(idx, q, layout=lay, **kw)
    path = os.path.join(root, "sift10k")
    t0 = time.perf_counter()
    write_index(path, vectors=base, graph=graph, centroids=cents,
                codes=codes, metric="l2", mode="aisaq")
    t_write = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    t0 = time.perf_counter()
    loaded, llay, metric = load_device_index(path, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    require(load_meta(path)["n"] == len(base) and metric == "l2"
            and llay == lay, "the written index's meta or layout")
    require(torch.equal(loaded.chunk_words, idx.chunk_words)
            and torch.equal(loaded.ep_ids, idx.ep_ids),
            "the reloaded chunk table differs from the in-memory one")
    same_search(beam_search_device(loaded, q, layout=llay, **kw), want,
                "reloaded index")
    del loaded
    built = os.path.join(root, "sift10k_built")
    t0 = time.perf_counter()
    meta = build_index(built, base, cfg.scaled(n_vectors=len(base)),
                       init_idx=init, graph=graph, device="cuda")
    t_build = time.perf_counter() - t0
    bidx, blay, _ = load_device_index(built, device="cuda")
    got = beam_search_device(bidx, q, layout=blay, **kw)[0].cpu().numpy()
    agree = float(np.mean([len(set(x) & set(y)) / 10.0 for x, y in
                           zip(got, want[0].cpu().numpy())]))
    log("write_load", n=len(base), write_s=f"{t_write:.3f}",
        dir_bytes=nbytes, load_s=f"{t_load:.3f}", same_table=True,
        same_answers=True, build_index_s=f"{t_build:.3f}",
        build_pq_s=f"{meta['build_pq_s']:.3f}",
        built_agreement_top10=agree)
    require(agree >= 0.99, f"the index build_index wrote agrees {agree} "
            f"with the in-memory one")


def kernel_times(idx, lay, queries, nq: int = 64, c: int = 100):
    """Kernel, plain-version and library times at the main path's shapes:
    a serving batch of nq queries, w=4 frontier slots per query on the
    10k table, c rerank candidates per query."""
    import torch
    from repro_torch.kernels import chunk_adc, ops, pq_lut
    from repro_torch.kernels.rerank import rerank_occupancy
    dev = idx.device
    m, ks, dsub = idx.centroids.shape
    d, R, S = lay.dim, lay.R, lay.device_stride
    w = 4
    reps = 20
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.from_numpy(queries[:nq]).to(dev)
    cents = idx.centroids
    lut = ops.build_lut(q, cents)
    fids = [torch.randint(0, idx.n, (nq, w), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(reps)]
    cands = [torch.randn((nq, c, d), generator=g, device=dev)
             for _ in range(reps)]
    out = {}

    def hop(backend, adc):
        return [lambda f=f: ops.fused_hop(idx.chunk_words, f, lut, q,
                                          layout=lay, backend=backend,
                                          adc_dtype=adc) for f in fids]

    hop_bytes = (nq * w * S + nq * m * ks * 4 + nq * d * 4 + nq * w * 4
                 + nq * w * 4 + 2 * nq * w * R * 4)
    hop_ops = nq * w * (R * m + 3 * d)
    # the same calls with the LUT rotated over reps copies (reps x 8.4 MB,
    # past the 50 MB L2), so each call reads its LUT from HBM as the bound
    # counts it; the row above keeps PR 12's method (one LUT for all calls,
    # as in the search loop)
    luts = [lut.clone() for _ in range(reps)]
    for adc in ("f32", "int8"):
        out[f"fused_hop_{adc}"] = dict(
            ms=device_ms(hop("auto", adc)),
            plain_ms=device_ms(hop("ref", adc)),
            library_ms=None, nbytes=hop_bytes, ops=hop_ops)
        cold = device_ms([lambda f=f, l=l: ops.fused_hop(
            idx.chunk_words, f, l, q, layout=lay, adc_dtype=adc)
            for f, l in zip(fids, luts)])
        log("hop", adc=adc, nq=nq, w=w,
            ms=f"{out[f'fused_hop_{adc}']['ms']:.5f}",
            hbm_cold_ms=f"{cold:.5f}",
            bound_ms=f"{bound_ms(hop_bytes, hop_ops)[0]:.6f}",
            **chunk_adc.hop_occupancy(lay, adc, ks, w))
    del luts

    require(bool(torch.allclose(lut_baddbmm(q, cents), lut, rtol=1e-4,
                                atol=1e-4)),
            "baddbmm LUT differs from the kernel's")
    lut_ms = lut_times(cents, {nq: q, 256: torch.from_numpy(
        queries[:256]).to(dev)}, reps)
    out["pq_lut"] = dict(
        ms=lut_ms[nq],
        plain_ms=device_ms([lambda: ops.build_lut(q, cents, backend="ref")]
                           * reps),
        library_ms=device_ms([lambda: lut_baddbmm(q, cents)] * reps),
        nbytes=lut_bytes_ops(nq, m, ks, dsub)[0],
        ops=lut_bytes_ops(nq, m, ks, dsub)[1])

    def rr_lib(cand):
        norms = (cand * cand).sum(-1) + (q * q).sum(-1)[:, None]
        return torch.baddbmm(norms[:, :, None], cand, q[:, :, None],
                             alpha=-2.0)[:, :, 0]

    dense = dict(
        ms=device_ms([lambda x=x: ops.rerank(q, x) for x in cands]),
        plain_ms=device_ms([lambda x=x: ops.rerank(q, x, backend="ref")
                            for x in cands]),
        library_ms=device_ms([lambda x=x: rr_lib(x) for x in cands]))
    b_dense, _ = bound_ms(nq * d * 4 + nq * c * d * 4 + nq * c * 4,
                          3 * nq * c * d)
    log("rerank", form="gathered", nq=nq, c=c, d=d,
        ms=f"{dense['ms']:.5f}", bound_ms=f"{b_dense:.6f}",
        pct_of_bound=f"{100 * b_dense / dense['ms']:.1f}",
        plain_ms=f"{dense['plain_ms']:.5f}",
        baddbmm_ms=f"{dense['library_ms']:.5f}",
        **rerank_occupancy(d, "dense"))
    ids = [torch.randint(0, idx.n, (nq, c), generator=g, device=dev,
                         dtype=torch.int32) for _ in range(reps)]
    out["rerank"] = serving_rerank_times(idx, lay, q, ids, "10k")
    for d_, src in ((128, "rows_u8"), (1024, "rows_f32"),
                    (130, "dense_any")):
        log("rerank", form="plan", d=d_, source=src,
            **rerank_occupancy(d_, src))
    return out


def lut_baddbmm(q, cents, metric="l2"):
    """The LUT as one batched product with its norms (the library
    yardstick of pq_lut; the port never calls it)."""
    import torch
    m, ks, dsub = cents.shape
    qs = q.reshape(q.shape[0], m, dsub).permute(1, 0, 2)    # (m, nq, dsub)
    if metric == "mips":
        return torch.bmm(qs, cents.transpose(1, 2)).neg_() \
            .permute(1, 0, 2).contiguous()
    norms = (qs * qs).sum(-1)[:, :, None] \
        + (cents * cents).sum(-1)[:, None, :]
    return torch.baddbmm(norms, qs, cents.transpose(1, 2), alpha=-2.0) \
        .permute(1, 0, 2).contiguous()


def lut_bytes_ops(nq, m, ks, dsub):
    """Bytes (queries and centroids read once, the LUT written once) and
    operations of one pq_lut call."""
    return (nq * m * dsub * 4 + m * ks * dsub * 4 + nq * m * ks * 4,
            nq * m * ks * (6 * dsub + 3))


def lut_times(cents, qs: dict, reps: int, metric="l2") -> dict:
    """pq_lut's time at each batch (qs: nq -> queries on the card), and its
    `[lut]` line: plan, registers, spills, CTAs an SM and the share of the
    byte bound."""
    from repro_torch.kernels import pq_lut
    m, ks, dsub = cents.shape
    times = {}
    for nq, q in qs.items():
        times[nq] = device_ms(
            [lambda q=q: pq_lut.pq_lut(q, cents, metric=metric)] * reps)
        b_ms, by = bound_ms(*lut_bytes_ops(nq, m, ks, dsub))
        log("lut", nq=nq, m=m, dsub=dsub, ks=ks, ms=f"{times[nq]:.5f}",
            bound_ms=f"{b_ms:.6f}", bound_by=by,
            pct_of_bound=f"{100 * b_ms / times[nq]:.1f}",
            **pq_lut.lut_occupancy(nq, m, dsub, ks))
    return times


def serving_rerank_times(idx, lay, q, ids, table: str,
                         required: bool = True) -> dict:
    """The serving path's rerank step on the same ids: the gather route
    that served it before rerank_rows (clamp, index_select of the chunk
    rows, the vector slice and its copy, the rerank kernel on the gathered
    tensor, where) against one rerank_rows launch, each call with its own
    ids; its `[rerank]` line, with each form's device ops (profile windows
    that must show their launches where required). The bound reads each
    distinct row of a call once (random ids repeat: ~4,700 distinct of
    6,400 on the 10k table). Returns rerank_rows' times and its bound's
    bytes and operations."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rerank import rerank_occupancy

    def route(i):
        cand = ref.gather_vecs(idx.chunk_words, i.clamp(0, idx.n - 1), lay)
        return torch.where(i >= 0, ops.rerank(q, cand), torch.inf)

    def rows(i, backend="auto"):
        return ops.rerank_rows(q, idx.chunk_words, i, lay, backend=backend)

    rows_err(rows(ids[0]), route(ids[0]))
    nq, c = ids[0].shape
    distinct = float(np.mean([int(torch.unique(i.clamp(0, idx.n - 1)).numel())
                              for i in ids]))
    t = dict(ms=device_ms([lambda i=i: rows(i) for i in ids]),
             plain_ms=device_ms([lambda i=i: rows(i, "ref") for i in ids]),
             library_ms=None,
             nbytes=nq * lay.dim * 4 + nq * c * 4
             + distinct * lay.padded_vec_bytes + nq * c * 4,
             ops=3 * nq * c * lay.dim)
    route_ms = device_ms([lambda i=i: route(i) for i in ids])
    b_ms, _ = bound_ms(t["nbytes"], t["ops"])
    n_rows = device_ops(lambda: rows(ids[0]), required)
    rows_seen = profiled_last()
    n_route = device_ops(lambda: route(ids[0]), required)
    log("rerank", form="serving step", table=table, nq=nq, c=c, d=lay.dim,
        rerank_rows_ms=f"{t['ms']:.5f}", gather_route_ms=f"{route_ms:.5f}",
        route_over_rows=f"{route_ms / t['ms']:.2f}",
        distinct_rows=f"{distinct:.1f}", bound_ms=f"{b_ms:.6f}",
        pct_of_bound=f"{100 * b_ms / t['ms']:.1f}",
        plain_ms=f"{t['plain_ms']:.5f}", rows_device_ops=n_rows,
        rows_profiled_launches=rows_seen, route_device_ops=n_route,
        route_profiled_launches=profiled_last(),
        **rerank_occupancy(lay.dim, "rows_u8" if lay.data_dtype == "uint8"
                           else "rows_f32"))
    return t


def graph_device_ms(idx, nq, adc, hops) -> float:
    """Device time of one search's graphs replayed back to back (the
    prologue and ceil(hops / K) K-hop replays of the batch's cached
    graphs, f32 or int8, kernel backend), from CUDA events: the search's
    device work without the host's reads in between."""
    import math
    import torch
    from repro_torch.core.device_index import HOPS_PER_SYNC, _pad_rows
    g = next(g for k, g in idx.graphs.items()
             if k[0] == _pad_rows(nq) and k[6] == adc and k[8] == "auto")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    g.prologue.replay()
    for _ in range(math.ceil(hops / HOPS_PER_SYNC)):
        g.hops.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_deployment():
    """1M nodes at SIFT1M widths; recall is not judged (random graph).
    Returns the index's host arrays (vectors, graph, centroids, codes) and
    its queries, for the storage phases."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.device_index import HOPS_PER_SYNC, \
        beam_search_device, from_arrays
    from repro_torch.core.pq import encode, train_codebooks
    from repro_torch.core.vamana import random_regular_graph
    from repro_torch.data.vectors import make_clustered, make_queries
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import make_device_search_fn
    n = 1_000_000
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = make_clustered(n, cfg.dim, seed=2)
    queries = make_queries(256, base, seed=3)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    vecs = torch.from_numpy(base).cuda()
    graph = random_regular_graph(n, cfg.R, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    sample = torch.from_numpy(rng.choice(n, 100_000, replace=False)).cuda()
    cents = train_codebooks(vecs[sample], m=cfg.pq_m,
                            init_idx=rng.choice(100_000, cfg.pq_ks,
                                                replace=False),
                            ks=cfg.pq_ks, iters=12, device="cuda")
    codes = encode(cents, vecs, device="cuda")
    idx, lay = from_arrays(vecs, graph, cents, codes, device="cuda")
    host_arrays = (base, graph.cpu().numpy(), cents.cpu().numpy(),
                   codes.cpu().numpy())
    del vecs, graph, codes
    torch.cuda.synchronize()
    table = idx.chunk_words.numel() * 4
    log("build1m", n=n, data_s=f"{t_data:.1f}",
        graph_pq_pack_s=f"{time.perf_counter() - t0:.2f}", table_bytes=table,
        note="random R-regular graph: recall is not judged at this size")
    require(table == n * lay.device_stride, "chunk table size")
    qt = torch.from_numpy(queries).cuda()
    searches = {}
    for adc in ("f32", "int8"):
        for nq in (64, 256):
            fn = make_device_search_fn(idx, lay, metric="l2", L=SEARCH_L,
                                       w=cfg.beamwidth,
                                       max_hops=cfg.max_hops, adc_dtype=adc,
                                       rerank=RERANK)
            fn(queries[:nq], 10)                   # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = fn(queries[:nq], 10)
            t_serve = time.perf_counter() - t0
            require(ids.shape == (nq, 10) and (ids >= 0).all(),
                    "deployment search returned bad ids")
            kw = dict(k=RERANK, L=SEARCH_L, w=cfg.beamwidth,
                      max_hops=cfg.max_hops, layout=lay, metric="l2",
                      adc_dtype=adc)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graphed = beam_search_device(idx, qt[:nq], **kw)
            torch.cuda.synchronize()
            t_search = time.perf_counter() - t0
            hops = graphed[2]
            t0 = time.perf_counter()
            eager = beam_search_device(idx, qt[:nq], hops_per_sync=1,
                                       cuda_graph=False, **kw)
            torch.cuda.synchronize()
            t_eager = time.perf_counter() - t0
            same_search(graphed, eager, f"1M {adc} batch {nq}")
            syncs, _ = search_syncs(idx, lay, qt[:nq], **{
                k: v for k, v in kw.items() if k != "layout"})
            events_ms = graph_device_ms(idx, nq, adc, hops)
            searches[adc, nq] = dict(wall_ms=t_search * 1e3, hops=hops,
                                     syncs=syncs, events_ms=events_ms,
                                     eager_ms=t_eager * 1e3)
            lut = ops.build_lut(qt[:nq], idx.centroids)
            g = torch.Generator(device="cuda").manual_seed(1)
            fids = [torch.randint(0, n, (nq, cfg.beamwidth), generator=g,
                                  device="cuda", dtype=torch.int32)
                    for _ in range(20)]
            hop_ms = device_ms([lambda f=f: ops.fused_hop(
                idx.chunk_words, f, lut, qt[:nq], layout=lay,
                adc_dtype=adc) for f in fids])
            w = cfg.beamwidth
            hop_bytes = (nq * w * lay.device_stride + nq * cfg.pq_m * 256 * 4
                         + nq * (w + 2 * w * cfg.R) * 4 + nq * cfg.dim * 4)
            log("deploy", adc=adc, batch=nq, qps=f"{nq / t_serve:.1f}",
                serve_ms=f"{t_serve * 1e3:.2f}", hops=hops,
                search_ms=f"{t_search * 1e3:.3f}",
                eager_k1_search_ms=f"{t_eager * 1e3:.3f}",
                search_ms_per_hop=f"{t_search * 1e3 / hops:.4f}",
                K=HOPS_PER_SYNC, host_syncs=syncs,
                fused_hop_ms=f"{hop_ms:.4f}",
                fused_hop_GBps=f"{hop_bytes / hop_ms / 1e6:.1f}",
                hbm_share=f"{hop_bytes / hop_ms * 1e3 / HBM_BYTES_PER_S:.4f}")
    log("deploy", peak_device_bytes=torch.cuda.max_memory_allocated())
    # what K costs: hops a replay against reads of the host, f32 batch 64
    # (K=8 is the default the searches above ran)
    kw = dict(k=RERANK, L=SEARCH_L, w=cfg.beamwidth, max_hops=cfg.max_hops,
              layout=lay, metric="l2")
    k_ms = {}
    for K in (2, 4, 8, 16):
        beam_search_device(idx, qt[:64], hops_per_sync=K, **kw)   # capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, hops = beam_search_device(idx, qt[:64], hops_per_sync=K, **kw)
        torch.cuda.synchronize()
        k_ms[K] = round((time.perf_counter() - t0) * 1e3, 3)
    log("search_k", adc="f32", batch=64, hops=hops,
        search_ms_by_K=json.dumps(k_ms))
    # the serving rerank step on the 1M table (rows mostly out of L2)
    g = torch.Generator(device="cuda").manual_seed(3)
    serving_rerank_times(idx, lay, qt[:64], [torch.randint(
        0, n, (64, RERANK), generator=g, device="cuda", dtype=torch.int32)
        for _ in range(20)], "1m", required=False)
    # where a search's time goes: device time by kernel over one profiled
    # search (batches 64 and 256, f32 and int8), against the unprofiled
    # wall time of the same search above (the profiler slows the host, not
    # the device); beside it the device time of the same graph replays
    # back to back, from CUDA events
    for (adc, nq), srch in searches.items():
        rows, (_, _, hops) = profile_window(lambda: beam_search_device(
            idx, qt[:nq], k=RERANK, L=SEARCH_L, w=cfg.beamwidth,
            max_hops=cfg.max_hops, layout=lay, metric="l2", adc_dtype=adc),
            required=False)
        wall_ms = srch["wall_ms"]
        busy_ms = sum(r[0] for r in rows)
        hop_ms = sum(t for t, k, _ in rows if "hop_kernel" in k)
        log("profile", batch=nq, adc=adc, hops=hops, K=HOPS_PER_SYNC,
            host_syncs=srch["syncs"], search_ms=f"{wall_ms:.3f}",
            eager_k1_search_ms=f"{srch['eager_ms']:.3f}",
            device_busy_ms=f"{busy_ms:.3f}",
            device_idle_share=f"{1 - busy_ms / wall_ms:.4f}",
            events_device_ms=f"{srch['events_ms']:.3f}",
            events_idle_share=f"{1 - srch['events_ms'] / wall_ms:.4f}",
            host_ms_per_hop=f"{(wall_ms - busy_ms) / hops:.4f}",
            device_ops_per_hop=f"{sum(r[2] for r in rows) / hops:.1f}",
            fused_hop_device_share=f"{hop_ms / max(busy_ms, 1e-9):.4f}",
            profiled_launches=profiled_last(),
            top=json.dumps([[k[:40], round(t, 4), c]
                            for t, k, c in rows[:10]]))
    return host_arrays, queries


def phase_diskann(arrays, aisaq_idx, aisaq_lay, queries, gt, aisaq_ids):
    """The DiskANN placement of the 10k index: the same vectors, graph and
    codes re-packed with mode="diskann" (codes in a resident (N, m) table,
    not in the chunks), served at the main path's L and rerank depth. The
    hop of each placement is timed alone and within a batch-64 search."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.device_index import _diskann_hop, \
        beam_search_device, from_arrays
    from repro_torch.core.pq import recall_at
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import make_device_search_fn
    base, graph, cents, codes = arrays
    idx, lay = from_arrays(base, graph, cents, codes, mode="diskann",
                           device="cuda")
    require(idx.pq_codes is not None and lay.mode == "diskann",
            "diskann index lacks its resident code table")
    fn = make_device_search_fn(idx, lay, metric="l2", L=SEARCH_L,
                               w=cfg.beamwidth, max_hops=cfg.max_hops,
                               rerank=RERANK)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    ids = np.concatenate([fn(queries[s:s + 64], 10)
                          for s in range(0, len(queries), 64)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    rec = recall_at(ids, gt, 10)
    agree = float(np.mean([len(set(a) & set(b)) / 10.0
                           for a, b in zip(ids, aisaq_ids)]))
    fast = {"aisaq": aisaq_idx.fast_tier_bytes(64, SEARCH_L),
            "diskann": idx.fast_tier_bytes(64, SEARCH_L)}
    log("diskann", requests=len(queries), batch=64, wall_s=f"{wall:.3f}",
        recall10=rec, agreement_with_aisaq=agree,
        fast_tier_bytes_aisaq_b64=fast["aisaq"],
        fast_tier_bytes_diskann_b64=fast["diskann"],
        launches=json.dumps(launches, separators=(",", ":")))
    require(ids.shape == (len(queries), 10) and (ids >= 0).all(),
            "diskann search returned bad ids")
    require(rec >= 0.8, f"diskann recall@10 {rec} < 0.8")
    require(launches["pq_lut"] > 0 and launches["rerank"] > 0,
            f"diskann path skipped a kernel: {launches}")
    require(fast["diskann"] - fast["aisaq"] == codes.numel(),
            "diskann fast tier must exceed aisaq's by the (N, m) codes")
    from repro_torch.kernels import ops
    q = torch.from_numpy(queries[:64]).cuda()
    lut = ops.build_lut(q, idx.centroids)
    g = torch.Generator(device="cuda").manual_seed(2)
    fids = [torch.randint(0, idx.n, (64, cfg.beamwidth), generator=g,
                          device="cuda", dtype=torch.int32) for _ in range(20)]
    hop_ms = {
        "aisaq": device_ms([lambda f=f: ops.fused_hop(
            aisaq_idx.chunk_words, f, lut, q, layout=aisaq_lay)
            for f in fids]),
        "diskann": device_ms([lambda f=f: _diskann_hop(idx, f, lut, q, lay,
                                                       "l2") for f in fids])}
    per_hop = {}
    for name, (ix, ly) in (("aisaq", (aisaq_idx, aisaq_lay)),
                           ("diskann", (idx, lay))):
        kw = dict(k=RERANK, L=SEARCH_L, w=cfg.beamwidth,
                  max_hops=cfg.max_hops, layout=ly, metric="l2")
        beam_search_device(ix, q, **kw)                    # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, hops = beam_search_device(ix, q, **kw)
        torch.cuda.synchronize()
        per_hop[name] = (time.perf_counter() - t0) * 1e3 / hops
        same_search(beam_search_device(ix, q, **kw),
                    beam_search_device(ix, q, hops_per_sync=1,
                                       cuda_graph=False, **kw),
                    f"10k {name} placement, batch 64")
    log("diskann", batch=64, w=cfg.beamwidth,
        hop_device_ms_aisaq=f"{hop_ms['aisaq']:.5f}",
        hop_device_ms_diskann=f"{hop_ms['diskann']:.5f}",
        search_ms_per_hop_aisaq=f"{per_hop['aisaq']:.4f}",
        search_ms_per_hop_diskann=f"{per_hop['diskann']:.4f}")


# ---------------------------------------------------------------------------
# the storage-backed search (HostIndex: chunks read from the file, the
# hop's arithmetic on the card)
# ---------------------------------------------------------------------------

STORAGE_BATCH = 64
# the kernels of the storage search path
STORAGE_KERNELS = ("fused_hop_f32", "pq_lut", "rerank")


def storage_search(idx, queries, nq: int = STORAGE_BATCH, **kw):
    """The queries through `HostIndex.search_batch` in batches of nq, k=10
    at the served L and rerank depth. Returns (ids, stats, wall s)."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    ids, stats = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, len(queries), nq):
        i, st = idx.search_batch(queries[s:s + nq], 10, L=SEARCH_L,
                                 w=cfg.beamwidth, rerank=RERANK, **kw)
        ids.append(i)
        stats += st
    torch.cuda.synchronize()
    return np.concatenate(ids), stats, time.perf_counter() - t0


def per_query(stats) -> dict:
    """Mean hops, ios (chunk reads) and bytes read from storage a query,
    and the run's seconds blocked in block-cache fetches and in the rest
    of the hop loop (staging, the device's step, bookkeeping), summed over
    its batches (`SearchStats` puts them on each batch's lead query)."""
    n = len(stats)
    return dict(hops=sum(s.hops for s in stats) / n,
                ios=sum(s.ios for s in stats) / n,
                bytes_read=sum(s.bytes_read for s in stats) / n,
                blocked_s=sum(s.blocked_wait_s for s in stats),
                compute_s=sum(s.compute_s for s in stats))


def agreement(a, b) -> float:
    return float(np.mean([len(set(x) & set(y)) / float(len(x))
                          for x, y in zip(a, b)]))


def peak_search_bytes(fn) -> int:
    """Device bytes one call of fn allocates at its peak, above what was
    allocated before it."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def storage_profile(fn) -> dict:
    """One call of fn unprofiled (wall) and under torch.profiler (device
    busy time, the kernels' launches it saw): busy and idle share."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows, _ = profile_window(fn, required=False)
    busy_ms = sum(r[0] for r in rows)
    return dict(wall_ms=f"{wall_ms:.3f}", device_busy_ms=f"{busy_ms:.3f}",
                device_busy_share=f"{busy_ms / wall_ms:.4f}",
                device_idle_share=f"{1 - busy_ms / wall_ms:.4f}",
                device_ops=sum(r[2] for r in rows),
                profiled_launches=profiled_last())


def phase_storage(arrays, queries, gt, root):
    """The 10k index that `phase_write_load` wrote, and its DiskANN
    placement written here, searched from their files by
    `HostIndex(device="cuda")`: 256 queries in batches of 64 at L=256,
    rerank 100; aisaq f32 and int8 with prefetch 0 and 4, diskann f32 and
    int8 (counts reset just before, read just after); aisaq against the
    same search with device="cpu"; then the peak device bytes of one batch
    and one batch under the profiler. Returns the path's launches and
    peak bytes."""
    from repro_torch.core.index_io import HostIndex, write_index
    from repro_torch.core.pq import recall_at
    from repro_torch.kernels import _build
    base, graph, cents, codes = arrays
    path = os.path.join(root, "sift10k")
    dpath = os.path.join(root, "sift10k_diskann")
    kw = dict(vectors=base, graph=graph, centroids=cents, codes=codes,
              metric="l2")
    write_index(dpath, mode="diskann", **kw)
    # a relabelled copy with the same centroids, for phase_switch
    write_index(os.path.join(root, "sift10k_rl"), mode="aisaq",
                relabel=True, **kw)
    idx = HostIndex.load(path, device="cuda")
    didx = HostIndex.load(dpath, device="cuda")
    runs, druns = {}, {}
    _build.reset_launch_counts()
    for adc in ("f32", "int8"):
        for pf in (0, 4):
            idx.cache.wait_prefetch()
            idx.cache.clear()
            runs[adc, pf] = storage_search(idx, queries, adc_dtype=adc,
                                           prefetch=pf)
        druns[adc] = storage_search(didx, queries, adc_dtype=adc)
    launches = dict(_build.launch_counts)
    cpu = HostIndex.load(path, device="cpu")
    agree = {adc: agreement(runs[adc, 0][0],
                            storage_search(cpu, queries, adc_dtype=adc)[0])
             for adc in ("f32", "int8")}
    cpu.close()
    rec = {adc: recall_at(runs[adc, 0][0], gt, 10) for adc in ("f32", "int8")}
    q64 = queries[:STORAGE_BATCH]
    skw = dict(L=SEARCH_L, rerank=RERANK)
    peak = {adc: peak_search_bytes(lambda a=adc: idx.search_batch(
        q64, 10, adc_dtype=a, **skw)) for adc in ("f32", "int8")}
    prof = storage_profile(lambda: idx.search_batch(q64, 10, **skw))
    for (adc, pf), (ids, st, wall) in runs.items():
        log("storage", n=len(base), placement="aisaq", adc=adc, prefetch=pf,
            batch=STORAGE_BATCH, queries=len(queries),
            qps=f"{len(queries) / wall:.1f}", wall_s=f"{wall:.3f}",
            recall10=recall_at(ids, gt, 10),
            rerank_ios=sum(s.rerank_ios for s in st),
            **{k: round(v, 4) for k, v in per_query(st).items()})
    for adc, (ids, st, wall) in druns.items():
        log("storage", n=len(base), placement="diskann", adc=adc, prefetch=0,
            batch=STORAGE_BATCH, queries=len(queries),
            qps=f"{len(queries) / wall:.1f}", wall_s=f"{wall:.3f}",
            recall10=recall_at(ids, gt, 10),
            agreement_with_aisaq=agreement(ids, runs[adc, 0][0]),
            **{k: round(v, 4) for k, v in per_query(st).items()})
    log("storage", load_time_s_aisaq=f"{idx.load_time_s:.4f}",
        load_time_s_diskann=f"{didx.load_time_s:.4f}",
        resident_bytes_aisaq=idx.resident_bytes(),
        resident_bytes_diskann=didx.resident_bytes(),
        cpu_agreement_f32=agree["f32"], cpu_agreement_int8=agree["int8"],
        int8_recall_gap=f"{abs(rec['f32'] - rec['int8']):.4f}",
        prefetch_same_ids=True,
        peak_device_bytes_b64_f32=peak["f32"],
        peak_device_bytes_b64_int8=peak["int8"],
        launches=json.dumps(launches, separators=(",", ":")))
    log("storage", profile="aisaq f32 batch 64", **prof)
    for adc in ("f32", "int8"):
        require(np.array_equal(runs[adc, 0][0], runs[adc, 4][0]),
                f"{adc}: prefetch 4 changed the ids")
        require(recall_at(druns[adc][0], gt, 10) >= 0.8,
                f"diskann {adc} storage recall")
    require(min(agree.values()) >= 0.99,
            f"storage search agrees {agree} with device='cpu' (< 0.99)")
    require(rec["f32"] >= 0.8, f"storage recall@10 {rec['f32']} < 0.8")
    require(abs(rec["f32"] - rec["int8"]) <= 0.01,
            f"storage int8 recall gap {abs(rec['f32'] - rec['int8'])}")
    require(all(launches[k] > 0 for k in STORAGE_KERNELS),
            f"a kernel was not launched on the storage path: {launches}")
    idx.close(), didx.close()
    return launches, peak


def drop_pages(path: str) -> None:
    """Drop a file's pages from the page cache (they are clean after the
    writer's fsync), so the next reads go to the device."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def phase_storage1m(arrays, queries, root, peak_10k):
    """The 1M deployment index written through the port's `write_index`
    (8.19 GB of chunks at 2 blocks a node) and searched from its file at
    batches of 64 and 256, f32 and int8: once with the file's pages
    dropped (cold) and once warm, each with an empty block cache. Recall is
    not judged (random graph). N is cut in steps of 100k when the disk
    lacks room. Returns the index's path."""
    import shutil
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.chunk_layout import ChunkLayout
    from repro_torch.core.index_io import HostIndex, write_index
    from repro_torch.core.vamana import random_regular_graph
    base, graph, cents, codes = arrays
    n = len(base)
    lay = ChunkLayout("aisaq", cfg.dim, "float32", cfg.R, cfg.pq_m)
    free = shutil.disk_usage(root).free

    def need(k):       # chunks.bin + pq_codes.npy + margin
        return lay.file_size(k) + k * cfg.pq_m + (256 << 20)

    log("storage1m", disk_free_bytes=free, needed_bytes=need(n), root=root)
    if need(n) > free:
        n = (free - (256 << 20)) // (lay.io_bytes + cfg.pq_m) \
            // 100_000 * 100_000
        require(n >= 100_000, f"no room for a 100k index: {free} B free")
        graph = random_regular_graph(n, cfg.R, seed=0,
                                     device="cuda").cpu().numpy()
        log("storage1m", cut_n=n, reason="disk space")
    path = os.path.join(root, "sift1m")
    t0 = time.perf_counter()
    write_index(path, vectors=base[:n], graph=graph[:n], centroids=cents,
                codes=codes[:n], metric="l2", mode="aisaq")
    t_write = time.perf_counter() - t0
    cbin = os.path.join(path, "chunks.bin")
    size = os.path.getsize(cbin)
    log("storage1m", n=n, write_s=f"{t_write:.1f}", chunks_bytes=size,
        io_bytes=lay.io_bytes)
    require(size == lay.file_size(n), "chunks.bin size")
    drop_pages(cbin)
    idx = HostIndex.load(path, device="cuda")
    peak = {}
    for adc in ("f32", "int8"):
        for nq in (64, 256):
            for state in ("cold", "warm"):
                if state == "cold":
                    drop_pages(cbin)
                idx.cache.clear()
                ids, st, wall = storage_search(idx, queries[:nq], nq=nq,
                                               adc_dtype=adc)
                require(ids.shape == (nq, 10) and (ids >= 0).all(),
                        "1M storage search returned bad ids")
                log("storage1m", adc=adc, batch=nq, pages=state,
                    qps=f"{nq / wall:.1f}", wall_ms=f"{wall * 1e3:.1f}",
                    **{k: round(v, 4) for k, v in per_query(st).items()})
        peak[adc] = peak_search_bytes(lambda a=adc: idx.search_batch(
            queries[:64], 10, L=SEARCH_L, rerank=RERANK, adc_dtype=a))
    prof = storage_profile(lambda: idx.search_batch(
        queries[:64], 10, L=SEARCH_L, rerank=RERANK))
    log("storage1m", load_time_s=f"{idx.load_time_s:.4f}",
        resident_bytes=idx.resident_bytes(),
        peak_device_bytes_b64_f32=peak["f32"],
        peak_device_bytes_b64_int8=peak["int8"],
        peak_minus_10k_f32=peak["f32"] - peak_10k["f32"],
        hbm_table_bytes_avoided=n * lay.device_stride)
    log("storage1m", profile="f32 batch 64, warm", **prof)
    idx.close()
    for adc in ("f32", "int8"):
        require(max(peak[adc], peak_10k[adc]) <= 32 << 20,
                f"{adc}: a storage search's peak device bytes exceed 32 MB")
        require(abs(peak[adc] - peak_10k[adc]) < 1 << 20,
                f"{adc}: peak device bytes differ by >= 1 MB between 10k "
                f"and {n}")
    return path


def phase_switch(root, path_1m):
    """`IndexManager` on the card over two 10k indices that share centroids
    (the written index and its relabelled copy), then over the 10k and 1M
    indices: the median time of 20 alternating switches and each index's
    load time."""
    from repro_torch.core.index_io import HostIndex
    from repro_torch.core.index_switch import IndexManager
    p10k = os.path.join(root, "sift10k")
    for pair, other in (("10k_10k_shared_centroids",
                         os.path.join(root, "sift10k_rl")),
                        ("10k_1m", path_1m)):
        paths = {"a": p10k, "b": other}
        mgr = IndexManager(paths, device="cuda")
        times = [mgr.switch("ab"[i % 2]) for i in range(20)]
        loads = {}
        for k, p in paths.items():
            h = HostIndex.load(p, device="cuda")
            loads[k] = round(h.load_time_s, 5)
            h.close()
        log("switch", pair=pair, switches=len(times),
            median_switch_ms=f"{np.median(times) * 1e3:.3f}",
            first_switch_ms=f"{times[0] * 1e3:.3f}",
            load_time_s=json.dumps(loads),
            centroid_shares=mgr.pool.stats()["centroid_shares"],
            resident_bytes=mgr.resident_bytes())
        mgr.close()


def phase_serve_launch():
    """`repro_torch.launch.serve.main` on the card over its demo index."""
    import contextlib
    import io
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = serve.main(["--queries", "200"])
    for line in buf.getvalue().splitlines():
        log("serve_launch", printed=repr(line))
    log("serve_launch", qps=f"{report['qps']:.1f}",
        p50_ms=f"{report['latency']['p50_ms']:.3f}",
        p99_ms=f"{report['latency']['p99_ms']:.3f}",
        device=report["device"], resident_bytes=report["resident_bytes"])
    require(report["device"].startswith("cuda") and report["qps"] > 0,
            "serve did not run on the card")


def adc_bytes_ops(nq, n, m, ks=256):
    """Bytes (codes once, f32 LUT once, output once) and adds of a bulk
    ADC call with u8 codes."""
    return n * m + nq * m * ks * 4 + nq * n * 4, nq * n * m


def adc_times(luts, codes, n_copies: int):
    """pq_adc / pq_adc_q8 device times at one shape: luts (reps, nq, m, ks)
    each a call's own query LUT, codes rotated over n_copies copies so that
    each call finds its codes out of L2 (50 MB), as a request does after
    the rest of its work. The library yardstick is one embedding_bag call
    over pre-offset int64 codes (idx precomputed outside the timing)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pq_adc import pq_adc_q8
    reps, nq, m, ks = luts.shape
    copies = [codes.clone() for _ in range(n_copies)]
    off = torch.arange(m, device=codes.device) * ks
    idx = [(c.long() + off) for c in copies[:2]]
    weights = [l.reshape(nq, m * ks).T.contiguous() for l in luts]
    lib = F.embedding_bag(idx[0], weights[0], mode="sum").T
    require(bool(torch.allclose(lib, ops.adc(luts[0], copies[0]),
                                rtol=TOL_ADC[0], atol=TOL_ADC[1])),
            "embedding_bag ADC differs from the kernel's")
    pick = [(luts[i], copies[i % n_copies]) for i in range(reps)]
    return {
        "pq_adc": dict(
            ms=device_ms([lambda a=a: ops.adc(*a) for a in pick]),
            plain_ms=device_ms([lambda a=a: ops.adc(*a, backend="ref")
                                for a in pick]),
            library_ms=device_ms([lambda i=i: F.embedding_bag(
                idx[i % 2], weights[i], mode="sum") for i in range(reps)])),
        "pq_adc_q8": dict(
            ms=device_ms([lambda a=a: pq_adc_q8(*a) for a in pick]),
            plain_ms=device_ms([lambda a=a: ref.pq_adc_q8_ref(*a)
                                for a in pick]),
            library_ms=None)}


# every CUDA graph the port captured in this process (keep_port_graphs)
KEPT_GRAPHS = []


def keep_port_graphs() -> None:
    """Keep every CUDA graph the port captures alive until the process
    ends. With CUPTI kept up (main), a graph replayed in a profiler window
    crashed the process (SIGSEGV in cudaGraphLaunch) once an earlier
    profiled graph had been destroyed and other graphs captured since;
    without the profiler windows, or with the port's graphs kept, the same
    sequence ran clean (probes on an H100, PERF.md §6)."""
    from repro_torch import cudagraph
    capture = cudagraph.Graph.__init__

    def capture_and_keep(self, *args, **kwargs):
        capture(self, *args, **kwargs)
        KEPT_GRAPHS.append(self.graph)
    cudagraph.Graph.__init__ = capture_and_keep


# (port kernels seen in a profile, launches the wrappers counted, windows
# run, required) of every profiled window. A window is run again, up to
# PROFILE_TRIES times in all, while its profile shows fewer of the port's
# launches than the wrappers counted; main() requires the first two equal
# for the windows whose counts are checked (required), and prints the rest.
PROFILED_LAUNCHES = []
PROFILE_TRIES = 4


def profile_window(fn, required: bool = True):
    """fn under torch.profiler. Returns its device rows (self device ms,
    name, count), sorted by time, and fn's result; records how many of the
    launches that the port's wrappers counted during the call the profile
    shows, and how many windows it took (PROFILED_LAUNCHES)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        before = sum(_build.launch_counts.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        launched = sum(_build.launch_counts.values()) - before
        rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        seen = sum(c for _, k, c in rows
                   if any(s in k for s in PORT_SYMBOLS))
        if seen == launched:
            break
    PROFILED_LAUNCHES.append((seen, launched, tries, required))
    return rows, out


def profiled_last() -> str:
    """The last window's "seen/counted in tries" (the port's launches)."""
    return "{}/{} in {}".format(*PROFILED_LAUNCHES[-1][:3])


def device_ops(fn, required: bool = True) -> int:
    """Device operations (kernels, copies, sets) of one call of fn, from
    torch.profiler."""
    rows, _ = profile_window(fn, required)
    return sum(r[2] for r in rows)


ADC_REPORT_SHAPES = (("retrieval", RETRIEVAL_SHAPE), ("bulk", BULK_SHAPE),
                     ("wide", WIDE_SHAPE))


def adc_device_ops():
    """Device ops of one pq_adc and one pq_adc_q8 call at each `[adc]`
    shape, from torch.profiler; each must be 1 (the wrappers run no torch
    op)."""
    import torch
    from repro_torch.kernels.pq_adc import pq_adc, pq_adc_q8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    ops = {}
    for label, (nq, n, m) in ADC_REPORT_SHAPES:
        lut = torch.rand((nq, m, 256), generator=g, device=dev) * 3
        codes = torch.randint(0, 256, (n, m), generator=g, device=dev,
                              dtype=torch.uint8)
        for dt, fn in (("f32", pq_adc), ("int8", pq_adc_q8)):
            fn(lut, codes)                                  # built, warm
            ops[label, dt] = device_ops(lambda: fn(lut, codes))
            require(ops[label, dt] == 1,
                    f"{fn.__name__} at the {label} shape ran "
                    f"{ops[label, dt]} device ops, not 1")
    log("adc", note="device ops a call", ops=json.dumps(
        {f"{k[0]}/{k[1]}": v for k, v in ops.items()}))
    return ops


def phase_adc_report(retrieval_times, bulk_times, ops):
    """The `[adc]` lines: for the retrieval, bulk and wide shapes and each
    LUT dtype, `adc_plan`'s plan, the card's registers, spill bytes and
    resident CTAs an SM, the time at the shape (retrieval and bulk from
    their phases, the wide one here, codes rotated out of L2 alike), the
    time at n = one tile a CTA, which is mostly the LUT staging, and the
    device ops a call that `adc_device_ops` counted."""
    import torch
    from repro_torch.kernels.pq_adc import adc_occupancy, pq_adc, pq_adc_q8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    fns = {"f32": pq_adc, "int8": pq_adc_q8}
    names = {"f32": "pq_adc", "int8": "pq_adc_q8"}
    known_times = {"retrieval": retrieval_times, "bulk": bulk_times}
    for label, (nq, n, m) in ADC_REPORT_SHAPES:
        known = known_times.get(label)
        luts = torch.rand((8, nq, m, 256), generator=g, device=dev) * 3
        codes = torch.randint(0, 256, (n, m), generator=g, device=dev,
                              dtype=torch.uint8)
        copies = [codes.clone() for _ in range(8)] if known is None else []
        for dt, fn in fns.items():
            occ = adc_occupancy(nq, m, 256, torch.uint8, dt)
            plain = "not measured"
            if known is not None:
                ms = known[names[dt]]["ms"]
                plain = f"{known[names[dt]]['plain_ms']:.5f}"
            else:
                ms = device_ms([lambda l=l, c=c: fn(l, c)
                                for l, c in zip(luts, copies)])
            n_one = occ["clusters"] * occ["cluster_ctas"] * occ["tile_rows"]
            one = torch.randint(0, 256, (n_one, m), generator=g, device=dev,
                                dtype=torch.uint8)
            one_ms = device_ms([lambda l=l: fn(l, one) for l in luts])
            b, _ = bound_ms(*adc_bytes_ops(nq, n, m))
            log("adc", shape=label, lut=dt, nq=nq, n=n, m=m,
                ms=f"{ms:.5f}", bound_ms=f"{b:.6f}",
                pct_of_bound=f"{100 * b / ms:.1f}", plain_ms=plain,
                one_tile_n=n_one, one_tile_ms=f"{one_ms:.5f}",
                device_ops=ops[label, dt], code_passes=occ["n_groups"],
                group=occ["group"], group_pad=occ["group_pad"],
                tile_rows=occ["tile_rows"], depth=occ["depth"],
                smem=occ["smem_bytes"], global_lut=occ["global_lut"],
                registers=occ["registers"], local_bytes=occ["local_bytes"],
                ctas_per_sm=occ["ctas_per_sm"], sms=occ["sms"],
                cluster=occ["cluster_ctas"], clusters=occ["clusters"])
            if label == "bulk":
                require(occ["n_groups"] == 1,
                        f"{names[dt]} reads the bulk codes "
                        f"{occ['n_groups']} times")
        del copies


def replays_device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn (a graph replay) from CUDA events
    around reps calls back to back."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_recsys(n_requests: int = 64, k: int = 100, rerank_mult: int = 4):
    """SASRec at full width against the 1M-item catalogue (retrieval_cand):
    random parameters from a seeded generator on the card, PQ (m=10, 6
    Lloyd iterations on every candidate) trained and encoded on the card,
    then n_requests one-user requests through `make_retrieval_fn` (one
    CUDA graph replay each) and again through the eager
    `retrieval_topk_pq`, in the same call."""
    import torch
    from repro_torch.configs import RETRIEVAL_CAND as shape
    from repro_torch.configs import SASREC as cfg
    from repro_torch.core.pq import encode, train_codebooks
    from repro_torch.kernels import _build, ops
    from repro_torch.models import recsys
    dev = torch.device("cuda")
    n, m = shape.n_candidates, RECSYS_PQ_M
    t0 = time.perf_counter()
    p = recsys.init_recsys(cfg, generator=torch.Generator(dev).manual_seed(0),
                           device=dev)
    cand_ids = torch.arange(n, device=dev)
    cand = recsys.item_vectors(p, cand_ids)                 # (1M, 50)
    init = np.random.default_rng(0).choice(n, 256, replace=False)
    cents = train_codebooks(cand, m=m, init_idx=init, ks=256,
                            iters=RECSYS_PQ_ITERS, device=dev)
    codes = encode(cents, cand, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    require(tuple(p.tables[0].shape) == (recsys.padded_vocab(n),
                                         cfg.embed_dim)
            and tuple(codes.shape) == (n, m), "recsys shapes")
    seqs = np.random.default_rng(1).integers(
        0, cfg.vocab_sizes[0], (n_requests, shape.batch, cfg.seq_len))
    batches = [{"seq": s, "cand_ids": cand_ids} for s in seqs]

    graphed = recsys.make_retrieval_fn(p, cfg, codes, cents, k=k,
                                       rerank_mult=rerank_mult)

    def serve(b, backend="auto"):
        if backend == "graph":
            return graphed(b)
        return recsys.retrieval_topk_pq(p, b, cfg, codes, cents, k=k,
                                        rerank_mult=rerank_mult,
                                        backend=backend)

    def requests(backend):
        """Latencies (s), ids and scores of the n_requests requests."""
        lat, ids, vals = [], [], []
        for b in batches:
            t0 = time.perf_counter()
            i, v = serve(b, backend)
            i, v = i.cpu().numpy(), v.cpu().numpy()
            lat.append(time.perf_counter() - t0)
            ids.append(i[0])
            vals.append(v[0])
        return np.array(lat), np.stack(ids), np.stack(vals)

    t0 = time.perf_counter()
    serve(batches[0], "graph")                     # warm-up and capture
    t_capture = time.perf_counter() - t0
    serve(batches[0])                              # the eager path, warm
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    lat, ids, vals = requests("graph")
    launches = dict(_build.launch_counts)
    eager_lat, eager_ids, _ = requests("auto")
    require(np.array_equal(eager_ids, ids),
            "the graph's answers differ from the eager retrieval_topk_pq's")
    require(ids.shape == (n_requests, k) and np.isfinite(vals).all()
            and (ids >= 0).all() and (ids < n).all()
            and (np.diff(vals, axis=1) <= 0).all(),
            "retrieval_topk_pq returned bad ids or scores")
    ref_ids = np.stack([serve(b, "ref")[0].cpu().numpy()[0]
                        for b in batches])
    agree = float(np.mean([len(set(a) & set(r)) / k
                           for a, r in zip(ids, ref_ids)]))
    exact = np.stack([recsys.retrieval_topk(p, b, cfg, k=k)[0]
                      .cpu().numpy()[0] for b in batches])
    overlap = float(np.mean([len(set(a) & set(e)) / k
                             for a, e in zip(ids, exact)]))
    users = torch.cat([recsys.user_tower(p, b, cfg) for b in batches[:20]])
    luts = ops.build_lut(users, cents, metric="mips")           # (20, m, ks)
    # the kernels on this path's own inputs (mips, m=10, dsub=5, signed
    # LUTs), each against its plain version
    err_lut = close_err(luts, ops.build_lut(users, cents, metric="mips",
                                            backend="ref"))
    luts = luts[:, None]                                        # (20,1,m,ks)
    d_pq = [ops.adc(l, codes)[0] for l in luts]
    err_adc = max(adc_err(d, ops.adc(l, codes, backend="ref")[0])
                  for d, l in zip(d_pq, luts))
    lut_ms = {be: device_ms([lambda u=u: ops.build_lut(
        u[None], cents, metric="mips", backend=be) for u in users])
        for be in ("auto", "ref")}
    lut_ms["library"] = device_ms([lambda u=u: lut_baddbmm(
        u[None], cents, "mips") for u in users])
    require(bool(torch.allclose(lut_baddbmm(users, cents, "mips"),
                                luts[:, 0], rtol=1e-4, atol=1e-4)),
            "bmm LUT differs from the kernel's")
    lut_times(cents, {1: users[:1]}, 20, "mips")
    lut_bound, _ = bound_ms(*lut_bytes_ops(1, m, 256, cfg.embed_dim // m))
    # the selection over 1M ADC distances: the stable sort the path uses,
    # beside an unstable topk (ties in no promised order) for its cost
    sort_ms = device_ms([lambda d=d: torch.sort(d, stable=True)
                         for d in d_pq])
    topk_ms = device_ms([lambda d=d: torch.topk(d, k * rerank_mult,
                                                largest=False)
                         for d in d_pq])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(batches[0], "graph")[0].cpu()
    one_ms = (time.perf_counter() - t0) * 1e3
    syncs, _ = host_syncs(lambda: serve(batches[0], "graph")[0].cpu())
    # the profiler watches the same request launched eagerly (the graph's
    # kernels, one launch each): a graph replay in this window crashed the
    # process in cudaGraphLaunch (SIGSEGV) in three of nine full runs on an
    # H100, never outside a profiler window; the replay's own device time
    # comes from CUDA events below
    rows, _ = profile_window(lambda: serve(batches[0])[0].cpu(),
                             required=False)
    busy_ms = sum(r[0] for r in rows)
    on_card = {"seq": torch.from_numpy(batches[0]["seq"]).cuda()}
    replay_ms = replays_device_ms(lambda: serve(on_card, "graph"))
    lat_ms = lat * 1e3
    eager_ms = eager_lat * 1e3
    log("recsys", model=cfg.name, shape=shape.name, candidates=n,
        embed_dim=cfg.embed_dim, seq_len=cfg.seq_len, blocks=cfg.n_blocks,
        pq_m=m, setup_s=f"{t_setup:.2f}", requests=n_requests,
        p50_ms=f"{np.percentile(lat_ms, 50):.4f}",
        p99_ms=f"{np.percentile(lat_ms, 99):.4f}",
        mean_ms=f"{lat_ms.mean():.4f}",
        eager_p50_ms=f"{np.percentile(eager_ms, 50):.4f}",
        eager_p99_ms=f"{np.percentile(eager_ms, 99):.4f}",
        capture_s=f"{t_capture:.3f}",
        agreement_with_plain=agree, overlap_with_exact_top100=overlap,
        pq_lut_err=err_lut, pq_adc_err=err_adc,
        pq_lut_ms=f"{lut_ms['auto']:.5f}",
        pq_lut_plain_ms=f"{lut_ms['ref']:.5f}",
        pq_lut_bmm_ms=f"{lut_ms['library']:.5f}",
        pq_lut_bound_ms=f"{lut_bound:.6f}",
        sort_1m_ms=f"{sort_ms:.4f}", topk400_1m_ms=f"{topk_ms:.4f}",
        launches=json.dumps(launches, separators=(",", ":")))
    log("recsys_profile", request_ms=f"{one_ms:.4f}",
        profiled="eager request", device_busy_ms=f"{busy_ms:.4f}",
        device_idle_share=f"{1 - busy_ms / one_ms:.4f}",
        events_replay_ms=f"{replay_ms:.4f}",
        events_idle_share=f"{1 - replay_ms / one_ms:.4f}",
        idle_share_at_p50=f"{1 - busy_ms / np.percentile(lat_ms, 50):.4f}",
        host_syncs=syncs,
        device_ops=sum(r[2] for r in rows),
        profiled_launches=profiled_last(),
        top=json.dumps([[key[:40], round(t, 4), c]
                        for t, key, c in rows[:8]]))
    require(launches["pq_lut"] == n_requests
            and launches["pq_adc"] == n_requests,
            f"expected {n_requests} pq_lut and pq_adc launches: {launches}")
    require(agree >= 0.99, f"top-{k} agreement with the plain path {agree}")
    return launches, adc_times(luts, codes, n_copies=6), \
        {"pq_lut": err_lut, "pq_adc": err_adc}


def phase_bulk_adc(nq: int = 8, n: int = 1_000_000, m: int = 16):
    """Bulk scoring (the counterpart of benchmarks/bench_device.py
    bulk_adc_scoring): nq l2 LUTs against n codes through ops.adc and
    pq_adc_q8. The int8 error bound holds on both data sets; the top-10
    overlap is judged on the distribution of tests/test_kernels.py
    (uniform LUT x 3, uniform codes) and printed on the clustered corpus
    (PQ trained on it), where one scale a query loses near neighbours."""
    import torch
    from repro_torch.core.pq import encode, train_codebooks
    from repro_torch.data.vectors import make_clustered, make_queries
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.pq_adc import pq_adc_q8
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(9)
    errs = {"pq_adc": 0.0, "pq_adc_q8": 0.0}
    b_ms, _ = bound_ms(*adc_bytes_ops(nq, n, m))

    def int8_vs_f32(data, lut, codes):
        """One ops.adc and one pq_adc_q8 call, counted; returns the
        launches and each query's top-10 overlap."""
        _build.reset_launch_counts()
        d = ops.adc(lut, codes)
        d8 = pq_adc_q8(lut, codes)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        errs["pq_adc"] = max(errs["pq_adc"], adc_err(d, ref.adc_ref(lut,
                                                                  codes)))
        errs["pq_adc_q8"] = max(errs["pq_adc_q8"],
                                q8_err(d8, ref.pq_adc_q8_ref(lut, codes)))
        err = float((d8 - d).abs().max())
        bound = m * float(lut.abs().max()) / 127
        top = [len(set(torch.sort(a, stable=True)[1][:10].tolist())
                   & set(torch.sort(b, stable=True)[1][:10].tolist()))
               for a, b in zip(d, d8)]
        log("bulk_adc", data=data, nq=nq, n=n, m=m, int8_err=err,
            int8_bound=bound, top10_overlap=json.dumps(top),
            launches=json.dumps(launches, separators=(",", ":")),
            bound_ms=f"{b_ms:.5f}")
        require(err <= bound + 1e-3, f"int8 ADC err {err} > bound {bound}")
        require(launches["pq_adc"] == 1 and launches["pq_adc_q8"] == 1,
                f"bulk ADC skipped a kernel: {launches}")
        return launches, top

    lut = torch.rand((nq, m, 256), generator=g, device=dev) * 3
    codes = torch.randint(0, 256, (n, m), generator=g, device=dev,
                          dtype=torch.uint8)
    launches, top = int8_vs_f32("uniform", lut, codes)
    require(min(top) >= 9, f"int8 top-10 overlap {top} < 9")
    luts = torch.rand((8, nq, m, 256), generator=g, device=dev) * 3
    t = adc_times(luts, codes, n_copies=4)
    log("bulk_adc", note="times at the bulk shape",
        pq_adc_ms=f"{t['pq_adc']['ms']:.5f}",
        pq_adc_q8_ms=f"{t['pq_adc_q8']['ms']:.5f}",
        plain_ms=f"{t['pq_adc']['plain_ms']:.5f}",
        embedding_bag_ms=f"{t['pq_adc']['library_ms']:.5f}",
        bound_ms=f"{b_ms:.5f}")
    base = make_clustered(n, 128, seed=4)
    queries = torch.from_numpy(make_queries(nq, base, seed=5)).to(dev)
    vecs = torch.from_numpy(base).to(dev)
    del base
    init = np.random.default_rng(4).choice(n, 256, replace=False)
    cents = train_codebooks(vecs, m=m, init_idx=init, iters=6, device=dev)
    int8_vs_f32("clustered", ops.build_lut(queries, cents),
                encode(cents, vecs, device=dev))
    log("bulk_adc", note="kernel against plain version on both data sets",
        pq_adc_err=errs["pq_adc"], pq_adc_q8_err=errs["pq_adc_q8"])
    return launches, t, errs


def main() -> int:
    faulthandler.enable()          # a crash in native code prints its stack
    # PyTorch tears CUPTI down after each profiler window and sets it up
    # again lazily; the next window then lost its first launch. Kept up,
    # the windows show their launches (checked below).
    os.environ["TEARDOWN_CUPTI"] = "0"
    os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    keep_port_graphs()
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_phases(root: str) -> int:
    """Every phase in order, the run's index directories under `root`."""
    import torch
    phase_env()
    errs = phase_parity()
    idx, lay, queries, gt, arrays = build_index_10k()
    # the first profiler window: after the build's host-only minutes (see
    # the module docstring)
    adc_ops = adc_device_ops()
    launches, served = phase_main_path(idx, lay, queries, gt)
    times = kernel_times(idx, lay, queries)
    phase_search_graph(idx, lay, queries)
    phase_write_load(idx, lay, queries, arrays, root)
    phase_diskann(arrays, idx, lay, queries, gt, served)
    del idx
    torch.cuda.empty_cache()
    arrays_1m, queries_1m = phase_deployment()
    torch.cuda.empty_cache()
    rec_launches, adc, rec_errs = phase_recsys()
    torch.cuda.empty_cache()
    bulk_launches, bulk, bulk_errs = phase_bulk_adc()
    torch.cuda.empty_cache()
    phase_adc_report(adc, bulk, adc_ops)
    storage_launches, peak_10k = phase_storage(arrays, queries, gt, root)
    path_1m = phase_storage1m(arrays_1m, queries_1m, root, peak_10k)
    del arrays_1m
    phase_switch(root, path_1m)
    shutil.rmtree(path_1m)
    phase_serve_launch()
    log("profiler", windows=len(PROFILED_LAUNCHES),
        port_graphs_kept=len(KEPT_GRAPHS),
        complete=sum(s == n for s, n, _, _ in PROFILED_LAUNCHES),
        first_try=sum(t == 1 for _, _, t, _ in PROFILED_LAUNCHES),
        windows_seen_counted_tries_required=json.dumps(PROFILED_LAUNCHES))
    require(all(s == n for s, n, _, req in PROFILED_LAUNCHES if req),
            f"a checked profile lost launches: {PROFILED_LAUNCHES}")
    # pq_lut runs on the search and the retrieval paths: its row keeps the
    # search shape's times and takes the worse error of the two paths.
    # pq_adc's row is at the retrieval shape, pq_adc_q8's at the bulk
    # shape, the one path that launches it.
    errs["pq_lut"] = max(errs["pq_lut"], rec_errs["pq_lut"])
    errs["pq_adc"] = max(errs["pq_adc"], rec_errs["pq_adc"])
    errs["pq_adc_q8"] = max(errs["pq_adc_q8"], bulk_errs["pq_adc_q8"])
    launches.update(pq_adc=rec_launches["pq_adc"],
                    pq_adc_q8=bulk_launches["pq_adc_q8"])
    for name, t, shape in (("pq_adc", adc, RETRIEVAL_SHAPE),
                           ("pq_adc_q8", bulk, BULK_SHAPE)):
        nbytes, n_ops = adc_bytes_ops(*shape)
        times[name] = dict(t[name], nbytes=nbytes, ops=n_ops)
    kernels = []
    for name in REPLACES:
        t = times[name]
        b, by = bound_ms(t["nbytes"], t["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_storage": storage_launches.get(name, 0),
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b, "bound_by": by,
            "library_ms": t["library_ms"]})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
