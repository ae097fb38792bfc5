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
     shared-memory plan and occupancy; and the bulk ADC at every
     `ADC_CASES` shape (f32 and int8 LUT, u8 and i32 codes; pq_adc_q8
     bit-equal to its int32 recomputation), a table at an odd byte offset
     and an all-zero LUT;
  3. the main path: a 10k-vector SIFT1M-width index (Vamana graph, PQ
     trained on the card, chunk table packed on the card) served through
     `ServingEngine` + `make_device_search_fn(L=256, rerank=100)`, f32 and
     int8; recall@10 against brute-force groundtruth, agreement with the plain
     (`backend="ref"`) search, and every kernel's launch count; then the
     `[hop]` lines: the fused hop's time with one LUT and with the LUT
     rotated out of L2, its registers, shared memory and resident CTAs;
  4. DiskANN placement: the same 10k vectors, graph and codes re-packed
     with mode="diskann" and served the same way; recall@10, agreement with
     phase 3, fast-tier bytes of both placements at batch 64, the time of
     each placement's hop alone and per hop of a batch-64 search;
  5. deployment size: a 1M-node SIFT1M-width chunk table (7.94 GB) on the
     card over the random R-regular start graph, served in batches of 64
     and 256; QPS, hops, time per hop, fused_hop bytes/s, peak memory,
     and one profiled search each for f32 and int8: device busy time by
     kernel, idle share, device ops per hop;
  6. recommender retrieval: SASRec at full width (embed_dim 50, seq_len 50,
     2 blocks) against 1,000,000 candidates (retrieval_cand), PQ m=10
     trained and encoded on the card, 64 one-user requests through
     `retrieval_topk_pq` (pq_lut + pq_adc kernels); latency p50/p99,
     agreement with the plain path, overlap with exact top-100, launches,
     and the path's own LUTs and ADC distances against their plain versions;
  7. bulk ADC: 8 queries against 1,000,000 codes at m=16 through `ops.adc`
     and `pq_adc_q8`; the int8 error bound and top-10 overlap;
  8. the `[adc]` lines: for the retrieval, bulk and wide shapes and each
     LUT dtype, `adc_plan`'s plan, registers, spills, resident CTAs, the
     time at the shape and at one tile a CTA (mostly the LUT staging),
     and one device op a call.
Each path's launch counts are reset just before it and read just after.
Then the card line, the `kernels` JSON line (times at each kernel's path
shapes) and the result line.

Needs a CUDA card and the CUDA toolkit (`nvcc`); without a card it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
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
    return launches, ids["f32"]


def kernel_times(idx, lay, queries, nq: int = 64, c: int = 100):
    """Kernel, plain-version and library times at the main path's shapes:
    a serving batch of nq queries, w=4 frontier slots per query on the
    10k table, c rerank candidates per query."""
    import torch
    from repro_torch.kernels import chunk_adc, ops
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

    def lut_lib():
        qs = q.reshape(nq, m, dsub).permute(1, 0, 2)        # (m, nq, dsub)
        norms = (qs * qs).sum(-1)[:, :, None] \
            + (cents * cents).sum(-1)[:, None, :]
        return torch.baddbmm(norms, qs, cents.transpose(1, 2), alpha=-2.0) \
            .permute(1, 0, 2).contiguous()

    require(bool(torch.allclose(lut_lib(), lut, rtol=1e-4, atol=1e-4)),
            "baddbmm LUT differs from the kernel's")
    out["pq_lut"] = dict(
        ms=device_ms([lambda: ops.build_lut(q, cents)] * reps),
        plain_ms=device_ms([lambda: ops.build_lut(q, cents, backend="ref")]
                           * reps),
        library_ms=device_ms([lut_lib] * reps),
        nbytes=nq * d * 4 + m * ks * dsub * 4 + nq * m * ks * 4,
        ops=nq * m * ks * (6 * dsub + 3))

    def rr_lib(cand):
        norms = (cand * cand).sum(-1) + (q * q).sum(-1)[:, None]
        return torch.baddbmm(norms[:, :, None], cand, q[:, :, None],
                             alpha=-2.0)[:, :, 0]

    out["rerank"] = dict(
        ms=device_ms([lambda x=x: ops.rerank(q, x) for x in cands]),
        plain_ms=device_ms([lambda x=x: ops.rerank(q, x, backend="ref")
                            for x in cands]),
        library_ms=device_ms([lambda x=x: rr_lib(x) for x in cands]),
        nbytes=nq * d * 4 + nq * c * d * 4 + nq * c * 4,
        ops=3 * nq * c * d)
    return out


def phase_deployment():
    """1M nodes at SIFT1M widths; recall is not judged (random graph)."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.device_index import beam_search_device, from_arrays
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
    del base
    graph = random_regular_graph(n, cfg.R, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    sample = torch.from_numpy(rng.choice(n, 100_000, replace=False)).cuda()
    cents = train_codebooks(vecs[sample], m=cfg.pq_m,
                            init_idx=rng.choice(100_000, cfg.pq_ks,
                                                replace=False),
                            ks=cfg.pq_ks, iters=12, device="cuda")
    codes = encode(cents, vecs, device="cuda")
    idx, lay = from_arrays(vecs, graph, cents, codes, device="cuda")
    del vecs, graph, codes
    torch.cuda.synchronize()
    table = idx.chunk_words.numel() * 4
    log("build1m", n=n, data_s=f"{t_data:.1f}",
        graph_pq_pack_s=f"{time.perf_counter() - t0:.2f}", table_bytes=table,
        note="random R-regular graph: recall is not judged at this size")
    require(table == n * lay.device_stride, "chunk table size")
    qt = torch.from_numpy(queries).cuda()
    search_ms_64 = {}
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
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, hops = beam_search_device(
                idx, qt[:nq], k=RERANK, L=SEARCH_L, w=cfg.beamwidth,
                max_hops=cfg.max_hops, layout=lay, metric="l2",
                adc_dtype=adc)
            torch.cuda.synchronize()
            t_search = time.perf_counter() - t0
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
                search_ms_per_hop=f"{t_search * 1e3 / hops:.3f}",
                fused_hop_ms=f"{hop_ms:.4f}",
                fused_hop_GBps=f"{hop_bytes / hop_ms / 1e6:.1f}",
                hbm_share=f"{hop_bytes / hop_ms * 1e3 / HBM_BYTES_PER_S:.4f}")
            if nq == 64:
                search_ms_64[adc] = t_search * 1e3
    log("deploy", peak_device_bytes=torch.cuda.max_memory_allocated())
    # where a hop's time goes: device time by kernel over one profiled
    # search (batch 64, f32 and int8), against the unprofiled wall time of
    # the same search above (the profiler slows the host, not the device)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for adc, wall_ms in search_ms_64.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, hops = beam_search_device(
                idx, qt[:64], k=RERANK, L=SEARCH_L, w=cfg.beamwidth,
                max_hops=cfg.max_hops, layout=lay, metric="l2",
                adc_dtype=adc)
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        busy_ms = sum(r[0] for r in rows)
        hop_ms = sum(t for t, k, _ in rows if "hop_kernel" in k)
        log("profile", batch=64, adc=adc, hops=hops,
            search_ms=f"{wall_ms:.2f}", device_busy_ms=f"{busy_ms:.3f}",
            device_idle_share=f"{1 - busy_ms / wall_ms:.4f}",
            host_ms_per_hop=f"{(wall_ms - busy_ms) / hops:.3f}",
            device_ops_per_hop=f"{sum(r[2] for r in rows) / hops:.1f}",
            fused_hop_device_share=f"{hop_ms / busy_ms:.4f}",
            top=json.dumps([[k[:40], round(t, 4), c]
                            for t, k, c in rows[:10]]))


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
    log("diskann", batch=64, w=cfg.beamwidth,
        hop_device_ms_aisaq=f"{hop_ms['aisaq']:.5f}",
        hop_device_ms_diskann=f"{hop_ms['diskann']:.5f}",
        search_ms_per_hop_aisaq=f"{per_hop['aisaq']:.4f}",
        search_ms_per_hop_diskann=f"{per_hop['diskann']:.4f}")


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


def device_ops(fn) -> int:
    """Device operations (kernels, copies, sets) of one call of fn, from
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


ADC_REPORT_SHAPES = (("retrieval", RETRIEVAL_SHAPE), ("bulk", BULK_SHAPE),
                     ("wide", WIDE_SHAPE))


def adc_device_ops():
    """Device ops of one pq_adc and one pq_adc_q8 call at each `[adc]`
    shape, from torch.profiler; each must be 1 (the wrappers run no torch
    op). Run before any other profiler session of the process: after
    earlier sessions the profiler was seen to drop these launches."""
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
            if known is not None:
                ms = known[names[dt]]["ms"]
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
                pct_of_bound=f"{100 * b / ms:.1f}",
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


def phase_recsys(n_requests: int = 64, k: int = 100, rerank_mult: int = 4):
    """SASRec at full width against the 1M-item catalogue (retrieval_cand):
    random parameters from a seeded generator on the card, PQ (m=10, 6
    Lloyd iterations on every candidate) trained and encoded on the card,
    then n_requests one-user requests through retrieval_topk_pq."""
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

    def serve(b, backend="auto"):
        return recsys.retrieval_topk_pq(p, b, cfg, codes, cents, k=k,
                                        rerank_mult=rerank_mult,
                                        backend=backend)

    serve(batches[0])                                      # warm
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    lat, ids, vals = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        i, v = serve(b)
        i, v = i.cpu().numpy(), v.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        ids.append(i[0])
        vals.append(v[0])
    launches = dict(_build.launch_counts)
    ids, vals = np.stack(ids), np.stack(vals)
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
    # the selection over 1M ADC distances: the stable sort the path uses,
    # beside an unstable topk (ties in no promised order) for its cost
    sort_ms = device_ms([lambda d=d: torch.sort(d, stable=True)
                         for d in d_pq])
    topk_ms = device_ms([lambda d=d: torch.topk(d, k * rerank_mult,
                                                largest=False)
                         for d in d_pq])
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(batches[0])[0].cpu()
    one_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(batches[0])[0].cpu()
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    lat_ms = np.array(lat) * 1e3
    log("recsys", model=cfg.name, shape=shape.name, candidates=n,
        embed_dim=cfg.embed_dim, seq_len=cfg.seq_len, blocks=cfg.n_blocks,
        pq_m=m, setup_s=f"{t_setup:.2f}", requests=n_requests,
        p50_ms=f"{np.percentile(lat_ms, 50):.3f}",
        p99_ms=f"{np.percentile(lat_ms, 99):.3f}",
        mean_ms=f"{lat_ms.mean():.3f}",
        agreement_with_plain=agree, overlap_with_exact_top100=overlap,
        pq_lut_err=err_lut, pq_adc_err=err_adc,
        pq_lut_ms=f"{lut_ms['auto']:.5f}",
        pq_lut_plain_ms=f"{lut_ms['ref']:.5f}",
        sort_1m_ms=f"{sort_ms:.4f}", topk400_1m_ms=f"{topk_ms:.4f}",
        launches=json.dumps(launches, separators=(",", ":")))
    log("recsys_profile", request_ms=f"{one_ms:.3f}",
        device_busy_ms=f"{busy_ms:.4f}",
        device_idle_share=f"{1 - busy_ms / one_ms:.4f}",
        device_ops=sum(r[2] for r in rows),
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
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_env()
    adc_ops = adc_device_ops()
    errs = phase_parity()
    idx, lay, queries, gt, arrays = build_index_10k()
    launches, served = phase_main_path(idx, lay, queries, gt)
    times = kernel_times(idx, lay, queries)
    phase_diskann(arrays, idx, lay, queries, gt, served)
    del idx, arrays
    torch.cuda.empty_cache()
    phase_deployment()
    torch.cuda.empty_cache()
    rec_launches, adc, rec_errs = phase_recsys()
    torch.cuda.empty_cache()
    bulk_launches, bulk, bulk_errs = phase_bulk_adc()
    torch.cuda.empty_cache()
    phase_adc_report(adc, bulk, adc_ops)
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
