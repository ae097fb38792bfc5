#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failed check raises, so the exit code is
non-zero):
  1. environment: card name and power limit, torch/CUDA versions, nvcc build
     of `src/repro_torch/kernels/csrc/aisaq_kernels.cu` and
     `gnn_kernels.cu` (one nvcc each, side by side, then a link);
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
     then `[cells]`: the dry run's aisaq-sift1m serve_q32 and serve_q1k
     cells (`launch.inputs.build_cell` on grid (1, 1) of a one-rank gloo
     world in this process: mode A) run their `fn` on this 1M table
     (`hop_kernel<false>`, `pq_lut_kernel`): inputs shaped as
     `local_args`, ids equal to `beam_search_device` called directly,
     predicted argument bytes equal to the held ones, the search's peak
     device bytes; `[dryrun]`: `launch.dryrun` in a subprocess on this
     host (the fake 256- and 512-rank worlds, meta tensors) for the
     three ANN archs on both meshes, qwen3-1.7b decode_32k and dcn-v2
     serve_p99: argument bytes, collective MB by op, flops x ranks /
     model flops, bytes accessed, transcendentals, peak, temp and alias
     bytes, and the ANN cells' hops counted and per-hop counts.
     (`[dryrun_peak]` prints after phase 3's build, beside whose
     host-only Vamana graph it runs: qwen3-1.7b decode_32k and train_4k,
     dlrm-rm2 train_batch, and aisaq-sift1m and aisaq-sift1b serve_q1k as
     rank 0 of a fake 256-rank world in a subprocess, the dry run's meta
     trace and then the step on CUDA tensors of the same blocks; the
     card's peak bytes within 10% or 256 MB of the dry run's
     `peak_bytes`, dlrm-rm2's at most 256 MB above it, an upper bound;
     an ANN cell's shard is a real packed chunk table over a random
     R-regular graph, searched eagerly (`hop_kernel<false>`,
     `pq_lut_kernel`) and merged, within 10% or 2 MB);
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
     its demo index: QPS and latency as it prints them;
 13. `[dynamic]`: `DynamicHostIndex(device="cuda")` over a copy of the
     10k index: 256 held-out vectors of the same distribution inserted
     while 3 reader threads search (L=256, k=10) the whole time, taking
     turns with the inserts at the process's search gate; inserts/s,
     insert p50/p99, reader QPS, the path's launches of every kernel
     (`fused_hop_f32` and `pq_lut` required), the peak device bytes of
     one reader search; then 64 labels deleted, filtered searches (no
     tombstoned label), flush, reload (n = 10,256, no CRC mismatch),
     recall@10 over the live grown set (the deleted vectors left out of
     the ground truth, no deleted label in the results) and
     self-recall@1 of the live inserts (>= 0.8 each), and `compact` to a
     sibling directory whose card and CPU searches agree (>= 0.99);
 14. `[crash_drill]`: every `KillSwitch` tick of one insert plus its flush
     on a 2,000-vector index: crash, abandon, recover on the card; n pre-
     or post-insert (post if committed), no dangling edge, no CRC
     mismatch, an empty journal, a rolled-forward vector at rank 1;
 15. `[service]`: `RetrievalService` over `WarmIndexPool(device="cuda")`
     with the 10k index and its relabelled copy, 512 requests from 8
     client threads, every answer equal to a direct search on the card;
     QPS, p50/p99, per-corpus stats; then a corpus whose journal holds a
     torn frame, recovered and reported in the pool's `recoveries`;
 16. `[cluster]`: the 10k vectors in 2 shards of 5,000 (global labels)
     served by `ShardCluster` (2 spawned workers on the card) behind
     `ShardRouter`: 256 queries, every answer bit-identical to
     `merge_topk` of the shards' single-process searches on the card;
     worker 1 SIGKILLed: a partial answer without shard 1, then full
     coverage again within 60 s, never quarantined; worker start and
     respawn seconds, router p50/p99, each worker's kernel launches;
 17. `[sharded]` (the paper's Fig. 5 device tier): the 10k vectors and
     PQ of phase 3 split by `vamana.build_sharded` (one-pass Vamana) into
     4 shards of 2,500 and 2 of 5,000, built side by side in spawned
     processes and stacked on the card by `stack_shards`; 4 spawned gloo
     ranks on cuda:0 run `sharded_search_fn` on grid (1, 4) with the
     queries replicated and (2, 2) with 2 query groups over the 2-shard
     build, batches 64 and 256, L=256, k=10, f32 and int8: recall@10 (>=
     0.8), the int8 gap (<= 0.01), ids equal to the same shards searched
     one after another in this process and merged, top-10 agreement with
     every rank's plain path (>= 0.99), wall and QPS beside the unsharded
     10k search, each rank's launches and peak device bytes, each rank's
     search alone (the ranks taking turns) and the gather of the results,
     the seconds to start the world;
 18. `[sharded1m]`: phase 5's 1M corpus as 4 shards of 250,000 rows, each
     rank reading its rows from the run's files and packing them over its
     own random R-regular graph (1.98 GB of chunk rows each); f32, batches
     64 and 256, k=100: wall and QPS beside phase 5's unsharded search;
 19. `[recsys_towers]`: DLRM-rm2, DCN-v2 and Wide&Deep one at a time at
     their published cardinalities (48.08, 12.02 and 11.74 GB of tables):
     the CTR forward at serve_p99 (512) and serve_bulk (262,144), p50/p99,
     finite and bit-equal logits; retrieval_cand (1M candidates of table
     0, all 1,000 of Wide&Deep's) with PQ at m=16 / 8 / 8 trained on the
     card, 64 requests through `make_retrieval_fn` (a graph) and eagerly:
     p50/p99, graph vs eager answers equal, agreement with the plain path
     (>= 0.99), launches, peak device bytes;
 20. `[train]`: the recommender trainer (`repro_torch.launch.train`) on
     the card: tiny SASRec and DCN-v2 3 steps on the card and on the CPU
     from one state (largest parameter difference after each step within
     TOL_TRAIN_PARAMS, the CPU tests' tolerance); tiny DCN-v2's 25 losses
     at lr 1e-2 from the CPU's seed-0 state (the last and the mean of the
     last 5 below the first, each within TOL_TRAIN_LOSS of the CPU's);
     DLRM-rm2, DCN-v2, Wide&Deep
     and SASRec one at a time at their published cardinalities and
     train_batch (65,536 rows), 5 steps each: init seconds, step p50/p99
     after the first, peak device bytes against the parameter and
     optimizer bytes (DLRM-rm2's above them below its largest table: no
     dense table gradient), rows touched a step, finite losses, the bound
     of a step's float32 matrix products; tiny SASRec restarted after a
     WorkerFailure at step 6 from its step-4 checkpoint, the final state
     bit-equal to an uninterrupted run's; no port kernel launched;
 21. `[lm_parity]`: the five LM archs at `reduced_lm` scale, float32,
     TF32 off, the same parameters (drawn on the CPU) on the CPU and the
     card: `lm_prefill` logits, 9 `lm_decode_step` logits, `lm_loss` and
     every gradient within TOL_LM_PARITY; `flash_attention` and
     `flash_attention_vjp` (full, sliding and chunked masks, Sq = 300 with
     64/128 and 128/64 blocks, q offsets 0 and 37) within TOL_FLASH_FWD
     forward and TOL_FLASH_GRAD for the gradients;
 22. `[lm_serve]`: bfloat16, random weights drawn on the card, full
     width: qwen3-1.7b at all 28 layers serving 8 requests (128-token
     prompts fed through `lm_decode_step`, 32 greedy tokens; decode p50 /
     p99, tokens/s, peak bytes against the parameters), `lm_prefill` at
     prefill_32k's 32,768 tokens (batch cut to 1) and one decode step at
     decode_32k's T = 32,768 (batch cut to 8, a 30.1 GB cache of seeded
     draws), each beside its bound; float32 at full width, 16 decode
     steps against the prefill within TOL_DECODE_PREFILL; one layer's
     attention at 8,192 tokens beside `scaled_dot_product_attention` (a
     library yardstick only); then qwen2-1.5b, h2o-danube-1.8b (prefill
     at 8,192 tokens, past its 4,096 window), qwen2-moe-a2.7b (dropped
     pair shares) and llama4-scout-17b-a16e cut to SCOUT_LAYERS layers
     (width kept; prefill at 16,384 tokens, two local chunks), each 4
     requests (64-token prompts, 16 new tokens), prefill ms, decode p50,
     peak bytes, finite logits;
 23. `[lm_train]`: the LM trainer on the card: tiny_lm (qwen3-1.7b's, 4
     layers, float32) 3 steps of the launcher's default schedule on the
     card and on the CPU from one state within TOL_LM_PARITY (and the
     first step's gradients, relative to the largest); 25 steps at lr 1e-2, the last loss below the
     first; a restart after a WorkerFailure at step 6 from the step-4
     checkpoint, bit-equal; qwen3-1.7b at full width (bfloat16, float32
     master weights) on train_4k's 4,096 tokens at batch 4 (cut from
     256), 4 steps: step p50 beside 6 N tokens plus the attention's
     products at 989 TFLOP/s, peak bytes against parameters and optimizer
     state; no port kernel launched. Every LM line carries the card line.
 24. `[gnn_parity]`: the segment-sum kernel (`csrc/gnn_kernels.cu`, the
     GNN family's aggregation) against its plain version in float64 on
     the card, within the running-error bound of float32 sums in the
     order the CSR's plan fixes (`seg_plan`, `seg_bound`), forward (by
     destination) and backward (by source) at F = 7, 13, 24, 30, 64, 100,
     128, 602 and 1,433 (every lane layout), with empty rows, duplicate
     edges, self-loops and (n, n) dummies, and at F = 7, 100 and 128 two
     destinations and two sources of 2.1M and 12,411 edges (hub rows cut
     into chunks, two a way; the two hub sources staged as hot); every
     call twice, bit-equal; bit-equal to a plain float32 sum in the plan's
     order on every hub row, the 64 longest and 4,096 random other rows
     (`seg_exact`); an unaligned copy of x (4-byte loads) bit-equal; the
     plan, registers, spills, shared memory and resident CTAs of each
     width; then reduced graphsage-reddit (d_hidden
     64) card vs CPU in float32: full-graph logits (mean, sum, max),
     loss and gradients, minibatch and batched losses and gradients,
     within TOL_GNN_PARITY;
 25. `[gnn_serve]`: graphsage-reddit at full width (random weights) on
     all four GNN shapes, the graphs being `make_graph` draws at the
     shapes' sizes (ogb_products and minibatch_lg drawn by two helper
     processes while the LM phases run): full_graph_sm and ogb_products
     forward p50/p99 of 5 beside the port's floor (`gnn_full_floor`:
     each op's inputs read once, outputs written once, no messages) and
     the reference's message-materialising reckoning (`launch.flops`,
     the step's terms without the 3x of training), and peak bytes; minibatch_lg's
     host sampler ms for 1,024 seeds at fanout (15, 10) and the forward
     on blocks gathered on the card; molecule's batched forward of 128
     graphs; then the kernel at ogb_products' hidden width (F = 128),
     the main path's shape: against its plain version in float64 over
     both CSRs (the backward's zipf hub rows included, in destination
     bands), 8 columns at a time, bit-equal across two calls and to the
     float32 sum in the plan's order (`seg_exact`); the forward's staged
     hot sources, shared memory and the backward's bands (required: some
     of each); forward and backward ms, the plain version's,
     `torch.sparse.mm`'s (the library call) each way and `index_add_`'s
     on gathered messages, and both bounds;
 26. `[gnn_train]`: tiny full_graph_sm card vs CPU after each of 3 steps
     (TOL_GNN_TRAIN), 30 steps at lr 1e-2 (last < 0.8x first, each loss
     within TOL_GNN_LOSS of the CPU's), a restart bit-equal; ogb_products
     at full width, 6 steps: p50/p99 after the first beside the step's
     port floor and the reference's reckoning, peak bytes below the
     (E, 128) message tensor's; 3 steps of
     minibatch_lg on sampled blocks and of molecule, finite losses;
 27. `[gnn_sharded]`: ogb_products partitioned by destination over 4
     gloo ranks (grid (2, 2), time-slicing the card, each reading its
     partition from the run's files): the partitioned loss and gradients
     against the one-process `gnn_full_loss` on the card, float32 wire
     within TOL_SHARDED_LOSS / TOL_SHARDED_GRAD, bfloat16 wire (through
     `train_step.make_loss_fn(arch, shape, grid)`) reported
     (deviations, step ms, bytes gathered, peak bytes a rank);
 28. `[dist_rec]` (the distributed scaffolding, on one world of 4 gloo
     ranks sharing the card for the three `[dist_*]` phases): DLRM-rm2 at
     its published cardinalities (48.08 GB of tables) row-sharded over 4
     ranks (grid (1, 4)), then DCN-v2 on (2, 2) (tables row-sharded over
     2, replicated over 2 data ranks: their sparse gradients exchanged),
     3 steps of `train_loop(grid=)` at train_batch (65,536 rows), the
     ranks taking turns at the draw: the losses within TOL_DIST_LOSS of
     the unsharded trainer's on the card (same seed, same batches), each
     rank's table bytes a quarter (a half) of the tables, step p50 beside
     the unsharded step's, per-rank peak bytes; the trained DLRM-rm2
     moved to `serve_placement` (tablewise: small tables replicated) and
     served at serve_p99 by `make_serve_step(grid=)` against the training
     placement's forward; each rank's parameter and optimizer bytes
     equal to the dry run's train_batch cell's blocks on that grid;
 29. `[dist_lm]`: qwen3-1.7b at its widths, DIST_LM_LAYERS of 28 layers in
     float32, batch 4 x 4,096, 2 steps of `train_loop(grid=(2, 2))`
     (leaves gathered at use a layer at a time) against the unsharded
     trainer on the card: losses, step ms, each rank's state bytes
     against the full state's; its final checkpoint, saved on the grid,
     restored onto (1, 4) by `restore(grid=)` (every leaf's sum equal);
 30. `[dist_parts]`: on the card with CUDA tensors, `moe_apply_ep` at
     qwen2-moe-a2.7b's widths (60 experts, top-4, 4 shared) on (1, 4)
     against `moe_apply` (output and gradients), `cp_attention_wrap` at
     qwen3-1.7b's attention width and 8,192 tokens against one-rank
     attention (loss and gradients), `compressed_psum` bit-equal to the
     same ranks' CPU answer, `pipeline_forward` over 4 stages bit-equal to
     the stages in sequence, and its gradients (weights and inputs)
     within TOL_PIPE of autograd through the stages in sequence; no
     `[dist_*]` phase launches a port kernel.
Each path's launch counts are reset just before it and read just after;
the kernels line gives the main path's as `launches`, the storage
path's as `launches_storage`, the dynamic index's (inserts and readers)
as `launches_dynamic`, the service's as `launches_service`, the sharded
phases' (every rank's timed searches, summed) as `launches_sharded` and
`launches_sharded1m`, the towers' graph requests as
`launches_towers`, the `[cells]` searches' as `launches_cells`, the
`[dryrun_peak]` ANN cells' eager searches as `launches_dryrun_peak`;
`segment_sum`'s `launches` are the GNN serving
path's, and every row has `launches_gnn_train` and
`launches_gnn_sharded` (every rank's timed float32 step). Each phase's seconds are printed as it ends
(`[phase_s]`) and all together before the card line. The run's index
directories live in one temporary directory, removed at exit.
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
# groups), m=50, LUTs too wide for shared memory (f32 at m=256, both
# dtypes at m=1024: the global-LUT path), and the towers' retrieval
# shapes (one user against 1M codes at m=16 and m=8). Every case runs u8
# and i32 codes.
ADC_CASES = ((1, 1_000_000, 10), (8, 1_000_000, 16), (4, 50_000, 128),
             (2, 100_003, 16), (3, 100, 16), (2, 1, 10), (20, 30_000, 16),
             (4, 20_000, 50), (1, 5_000, 256), (2, 3_000, 1024),
             (1, 1_000_000, 16), (1, 1_000_000, 8))
RETRIEVAL_SHAPE, BULK_SHAPE, WIDE_SHAPE = ADC_CASES[:3]
# PQ of the towers' retrieval candidates (one user against 1M projected
# rows of table 0): m so that dsub is 4 or 2 and m % 8 == 0 (DLRM-rm2 D=64,
# DCN-v2 D=16, Wide&Deep D=32); the last two ADC_CASES are their shapes
TOWER_PQ_M = {"dlrm": 16, "dcnv2": 8, "widedeep": 8}


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
              # the towers' retrieval LUTs (TOWER_PQ_M): dsub 4, 2 and 4
              ("dlrm-rm2", 64, "float32", 8, TOWER_PQ_M["dlrm"], "mips"),
              ("dcn-v2", 16, "float32", 8, TOWER_PQ_M["dcnv2"], "mips"),
              ("wide-deep", 32, "float32", 8, TOWER_PQ_M["widedeep"],
               "mips"),
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
    Returns the index's host arrays (vectors, graph, centroids, codes),
    its queries, for the storage and sharded phases, and each search's
    times by (adc, batch)."""
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
    return host_arrays, queries, searches, (idx, lay)


# the dry-run cells served on the card (`[cells]`), and the queries the
# larger one takes
CELL_ARCH, CELL_SHAPES, CELL_QUERIES = "aisaq-sift1m", ("serve_q32",
                                                        "serve_q1k"), 1024


def phase_cells(index_1m, arrays_1m, card: str) -> dict:
    """[cells]: the paper's aisaq-sift1m cells of `launch.inputs.
    build_cell` on grid (1, 1) of a one-rank gloo world in this process
    (mode A: the whole 7.94 GB chunk table on the rank). Each cell's
    `fn`, `sharded_search_fn`'s search, runs on the deployment phase's 1M
    table (already on the card) with its 32 or 1,024 queries, shaped as
    `local_args` says; its ids against `beam_search_device` called
    directly with the same arguments; the dry run's predicted argument
    bytes (`local_bytes`) against the bytes the rank holds; the search's
    peak device bytes above what was allocated before it (the served
    graphs' replay; the dry run's traced peak is held against the eager
    search in `[dryrun_peak]`). Returns the cells' launches (the direct
    calls not counted)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core.device_index import beam_search_device
    from repro_torch.core.sharded_search import ShardedIndexArrays
    from repro_torch.data.vectors import make_queries
    from repro_torch.kernels import _build
    from repro_torch.launch.inputs import build_cell, local_args, \
        local_bytes
    from repro_torch.launch.mesh import ProcessGrid
    idx, lay = index_1m
    cfg = get_arch(CELL_ARCH).model
    queries = make_queries(CELL_QUERIES, arrays_1m[0], seed=5)
    launches = {k: 0 for k in REPLACES}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        grid = ProcessGrid((1, 1), ("data", "model"))
        arrays = ShardedIndexArrays(
            chunk_words=idx.chunk_words[None], centroids=idx.centroids,
            ep_ids=idx.ep_ids[None], ep_codes=idx.ep_codes[None],
            offsets=torch.zeros((1,), dtype=torch.int32, device="cuda"))
        for name in CELL_SHAPES:
            cell = build_cell(CELL_ARCH, name, grid)
            want = local_args(cell, grid)
            q = torch.from_numpy(queries[:cell.args[1].shape[0]]).cuda()
            got = [(tuple(t.shape), t.dtype) for t in (*arrays, q)]
            spec = [(tuple(t.shape), t.dtype) for t in (*want[0], want[1])]
            require(got == spec, f"{name}: the rank's inputs {got} are not "
                    f"local_args' {spec}")
            held = sum(t.numel() * t.element_size() for t in (*arrays, q))
            predicted = local_bytes(cell, grid)
            cell.fn(arrays, q)                       # capture
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ids, d = cell.fn(arrays, q)
            torch.cuda.synchronize()
            t_cell = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - before
            for k, v in _build.launch_counts.items():
                if k in launches:
                    launches[k] += v
            direct = beam_search_device(
                idx, q, k=10, L=128, w=cfg.beamwidth,
                max_hops=cfg.max_hops, layout=lay, metric=cfg.metric)
            equal = bool(torch.equal(ids, direct[0]))
            log("cells", arch=CELL_ARCH, shape=name, grid="[1,1]",
                mode=cell.meta["mode"], n_shards=cell.meta["n_shards"],
                chunk_gb_per_dev=cell.meta["chunk_gb_per_dev"],
                batch=q.shape[0], ids_equal_direct=equal,
                valid_ids=int((ids >= 0).sum()),
                predicted_arg_bytes=predicted, held_arg_bytes=held,
                peak_bytes=peak, search_ms=f"{t_cell * 1e3:.3f}",
                card=json.dumps(card))
            require(equal, f"{name}: the cell's ids differ from "
                    "beam_search_device's")
            require(predicted == held, f"{name}: the dry run predicts "
                    f"{predicted} argument bytes, the rank holds {held}")
    finally:
        dist.destroy_process_group()
    log("cells", launches=compact({k: v for k, v in launches.items() if v}))
    require(launches["fused_hop_f32"] > 0 and launches["pq_lut"] > 0,
            "the cells launched no hop_kernel<false> or pq_lut_kernel")
    return launches


# the dry run on the card's host (`[dryrun]`): (arch, shape or None for
# all its shapes, both meshes)
DRYRUN_CELLS = (("aisaq-sift1m", None, True), ("aisaq-sift1b", None, True),
                ("aisaq-kilt-e5", None, True),
                ("qwen3-1.7b", "decode_32k", False),
                ("dcn-v2", "serve_p99", False))

_DRYRUN = """
import sys
from repro_torch.launch import dryrun
for arch, shape, both in %r:
    argv = ["--arch", arch, "--out", sys.argv[1], "--force"]
    argv += ["--shape", shape] if shape else []
    argv += ["--both-meshes"] if both else []
    assert dryrun.main(argv) == 0, (arch, shape)
"""


# the keys every dry-run record carries, and those an ANN cell adds
DRYRUN_KEYS = {"memory": ("argument_size_in_bytes", "output_size_in_bytes",
                          "peak_bytes", "temp_size_in_bytes",
                          "alias_size_in_bytes"),
               "cost": ("flops", "bytes accessed", "transcendentals")}
DRYRUN_ANN_KEYS = ("hops_counted", "per_hop", "kernels")


def phase_dryrun(root: str, card: str) -> None:
    """[dryrun]: `python -m repro_torch.launch.dryrun`'s cells on this
    host in a subprocess (the fake 256- and 512-rank worlds and the meta
    trace of the card's torch): the ANN archs on both meshes, qwen3-1.7b
    decode_32k and dcn-v2 serve_p99 on 256 ranks; one line a record
    (argument bytes, collective MB by op, flops x ranks / model flops,
    bytes accessed, transcendentals, peak, temp and alias bytes; every
    record must carry every `DRYRUN_KEYS` key, an ANN cell also
    `DRYRUN_ANN_KEYS`, whose hops counted and per-hop counts it logs)."""
    out = os.path.join(root, "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_GNN", None)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _DRYRUN % (DRYRUN_CELLS,),
                        out], env=env, capture_output=True, text=True,
                       timeout=600)
    require(r.returncode == 0, "the dry run failed: "
            + r.stdout[-1500:] + r.stderr[-1500:])
    n = 0
    for fname in sorted(os.listdir(out)):
        with open(os.path.join(out, fname)) as f:
            rec = json.load(f)
        for sec in ("memory", "cost", "collectives"):
            require("error" not in rec[sec],
                    f"{fname}: {sec} {rec[sec]}")
        mem, cost = rec["memory"], rec["cost"]
        ann = rec["meta"].get("mode") is not None
        missing = [k for k in DRYRUN_KEYS["memory"] if k not in mem] + \
            [k for k in DRYRUN_KEYS["cost"] + (DRYRUN_ANN_KEYS if ann
                                               else ()) if k not in cost]
        require(not missing, f"{fname}: no {missing}")
        ann_counts = dict(hops_counted=cost["hops_counted"],
                          per_hop_flops=cost["per_hop"]["flops"],
                          per_hop_bytes=cost["per_hop"]["bytes accessed"]) \
            if ann else {}
        coll = {k: v for k, v in rec["collectives"].items() if k != "note"}
        log("dryrun", arch=rec["arch"], shape=rec["shape"],
            mesh=compact(rec["mesh"]), n_devices=rec["n_devices"],
            arg_bytes=rec["memory"]["argument_size_in_bytes"],
            collective_MB=compact({k: round(v["bytes"] / 1e6, 3)
                                   for k, v in coll.items()}),
            collective_counts=compact({k: v["count"]
                                       for k, v in coll.items()}),
            flops=cost["flops"],
            flops_x_ranks_over_model=cost.get("flops_x_ranks_over_model"),
            bytes_accessed=cost.get("bytes accessed", "-"),
            transcendentals=cost.get("transcendentals", "-"),
            peak_bytes=mem.get("peak_bytes", "-"),
            temp_size_in_bytes=mem.get("temp_size_in_bytes", "-"),
            alias_size_in_bytes=mem.get("alias_size_in_bytes", "-"),
            t_build_s=rec["t_build_s"], t_trace_s=rec["t_trace_s"],
            mode=rec["meta"].get("mode", "-"), **ann_counts,
            card=json.dumps(card))
        n += 1
    log("dryrun", records=n, wall_s=f"{time.perf_counter() - t0:.2f}")
    require(n == 3 * 2 * 2 + 2, f"{n} dry-run records")


# the dry run's peak held against the card (`[dryrun_peak]`): (arch,
# shape, whether the peak is an upper bound only). dlrm-rm2's is: its
# sparse gradients' nnz and its meta lookup's ids are upper bounds. The
# ANN cells: sift1m in mode A (62,500 rows a shard, 64 queries), sift1b
# in mode B (3,906,250 rows, 8.0 GB, 1,024 queries in 8 chunks).
PEAK_CELLS = (("qwen3-1.7b", "decode_32k", False),
              ("qwen3-1.7b", "train_4k", False),
              ("dlrm-rm2", "train_batch", True),
              ("aisaq-sift1m", "serve_q1k", False),
              ("aisaq-sift1b", "serve_q1k", False))
PEAK_REL, PEAK_SLACK = 0.10, 256 << 20     # the band: 10% or 256 MB
# an ANN cell's band: its peak is tens of MB, which PEAK_SLACK would pass
# whatever it was
ANN_PEAK_REL, ANN_PEAK_SLACK = 0.10, 2 << 20


def card_args(cell, local, seed: int = 0):
    """`local` (the rank's meta blocks, `inputs.local_args`) as CUDA
    tensors, in place for modules (their `attach` marks kept): float
    leaves seeded normal draws; the batch's integer leaves as the port's
    batch makers draw them for the family (an LM's training tokens from
    `TokenStream`, decode tokens uniform as `[lm_serve]` draws them, a
    recommender's ids and labels from `ClickStream`); other integer
    leaves zeros. Returns (args, {path: how})."""
    import torch
    from torch import nn
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import ClickStream, TokenStream
    arch = get_arch(cell.arch_id)
    shape = arch.shape(cell.shape_name)
    rng = np.random.default_rng(seed)
    g = torch.Generator("cuda").manual_seed(seed)
    batch = {}
    if shape.kind == "lm_train":
        batch = TokenStream(arch.model.vocab_size, shape.seq_len,
                            shape.global_batch, seed=seed).batch_at(0)
    elif shape.kind == "lm_decode":
        batch = {"token": rng.integers(0, arch.model.vocab_size,
                                       shape.global_batch).astype(np.int32)}
    elif arch.family == "recsys" and arch.model.kind != "sasrec":
        batch = ClickStream(arch.model, shape.batch, seed=seed).batch_at(0)
    how = {}

    def leaf(path, t):
        key = path.rsplit("/", 1)[-1]
        if t.dtype.is_floating_point:
            how[path] = "normal"
            return torch.randn(tuple(t.shape), generator=g, device="cuda",
                               dtype=torch.float32).to(t.dtype)
        if int(path.split("/")[0]) in cell.whole and key in batch:
            how[path] = "batch_maker"
            got = torch.from_numpy(np.ascontiguousarray(batch[key]))
            return got.to(device="cuda", dtype=t.dtype)
        how[path] = "zeros"
        return torch.zeros(tuple(t.shape), dtype=t.dtype, device="cuda")

    def walk(tree, path):
        if isinstance(tree, torch.Tensor):
            return leaf(path, tree)
        if isinstance(tree, nn.Module):
            for name, p in list(tree.named_parameters()) + \
                    list(tree.named_buffers()):
                owner, _, attr = name.rpartition(".")
                new = leaf(f"{path}/{name.replace('.', '/')}", p.detach())
                if isinstance(p, nn.Parameter):
                    new = nn.Parameter(new, requires_grad=p.requires_grad)
                setattr(tree.get_submodule(owner), attr, new)
            return tree
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(getattr(tree, f), f"{path}/{f}")
                                for f in tree._fields))
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(c, f"{path}/{i}")
                              for i, c in enumerate(tree))
        if isinstance(tree, dict):
            return {k: walk(c, f"{path}/{k}") for k, c in tree.items()}
        return tree

    args = tuple(walk(a, str(i)) for i, a in enumerate(local))
    return args, how


def ann_card_args(cell, local, seed: int = 0):
    """An ANN cell's `local` (the rank's meta shard and query block) as a
    real shard on the card: vectors of the index's dtype, random PQ codes
    and a random R-regular graph (`vamana.random_regular_graph`), packed
    by `pack_chunks_torch`, so every neighbour id a hop reads is a row of
    the shard; random centroids; entry points below N_s with their codes;
    offset 0; the queries drawn in the vectors' range. Returns (args,
    {field: how})."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.chunk_layout import layout_for, pack_chunks_torch
    from repro_torch.core.sharded_search import ShardedIndexArrays
    from repro_torch.core.vamana import random_regular_graph
    cfg = get_arch(cell.arch_id).model
    lay = layout_for(cfg, "aisaq")
    arrays, queries = local
    n_s = arrays.chunk_words.shape[1]
    g = torch.Generator("cuda").manual_seed(seed)
    if cfg.data_dtype == "uint8":
        vecs = torch.randint(0, 256, (n_s, cfg.dim), generator=g,
                             device="cuda", dtype=torch.uint8)
        q = torch.rand(tuple(queries.shape), generator=g,
                       device="cuda") * 255
    else:
        vecs = torch.randn((n_s, cfg.dim), generator=g, device="cuda")
        q = torch.randn(tuple(queries.shape), generator=g, device="cuda")
    codes = torch.randint(0, cfg.pq_ks, (n_s, cfg.pq_m), generator=g,
                          device="cuda", dtype=torch.uint8)
    graph = random_regular_graph(n_s, cfg.R, seed=seed, device="cuda")
    words = pack_chunks_torch(vecs, graph, codes, lay)
    del vecs, graph
    ep = torch.randint(0, n_s, (cfg.n_ep,), generator=g, device="cuda",
                       dtype=torch.int32)
    cent = torch.randn(tuple(arrays.centroids.shape), generator=g,
                       device="cuda")
    if cfg.data_dtype == "uint8":
        cent = cent * 40 + 128
    args = (ShardedIndexArrays(
        chunk_words=words[None], centroids=cent, ep_ids=ep[None],
        ep_codes=codes[ep.long()].to(torch.int32)[None],
        offsets=torch.zeros((1,), dtype=torch.int32, device="cuda")), q)
    got = [(tuple(t.shape), t.dtype) for t in (*args[0], args[1])]
    want = [(tuple(t.shape), t.dtype) for t in (*arrays, queries)]
    require(got == want, f"the card's shard {got} is not local_args' "
            f"{want}")
    how = {"chunk_words": f"pack_chunks_torch({cfg.data_dtype} vectors, "
           f"random_regular_graph(R={cfg.R}), random codes)",
           "centroids": "normal", "ep_ids": "uniform < N_s",
           "ep_codes": "the entry points' codes", "offsets": "zero",
           "queries": "uniform 0-255" if cfg.data_dtype == "uint8"
           else "normal"}
    return args, how


def ann_search_peak(cell, args) -> dict:
    """The cell's `fn` on the card twice, each time with its local
    searches (`sharded_search.beam_search_device`) recorded: first with
    every search eager (`cuda_graph=False`: the ops the dry run traces,
    with the merge after them), whose peak device bytes above what was
    allocated before it and launches are returned; then as served, its
    first call capturing the CUDA graphs (peak logged, not judged). The
    searches' ids must be valid and equal between the two runs."""
    import torch
    from repro_torch.core import sharded_search as SS
    from repro_torch.kernels import _build
    served = SS.beam_search_device

    def run(graph: bool):
        got = []

        def search(*a, **kw):
            out = served(*a, cuda_graph=graph, **kw)
            got.append(out)
            return out
        SS.beam_search_device = search
        try:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cell.fn(*args)
            torch.cuda.synchronize()
            return got, torch.cuda.max_memory_allocated() - before, \
                time.perf_counter() - t0, dict(_build.launch_counts)
        finally:
            SS.beam_search_device = served
    eager, measured, t_step, launches = run(False)
    graphed, graph_peak, t_graph, _ = run(True)
    ids = torch.cat([e[0] for e in eager])
    require(bool((ids >= 0).all()), f"{cell.arch_id}: an eager search "
            "answered fewer than k ids")
    require(all(torch.equal(e[0], g[0]) and e[2] == g[2]
                for e, g in zip(eager, graphed)),
            f"{cell.arch_id}: the eager and graph searches differ")
    return dict(measured=measured, t_step_s=round(t_step, 2),
                graph_first_call_peak=graph_peak,
                t_graph_s=round(t_graph, 2), hops=[e[2] for e in eager],
                launches={k: v for k, v in launches.items() if v})


def dryrun_peak_cell(arch_id: str, shape_name: str) -> dict:
    """One cell in a fake 256-rank world on the card: the dry run's record
    (`dryrun.run_cell`, meta), then rank 0's step once on CUDA tensors of
    the same blocks (`card_args`); the step's peak device bytes above
    what was allocated before it. An ANN cell's blocks are a real shard
    (`ann_card_args`) and its step runs eagerly (`ann_search_peak`)."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.act_sharding import set_policy
    from repro_torch.launch import dryrun
    from repro_torch.launch.inputs import build_cell, local_args
    from repro_torch.launch.mesh import make_production_grid
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch_id, shape_name, multi_pod=False,
                          verbose=False)
    t_meta = time.perf_counter() - t0
    grid = make_production_grid()
    set_policy(grid)
    ann = get_arch(arch_id).family == "ann"
    extra = {}
    try:
        cell = build_cell(arch_id, shape_name, grid)
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        args, how = (ann_card_args if ann else card_args)(
            cell, local_args(cell, grid))
        torch.cuda.synchronize()
        t_args = time.perf_counter() - t1
        before = torch.cuda.memory_allocated()
        if ann:
            extra = ann_search_peak(cell, args)
            measured, t_step = extra.pop("measured"), extra.pop("t_step_s")
            extra.update(t_args_s=round(t_args, 2), ann=True)
        else:
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            out = cell.fn(*args)
            torch.cuda.synchronize()
            t_step = time.perf_counter() - t1
            measured = torch.cuda.max_memory_allocated() - before
            del out
    finally:
        set_policy(None)
    draws = {}
    for path, h in how.items():
        draws.setdefault(h, []).append(path)
    del args, cell
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=arch_id, shape=shape_name, measured=measured,
                arg_bytes=before - base, memory=rec["memory"],
                t_meta_s=round(t_meta, 2), t_step_s=round(t_step, 2),
                draws={h: p if h != "normal" else len(p)
                       for h, p in draws.items()}, **extra)


_DRYRUN_PEAK = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from repro_torch.launch.mesh import fake_world
fake_world(256)
for arch, shape, _ in chip_smoke.PEAK_CELLS:
    print(json.dumps(chip_smoke.dryrun_peak_cell(arch, shape)), flush=True)
"""


def start_dryrun_peak(root: str):
    """Start `[dryrun_peak]`'s subprocess (`_DRYRUN_PEAK`), its output
    under `root`; `phase_dryrun_peak` waits for it. It runs beside the
    10k build, whose Vamana graph holds the host for minutes and the card
    not at all, so no timed phase shares the card with it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_GNN", None)
    env.pop("REPRO_MB_BUDGET_GB", None)
    out = open(os.path.join(root, "dryrun_peak.out"), "w+")
    err = open(os.path.join(root, "dryrun_peak.err"), "w+")
    proc = subprocess.Popen([sys.executable, "-c", _DRYRUN_PEAK, ROOT],
                            env=env, stdout=out, stderr=err, text=True)
    return proc, out, err


def stop_dryrun_peak(run) -> None:
    """Kill a `start_dryrun_peak` run that is still going; close its
    files."""
    proc, out, err = run
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)
    out.close()
    err.close()


def phase_dryrun_peak(run, card: str) -> dict:
    """[dryrun_peak]: the dry run's `peak_bytes` against the card's
    allocator. One subprocess (`start_dryrun_peak`) starts a fake world
    of 256 ranks (its collectives move nothing: values are garbage after
    a gather, the bytes are not) and runs each `PEAK_CELLS` cell twice as
    rank 0: the dry run's meta trace, then the step on CUDA tensors,
    measuring max_memory_allocated() - memory_allocated() before the
    call. Within `PEAK_REL` or `PEAK_SLACK` of the peak, whichever is
    larger (an ANN cell: `ANN_PEAK_REL` or `ANN_PEAK_SLACK`); an
    upper-bound cell at most `PEAK_SLACK` above it. Returns the ANN
    cells' eager searches' launches."""
    proc, out, err = run
    try:
        proc.wait(timeout=400)
    except subprocess.TimeoutExpired:
        stop_dryrun_peak(run)
        raise AssertionError("the dry run's peak check ran over 400 s")
    out.seek(0)
    err.seek(0)
    text = out.read()
    require(proc.returncode == 0, "the dry run's peak check failed: "
            + text[-1500:] + err.read()[-3000:])
    got = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    require(len(got) == len(PEAK_CELLS), f"{len(got)} cells measured")
    bad = []
    launches = {}
    for res, (_, _, upper) in zip(got, PEAK_CELLS):
        mem, measured = res["memory"], res["measured"]
        peak = mem["peak_bytes"]
        ann = res.get("ann", False)
        band = max(ANN_PEAK_REL * peak, ANN_PEAK_SLACK) if ann else \
            max(PEAK_REL * peak, PEAK_SLACK)
        ann_log = {}
        if ann:
            ann_log = dict(
                hops=compact(res["hops"]),
                graph_first_call_peak_bytes=res["graph_first_call_peak"],
                t_graph_s=res["t_graph_s"], t_args_s=res["t_args_s"],
                launches=compact(res["launches"]))
            for k, v in res["launches"].items():
                launches[k] = launches.get(k, 0) + v
        log("dryrun_peak", arch=res["arch"], shape=res["shape"],
            measured_peak_bytes=measured, dryrun_peak_bytes=peak,
            ratio=f"{measured / peak:.4f}" if peak else "-",
            band_bytes=int(band), check="upper_bound" if upper else "band",
            arg_bytes_card=res["arg_bytes"],
            arg_bytes_dryrun=mem["argument_size_in_bytes"],
            temp_size_in_bytes=mem["temp_size_in_bytes"],
            alias_size_in_bytes=mem["alias_size_in_bytes"],
            output_size_in_bytes=mem["output_size_in_bytes"],
            t_meta_s=res["t_meta_s"], t_step_s=res["t_step_s"],
            draws=compact(res["draws"]), **ann_log, card=json.dumps(card))
        ok = measured <= peak + PEAK_SLACK if upper else \
            abs(measured - peak) <= band
        if not ok:
            bad.append(f"{res['arch']} {res['shape']}: the card's peak "
                       f"{measured} against the dry run's {peak}")
    require(not bad, "; ".join(bad))
    require(launches.get("fused_hop_f32", 0) > 0
            and launches.get("pq_lut", 0) > 0,
            "the ANN cells launched no hop_kernel<false> or pq_lut_kernel")
    return launches


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


# ---------------------------------------------------------------------------
# the write half: dynamic index, crash drill, service, cluster
# ---------------------------------------------------------------------------

# held-out vectors inserted into the 10k index (cut from 512: on a slow
# host the whole script neared the 1,200 s a run may take)
DYN_INSERTS = 256
DYN_READERS = 3
DYN_DELETES = 64
DYN_KERNELS = ("fused_hop_f32", "pq_lut")
CRASH_N = 2_000          # the crash drill's index (SIFT1M widths)
SERVICE_REQUESTS = 512
SERVICE_CLIENTS = 8
CLUSTER_QUERIES = 256
CLUSTER_CLIENTS = 4


def held_out(base, n: int):
    """n vectors from the 10k index's distribution: `make_clustered`'s
    mixture (its 64 centres and power-law weights, drawn from the index's
    seed, as `repro_torch.data.vectors.make_clustered` draws them) with
    fresh assignments and noise. Checked: the indexed vectors lie near
    these centres."""
    d = base.shape[1]
    rng = np.random.default_rng(0)            # make_clustered(seed=0)
    centers = rng.normal(size=(64, d)).astype(np.float32)
    near = ((base[:, None, :] - centers[None]) ** 2).sum(-1).min(1)
    require(float(near.mean()) < 0.15 ** 2 * d * 2,
            "the held-out vectors' centres are not the index's")
    w = 1.0 / np.arange(1, 65) ** 0.7
    fresh = np.random.default_rng(12345)
    assign = fresh.choice(64, size=n, p=w / w.sum())
    x = centers[assign] + 0.15 * fresh.normal(size=(n, d)).astype(
        np.float32)
    return x.astype(np.float32)


def percentiles_ms(seconds) -> dict:
    a = np.asarray(seconds) * 1e3
    return dict(p50_ms=f"{np.percentile(a, 50):.3f}",
                p99_ms=f"{np.percentile(a, 99):.3f}")


def phase_dynamic(arrays, queries, root):
    """`DynamicHostIndex(device="cuda")` over a copy of the 10k index:
    256 held-out vectors inserted while 3 reader threads search (L=256,
    k=10) the whole time (launch counts reset just before, read just
    after); then 64 labels deleted, filtered searches, flush, reload, and
    `compact` to a sibling directory searched on the card and on the CPU.
    Searches and inserts take turns at the process's search gate
    (`repro_torch.core.traversal`). Returns the path's launches."""
    import threading
    from repro_torch.core.dynamic import DynamicHostIndex
    from repro_torch.core.index_io import HostIndex
    from repro_torch.core.pq import groundtruth, recall_at
    from repro_torch.kernels import _build
    base = arrays[0]
    held = held_out(base, DYN_INSERTS)
    ext = np.concatenate([base, held])
    path = os.path.join(root, "dyn10k")
    shutil.copytree(os.path.join(root, "sift10k"), path)
    idx = DynamicHostIndex.load(path, device="cuda")
    peak = peak_search_bytes(lambda: idx.search(queries[0], 10, L=SEARCH_L))
    t0 = time.perf_counter()
    idx.search(queries[0], 10, L=SEARCH_L)
    alone_ms = (time.perf_counter() - t0) * 1e3
    stop = threading.Event()
    errors, served = [], [0] * DYN_READERS

    def reader(r):
        i = r
        while not stop.is_set():
            try:
                ids, _ = idx.search(queries[i % len(queries)], 10,
                                    L=SEARCH_L)
                require(len(ids) == 10 and (ids < idx.n + 1).all(),
                        f"reader {r}: bad result {ids}")
            except Exception as e:        # reported and required below
                errors.append(repr(e))
                return
            served[r] += 1
            i += DYN_READERS

    def insert_all(vecs):
        out = []
        for v in vecs:
            t1 = time.perf_counter()
            labels.append(idx.insert(v))
            out.append(time.perf_counter() - t1)
        return out

    labels = []
    readers = [threading.Thread(target=reader, args=(r,), daemon=True)
               for r in range(DYN_READERS)]
    _build.reset_launch_counts()
    for t in readers:
        t.start()
    t0 = time.perf_counter()
    try:
        lat = insert_all(held)
    finally:
        wall = time.perf_counter() - t0
        stop.set()
        for t in readers:
            t.join(60.0)
    launches = dict(_build.launch_counts)
    hung = sum(t.is_alive() for t in readers)
    log("dynamic", n=len(base), inserts=len(lat), readers=DYN_READERS,
        inserts_per_s=f"{len(lat) / wall:.2f}", insert_wall_s=f"{wall:.2f}",
        **{f"insert_{k}": v for k, v in percentiles_ms(lat).items()},
        reader_queries=sum(served),
        reader_qps=f"{sum(served) / wall:.2f}",
        reader_errors=len(errors), readers_hung=hung,
        search_alone_ms=f"{alone_ms:.2f}",
        peak_device_bytes_reader_search=peak,
        launches=json.dumps(launches, separators=(",", ":")))
    require(not errors, f"reader errors: {errors[:3]}")
    require(hung == 0, f"{hung} reader threads did not end")
    require(min(served) > 0, f"a reader served nothing: {served}")
    require(labels == list(range(len(base), len(ext))),
            "insert labels are not the next ids")
    require(all(launches[k] > 0 for k in DYN_KERNELS),
            f"a kernel was not launched on the dynamic path: {launches}")
    # deletes: the rank-1 answers of 64 queries, then filtered searches
    q64 = queries[:DYN_DELETES]
    first, _ = idx.search_batch(q64, 1, L=SEARCH_L)
    victims = sorted(set(int(i) for i in first[:, 0]))
    for lab in victims:
        idx.delete(lab)
    dead = set(victims)
    leaked = 0
    for q in q64:
        ids, _ = idx.search(q, 10, L=SEARCH_L)
        leaked += len(dead & set(int(i) for i in ids))
        require(len(ids) == 10, "a filtered search came back short")
    ids, _ = idx.search(queries[-1], 10, L=SEARCH_L,
                        predicate=lambda i: i % 2 == 0)
    require(len(ids) == 10 and all(int(i) % 2 == 0 for i in ids),
            f"predicate search returned {ids}")
    idx.flush()
    crc = idx.cache.counters.crc_mismatches
    idx.close()
    # reload: recall over the grown set, self-recall of the inserts
    t0 = time.perf_counter()
    idx = DynamicHostIndex.load(path, device="cuda")
    reload_s = time.perf_counter() - t0
    n = int(idx.meta["n"])
    # recall over the live set: ground truth without the deleted vectors
    # (labels are rows of `ext`: the 10k index is not relabelled)
    alive = np.setdiff1d(np.arange(len(ext)), sorted(dead))
    gt = alive[groundtruth(queries, ext[alive], 10, device="cuda")]
    got = np.concatenate([idx.search_batch(queries[s:s + 64], 10,
                                           L=SEARCH_L)[0]
                          for s in range(0, len(queries), 64)])
    rec = recall_at(got, gt, 10)
    live = [i for i, lab in enumerate(labels) if lab not in dead]
    self_ids = np.concatenate([idx.search_batch(
        held[live[s:s + 64]], 1, L=SEARCH_L)[0]
        for s in range(0, len(live), 64)])[:, 0]
    self_rec = float(np.mean(self_ids == np.asarray(labels)[live]))
    leaked += len(dead & set(int(i) for i in got.ravel())) \
        + len(dead & set(int(i) for i in self_ids))
    crc += idx.cache.counters.crc_mismatches
    # compaction to a sibling directory, searched on the card and the CPU
    dst = os.path.join(root, "dyn10k_v2")
    t0 = time.perf_counter()
    cmeta = idx.compact(dst, relabel=True)
    compact_s = time.perf_counter() - t0
    idx.close()
    gpu = HostIndex.load(dst, device="cuda")
    cpu = HostIndex.load(dst, device="cpu")
    a = gpu.search_batch(q64, 10, L=SEARCH_L)[0]
    b = cpu.search_batch(q64, 10, L=SEARCH_L)[0]
    agree = agreement(a, b)
    compact_leak = len(dead & set(int(i) for i in a.ravel()))
    gpu.close(), cpu.close()
    log("dynamic", deleted=len(victims), tombstones_in_results=leaked,
        reload_n=n, reload_s=f"{reload_s:.3f}",
        recovery_journaled=0, crc_mismatches=crc,
        recall10_live=f"{rec:.4f}", self_recall1=f"{self_rec:.4f}",
        compact_s=f"{compact_s:.2f}", compact_n=cmeta["n"],
        compact_cpu_agreement=f"{agree:.4f}",
        compact_tombstones_in_results=compact_leak)
    require(n == len(ext), f"meta n {n} after reload, want {len(ext)}")
    require(crc == 0, f"{crc} CRC mismatches on the dynamic index")
    require(leaked == 0, f"{leaked} tombstoned labels in results")
    require(self_rec >= 0.8, f"self-recall@1 of the inserts {self_rec}")
    require(rec >= 0.8, f"recall@10 over the live grown set {rec} < 0.8")
    require(cmeta["n"] == len(ext) - len(victims), "compacted n")
    require(compact_leak == 0, "the compacted index serves deleted labels")
    require(agree >= 0.99, f"compacted index: card/CPU agreement {agree}")
    return launches


def cut_graph(graph, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of a graph as a graph of their own: edges leaving
    the range dropped, ids shifted by lo, each row packed to the left."""
    g = np.full((hi - lo, graph.shape[1]), -1, np.int32)
    for i, row in enumerate(np.asarray(graph[lo:hi])):
        keep = row[(row >= lo) & (row < hi)] - lo
        g[i, :len(keep)] = keep
    return g


def crash_index(arrays, root) -> str:
    """The first 2,000 vectors of the 10k index with their graph cut to
    them, written by the port."""
    from repro_torch.core.index_io import write_index
    base, graph, cents, codes = arrays
    path = os.path.join(root, "crash2k")
    write_index(path, vectors=base[:CRASH_N],
                graph=cut_graph(graph, 0, CRASH_N), centroids=cents,
                codes=codes[:CRASH_N], metric="l2", mode="aisaq")
    return path


def phase_crash_drill(arrays, root):
    """Every `KillSwitch` tick of one insert plus its flush on a 2,000-
    vector index at SIFT1M widths: for each tick a fresh copy is crashed
    there, abandoned, and recovered by `DynamicHostIndex.load(device=
    "cuda")`; n is the pre- or post-insert value (post if committed), no
    edge dangles, no CRC mismatch, the journal is empty, and a rolled-
    forward vector is found at rank 1 by a search on the card."""
    from repro_torch.core.dynamic import DynamicHostIndex
    from repro_torch.core.faults import CrashPoint, KillSwitch
    src = crash_index(arrays, root)
    vec = arrays[0][CRASH_N]
    work = os.path.join(root, "crash_work")
    shutil.copytree(src, work)
    ks = KillSwitch()
    h = DynamicHostIndex.load(work, kill=ks, device="cuda")
    h.insert(vec)
    h.flush()
    h.close()
    shutil.rmtree(work)
    total = ks.count
    rec_ms, outcomes = [], {"rolled_back": 0, "rolled_forward": 0,
                            "clean": 0}
    t_all = time.perf_counter()
    for at in range(1, total + 1):
        shutil.copytree(src, work)
        h = DynamicHostIndex.load(work, kill=KillSwitch(at=at),
                                  device="cuda")
        committed = False
        try:
            h.insert(vec)
            committed = True
            h.flush()
        except CrashPoint:
            pass
        h.abandon()
        t0 = time.perf_counter()
        r = DynamicHostIndex.load(work, device="cuda")
        rec_ms.append((time.perf_counter() - t0) * 1e3)
        n = int(r.meta["n"])
        require(n in (CRASH_N, CRASH_N + 1), f"at={at}: n={n}")
        require(not committed or n == CRASH_N + 1,
                f"at={at}: a committed insert was lost")
        for node in range(n):
            _, nbrs, _ = r._read_node(node)
            live = nbrs[nbrs >= 0]
            require(bool((live < n).all()), f"at={at}: dangling edge")
        if n == CRASH_N + 1:
            ids, _ = r.search(vec, 1, L=SEARCH_L)
            require(int(ids[0]) == CRASH_N,
                    f"at={at}: rolled-forward vector not at rank 1")
        require(r.cache.counters.crc_mismatches == 0,
                f"at={at}: CRC mismatch after recovery")
        require(r.wal.size == 0, f"at={at}: journal not empty")
        key = "rolled_back" if r.recovery["rolled_back"] else \
            "rolled_forward" if r.recovery["rolled_forward"] else "clean"
        outcomes[key] += 1
        r.close()
        shutil.rmtree(work)
    log("crash_drill", n=CRASH_N, ticks=total,
        median_recovery_ms=f"{np.median(rec_ms):.3f}",
        max_recovery_ms=f"{max(rec_ms):.3f}",
        drill_s=f"{time.perf_counter() - t_all:.1f}",
        outcomes=json.dumps(outcomes, separators=(",", ":")))
    require(total > 10, f"only {total} crash points")


def phase_service(queries, root):
    """`RetrievalService` over `WarmIndexPool(device="cuda")` with the 10k
    index and its relabelled copy: 512 requests (k=10, L=256, rerank 100)
    from 8 client threads, each answer equal to a direct
    `HostIndex.search_batch` on the card; then a third corpus whose
    wal.log holds a torn frame opens through journal recovery. Returns
    the path's launches."""
    import threading
    from repro_torch.core.index_io import HostIndex
    from repro_torch.core.wal import WAL_NAME
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import make_host_search_fn
    from repro_torch.serving.pool import WarmIndexPool
    from repro_torch.serving.service import RetrievalService
    paths = {"sift10k": os.path.join(root, "sift10k"),
             "sift10k_rl": os.path.join(root, "sift10k_rl")}
    skw = dict(L=SEARCH_L, rerank=RERANK)
    want = {}
    for name, p in paths.items():
        h = HostIndex.load(p, device="cuda")
        fn = make_host_search_fn(h, **skw)    # the service's own search
        want[name] = np.concatenate([fn(queries[s:s + 64], 10)
                                     for s in range(0, len(queries), 64)])
        h.close()
    pool = WarmIndexPool(paths, device="cuda")
    svc = RetrievalService(pool, num_workers=4, max_batch=16,
                           max_wait_ms=2.0, **skw)
    names = sorted(paths)
    bad, errors = [], []

    def client(c):
        for i in range(c, SERVICE_REQUESTS, SERVICE_CLIENTS):
            name, qi = names[i % 2], (i // 2) % len(queries)
            try:
                r = svc.submit_wait(queries[qi], corpus=name, k=10,
                                    timeout=120.0)
            except Exception as e:        # reported and required below
                errors.append(repr(e))
                return
            if not np.array_equal(r.result, want[name][qi]):
                bad.append((name, qi))

    _build.reset_launch_counts()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(SERVICE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300.0)
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    st = svc.stats()
    per = {c: {k: (round(v, 3) if isinstance(v, float) else v)
               for k, v in s.items()
               if k in ("completed", "batches", "mean_batch", "switches",
                        "p50_ms", "p99_ms", "errors")}
           for c, s in st["corpora"].items()}
    # a crashed writer's directory: a torn frame in its journal
    torn = os.path.join(root, "sift10k_torn")
    shutil.copytree(paths["sift10k"], torn)
    garbage = b"\xde\xad\xbe\xef" + b"\x00" * 33
    with open(os.path.join(torn, WAL_NAME), "wb") as f:
        f.write(garbage)
    pool.register("torn", torn)
    r = svc.submit_wait(queries[0], corpus="torn", k=10, timeout=120.0)
    rec = pool.stats()["recoveries"]
    svc.close()
    pool.close()
    log("service", corpora=len(paths), requests=SERVICE_REQUESTS,
        clients=SERVICE_CLIENTS, workers=4,
        qps=f"{SERVICE_REQUESTS / wall:.2f}", wall_s=f"{wall:.2f}",
        p50_ms=f"{st.get('p50_ms', 0):.3f}",
        p99_ms=f"{st.get('p99_ms', 0):.3f}",
        mismatches=len(bad), errors=len(errors),
        per_corpus=json.dumps(per, separators=(",", ":")),
        launches=json.dumps(launches, separators=(",", ":")))
    log("service", recoveries=json.dumps(rec, separators=(",", ":")),
        torn_corpus_answer_equal=bool(np.array_equal(r.result,
                                                     want["sift10k"][0])))
    require(not errors and not any(t.is_alive() for t in threads),
            f"service clients failed: {errors[:3]}")
    require(st["total_completed"] == SERVICE_REQUESTS,
            f"{st['total_completed']} of {SERVICE_REQUESTS} completed")
    require(not bad, f"{len(bad)} service answers differ from a direct "
            f"search on the card: {bad[:5]}")
    require(set(rec) == {"torn"} and rec["torn"]["torn"]
            and rec["torn"]["truncated_bytes"] == len(garbage),
            f"the torn journal is not in recoveries: {rec}")
    require(np.array_equal(r.result, want["sift10k"][0]),
            "the recovered corpus answers differently")
    require(all(launches[k] > 0 for k in DYN_KERNELS),
            f"a kernel was not launched on the service path: {launches}")
    return launches


def shard_dirs(arrays, root):
    """The 10k vectors in 2 shards of 5,000 with global labels, each with
    the 10k graph cut to its rows, written by the port's `write_index`."""
    from repro_torch.core.index_io import write_index
    from repro_torch.core.shard_math import contiguous_shards
    base, graph, cents, codes = arrays
    asn = contiguous_shards(len(base), 2)
    shards = []
    for s in range(asn.n_shards):
        lo, hi = asn.bounds(s)
        p = os.path.join(root, f"shard{s}")
        write_index(p, vectors=base[lo:hi], graph=cut_graph(graph, lo, hi),
                    centroids=cents, codes=codes[lo:hi], metric="l2",
                    mode="aisaq", labels=np.arange(lo, hi, dtype=np.int64))
        shards.append({"default": p})
    return shards


def phase_cluster(arrays, queries, root):
    """`ShardCluster` with 2 spawned workers on device="cuda" behind a
    `ShardRouter`: 256 queries (k=10, L=256) from 4 router clients, each
    answer bit-identical to `merge_topk` of the two shards' single-process
    searches on the card; then worker 1 SIGKILLed: a partial answer
    without shard 1, and after the respawn (heartbeat 0.1 s, slower
    starts than three missed heartbeats) full coverage bit-identical
    again within 60 s, the shard never quarantined."""
    import signal
    import threading
    from repro_torch.core.index_io import HostIndex
    from repro_torch.core.shard_math import merge_topk
    from repro_torch.serving.cluster import ShardCluster
    from repro_torch.serving.engine import make_host_search_dist_fn
    from repro_torch.serving.router import ShardRouter, SocketShardClient
    shards = shard_dirs(arrays, root)
    k, L = 10, SEARCH_L
    parts = []
    for corpora in shards:
        h = HostIndex.load(corpora["default"], device="cuda")
        fn = make_host_search_dist_fn(h, L=L, w=4)
        parts.append([fn(queries[s:s + 64], k)
                      for s in range(0, len(queries), 64)])
        h.close()
    ids = [np.concatenate([p[0] for p in ps]) for ps in parts]
    dists = [np.concatenate([p[1] for p in ps]) for ps in parts]
    want = [merge_topk([ids[0][i], ids[1][i]], [dists[0][i], dists[1][i]],
                       k) for i in range(len(queries))]
    socks = tempfile.mkdtemp(prefix="socks", dir=root)
    t0 = time.perf_counter()
    cluster = ShardCluster(shards, socket_dir=socks, L=L, w=4,
                           heartbeat_s=0.1, backoff_s=0.2, stable_s=5.0,
                           device="cuda").start(ready_timeout_s=120.0)
    start_s = time.perf_counter() - t0
    routers = [ShardRouter([SocketShardClient(p)
                            for p in cluster.endpoints()],
                           min_shards=1, shard_deadline_s=30.0,
                           endpoints_fn=cluster.endpoints)
               for _ in range(CLUSTER_CLIENTS)]
    try:
        lat, bad, partial = [], [], []

        def client(c):
            for i in range(c, min(CLUSTER_QUERIES, len(queries)),
                           CLUSTER_CLIENTS):
                out = routers[c].search(queries[i], k)
                lat.append(out.latency_s)
                if out.partial:
                    partial.append(i)
                elif not (np.array_equal(out.ids, want[i][0])
                          and np.array_equal(out.dists, want[i][1])):
                    bad.append(i)

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(CLUSTER_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300.0)
        wall = time.perf_counter() - t0
        require(not any(t.is_alive() for t in threads),
                 "router clients did not finish")
        stats = cluster.stats()
        wl = {s: cluster.worker_stats(s)["kernel_launches"]
              for s in range(cluster.n_shards)}
        ready = {s: round(v["ready_s"], 3)
                 for s, v in stats["shards"].items()}
        log("cluster", shards=2, queries=len(lat), clients=CLUSTER_CLIENTS,
            start_s=f"{start_s:.2f}",
            worker_start_s=json.dumps(ready, separators=(",", ":")),
            qps=f"{len(lat) / wall:.2f}", **percentiles_ms(lat),
            partial=len(partial), mismatches=len(bad),
            worker_launches=json.dumps(wl, separators=(",", ":")))
        require(not partial and not bad,
                 f"{len(partial)} partial, {len(bad)} differing answers "
                 f"under full coverage: {bad[:5]}")
        require(all(wl[s]["fused_hop_f32"] > 0 and wl[s]["pq_lut"] > 0
                    for s in wl),
                f"a worker launched no search kernel: {wl}")
        # SIGKILL worker 1: partial answers, then the respawn
        t_kill = time.perf_counter()
        os.kill(cluster.pid(1), signal.SIGKILL)
        saw = None
        while saw is None and time.perf_counter() - t_kill < 30.0:
            out = routers[0].search(queries[0], k)
            if out.partial:
                saw = out
        require(saw is not None and saw.failed_shards == [1],
                f"the kill never degraded coverage: {saw}")
        want0 = merge_topk([ids[0][0]], [dists[0][0]], k)
        require(np.array_equal(saw.ids, want0[0])
                and np.array_equal(saw.dists, want0[1]),
                "the partial answer is not shard 0's own")
        full = None
        while full is None and time.perf_counter() - t_kill < 60.0:
            out = routers[0].search(queries[1], k)
            if not out.partial:
                full = out
            else:
                time.sleep(0.05)
        back_s = time.perf_counter() - t_kill
        st1 = cluster.stats()["shards"][1]
        events = [w for _, s, w in cluster.events if s == 1]
        log("cluster", killed_shard=1, partial_failed=saw.failed_shards,
            full_coverage_after_s=f"{back_s:.2f}",
            respawn_ready_s=st1["ready_s"], restarts=st1["restarts"],
            state=st1["state"], events=json.dumps(events))
        require(full is not None, "full coverage did not come back in 60 s")
        require(np.array_equal(full.ids, want[1][0])
                and np.array_equal(full.dists, want[1][1]),
                "the respawned cluster's answer differs")
        require(st1["state"] == "serving" and st1["restarts"] >= 1
                and not any("quarantined" in w for w in events),
                f"shard 1 after the kill: {st1}, {events}")
        rl = [r.stats() for r in routers]
        log("cluster", router_full=sum(s["full"] for s in rl),
            router_partial=sum(s["partial"] for s in rl),
            router_retries=sum(s["retries"] for s in rl))
    finally:
        for r in routers:
            r.close()
        cluster.stop()


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


# ---------------------------------------------------------------------------
# the sharded device search (paper Fig. 5) on torch.distributed
# ---------------------------------------------------------------------------

SHARDED_WORLD = 4
SHARDED_BATCHES = (64, 256)
SHARDED_WAIT_S = 300      # longest wait for one job's answers
# (grid, query axes, shard axes, shards built): 4 ranks owning one shard
# each with the queries replicated, and 2 query groups x 2 shards
SHARDED_GRIDS = (((1, 4), (), ("model",), 4),
                 ((2, 2), ("data",), ("model",), 2))


def sharded_rank(rank: int, world: int, store: str, inbox, outbox,
                 backend: str, expandable: bool = False) -> None:
    """One rank of the sharded phases, answering jobs from `inbox`
    (`rank_job`) until None: with "gloo" a process on cuda:0 (NCCL refuses
    two ranks on one card), with "nccl" one on card `rank`. Its inputs
    come from files under the run's temporary directory or from the seed;
    only the (B, k) results cross processes, through the all-gather.
    `expandable`: the caching allocator maps its segments in pages, so
    memory a rank frees goes back to the card for the ranks sharing it
    (a freed 10 GB table's segment is otherwise pinned by any small
    tensor placed in it)."""
    if expandable:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=240))
    torch.zeros(1, device="cuda")              # the CUDA context
    outbox.put((rank, {"ready": time.time()}))
    state = {}
    try:
        while True:
            job = inbox.get(timeout=3600)
            if job is None:
                break
            try:
                outbox.put((rank, rank_job(rank, job, state)))
            except BaseException:
                outbox.put((rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def rank_job(rank: int, job: dict, state: dict) -> dict:
    """load: the stacked 10k shards from an npz; load1m: this rank's own
    250k-row shard of the 1M corpus (rows from the npy files, its own
    random R-regular graph from the seed), packed on the card; search:
    one sharded search (warm-up and capture first, then the counted,
    timed call after a barrier), and the same with backend="ref"."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core import sharded_search as ss
    from repro_torch.core.chunk_layout import layout_for
    from repro_torch.core.vamana import random_regular_graph, shard_bounds
    from repro_torch.kernels import _build
    op = job["op"]
    if op.startswith("gnn_"):
        return gnn_rank_job(rank, job, state)
    if op.startswith("dist_"):
        return dist_rank_job(rank, job, state)
    lay = layout_for(cfg)
    grids = state.setdefault("grids", {})
    if op == "load":
        z = np.load(job["npz"])
        state[job["name"]] = ss.ShardedIndexArrays(*(
            torch.from_numpy(z[f]) for f in ss.ShardedIndexArrays._fields))
        state["queries"] = z["queries"]
        return {}
    if op == "load1m":
        t0 = time.perf_counter()
        base = np.load(job["base"], mmap_mode="r")
        codes = np.load(job["codes"], mmap_mode="r")
        b = shard_bounds(base.shape[0], job["n_shards"])
        lo, hi = int(b[rank]), int(b[rank + 1])
        graph = random_regular_graph(hi - lo, cfg.R, seed=rank,
                                     device="cuda")
        state[job["name"]] = ss.stack_shards(
            [(lo, np.ascontiguousarray(base[lo:hi]), graph)],
            np.load(job["cents"]), codes, lay, device="cuda")
        state["queries"] = np.load(job["queries"])
        torch.cuda.synchronize()
        return {"load_s": time.perf_counter() - t0, "rows": hi - lo,
                "table_bytes": state[job["name"]].chunk_words.numel() * 4}
    shape, qaxes, saxes = job["grid"], job["qaxes"], job["saxes"]
    if shape not in grids:
        grids[shape] = ss.ProcessGrid(shape)
    grid = grids[shape]
    place_arrays, place_queries = ss.input_sharding(
        grid, query_axes=qaxes, shard_axes=saxes, device="cuda")
    key = (job["arrays"], shape, qaxes, saxes)
    if key not in state:
        state[key] = place_arrays(state[job["arrays"]])
    arrays = state[key]
    q = place_queries(state["queries"][:job["batch"]])
    torch.cuda.reset_peak_memory_stats()
    out = {"block": grid.index(qaxes), "blocks": grid.size(qaxes)}
    for backend in ("auto", "ref"):
        fkey = key + (job["adc"], backend, job["k"])
        if fkey not in state:
            state[fkey] = ss.sharded_search_fn(
                grid, k=job["k"], L=SEARCH_L, w=cfg.beamwidth,
                max_hops=cfg.max_hops, layout=lay, metric="l2",
                backend=backend, query_axes=qaxes, shard_axes=saxes,
                adc_dtype=job["adc"])
        fn = state[fkey]
        fn(arrays, q)                                  # warm-up, capture
        torch.cuda.synchronize()
        dist.barrier()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        ids, d = fn(arrays, q)
        ids, d = ids.cpu().numpy(), d.cpu().numpy()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        if backend == "auto":
            out.update(ids=ids, d=d, wall_s=wall, launches=launches)
        else:
            out.update(plain_ids=ids, plain_wall_s=wall)
    out.update(rank_breakdown(rank, grid, saxes, arrays, q, job))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def rank_breakdown(rank: int, grid, saxes, arrays, q, job) -> dict:
    """Where a sharded search's wall goes: this rank's local search alone
    on the card (the ranks take turns, each between two barriers) and the
    gather of its (B, k) results with no search beside it."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core import sharded_search as ss
    from repro_torch.core.chunk_layout import layout_for
    from repro_torch.core.device_index import beam_search_device, from_numpy
    idx = from_numpy(arrays.chunk_words[0], arrays.centroids,
                     arrays.ep_ids[0], arrays.ep_codes[0], device="cuda")
    kw = dict(k=job["k"], L=SEARCH_L, w=cfg.beamwidth,
              max_hops=cfg.max_hops, layout=layout_for(cfg), metric="l2",
              adc_dtype=job["adc"])
    ids, d, _ = beam_search_device(idx, q, **kw)          # warm-up, capture
    torch.cuda.synchronize()
    alone = None
    for turn in range(grid.world):
        dist.barrier()
        if turn == rank:
            t0 = time.perf_counter()
            beam_search_device(idx, q, **kw)[0].cpu()
            alone = time.perf_counter() - t0
    group, members = grid.group(saxes)
    dist.barrier()
    t0 = time.perf_counter()
    ss.all_gather(ids, group, members).cpu()
    ss.all_gather(d, group, members).cpu()
    return {"alone_s": alone, "gather_s": time.perf_counter() - t0}


class RankWorld:
    """`n` spawned `sharded_rank` processes in one world of `backend`
    (FileStore in the run's temporary directory): gloo ranks share cuda:0,
    NCCL ranks take a card each. `run(job)` sends the job to every rank
    and returns their answers by rank; every wait and every join has a
    time limit, and `close` stops every process. With `wait=False` the
    ranks start in the background and `ready()` waits for them."""

    def __init__(self, n: int, root: str, name: str, backend: str = "gloo",
                 expandable: bool = False, wait: bool = True):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.n = n
        self.inboxes = [ctx.Queue() for _ in range(n)]
        self.outbox = ctx.Queue()
        store = os.path.join(root, f"store_{name}")
        t0 = time.time()
        self.procs = [ctx.Process(target=sharded_rank, daemon=True,
                                  args=(r, n, store, self.inboxes[r],
                                        self.outbox, backend, expandable))
                      for r in range(n)]
        for p in self.procs:
            p.start()
        self.t0, self.start_s = t0, None
        if wait:
            self.ready()

    def ready(self) -> None:
        """Wait until every rank has its CUDA context (`start_s`: seconds
        from the spawn to the last rank's readiness)."""
        if self.start_s is not None:
            return
        try:
            ready = self._collect("start", 240)
        except BaseException:
            self.close()
            raise
        self.start_s = max(v["ready"] for v in ready.values()) - self.t0

    def _collect(self, what: str, timeout: float) -> dict:
        import queue
        got, t_end = {}, time.time() + timeout
        while len(got) < self.n:
            try:
                rank, ans = self.outbox.get(
                    timeout=max(1.0, t_end - time.time()))
            except queue.Empty:
                raise AssertionError(f"sharded {what}: only ranks "
                                     f"{sorted(got)} answered") from None
            require(not isinstance(ans, str), f"rank {rank}, {what}: {ans}")
            got[rank] = ans
        return got

    def run(self, job: dict, timeout: float = SHARDED_WAIT_S) -> dict:
        for box in self.inboxes:
            box.put(job)
        return self._collect(job["op"], timeout)

    def close(self) -> None:
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def gathered(answers: dict, key: str = "ids") -> np.ndarray:
    """The (B, k) answer of a sharded search: each query block once, in
    block order, after checking that every rank of a block agrees."""
    blocks = {}
    for a in answers.values():
        if a["block"] in blocks:
            require(np.array_equal(blocks[a["block"]], a[key]),
                    f"ranks of block {a['block']} disagree on {key}")
        blocks[a["block"]] = a[key]
    return np.concatenate([blocks[b] for b in sorted(blocks)])


def shard_indexes(arrays):
    """A DeviceIndex of each stacked shard, on the card."""
    from repro_torch.core.device_index import from_numpy
    return [(from_numpy(arrays.chunk_words[s], arrays.centroids,
                        arrays.ep_ids[s], arrays.ep_codes[s], device="cuda"),
             arrays.offsets[s]) for s in range(arrays.chunk_words.shape[0])]


def one_process_merge(indexes, q, k: int, adc: str):
    """The same shards searched one after another in this process on the
    card (their ids made global), then merged by the stable-sort merge."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.chunk_layout import layout_for
    from repro_torch.core.device_index import beam_search_device
    from repro_torch.core.sharded_search import merge_shards
    all_ids, all_d = [], []
    for idx, offset in indexes:
        ids, d, _ = beam_search_device(
            idx, q, k=k, L=SEARCH_L, w=cfg.beamwidth, max_hops=cfg.max_hops,
            layout=layout_for(cfg), metric="l2", adc_dtype=adc)
        valid = ids >= 0
        all_ids.append(torch.where(valid, ids + offset, -1).to(torch.int32))
        all_d.append(torch.where(valid, d, torch.inf))
    ids, _ = merge_shards(torch.stack(all_ids), torch.stack(all_d), k)
    return ids.cpu().numpy()


def unsharded_search_ms(idx, lay, queries, k: int, adc: str = "f32") -> dict:
    """Wall ms of one warm beam_search_device call at each sharded batch
    (the graph captured by a first call)."""
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.device_index import beam_search_device
    out = {}
    for nq in SHARDED_BATCHES:
        q = torch.from_numpy(queries[:nq]).cuda()
        kw = dict(k=k, L=SEARCH_L, w=cfg.beamwidth, max_hops=cfg.max_hops,
                  layout=lay, metric="l2", adc_dtype=adc)
        beam_search_device(idx, q, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beam_search_device(idx, q, **kw)[0].cpu()
        out[nq] = (time.perf_counter() - t0) * 1e3
    return out


def add_launches(total: dict, answers: dict) -> None:
    """Add every rank's counted launches into `total`."""
    for a in answers.values():
        for name, n in a["launches"].items():
            total[name] = total.get(name, 0) + n


def compact(obj) -> str:
    return json.dumps(obj, separators=(",", ":"))


def phase_sharded(arrays, queries, gt, root):
    """[sharded]: the main path's 10k vectors and PQ codebooks, split by
    `build_sharded` (the main path's one-pass Vamana, L=64) into 4 shards
    of 2,500 and into 2 of 5,000, the builds side by side in spawned
    processes; `stack_shards` on the card; 4 gloo ranks on cuda:0 search
    them on grid (1, 4) (queries replicated) and (2, 2) (2 query groups x
    2 shards), batches 64 and 256, L=256, k=10, f32 and int8. Checks:
    recall@10 >= 0.8, the int8 gap <= 0.01, ids equal to the one-process
    merge, top-10 agreement with the plain path >= 0.99. Returns the
    launches of every rank's timed searches, summed."""
    import threading
    import torch
    from repro_torch.configs import SIFT1M as cfg
    from repro_torch.core.chunk_layout import layout_for
    from repro_torch.core.device_index import from_arrays
    from repro_torch.core.pq import recall_at
    from repro_torch.core.sharded_search import stack_shards
    from repro_torch.core.vamana import build_sharded
    base, graph, cents, codes = arrays
    kw = dict(R=cfg.R, L=64, alpha=cfg.alpha, two_pass=False, seed=0)
    builds, t0 = {}, time.perf_counter()

    def build(n_shards):
        builds[n_shards] = build_sharded(base, n_shards, processes=n_shards,
                                         **kw)
    threads = [threading.Thread(target=build, args=(s,), daemon=True)
               for s in (4, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    build_s = time.perf_counter() - t0
    require(set(builds) == {4, 2}, "a sharded build did not finish")
    lay = layout_for(cfg)
    stacked, t0 = {}, time.perf_counter()
    for s, shards in builds.items():
        stacked[s] = stack_shards(shards, cents, codes, lay, device="cuda")
        np.savez(os.path.join(root, f"sharded{s}.npz"), queries=queries,
                 **{f: getattr(stacked[s], f).cpu().numpy()
                    for f in stacked[s]._fields})
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    log("sharded", n=len(base), builds="4x2500,2x5000",
        build_s=f"{build_s:.1f}", stack_s=f"{stack_s:.2f}",
        table_bytes=compact({s: a.chunk_words.numel() * 4
                             for s, a in stacked.items()}))
    idx, ulay = from_arrays(base, graph, cents, codes, device="cuda")
    unsharded = unsharded_search_ms(idx, ulay, queries, 10)
    del idx
    indexes = {s: shard_indexes(a) for s, a in stacked.items()}
    one = {(s, adc, nq): one_process_merge(
        indexes[s], torch.from_numpy(queries[:nq]).cuda(), 10, adc)
        for s in (4, 2) for adc in ("f32", "int8")
        for nq in SHARDED_BATCHES}
    del stacked, indexes
    torch.cuda.empty_cache()
    world = RankWorld(SHARDED_WORLD, root, "sharded")
    launches, rec = {}, {}
    try:
        for s in (4, 2):
            world.run({"op": "load", "name": f"s{s}",
                       "npz": os.path.join(root, f"sharded{s}.npz")})
        for shape, qaxes, saxes, s in SHARDED_GRIDS:
            for nq in SHARDED_BATCHES:
                for adc in ("f32", "int8"):
                    ans = world.run({"op": "search", "arrays": f"s{s}",
                                     "grid": shape, "qaxes": qaxes,
                                     "saxes": saxes, "batch": nq,
                                     "adc": adc, "k": 10})
                    ids = gathered(ans)
                    plain = gathered(ans, "plain_ids")
                    rec[shape, nq, adc] = recall_at(ids, gt[:nq], 10)
                    agree = float(np.mean([len(set(a) & set(b)) / 10.0
                                           for a, b in zip(ids, plain)]))
                    same = bool(np.array_equal(ids, one[s, adc, nq]))
                    wall = max(a["wall_s"] for a in ans.values())
                    plain_wall = max(a["plain_wall_s"] for a in ans.values())
                    alone = [a["alone_s"] * 1e3 for _, a in sorted(ans.items())]
                    per_rank = {r: {k: a["launches"].get(k, 0) for k in
                                    ("fused_hop_f32", "fused_hop_int8",
                                     "pq_lut")}
                                for r, a in sorted(ans.items())}
                    add_launches(launches, ans)
                    log("sharded", grid="x".join(map(str, shape)),
                        query_axes="+".join(qaxes) or "replicated",
                        shards=s, batch=nq, adc=adc,
                        recall10=rec[shape, nq, adc],
                        equal_to_one_process_merge=same,
                        plain_agreement=agree,
                        wall_ms=f"{wall * 1e3:.3f}", qps=f"{nq / wall:.1f}",
                        unsharded_f32_ms=f"{unsharded[nq]:.3f}",
                        unsharded_f32_qps=f"{nq / unsharded[nq] * 1e3:.1f}",
                        plain_wall_ms=f"{plain_wall * 1e3:.3f}",
                        rank_alone_ms=compact([round(t, 3) for t in alone]),
                        alone_sum_ms=f"{sum(alone):.3f}",
                        gather_ms=f"{max(a['gather_s'] for a in ans.values()) * 1e3:.3f}",
                        rank_launches=compact(per_rank),
                        rank_peak_bytes=compact(
                            {r: a["peak_bytes"]
                             for r, a in sorted(ans.items())}))
                    require(same, f"grid {shape} {adc} batch {nq}: ids "
                            "differ from the one-process merge")
                    require(agree >= 0.99, f"grid {shape} {adc} batch {nq}:"
                            f" agreement with the plain path {agree}")
                    kernel = ("fused_hop_f32" if adc == "f32"
                              else "fused_hop_int8")
                    require(all(a["launches"].get(kernel, 0) > 0
                                and a["launches"].get("pq_lut", 0) > 0
                                for a in ans.values()),
                            f"a rank launched no {kernel} or pq_lut: "
                            f"{per_rank}")
        for key, r in rec.items():
            require(r >= 0.8, f"sharded recall@10 {r} < 0.8 at {key}")
            if key[2] == "f32":
                gap = abs(r - rec[key[0], key[1], "int8"])
                require(gap <= 0.01, f"sharded int8 gap {gap} at {key}")
        log("sharded", world=SHARDED_WORLD, backend="gloo",
            device="cuda:0 shared", world_start_s=f"{world.start_s:.2f}",
            launches=compact(launches))
    finally:
        world.close()
    return launches


def save_1m(arrays_1m, queries_1m, root) -> dict:
    """The 1M corpus's rows, codes and centroids and its queries, as npy
    files the sharded ranks read their rows from."""
    base, _, cents, codes = arrays_1m
    paths = {k: os.path.join(root, f"one_m_{k}.npy")
             for k in ("base", "codes", "cents", "queries")}
    for k, a in (("base", base), ("codes", codes), ("cents", cents),
                 ("queries", queries_1m)):
        np.save(paths[k], np.asarray(a))
    return paths


def phase_sharded1m(paths, searches_1m, root):
    """[sharded1m]: the 1M corpus of the deployment phase as 4 shards of
    250,000 rows (1.98 GB of chunk rows each), one a rank on cuda:0, each
    over its own random R-regular graph (recall is not judged, as at 1M);
    grid (1, 4), queries replicated, f32, k=100 (the deployment search's
    k), batches 64 and 256: wall and QPS beside the unsharded search of
    the same run. Returns the timed searches' launches, summed."""
    world = RankWorld(SHARDED_WORLD, root, "sharded1m")
    launches = {}
    try:
        loaded = world.run({"op": "load1m", "name": "s1m", "n_shards": 4,
                            **paths}, timeout=600)
        log("sharded1m", world=SHARDED_WORLD,
            world_start_s=f"{world.start_s:.2f}",
            rank_rows=compact({r: a["rows"] for r, a in loaded.items()}),
            rank_table_bytes=compact({r: a["table_bytes"]
                                      for r, a in loaded.items()}),
            load_s=f"{max(a['load_s'] for a in loaded.values()):.2f}")
        for nq in SHARDED_BATCHES:
            ans = world.run({"op": "search", "arrays": "s1m",
                             "grid": (1, 4), "qaxes": (),
                             "saxes": ("model",), "batch": nq, "adc": "f32",
                             "k": RERANK}, timeout=600)
            ids = gathered(ans)
            plain = gathered(ans, "plain_ids")
            agree = float(np.mean([len(set(a) & set(b)) / RERANK
                                   for a, b in zip(ids, plain)]))
            wall = max(a["wall_s"] for a in ans.values())
            unsharded = searches_1m["f32", nq]["wall_ms"]
            add_launches(launches, ans)
            alone = [a["alone_s"] * 1e3 for _, a in sorted(ans.items())]
            log("sharded1m", grid="1x4", shards=4, batch=nq, adc="f32",
                k=RERANK, wall_ms=f"{wall * 1e3:.3f}",
                rank_alone_ms=compact([round(t, 3) for t in alone]),
                alone_sum_ms=f"{sum(alone):.3f}",
                gather_ms=f"{max(a['gather_s'] for a in ans.values()) * 1e3:.3f}",
                qps=f"{nq / wall:.1f}", unsharded_ms=f"{unsharded:.3f}",
                unsharded_qps=f"{nq / unsharded * 1e3:.1f}",
                plain_agreement=agree,
                rank_launches=compact({r: a["launches"]
                                       for r, a in sorted(ans.items())}),
                rank_peak_bytes=compact({r: a["peak_bytes"]
                                         for r, a in sorted(ans.items())}))
            require(ids.shape == (nq, RERANK) and (ids >= 0).all()
                    and (ids < 1_000_000).all(), "sharded 1M ids")
            require(agree >= 0.99, f"sharded 1M agreement {agree}")
            require(all(a["launches"].get("fused_hop_f32", 0) > 0
                        for a in ans.values()),
                    "a 1M rank launched no fused_hop_f32")
    finally:
        world.close()
    return launches


# ---------------------------------------------------------------------------
# the recommender towers at their published cardinalities
# ---------------------------------------------------------------------------


def tower_batch(cfg, n: int, seed: int, device):
    """n rows of CTR inputs drawn on `device`: dense N(0, 1) features and
    each field's ids uniform over its published vocabulary."""
    import torch
    g = torch.Generator(device).manual_seed(seed)
    sparse = torch.stack([torch.randint(0, v, (n, cfg.multi_hot),
                                        generator=g, device=device)
                          for v in cfg.vocab_sizes], dim=1)
    out = {"sparse": sparse}
    if cfg.n_dense:
        out["dense"] = torch.randn((n, cfg.n_dense), generator=g,
                                   device=device)
    return out


def ctr_bytes_ops(cfg, n: int):
    """Bytes (each looked-up embedding row and wide weight read once, the
    dense features read, the logits written) and operations (two a
    multiply-add of every matrix product, DLRM's pairwise dots included)
    of n rows of the CTR forward."""
    D, F, hot = cfg.embed_dim, cfg.n_sparse, cfg.multi_hot

    def mlp(dims):
        return sum(a * b for a, b in zip(dims, dims[1:]))
    nbytes = n * 4 * (F * hot * D + cfg.n_dense + 1)
    if cfg.kind == "dlrm":
        f = F + 1
        macs = (mlp((cfg.n_dense,) + cfg.bot_mlp) + f * f * D
                + mlp((f * (f - 1) // 2 + cfg.bot_mlp[-1],) + cfg.top_mlp))
    elif cfg.kind == "dcnv2":
        d0 = cfg.n_dense + F * D
        macs = cfg.n_cross_layers * d0 * d0 + mlp((d0,) + cfg.mlp + (1,))
    else:
        nbytes += n * 4 * F * hot                      # the wide weights
        macs = mlp((F * D,) + cfg.mlp + (1,))
    return nbytes, 2 * macs * n


def ctr_times(p, cfg, batch, reps: int):
    """Latencies (s) of `reps` CTR forwards after a first call, and the
    logits of the first and the last."""
    import torch
    from repro_torch.models import recsys
    first = recsys.rec_forward(p, batch, cfg)
    torch.cuda.synchronize()
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        last = recsys.rec_forward(p, batch, cfg)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return np.array(lat), first, last


def phase_recsys_towers(n_requests: int = 64, k: int = 100,
                        rerank_mult: int = 4):
    """[recsys_towers]: DLRM-rm2, DCN-v2 and Wide&Deep, one at a time, at
    their published cardinalities on the card (random parameters from a
    seeded generator): the CTR forward at serve_p99 (512) and serve_bulk
    (262,144) — p50/p99, finite logits, two calls bit-equal — and
    retrieval_cand: one user against the first rows of table 0, projected
    (1M, or all of table 0 where it holds fewer: Wide&Deep's has 1,000),
    PQ trained and encoded on the card at TOWER_PQ_M, n_requests requests
    through make_retrieval_fn (one graph a request) and the eager
    retrieval_topk_pq: p50/p99, graph vs eager answers equal, kernel vs
    plain top-k agreement >= 0.99. Returns the graph requests' launches,
    summed over the towers."""
    import torch
    from repro_torch.configs import (DCN_V2, DLRM_RM2, RETRIEVAL_CAND,
                                     SERVE_BULK, SERVE_P99, WIDE_DEEP)
    from repro_torch.core.pq import encode, train_codebooks
    from repro_torch.kernels import _build, ops
    from repro_torch.models import recsys
    dev = torch.device("cuda")
    total = {}
    for cfg in (DLRM_RM2, DCN_V2, WIDE_DEEP):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        p = recsys.init_recsys(cfg, generator=torch.Generator(dev)
                               .manual_seed(0), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() - base_bytes
        rows = sum(recsys.padded_vocab(v) for v in cfg.vocab_sizes)
        table_bytes = sum(t.numel() * 4 for t in p.tables) + sum(
            t.numel() * 4 for t in getattr(p, "wide", []))
        require(all(t.shape[0] == recsys.padded_vocab(v)
                    for t, v in zip(p.tables, cfg.vocab_sizes)),
                f"{cfg.name}: a table is not at its published size")
        ctr = {}
        for shape, reps in ((SERVE_P99, 50), (SERVE_BULK, 10)):
            batch = tower_batch(cfg, shape.batch, 1, dev)
            lat, a, b = ctr_times(p, cfg, batch, reps)
            require(a.shape == (shape.batch,)
                    and bool(torch.isfinite(a).all()),
                    f"{cfg.name} {shape.name}: logits not finite")
            require(torch.equal(a, b), f"{cfg.name} {shape.name}: two "
                    "calls gave different logits")
            ctr[shape.name] = percentiles_ms(lat)
            b_ms, by = bound_ms(*ctr_bytes_ops(cfg, shape.batch))
            ctr[shape.name].update(bound_ms=f"{b_ms:.4f}", bound_by=by)
            del batch, a, b
        n = min(RETRIEVAL_CAND.n_candidates, cfg.vocab_sizes[0])
        m = TOWER_PQ_M[cfg.kind]
        t0 = time.perf_counter()
        cand = recsys.item_vectors(p, torch.arange(n, device=dev))
        init = np.random.default_rng(0).choice(n, 256, replace=False)
        cents = train_codebooks(cand, m=m, init_idx=init, ks=256,
                                iters=RECSYS_PQ_ITERS, device=dev)
        codes = encode(cents, cand, device=dev)
        torch.cuda.synchronize()
        pq_s = time.perf_counter() - t0
        rng = np.random.default_rng(2)
        reqs = []
        for _ in range(n_requests):
            r = {"sparse": np.stack([rng.integers(0, v, (1, cfg.multi_hot))
                                     for v in cfg.vocab_sizes], axis=1)}
            if cfg.n_dense:
                r["dense"] = rng.normal(size=(1, cfg.n_dense)).astype(
                    np.float32)
            reqs.append(r)
        graphed = recsys.make_retrieval_fn(p, cfg, codes, cents, k=k,
                                           rerank_mult=rerank_mult)

        def eager(r, backend="auto"):
            return recsys.retrieval_topk_pq(p, r, cfg, codes, cents, k=k,
                                            rerank_mult=rerank_mult,
                                            backend=backend)

        def requests(fn):
            lat, ids = [], []
            for r in reqs:
                t0 = time.perf_counter()
                i = fn(r)[0].cpu().numpy()
                lat.append(time.perf_counter() - t0)
                ids.append(i[0])
            return np.array(lat), np.stack(ids)

        t0 = time.perf_counter()
        graphed(reqs[0])                       # warm-up and capture
        capture_s = time.perf_counter() - t0
        eager(reqs[0])
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        lat, ids = requests(graphed)
        launches = dict(_build.launch_counts)
        eager_lat, eager_ids = requests(eager)
        _, plain_ids = requests(lambda r: eager(r, "ref"))
        graph_agree = float(np.mean([len(set(a) & set(b)) / k
                                     for a, b in zip(ids, eager_ids)]))
        agree = float(np.mean([len(set(a) & set(b)) / k
                               for a, b in zip(ids, plain_ids)]))
        users = torch.cat([recsys.user_tower(p, r, cfg) for r in reqs[:8]])
        lut = ops.build_lut(users, cents, metric="mips")
        err_lut = close_err(lut, ops.build_lut(users, cents, metric="mips",
                                               backend="ref"))
        err_adc = max(adc_err(ops.adc(l[None], codes),
                              ops.adc(l[None], codes, backend="ref"))
                      for l in lut)
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c
        log("recsys_towers", model=cfg.name, kind=cfg.kind,
            embed_dim=cfg.embed_dim, fields=cfg.n_sparse,
            multi_hot=cfg.multi_hot, table_rows=rows,
            table_bytes=table_bytes, init_s=f"{init_s:.2f}",
            init_peak_bytes=init_peak,
            **{f"{shape}_{key}": v for shape, c in ctr.items()
               for key, v in c.items()},
            logits_finite=True, logits_bit_equal=True)
        log("recsys_towers", model=cfg.name, shape="retrieval_cand",
            candidates=n, pq_m=m, dsub=cfg.embed_dim // m,
            pq_s=f"{pq_s:.2f}", requests=n_requests,
            capture_s=f"{capture_s:.3f}", **percentiles_ms(lat),
            eager_p50_ms=f"{np.percentile(eager_lat * 1e3, 50):.3f}",
            eager_p99_ms=f"{np.percentile(eager_lat * 1e3, 99):.3f}",
            graph_eager_agreement=graph_agree, plain_agreement=agree,
            pq_lut_err=err_lut, pq_adc_err=err_adc,
            launches=compact(launches),
            peak_device_bytes=torch.cuda.max_memory_allocated()
            - base_bytes)
        require(launches.get("pq_lut") == n_requests
                and launches.get("pq_adc") == n_requests,
                f"{cfg.name}: expected {n_requests} pq_lut and pq_adc "
                f"launches: {launches}")
        require(graph_agree == 1.0 and np.array_equal(ids, eager_ids),
                f"{cfg.name}: graph and eager answers differ")
        require(agree >= 0.99, f"{cfg.name}: top-{k} agreement with the "
                f"plain path {agree}")
        del p, cand, cents, codes, graphed, users, lut
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# training the recommender towers
# ---------------------------------------------------------------------------


# parameters after a train step, port against reference on the CPU
# (tests/test_torch_train.py); held here card against CPU
TOL_TRAIN_PARAMS = 1e-4
# losses of 25 tiny steps, card against CPU from one state
TOL_TRAIN_LOSS = 1e-3
TRAIN_ARCHS = ("dlrm-rm2", "dcn-v2", "wide-deep", "sasrec")


def train_matmul_ops(cfg, n: int) -> float:
    """Operations of one training step's float32 matrix products on n
    rows: 3x the forward's (forward, and two products a layer backward).
    The CTR kinds' forward as `ctr_bytes_ops` reckons it; SASRec's per
    sequence and block: q, k, v and the two feed-forward layers (5 S D^2),
    scores and the weighted sum (2 S^2 D), then the positive and negative
    dots (2 S D)."""
    if cfg.kind == "sasrec":
        S, D = cfg.seq_len, cfg.embed_dim
        macs = cfg.n_blocks * (5 * S * D * D + 2 * S * S * D) + 2 * S * D
        return 3 * 2 * macs * n
    return 3 * ctr_bytes_ops(cfg, n)[1]


def max_param_diff(a, b) -> float:
    from repro_torch.optim.adamw import param_tree
    ta, tb = param_tree(a.params), param_tree(b.params)
    return max(float((x.detach().cpu() - tb[n].detach().cpu()).abs().max())
               for n, x in ta.items())


def train_parity():
    """Tiny SASRec and DCN-v2: 3 steps on the card and on the CPU from one
    state (drawn on the CPU); the largest parameter difference after each
    step within TOL_TRAIN_PARAMS."""
    import torch
    from repro_torch.distributed.train_step import state_to
    from repro_torch.launch import train
    for aid in ("sasrec", "dcn-v2"):
        _, init, cpu_step, data = train.build_trainer(
            aid, "train_batch", steps=3, device="cpu")
        _, _, card_step, _ = train.build_trainer(aid, "train_batch",
                                                 steps=3, device="cuda")
        cpu = init(torch.Generator().manual_seed(0))
        card = state_to(cpu, "cuda")
        diffs, losses = [], []
        for step in range(3):
            b = data(step)
            cpu, mc = cpu_step(cpu, b)
            card, mg = card_step(card, b)
            diffs.append(max_param_diff(cpu, card))
            losses.append((float(mc["loss"]), float(mg["loss"])))
        log("train", check="parity", arch=aid, steps=3,
            max_param_diff=compact([f"{d:.3e}" for d in diffs]),
            tol=TOL_TRAIN_PARAMS, loss_cpu_card=compact(losses))
        require(max(diffs) <= TOL_TRAIN_PARAMS,
                f"{aid}: card and CPU parameters differ by {max(diffs)}")


def train_loss_curve():
    """Tiny DCN-v2, 25 steps at lr 1e-2 from the CPU's seed-0 state, on
    the card and on the CPU: the card's last loss below its first (the bar
    of tests/test_system.py), the mean of its last 5 below its first too,
    and each of its losses within TOL_TRAIN_LOSS of the CPU's."""
    import torch
    from repro_torch.distributed.train_step import state_to
    from repro_torch.launch import train
    kw = dict(steps=25, lr=1e-2, verbose=False)
    _, init, _, _ = train.build_trainer("dcn-v2", "train_batch",
                                        steps=25, lr=1e-2, device="cpu")
    cpu_state = init(torch.Generator().manual_seed(0))
    card = train.train_loop("dcn-v2", "train_batch", device="cuda",
                            init_state=state_to(cpu_state, "cuda"),
                            **kw)["losses"]
    cpu = train.train_loop("dcn-v2", "train_batch", device="cpu",
                           init_state=cpu_state, **kw)["losses"]
    diff = max(abs(a - b) for a, b in zip(card, cpu))
    last5 = float(np.mean(card[-5:]))
    log("train", check="loss_curve", arch="dcn-v2", steps=25, lr=1e-2,
        first=f"{card[0]:.5f}", last=f"{card[-1]:.5f}",
        mean_last5=f"{last5:.5f}", cpu_last=f"{cpu[-1]:.5f}",
        max_loss_diff_vs_cpu=f"{diff:.3e}", tol=TOL_TRAIN_LOSS,
        losses=compact([f"{x:.4f}" for x in card]))
    require(card[-1] < card[0], "dcn-v2: the loss did not fall")
    require(last5 < card[0], "dcn-v2: the last 5 losses average above "
            "the first")
    require(diff <= TOL_TRAIN_LOSS,
            f"dcn-v2: the card's losses differ from the CPU's by {diff}")


def train_full_width(aid: str, steps: int = 5) -> dict:
    """One arch at its published cardinalities and train_batch (65,536
    rows): init, `steps` steps through `build_trainer`'s step; init
    seconds, step p50/p99 after the first, peak device bytes against the
    parameter and optimizer bytes, rows touched a step, losses, the bound
    of a step's float32 matrix products."""
    import gc

    import torch
    from repro_torch.device import to_tensor
    from repro_torch.launch import train
    from repro_torch.optim.adamw import param_tree
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    arch, init, step_fn, data = train.build_trainer(
        aid, "train_batch", scale="full", steps=steps, device=dev)
    cfg = arch.model
    t0 = time.perf_counter()
    state = init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = param_tree(state.params)
    param_bytes = sum(t.numel() * t.element_size() for t in params.values())
    opt_bytes = sum(t.numel() * t.element_size()
                    for d in (state.opt.m, state.opt.v, state.opt.master)
                    for t in d.values())
    table_bytes = [t.numel() * t.element_size() for n, t in params.items()
                   if n.startswith("tables/")]
    lat, losses, rows = [], [], []
    for step in range(steps):
        batch = {k: to_tensor(v, dev) for k, v in data(step).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        rows.append(m["rows_touched"])
        del batch
    peak = torch.cuda.max_memory_allocated() - base
    total = torch.cuda.get_device_properties(0).total_memory
    n = len(next(iter(data(0).values())))
    b_ms = train_matmul_ops(cfg, n) / FP32_OPS_PER_S * 1e3
    out = dict(arch=aid, batch=n, table_rows=sum(
        t.shape[0] for n, t in params.items() if n.startswith("tables/")),
        param_bytes=param_bytes, opt_bytes=opt_bytes,
        init_s=f"{init_s:.2f}", first_step_ms=f"{lat[0] * 1e3:.3f}",
        **{f"step_{k}": v for k, v in percentiles_ms(lat[1:]).items()},
        step_bound_ms=f"{b_ms:.3f}", bound_by="operations",
        peak_device_bytes=peak,
        peak_above_params_and_opt=peak - param_bytes - opt_bytes,
        rows_touched=compact(rows),
        losses=compact([f"{x:.5f}" for x in losses]))
    log("train", check="full_width", **out)
    require(all(np.isfinite(losses)), f"{aid}: a loss is not finite")
    require(peak < total, f"{aid}: peak {peak} above the card's {total}")
    if aid == "dlrm-rm2":
        # a dense gradient of the largest table alone would add its bytes
        require(peak - param_bytes - opt_bytes < max(table_bytes),
                f"{aid}: {peak - param_bytes - opt_bytes} bytes above the "
                "parameters and optimizer state: a dense table gradient?")
    del state, params, step_fn, init, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_restart(root: str):
    """Tiny SASRec on the card: 10 steps with a checkpoint every 4 and a
    WorkerFailure injected at step 6, resumed from step 4 by
    `run_with_restarts`; the final parameters and optimizer state
    bit-equal to an uninterrupted run's."""
    import torch
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.distributed.fault_tolerance import run_with_restarts
    from repro_torch.launch import train
    kw = dict(steps=10, ckpt_every=4, verbose=False, device="cuda")
    whole = train.train_loop("sasrec", "train_batch", **kw)
    ckpt_dir = os.path.join(root, "train_restart")
    resumed = []

    def segment(resume_step):
        resumed.append(resume_step)
        hist = train.train_loop("sasrec", "train_batch", ckpt_dir=ckpt_dir,
                                fail_at_step=6 if len(resumed) == 1
                                else None, **kw)
        segment.hist = hist
        return hist["final_step"]

    final = run_with_restarts(segment, max_restarts=1)
    a, b = _flatten(whole["state"]), _flatten(segment.hist["state"])
    equal = list(a) == list(b) and all(torch.equal(a[n], b[n]) for n in a)
    log("train", check="restart", arch="sasrec", steps=10, ckpt_every=4,
        failed_at=6, restarts=len(resumed) - 1,
        resumed_losses=len(segment.hist["losses"]), final_step=final,
        leaves=len(a), bit_equal=equal)
    require(final == 10 and resumed == [None, 6]
            and len(segment.hist["losses"]) == 6,
            f"restart: resumed {resumed}, final step {final}")
    require(segment.hist["losses"] == whole["losses"][4:],
            "restart: the resumed losses differ")
    require(equal, "restart: final state not bit-equal to the "
            "uninterrupted run's")


def phase_train(root: str):
    """[train]: the recommender trainer on the card
    (`repro_torch.launch.train`): card vs CPU parity, tiny DCN-v2's loss
    falling over 25 steps at lr 1e-2, each arch at full width, and the
    restart. The training path launches none of the port's kernels."""
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    _build.reset_launch_counts()
    train_parity()
    train_loss_curve()
    full = [train_full_width(aid) for aid in TRAIN_ARCHS]
    train_restart(root)
    launches = sum(_build.launch_counts.values())
    log("train", kernel_launches=launches)
    require(launches == 0, "the training path launched a port kernel")
    return full


# ---------------------------------------------------------------------------
# the language models (`repro_torch.models.{layers,moe,transformer}`)
# ---------------------------------------------------------------------------

LM_ARCHS = ("qwen3-1.7b", "h2o-danube-1.8b", "qwen2-1.5b",
            "qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
BF16_OPS_PER_S = 989e12         # bfloat16 tensor cores, dense
TOL_LM_PARITY = 1e-4            # card vs CPU: logits, loss, gradients
TOL_FLASH_FWD = 1e-5            # flash attention card vs CPU, forward
TOL_FLASH_GRAD = 1e-4           # and its gradients
TOL_DECODE_PREFILL = 2e-3       # tests/test_models_lm.py's bar
SCOUT_LAYERS = 8                # of 48: 215.5 GB does not fit in 80 GB


def reduced_lm(cfg):
    """tests/test_smoke_archs.py's `reduced_lm`: every structural feature
    kept (GQA ratio, qk-norm, QKV bias, windows, shared + routed experts),
    MoE cut to 8 experts, Scout to 4 layers (layer 3 global)."""
    import dataclasses
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=min(8, moe.n_experts),
                                  d_expert=64,
                                  d_shared=64 if moe.d_shared else 0)
    return cfg.scaled(n_layers=4 if cfg.attention == "chunked_global" else 2,
                      d_model=64, n_heads=max(2, cfg.n_heads // 8),
                      n_kv_heads=max(1, cfg.n_kv_heads // 8), head_dim=16,
                      d_ff=96, vocab_size=512,
                      window=min(cfg.window, 32) if cfg.window else 0,
                      moe=moe, dtype="float32")


def max_diff(a, b) -> float:
    return float((a.detach().float().cpu() - b.detach().float().cpu())
                 .abs().max())


def lm_model_parity(aid: str, card: str) -> dict:
    """One arch at `reduced_lm` scale, float32: the same parameters (drawn
    on the CPU) on the CPU and the card; prefill logits, 9 decode steps'
    logits, the loss and every gradient."""
    import copy

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import param_tree
    cfg = reduced_lm(get_arch(aid).model)
    cpu = T.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    errs = {"prefill": max_diff(T.lm_prefill(cpu, toks, cfg),
                                T.lm_prefill(gpu, toks, cfg))}
    cc = T.init_cache(cfg, 2, 16, device="cpu")
    cg = T.init_cache(cfg, 2, 16, device="cuda")
    dec = 0.0
    for t in range(9):
        lc, cc = T.lm_decode_step(cpu, cc, toks[:, t], t, cfg)
        lg, cg = T.lm_decode_step(gpu, cg, toks[:, t], t, cfg)
        dec = max(dec, max_diff(lc, lg))
    errs["decode"] = dec
    grads = []
    for p in (cpu, gpu):
        loss, _ = T.lm_loss(p, batch, cfg)
        tree = param_tree(p)
        gs = torch.autograd.grad(loss, list(tree.values()))
        grads.append((loss, dict(zip(tree, gs))))
    errs["loss"] = max_diff(grads[0][0], grads[1][0])
    errs["grads"] = max(max_diff(g, grads[1][1][n])
                        for n, g in grads[0][1].items())
    out = dict(arch=aid, layers=cfg.n_layers, leaves=len(grads[0][1]),
               **{f"{k}_err": f"{v:.3e}" for k, v in errs.items()},
               tol=TOL_LM_PARITY, card=json.dumps(card))
    log("lm_parity", **out)
    require(max(errs.values()) <= TOL_LM_PARITY,
            f"{aid}: card and CPU differ by {errs}")
    return errs


def flash_parity(card: str) -> float:
    """flash_attention and flash_attention_vjp on the card against their
    CPU runs: full, sliding (window 100) and chunked (chunk 128) masks,
    Sq = 300 (a partial last q block), 64/128 and 128/64 blocks, q
    offsets 0 and 37 (keys then the 337 positions before and of the
    queries), GQA 8 query heads over 2 KV heads."""
    import torch
    from repro_torch.models import layers as L
    worst = 0.0
    rng = np.random.default_rng(2)
    for name, window, chunked in (("full", 0, False), ("sliding", 100, False),
                                  ("chunked", 128, True)):
        for bq, bk in ((64, 128), (128, 64)):
            for off in (0, 37):
                Sq, Skv = 300, 300 + off
                q = torch.from_numpy(rng.normal(size=(2, Sq, 8, 64))
                                     .astype(np.float32))
                k = torch.from_numpy(rng.normal(size=(2, Skv, 2, 64))
                                     .astype(np.float32))
                v = torch.from_numpy(rng.normal(size=(2, Skv, 2, 64))
                                     .astype(np.float32))
                do = torch.from_numpy(rng.normal(size=(2, Sq, 8, 64))
                                      .astype(np.float32))
                res = []
                for dev in ("cpu", "cuda"):
                    qq, kk, vv = (x.to(dev).requires_grad_()
                                  for x in (q, k, v))
                    fwd = L.flash_attention(qq.detach(), kk.detach(),
                                            vv.detach(), window=window,
                                            chunked=chunked, block_q=bq,
                                            block_kv=bk, q_offset=off)
                    o = L.flash_attention_vjp(qq, kk, vv, off, True, window,
                                              chunked, bq, bk)
                    gs = torch.autograd.grad(o, (qq, kk, vv), do.to(dev))
                    res.append((fwd, o, gs))
                ef = max(max_diff(res[0][0], res[1][0]),
                         max_diff(res[0][1], res[1][1]))
                eg = max(max_diff(a, b) for a, b in zip(res[0][2],
                                                        res[1][2]))
                log("lm_parity", check="flash", mask=name, block_q=bq,
                    block_kv=bk, q_offset=off, sq=Sq, skv=Skv,
                    fwd_err=f"{ef:.3e}", grad_err=f"{eg:.3e}",
                    tol_fwd=TOL_FLASH_FWD, tol_grad=TOL_FLASH_GRAD,
                    card=json.dumps(card))
                require(ef <= TOL_FLASH_FWD and eg <= TOL_FLASH_GRAD,
                        f"flash {name} {bq}/{bk} off {off}: {ef}, {eg}")
                worst = max(worst, ef)
    return worst


def phase_lm_parity(card: str):
    """[lm_parity]: float32, TF32 off. Each LM arch at reduced scale, card
    against CPU, then the attention alone."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    for aid in LM_ARCHS:
        lm_model_parity(aid, card)
    flash_parity(card)


def param_bytes(p) -> int:
    return sum(t.numel() * t.element_size() for t in p.parameters())


def cuda_ms(fn, reps: int = 1) -> float:
    """Wall ms of fn() from CUDA events, the mean of `reps` calls after
    one warm-up call."""
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


def serve_requests(p, cfg, n: int, prompt: int, new: int, seed: int):
    """n requests: each prompt fed a token a step through `lm_decode_step`
    (the reference's serving path has no cache-filling prefill), then
    `new` greedy tokens. Per-step seconds and whether the last logits
    are finite."""
    import torch
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n, prompt))
                            .astype(np.int64)).cuda()
    cache = T.init_cache(cfg, n, prompt + new)
    lat, logits = [], None
    for t in range(prompt + new):
        tok = toks[:, t] if t < prompt else logits.argmax(-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.lm_decode_step(p, cache, tok, t, cfg)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    finite = bool(torch.isfinite(logits).all())
    del cache
    return lat, finite


def prefill_bound_ms(cfg, B: int, S: int) -> float:
    """(2 N tokens + 2 B S^2 H hd L) / 989 TFLOP/s: the weights' products
    and causal attention (half of QK^T and of PV). N counts the
    parameters a token touches (an MoE's routed top-k, not every
    expert)."""
    ops = 2 * cfg.n_active_params() * B * S \
        + 2 * B * S * S * cfg.n_heads * cfg.head_dim * cfg.n_layers
    return ops / BF16_OPS_PER_S * 1e3


def lm_init(cfg, seed: int = 0):
    import torch
    from repro_torch.models import transformer as T
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = T.init_lm(cfg, generator=torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    return p, time.perf_counter() - t0


def fresh_peak():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def serve_qwen3(card: str) -> dict:
    """qwen3-1.7b at all 28 layers, bfloat16, random weights drawn on the
    card: 8 requests (128-token prompts, 32 greedy tokens); prefill at
    prefill_32k's 32,768 tokens (batch cut from 32 to 1); one decode step
    against decode_32k's T = 32,768 (batch cut from 128 to 8; the cache
    filled by a seeded draw); then float32 decode against prefill."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = get_arch("qwen3-1.7b").model
    base = fresh_peak()
    p, init_s = lm_init(cfg)
    pb = param_bytes(p)
    lat, finite = serve_requests(p, cfg, 8, 128, 32, seed=3)
    peak = torch.cuda.max_memory_allocated() - base
    gen_s = sum(lat[127:159])        # the steps whose logits gave the 32
    out = dict(arch="qwen3-1.7b", layers=cfg.n_layers,
               params=cfg.n_params(), param_bytes=pb,
               init_s=f"{init_s:.2f}", requests=8, prompt=128, new=32,
               decode_steps=len(lat),
               **{f"decode_{k}": v for k, v in
                  percentiles_ms(lat[1:]).items()},
               gen_tokens_per_s=f"{8 * 32 / gen_s:.1f}",
               tokens_per_s=f"{8 * len(lat) / sum(lat):.1f}",
               serve_peak_bytes=peak, peak_over_params=f"{peak / pb:.4f}",
               bf16_route=L.bf16_bmm_route(torch.device("cuda")),
               finite=finite, card=json.dumps(card))
    log("lm_serve", check="requests", **out)
    require(finite, "qwen3-1.7b: non-finite logits")
    # prefill_32k, batch 1
    S = 32768
    toks = torch.randint(0, cfg.vocab_size, (1, S), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(4))
    T.lm_prefill(p, toks[:, :1024], cfg)               # warm-up
    fresh_peak()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = T.lm_prefill(p, toks, cfg)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    b_ms = prefill_bound_ms(cfg, 1, S)
    log("lm_serve", check="prefill_32k", arch="qwen3-1.7b", batch=1,
        batch_cut_from=32, seq=S, ms=f"{pre_ms:.1f}", bound_ms=f"{b_ms:.1f}",
        bound_by="operations", share_of_bound=f"{b_ms / pre_ms:.4f}",
        peak_bytes=torch.cuda.max_memory_allocated() - base,
        finite=bool(torch.isfinite(logits).all()), card=json.dumps(card))
    require(bool(torch.isfinite(logits).all()), "prefill_32k: not finite")
    del toks, logits
    # decode_32k, batch 8: one step at the last position of a full cache
    B, Tn = 8, 32768
    fresh_peak()
    cache = T.init_cache(cfg, B, Tn)
    g = torch.Generator("cuda").manual_seed(5)
    for t in (cache.k, cache.v):
        for li in range(cfg.n_layers):
            t[li].normal_(generator=g)
    cache_bytes = 2 * cache.k.numel() * cache.k.element_size()
    tok = torch.randint(0, cfg.vocab_size, (B,), device="cuda", generator=g)
    dec_ms = cuda_ms(lambda: T.lm_decode_step(p, cache, tok, Tn - 1, cfg),
                     reps=5)
    logits, _ = T.lm_decode_step(p, cache, tok, Tn - 1, cfg)
    bound = (cache_bytes + pb) / HBM_BYTES_PER_S * 1e3
    log("lm_serve", check="decode_32k", arch="qwen3-1.7b", batch=B,
        batch_cut_from=128, cache_len=Tn, cache_bytes=cache_bytes,
        ms=f"{dec_ms:.3f}", bound_ms=f"{bound:.3f}", bound_by="bytes",
        share_of_bound=f"{bound / dec_ms:.4f}",
        peak_bytes=torch.cuda.max_memory_allocated() - base,
        finite=bool(torch.isfinite(logits).all()), card=json.dumps(card))
    require(bool(torch.isfinite(logits).all()), "decode_32k: not finite")
    del cache, logits, p
    # float32 at full width: decode must reproduce prefill
    fresh_peak()
    cfg32 = cfg.scaled(dtype="float32")
    p32, _ = lm_init(cfg32, seed=6)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(7))
    pre = T.lm_prefill(p32, toks, cfg32)
    cache = T.init_cache(cfg32, 2, 16)
    for t in range(16):
        last, cache = T.lm_decode_step(p32, cache, toks[:, t], t, cfg32)
    err = max_diff(pre, last)
    rel = float(((pre - last).abs() / (2e-3 + 2e-3 * last.abs())).max())
    log("lm_serve", check="decode_vs_prefill", arch="qwen3-1.7b",
        dtype="float32", param_bytes=param_bytes(p32), prompt=16,
        max_abs_diff=f"{err:.3e}", rtol=TOL_DECODE_PREFILL,
        atol=TOL_DECODE_PREFILL, worst_share_of_tol=f"{rel:.4f}",
        card=json.dumps(card))
    require(rel <= 1.0, f"qwen3-1.7b float32: decode vs prefill {err}")
    del p32, cache
    return out


def attention_times(card: str):
    """One qwen3-1.7b layer's causal attention at 8,192 tokens, bfloat16:
    the port's blockwise attention (float32 accumulation) against one
    `scaled_dot_product_attention` call (a library yardstick, not on the
    path) and the bound of its products at 989 TFLOP/s."""
    import torch
    from torch.nn import functional as F
    from repro_torch.models import layers as L
    B, S, H, KVH, hd = 1, 8192, 16, 8, 128
    g = torch.Generator("cuda").manual_seed(8)
    q = torch.randn((B, S, H, hd), device="cuda", generator=g,
                    dtype=torch.bfloat16)
    k = torch.randn((B, S, KVH, hd), device="cuda", generator=g,
                    dtype=torch.bfloat16)
    v = torch.randn((B, S, KVH, hd), device="cuda", generator=g,
                    dtype=torch.bfloat16)
    port = cuda_ms(lambda: L.flash_attention(q, k, v), reps=3)
    qt, kt, vt = (x.transpose(1, 2) for x in
                  (q, k.repeat_interleave(H // KVH, 2),
                   v.repeat_interleave(H // KVH, 2)))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True),
                  reps=3)
    ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    err = max_diff(L.flash_attention(q, k, v), ref.transpose(1, 2))
    bound = 2 * B * S * S * H * hd / BF16_OPS_PER_S * 1e3
    log("lm_serve", check="attention", shape=compact([B, S, H, KVH, hd]),
        dtype="bfloat16", ms=f"{port:.3f}", sdpa_ms=f"{lib:.3f}",
        bound_ms=f"{bound:.3f}", bound_by="operations",
        max_abs_diff_vs_sdpa=f"{err:.3e}",
        bf16_route=L.bf16_bmm_route(torch.device("cuda")),
        card=json.dumps(card))


def serve_other(aid: str, card: str, prefill_tokens: int = 0) -> dict:
    """One more arch at full width, bfloat16 (Scout cut to SCOUT_LAYERS
    layers, width kept): 4 requests (64-token prompts, 16 new tokens),
    then a prefill: of the 4 prompts, or of `prefill_tokens` tokens at
    batch 1. MoE archs also report the dropped (token, expert) pairs."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import count_drops
    cfg = get_arch(aid).model
    cut = ""
    if aid == "llama4-scout-17b-a16e":
        cut = f"layers {cfg.n_layers}->{SCOUT_LAYERS}, width kept"
        cfg = cfg.scaled(n_layers=SCOUT_LAYERS)
    base = fresh_peak()
    p, init_s = lm_init(cfg)
    pb = param_bytes(p)
    with count_drops() as dec_drops:
        lat, finite = serve_requests(p, cfg, 4, 64, 16, seed=9)
    g = torch.Generator("cuda").manual_seed(10)
    if prefill_tokens:
        toks = torch.randint(0, cfg.vocab_size, (1, prefill_tokens),
                             device="cuda", generator=g)
    else:
        toks = torch.randint(0, cfg.vocab_size, (4, 64), device="cuda",
                             generator=g)
    T.lm_prefill(p, toks[:, :64], cfg)                  # warm-up
    with count_drops() as pre_drops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = T.lm_prefill(p, toks, cfg)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    fin = finite and bool(torch.isfinite(logits).all())
    out = dict(arch=aid, layers=cfg.n_layers, params=cfg.n_params(),
               param_bytes=pb, init_s=f"{init_s:.2f}", requests=4,
               prompt=64, new=16,
               **{f"decode_{k}": v for k, v in
                  percentiles_ms(lat[1:]).items()},
               prefill_batch=toks.shape[0], prefill_seq=toks.shape[1],
               prefill_ms=f"{pre_ms:.1f}",
               prefill_bound_ms=f"{prefill_bound_ms(cfg, *toks.shape):.1f}",
               peak_bytes=peak, peak_over_params=f"{peak / pb:.4f}",
               finite=fin)
    if cfg.moe is not None:
        for name, d in (("decode", dec_drops), ("prefill", pre_drops)):
            dropped = int(sum(int(x) for x, _ in d))
            routed = sum(n for _, n in d)
            out[f"{name}_dropped_pairs"] = f"{dropped}/{routed}"
            out[f"{name}_dropped_share"] = f"{dropped / routed:.4f}"
    if cut:
        out["cut"] = json.dumps(cut)
    log("lm_serve", **out, card=json.dumps(card))
    require(fin, f"{aid}: non-finite logits")
    del p, logits
    return out


def phase_lm_serve(card: str):
    """[lm_serve]: the five LM archs at full width on the card, bfloat16."""
    from repro_torch.kernels import _build
    _build.reset_launch_counts()
    full = [serve_qwen3(card)]
    attention_times(card)
    full.append(serve_other("qwen2-1.5b", card))
    full.append(serve_other("h2o-danube-1.8b", card, prefill_tokens=8192))
    full.append(serve_other("qwen2-moe-a2.7b", card))
    full.append(serve_other("llama4-scout-17b-a16e", card,
                            prefill_tokens=16384))
    launches = sum(_build.launch_counts.values())
    log("lm_serve", kernel_launches=launches, card=json.dumps(card))
    require(launches == 0, "the LM path launched a port kernel")
    return full


def lm_train_parity(card: str):
    """tiny_lm (qwen3-1.7b's, float32), the launcher's default schedule
    (100 steps: lr warms up over 10): 3 steps on the card and on the CPU
    from one state drawn on the CPU; the largest parameter difference
    after each step, and the first step's gradients.

    Why not a 3-step schedule, as `[train]` runs the towers: its first
    step takes lr 2.3e-3, and Adam's first step moves each element by
    lr * g / (|g| + 1e-8). An element whose gradient sums cancel to ~1e-8
    (the float32 noise floor of sums of ~1e-2 terms) then moves by a
    share of lr that the last bits decide: 2.4e-4 apart on the card and
    the CPU (PERF.md §6) while every gradient agreed to 1.8e-8 of 2.4e-2."""
    import torch
    from repro_torch.distributed.train_step import _grads, make_loss_fn, \
        state_to
    from repro_torch.launch import train
    arch, init, cpu_step, data = train.build_trainer(
        "qwen3-1.7b", "train_4k", device="cpu")
    _, _, card_step, _ = train.build_trainer("qwen3-1.7b", "train_4k",
                                             device="cuda")
    cpu = init(torch.Generator().manual_seed(0))
    gpu = state_to(cpu, "cuda")
    loss_fn = make_loss_fn(arch, arch.shape("train_4k"))
    b = data(0)
    gc = _grads(loss_fn, cpu.params, b)[2]
    gg = _grads(loss_fn, gpu.params, b)[2]
    g_err = max(max_diff(g, gg[n]) / float(g.abs().max())
                for n, g in gc.items())
    diffs, losses = [], []
    for step in range(3):
        b = data(step)
        cpu, mc = cpu_step(cpu, b)
        gpu, mg = card_step(gpu, b)
        diffs.append(max_param_diff(cpu, gpu))
        losses.append((float(mc["loss"]), float(mg["loss"])))
    log("lm_train", check="parity", arch="qwen3-1.7b", scale="tiny_lm",
        steps=3, schedule_steps=100,
        grad_err_over_max_grad=f"{g_err:.3e}",
        max_param_diff=compact([f"{d:.3e}" for d in diffs]),
        tol=TOL_LM_PARITY, loss_cpu_card=compact(losses),
        card=json.dumps(card))
    require(max(diffs) <= TOL_LM_PARITY,
            f"tiny LM: card and CPU parameters differ by {max(diffs)}")
    return init


def lm_train_curve(init, card: str):
    """tiny_lm, 25 steps at lr 1e-2 on the card from the CPU's seed-0
    state: the last loss below the first."""
    import torch
    from repro_torch.distributed.train_step import state_to
    from repro_torch.launch import train
    state = state_to(init(torch.Generator().manual_seed(0)), "cuda")
    losses = train.train_loop("qwen3-1.7b", "train_4k", steps=25, lr=1e-2,
                              verbose=False, device="cuda",
                              init_state=state)["losses"]
    log("lm_train", check="loss_curve", arch="qwen3-1.7b", scale="tiny_lm",
        steps=25, lr=1e-2, first=f"{losses[0]:.5f}",
        last=f"{losses[-1]:.5f}",
        losses=compact([f"{x:.4f}" for x in losses]), card=json.dumps(card))
    require(losses[-1] < losses[0], "tiny LM: the loss did not fall")


def lm_train_restart(root: str, card: str):
    """tiny_lm on the card: 10 steps with a checkpoint every 4 and a
    WorkerFailure at step 6, resumed from step 4; the final state
    bit-equal to an uninterrupted run's."""
    import torch
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.distributed.fault_tolerance import run_with_restarts
    from repro_torch.launch import train
    kw = dict(steps=10, ckpt_every=4, verbose=False, device="cuda")
    whole = train.train_loop("qwen3-1.7b", "train_4k", **kw)
    ckpt_dir = os.path.join(root, "lm_train_restart")
    resumed = []

    def segment(resume_step):
        resumed.append(resume_step)
        hist = train.train_loop("qwen3-1.7b", "train_4k", ckpt_dir=ckpt_dir,
                                fail_at_step=6 if len(resumed) == 1
                                else None, **kw)
        segment.hist = hist
        return hist["final_step"]

    final = run_with_restarts(segment, max_restarts=1)
    a, b = _flatten(whole["state"]), _flatten(segment.hist["state"])
    equal = list(a) == list(b) and all(torch.equal(a[n], b[n]) for n in a)
    log("lm_train", check="restart", arch="qwen3-1.7b", scale="tiny_lm",
        steps=10, ckpt_every=4, failed_at=6, restarts=len(resumed) - 1,
        resumed_losses=len(segment.hist["losses"]), final_step=final,
        leaves=len(a), bit_equal=equal, card=json.dumps(card))
    require(final == 10 and resumed == [None, 6]
            and len(segment.hist["losses"]) == 6,
            f"LM restart: resumed {resumed}, final step {final}")
    require(segment.hist["losses"] == whole["losses"][4:],
            "LM restart: the resumed losses differ")
    require(equal, "LM restart: final state not bit-equal")


def lm_train_full(card: str, steps: int = 4, batch: int = 4) -> dict:
    """qwen3-1.7b at full width, bfloat16 parameters with float32 master
    weights: train_4k's 4,096 tokens, batch cut from 256 to `batch`."""
    import torch
    from repro_torch.device import to_tensor
    from repro_torch.launch import train
    base = fresh_peak()
    arch, init, step_fn, data = train.build_trainer(
        "qwen3-1.7b", "train_4k", scale="full", steps=steps, device="cuda",
        batch=batch)
    cfg = arch.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pb = param_bytes(state.params)
    ob = sum(t.numel() * t.element_size()
             for d in (state.opt.m, state.opt.v, state.opt.master)
             for t in d.values())
    lat, losses = [], []
    for step in range(steps):
        b = {k: to_tensor(v, "cuda") for k, v in data(step).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() - base
    S = arch.shape("train_4k").seq_len
    tokens = batch * S
    attn_ops = 3 * 2 * batch * S * S * cfg.n_heads * cfg.head_dim \
        * cfg.n_layers
    bound = (6 * cfg.n_params() * tokens + attn_ops) / BF16_OPS_PER_S * 1e3
    p50 = float(np.percentile(np.asarray(lat[1:]) * 1e3, 50))
    out = dict(arch="qwen3-1.7b", scale="full", seq=S, batch=batch,
               batch_cut_from=256, steps=steps, params=cfg.n_params(),
               param_bytes=pb, opt_bytes=ob, init_s=f"{init_s:.2f}",
               first_step_ms=f"{lat[0] * 1e3:.1f}",
               step_p50_ms=f"{p50:.1f}", step_bound_ms=f"{bound:.1f}",
               bound_by="operations", share_of_bound=f"{bound / p50:.4f}",
               peak_bytes=peak, peak_over_state=f"{peak / (pb + ob):.4f}",
               losses=compact([f"{x:.4f}" for x in losses]),
               card=json.dumps(card))
    log("lm_train", check="full_width", **out)
    require(all(np.isfinite(losses)), "qwen3-1.7b: a loss is not finite")
    del state, step_fn, init, data
    fresh_peak()
    return out


def phase_lm_train(root: str, card: str):
    """[lm_train]: the LM trainer on the card: tiny_lm parity with the
    CPU, a falling loss, a bit-equal restart; qwen3-1.7b at full width."""
    from repro_torch.kernels import _build
    _build.reset_launch_counts()
    init = lm_train_parity(card)
    lm_train_curve(init, card)
    lm_train_restart(root, card)
    full = lm_train_full(card)
    launches = sum(_build.launch_counts.values())
    log("lm_train", kernel_launches=launches, card=json.dumps(card))
    require(launches == 0, "the LM training path launched a port kernel")
    return full


# ---------------------------------------------------------------------------
# the GNN family (`repro_torch.models.gnn`, `models.gnn_sharded`,
# `kernels.segment`)
# ---------------------------------------------------------------------------

GNN_ARCH = "graphsage-reddit"
GNN_SRC = "src/repro_torch/kernels/csrc/gnn_kernels.cu"
GNN_REPLACES = ("jax.ops.segment_sum in src/repro/models/gnn.py:58 "
                "(no pallas_call)")
# the segment sum against its plain version in float64: the running-error
# bound of float32 sums in the kernel's order (`seg_bound`), times 1 + this
# (the bound is first order in 2^-24)
TOL_SEG = 1e-3
# every lane layout of the kernel: 16-byte loads at 8, 16 and 32 lanes a
# row (24, 64, 100, 128), 4-byte ones at 8, 16 and 32 (7, 13, 30) and four
# tiles a lane (602, 1433)
SEG_WIDTHS = (7, 13, 24, 30, 64, 100, 128, 602, 1433)
SEG_HUB_WIDTHS = (7, 100, 128)    # the hub cases (hot sources staged)
SEG_HUB_EDGES = 2_100_000         # a hub row's edges (above 2M)
SEG_HUB2_EDGES = 12_411           # a second hub's: 3 chunks and a short one
SEG_COLS = 8                      # float64 columns at a time at full width
SEG_EXACT_LONG = 64               # `seg_exact`: the longest non-hub rows
SEG_EXACT_RANDOM = 4096           # and random ones, besides every hub row
TOL_GNN_PARITY = 1e-5             # reduced graphsage-reddit, card vs CPU
TOL_GNN_TRAIN = 1e-4              # parameters after each of 3 tiny steps
TOL_GNN_LOSS = 1e-3               # the 30 tiny losses, card vs CPU
TOL_SHARDED_LOSS = 1e-4           # tests/test_distributed.py's bar:
TOL_SHARDED_GRAD = 1e-3           # loss, and gradients relative to the max
GNN_GRID = (2, 2)
GNN_REPS = 5                      # timed calls of each full-width forward
GNN_SEEDS = 1024                  # minibatch_lg's batch_nodes
# the full-width graphs drawn by helper processes while the LM phases run
GNN_DRAWN = ("ogb_products", "minibatch_lg")


def gnn_draw(name: str, out: str) -> None:
    """A helper process: graphsage-reddit's `make_graph` draw at the
    shape's size, saved as npy files in `out`; for ogb_products also its
    `partition_edges` over GNN_GRID's ranks, for minibatch_lg its
    `NeighborSampler` CSR. Seconds of each step in done.json."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_graph
    arch = get_arch(GNN_ARCH)
    shape = arch.shape(name)
    secs = {}
    t0 = time.perf_counter()
    g = make_graph(shape.n_nodes, max(2, shape.n_edges // shape.n_nodes),
                   shape.d_feat, arch.model.n_classes)
    secs["draw_s"] = round(time.perf_counter() - t0, 2)
    for k, v in g.items():
        np.save(os.path.join(out, f"{k}.npy"), v)
    t0 = time.perf_counter()
    if name == "ogb_products":
        from repro_torch.models.gnn_sharded import partition_edges
        part, _ = partition_edges(g["edges"], shape.n_nodes,
                                  int(np.prod(GNN_GRID)))
        np.save(os.path.join(out, "edges_part.npy"), part)
        secs["partition_s"] = round(time.perf_counter() - t0, 2)
    else:
        from repro_torch.models.gnn import NeighborSampler
        s = NeighborSampler.from_edges(g["edges"], shape.n_nodes)
        np.save(os.path.join(out, "indptr.npy"), s.indptr)
        np.save(os.path.join(out, "indices.npy"), s.indices)
        secs["sampler_csr_s"] = round(time.perf_counter() - t0, 2)
    with open(os.path.join(out, "done.json"), "w") as f:
        json.dump(secs, f)


class GnnDraws:
    """The GNN_DRAWN graphs drawn in spawned helper processes (host-only
    numpy: ~20-60 s each), started early so that the draws overlap the
    LM phases; `load` waits for one and reads its arrays."""

    def __init__(self, root: str):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.dirs, self.procs = {}, {}
        for name in GNN_DRAWN:
            d = os.path.join(root, f"gnn_{name}")
            os.makedirs(d, exist_ok=True)
            p = ctx.Process(target=gnn_draw, args=(name, d), daemon=True)
            p.start()
            self.dirs[name], self.procs[name] = d, p

    def wait(self, name: str, timeout: float = 900) -> dict:
        p = self.procs[name]
        t0 = time.perf_counter()
        p.join(timeout)
        if p.is_alive():
            p.kill()
            raise AssertionError(f"the {name} draw took over {timeout} s")
        require(p.exitcode == 0, f"the {name} draw failed ({p.exitcode})")
        with open(os.path.join(self.dirs[name], "done.json")) as f:
            info = json.load(f)
        info["waited_s"] = round(time.perf_counter() - t0, 2)
        return info

    def load(self, name: str, keys) -> dict:
        return {k: np.load(os.path.join(self.dirs[name], f"{k}.npy"))
                for k in keys}

    def close(self) -> None:
        for p in self.procs.values():
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


GRAPH_KEYS = ("feats", "edges", "labels", "mask")


def gnn_on_card(g: dict):
    """A make_graph draw on the card with its CSRs (`prepare_csr`), and
    the CSRs' build seconds."""
    import torch
    from repro_torch.kernels.segment import prepare_csr
    out = {k: torch.from_numpy(g[k]).cuda() for k in GRAPH_KEYS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["csr"] = prepare_csr(out["edges"], out["feats"].shape[0])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def small_graph(name: str) -> dict:
    """graphsage-reddit's make_graph draw at a small shape's size."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_graph
    arch = get_arch(GNN_ARCH)
    s = arch.shape(name)
    return make_graph(s.n_nodes, max(2, s.n_edges // s.n_nodes), s.d_feat,
                      arch.model.n_classes)


def molecule_batch(seed: int = 0, device="cuda") -> dict:
    """molecule's 128 graphs of 30 nodes and 64 edges (seeded draws),
    their labels, and the block-diagonal CSR."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import batched_csr
    arch = get_arch(GNN_ARCH)
    s = arch.shape("molecule")
    rng = np.random.default_rng(seed)
    G, n = s.batch_graphs, s.n_nodes
    b = {"feats": rng.normal(size=(G, n, s.d_feat)).astype(np.float32),
         "edges": rng.integers(0, n, (G, s.n_edges, 2)).astype(np.int32),
         "labels": rng.integers(0, arch.model.n_classes, G).astype(np.int32)}
    b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    b["csr"] = batched_csr(b["edges"], n)
    return b


def gnn_params(d_feat: int, seed: int = 0, device="cuda", cfg=None):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import init_gnn
    cfg = cfg or get_arch(GNN_ARCH).model
    return init_gnn(cfg, d_feat, device=device,
                    generator=torch.Generator(device).manual_seed(seed))


def seg_case(F: int, hub: bool, seed: int, n: int = 5000,
             e_rand: int = 60_000):
    """x (n, F) and its graph's CSRs on the card: random edges into the
    first 90% of rows (the rest have none), a tenth of them repeated,
    self-loops, (n, n) dummies up to a multiple of 512; with `hub`, two
    destinations and two sources of SEG_HUB_EDGES and SEG_HUB2_EDGES
    edges (two hub rows each way, so the hub pass adds more than one)."""
    import torch
    from repro_torch.kernels.segment import prepare_csr
    from repro_torch.models.gnn import pad_edges
    rng = np.random.default_rng(seed)
    live = int(n * 0.9)
    src = rng.integers(0, n, e_rand)
    dst = rng.integers(0, live, e_rand)
    dup = rng.choice(e_rand, e_rand // 10)
    loops = rng.integers(0, live, n // 20)
    ss, ds = [src, src[dup], loops], [dst, dst[dup], loops]
    if hub:
        for e, d, sr in ((SEG_HUB_EDGES, 5, 7), (SEG_HUB2_EDGES, 6, 8)):
            ss += [rng.integers(0, n, e), np.full(e, sr)]
            ds += [np.full(e, d), rng.integers(0, live, e)]
    edges = pad_edges(np.stack([np.concatenate(ss), np.concatenate(ds)],
                               1).astype(np.int32), 512, n)
    x = torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32)).cuda()
    return x, prepare_csr(torch.from_numpy(edges).cuda(), n), edges.shape[0]


def seg_plan(csr) -> dict:
    """The index work of `seg_bound` for one CSR, read from the plan that
    the kernel runs (the CSR's own): each entry's row, the first entry of
    its sum segment (a row's entries, or a hub chunk's, [chunk_beg,
    chunk_end)), whether it opens one, and the entries that close a hub's
    chunks in the hub pass's order (slot order: a hub's partials in entry
    order) with their rows."""
    import torch
    rows = csr.rows()
    pos = torch.arange(rows.shape[0], device=rows.device)
    counts = csr.indptr[1:] - csr.indptr[:-1]
    opens = torch.zeros_like(pos, dtype=torch.bool)
    opens[csr.indptr[:-1][counts > 0]] = True
    opens[csr.chunk_beg] = True
    seg = torch.cummax(torch.where(opens, pos, 0), 0).values
    by_slot = torch.argsort(csr.chunk_slot)
    ends = csr.chunk_end[by_slot] - 1
    hub_rows = csr.chunk_row[by_slot].long()
    hub_open = torch.cat([torch.ones_like(hub_rows[:1], dtype=torch.bool),
                          hub_rows[1:] != hub_rows[:-1]])
    return dict(rows=rows, seg=seg, opens=opens, ends=ends,
                hub_rows=hub_rows, hub_open=hub_open)


def ordered_sums(x, col, begs, ends):
    """(len(begs), F) float32: each [beg, end) of `col` summed from 0 in
    entry order, one add of x's row a position (a plain float32 loop over
    positions, one (items, F) tensor at a time)."""
    import torch
    lens = ends - begs
    acc = torch.zeros((begs.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    last = max(col.shape[0] - 1, 0)
    for j in range(int(lens.max()) if lens.numel() else 0):
        v = x[col[(begs + j).clamp(max=last)].long()]
        acc = torch.where((j < lens)[:, None], acc + v, acc)
    return acc


def seg_exact(x, csr, got, seed: int = 0) -> dict:
    """The kernel's output `got` (csr_sum(x, csr)) bit for bit against a
    plain float32 sum in the plan's order on sampled rows: every hub row
    (each chunk from 0 in entry order, then its partials in slot order),
    the SEG_EXACT_LONG longest other rows and SEG_EXACT_RANDOM random
    ones. Raises on the first difference; the rows checked."""
    import torch
    from repro_torch.kernels import segment
    counts = csr.indptr[1:] - csr.indptr[:-1]
    small = torch.nonzero(counts <= segment.CHUNK).flatten()
    longest = small[torch.argsort(counts[small], descending=True,
                                  stable=True)[:SEG_EXACT_LONG]]
    g = torch.Generator(device=x.device).manual_seed(seed)
    pick = torch.randperm(small.shape[0], generator=g, device=x.device)
    rows = torch.unique(torch.cat([longest,
                                   small[pick[:SEG_EXACT_RANDOM]]]))
    want = ordered_sums(x, csr.col, csr.indptr[rows], csr.indptr[rows + 1])
    bad = (want.view(torch.int32) != got[rows].view(torch.int32)).any(1)
    if bool(bad.any()):
        raise AssertionError(f"seg_exact: row {int(rows[bad][0])} differs "
                             "from the float32 sum in the CSR's order")
    n_hubs = csr.hub_rows.shape[0]
    if n_hubs:
        by_slot = torch.argsort(csr.chunk_slot)
        part = ordered_sums(x, csr.col, csr.chunk_beg[by_slot],
                            csr.chunk_end[by_slot])
        first = csr.hub_first.long()
        acc = torch.zeros((n_hubs, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        for k in range(int((first[1:] - first[:-1]).max())):
            idx = first[:-1] + k
            acc = torch.where((idx < first[1:])[:, None],
                              acc + part[idx.clamp(max=part.shape[0] - 1)],
                              acc)
        hub = csr.hub_rows.long()
        bad = (acc.view(torch.int32) != got[hub].view(torch.int32)).any(1)
        if bool(bad.any()):
            raise AssertionError(f"seg_exact: hub row {int(hub[bad][0])} "
                                 "differs from the float32 sum in the CSR's "
                                 "order")
    return dict(rows=int(rows.shape[0]), hub_rows=n_hubs,
                chunks=csr.n_chunks)


def seg_bound(x, csr, plan: dict):
    """(n_rows, F) float64: the running-error bound of the kernel's float32
    sums in the kernel's order, u * (sum over every add but a segment's
    first of |the partial sum it makes|), u = 2^-24. A segment is a row's
    edges, or for a hub row each chunk of CHUNK edges; a hub row then adds
    its chunks' sums in order, which the bound counts the same way. Each
    column's prefix sums are one 1-D scan (a scan down the rows of an
    (E, F) tensor runs a thread a column)."""
    import torch
    g = x.double()[csr.col.long()].t().contiguous()          # (F, E)
    cs = torch.zeros((x.shape[1], g.shape[1] + 1), dtype=torch.float64,
                     device=x.device)
    for c in range(x.shape[1]):
        torch.cumsum(g[c], 0, out=cs[c, 1:])
    del g
    part = cs[:, 1:] - cs.index_select(1, plan["seg"])  # partial sums
    del cs
    sums = part.index_select(1, plan["ends"])    # hub chunks' sums, in order
    part.abs_()
    part.mul_(~plan["opens"])
    bound = torch.zeros((x.shape[1], csr.n_rows), dtype=torch.float64,
                        device=x.device)
    bound.index_add_(1, plan["rows"], part)
    del part
    if sums.shape[1]:
        # the hub pass: acc = 0 + s0, then + s1, ...: its partials are the
        # running sums within a hub row after its first chunk
        run = sums.cumsum(1)
        k = torch.arange(sums.shape[1], device=x.device)
        first = torch.cummax(torch.where(plan["hub_open"], k, 0), 0).values
        run -= torch.cat([torch.zeros_like(run[:, :1]), run], 1)[:, first]
        run.abs_()
        run.mul_(~plan["hub_open"])
        bound.index_add_(1, plan["hub_rows"], run)
    return bound.t() * 2.0 ** -24


def seg_check(x, csr, what: str, cols: int = 0):
    """The kernel twice on (x, csr), bit-equal; bit-equal to the float32
    sum in the plan's order on sampled rows (`seg_exact`); against its
    plain version (`ref.segment_sum_ref`) on the same inputs in float64:
    within the running-error bound of float32 sums in the kernel's order
    (`seg_bound`, TOL_SEG slack). With `cols`, the kernel runs at x's
    whole width and the float64 side takes `cols` columns at a time (the
    published graphs' (E, F) float64 gather does not fit at once). (The
    max abs error, `seg_exact`'s counts.)"""
    import torch
    from repro_torch.kernels.ref import segment_sum_ref
    from repro_torch.kernels.segment import csr_sum
    a, b = csr_sum(x, csr), csr_sum(x, csr)
    torch.cuda.synchronize()
    require(torch.equal(a, b), f"segment_sum {what}: two calls differ")
    del b
    exact = seg_exact(x, csr, a)
    plan = seg_plan(csr)
    F = x.shape[1]
    worst = 0.0
    for c0 in range(0, F, cols or F):
        xs = x[:, c0:c0 + (cols or F)]
        want = segment_sum_ref(xs.double(), csr.col, plan["rows"],
                               csr.n_rows)
        lim = seg_bound(xs, csr, plan) * (1 + TOL_SEG)
        err = (a[:, c0:c0 + xs.shape[1]].double() - want).abs()
        if not bool((err <= lim).all()):
            r, c = np.unravel_index(int((err - lim).argmax()),
                                    tuple(err.shape))
            deg = int(csr.indptr[r + 1] - csr.indptr[r])
            raise AssertionError(
                f"segment_sum {what}: row {r} ({deg} edges) col {c0 + c}: "
                f"kernel {float(a[r, c0 + c])}, float64 {float(want[r, c])}"
                f", bound {float(lim[r, c])}")
        worst = max(worst, float(err.max()))
        del want, lim, err
    return worst, exact


def segment_parity() -> float:
    """[gnn_parity] kernel lines: every width of SEG_WIDTHS forward (by
    destination) and backward (by source, the gradient's direction), the
    hub cases at F = 7 and 128 (both hub passes required), and the
    autograd Function's gradient equal to the backward kernel's."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.segment import csr_sum, segment_occupancy, \
        segment_sum
    worst = 0.0
    for i, F in enumerate(SEG_WIDTHS):
        for hub in ((False, True) if F in SEG_HUB_WIDTHS else (False,)):
            x, csr, n_edges = seg_case(F, hub, seed=i)
            t0 = time.perf_counter()
            fwd, fwd_exact = seg_check(x, csr.by_dst, f"F={F} forward")
            g = torch.randn(x.shape, device=x.device, generator=torch.
                            Generator(x.device).manual_seed(i))
            bwd, bwd_exact = seg_check(g, csr.by_src, f"F={F} backward")
            if F % 4 == 0:
                # x 4 bytes off 16-byte alignment: 4-byte loads, the same
                # order, so the same bits
                buf = torch.empty(x.numel() + 1, device=x.device)
                xm = buf[1:].view(x.shape)
                xm.copy_(x)
                require(torch.equal(csr_sum(xm, csr.by_dst),
                                    csr_sum(x, csr.by_dst)),
                        f"segment_sum F={F}: unaligned x differs")
                del buf, xm
            if hub:
                require(csr.by_dst.hub_rows.shape[0] >= 2
                        and csr.by_src.hub_rows.shape[0] >= 2
                        and csr.by_dst.n_hot > 0,
                        "the hub case has fewer than two hub rows a way "
                        "or no hot source")
                xr = x.clone().requires_grad_()
                segment_sum(xr, csr).backward(g)
                require(torch.equal(xr.grad, csr_sum(g, csr.by_src)),
                        "segment_sum's gradient is not the backward kernel's")
            worst = max(worst, fwd, bwd)
            log("gnn_parity", kernel="segment_sum", F=F, hub=hub,
                edges=n_edges, valid_edges=csr.n_edges,
                hub_rows_fwd_bwd=compact([csr.by_dst.hub_rows.shape[0],
                                          csr.by_src.hub_rows.shape[0]]),
                hub_chunks_fwd_bwd=compact([csr.by_dst.n_chunks,
                                            csr.by_src.n_chunks]),
                max_abs_err_fwd=f"{fwd:.3e}", max_abs_err_bwd=f"{bwd:.3e}",
                bit_equal=True, tol=TOL_SEG,
                exact_rows_fwd_bwd=compact([fwd_exact["rows"],
                                            bwd_exact["rows"]]),
                n_hot=csr.by_dst.n_hot, plan=compact(segment_occupancy(
                    F, csr.by_dst.n_hot)),
                s=f"{time.perf_counter() - t0:.2f}")
            del x, csr, g
    log("gnn_parity", kernel="segment_sum", build_s=_build.build_seconds)
    return worst


def finite_diff(a, b, what: str) -> float:
    """max |a - b| where both are finite; raises unless a and b are
    non-finite at the same places with the same values (-inf, NaN)."""
    import torch
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    require(torch.equal(fa, fb) and torch.equal(a[~fa].nan_to_num(),
                                                b[~fb].nan_to_num())
            and torch.equal(a[~fa].isnan(), b[~fb].isnan()),
            f"{what}: the non-finite values differ")
    return float((a[fa] - b[fb]).abs().max()) if fa.any() else 0.0


def gnn_model_parity(card: str) -> float:
    """Reduced graphsage-reddit (d_hidden 64), float32, the same parameters
    on the CPU and the card: the full graph's logits (mean, sum and max
    aggregators), loss and every gradient; the minibatch and batched
    losses and gradients (the same sampled ids on both devices); all
    within TOL_GNN_PARITY."""
    import copy

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_graph
    from repro_torch.kernels.segment import prepare_csr
    from repro_torch.models import gnn as G
    from repro_torch.models.gnn import NeighborSampler, batched_csr
    from repro_torch.optim.adamw import param_tree
    base = get_arch(GNN_ARCH).model.scaled(d_hidden=64)
    g = make_graph(1000, 10, 48, base.n_classes, seed=1)
    p_cpu = gnn_params(48, device="cpu", cfg=base)
    rng = np.random.default_rng(3)
    Gr, n = 16, 30
    bat = {"feats": rng.normal(size=(Gr, n, 48)).astype(np.float32),
           "edges": rng.integers(-1, n + 1, (Gr, 64, 2)).astype(np.int32),
           "labels": rng.integers(0, base.n_classes, Gr).astype(np.int32)}
    seeds = np.arange(0, 1000, 8)
    out = {}
    for dev in ("cpu", "cuda"):
        p = p_cpu if dev == "cpu" else copy.deepcopy(p_cpu).to(dev)
        tree = param_tree(p)
        full = {k: torch.from_numpy(g[k]).to(dev) for k in GRAPH_KEYS}
        full["csr"] = prepare_csr(full["edges"], 1000)
        r = {}
        for agg in ("sum", "max"):
            r[f"logits_{agg}"] = G.gnn_full_forward(
                p, full["feats"], full["edges"], base.scaled(aggregator=agg),
                csr=full["csr"])
        loss, m = G.gnn_full_loss(p, full, base)
        r.update(logits_mean=G.gnn_full_forward(p, full["feats"], None,
                                                base, csr=full["csr"]),
                 loss=loss, acc=m["acc"])
        r.update({f"grad/{k}": v for k, v in zip(
            tree, torch.autograd.grad(loss, list(tree.values())))})
        sampler = NeighborSampler.from_edges(g["edges"], 1000, seed=2)
        blocks = sampler.sample_blocks(seeds, (5, 4),
                                       torch.from_numpy(g["feats"]).to(dev))
        blocks["labels"] = torch.from_numpy(g["labels"][seeds]).to(dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in bat.items()}
        b["csr"] = batched_csr(b["edges"], n)
        for kind, fn, batch in (("minibatch", G.gnn_minibatch_loss, blocks),
                                ("batched", G.gnn_batched_loss, b)):
            loss, _ = fn(p, batch, base)
            r[f"{kind}_loss"] = loss
            r.update({f"{kind}_grad/{k}": v for k, v in zip(
                tree, torch.autograd.grad(loss, list(tree.values())))})
        out[dev] = r
    diffs = {k: finite_diff(out["cpu"][k], out["cuda"][k], k)
             for k in out["cpu"]}
    worst = max(diffs.values())
    log("gnn_parity", check="model", arch=GNN_ARCH, d_hidden=64, nodes=1000,
        tensors=len(diffs), max_diff=f"{worst:.3e}", tol=TOL_GNN_PARITY,
        worst_tensor=max(diffs, key=diffs.get),
        loss_cpu_card=compact([float(out["cpu"]["loss"].detach()),
                               float(out["cuda"]["loss"].detach())]),
        card=json.dumps(card))
    require(worst <= TOL_GNN_PARITY,
            f"graphsage card vs CPU: {max(diffs, key=diffs.get)} differs "
            f"by {worst}")
    return worst


def phase_gnn_parity(card: str) -> float:
    """[gnn_parity]: the segment-sum kernel against its plain version on
    the card, forward and backward, bit-equal across two calls; then
    reduced graphsage-reddit card vs CPU. Returns the kernel's worst
    error."""
    err = segment_parity()
    gnn_model_parity(card)
    return err


def gnn_forward_bound(shape, n_edges: int):
    """The least time of one forward: `flops.cell_terms`' step (the
    reference's reckoning, at this run's edge count) without its 3x
    training factor; (ms, "bytes" or "operations")."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.flops import cell_terms
    s = dataclasses.replace(shape, n_edges=n_edges) if n_edges else shape
    t = cell_terms(get_arch(GNN_ARCH), s, chips=1, model_ways=1, dp_ways=1)
    by = "bytes" if t["t_memory"] >= t["t_compute"] else "operations"
    return max(t["t_memory"], t["t_compute"]) * 1e3 / 3, by


def gnn_full_floor(N: int, E: int, F: int, cfg, train: bool) -> dict:
    """The least time of the port's full-graph forward (or train step) as
    it is built: each op reads its inputs once and writes its outputs
    once, the messages never exist. A layer of input width w: the segment
    sum (x, the CSR, the in-degrees read, the (N, w) sum written, as
    `segment_times` counts it), then the dense part (x and the sum read,
    the (N, H) states written); the readout reads the states and writes
    the logits. A step adds the loss's labels and mask and the backward:
    each op reads the cotangent of its output and the saved tensors it
    needs and writes the cotangents of its inputs (none for the features,
    so layer 0's sum has no backward), the source CSR standing in for the
    destination CSR. Operations: the float32 matmuls (2 a multiply-add;
    a step two more for each, but layer 0's input gradients) and the
    sum's adds. {ms, by, bytes, flops}."""
    H, C, L = cfg.d_hidden, cfg.n_classes, cfg.n_layers
    widths = [F] + [H] * (L - 1)
    csr = (N + 1) * 8 + E * 4 + N * 4
    nbytes = sum(2 * N * w * 4 + csr + 2 * N * w * 4 + N * H * 4
                 for w in widths) + N * H * 4 + N * C * 4
    flops = sum(E * w + 4 * N * w * H for w in widths) + 2 * N * H * C
    if train:
        nbytes += N * 8 + N * C * 4 + 2 * N * H * 4
        for i, w in enumerate(widths):
            nbytes += 2 * N * H * 4 + 2 * N * w * 4
            if i:
                nbytes += 2 * N * w * 4 + N * w * 4 + csr + N * w * 4
        flops += sum((2 if i else 1) * 4 * N * w * H + (E * w if i else 0)
                     for i, w in enumerate(widths)) + 4 * N * H * C
    ms, by = bound_ms(nbytes, flops)
    return dict(ms=ms, by=by, bytes=nbytes, flops=flops)


def timed_calls(fn, reps: int = GNN_REPS):
    """fn() `reps` times, each synchronised: (seconds each, last result)."""
    import torch
    lat, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return lat, out


def serve_full(name: str, graph: dict, card: str) -> dict:
    """graphsage-reddit at full width (random weights) on one full-graph
    shape through `make_serve_step`: p50/p99 of GNN_REPS forwards beside
    the bound, peak device bytes above the graph, finite logits."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.train_step import make_serve_step
    arch = get_arch(GNN_ARCH)
    shape = arch.shape(name)
    p = gnn_params(shape.d_feat)
    fwd = make_serve_step(arch, shape)
    base = fresh_peak()
    with torch.no_grad():
        lat, logits = timed_calls(lambda: fwd(p, graph))
    peak = torch.cuda.max_memory_allocated() - base
    N, E = graph["feats"].shape[0], graph["edges"].shape[0]
    b_ms, by = gnn_forward_bound(shape, E)
    floor = gnn_full_floor(N, graph["csr"].n_edges, shape.d_feat,
                           arch.model, train=False)
    finite = bool(torch.isfinite(logits).all())
    pct = percentiles_ms(lat)
    out = dict(shape=name, nodes=N, edges=E, d_feat=shape.d_feat, **pct,
               floor_ms=f"{floor['ms']:.3f}", floor_by=floor["by"],
               floor_bytes=floor["bytes"], floor_flops=floor["flops"],
               p50_over_floor=f"{float(pct['p50_ms']) / floor['ms']:.2f}",
               ref_msg_bound_ms=f"{b_ms:.3f}", ref_msg_bound_by=by,
               peak_bytes=peak, finite=finite, card=json.dumps(card))
    log("gnn_serve", **out)
    require(finite and tuple(logits.shape) == (N, arch.model.n_classes),
            f"{name}: logits {tuple(logits.shape)} finite={finite}")
    return out


def segment_times(graph: dict, p) -> dict:
    """segment_sum at ogb_products' layer-2 width (F = 128, the hidden
    states of `p`'s first layer), the shape the main path gives it: the
    kernel against its plain version in float64 over both CSRs (the
    backward's with its zipf hub rows), SEG_COLS columns at a time, and
    bit-equal across two calls; the kernel's ms over the destination CSR
    (the forward) and over the source CSR (the backward, hub rows
    chunked), the plain version's (gather + index_add_), the library's
    one call for the same function (`torch.sparse.mm` of the CSR
    adjacency, cuSPARSE's SpMM) and `index_add_` alone on messages
    gathered beforehand; bytes and operations of the bound."""
    import torch
    from repro_torch.kernels.ref import segment_sum_ref
    from repro_torch.kernels.segment import csr_sum, segment_occupancy
    csr = graph["csr"]
    with torch.no_grad():
        l0 = p.layers[0]
        agg = csr_sum(graph["feats"], csr.by_dst) / torch.clamp(
            csr.deg, min=1.0)[:, None]
        h = torch.relu(graph["feats"] @ l0["w_self"]
                       + agg @ l0["w_neigh"] + l0["b"])
        del agg
        t0 = time.perf_counter()
        checks = [seg_check(h, c, f"ogb_products F=128 {what}", SEG_COLS)
                  for what, c in (("forward", csr.by_dst),
                                  ("backward", csr.by_src))]
        check_s = time.perf_counter() - t0
        d, b = csr.by_dst, csr.by_src
        ms = cuda_ms(lambda: csr_sum(h, d), reps=10)
        bwd_ms = cuda_ms(lambda: csr_sum(h, b), reps=10)
        rows = d.rows()
        plain_ms = cuda_ms(lambda: segment_sum_ref(h, d.col, rows, d.n_rows),
                           reps=2)
        lib = {}
        for name, c in (("fwd", d), ("bwd", b)):
            adj = torch.sparse_csr_tensor(
                c.indptr.to(torch.int32), c.col,
                torch.ones(c.col.shape[0], dtype=torch.float32,
                           device=h.device), (c.n_rows, c.n_cols))
            sp = torch.sparse.mm(adj, h)
            lib[f"{name}_diff"] = float((sp - csr_sum(h, c)).abs().max())
            del sp
            lib[name] = cuda_ms(lambda: torch.sparse.mm(adj, h), reps=10)
            del adj
        msg = h[d.col.long()]
        out = torch.zeros_like(h)
        index_add_ms = cuda_ms(lambda: out.index_add_(0, rows, msg), reps=2)
        del msg, out, rows
        bands = (torch.unique(b.col[b.chunk_beg].long() // b.band_rows)
                 .shape[0] if b.band_rows and b.n_chunks else 0)
    N, F = h.shape
    E, E_bwd = d.col.shape[0], b.col.shape[0]
    nbytes = 2 * N * F * 4 + (N + 1) * 8 + E * 4
    bwd_nbytes = 2 * N * F * 4 + (N + 1) * 8 + E_bwd * 4
    bwd_bound_ms, bwd_by = bound_ms(bwd_nbytes, E_bwd * F)
    return dict(ms=ms, bwd_ms=bwd_ms, plain_ms=plain_ms,
                library_ms=lib["fwd"], bwd_library_ms=lib["bwd"],
                index_add_ms=index_add_ms,
                sparse_mm_max_diff=[lib["fwd_diff"], lib["bwd_diff"]],
                max_abs_err=max(e for e, _ in checks),
                errs=[e for e, _ in checks], exact=[x for _, x in checks],
                check_s=check_s, nbytes=nbytes, ops=E * F,
                bwd_nbytes=bwd_nbytes, bwd_bound_ms=bwd_bound_ms,
                bwd_bound_by=bwd_by, bands=bands, n_hot=d.n_hot,
                occupancy=segment_occupancy(F, d.n_hot),
                shape=f"N={N},E={E},E_bwd={E_bwd},F={F}")


def serve_minibatch(draws: GnnDraws, card: str) -> dict:
    """minibatch_lg: GNN_SEEDS seeds sampled at the shape's fanout (15, 10)
    on the host (`NeighborSampler` over the drawn graph's CSR), the
    blocks gathered on the card, the forward through `make_serve_step`."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.train_step import make_serve_step
    from repro_torch.models.gnn import NeighborSampler
    arch = get_arch(GNN_ARCH)
    shape = arch.shape("minibatch_lg")
    info = draws.wait("minibatch_lg")
    a = draws.load("minibatch_lg", ("feats", "labels", "indptr", "indices"))
    feats = torch.from_numpy(a["feats"]).cuda()
    sampler = NeighborSampler(a["indptr"], a["indices"], seed=0)
    rng = np.random.default_rng(0)
    seeds = rng.choice(shape.n_nodes, GNN_SEEDS, replace=False)
    samp = []
    for _ in range(GNN_REPS):
        t0 = time.perf_counter()
        sampler.sample_ids(seeds, shape.fanout)
        samp.append(time.perf_counter() - t0)
    blocks = sampler.sample_blocks(seeds, shape.fanout, feats)
    p = gnn_params(shape.d_feat)
    fwd = make_serve_step(arch, shape)
    base = fresh_peak()
    with torch.no_grad():
        lat, logits = timed_calls(lambda: fwd(p, blocks))
    peak = torch.cuda.max_memory_allocated() - base
    b_ms, by = gnn_forward_bound(shape, 0)
    finite = bool(torch.isfinite(logits).all())
    out = dict(shape="minibatch_lg", nodes=shape.n_nodes,
               edges=int(a["indices"].shape[0]), seeds=GNN_SEEDS,
               fanout=compact(list(shape.fanout)), **info,
               sampler_host_p50_ms=f"{np.median(samp) * 1e3:.3f}",
               block_bytes=blocks["nbr2_feats"].numel() * 4,
               **{f"fwd_{k}": v for k, v in percentiles_ms(lat).items()},
               bound_ms=f"{b_ms:.3f}", bound_by=by, peak_bytes=peak,
               finite=finite, card=json.dumps(card))
    log("gnn_serve", **out)
    require(finite and tuple(logits.shape) == (GNN_SEEDS,
                                               arch.model.n_classes),
            f"minibatch_lg: logits {tuple(logits.shape)} finite={finite}")
    return dict(sampler=sampler, feats=feats, labels=a["labels"],
                seeds=seeds)


def serve_molecule(card: str) -> dict:
    """molecule: the batched forward of 128 graphs."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.train_step import make_serve_step
    arch = get_arch(GNN_ARCH)
    shape = arch.shape("molecule")
    b = molecule_batch()
    p = gnn_params(shape.d_feat)
    fwd = make_serve_step(arch, shape)
    with torch.no_grad():
        lat, logits = timed_calls(lambda: fwd(p, b))
    b_ms, by = gnn_forward_bound(shape, 0)
    finite = bool(torch.isfinite(logits).all())
    out = dict(shape="molecule", graphs=shape.batch_graphs,
               nodes=shape.n_nodes, edges=shape.n_edges,
               **percentiles_ms(lat), bound_ms=f"{b_ms:.5f}", bound_by=by,
               finite=finite, card=json.dumps(card))
    log("gnn_serve", **out)
    require(finite and tuple(logits.shape) == (shape.batch_graphs,
                                               arch.model.n_classes),
            f"molecule: logits {tuple(logits.shape)} finite={finite}")
    return out


def phase_gnn_serve(draws: GnnDraws, card: str):
    """[gnn_serve]: graphsage-reddit at full width on all four GNN_SHAPES
    (launch counts reset just before and read just after), then the
    segment-sum kernel's times at ogb_products' hidden width. Returns
    (launches, times, the ogb_products graph on the card, the
    minibatch_lg sampler and features)."""
    from repro_torch.kernels import _build
    sm, csr_sm = gnn_on_card(small_graph("full_graph_sm"))
    info = draws.wait("ogb_products")
    ogb, csr_s = gnn_on_card(draws.load("ogb_products", GRAPH_KEYS))
    log("gnn_serve", graph="ogb_products", **info,
        csr_build_s=f"{csr_s:.2f}",
        hub_chunks_fwd_bwd=compact([ogb["csr"].by_dst.n_chunks,
                                    ogb["csr"].by_src.n_chunks]),
        max_in_degree=int(ogb["csr"].deg.max()))
    _build.reset_launch_counts()
    serve_full("full_graph_sm", sm, card)
    serve_full("ogb_products", ogb, card)
    mb = serve_minibatch(draws, card)
    serve_molecule(card)
    launches = dict(_build.launch_counts)
    require(launches["segment_sum"] > 0, "the GNN serving path did not "
            "launch segment_sum")
    times = segment_times(ogb, gnn_params(100))
    b_ms, by = bound_ms(times["nbytes"], times["ops"])
    log("gnn_serve", kernel="segment_sum", at=times["shape"],
        hub_rows_fwd_bwd=compact([ogb["csr"].by_dst.hub_rows.shape[0],
                                  ogb["csr"].by_src.hub_rows.shape[0]]),
        hub_chunks_fwd_bwd=compact([ogb["csr"].by_dst.n_chunks,
                                    ogb["csr"].by_src.n_chunks]),
        bwd_bands=times["bands"], band_rows=ogb["csr"].by_src.band_rows,
        n_hot=times["n_hot"], plan=compact(times["occupancy"]),
        max_abs_err_fwd_bwd=compact([f"{e:.3e}" for e in times["errs"]]),
        exact_fwd_bwd=compact(times["exact"]),
        bit_equal=True, tol=TOL_SEG, check_s=f"{times['check_s']:.2f}",
        ms=f"{times['ms']:.4f}", bwd_ms=f"{times['bwd_ms']:.4f}",
        plain_ms=f"{times['plain_ms']:.4f}",
        library_sparse_mm_ms=f"{times['library_ms']:.4f}",
        bwd_library_sparse_mm_ms=f"{times['bwd_library_ms']:.4f}",
        sparse_mm_max_diff_fwd_bwd=compact(
            [f"{d:.3e}" for d in times["sparse_mm_max_diff"]]),
        index_add_ms=f"{times['index_add_ms']:.4f}",
        bound_ms=f"{b_ms:.4f}", bound_by=by,
        bwd_nbytes=times["bwd_nbytes"],
        bwd_bound_ms=f"{times['bwd_bound_ms']:.4f}",
        bwd_bound_by=times["bwd_bound_by"],
        launches=launches["segment_sum"], card=json.dumps(card))
    require(times["n_hot"] > 0 and times["occupancy"]["staged_rows"] > 0
            and times["occupancy"]["dynamic_smem"] > 0 and times["bands"] > 1,
            "ogb_products: the forward stages no hot source or the "
            "backward has no bands")
    fresh_peak()
    return launches, times, ogb, mb


def gnn_tiny_parity():
    """Tiny full_graph_sm (the launcher's scale): 3 steps on the card and
    on the CPU from one state; the largest parameter difference after
    each step within TOL_GNN_TRAIN. Returns the CPU's initial state."""
    import torch
    from repro_torch.distributed.train_step import state_to
    from repro_torch.launch import train
    _, init, cpu_step, cpu_data = train.build_trainer(
        GNN_ARCH, "full_graph_sm", steps=3, device="cpu")
    _, _, card_step, card_data = train.build_trainer(
        GNN_ARCH, "full_graph_sm", steps=3, device="cuda")
    cpu = init(torch.Generator().manual_seed(0))
    card = state_to(cpu, "cuda")
    diffs, losses = [], []
    for step in range(3):
        cpu, mc = cpu_step(cpu, cpu_data(step))
        card, mg = card_step(card, card_data(step))
        diffs.append(max_param_diff(cpu, card))
        losses.append((float(mc["loss"]), float(mg["loss"])))
    log("gnn_train", check="parity", arch=GNN_ARCH, shape="full_graph_sm",
        scale="tiny", steps=3,
        max_param_diff=compact([f"{d:.3e}" for d in diffs]),
        tol=TOL_GNN_TRAIN, loss_cpu_card=compact(losses))
    require(max(diffs) <= TOL_GNN_TRAIN,
            f"graphsage: card and CPU parameters differ by {max(diffs)}")


def gnn_loss_curve():
    """Tiny full_graph_sm, 30 steps at lr 1e-2 from the CPU's seed-0
    state on the card and on the CPU: the card's last loss below 0.8x its
    first (tests/test_system.py's bar), each loss within TOL_GNN_LOSS of
    the CPU's."""
    import torch
    from repro_torch.distributed.train_step import state_to
    from repro_torch.launch import train
    kw = dict(steps=30, lr=1e-2, verbose=False)
    _, init, _, _ = train.build_trainer(GNN_ARCH, "full_graph_sm", steps=30,
                                        lr=1e-2, device="cpu")
    cpu_state = init(torch.Generator().manual_seed(0))
    card = train.train_loop(GNN_ARCH, "full_graph_sm", device="cuda",
                            init_state=state_to(cpu_state, "cuda"),
                            **kw)["losses"]
    cpu = train.train_loop(GNN_ARCH, "full_graph_sm", device="cpu",
                           init_state=cpu_state, **kw)["losses"]
    diff = max(abs(a - b) for a, b in zip(card, cpu))
    log("gnn_train", check="loss_curve", arch=GNN_ARCH, steps=30, lr=1e-2,
        first=f"{card[0]:.5f}", last=f"{card[-1]:.5f}",
        ratio=f"{card[-1] / card[0]:.4f}", cpu_last=f"{cpu[-1]:.5f}",
        max_loss_diff_vs_cpu=f"{diff:.3e}", tol=TOL_GNN_LOSS)
    require(card[-1] < 0.8 * card[0], "graphsage: the loss did not fall "
            "below 0.8x its first")
    require(diff <= TOL_GNN_LOSS,
            f"graphsage: the card's losses differ from the CPU's by {diff}")


def gnn_restart(root: str):
    """Tiny full_graph_sm on the card: 10 steps with a checkpoint every 4
    and a WorkerFailure at step 6, resumed from step 4; the final state
    bit-equal to an uninterrupted run's (the segment sum has no atomics)."""
    import torch
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.distributed.fault_tolerance import run_with_restarts
    from repro_torch.launch import train
    kw = dict(steps=10, ckpt_every=4, verbose=False, device="cuda")
    whole = train.train_loop(GNN_ARCH, "full_graph_sm", **kw)
    ckpt_dir = os.path.join(root, "gnn_restart")
    resumed = []

    def segment(resume_step):
        resumed.append(resume_step)
        hist = train.train_loop(GNN_ARCH, "full_graph_sm",
                                ckpt_dir=ckpt_dir,
                                fail_at_step=6 if len(resumed) == 1
                                else None, **kw)
        segment.hist = hist
        return hist["final_step"]

    final = run_with_restarts(segment, max_restarts=1)
    a, b = _flatten(whole["state"]), _flatten(segment.hist["state"])
    equal = list(a) == list(b) and all(torch.equal(a[n], b[n]) for n in a)
    log("gnn_train", check="restart", arch=GNN_ARCH, steps=10, ckpt_every=4,
        failed_at=6, restarts=len(resumed) - 1, final_step=final,
        leaves=len(a), bit_equal=equal)
    require(final == 10 and segment.hist["losses"] == whole["losses"][4:],
            f"gnn restart: resumed {resumed}, final step {final}")
    require(equal, "gnn restart: final state not bit-equal")


def gnn_steps(shape_name: str, batch: dict, steps: int, d_feat: int):
    """`steps` training steps of graphsage-reddit at full width through
    `make_train_step` on `batch`: (seconds each, losses, peak bytes above
    the batch)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.train_step import (TrainState,
                                                    default_optimizer,
                                                    make_train_step)
    import torch
    arch = get_arch(GNN_ARCH)
    opt = default_optimizer(total_steps=steps, base_lr=3e-3)
    step_fn = make_train_step(arch, arch.shape(shape_name), optimizer=opt)
    base = fresh_peak()
    p = gnn_params(d_feat)
    state = TrainState(p, opt[0](p))
    lat, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        lat.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    return lat, losses, peak


def phase_gnn_train(root: str, ogb: dict, mb: dict, card: str):
    """[gnn_train]: the GNN trainer on the card: tiny parity with the CPU,
    the reference's loss bar, a bit-equal restart; ogb_products at full
    width (step p50/p99 over 5 steps after the first, beside the step's
    bound and its peak beside the message tensor the kernel never
    makes); a minibatch_lg step on sampled blocks and a molecule step.
    Returns the path's launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.flops import cell_terms
    _build.reset_launch_counts()
    gnn_tiny_parity()
    gnn_loss_curve()
    gnn_restart(root)
    arch = get_arch(GNN_ARCH)
    shape = arch.shape("ogb_products")
    lat, losses, peak = gnn_steps("ogb_products", ogb, 6, shape.d_feat)
    N, E = ogb["feats"].shape[0], ogb["edges"].shape[0]
    t = cell_terms(arch, dataclasses.replace(shape, n_edges=E), chips=1,
                   model_ways=1, dp_ways=1)
    b_ms = max(t["t_memory"], t["t_compute"]) * 1e3
    floor = gnn_full_floor(N, ogb["csr"].n_edges, shape.d_feat, arch.model,
                           train=True)
    pct = percentiles_ms(lat[1:])
    msg_bytes = E * arch.model.d_hidden * 4
    log("gnn_train", check="full_width", shape="ogb_products", nodes=N,
        edges=E, first_step_ms=f"{lat[0] * 1e3:.3f}",
        **{f"step_{k}": v for k, v in pct.items()},
        step_floor_ms=f"{floor['ms']:.3f}", floor_by=floor["by"],
        floor_bytes=floor["bytes"], floor_flops=floor["flops"],
        p50_over_floor=f"{float(pct['p50_ms']) / floor['ms']:.2f}",
        ref_msg_step_bound_ms=f"{b_ms:.3f}",
        ref_msg_bound_by="bytes" if t["t_memory"] >= t["t_compute"] else
        "operations", ref_msg_hbm_bytes=int(t["hbm_bytes"]),
        ref_msg_flops=int(t["flops"]),
        peak_bytes=peak, message_tensor_bytes=msg_bytes,
        losses=compact([f"{x:.5f}" for x in losses]), card=json.dumps(card))
    require(all(np.isfinite(losses)), "ogb_products: a loss is not finite")
    require(peak < msg_bytes, f"ogb_products: peak {peak} B reaches the "
            f"(E, H) message tensor's {msg_bytes} B")
    mshape = arch.shape("minibatch_lg")
    blocks = mb["sampler"].sample_blocks(mb["seeds"], mshape.fanout,
                                         mb["feats"])
    blocks["labels"] = torch.from_numpy(mb["labels"][mb["seeds"]]).cuda()
    mlat, mlosses, mpeak = gnn_steps("minibatch_lg", blocks, 3,
                                     mshape.d_feat)
    log("gnn_train", check="minibatch", shape="minibatch_lg",
        seeds=GNN_SEEDS, step_ms=compact([f"{x * 1e3:.3f}" for x in mlat]),
        peak_bytes=mpeak, losses=compact([f"{x:.5f}" for x in mlosses]))
    require(all(np.isfinite(mlosses)), "minibatch_lg: a loss is not finite")
    del blocks
    glat, glosses, _ = gnn_steps("molecule", molecule_batch(), 3,
                                 arch.shape("molecule").d_feat)
    log("gnn_train", check="molecule", graphs=128,
        step_ms=compact([f"{x * 1e3:.3f}" for x in glat]),
        losses=compact([f"{x:.5f}" for x in glosses]))
    require(all(np.isfinite(glosses)), "molecule: a loss is not finite")
    launches = dict(_build.launch_counts)
    log("gnn_train", launches=launches["segment_sum"], card=json.dumps(card))
    require(launches["segment_sum"] > 0,
            "the GNN training path did not launch segment_sum")
    fresh_peak()
    return launches


def gnn_tree(npz) -> dict:
    """{"layers": [...], "w_out": ...} from `param_tree` paths."""
    tree = {"layers": []}
    for path in npz.files:
        parts = path.split("/")
        if parts[0] == "w_out":
            tree["w_out"] = npz[path]
            continue
        li = int(parts[1])
        while len(tree["layers"]) <= li:
            tree["layers"].append({})
        tree["layers"][li][parts[2]] = npz[path]
    return tree


def gnn_rank_job(rank: int, job: dict, state: dict) -> dict:
    """gnn_load: this rank's slice of ogb_products from the run's files
    (its partition's CSR built on the card; features, labels and mask
    whole) and the parameters; gnn_loss: the partitioned loss and its
    gradients once to warm up, then once timed after a barrier. The
    float32 wire calls `sharded_full_loss_fn`; the bfloat16 wire, the
    default of the step factories' `grid=` path, goes through
    `train_step.make_loss_fn(arch, shape, grid)`."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core.sharded_search import ProcessGrid
    from repro_torch.distributed.train_step import make_loss_fn
    from repro_torch.kernels import _build
    from repro_torch.models.gnn import gnn_params_from_jax
    from repro_torch.models.gnn_sharded import local_csr, \
        sharded_full_loss_fn
    from repro_torch.optim.adamw import param_tree
    arch = get_arch(GNN_ARCH)
    cfg = arch.model
    if job["op"] == "gnn_load":
        t0 = time.perf_counter()
        d = job["dir"]
        batch = {k: torch.from_numpy(np.load(os.path.join(d, f"{k}.npy")))
                 .cuda() for k in ("feats", "labels", "mask")}
        part = np.load(os.path.join(d, "edges_part.npy"), mmap_mode="r")
        n = batch["feats"].shape[0]
        batch["csr"] = local_csr(np.ascontiguousarray(part[rank]), n,
                                 part.shape[0], rank, device="cuda")
        batch["edges"] = None
        with np.load(job["params"]) as z:
            params = gnn_params_from_jax(gnn_tree(z), device="cuda")
        state["gnn"] = dict(batch=batch, params=params, n=n,
                            grid=ProcessGrid(tuple(job["grid"])))
        torch.cuda.synchronize()
        return {"load_s": time.perf_counter() - t0,
                "edges": batch["csr"].n_edges}
    s = state["gnn"]
    wire = getattr(torch, job["wire"])
    if wire == torch.float32:
        fn = sharded_full_loss_fn(s["grid"], cfg, s["n"], wire_dtype=wire)
    else:
        shape = arch.shape("ogb_products")
        require(shape.n_nodes == s["n"], "the graph is not ogb_products'")
        fn = make_loss_fn(arch, shape, s["grid"])
    tree = param_tree(s["params"])

    def run():
        loss, m = fn(s["params"], s["batch"])
        return loss, m, torch.autograd.grad(loss, list(tree.values()))
    run()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    loss, m, grads = run()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    n_local = -(-s["n"] // s["grid"].world)
    return {"loss": float(loss.detach()), "acc": float(m["acc"]),
            "grads": {k: g.cpu().numpy() for k, g in zip(tree, grads)},
            "step_s": step_s, "launches": dict(_build.launch_counts),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "gathered_bytes": (cfg.n_layers - 1) * s["grid"].world
            * n_local * cfg.d_hidden * wire.itemsize}


def phase_gnn_sharded(root: str, draws: GnnDraws, ogb: dict, card: str):
    """[gnn_sharded]: ogb_products' full-width graph partitioned by
    destination over 4 gloo ranks (grid (2, 2), time-slicing cuda:0; each
    reads its partition from the run's files), the partitioned loss and
    gradients against the one-process `gnn_full_loss` on the card: with
    the float32 wire within TOL_SHARDED_LOSS and TOL_SHARDED_GRAD (the
    reference test's bar), with the bfloat16 wire the deviations; step
    wall, bytes gathered, per-rank peak. Returns the ranks' launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import gnn_full_loss
    from repro_torch.optim.adamw import param_tree
    cfg = get_arch(GNN_ARCH).model
    p = gnn_params(ogb["feats"].shape[1])
    tree = param_tree(p)
    loss, m = gnn_full_loss(p, ogb, cfg)
    ref = {k: g.cpu().numpy() for k, g in zip(
        tree, torch.autograd.grad(loss, list(tree.values())))}
    ref_loss, ref_acc = float(loss), float(m["acc"])
    params_path = os.path.join(root, "gnn_params.npz")
    np.savez(params_path, **{k: t.detach().cpu().numpy()
                             for k, t in tree.items()})
    del loss, m, p, tree
    fresh_peak()
    world = RankWorld(int(np.prod(GNN_GRID)), root, "gnn")
    launches = {}
    try:
        loads = world.run({"op": "gnn_load", "dir":
                           draws.dirs["ogb_products"],
                           "params": params_path, "grid": GNN_GRID})
        for wire in ("float32", "bfloat16"):
            ans = world.run({"op": "gnn_loss", "wire": wire})
            losses = {a["loss"] for a in ans.values()}
            g0 = ans[0]["grads"]
            same = all(all(np.array_equal(a["grads"][k], g0[k]) for k in g0)
                       for a in ans.values())
            rel = max(float(np.abs(g0[k] - ref[k]).max()
                            / (np.abs(ref[k]).max() + 1e-9)) for k in ref)
            dloss = abs(ans[0]["loss"] - ref_loss)
            log("gnn_sharded", wire=wire, grid=compact(list(GNN_GRID)),
                loss=f"{ans[0]['loss']:.6f}", ref_loss=f"{ref_loss:.6f}",
                loss_diff=f"{dloss:.3e}", grad_rel_diff=f"{rel:.3e}",
                acc=f"{ans[0]['acc']:.4f}", ref_acc=f"{ref_acc:.4f}",
                ranks_agree=len(losses) == 1 and same,
                step_ms=compact([f"{ans[r]['step_s'] * 1e3:.1f}"
                                 for r in sorted(ans)]),
                gathered_bytes=ans[0]["gathered_bytes"],
                peak_bytes=compact([ans[r]["peak_bytes"]
                                    for r in sorted(ans)]),
                load_s=compact([f"{loads[r]['load_s']:.2f}"
                                for r in sorted(loads)]),
                rank_edges=compact([loads[r]["edges"]
                                    for r in sorted(loads)]),
                world_start_s=f"{world.start_s:.2f}", card=json.dumps(card))
            require(len(losses) == 1 and same,
                    f"{wire}: the ranks' losses or gradients differ")
            if wire == "float32":
                require(dloss <= TOL_SHARDED_LOSS,
                        f"sharded loss off by {dloss}")
                require(rel <= TOL_SHARDED_GRAD,
                        f"sharded gradients off by {rel} (relative)")
                add_launches(launches, ans)
    finally:
        world.close()
    require(launches.get("segment_sum", 0) > 0,
            "the sharded GNN path did not launch segment_sum")
    return launches


# ---------------------------------------------------------------------------
# the distributed scaffolding (`launch.mesh`, `distributed.sharding`,
# `act_sharding`, `compression`, `pipeline`, `models.moe.moe_apply_ep`,
# `train_loop(grid=)`): one world of 4 gloo ranks on the card
# ---------------------------------------------------------------------------

# (arch, grid) of `[dist_rec]`: DLRM-rm2's tables row-sharded over 4 ranks,
# DCN-v2's over 2 and replicated over 2 data ranks
DIST_REC = (("dlrm-rm2", (1, 4)), ("dcn-v2", (2, 2)))
DIST_REC_STEPS = 3
DIST_REC_BATCH = None           # the shape's 65,536 rows (None: uncut)
# of qwen3-1.7b's 28, float32; 4 until a whole run took 1,041.6 s of its
# 1,200 s (PERF.md §4)
DIST_LM_LAYERS = 2
DIST_LM_BATCH = 4               # of train_4k's 256 sequences of 4,096
DIST_LM_STEPS = 2
DIST_LM_GRID = (2, 2)
TOL_DIST_LOSS = 1e-4            # sharded vs unsharded losses, relative
DIST_MOE_TOKENS = 4096          # tokens of the expert-parallel layer
TOL_MOE_OUT, TOL_MOE_GRAD = 1e-5, 1e-4   # tests/test_distributed.py:221
DIST_CP_SEQ = 8192
TOL_CP_LOSS, TOL_CP_GRAD = 1e-4, 5e-3    # tests/test_distributed.py:159
TOL_PIPE = 2e-4                          # tests/test_distributed.py:113
DIST_PSUM_ELEMS = 1 << 22       # elements of the compressed leaf


def dist_launches() -> int:
    from repro_torch.kernels import _build
    return sum(_build.launch_counts.values())


def dist_rec_job(job: dict) -> dict:
    """One recommender's `train_loop(grid=)` at full width; for DLRM-rm2
    also the trained model moved to `serve_placement` (tablewise: small
    tables replicated) and served by `make_serve_step(grid=)` at
    serve_p99, against the training placement's forward on the same
    batch."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import train_step as ts
    from repro_torch.launch import train
    from repro_torch.launch.mesh import ProcessGrid
    from repro_torch.models.recsys import rec_forward
    from repro_torch.optim.adamw import param_tree
    aid = job["aid"]
    grid = ProcessGrid(tuple(job["grid"]))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h = train.train_loop(aid, "train_batch", steps=DIST_REC_STEPS,
                         scale="full", device="cuda", grid=grid,
                         verbose=False, batch=DIST_REC_BATCH)
    wall = time.perf_counter() - t0
    st = h["state"]
    tree = param_tree(st.params)
    out = dict(losses=h["losses"], step_s=h["step_s"], wall_s=wall,
               table_bytes=sum(t.numel() * t.element_size()
                               for n, t in tree.items()
                               if n.startswith("tables/")),
               state_bytes=sum(t.numel() * t.element_size()
                               for t in [*tree.values(), *st.opt.m.values(),
                                         *st.opt.v.values()]),
               peak_bytes=torch.cuda.max_memory_allocated())
    if job.get("serve"):
        arch, init, _, data = train.build_trainer(
            aid, "train_batch", scale="full", device="cuda", grid=grid)
        shape = get_arch(aid).shape("serve_p99")
        b = {k: v[:shape.batch] for k, v in data(DIST_REC_STEPS).items()
             if k != "label"}
        want = rec_forward(st.params, SH.shard_batch(b, "rec_serve", grid),
                           arch.model)
        meta = train._make_init(arch, None)(torch.Generator("cpu"), "meta")
        place = ts.serve_placement(arch, shape, grid, meta)
        params = ts.reshard(st.params, init.placement, place)
        t1 = time.perf_counter()
        got = ts.make_serve_step(arch, shape, grid=grid)(params, b)
        torch.cuda.synchronize()
        out.update(serve_ms=(time.perf_counter() - t1) * 1e3,
                   serve_err=float((got - want).abs().max()),
                   serve_rows=int(got.shape[0]),
                   replicated_tables=sum(
                       1 for n, sp in place.params.items()
                       if n.startswith("tables/") and not SH.spec_axes(sp)),
                   serve_table_bytes=sum(
                       t.numel() * t.element_size()
                       for n, t in param_tree(params).items()
                       if n.startswith("tables/")))
        del params, got, want
    del st, tree, h
    gc.collect()
    torch.cuda.empty_cache()
    return out


def leaf_sums(state, place) -> dict:
    """{leaf: float64 sum of the full leaf}: each rank adds the blocks it
    owns, the world sums (a check of a sharded state that gathers
    nothing)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.distributed import sharding as SH
    leaves = _flatten(state)
    mine = torch.stack([
        t.detach().to(torch.float64).sum() if SH.owner(
            place.leaves[n][0], place.grid) else
        torch.zeros((), dtype=torch.float64, device=t.device)
        for n, t in leaves.items()]).cpu()
    dist.all_reduce(mine)
    return dict(zip(leaves, mine.tolist()))


def dist_lm_job(job: dict) -> dict:
    """qwen3-1.7b at its widths, `DIST_LM_LAYERS` layers in float32,
    `train_loop(grid=)` on DIST_LM_GRID with its final checkpoint saved on
    the grid: losses, step seconds, this rank's state bytes against the
    full state's; then the checkpoint restored onto (1, 4)
    (`restore(grid=)`, each rank reading its blocks), every leaf's sum
    against the trained state's."""
    import gc
    import shutil

    import torch
    from repro_torch.checkpoint.ckpt import _flatten, restore
    from repro_torch.launch import train
    from repro_torch.launch.mesh import ProcessGrid
    grid = ProcessGrid(tuple(job["grid"]))
    torch.cuda.reset_peak_memory_stats()
    kw = dict(scale="full", device="cuda", batch=DIST_LM_BATCH,
              steps=DIST_LM_STEPS, model_overrides=dict(
                  n_layers=DIST_LM_LAYERS, dtype="float32"))
    h = train.train_loop("qwen3-1.7b", "train_4k", grid=grid, verbose=False,
                         ckpt_dir=job["dir"], ckpt_every=1 << 30, **kw)
    place = train.build_trainer("qwen3-1.7b", "train_4k", grid=grid,
                                **kw)[1].placement
    leaves = _flatten(h["state"])
    mine = sum(t.numel() * t.element_size() for t in leaves.values())
    full = sum(int(np.prod(place.leaves[n][1])) * t.element_size()
               for n, t in leaves.items())
    out = dict(losses=h["losses"], step_s=h["step_s"], state_bytes=mine,
               full_state_bytes=full,
               peak_bytes=torch.cuda.max_memory_allocated())
    want = leaf_sums(h["state"], place)
    del h, leaves
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, init, _, _ = train.build_trainer("qwen3-1.7b", "train_4k",
                                        grid=ProcessGrid((1, 4)), **kw)
    st = restore(job["dir"], init(device="meta"), device="cuda",
                 grid=init.placement.grid, layout=init.placement.leaves)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    got = leaf_sums(st, init.placement)
    out["restore_rel_err"] = max(abs(got[n] - w) / (abs(w) + 1e-30)
                                 for n, w in want.items())
    out["restore_leaves"] = len(got)
    del st
    gc.collect()
    torch.cuda.empty_cache()
    if grid.rank == 0:
        shutil.rmtree(job["dir"], ignore_errors=True)
    return out


def _rel(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def dist_moe_part(rank: int) -> dict:
    """qwen2-moe-a2.7b's MoE layer (60 experts, top-4, d_expert 1,408, 4
    shared experts) on DIST_MOE_TOKENS tokens, float32: `moe_apply_ep` on
    grid (1, 4) against `moe_apply` on the same inputs, output and every
    gradient of (out ** 2).sum() (an expert leaf on this rank's rows)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import act_sharding as AS
    from repro_torch.launch.mesh import ProcessGrid
    from repro_torch.models.moe import init_moe, moe_apply, moe_apply_ep
    cfg = get_arch("qwen2-moe-a2.7b").model
    mc, D = cfg.moe, cfg.d_model
    grid = ProcessGrid((1, 4))
    n_pad = mc.padded_experts(grid.sizes["model"]) - mc.n_experts
    g = torch.Generator("cuda").manual_seed(0)
    p = init_moe(D, mc, generator=g, device="cuda", n_pad_experts=n_pad)
    leaves = {"router": p["router"], "w_gate": p["w_gate"],
              "w_up": p["w_up"], "w_down": p["w_down"],
              **{f"shared/{k}": v for k, v in p["shared"].items()}}
    for t in leaves.values():
        t.requires_grad_(True)
    x = torch.randn((DIST_MOE_TOKENS, D), generator=g, device="cuda")

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux = fn(p, x, mc, n_pad_experts=n_pad)
        gs = torch.autograd.grad((out ** 2).sum(), list(leaves.values()))
        torch.cuda.synchronize()
        return out.detach(), dict(zip(leaves, gs)), time.perf_counter() - t0
    want, g_want, ms_plain = run(moe_apply)
    AS.set_policy(grid)
    try:
        run(moe_apply_ep)                         # warm-up
        got, g_got, ms_ep = run(moe_apply_ep)
    finally:
        AS.set_policy(None)
    E_loc = (mc.n_experts + n_pad) // grid.sizes["model"]
    lo = grid.index(("model",)) * E_loc
    gerr = 0.0
    for k, w in g_want.items():
        a = g_got[k]
        if k in ("w_gate", "w_up", "w_down"):
            a, w = a[lo:lo + E_loc], w[lo:lo + E_loc]
        gerr = max(gerr, _rel(a, w))
    return dict(moe_out_err=_rel(got, want), moe_grad_err=gerr,
                moe_ep_ms=ms_ep * 1e3, moe_plain_ms=ms_plain * 1e3)


def dist_cp_part(rank: int) -> dict:
    """qwen3-1.7b's attention width (16 heads of 128 over 8 KV heads) at
    DIST_CP_SEQ tokens: `cp_attention_wrap` on grid (1, 4) (q rows over
    `model`) against single-rank `flash_attention_vjp`, the loss
    sum(out * w) and the gradients of q, k and v."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import act_sharding as AS
    from repro_torch.launch.mesh import ProcessGrid
    from repro_torch.models.layers import flash_attention_vjp
    cfg = get_arch("qwen3-1.7b").model
    g = torch.Generator("cuda").manual_seed(1)
    S, H, KVH, hd = DIST_CP_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.randn((1, S, n, hd), generator=g, device="cuda")
               .requires_grad_(True) for n in (H, KVH, KVH))
    w = torch.randn((1, S, H, hd), generator=g, device="cuda")

    def flash(qq, kk, vv, off):
        return flash_attention_vjp(qq, kk, vv, off, True, 0, False,
                                   min(512, qq.shape[1]),
                                   min(1024, kk.shape[1]))

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = (fn(q, k, v) * w).sum()
        gs = torch.autograd.grad(loss, [q, k, v])
        torch.cuda.synchronize()
        return float(loss.detach()), gs, time.perf_counter() - t0
    want, g_want, s_plain = run(lambda a, b, c: flash(a, b, c, 0))
    AS.set_policy(ProcessGrid((1, 4)), cp_attention=True)
    try:
        cp = AS.cp_attention_wrap(flash, S)
        require(cp is not None, "cp attention does not apply")
        got, g_got, s_cp = run(cp)
    finally:
        AS.set_policy(None)
    return dict(cp_loss_err=abs(got - want) / (abs(want) + 1e-9),
                cp_grad_err=max(_rel(a, b) for a, b in zip(g_got, g_want)),
                cp_ms=s_cp * 1e3, cp_plain_ms=s_plain * 1e3)


def dist_psum_part(rank: int) -> dict:
    """`compressed_psum` over the 4 ranks on the card (through the host:
    gloo) against the same on the CPU, bit for bit, and against the float32
    mean (<= 0.02 relative); its time beside a float32 all-reduce of the
    same leaf."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.mesh import all_reduce
    g = torch.Generator().manual_seed(100 + rank)
    host = {"g": torch.randn(DIST_PSUM_ELEMS, generator=g),
            "bias": torch.randn(1000, generator=g)}
    card = {k: t.cuda() for k, t in host.items()}
    world = dist.group.WORLD
    on_cpu = compressed_psum(host, world)
    compressed_psum(card, world)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = compressed_psum(card, world)
    torch.cuda.synchronize()
    t_int8 = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean = all_reduce(card["g"], world) / 4
    torch.cuda.synchronize()
    t_f32 = time.perf_counter() - t0
    return dict(psum_bit_equal=all(torch.equal(on_card[k].cpu(), on_cpu[k])
                                   for k in host),
                psum_rel=_rel(on_card["g"], mean), psum_ms=t_int8 * 1e3,
                f32_allreduce_ms=t_f32 * 1e3,
                psum_bytes=DIST_PSUM_ELEMS * 4)


def dist_pipe_part(rank: int) -> dict:
    """`pipeline_forward` over 4 stages ((4, 1) ("pp", "data")) on the
    card: 8 layers of tanh(h @ w) at d = 2,048, 8 microbatches of 512
    rows, against the stages run in sequence on the card (bit for bit)."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.pipeline import make_pp_grid, \
        pipeline_forward
    grid = make_pp_grid(4, 1)
    d, M, mb, L = 2048, 8, 512, 8
    g = torch.Generator("cuda").manual_seed(7)
    W = (torch.randn((4, L // 4, d, d), generator=g, device="cuda")
         * d ** -0.5)
    x = torch.randn((M, mb, d), generator=g, device="cuda")

    def stage_fn(params, h):
        for w in params:
            h = torch.tanh(h @ w)
        return h
    fn = pipeline_forward(grid, stage_fn, M)
    fn(SH.shard(W, ("pp",), grid)[0], x)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(SH.shard(W, ("pp",), grid)[0], x)
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = []
    for m in range(M):
        h = x[m]
        for s in range(4):
            h = stage_fn(W[s], h)
        seq.append(h)
    seq = torch.stack(seq)
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    # the gradients of sum(out * R): the schedule's backward against
    # autograd through the stages in sequence
    R = torch.randn((M, mb, d), generator=g, device="cuda")
    stage = grid.coords()[0]
    mine = SH.shard(W, ("pp",), grid)[0].clone().requires_grad_(True)
    xs = x.clone().requires_grad_(True)
    torch.autograd.grad((fn(mine, xs) * R).sum(), [mine, xs])   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gw, gx = torch.autograd.grad((fn(mine, xs) * R).sum(), [mine, xs])
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    Ws, xq = W.clone().requires_grad_(True), x.clone().requires_grad_(True)
    hs = []
    for m in range(M):
        h = xq[m]
        for s in range(4):
            h = stage_fn(Ws[s], h)
        hs.append(h)
    sw, sx = torch.autograd.grad((torch.stack(hs) * R).sum(), [Ws, xq])
    return dict(pipe_bit_equal=bool(torch.equal(out, seq)),
                pipe_ms=t_pipe * 1e3, seq_ms=t_seq * 1e3,
                pipe_grad_ms=t_grad * 1e3,
                pipe_gw_err=float((gw - sw[stage]).abs().max()),
                pipe_gx_err=float((gx - sx).abs().max()))


def dist_rank_job(rank: int, job: dict, state: dict) -> dict:
    """The `[dist_*]` phases' jobs on one rank; every answer carries the
    port kernels this rank launched in it."""
    import torch
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.reset_launch_counts()
    op = job["op"]
    if op == "dist_rec":
        out = dist_rec_job(job)
    elif op == "dist_lm":
        out = dist_lm_job(job)
    else:
        torch.cuda.reset_peak_memory_stats()
        out = {}
        for part in (dist_moe_part, dist_cp_part, dist_psum_part,
                     dist_pipe_part):
            out.update(part(rank))
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = dist_launches()
    return out


def unsharded_losses(aid: str, shape: str, **kw) -> dict:
    """`train_loop` of one process on the card (the yardstick of a
    sharded run): losses and step seconds; the state freed after."""
    from repro_torch.launch import train
    fresh_peak()
    h = train.train_loop(aid, shape, scale="full", device="cuda",
                         verbose=False, **kw)
    out = dict(losses=h["losses"], step_s=h["step_s"])
    del h
    fresh_peak()
    return out


def loss_err(got, want) -> float:
    return max(abs(a - b) / (abs(b) + 1e-9) for a, b in zip(got, want))


def p50_ms(seconds) -> str:
    return f"{float(np.percentile(np.asarray(seconds) * 1e3, 50)):.1f}"


def predicted_state_bytes(aid: str, grid) -> list:
    """Each rank's bytes of the parameters and the optimizer's `m` and
    `v` (what `[dist_rec]` measures) in the dry run's train_batch cell on
    `grid`, from the blocks of the cell's specs (meta: nothing is
    drawn)."""
    from repro_torch.launch import inputs as I
    from repro_torch.launch.mesh import ProcessGrid
    axes = ("data", "model")
    cell = I.build_cell(aid, "train_batch",
                        ProcessGrid(grid, axes, rank=0))
    out = []
    for r in range(int(np.prod(grid))):
        g = ProcessGrid(grid, axes, rank=r)
        out.append(sum(I._block(t, sp, g, r).numel() * t.element_size()
                       for p, t, sp in I.arg_leaves(cell)
                       if p.startswith(("0/params/", "0/opt/m/",
                                        "0/opt/v/"))))
    return out


def phase_dist_rec(world: "RankWorld", card: str) -> int:
    """[dist_rec]: DLRM-rm2 at its published cardinalities (48.08 GB of
    tables) on grid (1, 4), DCN-v2 on (2, 2): DIST_REC_STEPS steps of
    `train_loop(grid=)` at train_batch, the losses against the unsharded
    trainer's from the same state and batches, each rank's table bytes
    a quarter (a half) of the tables; DLRM-rm2 then served tablewise."""
    from repro_torch.configs import get_arch
    from repro_torch.models.recsys import padded_vocab
    launches = 0
    for aid, grid in DIST_REC:
        cfg = get_arch(aid).model
        tables = sum(padded_vocab(v) for v in cfg.vocab_sizes) \
            * cfg.embed_dim * 4
        ref = unsharded_losses(aid, "train_batch", steps=DIST_REC_STEPS,
                               batch=DIST_REC_BATCH)
        import torch
        parent = torch.cuda.memory_reserved()
        ans = world.run({"op": "dist_rec", "aid": aid, "grid": grid,
                         "serve": aid == "dlrm-rm2"}, timeout=900)
        per = int(np.prod(grid)) // grid[0]
        err = max(loss_err(a["losses"], ref["losses"]) for a in ans.values())
        predicted = predicted_state_bytes(aid, grid)
        extra = {}
        if aid == "dlrm-rm2":
            extra = dict(serve_err=compact([f"{ans[r]['serve_err']:.2e}"
                                            for r in sorted(ans)]),
                         serve_ms=compact([f"{ans[r]['serve_ms']:.1f}"
                                           for r in sorted(ans)]),
                         replicated_tables=ans[0]["replicated_tables"],
                         serve_table_bytes=ans[0]["serve_table_bytes"])
        log("dist_rec", arch=aid, grid=compact(list(grid)),
            batch=DIST_REC_BATCH or 65536, table_bytes=tables,
            rank_table_bytes=compact([ans[r]["table_bytes"]
                                      for r in sorted(ans)]),
            rank_state_bytes=compact([ans[r]["state_bytes"]
                                      for r in sorted(ans)]),
            dryrun_state_bytes=compact(predicted),
            losses=compact([f"{x:.6f}" for x in ans[0]["losses"]]),
            unsharded_losses=compact([f"{x:.6f}" for x in ref["losses"]]),
            loss_rel_err=f"{err:.2e}",
            step_p50_ms=p50_ms(ans[0]["step_s"][1:]),
            unsharded_step_p50_ms=p50_ms(ref["step_s"][1:]),
            first_step_ms=f"{ans[0]['step_s'][0] * 1e3:.1f}",
            rank_wall_s=compact([f"{ans[r]['wall_s']:.2f}"
                                 for r in sorted(ans)]),
            peak_bytes=compact([ans[r]["peak_bytes"] for r in sorted(ans)]),
            parent_reserved_bytes=parent, **extra, card=json.dumps(card))
        require(err <= TOL_DIST_LOSS, f"{aid}: sharded losses off by {err}")
        require(all(abs(a["table_bytes"] - tables / per) <= tables * 1e-6
                    for a in ans.values()),
                f"{aid}: a rank's tables are not 1/{per} of the tables")
        require(all(a["losses"] == ans[0]["losses"] for a in ans.values()),
                f"{aid}: the ranks' losses differ")
        require([ans[r]["state_bytes"] for r in sorted(ans)] == predicted,
                f"{aid}: the ranks hold other state bytes than the dry "
                f"run's {predicted}")
        if aid == "dlrm-rm2":
            require(all(a["serve_err"] <= 1e-4 for a in ans.values()),
                    "tablewise serving differs from the training placement")
            require(0 < ans[0]["replicated_tables"] < cfg.n_sparse,
                    "tablewise replicated no table or every table")
        launches += sum(a["launches"] for a in ans.values())
    log("dist_rec", kernel_launches=launches)
    require(launches == 0, "the sharded recommender path launched a kernel")
    return launches


def phase_dist_lm(world: "RankWorld", root: str, card: str) -> int:
    """[dist_lm]: qwen3-1.7b at its widths (d_model 2,048, 16 heads of 128,
    d_ff 6,144, vocab 151,936), DIST_LM_LAYERS of 28 layers in float32,
    batch DIST_LM_BATCH x 4,096: DIST_LM_STEPS steps of
    `train_loop(grid=DIST_LM_GRID)` against the unsharded trainer on the
    card from the same state; each rank's state bytes against the full
    state's; the elastic checkpoint restored onto (1, 4)."""
    kw = dict(steps=DIST_LM_STEPS, batch=DIST_LM_BATCH,
              model_overrides=dict(n_layers=DIST_LM_LAYERS,
                                   dtype="float32"))
    ref = unsharded_losses("qwen3-1.7b", "train_4k", **kw)
    ans = world.run({"op": "dist_lm", "grid": DIST_LM_GRID,
                     "dir": os.path.join(root, "dist_lm_ckpt")}, timeout=900)
    err = max(loss_err(a["losses"], ref["losses"]) for a in ans.values())
    launches = sum(a["launches"] for a in ans.values())
    log("dist_lm", arch="qwen3-1.7b", layers=DIST_LM_LAYERS, of_layers=28,
        dtype="float32", batch=DIST_LM_BATCH, seq=4096,
        grid=compact(list(DIST_LM_GRID)),
        losses=compact([f"{x:.6f}" for x in ans[0]["losses"]]),
        unsharded_losses=compact([f"{x:.6f}" for x in ref["losses"]]),
        loss_rel_err=f"{err:.2e}",
        step_ms=compact([f"{x * 1e3:.1f}" for x in ans[0]["step_s"]]),
        unsharded_step_ms=compact([f"{x * 1e3:.1f}"
                                   for x in ref["step_s"]]),
        rank_state_bytes=compact([ans[r]["state_bytes"]
                                  for r in sorted(ans)]),
        full_state_bytes=ans[0]["full_state_bytes"],
        peak_bytes=compact([ans[r]["peak_bytes"] for r in sorted(ans)]),
        restore_onto="[1,4]", restore_leaves=ans[0]["restore_leaves"],
        restore_rel_err=f"{ans[0]['restore_rel_err']:.2e}",
        restore_s=compact([f"{ans[r]['restore_s']:.2f}"
                           for r in sorted(ans)]),
        kernel_launches=launches, card=json.dumps(card))
    require(err <= TOL_DIST_LOSS, f"qwen3-1.7b: sharded losses off by {err}")
    require(all(a["restore_rel_err"] <= 1e-9 for a in ans.values()),
            "the (2, 2) checkpoint restored onto (1, 4) differs")
    require(all(a["state_bytes"] < 0.3 * a["full_state_bytes"]
                for a in ans.values()),
            "a rank holds more than its quarter of the LM state")
    require(launches == 0, "the sharded LM path launched a kernel")
    return launches


def phase_dist_parts(world: "RankWorld", card: str) -> int:
    """[dist_parts]: `moe_apply_ep`, `cp_attention_wrap`, `compressed_psum`
    and `pipeline_forward` on the card with CUDA tensors, each against its
    one-rank or CPU counterpart (module constants for shapes and bars)."""
    ans = world.run({"op": "dist_parts"}, timeout=600)
    launches = sum(a["launches"] for a in ans.values())

    def col(k, f="{:.2e}"):
        return compact([f.format(ans[r][k]) for r in sorted(ans)])
    log("dist_parts", part="moe_ep", arch="qwen2-moe-a2.7b",
        tokens=DIST_MOE_TOKENS, grid="[1,4]", out_rel_err=col("moe_out_err"),
        grad_rel_err=col("moe_grad_err"), ep_ms=col("moe_ep_ms", "{:.1f}"),
        plain_ms=col("moe_plain_ms", "{:.1f}"), card=json.dumps(card))
    log("dist_parts", part="cp_attention", seq=DIST_CP_SEQ, grid="[1,4]",
        loss_rel_err=col("cp_loss_err"), grad_rel_err=col("cp_grad_err"),
        cp_ms=col("cp_ms", "{:.1f}"), plain_ms=col("cp_plain_ms", "{:.1f}"),
        card=json.dumps(card))
    log("dist_parts", part="compressed_psum", ranks=4,
        elems=DIST_PSUM_ELEMS, bit_equal_cpu=col("psum_bit_equal", "{}"),
        rel_to_mean=col("psum_rel"), int8_ms=col("psum_ms", "{:.1f}"),
        f32_allreduce_ms=col("f32_allreduce_ms", "{:.1f}"),
        card=json.dumps(card))
    log("dist_parts", part="pipeline", stages=4, grid="[4,1]",
        bit_equal_sequential=col("pipe_bit_equal", "{}"),
        pipe_ms=col("pipe_ms", "{:.1f}"), seq_ms=col("seq_ms", "{:.1f}"),
        grad_w_abs_err=col("pipe_gw_err"), grad_x_abs_err=col("pipe_gx_err"),
        forward_backward_ms=col("pipe_grad_ms", "{:.1f}"),
        peak_bytes=col("peak_bytes", "{}"), kernel_launches=launches,
        card=json.dumps(card))
    for r, a in ans.items():
        require(a["moe_out_err"] <= TOL_MOE_OUT
                and a["moe_grad_err"] <= TOL_MOE_GRAD,
                f"rank {r}: moe_apply_ep off by {a['moe_out_err']}, "
                f"{a['moe_grad_err']}")
        require(a["cp_loss_err"] <= TOL_CP_LOSS
                and a["cp_grad_err"] <= TOL_CP_GRAD,
                f"rank {r}: cp attention off by {a['cp_loss_err']}, "
                f"{a['cp_grad_err']}")
        require(a["psum_bit_equal"] and a["psum_rel"] < 0.02,
                f"rank {r}: compressed_psum differs from the CPU's")
        require(a["pipe_bit_equal"], f"rank {r}: the pipeline differs")
        require(max(a["pipe_gw_err"], a["pipe_gx_err"]) <= TOL_PIPE,
                f"rank {r}: the pipeline's gradients differ from the "
                f"sequence's by {a['pipe_gw_err']}, {a['pipe_gx_err']}")
    require(launches == 0, "the distributed parts launched a kernel")
    return launches


def phase_dist(world: "RankWorld", root: str, card: str) -> None:
    """The three `[dist_*]` phases on one world of 4 gloo ranks sharing
    the card (NCCL refuses two ranks on one card), started in the
    background before the LM phases."""
    timed("dist_world", world.ready)
    log("dist", world_start_s=f"{world.start_s:.2f}")
    timed("dist_rec", phase_dist_rec, world, card)
    timed("dist_lm", phase_dist_lm, world, root, card)
    timed("dist_parts", phase_dist_parts, world, card)


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


# seconds of each phase, in order (`timed`)
PHASE_S = {}


def timed(name: str, fn, *args):
    """fn(*args), its seconds logged as a `[phase_s]` line and kept in
    PHASE_S."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[name] = round(time.perf_counter() - t0, 2)
        log("phase_s", of=name, s=PHASE_S[name])


def run_phases(root: str) -> int:
    """Every phase in order, the run's index directories under `root`."""
    import torch
    timed("env", phase_env)
    errs = timed("parity", phase_parity)
    peak_run = start_dryrun_peak(root)
    try:
        idx, lay, queries, gt, arrays = timed("build10k", build_index_10k)
        peak_launches = timed("dryrun_peak", phase_dryrun_peak, peak_run,
                              card_line())
    finally:
        stop_dryrun_peak(peak_run)
    # the first profiler window: after the build's host-only minutes (see
    # the module docstring)
    adc_ops = timed("adc_ops", adc_device_ops)
    launches, served = timed("main_path", phase_main_path, idx, lay,
                             queries, gt)
    times = timed("kernel_times", kernel_times, idx, lay, queries)
    timed("search_graph", phase_search_graph, idx, lay, queries)
    timed("write_load", phase_write_load, idx, lay, queries, arrays, root)
    timed("diskann", phase_diskann, arrays, idx, lay, queries, gt, served)
    del idx
    torch.cuda.empty_cache()
    arrays_1m, queries_1m, searches_1m, index_1m = timed("deployment",
                                                         phase_deployment)
    cells_launches = timed("cells", phase_cells, index_1m, arrays_1m,
                           card_line())
    del index_1m
    paths_1m = save_1m(arrays_1m, queries_1m, root)
    torch.cuda.empty_cache()
    timed("dryrun", phase_dryrun, root, card_line())
    rec_launches, adc, rec_errs = timed("recsys", phase_recsys)
    torch.cuda.empty_cache()
    bulk_launches, bulk, bulk_errs = timed("bulk_adc", phase_bulk_adc)
    torch.cuda.empty_cache()
    timed("adc_report", phase_adc_report, adc, bulk, adc_ops)
    storage_launches, peak_10k = timed("storage", phase_storage, arrays,
                                       queries, gt, root)
    path_1m = timed("storage1m", phase_storage1m, arrays_1m, queries_1m,
                    root, peak_10k)
    del arrays_1m
    timed("switch", phase_switch, root, path_1m)
    shutil.rmtree(path_1m)
    timed("serve_launch", phase_serve_launch)
    dyn_launches = timed("dynamic", phase_dynamic, arrays, queries, root)
    timed("crash_drill", phase_crash_drill, arrays, root)
    svc_launches = timed("service", phase_service, queries, root)
    timed("cluster", phase_cluster, arrays, queries, root)
    torch.cuda.empty_cache()
    sharded_launches = timed("sharded", phase_sharded, arrays, queries, gt,
                             root)
    sharded1m_launches = timed("sharded1m", phase_sharded1m, paths_1m,
                               searches_1m, root)
    tower_launches = timed("recsys_towers", phase_recsys_towers)
    timed("train", phase_train, root)
    card = card_line()
    # the `[dist_*]` ranks start (torch, a CUDA context each) and the
    # full-width graphs are drawn on the host while the LM phases run
    dist_world = RankWorld(4, root, "dist", expandable=True, wait=False)
    draws = None
    try:
        draws = GnnDraws(root)
        timed("lm_parity", phase_lm_parity, card)
        timed("lm_serve", phase_lm_serve, card)
        timed("lm_train", phase_lm_train, root, card)
        errs["segment_sum"] = timed("gnn_parity", phase_gnn_parity, card)
        gnn_launches, seg_times, ogb, mb = timed("gnn_serve",
                                                 phase_gnn_serve, draws,
                                                 card)
        errs["segment_sum"] = max(errs["segment_sum"],
                                  seg_times["max_abs_err"])
        gnn_train_launches = timed("gnn_train", phase_gnn_train, root, ogb,
                                   mb, card)
        del mb
        gnn_sharded_launches = timed("gnn_sharded", phase_gnn_sharded,
                                     root, draws, ogb, card)
        del ogb
        draws.close()
        draws = None
        phase_dist(dist_world, root, card)
    finally:
        if draws is not None:
            draws.close()
        dist_world.close()
    log("phase_s", total=round(sum(PHASE_S.values()), 2),
        by_phase=compact(PHASE_S))
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
    launches["segment_sum"] = gnn_launches["segment_sum"]
    times["segment_sum"] = seg_times
    kernels = []
    for name in (*REPLACES, "segment_sum"):
        t = times[name]
        b, by = bound_ms(t["nbytes"], t["ops"])
        gnn = name == "segment_sum"
        kernels.append({
            "name": name, "route": "cuda", "source": GNN_SRC if gnn else SRC,
            "replaces": GNN_REPLACES if gnn else REPLACES[name],
            "launches": launches[name],
            "launches_gnn_train": gnn_train_launches.get(name, 0),
            "launches_gnn_sharded": gnn_sharded_launches.get(name, 0),
            "launches_storage": storage_launches.get(name, 0),
            "launches_dynamic": dyn_launches.get(name, 0),
            "launches_service": svc_launches.get(name, 0),
            "launches_sharded": sharded_launches.get(name, 0),
            "launches_sharded1m": sharded1m_launches.get(name, 0),
            "launches_towers": tower_launches.get(name, 0),
            "launches_cells": cells_launches.get(name, 0),
            "launches_dryrun_peak": peak_launches.get(name, 0),
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b, "bound_by": by,
            "library_ms": t["library_ms"],
            **({"index_add_ms": t["index_add_ms"], "bwd_ms": t["bwd_ms"],
                "bwd_library_ms": t["bwd_library_ms"],
                "bwd_bound_ms": t["bwd_bound_ms"]} if gnn else {})})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
