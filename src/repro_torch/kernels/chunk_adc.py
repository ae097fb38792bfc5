"""The fused AiSAQ hop — the search loop's kernel (`csrc/aisaq_kernels.cu`
`hop_kernel`, replacing `repro/kernels/chunk_adc.py:_hop_kernel` and
`_hop_kernel_q8`).

For each (query q, beam slot i) one chunk-row gather yields the exact
query-node distance, the R neighbour ids and the R inline-PQ ADC distances
of the neighbours — AiSAQ's point: nothing N-sized is needed besides the
chunk table itself.

On the card a query is one thread-block cluster of w CTAs, one CTA per
frontier row. In f32 the query's LUT streams through shared memory in
slabs of `HopPlan.group` subspaces, each fetched once for the cluster and
multicast to its CTAs; in int8 the cluster quantizes the LUT once, each
CTA a share, into every CTA's shared memory. `hop_plan` sizes that shared
memory; the kernel checks the plan it is given.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.core.chunk_layout import ChunkLayout
from repro_torch.kernels import _build, ref

# constants of hop_kernel in csrc/aisaq_kernels.cu
SMEM_LIMIT = 232_448        # shared memory a block may use on Hopper (B)
HOP_HEADER_BYTES = 128      # five mbarriers and the int8 partial maximum
HOP_MAX_GROUP = 32          # one lane per subspace of a slab
HOP_MAX_R = 8 * 16          # 8 consumer warps, 16 neighbours each
HOP_MAX_CLUSTER = 8         # portable cluster size: w frontier rows


@dataclass(frozen=True)
class HopPlan:
    """Shared memory of one CTA: header, the chunk row, and the LUT it
    stages (`lut_bytes`). f32 stages a ring of two slabs of `group`
    subspaces (the last slab may be shorter), multicast to the cluster;
    int8 the whole LUT quantized once by the cluster (m*ks bytes) and the
    CTA's f32 share of it, 1/w of the LUT in groups of 16 entries. Lanes
    take `group` subspaces at a time in both."""
    group: int
    n_slabs: int
    row_bytes: int
    lut_bytes: int
    smem_bytes: int


def hop_plan(layout: ChunkLayout, ks: int = 256, w: int = 4,
             adc_dtype: str = "f32") -> HopPlan:
    """The hop's shared-memory plan. For f32 the largest slab (at most 32
    subspaces, halved until it fits) whose plan fits `SMEM_LIMIT`. Raises
    ValueError when none fits, or when the layout or the frontier width
    exceeds what the kernel takes (R > 128, w outside [1, 8], ks or pq_m
    not a multiple of 4)."""
    R, m = layout.R, layout.pq_m
    if adc_dtype not in ("f32", "int8"):
        raise ValueError(f"adc_dtype must be 'f32' or 'int8', "
                         f"got {adc_dtype!r}")
    if m % 4 or m <= 0:
        raise ValueError("pq_m must be a positive multiple of 4 for word "
                         "layout")
    if ks <= 0 or ks % 4:
        raise ValueError(f"ks must be a positive multiple of 4, got {ks}")
    if R > HOP_MAX_R:
        raise ValueError(f"fused_hop takes R <= {HOP_MAX_R}, got {R}")
    if not 1 <= w <= HOP_MAX_CLUSTER:
        raise ValueError(f"fused_hop runs a cluster of w CTAs: need "
                         f"1 <= w <= {HOP_MAX_CLUSTER}, got {w}")
    row = layout.device_stride
    group = min(HOP_MAX_GROUP, m)
    while group >= 1:
        if adc_dtype == "int8":
            share = -(-(m * ks // 16) // w) * 64
            staged = -(-m * ks // 16) * 16 + share
        else:
            staged = 2 * group * ks * 4
        total = HOP_HEADER_BYTES + row + staged
        if total <= SMEM_LIMIT:
            return HopPlan(group, -(-m // group), row, staged, total)
        if adc_dtype == "int8":
            break
        group //= 2
    raise ValueError(f"fused_hop ({adc_dtype}): a {row} B chunk row and "
                     f"the staged LUT exceed {SMEM_LIMIT} B of shared "
                     f"memory")


def fused_hop(chunk_words: torch.Tensor, frontier_ids: torch.Tensor,
              lut: torch.Tensor, queries: torch.Tensor, *,
              layout: ChunkLayout, metric: str = "l2",
              adc_dtype: str = "f32"):
    """chunk_words (N, S) i32; frontier_ids (nq, w) i32; lut (nq, m, ks)
    f32; queries (nq, d) f32. Returns (exact (nq, w), ids (nq, w, R),
    nbr_d (nq, w, R)).

    CUDA tensors launch the kernel, once for either adc_dtype; CPU tensors
    take `ref.fused_hop_ref`. adc_dtype="int8" quantizes the LUT per query
    inside the kernel (the recipe of `ref.quantize_lut`) and sums int8
    entries in int32 before one rescale by scale * INV127 (`ref.INV127`).
    """
    if layout.mode != "aisaq":
        raise NotImplementedError("fused_hop needs inline codes (aisaq mode)")
    if adc_dtype not in ("f32", "int8"):
        raise ValueError(f"adc_dtype must be 'f32' or 'int8', "
                         f"got {adc_dtype!r}")
    if not _build.on_cuda(chunk_words, frontier_ids, lut, queries):
        return ref.fused_hop_ref(chunk_words, frontier_ids, lut, queries,
                                 layout, metric=metric, adc_dtype=adc_dtype)
    nq, w = frontier_ids.shape
    N, S = chunk_words.shape
    R, m, d = layout.R, layout.pq_m, layout.dim
    ks = lut.shape[-1]
    plan = hop_plan(layout, ks, w, adc_dtype)
    if S * 4 != layout.device_stride:
        raise ValueError(f"chunk_words rows hold {S * 4} B, layout says "
                         f"{layout.device_stride}")
    _build.require(chunk_words, "chunk_words", torch.int32, (N, S))
    _build.require(frontier_ids, "frontier_ids", torch.int32, (nq, w))
    _build.require(lut, "lut", torch.float32, (nq, m, ks))
    _build.require(queries, "queries", torch.float32, (nq, d))
    dev = chunk_words.device
    exact = torch.empty((nq, w), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, w, R), dtype=torch.int32, device=dev)
    nbr_d = torch.empty((nq, w, R), dtype=torch.float32, device=dev)
    err = _build.lib().aisaq_fused_hop(
        chunk_words.data_ptr(), N, S, frontier_ids.data_ptr(), nq, w,
        lut.data_ptr(), m, ks, plan.group, plan.smem_bytes,
        queries.data_ptr(), d, layout.data_dtype == "uint8",
        metric == "mips", layout.dev_off_ids // 4, layout.dev_off_pq // 4, R,
        adc_dtype == "int8", exact.data_ptr(), ids.data_ptr(),
        nbr_d.data_ptr(), _build.stream())
    name = f"fused_hop_{adc_dtype}"
    _build.check(err, name)
    _build.count_launch(name)
    return exact, ids, nbr_d


def hop_occupancy(layout: ChunkLayout, adc_dtype: str = "f32",
                  ks: int = 256, w: int = 4) -> dict:
    """What the card makes of the hop kernel at this layout's plan:
    registers a thread, static and dynamic shared memory, local (spill)
    bytes a thread, resident CTAs an SM and resident clusters of w CTAs
    (`cudaFuncGetAttributes`, `cudaOccupancyMaxActiveBlocksPerMultiprocessor`,
    `cudaOccupancyMaxActiveClusters`). Needs the card."""
    plan = hop_plan(layout, ks, w, adc_dtype)
    out = (ctypes.c_int * 6)()
    _build.check(_build.lib().aisaq_hop_occupancy(
        adc_dtype == "int8", plan.smem_bytes, w, out), "hop_occupancy")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes",
            "ctas_per_sm", "clusters")
    return dict(zip(keys, list(out)), group=plan.group,
                n_slabs=plan.n_slabs)
