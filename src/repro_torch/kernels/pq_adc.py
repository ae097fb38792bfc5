"""Bulk asymmetric distance computation over PQ codes
(`csrc/aisaq_kernels.cu` `pq_adc_kernel`, replacing
`repro/kernels/pq_adc.py:_adc_kernel` and `_adc_q8_kernel`).

out[q, r] = sum_j lut[q, j, codes[r, j]]: the scoring of every candidate
row against a query's LUT, as in the recommender's AiSAQ-mode retrieval.
Any m is accepted (the Pallas body needs m % 8 == 0).

On the card one persistent wave of CTAs walks tiles of code rows, which
arrive in a shared-memory ring by `cp.async.bulk`. A CTA scores each tile
against a group of queries whose LUTs it holds in shared memory,
interleaved so that one gather fetches every query's entry; the codes
leave HBM once per group. `adc_plan` sizes that shared memory; the kernel
checks the plan it is given.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build, ref

# constants of pq_adc_kernel in csrc/aisaq_kernels.cu
SMEM_LIMIT = 232_448        # shared memory a block may use on Hopper (B)
ADC_HEADER_BYTES = 384      # seven mbarriers, 16 maxima, 4 x 16 partial ones
ADC_CLUSTER = 4             # CTAs that stage an int8 table together
ADC_MAX_GROUP = {"f32": 8, "int8": 16}   # queries a group (GP)
ADC_TILE_BYTES = 8192       # target bytes of codes a ring slot
ADC_MAX_TILE_ROWS = 1024
ADC_PASS_ROWS = 256         # rows one pass of the 256 consumer threads takes


@dataclass(frozen=True)
class AdcPlan:
    """How pq_adc_kernel runs one call. `group` queries share a pass over
    the codes (`n_groups` passes), their LUTs interleaved in shared memory
    and padded to `group_pad` queries (`lut_bytes`); `tile_rows` rows of
    codes a ring slot (`slot_bytes`, 16 bytes of slack and 128-byte
    aligned), `depth` slots. `global_lut`: one query's LUT does not fit,
    so the kernel reads it from global memory, one query a group.
    `cluster` CTAs stage an int8 group together, each quantizing a share
    of the LUTs into all of their tables (1 for f32 and the global path)."""
    group: int
    group_pad: int
    n_groups: int
    tile_rows: int
    depth: int
    slot_bytes: int
    lut_bytes: int
    smem_bytes: int
    global_lut: bool
    cluster: int


def _pad(g: int) -> int:
    """Queries a gather fetches: 1, 2, 4, 8 or 16."""
    p = 1
    while p < g:
        p *= 2
    return p


def _round(x: int, to: int) -> int:
    return -(-x // to) * to


def adc_plan(nq: int, m: int, ks: int = 256,
             code_dtype: torch.dtype = torch.uint8,
             lut_dtype: str = "f32") -> AdcPlan:
    """The bulk ADC's plan: the largest query group (at most 8 f32 or 16
    int8 LUTs) whose interleaved LUTs fit `SMEM_LIMIT` beside a ring of two
    code tiles, and a third slot where it still fits. Tiles hold about
    `ADC_TILE_BYTES` of codes in a multiple of 512 rows (two rows a
    consumer thread), else 256 rows (one each) where two such slots take
    at most half of shared memory, else a multiple of 16 rows; so every
    tile of a 16-byte aligned table starts 16-byte aligned. Where not even one
    query's LUT fits, the plan reads the LUT from global memory. Raises
    ValueError only where the kernel cannot run: bad arguments, or rows
    too wide for two tiles of 16."""
    if lut_dtype not in ADC_MAX_GROUP:
        raise ValueError(f"lut_dtype must be 'f32' or 'int8', "
                         f"got {lut_dtype!r}")
    if code_dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"codes: expected torch.uint8 or torch.int32, got "
                        f"{code_dtype}")
    if nq < 1 or m < 1 or ks < 1:
        raise ValueError(f"need nq, m, ks >= 1, got {nq}, {m}, {ks}")
    row = m * (1 if code_dtype == torch.uint8 else 4)
    by_bytes = ADC_TILE_BYTES // row
    if by_bytes >= 2 * ADC_PASS_ROWS:
        tile_rows = min(ADC_MAX_TILE_ROWS,
                        by_bytes // (2 * ADC_PASS_ROWS) * 2 * ADC_PASS_ROWS)
    elif 2 * _round(ADC_PASS_ROWS * row + 16, 128) <= SMEM_LIMIT // 2:
        tile_rows = ADC_PASS_ROWS
    else:
        tile_rows = max(16, by_bytes // 16 * 16)
    slot = _round(tile_rows * row + 16, 128)
    ring_room = SMEM_LIMIT - ADC_HEADER_BYTES - 2 * slot
    if ring_room < 0:
        raise ValueError(f"pq_adc: rows of {row} B are too wide for two "
                         f"tiles of 16 rows in {SMEM_LIMIT} B")
    entry = 4 if lut_dtype == "f32" else 1
    # int8 sums of query pairs share a word in 16-bit halves: m <= 256
    group = min(nq, ADC_MAX_GROUP[lut_dtype]
                if lut_dtype == "f32" or m <= 256 else 1)
    while group >= 1:
        lut = _round(m * ks * _pad(group) * entry, 16)
        if lut <= ring_room:
            break
        group -= 1
    glob = group == 0
    if glob:
        group, lut = 1, 0
    depth = 3 if ADC_HEADER_BYTES + 3 * slot + lut <= SMEM_LIMIT else 2
    pad = 1 if glob else _pad(group)
    cluster = ADC_CLUSTER if lut_dtype == "int8" and not glob else 1
    return AdcPlan(group, pad, -(-nq // group), tile_rows, depth, slot, lut,
                   ADC_HEADER_BYTES + depth * slot + lut, glob, cluster)


def _plan_args(plan: AdcPlan):
    return (plan.group, plan.group_pad, plan.tile_rows, plan.depth,
            plan.slot_bytes, plan.global_lut, plan.cluster, plan.smem_bytes)


def _launch(lut: torch.Tensor, codes: torch.Tensor, quantized: bool
            ) -> torch.Tensor:
    nq, m, ks = lut.shape
    n = codes.shape[0]
    plan = adc_plan(nq, m, ks, codes.dtype, "int8" if quantized else "f32")
    _build.require(codes, "codes", codes.dtype, (n, m))
    _build.require(lut, "lut", torch.float32, (nq, m, ks))
    out = torch.empty((nq, n), dtype=torch.float32, device=lut.device)
    name = "pq_adc_q8" if quantized else "pq_adc"
    # the launcher reads a base that is not 16-byte aligned (a sliced
    # table) with plain loads instead of cp.async.bulk
    err = _build.lib().aisaq_pq_adc(
        codes.data_ptr(), n, m, codes.dtype == torch.int32, lut.data_ptr(),
        nq, ks, quantized, *_plan_args(plan), out.data_ptr(),
        _build.stream())
    _build.check(err, name)
    _build.count_launch(name)
    return out


def pq_adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (nq, m, ks) f32, codes (n, m) u8/i32 -> (nq, n) f32; a 2-D
    (m, ks) LUT gives (n,).

    CUDA tensors launch the kernel; CPU tensors take `ref.adc_ref`.
    """
    if not _build.on_cuda(lut, codes):
        return ref.adc_ref(lut, codes)
    squeeze = lut.ndim == 2
    out = _launch(lut[None] if squeeze else lut, codes, quantized=False)
    return out[0] if squeeze else out


def pq_adc_q8(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """int8-quantized ADC: lut (nq, m, ks) f32 -> (nq, n) f32; a 2-D LUT
    gives (n,). The LUT is quantized per query (the recipe of
    `ref.quantize_lut`), the int8 entries are summed exactly in int32 and
    rescaled once by scale * INV127, so the error per distance is at most
    m * max|lut| / 127.

    CUDA tensors launch the kernel, which quantizes the LUT itself (one
    launch, no torch op); CPU tensors take `ref.pq_adc_q8_ref`.
    """
    if not _build.on_cuda(lut, codes):
        return ref.pq_adc_q8_ref(lut, codes)
    squeeze = lut.ndim == 2
    out = _launch(lut[None] if squeeze else lut, codes, quantized=True)
    return out[0] if squeeze else out


def adc_occupancy(nq: int, m: int, ks: int = 256,
                  code_dtype: torch.dtype = torch.uint8,
                  lut_dtype: str = "f32") -> dict:
    """What the card makes of the kernel at this plan: registers a thread,
    static and dynamic shared memory, local (spill) bytes a thread,
    resident CTAs an SM, the card's SMs and resident clusters
    (`cudaFuncGetAttributes`, `cudaOccupancyMaxActiveBlocksPerMultiprocessor`,
    `cudaOccupancyMaxActiveClusters`), beside the plan.
    Needs the card."""
    plan = adc_plan(nq, m, ks, code_dtype, lut_dtype)
    out = (ctypes.c_int * 8)()
    _build.check(_build.lib().aisaq_adc_occupancy(
        m, code_dtype == torch.int32, ks, lut_dtype == "int8",
        *_plan_args(plan), out), "adc_occupancy")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes",
            "ctas_per_sm", "sms", "clusters", "cluster_ctas")
    return dict(zip(keys, list(out)), **vars(plan))
