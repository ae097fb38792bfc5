"""The fused AiSAQ hop — the search loop's kernel (`csrc/aisaq_kernels.cu`
`fused_hop_kernel`, replacing `repro/kernels/chunk_adc.py:_hop_kernel` and
`_hop_kernel_q8`).

For each (query q, beam slot i) one chunk-row gather yields the exact
query-node distance, the R neighbour ids and the R inline-PQ ADC distances
of the neighbours — AiSAQ's point: nothing N-sized is needed besides the
chunk table itself.
"""
from __future__ import annotations

import torch

from repro_torch.core.chunk_layout import ChunkLayout
from repro_torch.kernels import _build, ref


def fused_hop(chunk_words: torch.Tensor, frontier_ids: torch.Tensor,
              lut: torch.Tensor, queries: torch.Tensor, *,
              layout: ChunkLayout, metric: str = "l2",
              adc_dtype: str = "f32"):
    """chunk_words (N, S) i32; frontier_ids (nq, w) i32; lut (nq, m, ks)
    f32; queries (nq, d) f32. Returns (exact (nq, w), ids (nq, w, R),
    nbr_d (nq, w, R)).

    CUDA tensors launch the kernel; CPU tensors take `ref.fused_hop_ref`.
    adc_dtype="int8" quantizes the LUT per query (`ref.quantize_lut`) and
    sums int8 entries in int32 before one rescale by scale/127.
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
    if m % 4:
        raise ValueError("pq_m must be a multiple of 4 for word layout")
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
    common = (layout.data_dtype == "uint8", metric == "mips",
              layout.dev_off_ids // 4, layout.dev_off_pq // 4, R,
              exact.data_ptr(), ids.data_ptr(), nbr_d.data_ptr(),
              _build.stream())
    lib = _build.lib()
    if adc_dtype == "int8":
        lut_q8, scale = ref.quantize_lut(lut)
        scale127 = (scale / 127.0).contiguous()
        err = lib.aisaq_fused_hop_int8(
            chunk_words.data_ptr(), N, S, frontier_ids.data_ptr(), nq, w,
            lut_q8.data_ptr(), scale127.data_ptr(), m, ks,
            queries.data_ptr(), d, *common)
        name = "fused_hop_int8"
    else:
        err = lib.aisaq_fused_hop_f32(
            chunk_words.data_ptr(), N, S, frontier_ids.data_ptr(), nq, w,
            lut.data_ptr(), m, ks, queries.data_ptr(), d, *common)
        name = "fused_hop_f32"
    _build.check(err, name)
    _build.count_launch(name)
    return exact, ids, nbr_d
