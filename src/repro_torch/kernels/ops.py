"""Public kernel entry points with backend dispatch (twin of
`repro.kernels.ops`).

backend:
  "auto"  the CUDA kernel on CUDA tensors, the plain version on CPU tensors
  "ref"   the plain PyTorch version, explicitly (the yardstick the kernels
          are held against on the card)
"""
from __future__ import annotations

import torch

from repro_torch.core.chunk_layout import ChunkLayout
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.chunk_adc import fused_hop as _fused_hop_kernel
from repro_torch.kernels.pq_adc import pq_adc as _pq_adc_kernel
from repro_torch.kernels.pq_lut import pq_lut as _pq_lut_kernel
from repro_torch.kernels.rerank import rerank as _rerank_kernel
from repro_torch.kernels.rerank import rerank_rows as _rerank_rows_kernel

BACKENDS = ("auto", "ref")


def _check(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def build_lut(queries: torch.Tensor, centroids: torch.Tensor, *,
              metric: str = "l2", backend: str = "auto") -> torch.Tensor:
    """(nq, d), (m, ks, dsub) -> (nq, m, ks) f32 per-query LUT."""
    _check(backend)
    if backend == "ref":
        return _ref.pq_lut_ref(queries, centroids, metric=metric)
    return _pq_lut_kernel(queries, centroids, metric=metric)


def adc(lut: torch.Tensor, codes: torch.Tensor, *, backend: str = "auto"
        ) -> torch.Tensor:
    """lut (nq, m, ks) or (m, ks); codes (n, m) -> (nq, n) or (n,)."""
    _check(backend)
    if backend == "ref":
        return _ref.adc_ref(lut, codes)
    return _pq_adc_kernel(lut, codes)


def fused_hop(chunk_words: torch.Tensor, frontier_ids: torch.Tensor,
              lut: torch.Tensor, queries: torch.Tensor, *,
              layout: ChunkLayout, metric: str = "l2", backend: str = "auto",
              adc_dtype: str = "f32"):
    """Batched AiSAQ hop, frontier_ids (nq, w) -> (exact, ids, nbr_d).

    adc_dtype="int8" runs the quantized ADC; the plain version emulates the
    same numerics by quantizing and dequantizing the LUT.
    """
    _check(backend)
    if backend == "ref":
        return _ref.fused_hop_ref(chunk_words, frontier_ids, lut, queries,
                                  layout, metric=metric, adc_dtype=adc_dtype)
    return _fused_hop_kernel(chunk_words, frontier_ids, lut, queries,
                             layout=layout, metric=metric, adc_dtype=adc_dtype)


def rerank(queries: torch.Tensor, cand: torch.Tensor, *, metric: str = "l2",
           backend: str = "auto") -> torch.Tensor:
    """Exact distances: (d,) x (c, d) -> (c,); (nq, d) x (c, d) or
    (nq, c, d) -> (nq, c)."""
    _check(backend)
    if backend == "ref":
        return _ref.rerank_ref(queries, cand, metric=metric)
    return _rerank_kernel(queries, cand, metric=metric)


def rerank_rows(queries: torch.Tensor, chunk_words: torch.Tensor,
                ids: torch.Tensor, layout: ChunkLayout, *,
                metric: str = "l2", backend: str = "auto") -> torch.Tensor:
    """Exact distances of (nq, r) candidate ids read from the chunk rows
    -> (nq, r); ids < 0 give +inf."""
    _check(backend)
    if backend == "ref":
        return _ref.rerank_rows_ref(queries, chunk_words, ids, layout,
                                    metric=metric)
    return _rerank_rows_kernel(queries, chunk_words, ids, layout,
                               metric=metric)
