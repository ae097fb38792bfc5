"""Exact rerank distances (`csrc/aisaq_kernels.cu` `rerank_kernel`,
replacing `repro/kernels/rerank.py:_rerank_kernel`).

`rerank` takes the candidate vectors as a tensor; `rerank_rows` reads them
by id straight out of the chunk table's rows, so the serving path never
copies the rows."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.chunk_layout import ChunkLayout
from repro_torch.kernels import _build, ref

# the kernel's candidate sources (rerank_kernel<kSrc, NP>)
SOURCES = ("dense", "dense_any", "rows_f32", "rows_u8")


def rerank(queries: torch.Tensor, cand: torch.Tensor, *,
           metric: str = "l2") -> torch.Tensor:
    """Exact distances in the expanded form.

    queries (d,) with cand (c, d) -> (c,); queries (nq, d) with cand
    (c, d) shared by all queries or (nq, c, d), a set per query -> (nq, c).
    CUDA tensors launch the kernel (one launch for the whole batch); CPU
    tensors take `ref.rerank_ref`.
    """
    if not _build.on_cuda(queries, cand):
        return ref.rerank_ref(queries, cand, metric=metric)
    squeeze = queries.ndim == 1
    q = queries[None] if squeeze else queries
    nq, d = q.shape
    if cand.ndim == 3 and not squeeze:
        c, qstride = cand.shape[1], cand.shape[1] * d
        _build.require(cand, "cand", torch.float32, (nq, c, d))
    elif cand.ndim == 2:
        c, qstride = cand.shape[0], 0
        _build.require(cand, "cand", torch.float32, (c, d))
    else:
        raise ValueError(f"cand must be (c, d) or (nq, c, d), got "
                         f"{tuple(cand.shape)} for queries "
                         f"{tuple(queries.shape)}")
    _build.require(q, "queries", torch.float32, (nq, d))
    out = torch.empty((nq, c), dtype=torch.float32, device=q.device)
    err = _build.lib().aisaq_rerank(
        q.data_ptr(), nq, cand.data_ptr(), qstride, c, d, metric == "mips",
        out.data_ptr(), _build.stream())
    _build.check(err, "rerank")
    _build.count_launch("rerank")
    return out[0] if squeeze else out


def rerank_rows(queries: torch.Tensor, chunk_words: torch.Tensor,
                ids: torch.Tensor, layout: ChunkLayout, *,
                metric: str = "l2") -> torch.Tensor:
    """Exact distances of each query's candidates, read by id from the
    chunk table: queries (nq, d) f32, chunk_words (N, stride/4) int32, ids
    (nq, r) int32 -> (nq, r) f32. Ids clamp to N-1 above; an id < 0 gives
    +inf. f32 or u8 vectors as `layout.data_dtype` says.

    CUDA tensors launch the kernel (one launch, no torch op besides the
    output); CPU tensors take `ref.rerank_rows_ref`.
    """
    if not _build.on_cuda(queries, chunk_words, ids):
        return ref.rerank_rows_ref(queries, chunk_words, ids, layout,
                                   metric=metric)
    nq, r = ids.shape
    N, S = chunk_words.shape
    d = layout.dim
    if S * 4 != layout.device_stride:
        raise ValueError(f"chunk_words rows hold {S * 4} B, layout says "
                         f"{layout.device_stride}")
    _build.require(queries, "queries", torch.float32, (nq, d))
    _build.require(chunk_words, "chunk_words", torch.int32, (N, S))
    _build.require(ids, "ids", torch.int32, (nq, r))
    out = torch.empty((nq, r), dtype=torch.float32, device=queries.device)
    err = _build.lib().aisaq_rerank_rows(
        queries.data_ptr(), nq, chunk_words.data_ptr(), N, S, ids.data_ptr(),
        r, d, layout.data_dtype == "uint8", metric == "mips", out.data_ptr(),
        _build.stream())
    _build.check(err, "rerank_rows")
    _build.count_launch("rerank")
    return out


def rerank_occupancy(d: int, source: str) -> dict:
    """What the card makes of the kernel for vectors of d elements from
    `source` (one of SOURCES): registers a thread, static and dynamic shared
    memory, local (spill) bytes a thread, resident CTAs an SM, the passes
    of four elements a lane holds (`np`) and the candidates a CTA. Needs
    the card."""
    out = (ctypes.c_int * 7)()
    _build.check(_build.lib().aisaq_rerank_occupancy(
        SOURCES.index(source), d, out), "rerank_occupancy")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes",
            "ctas_per_sm", "np", "cands_per_cta")
    return dict(zip(keys, list(out)))
