"""Exact rerank distances (`csrc/aisaq_kernels.cu` `rerank_kernel`,
replacing `repro/kernels/rerank.py:_rerank_kernel`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


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
