"""Per-query PQ distance LUT (`csrc/aisaq_kernels.cu` `pq_lut_kernel`,
replacing `repro/kernels/pq_lut.py:_lut_kernel`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def pq_lut(queries: torch.Tensor, centroids: torch.Tensor, *,
           metric: str = "l2") -> torch.Tensor:
    """(nq, d) x (m, ks, dsub) -> (nq, m, ks) f32 LUT in the expanded form.

    CUDA tensors launch the kernel; CPU tensors take `ref.pq_lut_ref`.
    """
    if not _build.on_cuda(queries, centroids):
        return ref.pq_lut_ref(queries, centroids, metric=metric)
    nq, d = queries.shape
    m, ks, dsub = centroids.shape
    if m * dsub != d:
        raise ValueError(f"centroids {tuple(centroids.shape)} do not split "
                         f"d={d}")
    _build.require(queries, "queries", torch.float32, (nq, d))
    _build.require(centroids, "centroids", torch.float32, (m, ks, dsub))
    out = torch.empty((nq, m, ks), dtype=torch.float32,
                      device=queries.device)
    err = _build.lib().aisaq_pq_lut(
        queries.data_ptr(), nq, centroids.data_ptr(), m, ks, dsub,
        metric == "mips", out.data_ptr(), _build.stream())
    _build.check(err, "pq_lut")
    _build.count_launch("pq_lut")
    return out
