"""PQ LUT / ADC numerics of the storage-backed search, on an explicit
device (port of `repro.core.adc`, whose numpy functions are the twins).

Every function takes tensors and computes on their device: the card in a
served search, the CPU in the tests. The batch LUT is
`kernels.pq_lut.pq_lut` (the kernel on CUDA tensors, its plain version on
CPU tensors), which computes the function of the reference's einsum in the
expanded form. The gathers and sums below are plain torch ops; on the CPU
their sums run left to right (`ref.sum_in_order`), so every result row
depends on its own inputs only, and a batch of one gives the bits of the
full batch (the scalar oracle's guarantee in `core.traversal`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.pq_lut import pq_lut
from repro_torch.kernels.ref import INV127, adc_ref, quantize_lut, \
    sum_in_order

__all__ = ["build_lut", "build_lut_batch", "adc", "quantize_lut",
           "adc_int8", "host_lut_int8", "adc_gather"]


def build_lut_batch(centroids: torch.Tensor, Q: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """centroids (m, ks, dsub), Q (nq, d) -> (nq, m, ks) f32 LUTs."""
    return pq_lut(Q.float().contiguous(), centroids, metric=metric)


def build_lut(centroids: torch.Tensor, q: torch.Tensor,
              metric: str) -> torch.Tensor:
    """centroids (m, ks, dsub), q (d,) -> (m, ks) f32 LUT: the batch LUT
    of one query."""
    return build_lut_batch(centroids, q[None], metric)[0]


def adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (m, ks), codes (..., m) -> (...,) f32 (`ref.adc_ref`'s gather
    and in-order sum)."""
    m = lut.shape[0]
    return adc_ref(lut, codes.reshape(-1, m)).reshape(codes.shape[:-1])


def adc_int8(lut_q8: torch.Tensor, scale: torch.Tensor,
             codes: torch.Tensor) -> torch.Tensor:
    """int8 ADC: lut_q8 (m, ks) int8, codes (..., m) -> (...,) f32. A
    scalar `scale` sums the int8 entries exactly in int32 and rescales
    once; a per-subspace (m,) `scale` dequantizes each entry first (the
    host recipe)."""
    m = lut_q8.shape[0]
    j = torch.arange(m, device=lut_q8.device)
    g = lut_q8[j, codes.long()]
    if scale.ndim == 0:
        return g.sum(-1, dtype=torch.int32).float() * (scale * float(INV127))
    return sum_in_order(g.float() * (scale * float(INV127)))


def host_lut_int8(lut: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The storage search's int8 LUT (twin of `np_host_lut_int8`): one
    mid-centred symmetric scale per (query, subspace). Subtracting each
    subspace's minimum shifts every ADC distance of a query by one
    constant, so the ranking is unchanged, and the step shrinks from
    max|lut|/127 to (subspace range)/254.

    lut (..., m, ks) f32 -> (lut_q8 (..., m, ks) int8, scale (..., m) f32).
    The arithmetic is `quantize_lut`'s on each subspace row, done in place
    on one temporary: at batch 64 and SIFT1M widths the LUT is 8.4 MB.
    """
    mid = lut.float() - lut.amin(dim=-1, keepdim=True)
    mid -= mid.amax(dim=-1, keepdim=True) * 0.5
    # max|mid| without an |mid| temporary (negation is exact)
    scale = torch.maximum(mid.amax(dim=-1), -mid.amin(dim=-1))
    mid /= torch.clamp_min(scale, 1e-20)[..., None]
    lut_q8 = mid.mul_(127.0).round_().clamp_(-127, 127).to(torch.int8)
    return lut_q8, scale


#: rows of one adc_gather step: bounds its temporaries (index, gathered
#: entries, products) to ~4 MB at m = 128, whatever the hop's fresh count
ADC_ROWS = 2048


def adc_gather(lut_g: torch.Tensor, dq: Optional[torch.Tensor],
               qidx: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The batched ADC of the storage search and the nav beam: row i is
    query qidx[i]'s distance to the codes codes[i].

    lut_g (nq, m, ks) f32, or int8 with dq (nq, m) f32 dequant factors
    (the int8 scale times float32(1/127)); qidx (F,) int; codes (F, m)
    int -> (F,) f32, on lut_g's device, ADC_ROWS rows at a time.
    """
    nq, m, ks = lut_g.shape
    dev = lut_g.device
    flat = lut_g.reshape(-1)
    col = (torch.arange(m, device=dev, dtype=torch.int32) * ks)[None, :]
    out = torch.empty(qidx.shape[0], dtype=torch.float32, device=dev)
    for lo in range(0, qidx.shape[0], ADC_ROWS):
        qi = qidx[lo:lo + ADC_ROWS].to(torch.int32)
        lin = codes[lo:lo + ADC_ROWS].to(torch.int32) + col \
            + (qi * (m * ks))[:, None]
        g = flat.index_select(0, lin.reshape(-1)).reshape(lin.shape)
        if dq is not None:
            g = g.float() * dq[qi.long()]
        out[lo:lo + ADC_ROWS] = sum_in_order(g)
    return out
