"""Bulk asymmetric distance computation over PQ codes
(`csrc/aisaq_kernels.cu` `pq_adc_kernel`, replacing
`repro/kernels/pq_adc.py:_adc_kernel` and `_adc_q8_kernel`).

out[q, r] = sum_j lut[q, j, codes[r, j]]: the scoring of every candidate
row against a query's LUT, as in the recommender's AiSAQ-mode retrieval.
Any m is accepted (the Pallas body needs m % 8 == 0).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

_MAX_QUERIES = 65535          # the kernel's grid.y


def _launch(lut: torch.Tensor, codes: torch.Tensor, quantized: bool
            ) -> torch.Tensor:
    nq, m, ks = lut.shape
    n = codes.shape[0]
    if codes.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"codes: expected torch.uint8 or torch.int32, got "
                        f"{codes.dtype}")
    if nq > _MAX_QUERIES:
        raise ValueError(f"at most {_MAX_QUERIES} queries a launch, got {nq}")
    _build.require(codes, "codes", codes.dtype, (n, m))
    _build.require(lut, "lut", torch.float32, (nq, m, ks))
    out = torch.empty((nq, n), dtype=torch.float32, device=lut.device)
    i32 = codes.dtype == torch.int32
    lib = _build.lib()
    if quantized:
        lut_q8, scale = ref.quantize_lut(lut)
        scale127 = (scale / 127.0).contiguous()
        err = lib.aisaq_pq_adc_int8(codes.data_ptr(), n, m, i32,
                                    lut_q8.data_ptr(), scale127.data_ptr(),
                                    nq, ks, out.data_ptr(), _build.stream())
        name = "pq_adc_q8"
    else:
        err = lib.aisaq_pq_adc_f32(codes.data_ptr(), n, m, i32,
                                   lut.data_ptr(), nq, ks, out.data_ptr(),
                                   _build.stream())
        name = "pq_adc"
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
    gives (n,). The LUT is quantized per query (`ref.quantize_lut`), the
    int8 entries are summed exactly in int32 and rescaled once by
    scale/127, so the error per distance is at most m * max|lut| / 127.

    CUDA tensors launch the kernel; CPU tensors take `ref.pq_adc_q8_ref`.
    """
    if not _build.on_cuda(lut, codes):
        return ref.pq_adc_q8_ref(lut, codes)
    squeeze = lut.ndim == 2
    out = _launch(lut[None] if squeeze else lut, codes, quantized=True)
    return out[0] if squeeze else out
