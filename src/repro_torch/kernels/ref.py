"""Plain PyTorch versions of every kernel of the device search path.

Twins of `repro.kernels.ref`, with the query batch written out where the
reference is vmapped. The CPU tests hold them against the JAX package, the
wrappers run them on CPU tensors, and `chip_smoke.py` holds the CUDA
kernels against them on the card.

Chunk rows are int32 *words* (device_stride/4 per row): 4-byte aligned
fields make ids single words and uint8 fields unpack with shifts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chunk_layout import ChunkLayout
from repro_torch.device import full_fp32

# the int8 rescale: an int32 sum (or an int8 entry) times scale * INV127.
# Under jax.jit, XLA rewrites the reference's `scale / 127.0` as a multiply
# by this rounded reciprocal (0x3C010204), and the host path writes it out
# (repro/core/adc.py); a true quotient differs in the last bit on ~4% of
# scales.
INV127 = np.float32(1 / 127)


def rescale127(scale: torch.Tensor) -> torch.Tensor:
    """scale * float32(1/127) in float32, as the jitted reference rescales.
    The Python scalar is a float32 value, and a float32 tensor's product
    with a scalar is one float32 multiply on either device (and stays
    capturable in a CUDA graph, unlike a new constant tensor)."""
    return scale * float(INV127)


# ---------------------------------------------------------------------------
# word-level parsing helpers
# ---------------------------------------------------------------------------


def unpack_u8(words: torch.Tensor) -> torch.Tensor:
    """int32 (..., W) -> (..., W*4) int32 values in [0,255] (little-endian)."""
    # built on the device (no host copy), so the function can be captured
    # in a CUDA graph for timing
    shifts = torch.arange(4, dtype=torch.int32, device=words.device) * 8
    b = (words[..., None] >> shifts) & 0xFF
    return b.reshape(words.shape[:-1] + (words.shape[-1] * 4,))


def parse_chunks_words(words: torch.Tensor, layout: ChunkLayout):
    """words (..., stride/4) int32 rows gathered from the chunk table.

    Returns (vec f32 (..., dim), deg (...,), ids (..., R) i32,
    codes (..., R, m) i32 or None for diskann-mode layouts).
    """
    d, R, m = layout.dim, layout.R, layout.pq_m
    if layout.data_dtype == "uint8":
        nw = (d + 3) // 4
        vec = unpack_u8(words[..., :nw])[..., :d].float()
    else:
        vec = words[..., :d].contiguous().view(torch.float32)
    deg = words[..., layout.dev_off_deg // 4]
    o = layout.dev_off_ids // 4
    ids = words[..., o:o + R]
    codes = None
    if layout.mode == "aisaq":
        if m % 4:
            raise ValueError("pq_m must be a multiple of 4 for word layout")
        o = layout.dev_off_pq // 4
        codes = unpack_u8(words[..., o:o + R * m // 4]) \
            .reshape(words.shape[:-1] + (R, m))
    return vec, deg, ids, codes


# ---------------------------------------------------------------------------
# kernel plain versions
# ---------------------------------------------------------------------------


def quantize_lut(lut: torch.Tensor):
    """Symmetric per-query int8 LUT quantization (the reference recipe).

    lut (nq, m, ks) f32 -> (lut_q8 (nq, m, ks) int8, scale (nq,) f32);
    dequantization is lut_q8 * rescale127(scale). `torch.round` rounds
    half to even, as jnp.round and np.round do, so the codes are bit-equal.
    """
    scale = lut.abs().amax(dim=(1, 2))
    lut_q8 = torch.clamp(torch.round(
        lut / torch.clamp_min(scale[:, None, None], 1e-20) * 127.0),
        -127, 127).to(torch.int8)
    return lut_q8, scale


def dequantize_lut(lut: torch.Tensor) -> torch.Tensor:
    """The quantize-dequantize LUT whose entries the int8 kernels sum:
    lut_q8 * rescale127(scale), the reference's `ops.fused_hop` emulation
    as it runs under jax.jit."""
    lut_q8, scale = quantize_lut(lut)
    return lut_q8.float() * rescale127(scale)[:, None, None]


def pq_lut_ref(queries: torch.Tensor, centroids: torch.Tensor, *,
               metric: str) -> torch.Tensor:
    """(q, d), (m, ks, dsub) -> (q, m, ks) f32."""
    full_fp32()
    q = queries.shape[0]
    m, ks, dsub = centroids.shape
    qs = queries.float().reshape(q, m, dsub)
    cross = torch.einsum("qmd,mkd->qmk", qs, centroids)
    if metric == "mips":
        return (-cross).contiguous()
    qn = (qs * qs).sum(-1)                                 # (q, m)
    cn = (centroids * centroids).sum(-1)                   # (m, ks)
    return (qn[:, :, None] - 2.0 * cross + cn[None, :, :]).contiguous()


def sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis. On the CPU the m entries are added left to
    right in float32, the order of the reference's XLA:CPU reduction: a
    pairwise sum rounds differently, and so does `cumsum`, which on the CPU
    carries a float64 accumulator; with int8 LUTs (sums of multiples of one
    step) that turns exact ties between neighbours into orderings that
    differ from the reference's. On the card no reference order applies,
    and one reduction replaces the m-1 elementwise adds."""
    if x.is_cuda:
        return x.sum(-1)
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def expand_rows_ref(chunk_words: torch.Tensor, frontier_ids: torch.Tensor,
                    queries: torch.Tensor, layout: ChunkLayout, *,
                    metric: str):
    """The part of a hop that needs only the chunk rows, in either mode.

    chunk_words (N, stride/4) int32; frontier_ids (nq, w) int32 (-1 pads);
    queries (nq, d). Returns (exact (nq, w) f32, nbr_ids (nq, w, R) i32,
    codes (nq, w, R, m) i32 or None in diskann mode, nvalid (nq, w, R)
    bool). Invalid frontier rows get +inf and invalid slots id -1.
    """
    safe = frontier_ids.long().clamp(0, chunk_words.shape[0] - 1)
    rows = chunk_words[safe]                              # (nq, w, S)
    vec, _, ids, codes = parse_chunks_words(rows, layout)
    fvalid = frontier_ids >= 0
    q = queries.float()[:, None, :]
    if metric == "mips":
        exact = -(vec * q).sum(-1)
    else:
        diff = vec - q
        exact = (diff * diff).sum(-1)
    exact = torch.where(fvalid, exact, torch.inf)
    nvalid = (ids >= 0) & fvalid[:, :, None]
    return exact, torch.where(nvalid, ids, -1), codes, nvalid


def adc_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (nq, m, ks) or (m, ks) f32, codes (n, m) int -> (nq, n) or (n,)
    f32 (gather semantics), each sum taken by `sum_in_order`."""
    squeeze = lut.ndim == 2
    lut = lut[None] if squeeze else lut
    nq, m, ks = lut.shape
    idx = codes.long() + torch.arange(m, device=lut.device) * ks
    out = sum_in_order(lut.reshape(nq, m * ks)[:, idx])
    return out[0] if squeeze else out


def pq_adc_q8_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """int8 ADC with the reference recipe: the LUT quantized per query
    (`quantize_lut`), its entries summed exactly in int32, and the sum
    rescaled once by scale * INV127. lut (nq, m, ks) or (m, ks) f32, codes
    (n, m) int -> (nq, n) or (n,) f32. The rescale is `rescale127`."""
    squeeze = lut.ndim == 2
    lut = lut[None] if squeeze else lut
    nq, m, ks = lut.shape
    lut_q8, scale = quantize_lut(lut)
    idx = codes.long() + torch.arange(m, device=lut.device) * ks
    acc = lut_q8.reshape(nq, m * ks)[:, idx].sum(-1, dtype=torch.int32)
    out = acc.float() * rescale127(scale)[:, None]
    return out[0] if squeeze else out


def fused_hop_ref(chunk_words: torch.Tensor, frontier_ids: torch.Tensor,
                  lut: torch.Tensor, queries: torch.Tensor,
                  layout: ChunkLayout, *, metric: str,
                  adc_dtype: str = "f32"):
    """One AiSAQ beam-search hop for a batch of queries.

    chunk_words (N, stride/4) int32; frontier_ids (nq, w) int32 (-1 pads);
    lut (nq, m, ks) f32; queries (nq, d). Returns (exact (nq, w) f32,
    nbr_ids (nq, w, R) i32, nbr_d (nq, w, R) f32). Invalid frontier rows and
    neighbour slots get +inf distances and id -1. adc_dtype="int8" runs the
    ADC on the quantize-dequantize LUT, the numerics of the int8 kernel.
    """
    if layout.mode != "aisaq":
        raise NotImplementedError("fused_hop needs inline codes (aisaq mode)")
    if adc_dtype == "int8":
        lut = dequantize_lut(lut)
    elif adc_dtype != "f32":
        raise ValueError(f"adc_dtype must be 'f32' or 'int8', "
                         f"got {adc_dtype!r}")
    nq, w = frontier_ids.shape
    R, m, ks = layout.R, layout.pq_m, lut.shape[-1]
    exact, ids, codes, nvalid = expand_rows_ref(
        chunk_words, frontier_ids, queries, layout, metric=metric)
    flat = lut.reshape(nq, 1, 1, m * ks)
    idx = codes.long() + torch.arange(m, device=lut.device) * ks
    d = sum_in_order(torch.gather(flat.expand(nq, w, R, m * ks), 3, idx))
    return exact, ids, torch.where(nvalid, d, torch.inf)


def rerank_ref(queries: torch.Tensor, cand: torch.Tensor, *,
               metric: str) -> torch.Tensor:
    """Exact distances in the difference form.

    queries (d,) with cand (c, d) -> (c,); queries (nq, d) with cand (c, d)
    (one set for all queries) or (nq, c, d) (a set per query) -> (nq, c).
    """
    full_fp32()
    cand = cand.float()
    q = queries.float()
    if q.ndim == 1:
        q_b = q[None, :]
    elif cand.ndim == 3:
        q_b = q[:, None, :]
    else:
        q_b = q[:, None, :]
        cand = cand[None]
    if metric == "mips":
        return -(cand * q_b).sum(-1)
    diff = cand - q_b
    return (diff * diff).sum(-1)
