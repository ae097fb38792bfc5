"""Shared NN layers (port of `repro.models.layers`): truncated-normal and
dense init, the relu MLP of the recommender; RMS norm, RoPE, GQA
attention with full, sliding-window and chunked masks (`flash_attention`
for inference, `flash_attention_vjp` with its hand-written backward for
training, `decode_attention` against a KV cache) and the SwiGLU MLP of
the language models.

Init draws from an explicit `torch.Generator` on an explicit device. The
distribution is the reference's (a standard normal truncated to [-2, 2],
times a scale); the bits are not, since JAX's keys have no torch
counterpart. Tests that compare the two carry JAX's parameters across.

The attention is an online softmax over KV blocks in torch (O(S * block)
memory), the reference's blockwise algorithm: no finished attention
kernel is called. Scores and `p @ v` accumulate in float32, as the
reference's `preferred_element_type=float32` einsums: two bfloat16
operands go through `torch.bmm(..., out_dtype=torch.float32)` on the card
(bfloat16 tensor cores, float32 accumulation and output) where this torch
has it, else both are widened to float32, which gives the same exact
products; any float32 operand makes the product a float32 one (TF32 stays
off, `device.full_fp32`). Blocks that the mask empties are skipped (an
empty block leaves the running max, sum and output exactly as they were),
and a block the mask fills whole is not masked, so one loop reproduces
both the reference's band-pruned and its full scans.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.device import DeviceLike, resolve_device

# the standard normal CDF at -2 and 2, mapped to erf's range [-1, 1]
_ERF_HI = math.erf(2.0 / math.sqrt(2.0))


def truncnorm_init(shape: Sequence[int], scale: float, *,
                   generator: torch.Generator, device: DeviceLike = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """scale * N(0, 1) truncated to [-2, 2], by inverting the CDF of a
    uniform draw between the two bounds (the truncated normal of
    `jax.random.truncated_normal`, whose variance is not rescaled).

    Every step runs in place on the one float32 buffer it draws, so a
    table takes its own size and no more (DLRM-rm2's largest table is
    10.2 GB)."""
    u = torch.empty(tuple(shape), dtype=torch.float32,
                    device=resolve_device(device))
    u.uniform_(-_ERF_HI, _ERF_HI, generator=generator)
    u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(scale)
    return u.to(dtype)


def init_dense(shape: Sequence[int], *, generator: torch.Generator,
               device: DeviceLike = None, dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """A (fan_in, fan_out) weight with scale fan_in ** -0.5 by default."""
    scale = scale if scale is not None else shape[0] ** -0.5
    return truncnorm_init(shape, scale, generator=generator, device=device,
                          dtype=dtype)


def mlp_stack(dims: Sequence[int], *, generator: torch.Generator,
              device: DeviceLike = None,
              dtype: torch.dtype = torch.float32) -> nn.ModuleList:
    """[(d0->d1), (d1->d2), ...] relu MLP: one {"w", "b"} per layer."""
    dev = resolve_device(device)
    return nn.ModuleList(
        nn.ParameterDict({
            "w": nn.Parameter(init_dense((dims[i], dims[i + 1]),
                                         generator=generator, device=dev,
                                         dtype=dtype)),
            "b": nn.Parameter(torch.zeros((dims[i + 1],), dtype=dtype,
                                          device=dev))})
        for i in range(len(dims) - 1))


def mlp_apply(layers, x: torch.Tensor, final_act: bool = False
              ) -> torch.Tensor:
    """x @ w + b per layer, relu between layers (and after the last one
    when final_act)."""
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, in float32, cast back."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(dt)


def rope_angles(positions: torch.Tensor, hd: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotary angles, (..., S, 1, hd // 2) float32:
    positions * theta ** (-i / (hd / 2))."""
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), exps)
    ang = positions[..., :, None, None].to(torch.float32) * freq
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         angles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
         ) -> torch.Tensor:
    """Half-split rotary embedding. x: (..., S, H, hd), positions: (..., S)
    int. The rotation runs in float32 and the result is cast back to x's
    dtype. `angles`: `rope_angles(positions, hd, theta)`, when a caller
    rotates many tensors at the same positions."""
    half = x.shape[-1] // 2
    cos, sin = angles or rope_angles(positions, x.shape[-1], theta)
    x1f = x[..., :half].to(torch.float32)
    x2f = x[..., half:].to(torch.float32)
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention masks
# ---------------------------------------------------------------------------


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                window: int, chunked: bool) -> torch.Tensor:
    """(bq,), (bk,) position vectors -> (bq, bk) bool allowed-mask."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window > 0 and not chunked:
        m = m & (qp - kp < window)                        # sliding window
    if window > 0 and chunked:
        m = m & (torch.div(qp, window, rounding_mode="floor")
                 == torch.div(kp, window, rounding_mode="floor"))  # chunks
    return m


_BIG = 1 << 62


def _allowed_span(q_pos: np.ndarray, *, causal: bool, window: int,
                  chunked: bool) -> Tuple[np.ndarray, np.ndarray]:
    """For each query position, the inclusive range [lo, hi] of key
    positions `_block_mask` allows (an intersection of ranges)."""
    lo = np.zeros_like(q_pos)
    hi = np.full_like(q_pos, _BIG)
    if causal:
        hi = np.minimum(hi, q_pos)
    if window > 0 and not chunked:
        lo = np.maximum(lo, q_pos - window + 1)
    if window > 0 and chunked:
        c0 = q_pos // window * window
        lo = np.maximum(lo, c0)
        hi = np.minimum(hi, c0 + window - 1)
    return lo, hi


@functools.lru_cache(maxsize=512)
def _block_plan(Sq: int, Skv: int, q_off: int, causal: bool, window: int,
                chunked: bool, block_q: int, block_kv: int
                ) -> Tuple[Tuple[Tuple[int, bool], ...], ...]:
    """For each q block, the KV blocks that hold an allowed pair, each
    with `whole`: every pair of the block is allowed (no padded row or
    key, nothing masked), so its scores need no mask."""
    nq, nk = -(-Sq // block_q), -(-Skv // block_kv)
    plan = []
    for qi in range(nq):
        r0 = qi * block_q
        rows = np.arange(r0, min(r0 + block_q, Sq), dtype=np.int64) + q_off
        lo, hi = _allowed_span(rows, causal=causal, window=window,
                               chunked=chunked)
        padded_rows = r0 + block_q > Sq
        blocks = []
        for ki in range(nk):
            k0 = ki * block_kv
            k_last = min(k0 + block_kv, Skv) - 1
            if not np.any((lo <= k_last) & (hi >= k0) & (lo <= hi)):
                continue               # empty: an exact no-op, skipped
            whole = (not padded_rows and k0 + block_kv <= Skv
                     and bool(np.all(lo <= k0)) and bool(np.all(hi >= k_last)))
            blocks.append((ki, whole))
        plan.append(tuple(blocks))
    return tuple(plan)


def _band_bounds(qi: int, q_off: int, *, causal: bool, window: int,
                 chunked: bool, block_q: int, block_kv: int, nk: int
                 ) -> Tuple[int, int]:
    """kv-block range [lo, hi) intersecting q block `qi`'s allowed band
    (the reference's `_band_bounds`); `q_off` is the global position of
    q row 0. Every block outside it is empty for `_block_plan`."""
    q0 = qi * block_q + q_off
    hi = min((q0 + block_q + block_kv - 1) // block_kv, nk)
    if not causal:
        hi = nk
    lo = 0
    if window > 0 and not chunked:
        lo = max(0, (q0 - (window - 1)) // block_kv)
    if window > 0 and chunked:
        lo = q0 // window * window // block_kv
    return lo, hi


# ---------------------------------------------------------------------------
# float32-accumulating products
# ---------------------------------------------------------------------------


NEG_INF = -1e30

_BMM_OUT_F32: Dict[str, bool] = {}


def bf16_bmm_route(device: torch.device) -> str:
    """How `mm_f32` multiplies two bfloat16 operands on `device`:
    "bmm_out_f32" (bfloat16 tensor cores, float32 output) or "widen"
    (both widened to float32 first). Probed once per device type."""
    key = device.type
    if key not in _BMM_OUT_F32:
        ok = False
        if device.type == "cuda":
            a = torch.ones((1, 2, 2), dtype=torch.bfloat16, device=device)
            try:
                ok = torch.bmm(a, a, out_dtype=torch.float32).dtype \
                    == torch.float32
            except (TypeError, RuntimeError, NotImplementedError):
                ok = False
        _BMM_OUT_F32[key] = ok
    return "bmm_out_f32" if _BMM_OUT_F32[key] else "widen"


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b as float32, accumulated in float32 (the reference's
    `preferred_element_type=jnp.float32`). a: (n, i, k), b: (n, k, j)."""
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16 \
            and bf16_bmm_route(a.device) == "bmm_out_f32":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


# ---------------------------------------------------------------------------
# blockwise "flash" attention (O(S * block) memory)
# ---------------------------------------------------------------------------


def _rows_major(x: torch.Tensor, n: int, block: int, KVH: int
                ) -> torch.Tensor:
    """(B, S, H, hd) -> (B*KVH, n, G*block, hd), rows padded to n*block;
    q head h = kvh * G + g serves KV head kvh (the kv-major GQA layout)."""
    B, S, H, hd = x.shape
    G = H // KVH
    x = F.pad(x, (0, 0, 0, 0, 0, n * block - S))
    x = x.reshape(B, n, block, KVH, G, hd).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B * KVH, n, G * block, hd)


def _from_rows_major(x: torch.Tensor, B: int, S: int, KVH: int, G: int,
                     block: int) -> torch.Tensor:
    """Inverse of `_rows_major`: (B*KVH, n, G*block, hd) -> (B, S, H, hd)."""
    n, hd = x.shape[1], x.shape[-1]
    x = x.reshape(B, KVH, n, G, block, hd).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, n * block, KVH * G, hd)[:, :S]


def _kv_major(x: torch.Tensor, nk: int, block: int) -> torch.Tensor:
    """(B, S, KVH, hd) -> (B*KVH, nk*block, hd), keys padded."""
    B, S, KVH, hd = x.shape
    x = F.pad(x, (0, 0, 0, 0, 0, nk * block - S))
    return x.permute(0, 2, 1, 3).reshape(B * KVH, nk * block, hd)


class _Blocks:
    """One attention call's geometry: padded sizes, the block plan and
    the (bq, bk) masks of the blocks that need one."""

    def __init__(self, q: torch.Tensor, k: torch.Tensor, q_off: int,
                 causal: bool, window: int, chunked: bool, block_q: int,
                 block_kv: int):
        self.B, self.Sq, self.H, self.hd = q.shape
        self.Skv, self.KVH = k.shape[1], k.shape[2]
        self.G = self.H // self.KVH
        if q.is_meta:
            # a shape trace (`launch.dryrun`): at most 8 blocks a side,
            # so a 32k-token trace runs at most 64 block pairs; the flops
            # it counts skip the empty blocks at that coarser grain
            block_q = max(block_q, -(-self.Sq // 8))
            block_kv = max(block_kv, -(-self.Skv // 8))
        self.bq, self.bk = block_q, block_kv
        self.nq, self.nk = -(-self.Sq // block_q), -(-self.Skv // block_kv)
        self.q_off = int(q_off)
        self.kw = dict(causal=causal, window=window, chunked=chunked)
        self.plan = _block_plan(self.Sq, self.Skv, self.q_off, causal,
                                window, chunked, block_q, block_kv)
        self.dev = q.device
        self._ar_q = torch.arange(block_q, device=self.dev)
        self._ar_k = torch.arange(block_kv, device=self.dev)

    def mask(self, qi: int, ki: int) -> torch.Tensor:
        """(1, G, bq, bk) allowed-mask of block (qi, ki), padded query
        rows and keys excluded (the reference's masks)."""
        q_pos = self.q_off + qi * self.bq + self._ar_q
        k_pos = ki * self.bk + self._ar_k
        m = _block_mask(q_pos, k_pos, **self.kw)
        m = m & (k_pos < self.Skv)[None, :] \
            & (q_pos - self.q_off < self.Sq)[:, None]
        return m[None, None]


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   geo: _Blocks):
    """out (B, Sq, H, hd) in q's dtype and lse (B*KVH, nq, G*bq) float32
    (the reference's `_flash_body`). Differentiable by autograd (no
    in-place step), which the inference path never asks of it."""
    B, KVH, G, bq, bk = geo.B, geo.KVH, geo.G, geo.bq, geo.bk
    scale = geo.hd ** -0.5
    # the scale is applied in q's dtype, as the reference's forward does
    qr = _rows_major(q, geo.nq, bq, KVH) * scale
    kr = _kv_major(k, geo.nk, bk)
    vr = _kv_major(v, geo.nk, bk)
    n = B * KVH
    outs, lses = [], []
    for qi, blocks in enumerate(geo.plan):
        qb = qr[:, qi]                                  # (n, G*bq, hd)
        m_run = torch.full((n, G * bq), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((n, G * bq), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((n, G * bq, geo.hd), dtype=torch.float32,
                          device=q.device)
        for ki, whole in blocks:
            kb = kr[:, ki * bk:(ki + 1) * bk]
            vb = vr[:, ki * bk:(ki + 1) * bk]
            s = mm_f32(qb, kb.transpose(1, 2))          # (n, G*bq, bk)
            if not whole:
                mask = geo.mask(qi, ki)
                s = s.view(B, KVH, G, bq, bk).masked_fill(~mask, NEG_INF) \
                    .view(n, G * bq, bk)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            if not whole:
                # an empty row: exp(NEG_INF - NEG_INF) = 1, zeroed here
                p = p.view(B, KVH, G, bq, bk).masked_fill(~mask, 0.0) \
                    .view(n, G * bq, bk)
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            pv = mm_f32(p.to(vb.dtype), vb)
            acc = acc * corr[..., None] + pv
            m_run = m_new
        l_safe = torch.clamp(l_run, min=1e-30)
        outs.append((acc / l_safe[..., None]).to(q.dtype))
        lses.append(m_run + torch.log(l_safe))
    out = torch.stack(outs, dim=1)                       # (n, nq, G*bq, hd)
    return (_from_rows_major(out, B, geo.Sq, KVH, G, bq),
            torch.stack(lses, dim=1))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    chunked: bool = False, block_q: int = 512,
                    block_kv: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Memory-efficient GQA attention. q: (B, Sq, H, hd); k, v: (B, Skv,
    KVH, hd) with H % KVH == 0. Online softmax over KV blocks a Q block at
    a time. The blocks a mask empties are always skipped (the reference's
    `skip_blocks` band pruning), which changes no result (see the module
    docstring)."""
    geo = _Blocks(q, k, q_offset, causal, window, chunked, block_q,
                  block_kv)
    return _flash_forward(q, k, v, geo)[0]


def _flash_backward(q, k, v, out, lse, dout, geo: _Blocks):
    """dq, dk, dv (the reference's `_flash_bwd`, FA2 style): p is
    recomputed from the saved lse, the same blocks are skipped."""
    B, KVH, G, bq, bk = geo.B, geo.KVH, geo.G, geo.bq, geo.bk
    scale = geo.hd ** -0.5
    f32 = torch.float32
    n = B * KVH
    # the backward scales q in float32, as the reference's does
    qr = _rows_major(q.to(f32), geo.nq, bq, KVH) * scale
    dor = _rows_major(dout.to(f32), geo.nq, bq, KVH)
    orr = _rows_major(out.to(f32), geo.nq, bq, KVH)
    Drow = torch.sum(dor * orr, dim=-1)                  # (n, nq, G*bq)
    kr = _kv_major(k.to(f32), geo.nk, bk)
    vr = _kv_major(v.to(f32), geo.nk, bk)
    dk_acc = torch.zeros_like(kr)
    dv_acc = torch.zeros_like(vr)
    dqs = []
    for qi, blocks in enumerate(geo.plan):
        qb, dob = qr[:, qi], dor[:, qi]
        Db, lseb = Drow[:, qi], lse[:, qi]
        dq_b = torch.zeros_like(qb)
        for ki, whole in blocks:
            sl = slice(ki * bk, (ki + 1) * bk)
            kb, vb = kr[:, sl], vr[:, sl]
            s = torch.bmm(qb, kb.transpose(1, 2))
            p = torch.exp(s - lseb[..., None])
            if not whole:
                p = p.view(B, KVH, G, bq, bk).masked_fill(
                    ~geo.mask(qi, ki), 0.0).view(n, G * bq, bk)
            dv_acc[:, sl] += torch.bmm(p.transpose(1, 2), dob)
            dp = torch.bmm(dob, vb.transpose(1, 2))
            ds = p * (dp - Db[..., None])
            dq_b = dq_b + torch.bmm(ds, kb)
            dk_acc[:, sl] += torch.bmm(ds.transpose(1, 2), qb)
        dqs.append(dq_b * scale)
    dq = _from_rows_major(torch.stack(dqs, dim=1), B, geo.Sq, KVH, G, bq)

    def kv_back(x, like):
        x = x.reshape(B, KVH, geo.nk * bk, geo.hd).permute(0, 2, 1, 3)
        return x[:, :geo.Skv].to(like.dtype)
    return dq.to(q.dtype), kv_back(dk_acc, k), kv_back(dv_acc, v)


class _FlashVJP(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse); backward is `_flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, causal, window, chunked, block_q,
                block_kv):
        geo = _Blocks(q, k, q_off, causal, window, chunked, block_q,
                      block_kv)
        out, lse = _flash_forward(q, k, v, geo)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.geo = geo
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, dout, ctx.geo)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_off: int = 0, causal: bool = True, window: int = 0,
                        chunked: bool = False, block_q: int = 512,
                        block_kv: int = 1024) -> torch.Tensor:
    """`flash_attention` with the reference's custom VJP: O(S) residuals
    (out and the row log-sum-exp), and the backward recomputes each
    block's probabilities, skipping the same empty blocks in both
    passes. `q_off` is the global position of q row 0."""
    return _FlashVJP.apply(q, k, v, int(q_off), causal, window, chunked,
                           block_q, block_kv)


def _decode_scores(q: torch.Tensor, k_cache: torch.Tensor,
                   qpos: torch.Tensor, k_lo: int, window: int,
                   chunked: bool) -> torch.Tensor:
    """(B, H, T) float32 scores of the new token (at positions qpos, (B,))
    against caches holding positions [k_lo, k_lo + T), the masked ones
    NEG_INF. q is laid out block-diagonally, (H, KVH*hd) with head h's
    row non-zero only in its KV head's hd columns, so the scores are one
    float32-accumulating batched product (the zeros add exact zeros)."""
    B, _, H, hd = q.shape
    T, KVH = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(B, KVH, H // KVH, hd) * hd ** -0.5
    eye = torch.eye(KVH, dtype=q.dtype, device=q.device)
    qd = (qr[:, :, :, None, :] * eye[None, :, None, :, None]) \
        .reshape(B, H, KVH * hd)
    s = mm_f32(qd, k_cache.reshape(B, T, KVH * hd).transpose(1, 2))
    pos = k_lo + torch.arange(T, device=q.device)
    qpos = qpos.to(pos.dtype)
    ok = pos[None, :] <= qpos[:, None]
    if window > 0 and not chunked:
        ok = ok & (qpos[:, None] - pos[None, :] < window)
    if window > 0 and chunked:
        ok = ok & (torch.div(pos[None, :], window, rounding_mode="floor")
                   == torch.div(qpos[:, None], window, rounding_mode="floor"))
    return torch.where(ok[:, None, :], s, NEG_INF)


def _decode_heads(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """(B, H, hd) float32: `p @ v` over the cache read once as a (T,
    KVH*hd) matrix, whose diagonal blocks are the heads' outputs."""
    B, H, T = p.shape
    KVH, hd = v_cache.shape[2], v_cache.shape[3]
    r = mm_f32(p.to(v_cache.dtype), v_cache.reshape(B, T, KVH * hd))
    out = torch.diagonal(r.view(B, KVH, H // KVH, KVH, hd), dim1=1, dim2=3)
    return out.permute(0, 3, 1, 2).reshape(B, H, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int = 0, chunked: bool = False) -> torch.Tensor:
    """Single-token decode. q: (B, 1, H, hd); caches: (B, T, KVH, hd);
    cache_len (B,) int, the new token at position cache_len - 1. Each
    product reads the cache once (`_decode_scores`, `_decode_heads`)."""
    B, _, H, hd = q.shape
    s = _decode_scores(q, k_cache, cache_len - 1, 0, window, chunked)
    out = _decode_heads(torch.softmax(s, dim=-1), v_cache)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_sp(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, qpos: torch.Tensor,
                        k_lo: int, group, *, window: int = 0,
                        chunked: bool = False) -> torch.Tensor:
    """`decode_attention` over a sequence cut across the ranks of `group`
    (sequence-parallel decode): this rank's caches (B, T_l, KVH, hd) hold
    positions [k_lo, k_lo + T_l), qpos (B,) is the new token's position.
    Each rank scores its block; the softmax's max is all-reduced, then the
    rank's unnormalised outputs and sums in one float32 all-reduce, and
    their quotient is the attention."""
    from repro_torch.launch.mesh import all_reduce
    B, _, H, hd = q.shape
    s = _decode_scores(q, k_cache, qpos, k_lo, window, chunked)
    top = all_reduce(s.amax(dim=-1, keepdim=True), group, "max")
    p = torch.exp(s - top)                                # (B, H, T_l)
    out = _decode_heads(p, v_cache).reshape(B, H * hd)
    tot = all_reduce(torch.cat([out, p.sum(-1)], dim=-1), group)
    out = tot[:, :H * hd].view(B, H, hd) / tot[:, H * hd:, None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# mlp
# ---------------------------------------------------------------------------


def init_swiglu(d_model: int, d_ff: int, *, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """{"w_gate", "w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {"w_gate": truncnorm_init((d_model, d_ff), d_model ** -0.5, **kw),
            "w_up": truncnorm_init((d_model, d_ff), d_model ** -0.5, **kw),
            "w_down": truncnorm_init((d_ff, d_model), d_ff ** -0.5, **kw)}


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    """(silu(x @ w_gate) * (x @ w_up)) @ w_down, in x's dtype."""
    g = F.silu(x @ p["w_gate"])
    return ((g * (x @ p["w_up"])) @ p["w_down"]).to(x.dtype)
