"""Decoder-only LM: dense or MoE, full / sliding / chunked-global attention
(port of `repro.models.transformer`).

Parameters live in one `LM` module whose leaves keep the reference's
stacked (L, ...) layer shapes and its tree paths (`embed`, `final_norm`,
`lm_head`, `layers/attn/w_q`, `layers/moe/shared/w_up`, ...), so
`optim.adamw.param_tree`, the optimizer's per-leaf rule and the
checkpoints match the reference leaf for leaf. A forward unbinds each
stacked leaf once into per-layer views (under autograd the layers'
gradients are stacked back in one pass) and runs the layers in a loop;
training checkpoints each layer (`torch.utils.checkpoint`) when
`cfg.remat`, and each chunk of the loss, so the (B, S, V) logits are never
held: a 4,096-token batch of 4 would keep 1.24 GB a 512-token chunk.

Decode keeps an (L, B, T, KVH, hd) KV cache that each step updates in
place. Every entry point runs on the parameters' device; bfloat16
products reduce in float32 (`device.exact_reductions`).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import LMConfig
from repro_torch.device import DeviceLike, exact_reductions, \
    resolve_device, to_tensor
from repro_torch.distributed.act_sharding import cp_attention_wrap
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, init_moe, moe_apply, moe_apply_ep


def _moe_fn():
    """Global dispatch, or explicit expert parallelism over the installed
    grid's `model` axis under REPRO_MOE=ep (the reference's `_moe_fn`)."""
    return moe_apply_ep if os.environ.get("REPRO_MOE") == "ep" \
        else moe_apply


def _dt(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class LMLayers(nn.Module):
    """The stacked layer leaves: `attn` (w_q, w_k, w_v, w_o; b_q, b_k, b_v
    with QKV bias; q_norm, k_norm with qk-norm), `ln1`, `ln2`, and `ffn`
    (a SwiGLU) or `moe` (`models.moe.MoE`)."""

    def __init__(self, p: Dict):
        super().__init__()
        self.attn = nn.ParameterDict(
            {n: nn.Parameter(t) for n, t in p["attn"].items()})
        self.ln1 = nn.Parameter(p["ln1"])
        self.ln2 = nn.Parameter(p["ln2"])
        if "ffn" in p:
            self.ffn = nn.ParameterDict(
                {n: nn.Parameter(t) for n, t in p["ffn"].items()})
        else:
            self.moe = MoE(p["moe"])

    def per_layer(self) -> List[Dict]:
        """One nested dict of (…)-shaped views a layer."""
        out: List[Dict] = []
        for name, p in self.named_parameters():
            parts = name.split(".")
            for li, t in enumerate(p.unbind(0)):
                if li == len(out):
                    out.append({})
                d = out[li]
                for c in parts[:-1]:
                    d = d.setdefault(c, {})
                d[parts[-1]] = t
        return out


class LM(nn.Module):
    """`embed` (V, D), `layers` (`LMLayers`), `final_norm` (D,) and, unless
    the embeddings are tied, `lm_head` (D, V).

    A model that holds only this rank's blocks of its leaves (a sharded
    train state) carries `gather`, a `distributed.sharding.LeafGather`:
    every forward gathers each leaf at use, one layer at a time."""

    gather = None

    def __init__(self, embed: torch.Tensor, layers: LMLayers,
                 final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.layers = layers
        self.final_norm = nn.Parameter(final_norm)
        if lm_head is not None:
            self.lm_head = nn.Parameter(lm_head)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _init_layer(cfg: LMConfig, *, generator: torch.Generator,
                device: torch.device, n_pad: int) -> Dict:
    """One layer's parameters (the reference's `init_layer`), a nested
    dict."""
    dt = _dt(cfg)
    D, Hhd, KVhd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    kw = dict(generator=generator, device=device, dtype=dt)
    s = D ** -0.5
    attn = {"w_q": L.truncnorm_init((D, Hhd), s, **kw),
            "w_k": L.truncnorm_init((D, KVhd), s, **kw),
            "w_v": L.truncnorm_init((D, KVhd), s, **kw),
            "w_o": L.truncnorm_init((Hhd, D), Hhd ** -0.5, **kw)}
    if cfg.qkv_bias:
        for n, w in (("b_q", Hhd), ("b_k", KVhd), ("b_v", KVhd)):
            attn[n] = torch.zeros((w,), dtype=dt, device=device)
    if cfg.qk_norm:
        for n in ("q_norm", "k_norm"):
            attn[n] = torch.ones((cfg.head_dim,), device=device)
    p = {"attn": attn, "ln1": torch.ones((D,), device=device),
         "ln2": torch.ones((D,), device=device)}
    if cfg.moe is None:
        p["ffn"] = L.init_swiglu(D, cfg.d_ff, **kw)
    else:
        p["moe"] = init_moe(D, cfg.moe, n_pad_experts=n_pad, **kw)
    return p


def _stack_into(leaves: Optional[Dict], layer: Dict, li: int,
                n_layers: int) -> Dict:
    """Copy one layer's nested dict into the (L, ...) leaves, made at the
    first layer."""
    out = {} if leaves is None else leaves
    for n, t in layer.items():
        if isinstance(t, dict):
            out[n] = _stack_into(out.get(n), t, li, n_layers)
            continue
        if n not in out:
            out[n] = torch.empty((n_layers,) + tuple(t.shape),
                                 dtype=t.dtype, device=t.device)
        out[n][li].copy_(t)
    return out


def init_lm(cfg: LMConfig, *, generator: torch.Generator,
            device: DeviceLike = None, ep: int = 1) -> LM:
    """Random parameters with the reference's shapes, scales and dtypes
    on `device` (default: the card), drawn from `generator`. `ep`: size of
    an expert-parallel axis (experts padded to a multiple).

    Layers are drawn one at a time into the stacked leaves (the
    reference's vmap over per-layer keys), so the float32 draw is one
    layer's leaf, not the stack's: Scout's stacked expert leaf is 10.7 GB
    at 8 layers in bfloat16, its float32 draw would be 21.5 GB."""
    dev = resolve_device(device)
    dt = _dt(cfg)
    n_pad = 0 if cfg.moe is None else \
        cfg.moe.padded_experts(ep) - cfg.moe.n_experts
    leaves = None
    for li in range(cfg.n_layers):
        layer = _init_layer(cfg, generator=generator, device=dev,
                            n_pad=n_pad)
        leaves = _stack_into(leaves, layer, li, cfg.n_layers)
        del layer
    kw = dict(generator=generator, device=dev, dtype=dt)
    embed = L.truncnorm_init((cfg.vocab_size, cfg.d_model), 0.02, **kw)
    head = None if cfg.tie_embeddings else L.truncnorm_init(
        (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5, **kw)
    return LM(embed, LMLayers(leaves),
              torch.ones((cfg.d_model,), device=dev), head)


def _np_tensor(a, dev: torch.device) -> torch.Tensor:
    """A reference leaf (numpy, or anything `np.asarray` takes) on `dev`;
    bfloat16 (`ml_dtypes.bfloat16`, which torch cannot read) moves as its
    16-bit pattern and is viewed as torch.bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.to(dev).view(torch.bfloat16)
    return to_tensor(a, dev)


def lm_params_from_jax(tree: Dict, *, device: DeviceLike = None) -> LM:
    """The JAX package's LM parameter pytree (`init_lm`'s) into the port's
    `LM` on `device`, leaf for leaf, dtypes kept."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _np_tensor(x, dev)

    p = conv(dict(tree))
    return LM(p["embed"], LMLayers(p["layers"]), p["final_norm"],
              p.get("lm_head"))


def _is_global_layer(cfg: LMConfig, li: int) -> bool:
    """llama4 iRoPE: every `global_every`-th layer attends globally (NoPE)."""
    return (li % cfg.global_every) == (cfg.global_every - 1)


# ---------------------------------------------------------------------------
# attention (one layer)
# ---------------------------------------------------------------------------


def _mask_of(cfg: LMConfig, li: int) -> Tuple[int, bool, bool]:
    """(window, chunked, global) of layer li."""
    if cfg.attention == "sliding":
        return cfg.window, False, False
    if cfg.attention == "chunked_global":
        if _is_global_layer(cfg, li):
            return 0, False, True
        return cfg.window, True, False
    return 0, False, False


def _attn(p: Dict, x: torch.Tensor, cfg: LMConfig, *,
          positions: torch.Tensor, li: int,
          cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          cache_pos: Optional[int] = None, train: bool = False,
          angles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          seq: Optional[Tuple[Any, int]] = None):
    """One layer's attention. Without a cache: causal flash attention
    (training through `flash_attention_vjp`, with blocks of at most 512
    queries and 1,024 keys). With one: the new keys and values are
    written into the cache in place at `cache_pos` and the token attends
    to the cache. `seq` = (process group, first position): the cache is
    this rank's block of a sequence cut over the group, `cache_pos` a
    0-d tensor; the rank holding it writes the new keys, and the token
    attends over every rank's block (`decode_attention_sp`). `angles`:
    the rotary cos and sin of `positions`, shared by the layers of one
    forward."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    window, chunked, glob = _mask_of(cfg, li)
    if not glob:                      # llama4's global layers are NoPE
        q = L.rope(q, positions, cfg.rope_theta, angles)
        k = L.rope(k, positions, cfg.rope_theta, angles)
    if cache is None:
        def flash(qq, kk, vv, off):
            # blocks adapt to a context-parallel rank's fewer q rows
            return L.flash_attention_vjp(qq, kk, vv, off, True, window,
                                         chunked, min(512, qq.shape[1]),
                                         min(1024, kk.shape[1]))
        # context-parallel attention: q rows sharded over `model` (train
        # and prefill), as the reference's `cp_attention_wrap` caller
        cp = cp_attention_wrap(flash, S)
        if cp is not None:
            o = cp(q, k, v)
        elif train:
            o = flash(q, k, v, 0)
        else:
            o = L.flash_attention(q, k, v, causal=True, window=window,
                                  chunked=chunked)
    elif seq is not None:
        kc, vc = cache                                 # (B, T_l, KVH, hd)
        group, lo = seq
        rel = (cache_pos - lo).reshape(1)
        own = ((rel >= 0) & (rel < kc.shape[1])).reshape(())
        slot = rel.clamp(0, kc.shape[1] - 1)
        for c, new in ((kc, k), (vc, v)):
            c.index_copy_(1, slot, torch.where(own, new.to(c.dtype),
                                               c.index_select(1, slot)))
        o = L.decode_attention_sp(q, kc, vc, cache_pos.expand(B), lo, group,
                                  window=window, chunked=chunked)
    else:
        kc, vc = cache                                   # (B, T, KVH, hd)
        kc[:, cache_pos:cache_pos + S] = k
        vc[:, cache_pos:cache_pos + S] = v
        clen = torch.full((B,), cache_pos + 1, dtype=torch.long,
                          device=x.device)
        o = L.decode_attention(q, kc, vc, clen, window=window,
                               chunked=chunked)
    out = o.reshape(B, S, H * hd) @ p["w_o"]
    return out.to(x.dtype)


def _ffn(lp: Dict, y: torch.Tensor, cfg: LMConfig):
    """The layer's MLP on (B, S, D): (out, aux loss)."""
    if cfg.moe is None:
        return L.swiglu(lp["ffn"], y), None
    B, S, D = y.shape
    moe = lp["moe"]
    f, a = _moe_fn()(moe, y.reshape(B * S, D), cfg.moe,
                     n_pad_experts=moe["router"].shape[-1]
                     - cfg.moe.n_experts)
    return f.reshape(B, S, D), a


# ---------------------------------------------------------------------------
# forward / loss / decode
# ---------------------------------------------------------------------------


def _tokens(params: LM, tokens) -> torch.Tensor:
    return to_tensor(tokens, params.device, torch.long)


def lm_hidden(params: LM, tokens, cfg: LMConfig, *, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> final hidden states (B, S, D) and the total aux
    loss (float32 scalar)."""
    exact_reductions()
    tokens = _tokens(params, tokens)
    x = _leaf(params, "embed")[tokens].to(_dt(cfg))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    angles = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    def block(x, lp, li):
        if params.gather is not None:     # inside the remat: re-gathered
            lp = params.gather.tree("layers", lp)
        h = _attn(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                  positions=positions, li=li, train=train, angles=angles)
        x = x + h
        f, a = _ffn(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        return x + f, a

    remat = cfg.remat and train and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, lp in enumerate(params.layers.per_layer()):
        if remat:
            x, a = checkpoint(block, x, lp, li, use_reentrant=False)
        else:
            x, a = block(x, lp, li)
        if a is not None:
            aux = aux + a
    return L.rms_norm(x, _leaf(params, "final_norm"), cfg.norm_eps), aux


def _leaf(params: LM, path: str) -> torch.Tensor:
    """A top-level leaf, gathered when the model holds only its block."""
    t = getattr(params, path)
    return t if params.gather is None else params.gather(path, t)


def _unembed(params: LM, cfg: LMConfig) -> torch.Tensor:
    return _leaf(params, "embed").T if cfg.tie_embeddings \
        else _leaf(params, "lm_head")


def chunked_xent(hidden: torch.Tensor, w_out: torch.Tensor,
                 labels: torch.Tensor, *, chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy without materializing (B, S, V) logits;
    under autograd each chunk is checkpointed, so its (B, chunk, V)
    float32 logits are recomputed in the backward, not kept."""
    B, S, D = hidden.shape
    nc = max(1, S // chunk)
    c = S // nc
    hc = hidden.reshape(B, nc, c, D)
    lc = labels.reshape(B, nc, c)

    def one(h, lab):
        logits = (h @ w_out).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        return (lse - gold).sum()

    remat = torch.is_grad_enabled() and (hidden.requires_grad
                                         or w_out.requires_grad)
    tot = None
    for i in range(nc):
        t = (checkpoint(one, hc[:, i], lc[:, i], use_reentrant=False)
             if remat else one(hc[:, i], lc[:, i]))
        tot = t if tot is None else tot + t
    return tot / (B * S)


def lm_loss(params: LM, batch: Dict, cfg: LMConfig):
    """batch: {'tokens': (B, S), 'labels': (B, S)} -> (loss, metrics)."""
    hidden, aux = lm_hidden(params, batch["tokens"], cfg, train=True)
    xent = chunked_xent(hidden, _unembed(params, cfg),
                        _tokens(params, batch["labels"]))
    return xent + aux, {"xent": xent, "aux": aux}


@torch.no_grad()
def lm_prefill(params: LM, tokens, cfg: LMConfig) -> torch.Tensor:
    """Prefill forward -> next-token logits at the last position (B, V)
    float32."""
    hidden, _ = lm_hidden(params, tokens, cfg)
    return (hidden[:, -1] @ _unembed(params, cfg)).to(torch.float32)


class DecodeCache(NamedTuple):
    k: torch.Tensor          # (L, B, T, KVH, hd)
    v: torch.Tensor


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> DecodeCache:
    """A zero KV cache on `device` (default: the card)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or _dt(cfg)
    return DecodeCache(torch.zeros(shape, dtype=dt, device=dev),
                       torch.zeros(shape, dtype=dt, device=dev))


@torch.no_grad()
def lm_decode_step(params: LM, cache: DecodeCache, token,
                   pos: Union[int, torch.Tensor], cfg: LMConfig, *,
                   seq_group=None, seq_lo: int = 0):
    """One decode step. token: (B,) int; pos: the append index (an int, or
    a 0-d tensor read once). Returns (logits (B, V) float32, cache): the
    cache is updated in place and returned.

    `seq_group` ((process group, members), the `model` group of a grid):
    sequence-parallel decode, the cache this rank's block of the sequence
    from position `seq_lo`; `pos` is then never read on the host."""
    exact_reductions()
    token = _tokens(params, token)
    x = _leaf(params, "embed")[token][:, None, :].to(_dt(cfg))  # (B, 1, D)
    B = x.shape[0]
    seq = None
    if seq_group is None:
        pos = int(pos)
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=x.device)
    else:
        pos = to_tensor(pos, x.device, torch.long).reshape(())
        positions = pos.expand(B, 1)
        seq = (seq_group[0], int(seq_lo))
    angles = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    for li, lp in enumerate(params.layers.per_layer()):
        if params.gather is not None:
            lp = params.gather.tree("layers", lp)
        h = _attn(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                  positions=positions, li=li,
                  cache=(cache.k[li], cache.v[li]), cache_pos=pos,
                  angles=angles, seq=seq)
        x = x + h
        f, _ = _ffn(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        x = x + f
    x = L.rms_norm(x, _leaf(params, "final_norm"), cfg.norm_eps)
    logits = (x[:, 0] @ _unembed(params, cfg)).to(torch.float32)
    return logits, cache
