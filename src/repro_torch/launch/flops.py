"""Analytic per-device FLOPs, HBM bytes and collective bytes of a cell
(port of `repro.launch.flops`), and the times they give on the card.

The counts are the reference's, term for term: it reconstructs the
loop-true totals from the model configs and its sharding strategy (XLA's
cost analysis counts a scanned body once). Its conventions:
  matmul train cost = 4x fwd   (fwd + remat recompute + 2x bwd)
  flash-vjp train   = 4.5x fwd (fwd + remat + recompute-s + 2.5x bwd)
  serve cost        = 1x fwd
All FLOPs are 2*MACs; attention counts the real (block_q, block_kv)
pairs of the band mask. `cell_terms` divides them by one H100's rates
(below) instead of the TPU v5e's that the reference divides by.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import ArchConfig, IndexConfig, ShapeConfig

# hardware constants: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
# H100 data sheet, dense rates without sparsity)
PEAK_FLOPS_BF16 = 989e12        # bfloat16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # float32 outside the tensor cores
HBM_BW = 3.35e12                # 80 GB of HBM3, bytes/s
# NVLink 4: 900 GB/s to the other cards of the host, all to all; 450 GB/s
# each way (NVIDIA's H100 data sheet)
LINK_BW = 450e9

BQ, BK = 512, 1024          # flash block sizes (models/layers.py defaults)


def peak_flops(arch: ArchConfig) -> float:
    """The card's peak for the model's type: bfloat16 on the tensor cores
    (the LMs), float32 otherwise (the GNN, the recommenders, the index)."""
    dtype = getattr(arch.model, "dtype", "float32")
    return PEAK_FLOPS_BF16 if dtype == "bfloat16" else PEAK_FLOPS_F32


def attn_block_pairs(S: int, *, causal: bool, window: int, chunked: bool,
                     bq: int = BQ, bk: int = BK) -> int:
    """Number of computed (q-block, kv-block) pairs under band skipping."""
    nq, nk = -(-S // bq), -(-S // bk)
    total = 0
    for qi in range(nq):
        hi = min((qi * bq + bq + bk - 1) // bk, nk) if causal else nk
        lo = 0
        if window > 0 and not chunked:
            lo = max(0, (qi * bq - (window - 1)) // bk)
        if window > 0 and chunked:
            lo = (qi * bq) // window * window // bk
        total += max(0, hi - lo)
    return total


def _lm_layer_flops(cfg, S: int, *, decode_T: int = 0) -> Dict[str, float]:
    """Per-layer fwd FLOPs for ONE sequence (or one decode token)."""
    D, Hhd, KVhd, hd, H = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim,
                           cfg.n_heads)
    out = {}
    ntok = 1 if decode_T else S
    out["proj"] = 2.0 * ntok * (D * (Hhd + 2 * KVhd) + Hhd * D)
    if decode_T:
        eff = decode_T if not cfg.window else min(cfg.window, decode_T)
        if cfg.attention == "chunked_global":
            n_glob = cfg.n_layers // cfg.global_every
            frac_glob = n_glob / cfg.n_layers
            eff = frac_glob * decode_T + (1 - frac_glob) * min(cfg.window,
                                                               decode_T)
        out["attn"] = 4.0 * eff * H * hd
    else:
        if cfg.attention == "full":
            pairs = attn_block_pairs(S, causal=True, window=0, chunked=False)
        elif cfg.attention == "sliding":
            pairs = attn_block_pairs(S, causal=True, window=cfg.window,
                                     chunked=False)
        else:
            p_loc = attn_block_pairs(S, causal=True, window=cfg.window,
                                     chunked=True)
            p_glob = attn_block_pairs(S, causal=True, window=0, chunked=False)
            n_glob = cfg.n_layers // cfg.global_every
            pairs = (p_glob * n_glob + p_loc * (cfg.n_layers - n_glob)) \
                / cfg.n_layers
        out["attn"] = 4.0 * pairs * BQ * BK * H * hd
    if cfg.moe is None:
        out["ffn"] = 6.0 * ntok * D * cfg.d_ff
    else:
        m = cfg.moe
        # capacity-factored routed einsums run on E*C slots (global dispatch)
        out["ffn"] = 6.0 * ntok * m.capacity_factor * m.top_k * D * m.d_expert
        out["ffn"] += 6.0 * ntok * D * m.d_shared + 2.0 * ntok * D * m.n_experts
    return out


def lm_cell_terms(arch: ArchConfig, shape: ShapeConfig, chips: int,
                  model_ways: int, dp_ways: int, *,
                  naive_flash: bool = False, cp_attention: bool = False,
                  mb_budget: float = 4e9) -> Dict[str, float]:
    cfg = arch.model
    train = shape.kind == "lm_train"
    decode = shape.kind == "lm_decode"
    B, S = shape.global_batch, shape.seq_len
    lf = _lm_layer_flops(cfg, S, decode_T=S if decode else 0)
    if naive_flash and not decode:
        # baseline masked-scan flash: NO band skipping -> full nq x nk pairs
        nq, nk = -(-S // BQ), -(-S // BK)
        lf["attn"] = 4.0 * nq * nk * BQ * BK * cfg.n_heads * cfg.head_dim
    L = cfg.n_layers
    ntok_total = B * (1 if decode else S)
    cm = 4.0 if train else 1.0            # matmul multiplier
    ca = 4.5 if train else 1.0            # flash-vjp multiplier
    # matmuls/MoE/logits shard over (dp x model); attention compute is
    # replicated over `model` unless context-parallel (cp_attention)
    attn_ways = chips if cp_attention else dp_ways
    flops_mm = cm * B * L * (lf["proj"] + lf["ffn"]) / chips
    flops_attn = ca * B * L * lf["attn"] / attn_ways
    flops_logits = cm * 2.0 * ntok_total * cfg.d_model * cfg.vocab_size / chips
    flops = flops_mm + flops_attn + flops_logits

    # HBM bytes/device: params read 3x (fwd+remat+bwd) as bf16 + opt fp32
    # rw (train) OR params 1x (serve); activations ~12 B/elem-layer rw;
    # decode reads the KV cache once per token.
    p_bytes = arch.model.n_params() * 2 / chips
    if train:
        bytes_params = 3 * p_bytes + 2 * 12 * arch.model.n_params() / chips
        bytes_act = 12.0 * ntok_total * cfg.d_model * L / chips
    else:
        bytes_params = (cfg.n_active_params() if cfg.moe else
                        cfg.n_params()) * 2 / chips
        bytes_act = 6.0 * ntok_total * cfg.d_model * L / chips
    bytes_kv = 0.0
    if decode:
        eff = S if not cfg.window else min(cfg.window, S)
        if cfg.attention == "chunked_global":
            n_glob = L // cfg.global_every
            eff_tot = n_glob * S + (L - n_glob) * min(cfg.window, S)
        else:
            eff_tot = L * (S if cfg.attention == "full" else eff)
        bytes_kv = B * eff_tot * cfg.kv_dim * 2 * 2 / chips
    hbm = bytes_params + bytes_act + bytes_kv

    # collectives/device: FSDP layer all-gathers (bf16 params over `data`)
    # x (fwd [+ remat + bwd gathers] ~3x) + partial-grad reduce-scatter
    # + logits-loss psum of d_hidden + MoE dispatch gathers.
    layer_bytes = (arch.model.n_params()
                   - cfg.vocab_size * cfg.d_model
                   * (1 if cfg.tie_embeddings else 2)) * 2 / L
    resid_per_seq = 2 * L * S * cfg.d_model
    n_mb = max(1, (B // dp_ways) // max(1, int(mb_budget // resid_per_seq))) \
        if train else 1
    coll = 0.0
    if train:
        # FSDP weight all-gathers: per layer, per microbatch, x3 (fwd +
        # remat recompute + bwd)
        coll += 3 * layer_bytes * L * n_mb * (dp_ways - 1) / dp_ways / model_ways
        # gradient reduce-scatter over `data` (once per step, bf16 partials)
        coll += (cfg.n_params() * 2 / model_ways) * (dp_ways - 1) / dp_ways
        coll += ntok_total * cfg.d_model * 4 / chips   # dlogits psum
        if cfg.moe:
            coll += 2 * 3 * ntok_total * cfg.d_model * 2 / dp_ways  # dispatch
    else:
        coll += layer_bytes * L * (dp_ways - 1) / dp_ways / model_ways
        if decode:
            coll += L * B * cfg.q_dim * 4 / dp_ways    # attn partial psum
    return dict(flops=flops, hbm_bytes=hbm, coll_bytes=coll)


def gnn_cell_terms(arch, shape, chips, model_ways, dp_ways):
    cfg = arch.model
    H = cfg.d_hidden
    train = 3.0
    if shape.kind == "gnn_full":
        E, N, F = shape.n_edges, shape.n_nodes, shape.d_feat
        flops = train * (cfg.n_layers * (2 * E * H + 4 * N * H * H)
                         + 2 * N * F * H) / dp_ways
        hbm = train * (E * (F + H) * 4 + N * F * 4 * 2) / dp_ways
        coll = cfg.n_layers * train * N * H * 4   # partial-agg psum (repl out)
    elif shape.kind == "gnn_minibatch":
        B, (f1, f2), F = shape.batch_nodes, shape.fanout, shape.d_feat
        nodes = B * (1 + f1 + f1 * f2)
        flops = train * (4 * nodes * F * H + 4 * B * H * H) / chips
        hbm = train * nodes * F * 4 / chips
        coll = B * H * 4 / chips
    else:
        nodes = shape.batch_graphs * shape.n_nodes
        flops = train * cfg.n_layers * (4 * nodes * shape.d_feat * H) / chips
        hbm = train * nodes * shape.d_feat * 4 / chips
        coll = shape.batch_graphs * 4 / chips
    return dict(flops=flops, hbm_bytes=hbm, coll_bytes=coll)


def rec_cell_terms(arch, shape, chips, model_ways, dp_ways):
    from repro_torch.launch.inputs import model_flops
    cfg = arch.model
    B = shape.batch
    flops_total = model_flops(arch, shape)
    if shape.kind == "rec_retrieval":
        C, D = shape.n_candidates, cfg.embed_dim
        flops = 2.0 * C * D / chips + 2 * C * D * D / chips  # score + proj
        hbm = C * D * 4 / chips
        coll = C * 4 / chips                                  # topk merge
        return dict(flops=flops, hbm_bytes=hbm, coll_bytes=coll)
    flops = flops_total / dp_ways      # dense interaction replicated on model
    hot = cfg.multi_hot
    row_traffic = B * cfg.n_sparse * hot * cfg.embed_dim * 4
    fac = 3.0 if shape.kind == "rec_train" else 1.0
    hbm = fac * row_traffic / chips + flops / 50  # mlp act traffic, coarse
    # gathered rows cross the model axis (tables row-sharded)
    coll = fac * row_traffic * (model_ways - 1) / model_ways / dp_ways
    return dict(flops=flops, hbm_bytes=hbm, coll_bytes=coll)


def ann_cell_terms(arch, shape, chips, model_ways, dp_ways, *, mode_b,
                   hops: int = 64, L: int = 128, w: int = 4,
                   int8_adc: bool = False):
    from repro_torch.core.chunk_layout import layout_for
    cfg: IndexConfig = arch.model
    lay = layout_for(cfg, "aisaq")
    nq = shape.batch
    # every shard searches every query in mode B; in mode A queries split dp
    q_per_dev = nq if mode_b else max(1, nq // dp_ways)
    # the reference's charge: ADC as one-hot MXU matmuls (its
    # kernels/chunk_adc.py), R*m*ks MACs per hop, the int8 ADC at half cost
    adc_rate = 0.5 if int8_adc else 1.0
    per_hop = adc_rate * 2.0 * cfg.R * cfg.pq_m * cfg.pq_ks + 2.0 * cfg.dim
    flops = q_per_dev * hops * w * per_hop \
        + q_per_dev * 2.0 * cfg.dim * cfg.pq_ks * cfg.pq_m  # LUT
    hbm = q_per_dev * hops * w * lay.device_stride           # chunk DMAs
    k = 10
    coll = q_per_dev * k * 8 * (chips if mode_b else model_ways)  # topk gather
    return dict(flops=flops, hbm_bytes=hbm, coll_bytes=coll)


def cell_terms(arch: ArchConfig, shape: ShapeConfig, *, chips: int = 256,
               model_ways: int = 16, dp_ways: int = 16,
               mode_b: bool = False, **opts) -> Dict[str, float]:
    fam = arch.family
    f = {"lm": lm_cell_terms, "gnn": gnn_cell_terms,
         "recsys": rec_cell_terms}.get(fam)
    if fam == "ann":
        t = ann_cell_terms(arch, shape, chips, model_ways, dp_ways,
                           mode_b=mode_b, **opts)
    elif fam == "lm":
        t = f(arch, shape, chips, model_ways, dp_ways, **opts)
    else:
        t = f(arch, shape, chips, model_ways, dp_ways)
    t["t_compute"] = t["flops"] / peak_flops(arch)
    t["t_memory"] = t["hbm_bytes"] / HBM_BW
    t["t_collective"] = t["coll_bytes"] / LINK_BW
    t["bottleneck"] = max(("t_compute", "t_memory", "t_collective"),
                          key=lambda k: t[k])
    return t
