"""Model FLOPs of a cell, the "useful work" yardstick (port of
`repro.launch.inputs.model_flops`).

The reference's `build_cell` and `input_specs` (its dry-run cells) are
the next slice: they can now take their specs from the port's rules
(`distributed.sharding`: `spec_tree`, the param rules, `opt_state_specs`,
`batch_specs`, `cache_spec`); `flops.cell_terms` gives each cell's bytes
and times on the card.
"""
from __future__ import annotations

from repro_torch.configs import ArchConfig, ShapeConfig


def model_flops(arch: ArchConfig, shape: ShapeConfig) -> float:
    if arch.family == "lm":
        cfg = arch.model
        n_act = cfg.n_active_params()
        if shape.kind == "lm_train":
            return 6.0 * n_act * shape.global_batch * shape.seq_len
        if shape.kind == "lm_prefill":
            return 2.0 * n_act * shape.global_batch * shape.seq_len
        return 2.0 * n_act * shape.global_batch        # decode: per token
    if arch.family == "gnn":
        cfg = arch.model
        H = cfg.d_hidden
        if shape.kind == "gnn_full":
            per_layer = 2 * shape.n_edges * H + 4 * shape.n_nodes * H * H
            fwd = cfg.n_layers * per_layer + 2 * shape.n_nodes * shape.d_feat * H
            return 3.0 * fwd
        if shape.kind == "gnn_minibatch":
            B, (f1, f2) = shape.batch_nodes, shape.fanout
            nodes = B * (1 + f1 + f1 * f2)
            return 3.0 * (4 * nodes * shape.d_feat * H + 4 * B * H * H)
        nodes = shape.batch_graphs * shape.n_nodes
        return 3.0 * cfg.n_layers * 4 * nodes * cfg.d_hidden * shape.d_feat
    if arch.family == "recsys":
        cfg = arch.model
        B = shape.batch
        if shape.kind == "rec_retrieval":
            return 2.0 * shape.n_candidates * cfg.embed_dim
        dims = []
        if cfg.kind == "dlrm":
            dims = list(zip((cfg.n_dense,) + cfg.bot_mlp[:-1], cfg.bot_mlp))
            f = cfg.n_sparse + 1
            d_int = f * (f - 1) // 2 + cfg.bot_mlp[-1]
            dims += list(zip((d_int,) + cfg.top_mlp[:-1], cfg.top_mlp))
            dims += [(f * cfg.embed_dim, f)]          # interaction
        elif cfg.kind in ("dcnv2", "widedeep"):
            d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
            dims = list(zip((d0,) + cfg.mlp, cfg.mlp + (1,)))
            dims += [(d0, d0)] * cfg.n_cross_layers
        else:  # sasrec
            S, D = cfg.seq_len, cfg.embed_dim
            per_tok = 4 * D * D + 2 * S * D + 2 * D * D
            dims = [(S * per_tok // 2, 1)]
        mults = sum(a * b for a, b in dims)
        fac = 6.0 if shape.kind == "rec_train" else 2.0
        return fac * B * mults
    if arch.family == "ann":
        cfg = arch.model
        # per query: ~hops * w * (R * m ADC adds + exact dist) + LUT
        hops, w = 64, cfg.beamwidth
        per_q = hops * w * (cfg.R * cfg.pq_m * 2 + 2 * cfg.dim) \
            + 2 * cfg.dim * cfg.pq_ks
        return float(shape.batch * per_q)
    raise ValueError(arch.family)
