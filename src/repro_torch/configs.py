"""Index configurations of the paper's Table 1 (copy of
`repro.configs.base.IndexConfig` and `repro.configs.aisaq_indices`), the
recommender configurations (`RecsysConfig`; `SASREC`, `DLRM_RM2`,
`DCN_V2`, `WIDE_DEEP`; the `REC_SHAPES` cells), the language models
(`MoEConfig`, `LMConfig`; `QWEN3_1P7B`, `H2O_DANUBE_1P8B`, `QWEN2_1P5B`,
`QWEN2_MOE_A2P7B`, `LLAMA4_SCOUT_17B_A16E`; the `LM_SHAPES` cells), the GNN (`GNNConfig`,
`GRAPHSAGE_REDDIT`; the `GNN_SHAPES` cells) and the `--arch` registry (`get_arch`, `list_archs`: copies of
`repro.configs.registry`'s)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class IndexConfig:
    """AiSAQ / DiskANN index build + search parameters (paper Table 1)."""

    name: str
    n_vectors: int
    dim: int
    data_dtype: str = "float32"     # float32 | uint8 (SIFT1B is uint8)
    metric: str = "l2"              # l2 | mips
    R: int = 56                     # max outdegree
    pq_m: int = 128                 # number of PQ subvectors == b_pq bytes
    pq_ks: int = 256                # centroids per subquantizer (1 byte codes)
    n_ep: int = 1                   # entry points kept resident
    block_bytes: int = 4096         # LBA block size B
    beamwidth: int = 4              # paper fixes w=4
    build_L: int = 96               # candidate list size during build
    alpha: float = 1.2              # RobustPrune distance slack
    max_hops: int = 256             # bound of the device search loop
    mode: str = "aisaq"             # aisaq | diskann (placement policy)

    @property
    def b_full(self) -> int:
        itemsize = 1 if self.data_dtype == "uint8" else 4
        return self.dim * itemsize

    def scaled(self, **kw) -> "IndexConfig":
        return dataclasses.replace(self, **kw)


# Table 1, column SIFT1M: float32, d=128, R=56, b_pq=128
SIFT1M = IndexConfig(
    name="sift1m", n_vectors=1_000_000, dim=128, data_dtype="float32",
    metric="l2", R=56, pq_m=128,
)

# Table 1, column SIFT1B: uint8, d=128, R=52, b_pq=32
SIFT1B = IndexConfig(
    name="sift1b", n_vectors=1_000_000_000, dim=128, data_dtype="uint8",
    metric="l2", R=52, pq_m=32,
)

# Table 1, column KILT E5 22M: float32, d=1024, MIPS, R=69, b_pq=128
KILT_E5_22M = IndexConfig(
    name="kilt-e5-22m", n_vectors=22_220_792, dim=1024, data_dtype="float32",
    metric="mips", R=69, pq_m=128,
)


# ---------------------------------------------------------------------------
# recommender (copies of `repro.configs.base.RecsysConfig`, `ShapeConfig`,
# the `retrieval_cand` shape and `repro.configs.sasrec.MODEL`)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                       # dlrm | dcnv2 | sasrec | widedeep
    embed_dim: int
    vocab_sizes: Tuple[int, ...]    # rows per sparse table
    n_dense: int = 0
    multi_hot: int = 1              # lookups per field (EmbeddingBag bag size)
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()
    n_cross_layers: int = 0
    # sasrec
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    interaction: str = "dot"        # dot | cross | concat | self-attn-seq
    dtype: str = "float32"

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    def n_embedding_rows(self) -> int:
        return sum(self.vocab_sizes)

    def scaled(self, **kw) -> "RecsysConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell. `kind` selects which step function is lowered."""

    name: str
    kind: str
    # lm
    seq_len: int = 0
    global_batch: int = 0
    # gnn
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    batch_graphs: int = 0
    # recsys / ann
    batch: int = 0
    n_candidates: int = 0


# the recommender cells: a training batch, a p99-latency serving batch, a
# bulk-scoring batch, and one user against the whole 1M-item catalogue
# (the paper's retrieval regime)
TRAIN_BATCH = ShapeConfig("train_batch", "rec_train", batch=65536)
SERVE_P99 = ShapeConfig("serve_p99", "rec_serve", batch=512)
SERVE_BULK = ShapeConfig("serve_bulk", "rec_serve", batch=262144)
RETRIEVAL_CAND = ShapeConfig("retrieval_cand", "rec_retrieval", batch=1,
                             n_candidates=1_000_000)
REC_SHAPES = (TRAIN_BATCH, SERVE_P99, SERVE_BULK, RETRIEVAL_CAND)

ANN_SHAPES = (
    ShapeConfig("serve_q32", "ann_search", batch=32),
    ShapeConfig("serve_q1k", "ann_search", batch=1024),
)

# sasrec [arXiv:1808.09781; paper] — self-attentive sequential recommender.
# Item vocabulary is set to 1M so retrieval_cand (1 query x 1e6 candidates)
# scores against the full catalogue.
SASREC = RecsysConfig(
    name="sasrec",
    kind="sasrec",
    embed_dim=50,
    vocab_sizes=(1_000_000,),       # item catalogue
    seq_len=50,
    n_blocks=2,
    n_heads=1,
    interaction="self-attn-seq",
)

# dlrm-rm2 [arXiv:1906.00091; paper]: the MLPerf / Criteo-Terabyte
# cardinalities of the 26 sparse fields. They sum to 187,767,399 rows, and
# to 187,801,600 once each table is padded to a multiple of 2048 as
# `models.recsys.padded_vocab` pads it: 48.08 GB of float32 at D=64, which
# fits on one 80 GB card. (The reference's docstring says "~882M total
# rows -> ~226 GB"; the tuple below, which both packages share, holds
# 187.8M.)
CRITEO_TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

DLRM_RM2 = RecsysConfig(
    name="dlrm-rm2",
    kind="dlrm",
    embed_dim=64,
    vocab_sizes=CRITEO_TB_VOCABS,
    n_dense=13,
    bot_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1),
    interaction="dot",
)

# dcn-v2 [arXiv:2008.13535; paper]: 3 cross layers + deep MLP over the same
# 26 Criteo tables at D=16 (12.02 GB padded)
DCN_V2 = RecsysConfig(
    name="dcn-v2",
    kind="dcnv2",
    embed_dim=16,
    vocab_sizes=CRITEO_TB_VOCABS,
    n_dense=13,
    mlp=(1024, 1024, 512),
    n_cross_layers=3,
    interaction="cross",
)

# wide-deep [arXiv:1606.07792; paper]: 40 fields spanning 1e3..1e7 rows
# (deterministic synthetic cardinalities; 88,888,000 rows, 88,915,968
# padded: 11.38 GB of deep tables at D=32 plus 0.36 GB of wide ones)
WD_VOCABS = tuple(10 ** (3 + (i % 5)) for i in range(40))

WIDE_DEEP = RecsysConfig(
    name="wide-deep",
    kind="widedeep",
    embed_dim=32,
    vocab_sizes=WD_VOCABS,
    n_dense=0,
    mlp=(1024, 512, 256),
    multi_hot=2,                    # wide&deep uses multi-hot cross features
    interaction="concat",
)


# ---------------------------------------------------------------------------
# language models (copies of `repro.configs.base.MoEConfig`, `LMConfig`,
# `LM_SHAPES` and the five `repro/configs/*.py` LM modules)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """GShard-style top-k routed MoE with optional shared experts."""

    n_experts: int
    top_k: int
    d_expert: int                 # hidden width of each routed expert
    n_shared_experts: int = 0
    d_shared: int = 0             # total hidden width of the shared expert(s)
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3

    # experts are sharded over an expert-parallel axis; pad the count up to
    # a multiple of the axis size so the expert dim shards evenly
    def padded_experts(self, ep: int) -> int:
        return ((self.n_experts + ep - 1) // ep) * ep


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qk_norm: bool = False
    qkv_bias: bool = False
    attention: str = "full"       # full | sliding | chunked_global
    window: int = 0               # sliding window size / local chunk size
    global_every: int = 0         # chunked_global: every k-th layer is global
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def n_params(self) -> int:
        """Total parameter count (embeddings included)."""
        d, L = self.d_model, self.n_layers
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.moe is None:
            ffn = 3 * d * self.d_ff
        else:
            m = self.moe
            ffn = m.n_experts * 3 * d * m.d_expert + 3 * d * m.d_shared
            ffn += d * m.n_experts  # router
        norms = 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + norms) + emb + d

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE counts only routed top-k)."""
        if self.moe is None:
            return self.n_params()
        d, L, m = self.d_model, self.n_layers, self.moe
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        ffn = m.top_k * 3 * d * m.d_expert + 3 * d * m.d_shared \
            + d * m.n_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + 2 * d) + emb + d

    def scaled(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)


# canonical LM shape set (assigned to every LM arch)
LM_SHAPES = (
    ShapeConfig("train_4k", "lm_train", seq_len=4096, global_batch=256),
    ShapeConfig("prefill_32k", "lm_prefill", seq_len=32768, global_batch=32),
    ShapeConfig("decode_32k", "lm_decode", seq_len=32768, global_batch=128),
    ShapeConfig("long_500k", "lm_decode", seq_len=524288, global_batch=1),
)

# qwen3-1.7b [hf:Qwen/Qwen3-8B family; hf] — dense, GQA kv=8, qk_norm
QWEN3_1P7B = LMConfig(
    name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    head_dim=128, d_ff=6144, vocab_size=151936, qk_norm=True,
    attention="full", rope_theta=1_000_000.0, tie_embeddings=True,
)

# h2o-danube-1.8b [arXiv:2401.16818; hf] — llama+mistral mix with SWA
H2O_DANUBE_1P8B = LMConfig(
    name="h2o-danube-1.8b", n_layers=24, d_model=2560, n_heads=32,
    n_kv_heads=8, head_dim=80, d_ff=6912, vocab_size=32000,
    attention="sliding", window=4096,       # mistral-style sliding window
    rope_theta=10_000.0,
)

# qwen2-1.5b [arXiv:2407.10671; hf] — dense GQA kv=2 with QKV bias
QWEN2_1P5B = LMConfig(
    name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    head_dim=128, d_ff=8960, vocab_size=151936, qkv_bias=True,
    attention="full", rope_theta=1_000_000.0, tie_embeddings=True,
)

# qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 60 routed top-4 + 4
# shared
QWEN2_MOE_A2P7B = LMConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, head_dim=128,
    d_ff=1408,                      # routed-expert hidden (per spec line)
    vocab_size=151936, qkv_bias=True, attention="full",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408, n_shared_experts=4,
                  d_shared=5632,    # 4 shared experts x 1408
                  capacity_factor=1.25),
)

# llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
# MoE 16 routed top-1 + 1 shared expert per layer; iRoPE attention:
# chunked local attention (chunk 8192) with every 4th layer global (NoPE)
LLAMA4_SCOUT_17B_A16E = LMConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=202048,
    attention="chunked_global",
    window=8192,                    # local-attention chunk length
    global_every=4,                 # every 4th layer attends globally
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=1, d_expert=8192, n_shared_experts=1,
                  d_shared=8192, capacity_factor=1.25),
)



# ---------------------------------------------------------------------------
# graph networks (copies of `repro.configs.base.GNNConfig`, `GNN_SHAPES`
# and `repro.configs.graphsage_reddit`)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    aggregator: str = "mean"        # mean | max | sum
    sample_sizes: Tuple[int, ...] = (25, 10)
    n_classes: int = 41             # reddit has 41 classes
    pq_features: bool = False       # beyond-paper: PQ-compressed feature store
    dtype: str = "float32"

    def scaled(self, **kw) -> "GNNConfig":
        return dataclasses.replace(self, **kw)


GNN_SHAPES = (
    ShapeConfig("full_graph_sm", "gnn_full", n_nodes=2708, n_edges=10556,
                d_feat=1433),
    ShapeConfig("minibatch_lg", "gnn_minibatch", n_nodes=232965,
                n_edges=114615892, batch_nodes=1024, fanout=(15, 10),
                d_feat=602),
    ShapeConfig("ogb_products", "gnn_full", n_nodes=2449029,
                n_edges=61859140, d_feat=100),
    ShapeConfig("molecule", "gnn_batched", n_nodes=30, n_edges=64,
                batch_graphs=128, d_feat=64),
)

# graphsage-reddit [arXiv:1706.02216; paper] — 2-layer mean aggregator
GRAPHSAGE_REDDIT = GNNConfig(
    name="graphsage-reddit",
    n_layers=2,
    d_hidden=128,
    aggregator="mean",
    sample_sizes=(25, 10),
    n_classes=41,
)


# ---------------------------------------------------------------------------
# the --arch registry (copy of `repro.configs.base.ArchConfig` and
# `repro.configs.registry`)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                     # lm | gnn | recsys | ann
    model: object
    shapes: Tuple[ShapeConfig, ...]
    skip_shapes: Tuple[str, ...] = ()
    skip_reason: str = ""
    source: str = ""

    def shape(self, name: str) -> ShapeConfig:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}")

    def active_shapes(self) -> Tuple[ShapeConfig, ...]:
        return tuple(s for s in self.shapes if s.name not in self.skip_shapes)


def _rec(arch_id: str, model: RecsysConfig, source: str) -> ArchConfig:
    return ArchConfig(arch_id=arch_id, family="recsys", model=model,
                      shapes=REC_SHAPES, source=source)


def _ann(arch_id: str, model: IndexConfig) -> ArchConfig:
    return ArchConfig(arch_id=arch_id, family="ann", model=model,
                      shapes=ANN_SHAPES, source="paper Table 1")


def _lm(arch_id: str, model: LMConfig, source: str,
        skip_reason: str = "") -> ArchConfig:
    return ArchConfig(arch_id=arch_id, family="lm", model=model,
                      shapes=LM_SHAPES,
                      skip_shapes=("long_500k",) if skip_reason else (),
                      skip_reason=skip_reason, source=source)


_REGISTRY: Dict[str, ArchConfig] = {
    "qwen3-1.7b": _lm(
        "qwen3-1.7b", QWEN3_1P7B, "hf:Qwen/Qwen3-8B; hf",
        "pure full attention: 500k decode is quadratic-KV with no "
        "published sub-quadratic variant for this checkpoint "
        "(DESIGN.md §4)"),
    # sliding window => O(S*W) compute and window-bounded KV: long_500k runs
    "h2o-danube-1.8b": _lm("h2o-danube-1.8b", H2O_DANUBE_1P8B,
                           "arXiv:2401.16818; hf"),
    "qwen2-1.5b": _lm("qwen2-1.5b", QWEN2_1P5B, "arXiv:2407.10671; hf",
                      "pure full attention (DESIGN.md §4)"),
    "qwen2-moe-a2.7b": _lm("qwen2-moe-a2.7b", QWEN2_MOE_A2P7B,
                           "hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
                           "pure full attention (DESIGN.md §4)"),
    # chunked-local + SP-decoded sparse global layers => long_500k runs
    "llama4-scout-17b-a16e": _lm(
        "llama4-scout-17b-a16e", LLAMA4_SCOUT_17B_A16E,
        "hf:meta-llama/Llama-4-Scout-17B-16E; unverified"),
    "graphsage-reddit": ArchConfig(
        arch_id="graphsage-reddit", family="gnn", model=GRAPHSAGE_REDDIT,
        shapes=GNN_SHAPES, source="arXiv:1706.02216; paper"),
    "dlrm-rm2": _rec("dlrm-rm2", DLRM_RM2, "arXiv:1906.00091; paper"),
    "sasrec": _rec("sasrec", SASREC, "arXiv:1808.09781; paper"),
    "dcn-v2": _rec("dcn-v2", DCN_V2, "arXiv:2008.13535; paper"),
    "wide-deep": _rec("wide-deep", WIDE_DEEP, "arXiv:1606.07792; paper"),
    "aisaq-sift1m": _ann("aisaq-sift1m", SIFT1M),
    "aisaq-sift1b": _ann("aisaq-sift1b", SIFT1B),
    "aisaq-kilt-e5": _ann("aisaq-kilt-e5", KILT_E5_22M),
}

# the reference's order: assigned architectures first, then the extras
_ORDER = ("qwen3-1.7b", "h2o-danube-1.8b", "qwen2-1.5b", "qwen2-moe-a2.7b",
          "llama4-scout-17b-a16e", "graphsage-reddit", "dlrm-rm2", "sasrec",
          "dcn-v2", "wide-deep", "aisaq-sift1m", "aisaq-sift1b",
          "aisaq-kilt-e5")

ASSIGNED_ARCHS: List[str] = list(_ORDER[:10])


def get_arch(arch_id: str) -> ArchConfig:
    """The ArchConfig of an `--arch` id; unknown ids raise KeyError, as
    the reference's registry does."""
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(_ORDER)}") from None


def list_archs(include_extra: bool = True) -> List[str]:
    return list(_ORDER) if include_extra else list(ASSIGNED_ARCHS)
