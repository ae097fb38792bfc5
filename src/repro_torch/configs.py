"""Index configurations of the paper's Table 1 (copy of
`repro.configs.base.IndexConfig` and `repro.configs.aisaq_indices`) and the
recommender configuration of the retrieval slice (`RecsysConfig`,
`SASREC`, `RETRIEVAL_CAND`)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


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


# one user against the whole 1M-item catalogue: the paper's retrieval regime
RETRIEVAL_CAND = ShapeConfig("retrieval_cand", "rec_retrieval", batch=1,
                             n_candidates=1_000_000)

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
