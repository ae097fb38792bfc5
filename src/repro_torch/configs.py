"""Index configurations of the paper's Table 1 (copy of
`repro.configs.base.IndexConfig` and `repro.configs.aisaq_indices`)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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
