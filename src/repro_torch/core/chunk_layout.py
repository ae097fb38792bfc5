"""Node-chunk layout math + packing (paper §2.3/§3.1, Figs 1-2).

A copy of `repro.core.chunk_layout` (layout, numpy packer, file-matrix
view) plus `pack_chunks_torch`, which packs block by block straight into
an (N, device_stride/4) int32 tensor on the card. The numpy packer holds
an (N, R, m) uint8 temporary of neighbour codes; at SIFT1M's N=1M that
alone is 7 GB of host memory, so deployment-size tables are packed on the
device.

  DiskANN : [ full_vec | n_nbrs | nbr_ids[R] ]
  AiSAQ   : [ full_vec | n_nbrs | nbr_ids[R] | nbr_pq_codes[R] ]

Device layout: stride padded to a multiple of 128 bytes and every field
4-byte aligned, so the vector is a float32 view and ids are int32 words.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

B_NUM = 4  # bytes per node id / degree field


def _align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


@dataclass(frozen=True)
class ChunkLayout:
    mode: str                 # "aisaq" | "diskann"
    dim: int
    data_dtype: str           # "float32" | "uint8"
    R: int
    pq_m: int                 # b_pq bytes per code
    block_bytes: int = 4096

    # ---- sizes (paper formulas) -----------------------------------------
    @property
    def b_full(self) -> int:
        return self.dim * (1 if self.data_dtype == "uint8" else 4)

    @property
    def chunk_bytes(self) -> int:
        base = self.b_full + B_NUM * (self.R + 1)
        if self.mode == "aisaq":
            base += self.R * self.pq_m
        return base

    # ---- field offsets (raw, unpadded; file layout) ----------------------
    @property
    def off_ids(self) -> int:
        return self.b_full + B_NUM

    # ---- file (LBA) placement -------------------------------------------
    @property
    def nodes_per_block(self) -> int:
        """>0 when chunk <= block (Fig 1a); 0 when multi-block (Fig 1b)."""
        return self.block_bytes // self.chunk_bytes \
            if self.chunk_bytes <= self.block_bytes else 0

    @property
    def blocks_per_chunk(self) -> int:
        return 1 if self.nodes_per_block else \
            -(-self.chunk_bytes // self.block_bytes)

    # ---- device placement -------------------------------------------------
    @property
    def device_stride(self) -> int:
        """Chunk stride of the (N, stride) device table: 128-B aligned."""
        return _align(self.padded_vec_bytes + B_NUM * (1 + self.R)
                      + (self.R * self.pq_m if self.mode == "aisaq" else 0),
                      128)

    @property
    def padded_vec_bytes(self) -> int:
        return _align(self.b_full, 4)

    @property
    def dev_off_deg(self) -> int:
        return self.padded_vec_bytes

    @property
    def dev_off_ids(self) -> int:
        return self.padded_vec_bytes + B_NUM

    @property
    def dev_off_pq(self) -> int:
        return self.dev_off_ids + self.R * B_NUM


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


def _vec_bytes(vectors: np.ndarray, layout: ChunkLayout) -> np.ndarray:
    if layout.data_dtype == "uint8":
        return vectors.astype(np.uint8)
    return vectors.astype(np.float32).view(np.uint8).reshape(
        vectors.shape[0], -1)


def pack_chunks_device(vectors: np.ndarray, adjacency: np.ndarray,
                       codes: np.ndarray, layout: ChunkLayout) -> np.ndarray:
    """(N, device_stride) uint8 array — the device-resident 'storage' tier
    (numpy; the byte-level reference of `pack_chunks_torch`)."""
    n = vectors.shape[0]
    out = np.zeros((n, layout.device_stride), dtype=np.uint8)
    vb = _vec_bytes(vectors, layout)
    out[:, :vb.shape[1]] = vb
    adj = adjacency.astype(np.int32)
    deg = (adj >= 0).sum(axis=1).astype(np.int32)
    out[:, layout.dev_off_deg:layout.dev_off_deg + B_NUM] = \
        deg[:, None].view(np.uint8)
    out[:, layout.dev_off_ids:layout.dev_off_ids + layout.R * B_NUM] = \
        adj.view(np.uint8).reshape(n, -1)
    if layout.mode == "aisaq":
        safe = np.where(adj >= 0, adj, 0)
        nc = np.where((adj >= 0)[:, :, None], codes[safe], 0).astype(np.uint8)
        o = layout.dev_off_pq
        out[:, o:o + layout.R * layout.pq_m] = nc.reshape(n, -1)
    return out


def pack_chunks_torch(vectors: torch.Tensor, adjacency: torch.Tensor,
                      codes: torch.Tensor, layout: ChunkLayout, *,
                      block_rows: int = 65536) -> torch.Tensor:
    """(N, device_stride/4) int32 chunk table on ``vectors.device``, packed
    `block_rows` rows at a time; its bytes equal `pack_chunks_device`'s.

    vectors (N, d) float32/uint8, adjacency (N, R) int (-1 padded) and
    codes (N, m) uint8 must share one device. Peak temporary memory is one
    block: block_rows * (device_stride + R * m) bytes.
    """
    dev = vectors.device
    n = vectors.shape[0]
    S, R, m = layout.device_stride, layout.R, layout.pq_m
    if layout.data_dtype == "uint8":
        vb_all = vectors.to(torch.uint8)
    else:
        vb_all = vectors.to(torch.float32).contiguous().view(torch.uint8)
    out = torch.empty((n, S // 4), dtype=torch.int32, device=dev)
    for lo in range(0, n, block_rows):
        hi = min(n, lo + block_rows)
        b = hi - lo
        blk = torch.zeros((b, S), dtype=torch.uint8, device=dev)
        blk[:, :vb_all.shape[1]] = vb_all[lo:hi]
        adj = adjacency[lo:hi].to(torch.int32)
        valid = adj >= 0
        deg = valid.sum(dim=1, dtype=torch.int32)
        blk[:, layout.dev_off_deg:layout.dev_off_deg + B_NUM] = \
            deg[:, None].view(torch.uint8)
        blk[:, layout.dev_off_ids:layout.dev_off_ids + R * B_NUM] = \
            adj.contiguous().view(torch.uint8)
        if layout.mode == "aisaq":
            safe = torch.where(valid, adj, 0).long()
            nc = codes[safe.reshape(-1)].reshape(b, R, m)
            nc = nc * valid[:, :, None].to(torch.uint8)
            blk[:, layout.dev_off_pq:layout.dev_off_pq + R * m] = \
                nc.reshape(b, R * m)
        out[lo:hi] = blk.view(torch.int32)
    return out


# ---------------------------------------------------------------------------
# unpacking (host file format)
# ---------------------------------------------------------------------------


def chunk_matrix(raw: np.ndarray, layout: ChunkLayout, n: int) -> np.ndarray:
    """Whole-file uint8 buffer -> (n, chunk_bytes) matrix of node chunks:
    one reshape peels the block padding off, so field slices are 2-D views.
    """
    if layout.nodes_per_block:
        npb = layout.nodes_per_block
        nblk = -(-n // npb)
        blocks = raw[:nblk * layout.block_bytes] \
            .reshape(nblk, layout.block_bytes)
        return blocks[:, :npb * layout.chunk_bytes] \
            .reshape(nblk * npb, layout.chunk_bytes)[:n]
    per = layout.blocks_per_chunk * layout.block_bytes
    return raw[:n * per].reshape(n, per)[:, :layout.chunk_bytes]
