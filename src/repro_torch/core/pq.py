"""Product Quantization (Jegou et al., TPAMI'11) in PyTorch.

Port of `repro.core.pq`: per-subspace Lloyd k-means, encoding, exact
distances and brute-force groundtruth, plus `recall_at`. The random
initial centroid draw of the JAX version cannot be reproduced in torch,
so `train_codebooks` takes the initial indices from the caller.

Distance conventions (smaller is better everywhere):
  l2   -> squared euclidean, decomposed exactly over subspaces
  mips -> negative inner product, decomposed exactly over subspaces
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, full_fp32, resolve_device, \
    to_tensor

# (rows x m x ks) float32 elements of one distance chunk: 512 MB
_CHUNK_ELEMS = 1 << 27


def _pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(..., n, dsub) x (..., ks, dsub) -> (..., n, ks) squared L2 in the
    expanded form of the reference."""
    xn = (x * x).sum(-1, keepdim=True)
    cn = (c * c).sum(-1)
    return xn - 2.0 * (x @ c.transpose(-1, -2)) + cn[..., None, :]


def _assign(subs: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(m, n, dsub), (m, ks, dsub) -> (m, n) nearest-centroid ids,
    chunked over n so one chunk's distances stay under _CHUNK_ELEMS."""
    m, n, _ = subs.shape
    ks = cent.shape[1]
    step = max(1, _CHUNK_ELEMS // (m * ks))
    return torch.cat([_pairwise_sqdist(subs[:, s:s + step], cent).argmin(-1)
                      for s in range(0, n, step)], dim=1)


def split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) -> (m, n, dsub)."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by m={m}")
    return x.reshape(n, m, d // m).permute(1, 0, 2)


def train_codebooks(data, *, m: int, init_idx, ks: int = 256,
                    iters: int = 12, device: DeviceLike = None
                    ) -> torch.Tensor:
    """Per-subspace Lloyd k-means -> (m, ks, dsub) float32 centroids.

    data (n, d); init_idx (ks,) row indices of the initial centroids (the
    reference draws them with `jax.random.choice`). Empty clusters keep
    their previous centroid.
    """
    full_fp32()
    dev = resolve_device(device)
    x = to_tensor(data, dev, torch.float32)
    n = x.shape[0]
    subs = split_subspaces(x, m).contiguous()             # (m, n, dsub)
    idx = to_tensor(init_idx, dev, torch.long)
    if idx.shape != (ks,):
        raise ValueError(f"init_idx must have shape ({ks},), got "
                         f"{tuple(idx.shape)}")
    cent = subs[:, idx, :].clone()                        # (m, ks, dsub)
    dsub = subs.shape[2]
    ones = torch.ones((m, n), dtype=torch.float32, device=dev)
    for _ in range(iters):
        ids = _assign(subs, cent)                         # (m, n)
        sums = torch.zeros((m, ks, dsub), dtype=torch.float32, device=dev)
        sums.scatter_add_(1, ids[:, :, None].expand(m, n, dsub), subs)
        cnts = torch.zeros((m, ks), dtype=torch.float32, device=dev)
        cnts.scatter_add_(1, ids, ones)
        new = sums / cnts.clamp_min(1.0)[:, :, None]
        cent = torch.where((cnts > 0)[:, :, None], new, cent)
    return cent


def encode(centroids: torch.Tensor, data, *, device: DeviceLike = None
           ) -> torch.Tensor:
    """(n, d) -> (n, m) uint8 codes on `device`."""
    full_fp32()
    dev = resolve_device(device)
    cent = to_tensor(centroids, dev, torch.float32)
    x = to_tensor(data, dev, torch.float32)
    subs = split_subspaces(x, cent.shape[0])
    return _assign(subs, cent).T.contiguous().to(torch.uint8)


def exact_distances(queries: torch.Tensor, base: torch.Tensor, *,
                    metric: str = "l2") -> torch.Tensor:
    """(q, d) x (n, d) -> (q, n) full-precision distances (smaller=better)."""
    full_fp32()
    queries = queries.float()
    base = base.float()
    if metric == "l2":
        return _pairwise_sqdist(queries, base)
    if metric == "mips":
        return -(queries @ base.T)
    raise ValueError(f"unknown metric {metric!r}")


def groundtruth(queries, base, k: int, *, metric: str = "l2",
                batch: int = 262144, device: DeviceLike = None
                ) -> np.ndarray:
    """Brute-force top-k ids, chunked over the base set. Returns (q, k).

    The running top-k uses a stable sort, so equal distances keep the
    lower id first, as the reference's `lax.top_k` does.
    """
    dev = resolve_device(device)
    q = to_tensor(queries, dev, torch.float32)
    best_d = best_i = None
    for s in range(0, base.shape[0], batch):
        blk = to_tensor(base[s:s + batch], dev, torch.float32)
        d = exact_distances(q, blk, metric=metric)
        i = torch.arange(s, s + blk.shape[0], device=dev)[None, :] \
            .expand(q.shape[0], -1)
        if best_d is not None:
            d = torch.cat([best_d, d], dim=1)
            i = torch.cat([best_i, i], dim=1)
        best_d, pos = torch.sort(d, dim=1, stable=True)
        best_d = best_d[:, :k]
        best_i = i.gather(1, pos[:, :k])
    return best_i.cpu().numpy()


def recall_at(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """k-recall@k over a batch: |pred_k ∩ gt_k| / k averaged."""
    p, g = ids[:, :k], gt[:, :k]
    srt = np.sort(p, axis=1)
    if k > 1 and (srt[:, 1:] == srt[:, :-1]).any():
        # duplicate predictions: fall back to exact set semantics
        hits = sum(len(set(map(int, rp)) & set(map(int, rg)))
                   for rp, rg in zip(p, g))
        return hits / (ids.shape[0] * k)
    hits = (p[:, :, None] == g[:, None, :]).any(axis=2).sum()
    return float(hits) / (ids.shape[0] * k)
