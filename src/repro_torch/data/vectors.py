"""Synthetic vector corpora (copy of `repro.data.vectors`).

A gaussian mixture with power-law cluster weights stands in for SIFT's
clustered descriptors; a plain gaussian makes ANN search uninformative.
"""
from __future__ import annotations

import numpy as np


def make_clustered(n: int, d: int, *, n_clusters: int = 64, seed: int = 0,
                   dtype: str = "float32", spread: float = 0.15) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    w = 1.0 / np.arange(1, n_clusters + 1) ** 0.7
    w = w / w.sum()
    assign = rng.choice(n_clusters, size=n, p=w)
    x = centers[assign] + spread * rng.normal(size=(n, d)).astype(np.float32)
    if dtype == "uint8":
        lo, hi = x.min(), x.max()
        return np.clip((x - lo) / (hi - lo) * 255, 0, 255).astype(np.uint8)
    return x.astype(np.float32)


def make_queries(n_q: int, base: np.ndarray, *, seed: int = 1,
                 noise: float = 0.05) -> np.ndarray:
    """Queries near base points (realistic ANN regime)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(base.shape[0], size=n_q, replace=False)
    q = base[idx].astype(np.float32)
    q = q + noise * rng.normal(size=q.shape).astype(np.float32) * (
        np.abs(q).mean() + 1e-6)
    return q.astype(np.float32)
