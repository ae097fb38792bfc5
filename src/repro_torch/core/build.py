"""End-to-end index construction: PQ training + Vamana + serialization
(port of `repro.core.build`).

PQ training and encoding run in torch on `device` (the card unless the
caller passes device="cpu"); the Vamana graph is the numpy builder
(`core.vamana`); the directory is written by `core.index_io.write_index`,
in the reference's format.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import IndexConfig
from repro_torch.core import nav as _nav
from repro_torch.core.index_io import write_index
from repro_torch.core.pq import encode, train_codebooks
from repro_torch.core.vamana import build_vamana, medoid
from repro_torch.device import DeviceLike, resolve_device, to_tensor

# PQ is trained on at most this many vectors, drawn as the reference draws
PQ_SAMPLE = 100_000


def draw_init_idx(n: int, ks: int, seed: int) -> np.ndarray:
    """ks initial centroid rows of n, from a torch.Generator seeded by
    `seed` (without replacement unless n < ks, as the reference's
    `jax.random.choice` draw, whose bits torch cannot reproduce)."""
    g = torch.Generator().manual_seed(seed)
    if n < ks:
        return torch.randint(0, n, (ks,), generator=g).numpy()
    return torch.randperm(n, generator=g)[:ks].numpy()


def build_index(path: str, vectors: np.ndarray, cfg: IndexConfig, *,
                mode: Optional[str] = None, seed: int = 0,
                init_idx: Optional[np.ndarray] = None,
                shared_centroids=None, graph: Optional[np.ndarray] = None,
                verbose: bool = False, relabel: bool = False,
                nav: bool = False, nav_fraction: Optional[float] = None,
                nav_degree: Optional[int] = None, nav_seed: int = 0,
                nav_method: Optional[str] = None,
                device: DeviceLike = None) -> dict:
    """Build one index directory from raw vectors (N, d) float32 or uint8.

    PQ: `shared_centroids` (m, ks, dsub) lets several corpora in one vector
    space share centroids (paper §4.4); else Lloyd k-means on the vectors,
    or on PQ_SAMPLE of them drawn with numpy's generator seeded by `seed`
    as the reference draws them, starting from the rows `init_idx` (ks,)
    of that sample. Without `init_idx` the rows come from `draw_init_idx`
    and meta.json records it under `pq_init`. `graph` (N, R) skips the
    Vamana build. `relabel=True` applies the graph-locality permutation at
    pack time. `nav=True` also builds the in-memory navigation tier
    (`core.nav`; the `nav_*` knobs default to its DEFAULT_* constants).
    Returns the meta dict (plus the build's `build_pq_s` and
    `build_graph_s`).
    """
    nav_kw = dict(nav=nav,
                  nav_fraction=_nav.DEFAULT_FRACTION
                  if nav_fraction is None else nav_fraction,
                  nav_degree=_nav.DEFAULT_DEGREE
                  if nav_degree is None else nav_degree,
                  nav_seed=nav_seed,
                  nav_method=_nav.DEFAULT_METHOD
                  if nav_method is None else nav_method)
    dev = resolve_device(device)
    mode = mode or cfg.mode
    t0 = time.perf_counter()
    vec_f = vectors.astype(np.float32)
    n = vectors.shape[0]
    extra = {}
    if shared_centroids is not None:
        centroids = to_tensor(shared_centroids, dev, torch.float32)
    else:
        sample = vec_f if n <= PQ_SAMPLE else vec_f[
            np.random.default_rng(seed).choice(n, PQ_SAMPLE, replace=False)]
        if init_idx is None:
            init_idx = draw_init_idx(sample.shape[0], cfg.pq_ks, seed)
            extra["pq_init"] = f"torch.Generator(seed={seed})"
        centroids = train_codebooks(sample, m=cfg.pq_m, init_idx=init_idx,
                                    ks=cfg.pq_ks, device=dev)
    codes = encode(centroids, vec_f, device=dev).cpu().numpy()
    centroids = centroids.cpu().numpy()
    t_pq = time.perf_counter() - t0
    if graph is None:
        graph = build_vamana(vec_f, R=cfg.R, L=cfg.build_L, alpha=cfg.alpha,
                             metric=cfg.metric, seed=seed)
    t_graph = time.perf_counter() - t0 - t_pq
    ep = np.array([medoid(vec_f, cfg.metric)])
    meta = write_index(path, vectors=vectors, graph=graph,
                       centroids=centroids, codes=codes, metric=cfg.metric,
                       mode=mode, block_bytes=cfg.block_bytes, n_ep=cfg.n_ep,
                       entry_points=ep, relabel=relabel, **nav_kw,
                       extra_meta=dict(build_pq_s=t_pq,
                                       build_graph_s=t_graph, **extra))
    if verbose:
        print(f"built {path}: n={n} pq={t_pq:.1f}s graph={t_graph:.1f}s "
              f"on {dev}")
    return meta
