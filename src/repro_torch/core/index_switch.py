"""Multi-corpus index management + fast switching (paper §2.2, §4.4; port
of `repro.core.index_switch`, whose handles search on `device`).

The RAG scenario: one retriever process serves requests that may target any
of several corpora. DiskANN must reload N-proportional PQ tables per switch;
AiSAQ reloads only entry-point codes (+ centroids unless shared).

`IndexManager` is a thin wrapper over a budget-for-one
`serving.pool.WarmIndexPool` (`max_open=1`): the pool owns the open handle,
the shared-centroid dedup and the eviction of the previous corpus.  A pool
with a larger budget holds MANY corpora warm at once.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.index_io import HostIndex
from repro_torch.device import DeviceLike
from repro_torch.serving.pool import WarmIndexPool


class IndexManager:
    """Holds one active HostIndex; switches between registered corpora."""

    def __init__(self, paths: Dict[str, str], mode: Optional[str] = None,
                 *, device: DeviceLike = None):
        self.pool = WarmIndexPool(paths, max_open=1, mode=mode,
                                  device=device)
        self.mode = mode
        self.active_name: Optional[str] = None

    @property
    def paths(self) -> Dict[str, str]:
        return self.pool.paths

    @property
    def active(self) -> Optional[HostIndex]:
        if self.active_name is None:
            return None
        return self.pool.peek(self.active_name)

    @property
    def _centroids(self) -> Optional[np.ndarray]:
        idx = self.active
        return None if idx is None else idx.centroids

    def switch(self, name: str, share_centroids: bool = True) -> float:
        """Activate corpus `name`. Returns switch wall-time in seconds.

        If the target index was built with the same PQ centroids as the
        currently-loaded ones (hash match in meta.json) and
        `share_centroids`, skip the centroid load — paper Table 4's 0.3 ms
        row, where only ~4 KiB of metadata moves.  Raises a `KeyError`
        naming the known corpora when `name` was never registered.
        """
        if name == self.active_name:
            return 0.0
        dt = self.pool.ensure(name, share_centroids=share_centroids)
        self.active_name = name
        return dt

    def search(self, q, k: int, L: int, w: int = 4):
        assert self.active is not None, "switch() to a corpus first"
        return self.active.search(q, k, L, w)

    def search_batch(self, Q, k: int, L: int, w: int = 4):
        assert self.active is not None, "switch() to a corpus first"
        return self.active.search_batch(Q, k, L, w)

    def resident_bytes(self) -> int:
        idx = self.active
        return 0 if idx is None else idx.resident_bytes()

    def close(self):
        self.pool.close()
        self.active_name = None
