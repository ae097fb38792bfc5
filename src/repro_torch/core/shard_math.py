"""Shard assignment + partial top-k merge (copy of
`repro.core.shard_math`).

One piece of math decides which shard owns which vector and how partial
per-shard answers merge into a global top-k: the process-level router
(``serving.router``) merges with it, so a routed answer is bit-identical
to the single-process reference the cluster drill compares against, and
to the reference package's merge of the same parts.

numpy only: a spawned cluster worker imports it on its way to the
serving stack.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

__all__ = ["ShardAssignment", "contiguous_shards", "merge_topk"]


class ShardAssignment(NamedTuple):
    """Contiguous partition of global label space [0, n) into shards.

    ``offsets[s]`` is the first global label owned by shard ``s`` and
    ``counts[s]`` how many it owns — the same (offset, count) pairs
    ``sharded_search.stack_shards`` feeds the device mesh, so a corpus
    split once serves both tiers.
    """

    n: int                    # total vectors across all shards
    offsets: np.ndarray       # (S,) int64, first global label per shard
    counts: np.ndarray        # (S,) int64, vectors per shard

    @property
    def n_shards(self) -> int:
        return len(self.offsets)

    def shard_of(self, label: int) -> int:
        """Which shard owns a global label."""
        if not 0 <= label < self.n:
            raise ValueError(f"label {label} outside [0, {self.n})")
        return int(np.searchsorted(self.offsets, label, side="right") - 1)

    def bounds(self, shard: int) -> Tuple[int, int]:
        """[lo, hi) global-label range owned by ``shard``."""
        lo = int(self.offsets[shard])
        return lo, lo + int(self.counts[shard])


def contiguous_shards(n: int, n_shards: int) -> ShardAssignment:
    """Split [0, n) into ``n_shards`` near-equal contiguous ranges.

    The first ``n % n_shards`` shards get one extra vector, matching
    ``np.array_split`` — and therefore matching every existing caller
    that split a corpus that way before handing it to ``stack_shards``.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if n < n_shards:
        raise ValueError(f"cannot split {n} vectors into {n_shards} shards")
    base, extra = divmod(n, n_shards)
    counts = np.full(n_shards, base, dtype=np.int64)
    counts[:extra] += 1
    offsets = np.zeros(n_shards, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    return ShardAssignment(n=n, offsets=offsets, counts=counts)


def merge_topk(ids_parts: Sequence[np.ndarray],
               dists_parts: Sequence[np.ndarray],
               k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-shard partial top-k lists into one global top-k.

    The host twin of a device mesh's all-gather + top-k merge:
    concatenate every shard's (ids, dists), sort by (dist, id) — the id
    tie-break makes the merge DETERMINISTIC regardless of shard arrival
    order, which is what lets the cluster drill demand bit-identical
    answers against a single-process reference — and keep the best k.
    Entries with id < 0 (per-shard padding when a shard holds fewer
    than k vectors) are dropped.  Short inputs yield a short output
    padded back to k with id -1 / dist +inf so the result shape is
    always (k,).
    """
    ids = np.concatenate([np.asarray(p, dtype=np.int64).ravel()
                          for p in ids_parts]) if ids_parts else \
        np.empty(0, np.int64)
    dists = np.concatenate([np.asarray(p, dtype=np.float32).ravel()
                            for p in dists_parts]) if dists_parts else \
        np.empty(0, np.float32)
    if ids.shape != dists.shape:
        raise ValueError(f"ids/dists shape mismatch: "
                         f"{ids.shape} vs {dists.shape}")
    live = ids >= 0
    ids, dists = ids[live], dists[live]
    order = np.lexsort((ids, dists))[:k]
    out_ids = np.full(k, -1, dtype=np.int64)
    out_dists = np.full(k, np.inf, dtype=np.float32)
    out_ids[:order.size] = ids[order]
    out_dists[:order.size] = dists[order]
    return out_ids, out_dists
