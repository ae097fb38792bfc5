"""Graph-locality node relabeling (PAGE / DiskANN++-style page packing;
copy of `repro.core.relabel`).

The cold-path cost of storage-backed beam search is dominated by how many
distinct ``io_bytes`` units each hop touches: neighbor ids assigned in build
order are scattered across chunks.bin, so every frontier expansion pulls
blocks from all over the file. Relabeling assigns new node ids so that

  * graph neighbors land in the SAME block whenever ``nodes_per_block > 1``
    (greedy page packing: each block is seeded by the next BFS node and
    filled with its unassigned out-neighbors), and
  * BFS order makes ids of nodes expanded in consecutive hops *numerically
    close*, so the per-hop miss set coalesces into few contiguous preadv
    runs even when a block holds a single chunk.

The permutation is applied once at pack time (``core.index_io.write_index``,
``relabeled: true`` in meta.json + the old->new map in ``id_map.npy``);
search backends map result ids back to the original labels, so relabeling
is invisible to callers (groundtruth, recall, serving all keep original
ids).
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np


def locality_permutation(graph: np.ndarray, nodes_per_block: int,
                         entry_points: Optional[np.ndarray] = None
                         ) -> np.ndarray:
    """Compute the old->new id permutation for a Vamana graph.

    graph: (n, R) int adjacency, -1 padded. nodes_per_block: chunks that
    share one I/O unit (ChunkLayout.nodes_per_block; 0 -> multi-block
    chunks, plain BFS order still helps run contiguity). Returns
    old_to_new (n,) int64 with ``old_to_new[old_id] == new_id``.
    """
    graph = np.asarray(graph)
    n = graph.shape[0]
    npb = nodes_per_block if nodes_per_block and nodes_per_block > 0 else 1
    taken = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)        # order[new] = old
    pos = 0
    queue: deque = deque()
    if entry_points is not None:
        queue.extend(int(e) for e in np.atleast_1d(entry_points))
    scan = 0                                   # covers disconnected nodes
    while pos < n:
        while queue and taken[queue[0]]:
            queue.popleft()
        if queue:
            u = int(queue.popleft())
        else:
            while taken[scan]:
                scan += 1
            u = scan
        if taken[u]:
            continue
        taken[u] = True
        order[pos] = u
        pos += 1
        # pack u's block: local BFS from u fills the remaining slots with
        # a connected cluster (neighbors, then neighbors-of-neighbors)
        room = (-pos) % npb
        local = deque([u])
        while room and local:
            v = local.popleft()
            for x in graph[v]:
                x = int(x)
                if x < 0 or taken[x]:
                    continue
                taken[x] = True
                order[pos] = x
                pos += 1
                local.append(x)
                queue.append(x)
                room -= 1
                if not room:
                    break
        queue.extend(int(v) for v in graph[u] if v >= 0)  # BFS continues
    old_to_new = np.empty(n, dtype=np.int64)
    old_to_new[order] = np.arange(n, dtype=np.int64)
    return old_to_new


def invert_permutation(old_to_new: np.ndarray) -> np.ndarray:
    """old->new map -> new->old map (both are permutations of arange(n))."""
    old_to_new = np.asarray(old_to_new, dtype=np.int64)
    new_to_old = np.empty_like(old_to_new)
    new_to_old[old_to_new] = np.arange(old_to_new.size, dtype=np.int64)
    return new_to_old


def apply_permutation(old_to_new: np.ndarray, vectors: np.ndarray,
                      graph: np.ndarray, codes: np.ndarray,
                      entry_points: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Reorder all build arrays into new-id space.

    Row i of each output describes the node whose NEW id is i; neighbor ids
    inside the graph are rewritten to new labels (-1 padding preserved).
    """
    new_to_old = invert_permutation(old_to_new)
    vectors_p = np.ascontiguousarray(vectors[new_to_old])
    codes_p = np.ascontiguousarray(codes[new_to_old])
    g = graph[new_to_old]
    graph_p = np.where(g >= 0, old_to_new[np.where(g >= 0, g, 0)],
                       -1).astype(graph.dtype)
    eps_p = old_to_new[np.asarray(entry_points, dtype=np.int64)]
    return vectors_p, graph_p, codes_p, eps_p


def block_locality_score(graph: np.ndarray, old_to_new: Optional[np.ndarray],
                         nodes_per_block: int) -> float:
    """Mean fraction of each node's neighbors co-resident in its block.

    The direct objective page packing maximizes; used by tests and the
    cold-path benchmark to show the relabeled layout actually co-locates.
    """
    if not nodes_per_block:
        return 0.0
    graph = np.asarray(graph)
    n = graph.shape[0]
    ids = np.arange(n, dtype=np.int64) if old_to_new is None \
        else np.asarray(old_to_new, dtype=np.int64)
    valid = graph >= 0
    safe = np.where(valid, graph, 0)
    same = (ids[safe] // nodes_per_block) == \
        (ids[:, None] // nodes_per_block)
    deg = valid.sum(axis=1)
    frac = (same & valid).sum(axis=1) / np.maximum(deg, 1)
    return float(frac[deg > 0].mean()) if (deg > 0).any() else 0.0
