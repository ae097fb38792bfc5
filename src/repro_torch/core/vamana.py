"""Vamana graph construction (DiskANN's build algorithm; numpy copy of
`repro.core.vamana`) plus the random R-regular start graph on the device.

Faithful to Subramanya et al. (NeurIPS'19):
  1. start from a random R-regular digraph, entry point = medoid
  2. for each point p in random order: greedy-search(medoid -> p) collecting
     the visited set V; N_out(p) = RobustPrune(p, V, alpha, R); add reverse
     edges, pruning any node whose degree exceeds R
  3. two passes: alpha=1.0 then alpha=cfg.alpha
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _dists(data: np.ndarray, q: np.ndarray, ids: np.ndarray, metric: str
           ) -> np.ndarray:
    sub = data[ids]
    if metric == "mips":
        return -(sub @ q)
    diff = sub - q
    return np.einsum("nd,nd->n", diff, diff)


def medoid(data: np.ndarray, metric: str = "l2") -> int:
    mean = data.mean(axis=0)
    if metric == "mips":
        return int(np.argmax(data @ mean))
    d = ((data - mean) ** 2).sum(axis=1)
    return int(np.argmin(d))


def greedy_search(data: np.ndarray, graph: np.ndarray, q: np.ndarray,
                  start: int, L: int, metric: str = "l2",
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (topL_ids, topL_dists, visited_ids_in_expansion_order)."""
    cand_ids = np.array([start], dtype=np.int64)
    cand_d = _dists(data, q, cand_ids, metric)
    inserted = {start}
    expanded: list[int] = []
    expanded_set = set()
    while True:
        # closest unexpanded among top-L
        order = np.argsort(cand_d, kind="stable")
        cand_ids, cand_d = cand_ids[order][:L], cand_d[order][:L]
        nxt = -1
        for i in range(cand_ids.shape[0]):
            if int(cand_ids[i]) not in expanded_set:
                nxt = int(cand_ids[i])
                break
        if nxt < 0:
            break
        expanded.append(nxt)
        expanded_set.add(nxt)
        nbrs = graph[nxt]
        nbrs = nbrs[nbrs >= 0]
        fresh = np.array([v for v in nbrs if int(v) not in inserted],
                         dtype=np.int64)
        if fresh.size:
            inserted.update(int(v) for v in fresh)
            fd = _dists(data, q, fresh, metric)
            cand_ids = np.concatenate([cand_ids, fresh])
            cand_d = np.concatenate([cand_d, fd])
    return cand_ids, cand_d, np.array(expanded, dtype=np.int64)


def robust_prune(data: np.ndarray, p: int, cand: np.ndarray, alpha: float,
                 R: int, metric: str = "l2") -> np.ndarray:
    """RobustPrune: diversified neighbor selection. Returns <=R ids."""
    cand = np.unique(cand)
    cand = cand[cand != p]
    if cand.size == 0:
        return cand
    d_p = _dists(data, data[p], cand, metric)
    order = np.argsort(d_p, kind="stable")
    cand, d_p = cand[order], d_p[order]
    alive = np.ones(cand.size, dtype=bool)
    out = []
    for _ in range(R):
        idx = np.flatnonzero(alive)
        if idx.size == 0:
            break
        star = idx[0]
        out.append(int(cand[star]))
        alive[star] = False
        rest = np.flatnonzero(alive)
        if rest.size == 0:
            break
        d_star = _dists(data, data[cand[star]], cand[rest], metric)
        # occlusion rule: drop v if alpha * d(p*, v) <= d(p, v)
        alive[rest[alpha * d_star <= d_p[rest]]] = False
    return np.array(out, dtype=np.int64)


def build_vamana(data: np.ndarray, *, R: int, L: int, alpha: float = 1.2,
                 metric: str = "l2", seed: int = 0, two_pass: bool = True
                 ) -> np.ndarray:
    """Returns adjacency (N, R) int32, -1 padded. data: (N, d)."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    n = data.shape[0]
    rng = np.random.default_rng(seed)
    # random init graph
    graph = np.full((n, R), -1, dtype=np.int32)
    init_deg = min(R, max(1, min(R, n - 1)))
    for i in range(n):
        nb = rng.choice(n - 1, size=init_deg, replace=n - 1 < init_deg)
        nb = nb + (nb >= i)          # skip self
        graph[i, :init_deg] = nb
    ep = medoid(data, metric)
    passes = ([1.0, alpha] if two_pass else [alpha])
    for a in passes:
        order = rng.permutation(n)
        for p in order:
            p = int(p)
            _, _, expanded = greedy_search(data, graph, data[p], ep, L,
                                           metric)
            cand = np.concatenate([expanded, graph[p][graph[p] >= 0]])
            nbrs = robust_prune(data, p, cand, a, R, metric)
            graph[p, :] = -1
            graph[p, :nbrs.size] = nbrs
            # reverse edges
            for j in nbrs:
                j = int(j)
                row = graph[j]
                if p in row:
                    continue
                slot = np.flatnonzero(row < 0)
                if slot.size:
                    row[slot[0]] = p
                else:
                    merged = np.concatenate([row[row >= 0], [p]])
                    pruned = robust_prune(data, j, merged, a, R, metric)
                    graph[j, :] = -1
                    graph[j, :pruned.size] = pruned
    return graph


def random_regular_graph(n: int, R: int, *, seed: int = 0,
                         device: DeviceLike = None) -> torch.Tensor:
    """The random R-regular digraph `build_vamana` starts from, drawn on
    `device` (None: the card, as every entry point; "cpu" asks for the
    CPU): (n, R) int32, each row R distinct ids other than its own.

    Ids are drawn with replacement; each repeated id within a row is drawn
    again until no row holds one, so the result is exact without a host
    loop over n. Needs n > R.
    """
    if n <= R:
        raise ValueError(f"need n > R for an R-regular digraph (n={n}, R={R})")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.arange(n, device=device)[:, None].expand(n, R)

    def draw(row_ids: torch.Tensor) -> torch.Tensor:
        nb = torch.randint(0, n - 1, row_ids.shape, generator=gen,
                           device=device)
        return nb + (nb >= row_ids).long()           # skip self

    graph = draw(rows)
    while True:
        srt, order = graph.sort(dim=1)
        dup_sorted = srt[:, 1:] == srt[:, :-1]
        if not bool(dup_sorted.any()):
            return graph.to(torch.int32)
        dup = torch.zeros_like(graph, dtype=torch.bool)
        dup.scatter_(1, order[:, 1:], dup_sorted)    # later copies only
        graph[dup] = draw(rows[dup])
