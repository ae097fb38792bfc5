"""The plain reference of the served search, in PyTorch, importing nothing
of the program.

It works out again, from the inputs the harness drew (corpus, graph,
centroids, codes, queries), everything the program derives from them:
each query's distance table, every hop of the beam search, the exact
rerank and the final top k. It reads neighbour codes as
codes[graph[node]], so it never sees the program's packed chunk table.

The entry point is the row nearest the corpus mean, in float64. The
search is path-dependent, so an entry point that differs changes nearly
every answer; `entry_margin` says how far the runner-up lies behind (a
margin near float32 rounding would let a float32 program pick another
row).

The search is AiSAQ's Algorithm 1 as the program serves it: a candidate
list of L slots ordered by PQ distance (stable: equal distances keep the
earlier slot first), a visited set of every id ever inserted, w frontier
rows a hop taken from the unexpanded candidates, an exact-distance pool
of L slots, at most `max_hops` hops, then the pool's top `rerank`
reranked exactly and the first k kept. Queries are searched in blocks;
a query's answer does not depend on the others in its block.

`dtype` is the precision of every distance: float32 is the reference,
bfloat16 the lower-precision control that must fail the comparison.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def entry_distances(vectors: torch.Tensor,
                    dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(N,) squared l2 distance of each row to the corpus mean, computed in
    `dtype` (the mean itself in float64): the quantity whose smallest row
    is the entry point."""
    step = 262_144
    mean = torch.zeros(vectors.shape[1], dtype=torch.float64,
                       device=vectors.device)
    for a in range(0, vectors.shape[0], step):
        mean += vectors[a:a + step].double().sum(0)
    mean = (mean / vectors.shape[0]).to(dtype)
    return torch.cat([((vectors[a:a + step].to(dtype) - mean) ** 2).sum(1)
                      .double() for a in range(0, vectors.shape[0], step)])


def entry_point(vectors: torch.Tensor) -> int:
    """The row nearest the corpus mean."""
    return int(entry_distances(vectors).argmin())


def entry_margin(dist: torch.Tensor) -> float:
    """How much farther from the mean the second-nearest row lies than
    the nearest, relative to the nearest."""
    two = torch.topk(dist, 2, largest=False).values
    return float((two[1] - two[0]) / two[0].clamp_min(1e-30))


def distance_table(q: torch.Tensor, centroids: torch.Tensor, metric: str,
                   dtype: torch.dtype) -> torch.Tensor:
    """(B, d) queries -> (B, m * ks) PQ distance table: squared l2 of each
    query slice to each centroid, or the negated inner product (mips)."""
    B = q.shape[0]
    m, ks, dsub = centroids.shape
    qs = q.to(dtype).reshape(B, m, 1, dsub)
    c = centroids.to(dtype)[None]
    if metric == "mips":
        t = -(qs * c).sum(-1)
    else:
        diff = qs - c
        t = (diff * diff).sum(-1)
    return t.reshape(B, m * ks)


def exact(q: torch.Tensor, v: torch.Tensor, metric: str,
          dtype: torch.dtype) -> torch.Tensor:
    """q (B, d), v (B, X, d) -> (B, X): squared l2, or -<q, v> (mips)."""
    qq = q.to(dtype)[:, None, :]
    vv = v.to(dtype)
    if metric == "mips":
        return -(vv * qq).sum(-1)
    diff = vv - qq
    return (diff * diff).sum(-1)


def _first_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest a row, equal values in slot order."""
    return torch.sort(d, dim=1, stable=True)[1][:, :k]


@dataclass
class Answers:
    ids: torch.Tensor          # (nq, k) int64, the answers
    hops: torch.Tensor         # (nq,) hops in which the query expanded a row
    lanes: torch.Tensor        # (nq,) frontier rows expanded over the search


def _search_block(inp: dict, ep: int, q: torch.Tensor, cfg: dict,
                  dtype: torch.dtype):
    vectors, graph, codes = inp["vectors"], inp["graph"], inp["codes"]
    metric, L, w, R = cfg["metric"], cfg["L"], cfg["w"], cfg["R"]
    n = vectors.shape[0]
    B, dev = q.shape[0], q.device
    m, ks = inp["centroids"].shape[:2]
    table = distance_table(q, inp["centroids"], metric, dtype)
    offs = torch.arange(m, device=dev) * ks

    def adc(ids: torch.Tensor) -> torch.Tensor:
        """PQ distances (B, X) of ids (B, X) >= 0."""
        idx = codes[ids].long() + offs
        return torch.gather(table, 1, idx.reshape(B, -1)) \
            .reshape(ids.shape + (m,)).sum(-1).float()

    inf = torch.tensor(float("inf"), device=dev)
    cand_ids = torch.full((B, L), -1, dtype=torch.long, device=dev)
    cand_d = torch.full((B, L), float("inf"), device=dev)
    cand_exp = torch.ones((B, L), dtype=torch.bool, device=dev)
    cand_ids[:, 0] = ep
    cand_d[:, 0] = adc(cand_ids[:, :1])[:, 0]
    cand_exp[:, 0] = False
    visited = torch.zeros((B, n), dtype=torch.bool, device=dev)
    visited[:, ep] = True
    pool_ids = torch.full((B, L), -1, dtype=torch.long, device=dev)
    pool_d = torch.full((B, L), float("inf"), device=dev)
    hops = torch.zeros(B, dtype=torch.long, device=dev)
    lanes = torch.zeros(B, dtype=torch.long, device=dev)
    for _ in range(cfg["max_hops"]):
        if not bool((~cand_exp & torch.isfinite(cand_d)).any()):
            break
        # frontier: the w nearest unexpanded candidates
        sel = torch.where(cand_exp, inf, cand_d)
        pos = _first_k(sel, w)
        live = torch.isfinite(sel.gather(1, pos))
        fids = torch.where(live, cand_ids.gather(1, pos), -1)
        cand_exp.scatter_(1, pos, cand_exp.gather(1, pos) | live)
        hops += live.any(1)
        lanes += live.sum(1)
        # expand: exact distances of the frontier, its neighbours' PQ
        safe = fids.clamp(min=0)
        ex = torch.where(live, exact(q, vectors[safe], metric, dtype)
                         .float(), inf)
        nb = graph[safe].long()                               # (B, w, R)
        nb = torch.where(live[:, :, None] & (nb >= 0), nb, -1) \
            .reshape(B, w * R)
        nd = torch.where(nb >= 0, adc(nb.clamp(min=0)), inf)
        # pool of exact distances
        pd = torch.cat([pool_d, ex], 1)
        pi = torch.cat([pool_ids, fids], 1)
        keep = _first_k(pd, L)
        pool_d, pool_ids = pd.gather(1, keep), pi.gather(1, keep)
        # insertion: drop padding, ids seen before, repeats within the hop
        seen = visited.gather(1, nb.clamp(min=0))
        srt, order = torch.sort(nb, dim=1, stable=True)
        rep_sorted = torch.cat([torch.zeros_like(srt[:, :1], dtype=torch.bool),
                                srt[:, 1:] == srt[:, :-1]], 1)
        rep = torch.zeros_like(rep_sorted).scatter_(1, order, rep_sorted)
        bad = (nb < 0) | seen | rep
        nb = torch.where(bad, -1, nb)
        nd = torch.where(bad, inf, nd)
        r_, c_ = torch.nonzero(~bad, as_tuple=True)
        visited[r_, nb[r_, c_]] = True
        # the candidate list: the L nearest of old and new
        ad = torch.cat([cand_d, nd], 1)
        keep = _first_k(ad, L)
        cand_ids = torch.cat([cand_ids, nb], 1).gather(1, keep)
        cand_exp = torch.cat([cand_exp, ~torch.isfinite(nd)], 1) \
            .gather(1, keep)
        cand_d = ad.gather(1, keep)
    top = _first_k(pool_d, cfg["rerank"])
    r_ids, r_d = pool_ids.gather(1, top), pool_d.gather(1, top)
    final = _first_k(r_d, cfg["k"])
    return r_ids.gather(1, final), hops, lanes


def search(inp: dict, queries: torch.Tensor, cfg: dict, *,
           dtype: torch.dtype = torch.float32, block: int = 256,
           ep: int | None = None) -> Answers:
    """Answers of every query row, searched `block` rows at a time.
    cfg: metric, L, w, R, max_hops, rerank, k (the served options)."""
    if ep is None:
        ep = entry_point(inp["vectors"])
    parts = [_search_block(inp, ep, queries[a:a + block], cfg, dtype)
             for a in range(0, queries.shape[0], block)]
    ids, hops, lanes = (torch.cat(p) for p in zip(*parts))
    return Answers(ids=ids, hops=hops, lanes=lanes)
