"""A cell's inputs, drawn on the device from the run's seed.

Everything the program and the reference are handed comes from here:
the corpus, the query pool, the start graph, the PQ centroids and the
codes. Each draws from its own generator, keyed by the seed and a name,
so the size of one input never shifts another's numbers.

The corpus is a gaussian mixture with power-law cluster weights (the
recipe of the port's `data/vectors.make_clustered`, drawn in row blocks on
the device instead of on the host); the graph is the random R-regular
digraph `core/vamana.random_regular_graph` draws (a copy); the centroids
come from a few Lloyd iterations on a sample, and the codes are each row's
nearest centroid a subspace.
"""
from __future__ import annotations

import hashlib

import torch

BLOCK_ROWS = 262_144          # rows a generator block, bounding temporaries


def generator(seed: int, name: str, device) -> torch.Generator:
    """A generator on `device` for one named stream of the run `seed`
    (any whole number; hashed to 63 bits)."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h[:8], "little") >> 1)


def clustered(n: int, d: int, g: torch.Generator, *, n_clusters: int,
              spread: float, dtype: str = "float32",
              normalize: bool = False) -> torch.Tensor:
    """(n, d) rows of a gaussian mixture: centres N(0, 1), cluster weights
    proportional to 1 / rank^0.7, each row its centre plus N(0, spread^2)
    noise. `normalize` scales rows to unit length (embedding models'
    outputs); uint8 maps centre range +- 4 spread onto 0..255."""
    dev = g.device
    centers = torch.randn((n_clusters, d), generator=g, device=dev)
    w = 1.0 / torch.arange(1, n_clusters + 1, device=dev,
                           dtype=torch.float64) ** 0.7
    cdf = torch.cumsum(w / w.sum(), 0)
    u = torch.rand((n,), generator=g, device=dev, dtype=torch.float64)
    assign = torch.searchsorted(cdf, u).clamp_(max=n_clusters - 1)
    out_dtype = torch.uint8 if dtype == "uint8" else torch.float32
    out = torch.empty((n, d), dtype=out_dtype, device=dev)
    lo = float(centers.min()) - 4 * spread
    hi = float(centers.max()) + 4 * spread
    for a in range(0, n, BLOCK_ROWS):
        b = min(n, a + BLOCK_ROWS)
        x = centers[assign[a:b]]
        x += spread * torch.randn((b - a, d), generator=g, device=dev)
        if normalize:
            x /= x.norm(dim=1, keepdim=True).clamp_min(1e-12)
        if dtype == "uint8":
            x = ((x - lo) / (hi - lo) * 255).clamp_(0, 255)
        out[a:b] = x.to(out_dtype)
    return out


def queries(nq: int, base: torch.Tensor, g: torch.Generator, *,
            noise: float, normalize: bool = False) -> torch.Tensor:
    """(nq, d) f32 queries near base rows (the realistic ANN regime): a
    row drawn with replacement plus noise * N(0, 1) * the mean |entry|."""
    idx = torch.randint(0, base.shape[0], (nq,), generator=g,
                        device=base.device)
    q = base[idx].float()
    q += noise * torch.randn(q.shape, generator=g, device=q.device) \
        * (q.abs().mean() + 1e-6)
    if normalize:
        q /= q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return q


def random_regular_graph(n: int, R: int, g: torch.Generator
                         ) -> torch.Tensor:
    """(n, R) int32: each row R distinct ids other than its own, drawn with
    replacement and redrawn where a row repeats one (a copy of the port's
    `core/vamana.random_regular_graph`). Needs n > R."""
    if n <= R:
        raise ValueError(f"need n > R for an R-regular digraph (n={n}, R={R})")
    dev = g.device
    rows = torch.arange(n, device=dev)[:, None].expand(n, R)

    def draw(row_ids: torch.Tensor) -> torch.Tensor:
        nb = torch.randint(0, n - 1, row_ids.shape, generator=g, device=dev)
        return nb + (nb >= row_ids).long()

    graph = draw(rows)
    while True:
        srt, order = graph.sort(dim=1)
        dup_sorted = srt[:, 1:] == srt[:, :-1]
        if not bool(dup_sorted.any()):
            return graph.to(torch.int32)
        dup = torch.zeros_like(graph, dtype=torch.bool)
        dup.scatter_(1, order[:, 1:], dup_sorted)
        graph[dup] = draw(rows[dup])


def _nearest(xs: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """xs (m, b, dsub), cents (m, ks, dsub) -> (m, b) index of the nearest
    centroid a subspace (squared l2; the row norm does not change it)."""
    cn = (cents * cents).sum(-1)                              # (m, ks)
    score = torch.baddbmm(cn[:, None, :], xs, cents.transpose(1, 2),
                          alpha=-2.0)
    return score.argmin(-1)


def train_pq(sample: torch.Tensor, m: int, ks: int, iters: int,
             g: torch.Generator, *, sub_block: int = 16) -> torch.Tensor:
    """(m, ks, dsub) f32 centroids: Lloyd's k-means a subspace on `sample`
    (S, d), from ks distinct sample rows; an empty cluster keeps its
    centroid."""
    S, d = sample.shape
    if d % m:
        raise ValueError(f"d={d} does not split into m={m} subspaces")
    dsub = d // m
    xs = sample.float().reshape(S, m, dsub).transpose(0, 1).contiguous()
    init = torch.randperm(S, generator=g, device=sample.device)[:ks]
    cents = xs[:, init].clone()
    for _ in range(iters):
        for j in range(0, m, sub_block):
            x = xs[j:j + sub_block]
            a = _nearest(x, cents[j:j + sub_block])            # (mb, S)
            mb = x.shape[0]
            sums = torch.zeros((mb, ks, dsub), device=x.device)
            sums.scatter_add_(1, a[:, :, None].expand(mb, S, dsub), x)
            cnt = torch.zeros((mb, ks), device=x.device)
            cnt.scatter_add_(1, a, torch.ones_like(a, dtype=torch.float32))
            upd = sums / cnt.clamp_min(1)[:, :, None]
            cents[j:j + sub_block] = torch.where(cnt[:, :, None] > 0, upd,
                                                 cents[j:j + sub_block])
    return cents


def encode(x: torch.Tensor, cents: torch.Tensor, *,
           block_rows: int = 16_384) -> torch.Tensor:
    """(n, m) uint8 PQ codes of the rows of x under `cents`."""
    n, d = x.shape
    m, ks, dsub = cents.shape
    codes = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    for a in range(0, n, block_rows):
        b = min(n, a + block_rows)
        xs = x[a:b].float().reshape(b - a, m, dsub).transpose(0, 1)
        codes[a:b] = _nearest(xs, cents).T.to(torch.uint8)
    return codes


def draw_index(cfg: dict, seed: int, device) -> dict:
    """The corpus, graph, centroids and codes of configuration `cfg` on
    `device`: drawn from the configuration's own `data.seed` where it has
    one (a deployment serves one corpus, whatever the traffic), else from
    the run's `seed`."""
    data, pq = cfg["data"], cfg["pq_train"]
    seed = data.get("seed", seed)
    n, d = cfg["n_vectors"], cfg["dim"]
    vecs = clustered(n, d, generator(seed, "corpus", device),
                     n_clusters=data["n_clusters"], spread=data["spread"],
                     dtype=cfg["data_dtype"], normalize=data["normalize"])
    graph = random_regular_graph(n, cfg["R"],
                                 generator(seed, "graph", device))
    g = generator(seed, "pq", device)
    rows = torch.randint(0, n, (min(n, pq["sample"]),), generator=g,
                         device=device)
    cents = train_pq(vecs[rows], cfg["pq_m"], cfg["pq_ks"], pq["iters"], g)
    codes = encode(vecs, cents)
    return {"vectors": vecs, "graph": graph, "centroids": cents,
            "codes": codes}


def draw_queries(cfg: dict, n_queries: int, base: torch.Tensor, seed: int
                 ) -> torch.Tensor:
    data = cfg["data"]
    return queries(n_queries, base, generator(seed, "queries", base.device),
                   noise=data["query_noise"], normalize=data["normalize"])
