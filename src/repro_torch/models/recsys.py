"""Recommender models: DLRM, DCN-v2, Wide&Deep and SASRec, with their CTR
forward and retrieval over PQ codes (port of `repro.models.recsys`).

The `retrieval_cand` regime scores one user against every item of the
catalogue (the rows of table 0, projected by `item_proj`), in two ways:
  * exact — the user tower dotted with every projected item embedding;
  * pq    — the paper's technique: ADC over the PQ codes of the projected
            item embeddings (`kernels.ops.adc`), then an exact re-rank of
            the top k * rerank_mult.

Parameters live in one `nn.Module` per kind (`DLRM`, `DCNv2`, `WideDeep`,
`SASRec`), made by `init_recsys` from a `torch.Generator` or carried
across from the JAX package's parameter pytree by
`recsys_params_from_jax`. Tables keep the reference's padding
(`padded_vocab`) and its published cardinalities.

`rec_loss` is differentiable. Every table read goes through `lookup`,
whose gradient to the table is a sparse COO tensor of the rows read, so
training never holds a dense (V, D) table gradient (the reference's
`jnp.take` gives one); `repro_torch.optim.adamw` updates the touched
rows only. The serving functions run without autograd.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs import RecsysConfig
from repro_torch.cudagraph import Graph, warm_up
from repro_torch.device import DeviceLike, full_fp32, resolve_device, \
    to_tensor
from repro_torch.kernels import ops
from repro_torch.launch.mesh import reduce_forward
from repro_torch.models.layers import init_dense, mlp_apply, mlp_stack, \
    truncnorm_init

VOCAB_PAD = 2048  # table rows padded as the reference pads them

# the request inputs each kind's user tower reads (make_retrieval_fn)
TOWER_INPUTS = {"sasrec": ("seq",), "dlrm": ("dense", "sparse"),
                "dcnv2": ("sparse",), "widedeep": ("sparse",)}


def padded_vocab(v: int) -> int:
    return max(VOCAB_PAD, (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD)


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (V, D), idx (...) int -> (..., D). Under autograd the table's
    gradient is a sparse COO tensor of the rows read (duplicates kept; the
    optimizer sums them): the dense (V, D) gradient of plain indexing
    would double a table's footprint (DLRM-rm2: 48 GB more). Without
    autograd it is the plain gather, the same values: `F.embedding`'s
    gather made Wide&Deep's 262,144-row CTR forward 31% slower on the card
    (PERF.md §6)."""
    idx = idx.long()
    if torch.is_grad_enabled() and table.requires_grad:
        return F.embedding(idx, table, sparse=True)
    return table[idx]


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """table (V, D), idx (..., hot) int -> (..., D); in training the
    table's gradient is sparse (`lookup`)."""
    e = lookup(table, idx)                    # (..., hot, D)
    if combiner == "sum":
        return e.sum(dim=-2)
    if combiner == "mean":
        return e.mean(dim=-2)
    raise ValueError(combiner)


class TableShards:
    """The row blocks a sharded model holds: {leaf path: lo}, the first
    row of this rank's block of a row-sharded table (`tables/i`,
    `wide/i`), and the `model` group whose sum reassembles a lookup."""

    def __init__(self, starts: Dict[str, int], group):
        self.starts, self.group = starts, group


def _local_rows(table: torch.Tensor, idx: torch.Tensor, lo: int
                ) -> torch.Tensor:
    """`table` holds rows [lo, lo + len) of a row-sharded table: the rows
    of `idx` in that range, zeros for the others (..., D). Under autograd
    the table's gradient is sparse over its own rows, by local id."""
    flat = idx.reshape(-1).long()
    if flat.device.type == "meta":
        # a meta trace (`launch.dryrun`) cannot size the ids in range:
        # it takes every id as one (the most the rank can read)
        pos = torch.arange(flat.numel(), device=flat.device)
    else:
        pos = ((flat >= lo) & (flat < lo + table.shape[0])).nonzero()[:, 0]
    e = lookup(table, flat[pos] - lo)
    out = e.new_zeros((flat.numel(),) + tuple(table.shape[1:])) \
        .index_copy(0, pos, e)
    return out.view(tuple(idx.shape) + tuple(table.shape[1:]))


def table_rows(p: "Recsys", path: str, table: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """`lookup(table, idx)`; when the model holds only its row block of
    the table at `path`, each rank looks up the ids in its own range and
    the rows are summed over `model` (the psum GSPMD inserts for the
    reference)."""
    sh = p.shards
    lo = None if sh is None else sh.starts.get(path)
    if lo is None:
        return lookup(table, idx)
    return reduce_forward(_local_rows(table, idx, lo), sh.group)


def bags(p: "Recsys", tables, prefix: str, sparse: torch.Tensor
         ) -> torch.Tensor:
    """(B, n, D): field i's bag of ids (sparse[:, i, :]) summed in table i
    (`prefix`/i). Row-sharded tables look up their own rows, and their
    bags are summed over `model` in one all-reduce."""
    sh = p.shards
    parts, cut = [], []
    for i, t in enumerate(tables):
        lo = None if sh is None else sh.starts.get(f"{prefix}/{i}")
        if lo is None:
            parts.append(embedding_bag(t, sparse[:, i, :]))
        else:
            parts.append(_local_rows(t, sparse[:, i, :], lo).sum(dim=-2))
            cut.append(i)
    if cut:
        summed = reduce_forward(torch.stack([parts[i] for i in cut], 1),
                                sh.group)
        for i, r in zip(cut, summed.unbind(1)):
            parts[i] = r
    return torch.stack(parts, dim=1)


def _ln(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
        ) -> torch.Tensor:
    """The reference's layer norm: no bias, biased variance, eps 1e-6
    (not `nn.LayerNorm`)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale


class Recsys(nn.Module):
    """The parameters every kind has: the sparse tables and the retrieval
    tower's item projection. A model that holds only this rank's rows of
    its row-sharded tables (a sharded train state) carries `shards`
    (`TableShards`); the training and CTR forwards then read the tables
    through `table_rows` and `bags`."""

    shards = None

    def __init__(self, tables, item_proj):
        super().__init__()
        self.tables = nn.ParameterList(nn.Parameter(t) for t in tables)
        self.item_proj = nn.Parameter(item_proj)

    @property
    def device(self) -> torch.device:
        return self.item_proj.device


class DLRM(Recsys):
    """DLRM: a bottom MLP over the dense features, pairwise dot products
    of the (dense, sparse) embeddings, and a top MLP over both."""

    def __init__(self, tables, bot: nn.ModuleList, top: nn.ModuleList,
                 item_proj):
        super().__init__(tables, item_proj)
        self.bot, self.top = bot, top


class DCNv2(Recsys):
    """DCN-v2: cross layers `x0 * (x @ w + b) + x`, then a deep MLP."""

    def __init__(self, tables, cross: nn.ModuleList, mlp: nn.ModuleList,
                 item_proj):
        super().__init__(tables, item_proj)
        self.cross, self.mlp = cross, mlp


class WideDeep(Recsys):
    """Wide&Deep: a deep MLP over the concatenated embeddings plus a wide
    term, one scalar table per field."""

    def __init__(self, tables, wide, mlp: nn.ModuleList, item_proj):
        super().__init__(tables, item_proj)
        self.wide = nn.ParameterList(nn.Parameter(t) for t in wide)
        self.mlp = mlp


class SASRecBlock(nn.Module):
    """One self-attention block: single-head causal attention and a
    two-layer relu MLP, each behind a pre-norm residual."""

    def __init__(self, wq, wk, wv, ln1, ln2, ff: nn.ModuleList):
        super().__init__()
        self.wq, self.wk, self.wv = (nn.Parameter(t) for t in (wq, wk, wv))
        self.ln1, self.ln2 = nn.Parameter(ln1), nn.Parameter(ln2)
        self.ff = ff


class SASRec(Recsys):
    """SASRec's parameters (item tables, positions, blocks, the retrieval
    tower's item projection); `forward(seq)` is the reference's
    `sasrec_hidden`: (B, S) item ids -> (B, S, D) hidden states."""

    def __init__(self, tables, pos, blocks, item_proj):
        super().__init__(tables, item_proj)
        self.pos = nn.Parameter(pos)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        full_fp32()
        S = seq.shape[1]
        D = self.pos.shape[1]
        # sqrt(D) rounded to float32, as the reference divides by it
        inv = float(np.sqrt(np.float32(D)))
        x = table_rows(self, "tables/0", self.tables[0], seq) \
            + self.pos[None, :S]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=x.device))
        for b in self.blocks:
            xn = _ln(x, b.ln1)
            q, k, v = xn @ b.wq, xn @ b.wk, xn @ b.wv
            s = torch.einsum("bqd,bkd->bqk", q, k) / inv
            s = torch.where(mask, s, -1e30)
            x = x + torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), v)
            x = x + mlp_apply(b.ff, _ln(x, b.ln2))
        return x


# ---------------------------------------------------------------------------
# init and carry-across
# ---------------------------------------------------------------------------


def init_recsys(cfg: RecsysConfig, *, generator: torch.Generator,
                device: DeviceLike = None, keep=None) -> Recsys:
    """Random parameters of `cfg.kind` on `device` (default: the card),
    drawn from `generator`, with the reference's shapes and scales. Each
    table is drawn in place at its padded size, one after another;
    `keep(path, table)`, when given, says what to hold of each table
    (`tables/i`, `wide/i`) as it comes (a sharded init keeps its rows)."""
    dev = resolve_device(device)
    D = cfg.embed_dim
    kw = dict(generator=generator, device=dev)
    keep = keep or (lambda path, t: t)
    tables = [keep(f"tables/{i}", truncnorm_init((padded_vocab(v), D), 0.05,
                                                 **kw))
              for i, v in enumerate(cfg.vocab_sizes)]
    if cfg.kind == "dlrm":
        bot = mlp_stack((cfg.n_dense,) + cfg.bot_mlp, **kw)
        n_f = cfg.n_sparse + 1
        d_int = n_f * (n_f - 1) // 2 + cfg.bot_mlp[-1]
        top = mlp_stack((d_int,) + cfg.top_mlp, **kw)
        return DLRM(tables, bot, top, init_dense((D, D), **kw))
    if cfg.kind == "dcnv2":
        d0 = cfg.n_dense + cfg.n_sparse * D
        cross = nn.ModuleList(nn.ParameterDict({
            "w": nn.Parameter(init_dense((d0, d0), **kw)),
            "b": nn.Parameter(torch.zeros((d0,), device=dev))})
            for _ in range(cfg.n_cross_layers))
        mlp = mlp_stack((d0,) + cfg.mlp + (1,), **kw)
        return DCNv2(tables, cross, mlp, init_dense((D, D), **kw))
    if cfg.kind == "widedeep":
        wide = [keep(f"wide/{i}", truncnorm_init((padded_vocab(v), 1), 0.01,
                                                 **kw))
                for i, v in enumerate(cfg.vocab_sizes)]
        mlp = mlp_stack((cfg.n_sparse * D,) + cfg.mlp + (1,), **kw)
        return WideDeep(tables, wide, mlp, init_dense((D, D), **kw))
    if cfg.kind == "sasrec":
        S = cfg.seq_len
        pos = truncnorm_init((S, D), 0.05, **kw)
        blocks = [SASRecBlock(init_dense((D, D), **kw),
                              init_dense((D, D), **kw),
                              init_dense((D, D), **kw),
                              torch.ones((D,), device=dev),
                              torch.ones((D,), device=dev),
                              mlp_stack((D, D, D), **kw))
                  for _ in range(cfg.n_blocks)]
        return SASRec(tables, pos, blocks, init_dense((D, D), **kw))
    raise ValueError(cfg.kind)


def recsys_params_from_jax(p: dict, *, device: DeviceLike = None) -> Recsys:
    """The JAX package's parameter pytree, as numpy arrays, into the
    port's parameters on `device`. The kind follows from its keys: `bot` /
    `top` (DLRM), `cross` / `mlp` (DCN-v2), `wide` / `mlp` (Wide&Deep),
    `pos` / `blocks` (SASRec); every kind has `tables` and `item_proj`."""
    dev = resolve_device(device)

    def t(a):
        return to_tensor(a, dev, torch.float32)

    def layers(ls) -> nn.ModuleList:
        return nn.ModuleList(nn.ParameterDict({
            "w": nn.Parameter(t(l["w"])), "b": nn.Parameter(t(l["b"]))})
            for l in ls)

    tables = [t(x) for x in p["tables"]]
    proj = t(p["item_proj"])
    if "bot" in p:
        return DLRM(tables, layers(p["bot"]), layers(p["top"]), proj)
    if "cross" in p:
        return DCNv2(tables, layers(p["cross"]), layers(p["mlp"]), proj)
    if "wide" in p:
        return WideDeep(tables, [t(x) for x in p["wide"]],
                        layers(p["mlp"]), proj)
    if "blocks" in p:
        blocks = [SASRecBlock(t(b["wq"]), t(b["wk"]), t(b["wv"]),
                              t(b["ln1"]), t(b["ln2"]), layers(b["ff"]))
                  for b in p["blocks"]]
        return SASRec(tables, t(p["pos"]), blocks, proj)
    raise ValueError(f"no recommender kind has the keys {sorted(p)}")


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------


def _batch(p: Recsys, batch: Dict, key: str) -> torch.Tensor:
    """batch[key] on the parameters' device: float32 for the dense
    features, int64 ids for everything else."""
    dtype = torch.float32 if key == "dense" else torch.long
    return to_tensor(batch[key], p.device, dtype)


def _top(x: torch.Tensor, k: int, *, largest: bool):
    """Values and positions of the k largest (or smallest) along the last
    axis; ties keep the lower position first, as `lax.top_k` does."""
    vals, pos = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], pos[..., :k]


def _sparse_embs(p: Recsys, batch: Dict, cfg: RecsysConfig
                 ) -> torch.Tensor:
    """-> (B, n_sparse, D): each field's bag of ids summed in its table."""
    return bags(p, p.tables, "tables", _batch(p, batch, "sparse"))


def sasrec_hidden(p: SASRec, seq: torch.Tensor, cfg: RecsysConfig
                  ) -> torch.Tensor:
    """(B, S) item ids -> (B, S, D)."""
    if cfg.kind != "sasrec":
        raise ValueError(f"sasrec_hidden of a {cfg.kind} model")
    return p(seq)


@torch.no_grad()
def rec_forward(p: Recsys, batch: Dict, cfg: RecsysConfig) -> torch.Tensor:
    """CTR forward -> logits (B,). batch: dense (B, n_dense) f32, sparse
    (B, n_sparse, multi_hot) ids; SASRec: seq (B, S), target (B,)."""
    return _ctr_logits(p, batch, cfg)


def _ctr_logits(p: Recsys, batch: Dict, cfg: RecsysConfig) -> torch.Tensor:
    """`rec_forward` without its no_grad, for `rec_loss`."""
    full_fp32()
    if cfg.kind == "dlrm":
        d = mlp_apply(p.bot, _batch(p, batch, "dense"), final_act=True)
        s = _sparse_embs(p, batch, cfg)                        # (B, ns, D)
        z = torch.cat([d[:, None, :], s], dim=1)               # (B, F, D)
        zz = torch.einsum("bfd,bgd->bfg", z, z)
        f = z.shape[1]
        # the same row-major pairs as jnp.triu_indices(f, k=1)
        iu, ju = torch.triu_indices(f, f, 1, device=z.device)
        inter = zz[:, iu, ju]                                  # (B, F(F-1)/2)
        return mlp_apply(p.top, torch.cat([d, inter], -1))[:, 0]
    if cfg.kind == "dcnv2":
        dense = _batch(p, batch, "dense")
        s = _sparse_embs(p, batch, cfg).reshape(dense.shape[0], -1)
        x0 = torch.cat([dense, s], dim=-1)
        x = x0
        for c in p.cross:
            x = x0 * (x @ c["w"] + c["b"]) + x                 # DCNv2 cross
        return mlp_apply(p.mlp, x)[:, 0]
    if cfg.kind == "widedeep":
        s = _sparse_embs(p, batch, cfg)
        deep = mlp_apply(p.mlp, s.reshape(s.shape[0], -1))[:, 0]
        sparse = _batch(p, batch, "sparse")
        # a left-to-right Python sum over the fields, as the reference's
        w = bags(p, p.wide, "wide", sparse)
        wide = sum(w[:, i, 0] for i in range(w.shape[1]))
        return deep + wide
    if cfg.kind == "sasrec":
        h = sasrec_hidden(p, _batch(p, batch, "seq"), cfg)     # (B, S, D)
        tgt = table_rows(p, "tables/0", p.tables[0],
                         _batch(p, batch, "target"))           # (B, D)
        return torch.einsum("bd,bd->b", h[:, -1], tgt)
    raise ValueError(cfg.kind)


def rec_loss(p: Recsys, batch: Dict, cfg: RecsysConfig):
    """The training loss and its aux metrics (detached): SASRec's
    next-item BCE with one sampled negative per position, the CTR kinds'
    logistic loss against `batch["label"]`. Differentiable: every table
    read (SASRec's item table three ways: the sequence, `pos_items` and
    `neg_items`) gives its table a sparse gradient."""
    full_fp32()
    if cfg.kind == "sasrec":
        h = sasrec_hidden(p, _batch(p, batch, "seq"), cfg)     # (B, S, D)
        pos = table_rows(p, "tables/0", p.tables[0],
                         _batch(p, batch, "pos_items"))
        neg = table_rows(p, "tables/0", p.tables[0],
                         _batch(p, batch, "neg_items"))
        sp = torch.einsum("bsd,bsd->bs", h, pos)
        sn = torch.einsum("bsd,bsd->bs", h, neg)
        m = to_tensor(batch["seq_mask"], p.device, torch.float32)
        loss = -(torch.log(torch.sigmoid(sp) + 1e-9)
                 + torch.log(1 - torch.sigmoid(sn) + 1e-9))
        denom = m.sum().clamp_min(1.0)
        return (loss * m).sum() / denom, \
            {"pos_score": ((sp * m).sum() / denom).detach()}
    logits = _ctr_logits(p, batch, cfg)
    y = to_tensor(batch["label"], p.device, torch.float32)
    loss = torch.mean(logits.clamp_min(0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
    return loss, {"mean_logit": logits.mean().detach()}


# ---------------------------------------------------------------------------
# retrieval scoring (the paper's regime)
# ---------------------------------------------------------------------------


@torch.no_grad()
def user_tower(p: Recsys, batch: Dict, cfg: RecsysConfig) -> torch.Tensor:
    """-> (B, D) user representation for retrieval: SASRec's last hidden
    state; DLRM's bottom MLP plus its mean sparse embedding; DCN-v2's and
    Wide&Deep's mean sparse embedding."""
    full_fp32()
    if cfg.kind == "sasrec":
        return sasrec_hidden(p, _batch(p, batch, "seq"), cfg)[:, -1]
    if cfg.kind == "dlrm":
        return mlp_apply(p.bot, _batch(p, batch, "dense"), final_act=True) \
            + _sparse_embs(p, batch, cfg).mean(dim=1)
    if cfg.kind in ("dcnv2", "widedeep"):
        return _sparse_embs(p, batch, cfg).mean(dim=1)
    raise ValueError(cfg.kind)


def _project(p: Recsys, rows: torch.Tensor) -> torch.Tensor:
    """(C, D): the item table's rows `rows`, projected; a row-sharded
    item table is read through `table_rows` (a sum over `model`)."""
    full_fp32()
    return table_rows(p, "tables/0", p.tables[0], rows) @ p.item_proj


@torch.no_grad()
def item_vectors(p: Recsys, cand_ids) -> torch.Tensor:
    """(C,) item ids -> (C, D) projected item embeddings: the vectors the
    PQ codes of the retrieval path encode."""
    return _project(p, to_tensor(cand_ids, p.device, torch.long))


@torch.no_grad()
def retrieval_scores(p: Recsys, batch: Dict, cfg: RecsysConfig
                     ) -> torch.Tensor:
    """Exact scoring: (B, n_cand). Candidates = rows of table 0, projected."""
    u = user_tower(p, batch, cfg)                            # (B, D)
    cand = _project(p, _batch(p, batch, "cand_ids"))         # (C, D)
    return u @ cand.T


@torch.no_grad()
def retrieval_topk(p: Recsys, batch: Dict, cfg: RecsysConfig, k: int = 100
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: (ids (B, k), scores (B, k))."""
    vals, idx = _top(retrieval_scores(p, batch, cfg), k, largest=True)
    return _batch(p, batch, "cand_ids")[idx], vals


@torch.no_grad()
def retrieval_topk_pq(p: Recsys, batch: Dict, cfg: RecsysConfig,
                      pq_codes: torch.Tensor, centroids: torch.Tensor,
                      k: int = 100, rerank_mult: int = 4, *,
                      backend: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AiSAQ-mode retrieval: ADC over the PQ codes (C, m) of the projected
    candidate embeddings, then an exact re-rank of the top k*rerank_mult.
    Returns (ids (1, k), scores (1, k)).

    As in the reference, only query 0 is re-ranked (the batch-1
    retrieval_cand shape) and the positions of the codes' rows are the
    item ids. Both selections are stable sorts, so ties keep the lower
    position first as `lax.top_k` does. `backend` goes to `ops.build_lut`
    and `ops.adc` ("ref" runs their plain versions).
    """
    u = user_tower(p, batch, cfg)                            # (B, D)
    lut = ops.build_lut(u, centroids, metric="mips", backend=backend)
    d_pq = ops.adc(lut, pq_codes, backend=backend)           # (B, C)
    _, pre = _top(d_pq[0], k * rerank_mult, largest=False)
    exact = _project(p, pre) @ u[0]
    vals, idx = _top(exact, k, largest=True)
    return pre[idx][None], vals[None]


def make_retrieval_fn(p: Recsys, cfg: RecsysConfig, pq_codes: torch.Tensor,
                      centroids: torch.Tensor, k: int = 100,
                      rerank_mult: int = 4):
    """`retrieval_topk_pq` as a callable `batch -> (ids (1, k), scores (1,
    k))` at fixed shapes. The request's inputs are those the kind's user
    tower reads (`TOWER_INPUTS`): SASRec's `seq` (B, S); DLRM's `dense`
    (B, n_dense) and `sparse` (B, n_sparse, multi_hot); DCN-v2's and
    Wide&Deep's `sparse`. On the card the whole request (user tower,
    `pq_lut`, `pq_adc`, the stable sort, the projection, the product and
    the second stable sort) is captured in one CUDA graph at the first call
    for each shape of those inputs, after one eager warm-up; each call
    copies the request's inputs into the graph's fixed ones and replays
    it. The outputs are the graph's fixed tensors, which the next call
    overwrites: copy them out (e.g. `.cpu()`) before calling again. A lock
    keeps callers from replaying at once. On the CPU it calls
    `retrieval_topk_pq` eagerly.
    """
    if p.device.type != "cuda":
        return lambda batch: retrieval_topk_pq(
            p, batch, cfg, pq_codes, centroids, k, rerank_mult)
    keys = TOWER_INPUTS[cfg.kind]
    graphs: Dict[tuple, Tuple[Tuple[torch.Tensor, ...], Graph]] = {}
    lock = threading.Lock()

    def request(inputs: Tuple[torch.Tensor, ...]):
        return retrieval_topk_pq(p, dict(zip(keys, inputs)), cfg, pq_codes,
                                 centroids, k, rerank_mult)

    def serve(batch: Dict):
        inputs = tuple(_batch(p, batch, key) for key in keys)
        shapes = tuple(t.shape for t in inputs)
        with lock, torch.no_grad():
            if shapes not in graphs:
                static = tuple(t.clone() for t in inputs)
                warm_up(lambda: request(static))
                graphs[shapes] = static, Graph(lambda: request(static))
            static, graph = graphs[shapes]
            for fixed, t in zip(static, inputs):
                fixed.copy_(t)
            graph.replay()
            return graph.out
    return serve
