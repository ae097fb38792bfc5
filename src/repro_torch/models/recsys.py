"""SASRec retrieval over PQ codes (port of the SASRec half of
`repro.models.recsys`).

The `retrieval_cand` regime scores one user against every item of the
catalogue, in two ways:
  * exact — the user tower dotted with every projected item embedding;
  * pq    — the paper's technique: ADC over the PQ codes of the projected
            item embeddings (`kernels.ops.adc`), then an exact re-rank of
            the top k * rerank_mult.

Parameters live in an `nn.Module` (`SASRec`), made by `init_recsys` from
a `torch.Generator` or carried across from the JAX package's parameter
pytree by `recsys_params_from_jax`. Only kind="sasrec" is ported; the
other towers and the CTR forward are queued in ROADMAP §1.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs import RecsysConfig
from repro_torch.cudagraph import Graph, warm_up
from repro_torch.device import DeviceLike, full_fp32, resolve_device, \
    to_tensor
from repro_torch.kernels import ops
from repro_torch.models.layers import init_dense, mlp_apply, mlp_stack, \
    truncnorm_init

VOCAB_PAD = 2048  # table rows padded as the reference pads them

_NOT_PORTED = ("only the sasrec tower is ported; the dlrm, dcnv2 and "
               "widedeep towers and the CTR forward are queued in "
               "ROADMAP.md §1 (the recsys towers and CTR forward)")


def padded_vocab(v: int) -> int:
    return max(VOCAB_PAD, (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """table (V, D), idx (..., hot) int -> (..., D)."""
    e = table[idx.long()]                     # (..., hot, D)
    if combiner == "sum":
        return e.sum(dim=-2)
    if combiner == "mean":
        return e.mean(dim=-2)
    raise ValueError(combiner)


def _ln(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
        ) -> torch.Tensor:
    """The reference's layer norm: no bias, biased variance, eps 1e-6
    (not `nn.LayerNorm`)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale


class SASRecBlock(nn.Module):
    """One self-attention block: single-head causal attention and a
    two-layer relu MLP, each behind a pre-norm residual."""

    def __init__(self, wq, wk, wv, ln1, ln2, ff: nn.ModuleList):
        super().__init__()
        self.wq, self.wk, self.wv = (nn.Parameter(t) for t in (wq, wk, wv))
        self.ln1, self.ln2 = nn.Parameter(ln1), nn.Parameter(ln2)
        self.ff = ff


class SASRec(nn.Module):
    """SASRec's parameters (item tables, positions, blocks, the retrieval
    tower's item projection); `forward(seq)` is the reference's
    `sasrec_hidden`: (B, S) item ids -> (B, S, D) hidden states."""

    def __init__(self, tables, pos, blocks, item_proj):
        super().__init__()
        self.tables = nn.ParameterList(nn.Parameter(t) for t in tables)
        self.pos = nn.Parameter(pos)
        self.blocks = nn.ModuleList(blocks)
        self.item_proj = nn.Parameter(item_proj)

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        full_fp32()
        S = seq.shape[1]
        D = self.pos.shape[1]
        # sqrt(D) rounded to float32, as the reference divides by it
        inv = float(np.sqrt(np.float32(D)))
        x = self.tables[0][seq.long()] + self.pos[None, :S]
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
                device: DeviceLike = None) -> SASRec:
    """Random SASRec parameters on `device` (default: the card), drawn from
    `generator`, with the reference's shapes and scales."""
    if cfg.kind != "sasrec":
        raise NotImplementedError(_NOT_PORTED)
    dev = resolve_device(device)
    D, S = cfg.embed_dim, cfg.seq_len
    kw = dict(generator=generator, device=dev)
    tables = [truncnorm_init((padded_vocab(v), D), 0.05, **kw)
              for v in cfg.vocab_sizes]
    pos = truncnorm_init((S, D), 0.05, **kw)
    blocks = [SASRecBlock(init_dense((D, D), **kw), init_dense((D, D), **kw),
                          init_dense((D, D), **kw),
                          torch.ones((D,), device=dev),
                          torch.ones((D,), device=dev),
                          mlp_stack((D, D, D), **kw))
              for _ in range(cfg.n_blocks)]
    return SASRec(tables, pos, blocks, init_dense((D, D), **kw))


def recsys_params_from_jax(p: dict, *, device: DeviceLike = None) -> SASRec:
    """The JAX package's SASRec parameter pytree (`tables`, `pos`,
    `blocks[i].{wq,wk,wv,ln1,ln2,ff}`, `item_proj`), as numpy arrays, into
    the port's parameters on `device`."""
    if "blocks" not in p:
        raise NotImplementedError(_NOT_PORTED)
    dev = resolve_device(device)

    def t(a):
        return to_tensor(a, dev, torch.float32)

    blocks = []
    for b in p["blocks"]:
        ff = nn.ModuleList(nn.ParameterDict({
            "w": nn.Parameter(t(l["w"])), "b": nn.Parameter(t(l["b"]))})
            for l in b["ff"])
        blocks.append(SASRecBlock(t(b["wq"]), t(b["wk"]), t(b["wv"]),
                                  t(b["ln1"]), t(b["ln2"]), ff))
    return SASRec([t(x) for x in p["tables"]], t(p["pos"]), blocks,
                  t(p["item_proj"]))


# ---------------------------------------------------------------------------
# retrieval scoring (the paper's regime)
# ---------------------------------------------------------------------------


def _batch(p: SASRec, batch: Dict, key: str) -> torch.Tensor:
    return to_tensor(batch[key], p.device, torch.long)


def _top(x: torch.Tensor, k: int, *, largest: bool):
    """Values and positions of the k largest (or smallest) along the last
    axis; ties keep the lower position first, as `lax.top_k` does."""
    vals, pos = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], pos[..., :k]


def sasrec_hidden(p: SASRec, seq: torch.Tensor, cfg: RecsysConfig
                  ) -> torch.Tensor:
    """(B, S) item ids -> (B, S, D)."""
    if cfg.kind != "sasrec":
        raise NotImplementedError(_NOT_PORTED)
    return p(seq)


@torch.no_grad()
def user_tower(p: SASRec, batch: Dict, cfg: RecsysConfig) -> torch.Tensor:
    """-> (B, D) user representation for retrieval: the last position's
    hidden state."""
    return sasrec_hidden(p, _batch(p, batch, "seq"), cfg)[:, -1]


def _project(p: SASRec, rows: torch.Tensor) -> torch.Tensor:
    full_fp32()
    return p.tables[0][rows] @ p.item_proj


@torch.no_grad()
def item_vectors(p: SASRec, cand_ids) -> torch.Tensor:
    """(C,) item ids -> (C, D) projected item embeddings: the vectors the
    PQ codes of the retrieval path encode."""
    return _project(p, to_tensor(cand_ids, p.device, torch.long))


@torch.no_grad()
def retrieval_scores(p: SASRec, batch: Dict, cfg: RecsysConfig
                     ) -> torch.Tensor:
    """Exact scoring: (B, n_cand). Candidates = rows of table 0, projected."""
    u = user_tower(p, batch, cfg)                            # (B, D)
    cand = _project(p, _batch(p, batch, "cand_ids"))         # (C, D)
    return u @ cand.T


@torch.no_grad()
def retrieval_topk(p: SASRec, batch: Dict, cfg: RecsysConfig, k: int = 100
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: (ids (B, k), scores (B, k))."""
    vals, idx = _top(retrieval_scores(p, batch, cfg), k, largest=True)
    return _batch(p, batch, "cand_ids")[idx], vals


@torch.no_grad()
def retrieval_topk_pq(p: SASRec, batch: Dict, cfg: RecsysConfig,
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


def make_retrieval_fn(p: SASRec, cfg: RecsysConfig, pq_codes: torch.Tensor,
                      centroids: torch.Tensor, k: int = 100,
                      rerank_mult: int = 4):
    """`retrieval_topk_pq` as a callable `batch -> (ids (1, k), scores (1,
    k))` at fixed shapes. On the card the whole request (user tower,
    `pq_lut`, `pq_adc`, the stable sort, the projection, the product and
    the second stable sort) is captured in one CUDA graph at the first call
    for each shape of `batch["seq"]`, after one eager warm-up; each call
    copies the request's item ids into the graph's fixed input and replays
    it. The outputs are the graph's fixed tensors, which the next call
    overwrites: copy them out (e.g. `.cpu()`) before calling again. A lock
    keeps callers from replaying at once. On the CPU it calls
    `retrieval_topk_pq` eagerly.
    """
    if p.device.type != "cuda":
        return lambda batch: retrieval_topk_pq(
            p, batch, cfg, pq_codes, centroids, k, rerank_mult)
    graphs: Dict[tuple, Tuple[torch.Tensor, Graph]] = {}
    lock = threading.Lock()

    def request(seq: torch.Tensor):
        return retrieval_topk_pq(p, {"seq": seq}, cfg, pq_codes, centroids,
                                 k, rerank_mult)

    def serve(batch: Dict):
        seq = _batch(p, batch, "seq")
        with lock, torch.no_grad():
            if seq.shape not in graphs:
                static = seq.clone()
                warm_up(lambda: request(static))
                graphs[seq.shape] = static, Graph(lambda: request(static))
            static, graph = graphs[seq.shape]
            static.copy_(seq)
            graph.replay()
            return graph.out
    return serve
