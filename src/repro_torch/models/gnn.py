"""GraphSAGE (Hamilton et al., 2017): full-batch, sampled-minibatch and
batched-small-graph regimes (port of `repro.models.gnn`).

Message passing: the reference gathers each edge's source row and
segment-reduces the (E, F) messages onto the destinations. The port sums
over the graph's CSR (`kernels.segment`, built once per graph by
`prepare_csr`) with a hand-written kernel that never materialises the
messages and sums deterministically; `mean` divides by the in-degree in
torch, `max` stays plain torch (`scatter_reduce_` "amax" into a -inf
fill: an empty segment stays -inf, as `jax.ops.segment_max` leaves it).

The batched regime (the reference vmaps over G graphs) runs as one
block-diagonal graph: graph g's nodes at offsets g * n. The minibatch
regime consumes the fanout blocks of the host-side `NeighborSampler` (a
copy of the reference's, drawing the same ids from the same seed).

Parameters are a `GNN` module whose `param_tree` paths are the
reference's leaves (`layers/0/w_self`, `layers/0/w_neigh`, `layers/0/b`,
..., `w_out`). Entry points run on the card unless given the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs import GNNConfig
from repro_torch.device import DeviceLike, full_fp32, resolve_device, \
    to_tensor
from repro_torch.kernels.segment import GraphCSR, prepare_csr, segment_sum
from repro_torch.models.layers import init_dense


def pad_edges(edges: np.ndarray, multiple: int, n_nodes: int) -> np.ndarray:
    """Pad the edge list to a shardable multiple with (n, n) dummy edges.

    Out-of-range segment ids are dropped by the aggregation and the
    clamped source read contributes only to those dropped segments, so
    dummies are exact no-ops."""
    e = edges.shape[0]
    target = -(-e // multiple) * multiple
    if target == e:
        return edges
    pad = np.full((target - e, 2), n_nodes, edges.dtype)
    return np.concatenate([edges, pad], axis=0)


class GNN(nn.Module):
    """GraphSAGE parameters: `layers` (one {"w_self", "w_neigh", "b"} a
    layer) and the readout `w_out`."""

    def __init__(self, layers: Sequence[Dict[str, torch.Tensor]],
                 w_out: torch.Tensor):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v) for k, v in lp.items()})
            for lp in layers)
        self.w_out = nn.Parameter(w_out)


def init_gnn(cfg: GNNConfig, d_feat: int, *, generator: torch.Generator,
             device: DeviceLike = None) -> GNN:
    """The reference's init: w_self and w_neigh (fan_in ** -0.5 truncated
    normals), zero biases and w_out, drawn from `generator` on `device`."""
    dev = resolve_device(device)
    dims = [d_feat] + [cfg.d_hidden] * cfg.n_layers
    layers = []
    for i in range(cfg.n_layers):
        shape = (dims[i], dims[i + 1])
        layers.append({
            "w_self": init_dense(shape, generator=generator, device=dev),
            "w_neigh": init_dense(shape, generator=generator, device=dev),
            "b": torch.zeros((dims[i + 1],), dtype=torch.float32,
                             device=dev)})
    w_out = init_dense((cfg.d_hidden, cfg.n_classes), generator=generator,
                       device=dev)
    return GNN(layers, w_out)


def gnn_params_from_jax(tree: Dict, *, device: DeviceLike = None) -> GNN:
    """The reference's GNN parameters (a pytree of numpy or JAX arrays) as
    the port's module on `device`."""
    dev = resolve_device(device)
    return GNN([{k: to_tensor(np.asarray(v), dev) for k, v in lp.items()}
                for lp in tree["layers"]],
               to_tensor(np.asarray(tree["w_out"]), dev))


def _aggregate(x: torch.Tensor, csr: GraphCSR, kind: str) -> torch.Tensor:
    """(n, F): each destination's sum, mean or max over its in-edges'
    source rows of x."""
    if kind == "sum":
        return segment_sum(x, csr)
    if kind == "mean":
        return segment_sum(x, csr) / torch.clamp(csr.deg, min=1.0)[:, None]
    if kind == "max":
        src = csr.by_dst.col.long()
        dst = csr.by_dst.rows()
        out = torch.full((csr.n_rows, x.shape[1]), -torch.inf,
                         dtype=x.dtype, device=x.device)
        return out.scatter_reduce(
            0, dst[:, None].expand(-1, x.shape[1]), x[src], "amax")
    raise ValueError(kind)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def gnn_full_forward(params: GNN, feats: torch.Tensor, edges,
                     cfg: GNNConfig, csr: Optional[GraphCSR] = None
                     ) -> torch.Tensor:
    """feats (N, F), edges (E, 2) [src, dst] -> logits (N, classes). `csr`
    is the graph's `prepare_csr` (made from `edges` when None)."""
    full_fp32()
    x = feats
    if csr is None:
        csr = prepare_csr(edges, feats.shape[0], device=feats.device)
    for lp in params.layers:
        agg = _aggregate(x, csr, cfg.aggregator)
        x = torch.relu(x @ lp["w_self"] + agg @ lp["w_neigh"] + lp["b"])
        x = _l2_normalize(x)
    return x @ params.w_out


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    ls = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -ls.gather(1, labels.long()[:, None])[:, 0]


def gnn_full_loss(params: GNN, batch: Dict, cfg: GNNConfig):
    """Masked mean NLL over the nodes and {"acc"}: batch holds feats,
    edges, labels, mask and, optionally, the graph's `csr`."""
    logits = gnn_full_forward(params, batch["feats"], batch["edges"], cfg,
                              csr=batch.get("csr"))
    labels, mask = batch["labels"], batch["mask"]
    den = torch.clamp(mask.sum(), min=1.0)
    loss = torch.sum(_nll(logits, labels) * mask) / den
    hit = (logits.argmax(-1) == labels.long()).to(mask.dtype)
    return loss, {"acc": torch.sum(hit * mask) / den}


# ---------------------------------------------------------------------------
# sampled minibatch (fanout blocks)
# ---------------------------------------------------------------------------


def gnn_minibatch_forward(params: GNN, blocks: Dict, cfg: GNNConfig
                          ) -> torch.Tensor:
    """2-layer fanout forward. blocks: seed_feats (B, F); nbr1_feats
    (B, f1, F); nbr2_feats (B, f1, f2, F)."""
    full_fp32()
    l1, l2 = params.layers[0], params.layers[1]
    # layer 1 at the depth-1 nodes: aggregate their depth-2 neighbours
    h_n1 = torch.relu(blocks["nbr1_feats"] @ l1["w_self"]
                      + blocks["nbr2_feats"].mean(dim=2) @ l1["w_neigh"]
                      + l1["b"])
    h_seed = torch.relu(blocks["seed_feats"] @ l1["w_self"]
                        + blocks["nbr1_feats"].mean(dim=1) @ l1["w_neigh"]
                        + l1["b"])
    h_n1, h_seed = _l2_normalize(h_n1), _l2_normalize(h_seed)
    # layer 2 at the seeds: aggregate the depth-1 hidden states
    h = torch.relu(h_seed @ l2["w_self"] + h_n1.mean(dim=1) @ l2["w_neigh"]
                   + l2["b"])
    return _l2_normalize(h) @ params.w_out


def gnn_minibatch_loss(params: GNN, batch: Dict, cfg: GNNConfig):
    logits = gnn_minibatch_forward(params, batch, cfg)
    labels = batch["labels"].long()
    return _nll(logits, labels).mean(), {
        "acc": (logits.argmax(-1) == labels).to(torch.float32).mean()}


def batched_csr(edges: torch.Tensor, n: int) -> GraphCSR:
    """The CSRs of G graphs of n nodes ((G, e, 2) edges) as one
    block-diagonal graph of G * n rows, on the edges' device. Each graph's
    ids are normalised first, as the reference's vmapped gather and
    segment ops treat them: a destination out of [0, n) is dropped; a
    source wraps if negative and is clamped, and a clamped one is left out
    of the backward (the gather's transpose drops it); then graph g's ids
    move by g * n."""
    G = edges.shape[0]
    src, dst = edges[..., 0].long(), edges[..., 1].long()
    src = torch.where(src < 0, src + n, src)
    in_range = (src >= 0) & (src < n)
    off = (torch.arange(G, device=edges.device) * n)[:, None]
    dst = torch.where((dst >= 0) & (dst < n), dst + off, -1)
    flat = torch.stack([src.clamp(0, n - 1) + off, dst], -1).reshape(-1, 2)
    return prepare_csr(flat, G * n, grad_mask=in_range.reshape(-1))


def gnn_batched_forward(params: GNN, feats: torch.Tensor, edges,
                        cfg: GNNConfig, csr: Optional[GraphCSR] = None
                        ) -> torch.Tensor:
    """Batched small graphs: feats (G, n, F), edges (G, e, 2) ->
    (G, classes); readout = mean over nodes (the molecule regime). `csr`
    is `batched_csr(edges, n)`, made when None."""
    full_fp32()
    G, n, _ = feats.shape
    if csr is None:
        csr = batched_csr(to_tensor(edges, feats.device), n)
    x = feats.reshape(G * n, -1)
    for lp in params.layers:
        agg = _aggregate(x, csr, cfg.aggregator)
        x = torch.relu(x @ lp["w_self"] + agg @ lp["w_neigh"] + lp["b"])
    return x.reshape(G, n, -1).mean(dim=1) @ params.w_out


def gnn_batched_loss(params: GNN, batch: Dict, cfg: GNNConfig):
    logits = gnn_batched_forward(params, batch["feats"], batch["edges"], cfg,
                                 csr=batch.get("csr"))
    labels = batch["labels"].long()
    return _nll(logits, labels).mean(), {
        "acc": (logits.argmax(-1) == labels).to(torch.float32).mean()}


# ---------------------------------------------------------------------------
# host-side neighbour sampler (real, CSR-based; a copy of the reference's)
# ---------------------------------------------------------------------------


class NeighborSampler:
    """Uniform fanout sampling over CSR adjacency (GraphSAGE §3.1)."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_edges(cls, edges: np.ndarray, n_nodes: int, seed: int = 0):
        order = np.argsort(edges[:, 1], kind="stable")
        src = edges[order, 0].astype(np.int64)
        # the reference's np.add.at(indptr, dst + 1, 1), then a cumsum
        indptr = np.zeros(n_nodes + 1, np.int64)
        indptr[1:] = np.bincount(edges[:, 1], minlength=n_nodes)[:n_nodes]
        return cls(np.cumsum(indptr), src, seed)

    def sample(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """(B,) -> (B, fanout) sampled in-neighbours (self-loop if
        isolated)."""
        out = np.empty((nodes.shape[0], fanout), np.int64)
        for i, v in enumerate(nodes):
            lo, hi = self.indptr[v], self.indptr[v + 1]
            if hi == lo:
                out[i] = v
            else:
                out[i] = self.indices[
                    lo + self.rng.integers(0, hi - lo, size=fanout)]
        return out

    def sample_ids(self, seeds: np.ndarray, fanouts: Tuple[int, ...]):
        """The 2-hop ids: (B, f1) and (B, f1, f2)."""
        f1, f2 = fanouts
        n1 = self.sample(seeds, f1)
        n2 = self.sample(n1.reshape(-1), f2).reshape(seeds.shape[0], f1, f2)
        return n1, n2

    def sample_blocks(self, seeds: np.ndarray, fanouts: Tuple[int, ...],
                      feats, device: DeviceLike = None) -> Dict:
        """The 2-hop block tensors of `gnn_minibatch_forward`. With `feats`
        a tensor the rows are gathered on its device (at minibatch_lg the
        (B, f1, f2, F) block is 370 MB: not a host copy a step); with numpy
        they are gathered on the host and moved to `device` (default the
        card)."""
        n1, n2 = self.sample_ids(seeds, fanouts)
        if isinstance(feats, torch.Tensor):
            dev = feats.device

            def rows(ids):
                return feats[torch.from_numpy(ids).to(dev)]
        else:
            dev = resolve_device(device)

            def rows(ids):
                return to_tensor(feats[ids], dev)
        return {"seed_feats": rows(np.asarray(seeds)),
                "nbr1_feats": rows(n1), "nbr2_feats": rows(n2)}
