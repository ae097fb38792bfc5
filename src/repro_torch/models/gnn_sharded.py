"""Locality-aware sharded full-batch GraphSAGE on `torch.distributed` (port
of `repro.models.gnn_sharded`, where the reference uses `shard_map`).

- Nodes are cut into contiguous ranges, one a rank, over the whole
  (data, model) grid: rank r (its world rank, row-major) owns rows
  [r * n_local, (r + 1) * n_local).
- Edges are grouped by destination shard on the host (`partition_edges`,
  exact), so the aggregation onto a rank's own rows is local: one CSR of
  the rank's edges (`prepare_csr`) and the segment-sum kernel.
- One collective a layer: the all-gather of the (n_local, H) hidden
  states that the next layer's sources read, in `wire_dtype` (bfloat16 by
  default). It is differentiable: its backward sums the cotangents of
  every rank and keeps the rank's rows (the transpose of
  `jax.lax.all_gather`; gloo has no reduce-scatter, so an all_reduce and
  a slice).
- The loss is sum(local nll * mask) over the global mask count, its
  numerator and the accuracy all-reduced. Every parameter enters the loss
  through an identity whose backward all-reduces its gradient, so each
  rank's `torch.autograd.grad` is the gradient of the unsharded loss.

The collectives are `launch.mesh`'s: gloo moves host tensors, so with
CUDA tensors each goes through the host; NCCL would gather on the card. A
bfloat16 wire moves its bytes as uint8 (exact: gloo refuses bfloat16 and
int16 tensors).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import GNNConfig
from repro_torch.device import DeviceLike, full_fp32, resolve_device, \
    to_tensor
from repro_torch.kernels.segment import GraphCSR, prepare_csr, segment_sum
from repro_torch.launch.mesh import all_gather, all_reduce, reduce_backward
from repro_torch.optim.adamw import param_tree


def partition_edges(edges: np.ndarray, n_nodes: int, ways: int
                    ) -> Tuple[np.ndarray, int]:
    """Group edges by destination shard; pad shards to equal length with
    (n, n) dummies (dropped by segment ops). Returns ((ways, E_pad, 2),
    n_local)."""
    n_local = -(-n_nodes // ways)
    shard = edges[:, 1] // n_local
    order = np.argsort(shard, kind="stable")
    edges = edges[order]
    shard = shard[order]
    counts = np.bincount(shard, minlength=ways)
    e_pad = -(-int(counts.max()) // 8) * 8
    out = np.full((ways, e_pad, 2), n_nodes, dtype=np.int32)
    pos = 0
    for s in range(ways):
        c = counts[s]
        out[s, :c] = edges[pos:pos + c]
        pos += c
    return out, n_local


def _all_gather_rows(t: torch.Tensor, group, ways: int) -> torch.Tensor:
    """(ways * n, ...): every rank's t, by rank."""
    return all_gather(t, group, dist.get_process_group_ranks(group)) \
        .reshape((ways * t.shape[0],) + tuple(t.shape[1:]))


class _GatherStates(torch.autograd.Function):
    """h_local (n_local, H) float32 -> every rank's, (n_nodes, H) float32,
    through `wire` on the way there and back."""

    @staticmethod
    def forward(ctx, h_local, group, ways, rank, n_nodes, wire):
        ctx.group, ctx.rank, ctx.wire = group, rank, wire
        ctx.n_local = h_local.shape[0]
        full = _all_gather_rows(h_local.to(wire), group, ways)
        return full.to(torch.float32)[:n_nodes]

    @staticmethod
    def backward(ctx, g):
        n_pad = ctx.n_local * dist.get_world_size(ctx.group)
        g = torch.nn.functional.pad(g, (0, 0, 0, n_pad - g.shape[0]))
        g = all_reduce(g.to(ctx.wire).to(torch.float32), ctx.group)
        lo = ctx.rank * ctx.n_local
        mine = g[lo:lo + ctx.n_local].to(ctx.wire).to(torch.float32)
        return mine, None, None, None, None, None


def sharded_full_loss_fn(grid, cfg: GNNConfig, n_nodes: int,
                         wire_dtype: torch.dtype = torch.bfloat16):
    """Returns loss_fn(params, batch) -> (loss, {"acc"}) on every rank of
    `grid` (`launch.mesh.ProcessGrid`), called by all together.

    batch: feats (N, F), labels (N,), mask (N,) replicated; edges the
    (ways, E_pad, 2) of `partition_edges` or this rank's (E_pad, 2); and,
    optionally, `csr`, this rank's `local_csr` (made once per graph)."""
    group, _ = grid.group(grid.axis_names)
    ways = grid.world
    rank = grid.rank
    n_local = -(-n_nodes // ways)
    n_pad = n_local * ways
    lo = rank * n_local

    def loss_fn(params, batch):
        full_fp32()
        feats = batch["feats"]
        csr = batch.get("csr")
        if csr is None:
            csr = local_csr(batch["edges"], n_nodes, ways, rank,
                            device=feats.device)
        p = {n: reduce_backward(t, group)
             for n, t in param_tree(params).items()}
        x_glob = feats
        h_local = None
        for li in range(cfg.n_layers):
            w_self, w_neigh, b = (p[f"layers/{li}/{k}"]
                                  for k in ("w_self", "w_neigh", "b"))
            agg = segment_sum(x_glob, csr)
            if cfg.aggregator == "mean":
                agg = agg / torch.clamp(csr.deg, min=1.0)[:, None]
            x_self = x_glob[lo:lo + n_local]
            if x_self.shape[0] < n_local:
                x_self = torch.nn.functional.pad(
                    x_self, (0, 0, 0, n_local - x_self.shape[0]))
            h_local = torch.relu(x_self @ w_self + agg @ w_neigh + b)
            h_local = h_local / torch.clamp(torch.linalg.vector_norm(
                h_local, dim=-1, keepdim=True), min=1e-6)
            if li + 1 < cfg.n_layers:
                # the one collective a layer: every rank's states
                x_glob = _GatherStates.apply(h_local, group, ways, rank,
                                             n_nodes, wire_dtype)
        logits = h_local @ p["w_out"]
        labels, mask = (_local_rows(batch[k], lo, n_local, n_pad)
                        for k in ("labels", "mask"))
        ls = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -ls.gather(1, labels.long()[:, None])[:, 0]
        num = torch.sum(nll * mask)
        hit = torch.sum((logits.argmax(-1) == labels.long()).to(mask.dtype)
                        * mask)
        tot = all_reduce(torch.stack([num.detach(), mask.sum(), hit]),
                          group)
        den = torch.clamp(tot[1], min=1.0)
        # the value is the global loss, the gradient this rank's term's:
        # the parameters' identities sum the ranks' gradients
        mine = num / den
        loss = (mine - mine.detach()) + tot[0] / den
        return loss, {"acc": tot[2] / den}

    return loss_fn


def _local_rows(x: torch.Tensor, lo: int, n_local: int, n_pad: int):
    x = torch.nn.functional.pad(x, (0, n_pad - x.shape[0]))
    return x[lo:lo + n_local]


def local_csr(edges, n_nodes: int, ways: int, rank: int, *,
              device: DeviceLike = None) -> GraphCSR:
    """This rank's CSR of its destination shard, on `device` (default: the
    edges' own when they are a tensor, else the card): `edges` is the
    (ways, E_pad, 2) of `partition_edges` or the rank's (E_pad, 2); the
    rows are the rank's n_local nodes, the sources all n_nodes."""
    e = edges[rank] if edges.ndim == 3 else edges
    dev = (e.device if device is None and isinstance(e, torch.Tensor)
           else resolve_device(device))
    e = to_tensor(e, dev)
    n_local = -(-n_nodes // ways)
    src, dst = e[:, 0].long(), e[:, 1].long()
    dst_local = torch.where(dst < n_nodes, dst - rank * n_local, n_local)
    return prepare_csr(torch.stack([src, dst_local], 1), n_local,
                       n_src=n_nodes, drop_bad_src=True)
