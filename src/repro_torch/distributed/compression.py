"""Gradient compression for the data-parallel all-reduce (port of
`repro.distributed.compression`).

int8 symmetric quantization with a two-phase exchange:
  1. MAX all-reduce of the per-tensor max-abs (one scalar),
  2. quantize to int8 against that global scale, SUM all-reduce as int32,
     dequantize, divide by the member count.

Gloo and NCCL have no int8 sum that cannot overflow, so the payload
travels as int32 (as in the reference, whose XLA has no int8 ring
all-reduce); the numbers training sees are int8-grade either way. The
int32 sum and the max are exact, so the result does not depend on the
order the collective adds in.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.launch.mesh import all_reduce
from repro_torch.optim.adamw import param_tree

SMALL = 1024        # leaves under this many elements take the float32 mean


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(torch.round(x / torch.clamp(scale, min=1e-20) * 127.0),
                    -127, 127)
    return q.to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q * scale / 127 in float32, a true division: the reference run
    without `jax.jit` gives these bits; under `jit` XLA multiplies by
    float32(1/127) instead, which moves some elements by one ulp. The 127
    is a tensor on q's device: PyTorch's CUDA kernel divides by a Python
    number as a product with its float32 reciprocal (the jitted bits)."""
    return q.to(torch.float32) * scale / torch.full(
        (), 127.0, dtype=torch.float32, device=q.device)


def compressed_psum(grads: Dict[str, torch.Tensor], group
                    ) -> Dict[str, torch.Tensor]:
    """Per-tensor int8-quantized mean of {name: gradient} over `group`
    (a process group; a collective of its members, every member with the
    same names and shapes). A leaf under 1,024 elements (norms, biases)
    skips compression: its bytes do not matter and it is
    precision-critical."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def one(g):
        g = g.to(torch.float32)
        count = torch.full((), float(n), device=g.device)   # true division
        if g.numel() < SMALL:
            return all_reduce(g, group) / count
        scale = all_reduce(torch.max(torch.abs(g)), group, op="max")
        q = quantize_int8(g, scale)
        tot = all_reduce(q.to(torch.int32), group)
        return dequantize_int8(tot, scale) / count

    return {k: None if g is None else one(g) for k, g in grads.items()}


def make_compressed_dp_grads(loss_fn: Callable, grid,
                             dp_axis: str = "data") -> Callable:
    """Explicit data parallelism with compressed gradients: returns
    fn(params, batch) -> (loss, {path: gradient}). The parameters are
    replicated; the global batch is split over `dp_axis` (this rank
    takes its block of every leaf's leading dim), the gradients of this
    rank's loss go through `compressed_psum` over `dp_axis` (in place of
    the float32 all-reduce) and the loss is the mean over it. A
    collective: every rank of the grid calls it together."""
    from repro_torch.distributed.sharding import shard
    group, _ = grid.group((dp_axis,))
    n = grid.size((dp_axis,))

    def fn(params, batch):
        local = {k: shard(v, ((dp_axis,),), grid) for k, v in batch.items()}
        tree = param_tree(params)
        loss, _ = loss_fn(params, local)
        gs = torch.autograd.grad(loss, list(tree.values()),
                                 allow_unused=True)
        grads = compressed_psum(dict(zip(tree, gs)), group)
        return all_reduce(loss.detach(), group) / n, grads

    return fn
