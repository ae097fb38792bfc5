"""Dense layers of the recommender: truncated-normal init, dense init and
the relu MLP (port of `repro.models.layers` `truncnorm_init`,
`init_dense`, `mlp_stack`, `mlp_apply`).

Init draws from an explicit `torch.Generator` on an explicit device. The
distribution is the reference's (a standard normal truncated to [-2, 2],
times a scale); the bits are not, since JAX's keys have no torch
counterpart. Tests that compare the two carry JAX's parameters across.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

# the standard normal CDF at -2 and 2, mapped to erf's range [-1, 1]
_ERF_HI = math.erf(2.0 / math.sqrt(2.0))


def truncnorm_init(shape: Sequence[int], scale: float, *,
                   generator: torch.Generator, device: DeviceLike = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """scale * N(0, 1) truncated to [-2, 2], by inverting the CDF of a
    uniform draw between the two bounds (the truncated normal of
    `jax.random.truncated_normal`, whose variance is not rescaled)."""
    u = torch.empty(tuple(shape), dtype=torch.float32,
                    device=resolve_device(device))
    u.uniform_(-_ERF_HI, _ERF_HI, generator=generator)
    x = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return (scale * x).to(dtype)


def init_dense(shape: Sequence[int], *, generator: torch.Generator,
               device: DeviceLike = None, dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """A (fan_in, fan_out) weight with scale fan_in ** -0.5 by default."""
    scale = scale if scale is not None else shape[0] ** -0.5
    return truncnorm_init(shape, scale, generator=generator, device=device,
                          dtype=dtype)


def mlp_stack(dims: Sequence[int], *, generator: torch.Generator,
              device: DeviceLike = None,
              dtype: torch.dtype = torch.float32) -> nn.ModuleList:
    """[(d0->d1), (d1->d2), ...] relu MLP: one {"w", "b"} per layer."""
    dev = resolve_device(device)
    return nn.ModuleList(
        nn.ParameterDict({
            "w": nn.Parameter(init_dense((dims[i], dims[i + 1]),
                                         generator=generator, device=dev,
                                         dtype=dtype)),
            "b": nn.Parameter(torch.zeros((dims[i + 1],), dtype=dtype,
                                          device=dev))})
        for i in range(len(dims) - 1))


def mlp_apply(layers, x: torch.Tensor, final_act: bool = False
              ) -> torch.Tensor:
    """x @ w + b per layer, relu between layers (and after the last one
    when final_act)."""
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x
