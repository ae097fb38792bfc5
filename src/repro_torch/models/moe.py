"""Top-k routed MoE with capacity-factored index dispatch (port of
`repro.models.moe`: `init_moe`, `moe_apply`).

Dispatch is index-based (gather / scatter), not a dense (T, E, C) one-hot
einsum: each (token, slot) pair's position in its expert is a cumsum over
the one-hot assignment in token-major (T * k) order, then the tokens are
gathered into the (E, C, D) expert batch. A pair past its expert's
capacity is dropped: it writes -1 into slot (E-1, C-1) of the scatter-max
slot table, which changes nothing, and its combine weight reads a zero
row. The reference's routing ties go to the lower expert id
(`lax.top_k`); `torch.topk` promises no order on the card, so the
selection is a stable sort.

`moe_apply_ep` is the reference's explicit expert parallelism over the
`model` axis of the installed grid (`distributed.act_sharding`): each
rank dispatches only its own experts and one all-reduce sums the combined
output. `models.transformer` picks it under `REPRO_MOE=ep`, as the
reference's `_moe_fn` does; with no grid installed it is `moe_apply`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs import MoEConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import init_swiglu, swiglu, truncnorm_init


class MoE(nn.Module):
    """Router (d_model, E) float32, stacked expert FFNs (E, ...) and, when
    the config has one, the shared expert (`shared`: a SwiGLU). In an LM
    the leaves carry a leading layer axis."""

    def __init__(self, p: Dict[str, torch.Tensor]):
        super().__init__()
        for name in ("router", "w_gate", "w_up", "w_down"):
            setattr(self, name, nn.Parameter(p[name]))
        if "shared" in p:
            self.shared = nn.ParameterDict(
                {n: nn.Parameter(t) for n, t in p["shared"].items()})


def init_moe(d_model: int, cfg: MoEConfig, *, generator: torch.Generator,
             device: DeviceLike = None, dtype: torch.dtype = torch.float32,
             n_pad_experts: int = 0) -> Dict[str, torch.Tensor]:
    """Router + stacked expert FFNs (+ shared expert), as a dict."""
    dev = resolve_device(device)
    E = cfg.n_experts + n_pad_experts
    kw = dict(generator=generator, device=dev)
    s_in, s_out = d_model ** -0.5, cfg.d_expert ** -0.5
    p = {"router": truncnorm_init((d_model, E), s_in, **kw),
         "w_gate": truncnorm_init((E, d_model, cfg.d_expert), s_in,
                                  dtype=dtype, **kw),
         "w_up": truncnorm_init((E, d_model, cfg.d_expert), s_in,
                                dtype=dtype, **kw),
         "w_down": truncnorm_init((E, cfg.d_expert, d_model), s_out,
                                  dtype=dtype, **kw)}
    if cfg.d_shared:
        p["shared"] = init_swiglu(d_model, cfg.d_shared, dtype=dtype, **kw)
    return p


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The k largest along the last axis and their positions; ties keep
    the lower position first, as `lax.top_k` does."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


# (dropped, routed) pair counts of every `moe_apply` call while a
# `count_drops()` block is open, as device tensors (no host sync)
_DROPS: Optional[List[Tuple[torch.Tensor, int]]] = None


@contextlib.contextmanager
def count_drops():
    """Collects each `moe_apply` call's dropped (token, expert) pairs;
    yields a list of (dropped tensor, routed pairs) to read after."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


class Routing(NamedTuple):
    """One call's routing: the gates and experts of each token, each
    (token, slot) pair's position in its expert and whether it is kept."""
    gate_vals: torch.Tensor       # (T, k) float32, normalised
    top_ids: torch.Tensor         # (T, k) expert ids
    pos_in_e: torch.Tensor        # (T*k,) token-major
    keep: torch.Tensor            # (T*k,) bool: within capacity
    capacity: int
    aux: torch.Tensor             # () float32 load-balancing loss


def route(p, x: torch.Tensor, cfg: MoEConfig, *,
          capacity: Optional[int] = None, n_pad_experts: int = 0
          ) -> Routing:
    """Router softmax, stable top-k, the Switch aux loss and each pair's
    position in its expert (a cumsum over the one-hot assignment in
    token-major order). Capacity is max(8, int(capacity_factor * T * k /
    n_experts)) from this call's T (in decode, T is the batch). Padding
    experts get -1e30 logits and so never a token."""
    T, D = x.shape
    E = cfg.n_experts + n_pad_experts
    k = cfg.top_k
    if capacity is None:
        capacity = max(8, int(cfg.capacity_factor * T * k / cfg.n_experts))
    logits = x.to(torch.float32) @ p["router"]                  # (T, E)
    if n_pad_experts:
        pad = torch.arange(E, device=x.device) >= cfg.n_experts
        logits = torch.where(pad[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, top_ids = top_k_stable(probs, k)                  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    me = probs.mean(dim=0)                                       # (E,)
    flat_e = top_ids.reshape(-1)                                 # (T*k,)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device) \
        .index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) \
        / (T * k)
    aux = cfg.router_aux_weight * cfg.n_experts * torch.sum(me * ce)
    oh = F.one_hot(flat_e, E).to(torch.int32)                    # (T*k, E)
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh        # before me
    pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0].long()
    return Routing(gate_vals, top_ids, pos_in_e, pos_in_e < capacity,
                   capacity, aux)


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig, *,
              capacity: Optional[int] = None, n_pad_experts: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) token-major -> (out (T, D), aux_loss scalar float32);
    routing by `route`."""
    T, D = x.shape
    E = cfg.n_experts + n_pad_experts
    k = cfg.top_k
    r = route(p, x, cfg, capacity=capacity, n_pad_experts=n_pad_experts)
    C, keep, pos_in_e = r.capacity, r.keep, r.pos_in_e
    flat_e = r.top_ids.reshape(-1)
    if _DROPS is not None:
        _DROPS.append(((~keep).sum(), T * k))
    # ---- dispatch: (E, C) slot -> token row ------------------------------
    # init -1; dropped pairs write -1 into slot (E-1, C-1) (a no-op under
    # max); empty slots then point at the zero pad row T
    src_rows = torch.arange(T * k, device=x.device) // k
    slot = torch.where(keep, flat_e * C + pos_in_e, (E - 1) * C + C - 1)
    tok_of_slot = torch.full((E * C,), -1, dtype=torch.long,
                             device=x.device).scatter_reduce_(
        0, slot, torch.where(keep, src_rows, -1), reduce="amax")
    tok_of_slot = torch.where(tok_of_slot < 0, T, tok_of_slot)
    xpad = torch.cat([x, x.new_zeros((1, D))], dim=0)
    xe = xpad[tok_of_slot].view(E, C, D)                         # (E, C, D)
    # ---- expert FFN (batched over the stacked experts) -------------------
    g = F.silu(torch.bmm(xe, p["w_gate"]))
    u = torch.bmm(xe, p["w_up"])
    y = torch.bmm(g * u, p["w_down"])                            # (E, C, D)
    # ---- combine: gather slots back per (token, k) ----------------------
    slot_of_tok = torch.where(keep, flat_e * C + pos_in_e, E * C)
    ypad = torch.cat([y.reshape(E * C, D), y.new_zeros((1, D))], dim=0)
    yk = ypad[slot_of_tok].view(T, k, D)
    out = torch.einsum("tkd,tk->td", yk.to(torch.float32),
                       r.gate_vals).to(x.dtype)
    if "shared" in p:
        out = out + swiglu(p["shared"], x)
    return out, r.aux


# ---------------------------------------------------------------------------
# explicit expert parallelism
# ---------------------------------------------------------------------------


def moe_apply_ep(p, x: torch.Tensor, cfg: MoEConfig, *,
                 n_pad_experts: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replicated-dispatch expert parallelism over `model` (the reference's
    `REPRO_MOE=ep`). x is this rank's dp block of tokens (T_loc, D), the
    same on every rank of its `model` group; the routing is computed on
    every rank alike, with the capacity of one dp group (T_loc's), and
    each rank dispatches only the pairs of its own E / ways experts. The
    one collective is a sum of the (T_loc, D) combined output over
    `model`; the shared expert is added after it on every rank.

    The expert leaves may be the full (E, ...) stacks (the rank takes its
    experts' rows) or its (E / ways, ...) block. Autograd gives
    `moe_apply`'s gradients summed over the dp blocks: the output sum's
    backward is the identity (the output is replicated), and the tokens
    and the router enter the routed path through an identity whose
    backward sums their gradient over `model`, since each rank's gate
    values see only its experts. The aux loss is each rank's own (its
    value the mean over dp, as the reference's `pmean`; its gradient this
    dp block's). Falls back to `moe_apply` when no grid is installed."""
    from repro_torch.distributed import act_sharding
    from repro_torch.launch.mesh import all_reduce, reduce_backward, \
        reduce_forward
    grid = act_sharding.grid()
    if grid is None or "model" not in grid.axis_names:
        return moe_apply(p, x, cfg, n_pad_experts=n_pad_experts)
    group, _ = grid.group(("model",))
    ways = grid.sizes["model"]
    rank = grid.index(("model",))
    T, D = x.shape
    E = cfg.n_experts + n_pad_experts
    if E % ways:
        raise ValueError(f"{E} experts do not split over {ways} ranks "
                         "(pad them: init_moe's n_pad_experts)")
    k = cfg.top_k
    E_loc = E // ways
    lo = rank * E_loc
    r = route(p, x, cfg, n_pad_experts=n_pad_experts)
    C = r.capacity
    # the gates again, through identities that sum the routed path's
    # gradient over `model`: this rank's part of it
    x_in = reduce_backward(x, group)
    logits = x_in.to(torch.float32) @ reduce_backward(p["router"], group)
    if n_pad_experts:
        pad = torch.arange(E, device=x.device) >= cfg.n_experts
        logits = torch.where(pad[None, :], -1e30, logits)
    gate_vals = torch.softmax(logits, dim=-1).gather(1, r.top_ids)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat_e = r.top_ids.reshape(-1)
    keep = r.keep & (flat_e >= lo) & (flat_e < lo + E_loc)
    e_loc = flat_e - lo
    src_rows = torch.arange(T * k, device=x.device) // k
    slot = torch.where(keep, e_loc * C + r.pos_in_e, E_loc * C - 1)
    tok_of_slot = torch.full((E_loc * C,), -1, dtype=torch.long,
                             device=x.device).scatter_reduce_(
        0, slot, torch.where(keep, src_rows, -1), reduce="amax")
    tok_of_slot = torch.where(tok_of_slot < 0, T, tok_of_slot)
    xpad = torch.cat([x_in, x_in.new_zeros((1, D))], dim=0)
    xe = xpad[tok_of_slot].view(E_loc, C, D)
    w = {n: p[n][lo:lo + E_loc] if p[n].shape[0] == E else p[n]
         for n in ("w_gate", "w_up", "w_down")}
    g = F.silu(torch.bmm(xe, w["w_gate"]))
    u = torch.bmm(xe, w["w_up"])
    y = torch.bmm(g * u, w["w_down"])                          # (E_loc, C, D)
    slot_of_tok = torch.where(keep, e_loc * C + r.pos_in_e, E_loc * C)
    ypad = torch.cat([y.reshape(E_loc * C, D), y.new_zeros((1, D))], dim=0)
    yk = ypad[slot_of_tok].view(T, k, D)
    out = torch.einsum("tkd,tk->td", yk.to(torch.float32), gate_vals)
    out = reduce_forward(out, group).to(x.dtype)
    if "shared" in p:
        out = out + swiglu(p["shared"], x)
    aux = r.aux
    dp = tuple(a for a in ("pod", "data") if a in grid.axis_names)
    if dp and grid.size(dp) > 1:
        mean = all_reduce(aux.detach(), grid.group(dp)[0]) / grid.size(dp)
        aux = aux + (mean - aux.detach())
    return out, aux
