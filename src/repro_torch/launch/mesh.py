"""Named process grids and the collectives the port's sharded code runs on
them (port of `repro.launch.mesh`, on `torch.distributed` where the
reference builds a `jax.sharding.Mesh`).

A `ProcessGrid` lays the world's ranks out row-major over named axes:
("data", "model"), ("pod", "data", "model"), ("pp", "data"), ("data",).
Its `group(axes)` is the process group of the ranks that share this
rank's coordinates on every other axis: the ranks that a collective over
`axes` spans in the reference's `shard_map`.

    pod   -- the DCN tier: pure data parallelism (LM), more index shards
    data  -- batch data parallelism and FSDP (parameters gathered at use)
    model -- expert parallelism, row-sharded tables, index shards,
             context-parallel attention
    pp    -- pipeline stages (`distributed.pipeline`)

Initialising the process group is the caller's job
(`torch.distributed.init_process_group`, with its address, world size and
rank given explicitly). Gloo moves host tensors: with CUDA tensors on a
gloo group (several ranks sharing one card; NCCL refuses two ranks on one
GPU) every collective below copies to the host and back. NCCL, one card a
rank, runs them on the card. Gloo refuses bfloat16 tensors: a gather moves
their bytes (exact), a sum runs in float32.

`fake_world(n)` starts a world of n ranks in one process whose
collectives move nothing (torch's "fake" backend): with meta tensors it
traces what a rank of an n-rank grid holds and sends (`launch.dryrun`).
`record_collectives()` counts every collective below while it is open.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class ProcessGrid:
    """The world's ranks as a grid of `shape` over the axes `axes`,
    row-major (the last axis varies fastest). Needs an initialised default
    process group of prod(shape) ranks; `rank=` describes one rank of a
    grid without a world (for the specs and `sharding.shard`: no
    collective runs on such a grid)."""

    def __init__(self, shape: Sequence[int],
                 axes: Sequence[str] = ("data", "model"), *,
                 rank: Optional[int] = None):
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"a grid needs one size per distinct axis, got "
                             f"shape {shape} and axes {axes}")
        self.shape, self.axis_names = shape, axes
        n = int(np.prod(shape))
        self.live = rank is None
        if self.live:
            if not dist.is_initialized():
                raise RuntimeError("ProcessGrid needs torch.distributed's "
                                   "default process group "
                                   "(init_process_group)")
            if n != dist.get_world_size():
                raise ValueError(f"a {shape} grid needs {n} ranks, the "
                                 f"world has {dist.get_world_size()}")
            rank = dist.get_rank()
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} is outside a {shape} grid")
        self.world, self.rank = n, int(rank)
        self._groups: Dict[Tuple[str, ...], tuple] = {}
        self._coords: Dict[int, Tuple[int, ...]] = {}

    def __repr__(self) -> str:
        return (f"ProcessGrid({self.shape}, {self.axis_names}, "
                f"rank={self.rank})")

    @property
    def sizes(self) -> Dict[str, int]:
        """{axis: size}, the reference's `mesh.shape`."""
        return dict(zip(self.axis_names, self.shape))

    def coords(self, rank: int = None) -> Tuple[int, ...]:
        r = self.rank if rank is None else rank
        if r not in self._coords:
            self._coords[r] = tuple(int(c) for c in
                                    np.unravel_index(r, self.shape))
        return self._coords[r]

    def _axis(self, name: str) -> int:
        return self.axis_names.index(name)

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[self._axis(a)] for a in axes)

    def index(self, axes: Sequence[str], rank: int = None) -> int:
        """The rank's block along `axes` taken together, the first one
        major: the block of a dim that the reference's PartitionSpec entry
        `axes` gives this device."""
        c = self.coords(rank)
        i = 0
        for a in axes:
            i = i * self.shape[self._axis(a)] + c[self._axis(a)]
        return i

    def group(self, axes: Sequence[str]):
        """(process group, its member ranks in order of `index(axes)`):
        the ranks that share this rank's coordinates on the other axes.
        The first call for some `axes` is collective (every rank creates
        every such group, in the same order)."""
        axes = tuple(axes)
        if axes not in self._groups:
            if not self.live:
                raise RuntimeError(f"{self!r} has no world: no collectives")
            others = [self._axis(a) for a in self.axis_names
                      if a not in axes]
            buckets: Dict[tuple, list] = {}
            for r in range(self.world):
                c = self.coords(r)
                buckets.setdefault(tuple(c[i] for i in others), []).append(r)
            for key in sorted(buckets):
                members = buckets[key]
                g = (dist.group.WORLD if len(members) == self.world
                     else dist.new_group(members))
                if self.rank in members:
                    self._groups[axes] = (g, sorted(
                        members, key=lambda r: self.index(axes, r)))
        return self._groups[axes]

    def rank_at(self, **coords: int) -> int:
        """The world rank at this rank's coordinates with `coords` put in
        (e.g. `rank_at(pp=s + 1)`: the next stage of this rank's column)."""
        c = list(self.coords())
        for a, v in coords.items():
            c[self._axis(a)] = v
        return int(np.ravel_multi_index(c, self.shape))


def make_grid(shape: Sequence[int], axes: Sequence[str]) -> ProcessGrid:
    """The reference's `make_mesh_compat`: a grid over the live world."""
    return ProcessGrid(shape, axes)


def make_production_grid(*, multi_pod: bool = False) -> ProcessGrid:
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model) with
    `multi_pod`: the reference's production meshes (256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ProcessGrid(shape, axes)


def fake_world(n: int, rank: int = 0) -> None:
    """Initialise the default process group as a world of `n` ranks, this
    process rank `rank`, on torch's fake backend: every collective returns
    at once and moves nothing, so meta tensors trace one rank's part of an
    n-rank program. A fake world already up is replaced; any other raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


def make_test_grid(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model")) -> ProcessGrid:
    """A small grid for multi-process tests (the reference's is (2, 4) on
    8 virtual devices; the port's tests run 4 gloo ranks)."""
    return ProcessGrid(shape, axes)


# ---------------------------------------------------------------------------
# collectives (through the host for CUDA tensors on gloo)
# ---------------------------------------------------------------------------


_RECORD: Optional[Dict[str, Dict[str, int]]] = None


@contextlib.contextmanager
def record_collectives() -> Iterator[Dict[str, Dict[str, int]]]:
    """Counts the collectives below while open: yields {op: {"count",
    "bytes"}} under the reference's HLO names ("all-reduce", "all-gather",
    "broadcast", "collective-permute" for `isend` and `recv`, counted at
    each end), bytes being each occurrence's output on this rank (the
    reference's `dryrun.collective_bytes` convention): the reduced
    tensor as it goes on the wire, the gathered stack, the broadcast or
    sent / received tensor. A group of one rank moves nothing and counts
    nothing."""
    global _RECORD
    prev, _RECORD = _RECORD, {}
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _note(op: str, nbytes: int) -> None:
    if _RECORD is not None:
        c = _RECORD.setdefault(op, {"count": 0, "bytes": 0})
        c["count"] += 1
        c["bytes"] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    return (t.cpu() if via_host(t, group) else t).contiguous()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: `op` of every member's t. bfloat16 reduces in
    float32 and is rounded back."""
    if dist.get_world_size(group) == 1:
        return t.clone()
    x = t.to(torch.float32) if t.dtype == torch.bfloat16 else t
    w = _wire(x, group)
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    dist.all_reduce(w, op=_OPS[op], group=group)
    _note("all-reduce", _nbytes(w))
    return w.to(device=t.device, dtype=t.dtype)


def all_gather(t: torch.Tensor, group, members: Sequence[int]
               ) -> torch.Tensor:
    """(len(members), *t.shape): every member's t (all the same shape), in
    `members` order."""
    n = len(members)
    if n == 1:
        return t[None]
    if t.is_meta:
        # a shape trace (`launch.dryrun`): the bytes the path below holds
        # and moves (the members' buffers, then their stack, alive
        # together: the dry run's peak counts both) in two ops, without
        # the fake backend, whose per-member checks cost ~17 ms a
        # 256-rank call
        _note("all-gather", n * _nbytes(t))
        return t.new_empty((n,) + tuple(t.shape)).clone()
    bits = t.view(torch.uint8) if t.dtype == torch.bfloat16 else t
    src = _wire(bits, group)
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    _note("all-gather", n * _nbytes(src))
    by_rank = dict(zip(dist.get_process_group_ranks(group), out))
    stacked = torch.stack([by_rank[r] for r in members]).to(t.device)
    return stacked.view(t.dtype) if t.dtype == torch.bfloat16 else stacked


def all_gather_ragged(t: torch.Tensor, group, members: Sequence[int]
                      ) -> list:
    """Every member's t, whose leading dims may differ, in `members`
    order (padded to the longest for the gather, then cut)."""
    n = len(members)
    if n == 1:
        return [t]
    lens = all_gather(torch.tensor([t.shape[0]]), group, members)[:, 0]
    most = int(lens.max())
    pad = t.new_zeros((most - t.shape[0],) + tuple(t.shape[1:]))
    got = all_gather(torch.cat([t, pad]), group, members)
    return [got[i, :int(lens[i])] for i in range(n)]


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` of world rank `src` on every member (t gives the shape and
    dtype on the others)."""
    if dist.get_world_size(group) == 1:
        return t
    bits = t.view(torch.uint8) if t.dtype == torch.bfloat16 else t
    w = _wire(bits, group)
    dist.broadcast(w, src=src, group=group)
    _note("broadcast", _nbytes(w))
    w = w.to(t.device)
    return w.view(t.dtype) if t.dtype == torch.bfloat16 else w


def isend(t: torch.Tensor, dst: int):
    """Start sending t to world rank `dst`; returns (work, the tensor on
    the wire), both to be kept until `work.wait()`."""
    w = _wire(t, dist.group.WORLD)
    _note("collective-permute", _nbytes(w))
    return dist.isend(w, dst), w


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """A tensor shaped and typed as `like`, received from world rank
    `src`, on like's device."""
    w = torch.empty_like(like, device="cpu" if via_host(
        like, dist.group.WORLD) else like.device)
    dist.recv(w, src)
    _note("collective-permute", _nbytes(w))
    return w.to(like.device)


class _ReduceForward(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the identity (the sum
    is replicated over the group, and so is its cotangent)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBackward(torch.autograd.Function):
    """Forward: the identity. Backward: the sum of the members'
    cotangents (each member's is its part of the gradient)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def reduce_forward(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over `group` whose backward is the identity."""
    return _ReduceForward.apply(t, group)


def reduce_backward(t: torch.Tensor, group) -> torch.Tensor:
    """Identity whose backward sums the gradient over `group`."""
    return _ReduceBackward.apply(t, group)
