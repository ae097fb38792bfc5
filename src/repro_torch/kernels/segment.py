"""The GNN family's aggregation: a deterministic segment sum over a CSR
(`csrc/gnn_kernels.cu` `gnn_segment_sum`).

It replaces no `pallas_call`: the reference aggregates with
`jax.ops.segment_sum` over gathered messages (`repro/models/gnn.py:58`).
`prepare_csr` turns an edge list into two CSRs once per graph, on the
edges' device:

- by destination, for the forward: row r holds the sources of the valid
  edges into r, in the edge list's order (a stable sort), which is the
  order the reference's scatter adds them in;
- by source, for the backward: row s holds the destinations of the edges
  out of s.

Edges whose destination is out of range are dropped, as
`jax.ops.segment_sum` drops them (`gnn.pad_edges`' (n, n) dummies).
Sources out of range are clamped in the forward, as JAX's gather clamps
them (a negative one first wraps, as jnp indexing does), and their edges
are left out of the backward, as the gather's transpose drops them. With
`drop_bad_src` (the sharded loss, `gnn_sharded.py`) a source past the end
contributes nothing either way and a negative one reads row 0, as the
reference's clip-and-mask does. `deg` counts the edges of a row whose destination is
valid, whatever their source, as both reference paths count it.

`segment_sum(x, csr)` is a `torch.autograd.Function`: the forward runs the
kernel over the destination CSR, the backward (the gradient of `x`) runs
the same kernel over the source CSR. A mean's division by `max(deg, 1)`
stays in torch around it, so the backward divides the cotangent before
summing it, the reference's order. CUDA tensors reach the kernel or raise;
CPU tensors take `ref.segment_sum_ref` (`index_add_` over the same edges).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device, to_tensor
from repro_torch.kernels import _build, ref

# edges a warp sums before a row counts as a hub (split into chunks summed
# in parallel, then added in chunk order)
CHUNK = 4096


class CSR(NamedTuple):
    """One direction of a graph: row r reads rows col[indptr[r]:indptr[r+1]]
    of an (n_cols, F) input. The hub plan: rows of more than CHUNK edges
    (`hub_rows`), their chunks (`chunk_row`, `chunk_beg`), and each hub's
    first chunk (`hub_first`, n_hubs + 1 offsets)."""

    indptr: torch.Tensor       # (n_rows + 1,) int64
    col: torch.Tensor          # (nnz,) int32
    n_cols: int
    hub_rows: torch.Tensor     # (n_hubs,) int32
    hub_first: torch.Tensor    # (n_hubs + 1,) int32
    chunk_row: torch.Tensor    # (n_chunks,) int32
    chunk_beg: torch.Tensor    # (n_chunks,) int64

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_chunks(self) -> int:
        return self.chunk_row.shape[0]

    def rows(self) -> torch.Tensor:
        """(nnz,) int64: the row of each entry of `col`."""
        counts = self.indptr[1:] - self.indptr[:-1]
        return torch.repeat_interleave(
            torch.arange(self.n_rows, device=counts.device), counts,
            output_size=self.col.shape[0])


class GraphCSR(NamedTuple):
    """A graph's two CSRs and its in-degrees, made once by `prepare_csr`."""

    by_dst: CSR                # forward: rows are destinations
    by_src: CSR                # backward: rows are sources
    deg: torch.Tensor          # (n_rows,) float32 edges with a valid dst

    @property
    def n_rows(self) -> int:
        return self.by_dst.n_rows

    @property
    def n_edges(self) -> int:
        return self.by_dst.col.shape[0]


def _csr(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
         n_cols: int) -> CSR:
    order = torch.sort(rows, stable=True).indices
    counts = torch.bincount(rows, minlength=n_rows)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    hubs = torch.nonzero(counts > CHUNK).flatten()
    n_ch = (counts[hubs] + CHUNK - 1) // CHUNK
    hub_first = torch.zeros(hubs.shape[0] + 1, dtype=torch.int64,
                            device=rows.device)
    torch.cumsum(n_ch, 0, out=hub_first[1:])
    total = int(hub_first[-1])
    chunk_hub = torch.repeat_interleave(
        torch.arange(hubs.shape[0], device=rows.device), n_ch,
        output_size=total)
    k = torch.arange(total, device=rows.device) - hub_first[chunk_hub]
    chunk_row = hubs[chunk_hub]
    return CSR(indptr=indptr, col=cols[order].to(torch.int32),
               n_cols=n_cols, hub_rows=hubs.to(torch.int32),
               hub_first=hub_first.to(torch.int32),
               chunk_row=chunk_row.to(torch.int32),
               chunk_beg=indptr[chunk_row] + k * CHUNK)


def prepare_csr(edges, n_rows: int, *, n_src: Optional[int] = None,
                drop_bad_src: bool = False, grad_mask=None,
                device: DeviceLike = None) -> GraphCSR:
    """Both CSRs of `edges` ((E, 2) [src, dst], a tensor or numpy) onto
    `n_rows` destination rows, from `n_src` source rows (default n_rows).
    `grad_mask` ((E,) bool), when given, leaves the edges where it is
    False out of the backward (sources its caller clamped already, see
    `gnn.batched_csr`). Built on `device`: by default the edges' own
    when they are a tensor, else the card."""
    if device is None and isinstance(edges, torch.Tensor):
        dev = edges.device
    else:
        dev = resolve_device(device)
    e = to_tensor(edges, dev)
    n_src = n_rows if n_src is None else n_src
    if dev.type == "meta":
        return _meta_graph(e.shape[0], n_rows, n_src)
    src, dst = e[:, 0].long(), e[:, 1].long()
    ok = (dst >= 0) & (dst < n_rows)
    deg = torch.bincount(dst[ok], minlength=n_rows).to(torch.float32)
    if drop_bad_src:
        src = src.clamp(min=0)
        ok &= src < n_src
        fwd_src, bwd = src, ok
    else:
        src = torch.where(src < 0, src + n_src, src)
        fwd_src = src.clamp(0, n_src - 1)
        # JAX's gather clamps, but its transpose drops what it clamped
        bwd = ok & (src >= 0) & (src < n_src)
        if grad_mask is not None:
            bwd &= to_tensor(grad_mask, dev, torch.bool)
    return GraphCSR(by_dst=_csr(dst[ok], fwd_src[ok], n_rows, n_src),
                    by_src=_csr(src[bwd], dst[bwd], n_src, n_rows),
                    deg=deg)


def _meta_graph(n_edges: int, n_rows: int, n_src: int) -> GraphCSR:
    """A graph's CSRs as meta tensors for a meta trace (`launch.dryrun`),
    which cannot size what the edges hold: every edge counts as valid, no
    row as a hub."""
    def csr(rows: int, cols: int) -> CSR:
        def z(n, dt):
            return torch.empty((n,), dtype=dt, device="meta")
        return CSR(indptr=z(rows + 1, torch.int64),
                   col=z(n_edges, torch.int32), n_cols=cols,
                   hub_rows=z(0, torch.int32), hub_first=z(1, torch.int32),
                   chunk_row=z(0, torch.int32), chunk_beg=z(0, torch.int64))
    return GraphCSR(by_dst=csr(n_rows, n_src), by_src=csr(n_src, n_rows),
                    deg=torch.empty((n_rows,), device="meta"))


def csr_sum(x: torch.Tensor, csr: CSR) -> torch.Tensor:
    """(csr.n_rows, F) float32: row r the sum of x's rows that `csr` lists
    for r, in its order. CUDA tensors launch the kernel; CPU tensors take
    `ref.segment_sum_ref`; meta ones (a meta graph) give the shape."""
    if x.ndim != 2 or x.shape[0] != csr.n_cols:
        raise ValueError(f"x {tuple(x.shape)} does not have the CSR's "
                         f"{csr.n_cols} source rows")
    if x.is_meta and csr.col.is_meta:
        # a shape trace (`launch.dryrun`) over `_meta_graph`'s CSRs
        return x.new_empty((csr.n_rows, x.shape[1]), dtype=torch.float32)
    if not _build.on_cuda(x, csr.indptr, csr.col):
        return ref.segment_sum_ref(x, csr.col, csr.rows(), csr.n_rows)
    F = x.shape[1]
    _build.require(x, "x", torch.float32, (csr.n_cols, F))
    out = torch.empty((csr.n_rows, F), dtype=torch.float32, device=x.device)
    if F == 0:
        return out
    partial = torch.empty((csr.n_chunks, F), dtype=torch.float32,
                          device=x.device)
    err = _build.lib().gnn_segment_sum(
        x.data_ptr(), F, csr.indptr.data_ptr(), csr.col.data_ptr(),
        csr.n_rows, CHUNK, csr.chunk_row.data_ptr(),
        csr.chunk_beg.data_ptr(), csr.n_chunks, csr.hub_rows.data_ptr(),
        csr.hub_first.data_ptr(), csr.hub_rows.shape[0],
        partial.data_ptr(), out.data_ptr(), _build.stream())
    _build.check(err, "segment_sum")
    _build.count_launch("segment_sum")
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, csr):
        ctx.csr = csr
        return csr_sum(x, csr.by_dst)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        return csr_sum(g.contiguous(), ctx.csr.by_src), None


def segment_sum(x: torch.Tensor, csr: GraphCSR) -> torch.Tensor:
    """(n_rows, F): out[d] = sum of x[s] over the valid edges (s, d), with
    its gradient; x is (n_src, F) float32."""
    return _SegmentSum.apply(x.contiguous(), csr)


def segment_occupancy() -> dict:
    """Registers, spill bytes and resident CTAs an SM of the rows kernel,
    for F <= 32 (`v1_*`) and wider rows (`v4_*`). Needs the card."""
    out = (ctypes.c_int * 6)()
    _build.check(_build.lib().gnn_segment_occupancy(out),
                 "segment_occupancy")
    keys = [f"{v}_{k}" for v in ("v1", "v4")
            for k in ("registers", "local_bytes", "ctas_per_sm")]
    return dict(zip(keys, list(out)))

