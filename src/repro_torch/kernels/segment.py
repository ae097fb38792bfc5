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
  out of s, in the edge list's order, except in a hub row (below), whose
  entries are sorted stably by destination.

Edges whose destination is out of range are dropped, as
`jax.ops.segment_sum` drops them (`gnn.pad_edges`' (n, n) dummies).
Sources out of range are clamped in the forward, as JAX's gather clamps
them (a negative one first wraps, as jnp indexing does), and their edges
are left out of the backward, as the gather's transpose drops them. With
`drop_bad_src` (the sharded loss, `gnn_sharded.py`) a source past the end
contributes nothing either way and a negative one reads row 0, as the
reference's clip-and-mask does. `deg` counts the edges of a row whose destination is
valid, whatever their source, as both reference paths count it.

The order of every float32 sum is fixed by the CSR alone (`CSR`'s plan):

- a row of at most CHUNK entries is summed in its entries' order;
- a hub row (more than CHUNK entries) is cut into chunks, each summed in
  order into a partial; then the row's partials are added in entry order
  (`chunk_slot`: a hub's slots are consecutive, in entry order).
  By destination the chunks are every CHUNK entries of the row. By source
  the hub row is sorted by destination and cut where the destination
  band (BAND_ROWS rows of the cotangent) changes and every CHUNK entries
  within a band, and the chunk table runs band-major, so that the chunks
  of all hubs reading one band run together and share its rows in L2.

The forward stages its hottest sources in shared memory: `hot_ids` are
the sources that the most entries read (ties to the lower id; at most
HOT_MAX, each read by at least HOT_MIN_EDGES entries, together at least
HOT_MIN_SHARE of the entries, else none: molecule's batched graphs stage
nothing; nor does a graph of more than 2^HOT_ID_BITS sources), and
`hot_col` is `col` with a hot source's entries coded -2^31 + rank *
2^HOT_ID_BITS + id (nnz * 4 bytes more, and only where there are hot
sources; `col` keeps the true ids). The kernel stages as many of them as
fit its stage of shared memory at the call's width and decodes the rest.

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

# entries a warp sums before a row counts as a hub (split into chunks
# summed in parallel, then added in order)
CHUNK = 4096
# the backward's destination bands: 24 MiB of the cotangent at the hidden
# width (128 float32 columns), about half the H100's 50 MB L2
BAND_ROWS = (24 << 20) // (128 * 4)
# the forward's hot sources (see the module docstring); a hot entry of
# `hot_col` is -2^31 + rank * 2^HOT_ID_BITS + id, so ids below
# 2^HOT_ID_BITS and ranks below HOT_MAX
HOT_MAX = 512
HOT_MIN_EDGES = 1024
HOT_MIN_SHARE = 0.25
HOT_ID_BITS = 22


class CSR(NamedTuple):
    """One direction of a graph: row r reads rows col[indptr[r]:indptr[r+1]]
    of an (n_cols, F) input. The hub plan: rows of more than CHUNK entries
    (`hub_rows`), their chunks in the order the kernel runs them
    (`chunk_row`, entries [`chunk_beg`, `chunk_end`), the partial's slot
    `chunk_slot`), and each hub's first slot (`hub_first`, n_hubs + 1
    offsets). `band_rows` is the destination band of a banded CSR (0:
    none); `hot_ids` and `hot_col` the staged sources of the forward."""

    indptr: torch.Tensor       # (n_rows + 1,) int64
    col: torch.Tensor          # (nnz,) int32
    n_cols: int
    hub_rows: torch.Tensor     # (n_hubs,) int32
    hub_first: torch.Tensor    # (n_hubs + 1,) int32
    chunk_row: torch.Tensor    # (n_chunks,) int32
    chunk_beg: torch.Tensor    # (n_chunks,) int64
    chunk_end: torch.Tensor    # (n_chunks,) int64
    chunk_slot: torch.Tensor   # (n_chunks,) int32
    band_rows: int
    hot_ids: torch.Tensor      # (n_hot,) int32
    hot_col: torch.Tensor      # (nnz,) int32 (`col` itself when n_hot = 0)

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_chunks(self) -> int:
        return self.chunk_row.shape[0]

    @property
    def n_hot(self) -> int:
        return self.hot_ids.shape[0]

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


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))


def _csr(rows: torch.Tensor, cols: torch.Tensor, n_rows: int, n_cols: int,
         *, band_rows: int = 0, hot: bool = False) -> CSR:
    """The CSR of entries (rows, cols) with its hub plan; `band_rows` > 0
    sorts hub rows by column and bands their chunks, `hot` picks the
    forward's hot sources. Host syncs: one read of the plan's sizes and
    two `nonzero`s."""
    dev, nnz = rows.device, rows.shape[0]
    counts = _counts(rows, n_rows)
    hub = counts > CHUNK
    key = rows
    if band_rows:
        key = rows * max(n_cols, 1) + torch.where(hub[rows], cols, 0)
    order = torch.sort(key, stable=True).indices
    del key
    col = cols[order]
    r = rows[order]
    del order
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=indptr[1:])
    # a hub row's chunks: a new one where its band changes, and every
    # CHUNK entries within a band
    pos = torch.arange(nnz, device=dev)
    band = col // band_rows if band_rows else torch.zeros_like(col)
    grp = (pos == indptr[r]) | torch.cat([band[:1] < 0,
                                          band[1:] != band[:-1]])
    grp = torch.cummax(torch.where(grp, pos, 0), 0).values
    opens = hub[r] & ((pos - grp) % CHUNK == 0)
    del grp
    n_hot_d = torch.zeros((), dtype=torch.int64, device=dev)
    if hot and n_cols <= 1 << HOT_ID_BITS:
        cnt, ids = torch.sort(_counts(cols, n_cols), descending=True,
                              stable=True)
        cnt, ids = cnt[:HOT_MAX], ids[:HOT_MAX]
        take = cnt >= HOT_MIN_EDGES
        n_hot_d = torch.where((cnt * take).sum() >= HOT_MIN_SHARE * nnz,
                              take.sum(), 0)
    n_chunks, n_hot = torch.stack([opens.sum(), n_hot_d]).tolist()
    hubs = torch.nonzero(hub).flatten()
    cpos = torch.nonzero(opens).flatten()       # slot order: hub, entry
    del opens, pos
    crow = r[cpos]
    same = crow[1:] == crow[:-1]
    cend = torch.cat([torch.where(same, cpos[1:], indptr[crow[:-1] + 1]),
                      indptr[crow[-1:] + 1]])
    hub_first = torch.full((hubs.shape[0] + 1,), n_chunks, dtype=torch.int32,
                           device=dev)
    hub_first[:-1] = torch.searchsorted(crow, hubs).to(torch.int32)
    # the chunk table runs band-major (a stable sort: by hub and entry
    # within a band)
    perm = torch.sort(band[cpos], stable=True).indices
    col = col.to(torch.int32)
    hot_ids = ids[:n_hot].to(torch.int32) if n_hot else \
        torch.zeros(0, dtype=torch.int32, device=dev)
    hot_col = col
    if n_hot:
        slot = torch.full((n_cols,), -1, dtype=torch.int32, device=dev)
        slot[hot_ids.long()] = torch.arange(n_hot, dtype=torch.int32,
                                            device=dev)
        s = slot[col.long()].long()
        hot_col = torch.where(s >= 0, (s << HOT_ID_BITS) + col - 2 ** 31,
                              col).to(torch.int32)
    return CSR(indptr=indptr, col=col, n_cols=n_cols,
               hub_rows=hubs.to(torch.int32), hub_first=hub_first,
               chunk_row=crow[perm].to(torch.int32), chunk_beg=cpos[perm],
               chunk_end=cend[perm], chunk_slot=perm.to(torch.int32),
               band_rows=band_rows, hot_ids=hot_ids, hot_col=hot_col)


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
    return GraphCSR(by_dst=_csr(dst[ok], fwd_src[ok], n_rows, n_src,
                                hot=True),
                    by_src=_csr(src[bwd], dst[bwd], n_src, n_rows,
                                band_rows=BAND_ROWS),
                    deg=deg)


def _meta_graph(n_edges: int, n_rows: int, n_src: int) -> GraphCSR:
    """A graph's CSRs as meta tensors for a meta trace (`launch.dryrun`),
    which cannot size what the edges hold: every edge counts as valid, no
    row as a hub, no source as hot, no band."""
    def csr(rows: int, cols: int) -> CSR:
        def z(n, dt):
            return torch.empty((n,), dtype=dt, device="meta")
        col = z(n_edges, torch.int32)
        return CSR(indptr=z(rows + 1, torch.int64), col=col, n_cols=cols,
                   hub_rows=z(0, torch.int32), hub_first=z(1, torch.int32),
                   chunk_row=z(0, torch.int32), chunk_beg=z(0, torch.int64),
                   chunk_end=z(0, torch.int64), chunk_slot=z(0, torch.int32),
                   band_rows=0, hot_ids=z(0, torch.int32), hot_col=col)
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
    # the chunk pass's work counter (set to 0 by the launcher)
    counter = torch.empty((1 if csr.n_chunks else 0,), dtype=torch.int32,
                          device=x.device)
    err = _build.lib().gnn_segment_sum(
        x.data_ptr(), F, csr.indptr.data_ptr(), csr.col.data_ptr(),
        csr.hot_col.data_ptr(), csr.n_rows, CHUNK, csr.hot_ids.data_ptr(),
        csr.n_hot,
        csr.chunk_beg.data_ptr(), csr.chunk_end.data_ptr(),
        csr.chunk_slot.data_ptr(), csr.n_chunks, csr.hub_rows.data_ptr(),
        csr.hub_first.data_ptr(), csr.hub_rows.shape[0],
        partial.data_ptr(), counter.data_ptr(), out.data_ptr(),
        _build.stream())
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


OCCUPANCY_KEYS = ("lanes_per_row", "vector", "staged_rows",
                  "dynamic_smem", "rows_registers", "rows_local_bytes",
                  "rows_ctas_per_sm", "chunks_registers",
                  "chunks_local_bytes", "chunks_ctas_per_sm",
                  "hubs_registers", "sms")


def segment_occupancy(F: int, n_hot: int = 0) -> dict:
    """The plan and resources of the kernels that a call at width F with
    `n_hot` hot sources runs on a 16-byte aligned x: lanes a row, 16-byte
    loads or not, the rows each CTA stages and their dynamic shared memory;
    the rows kernel's (1,024 threads a CTA where rows are staged, else
    256) and the chunk kernel's (256) registers, spill bytes and resident
    CTAs an SM; the hub kernel's registers; the SMs. Needs the card."""
    out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    _build.check(_build.lib().gnn_segment_occupancy(F, n_hot, out),
                 "segment_occupancy")
    return dict(zip(OCCUPANCY_KEYS, list(out)))
