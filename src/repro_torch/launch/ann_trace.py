"""The ANN cells' step in the dry run (`launch.dryrun`): the search on
meta tensors, its kernels replaced by shape-only stand-ins.

An ANN cell's step is `core.sharded_search.sharded_search_fn`'s search:
a `beam_search_device` on the rank's shard a query chunk, then the
merge's two all-gathers and top-k. Meta tensors cannot run its kernels,
and its loop cannot read its flag, so for the length of one trace
`standins` swaps three functions and puts them back after it, also when
the trace raises:

  * `sharded_search.beam_search_device` -> `Standins.beam_search_device`:
    the real `device_index._Search` (its fixed state and padding, the
    hop's sorts, gathers and scatters), `load`, `prologue`, ONE `hop()`
    and `result`. The number of hops depends on the data; the reference's
    XLA cost analysis counts a loop's body once, so one hop is counted
    too, and `per_hop` lets a roofline scale it;
  * `kernels.ops.build_lut` (`pq_lut_kernel`) -> its (nq, m, ks) float32
    output, allocated, and `lut_charge`;
  * `kernels.ops.fused_hop` (`hop_kernel<f32|int8>`) -> its three
    outputs, allocated, and `hop_charge`: the nq*w frontier rows the
    kernel reads at the layout's stride, not the chunk table a plain
    gather would count.

The charges go to the open `dryrun.Tally` (`charge`); every other op of
the search is counted op by op. No served module is changed: importing
this module installs nothing.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import device_index as DI
from repro_torch.core import sharded_search as SS
from repro_torch.core.chunk_layout import ChunkLayout
from repro_torch.kernels import ops


def lut_charge(nq: int, m: int, ks: int, dsub: int, metric: str) -> dict:
    """What `pq_lut_kernel` (`kernels/csrc/aisaq_kernels.cu`) reads,
    writes and computes for (nq, m*dsub) queries and (m, ks, dsub)
    centroids: each input read once, the LUT written once. Operations (an
    FMA is 2), by the kernel's statements: an entry's `cross[kk] += x *
    c[...]`, 2*dsub; then `qn - 2.f * cross[kk] + cn[kk]`, 3 (l2), or
    `-cross[kk]`, 1 (mips); l2 also sums each query slab's norm, `qn +=
    x * x`, 2*dsub a (query, subspace), and each centroid's, `cn[kk] +=
    ...`, 2*dsub (the kernel sums it again in each CTA's block of
    queries, a plan of the card's, not counted)."""
    nbytes = 4 * (nq * m * dsub + m * ks * dsub + nq * m * ks)
    if metric == "mips":
        flops = nq * m * ks * (2 * dsub + 1)
    else:
        flops = nq * m * ks * (2 * dsub + 3) + nq * m * 2 * dsub \
            + m * ks * 2 * dsub
    return {"bytes": nbytes, "flops": flops}


def hop_bytes(nq: int, w: int, layout: ChunkLayout, m: int, ks: int
              ) -> dict:
    """The bytes `hop_kernel` moves for nq queries of w frontier rows:
    each row at the device stride (`rows`: `launch.flops.
    ann_cell_terms`' chunk term for one hop), the query's f32 LUT once (a
    slab multicast to the cluster in f32; the CTAs' shares in int8, which
    quantize it in shared memory), the query and the frontier ids once,
    and the exact distances, neighbour ids and ADC distances written."""
    return {"rows": nq * w * layout.device_stride, "lut": nq * m * ks * 4,
            "queries": nq * layout.dim * 4, "frontier": nq * w * 4,
            "outputs": nq * w * (1 + 2 * layout.R) * 4}


def hop_charge(nq: int, w: int, layout: ChunkLayout, m: int, ks: int,
               metric: str, adc_dtype: str) -> dict:
    """`hop_bytes` summed, and the operations of `hop_kernel` a frontier
    row, by its statements: the exact distance, `df = v - qq; acc += df *
    df` (l2, 3*d) or `acc += v * qq` and `-acc` (mips, 2*d + 1), and the
    ADC's `acc[k] += lrow[code[k]]`, R*m; int8 adds each row's R rescales
    `acc[k] * s127` and each query's quantization of its LUT,
    `quantize_q8`'s division and multiplication an entry."""
    d, R = layout.dim, layout.R
    rows = nq * w
    exact = 2 * d + 1 if metric == "mips" else 3 * d
    flops = rows * (exact + R * m)
    if adc_dtype == "int8":
        flops += rows * R + nq * 2 * m * ks
    return {"bytes": sum(hop_bytes(nq, w, layout, m, ks).values()),
            "flops": flops}


class Standins:
    """The stand-ins of one trace (see the module docstring): they charge
    `tally` and sum, by kernel, what they charged (`kernels`) and what
    the hops cost (`per_hop`: the tally's bytes and the flops of `flops()`
    across each `hop()`, every query chunk's hop summed); the hop kernel's
    entry also keeps its `chunk_row_bytes`."""

    def __init__(self, tally, flops):
        self.tally, self.flops = tally, flops
        self.kernels = {}
        self.per_hop = {"flops": 0.0, "bytes accessed": 0}

    def _charge(self, kernel: str, c: dict, **parts) -> None:
        self.tally.charge(bytes=c["bytes"], flops=c["flops"])
        k = self.kernels.setdefault(kernel, dict(
            {"launches": 0, "flops": 0.0, "bytes accessed": 0},
            **{p: 0 for p in parts}))
        k["launches"] += 1
        k["flops"] += c["flops"]
        k["bytes accessed"] += c["bytes"]
        for p, v in parts.items():
            k[p] += v

    def build_lut(self, queries, centroids, *, metric="l2", backend="auto"):
        nq = queries.shape[0]
        m, ks, dsub = centroids.shape
        out = torch.empty((nq, m, ks), dtype=torch.float32,
                          device=queries.device)
        self._charge("pq_lut", lut_charge(nq, m, ks, dsub, metric))
        return out

    def fused_hop(self, chunk_words, frontier_ids, lut, queries, *,
                  layout, metric="l2", backend="auto", adc_dtype="f32"):
        nq, w = frontier_ids.shape
        m, ks = lut.shape[1], lut.shape[2]
        dev = frontier_ids.device
        exact = torch.empty((nq, w), dtype=torch.float32, device=dev)
        ids = torch.empty((nq, w, layout.R), dtype=torch.int32, device=dev)
        nbr_d = torch.empty((nq, w, layout.R), dtype=torch.float32,
                            device=dev)
        self._charge(f"fused_hop_{adc_dtype}",
                     hop_charge(nq, w, layout, m, ks, metric, adc_dtype),
                     chunk_row_bytes=hop_bytes(nq, w, layout, m, ks)["rows"])
        return exact, ids, nbr_d

    def beam_search_device(self, index, queries, *, k, L, w=4,
                           max_hops=128, layout, metric="l2",
                           backend="auto", adc_dtype="f32"):
        """`device_index.beam_search_device`'s steps with one hop: the
        search state as the card's path makes it, for the batch padded
        to its bucket. Returns (ids, d, 1)."""
        queries = queries.to(index.device, torch.float32).contiguous()
        nq = queries.shape[0]
        search = DI._Search(index, DI._pad_rows(nq), L=L, w=w,
                            max_hops=max_hops, layout=layout, metric=metric,
                            backend=backend, adc_dtype=adc_dtype)
        search.load(queries)
        search.prologue()
        b0, f0 = self.tally.bytes_accessed, self.flops()
        search.hop()
        self.per_hop["bytes accessed"] += self.tally.bytes_accessed - b0
        self.per_hop["flops"] += self.flops() - f0
        ids, d = search.result(nq, k)
        return ids, d, 1


@contextlib.contextmanager
def standins(tally, flops):
    """While open, `ops.build_lut`, `ops.fused_hop` and `sharded_search.
    beam_search_device` are a `Standins`' (yielded), charging `tally`;
    `flops()` gives the trace's flops so far."""
    s = Standins(tally, flops)
    saved = (ops.build_lut, ops.fused_hop, SS.beam_search_device)
    ops.build_lut, ops.fused_hop = s.build_lut, s.fused_hop
    SS.beam_search_device = s.beam_search_device
    try:
        yield s
    finally:
        ops.build_lut, ops.fused_hop, SS.beam_search_device = saved
