"""Device AiSAQ index: the chunk table in GPU memory + batched beam search.

Port of `repro.core.device_index`. The (N, device_stride/4) int32 chunk
table is the "storage tier"; in the AiSAQ placement the per-hop work
(chunk gather, parse, exact distance, inline-PQ ADC) is
`kernels.ops.fused_hop`, and the only per-query fast-tier state is the
(L,) candidate list, the (m, ks) LUT and the rerank pool. The DiskANN
placement (the paper's baseline) keeps every node's PQ code resident in
an (N, m) table and reads neighbour codes from it.

The reference runs its loop as a `lax.while_loop` on the device. Here the
loop's condition is computed on the device too, and read by the host once
every K hops: on the card K hops run as one CUDA graph replay, so a
search syncs ceil(hops / K) times, not once a hop.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chunk_layout import ChunkLayout, chunk_matrix, \
    pack_chunks_torch
from repro_torch.core.relabel import invert_permutation
from repro_torch.cudagraph import Graph, warm_up
from repro_torch.device import DeviceLike, resolve_device, to_tensor
from repro_torch.kernels import ops
from repro_torch.kernels.ref import expand_rows_ref, sum_in_order


@dataclass
class DeviceIndex:
    chunk_words: torch.Tensor        # (N, stride/4) int32 — storage tier
    centroids: torch.Tensor          # (m, ks, dsub) f32
    ep_ids: torch.Tensor             # (n_ep,) int32
    ep_codes: torch.Tensor           # (n_ep, m) int32
    pq_codes: Optional[torch.Tensor] = None   # (N, m) — diskann mode ONLY
    # the search's CUDA graphs, by shape and options (beam_search_device)
    graphs: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.chunk_words.shape[0]

    @property
    def device(self) -> torch.device:
        return self.chunk_words.device

    def fast_tier_bytes(self, n_queries: int, L: int) -> int:
        """Bytes that must live in the fast tier during search (paper T2)."""
        m, ks = self.centroids.shape[0], self.centroids.shape[1]
        per_q = 4 * (m * ks + 3 * L)          # LUT + candidate list + pool
        resident = self.centroids.numel() * 4 + self.ep_codes.numel() * 4
        if self.pq_codes is not None:         # DiskANN keeps ALL codes hot
            resident += self.pq_codes.numel() * self.pq_codes.element_size()
        return int(resident + per_q * n_queries)


def from_arrays(vectors, graph, centroids, codes, *, mode: str = "aisaq",
                block_bytes: int = 4096, device: DeviceLike = None
                ) -> Tuple[DeviceIndex, ChunkLayout]:
    """Pack vectors (N, d) f32/u8, graph (N, R) int (-1 padded), centroids
    (m, ks, dsub) and codes (N, m) u8 — numpy arrays or tensors — into a
    DeviceIndex on `device`. The chunk table is packed on the device."""
    dev = resolve_device(device)
    vecs = to_tensor(vectors, dev)
    n, d = vecs.shape
    graph = to_tensor(graph, dev)
    codes = to_tensor(codes, dev)
    layout = ChunkLayout(
        mode=mode, dim=d,
        data_dtype="uint8" if vecs.dtype == torch.uint8 else "float32",
        R=graph.shape[1], pq_m=codes.shape[1], block_bytes=block_bytes)
    words = pack_chunks_torch(vecs, graph, codes, layout)
    # entry point: the vector nearest the mean
    vf = vecs.float()
    dd = ((vf - vf.mean(dim=0)) ** 2).sum(dim=1)
    ep = dd.argmin().reshape(1).to(torch.int32)
    idx = DeviceIndex(
        chunk_words=words,
        centroids=to_tensor(centroids, dev, torch.float32),
        ep_ids=ep,
        ep_codes=codes[ep.long()].to(torch.int32),
        pq_codes=codes if mode == "diskann" else None)
    return idx, layout


def from_numpy(chunk_words, centroids, ep_ids, ep_codes, *,
               device: DeviceLike = None) -> DeviceIndex:
    """Carry an index across from numpy arrays (e.g. the fields of the
    JAX package's DeviceIndex, converted with np.asarray)."""
    dev = resolve_device(device)

    return DeviceIndex(
        chunk_words=to_tensor(chunk_words, dev, torch.int32),
        centroids=to_tensor(centroids, dev, torch.float32),
        ep_ids=to_tensor(ep_ids, dev, torch.int32),
        ep_codes=to_tensor(ep_codes, dev, torch.int32))


def load_device_index(path: str, *, device: DeviceLike = None
                      ) -> Tuple[DeviceIndex, ChunkLayout, str]:
    """Load an index directory (the host format `repro`'s write_index
    writes) into device tensors. Returns (index, layout, metric)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    codes = np.load(os.path.join(path, "pq_codes.npy"))
    centroids = np.load(os.path.join(path, "pq_centroids.npy"))
    layout = ChunkLayout(mode=meta["mode"], dim=meta["dim"],
                         data_dtype=meta["data_dtype"], R=meta["R"],
                         pq_m=meta["pq_m"], block_bytes=meta["block_bytes"])
    raw = np.fromfile(os.path.join(path, "chunks.bin"), dtype=np.uint8)
    n = meta["n"]
    chunks = chunk_matrix(raw, layout, n)
    if meta["data_dtype"] == "uint8":
        vecs = chunks[:, :layout.b_full].copy()
    else:
        vecs = np.ascontiguousarray(
            chunks[:, :layout.b_full]).view(np.float32).reshape(n, -1)
    graph = np.ascontiguousarray(
        chunks[:, layout.off_ids:layout.off_ids + layout.R * 4]) \
        .view(np.int32).reshape(n, layout.R)
    if meta.get("relabeled"):
        # locality-relabeled index: undo the pack-time permutation so the
        # device tier works (and returns ids) in ORIGINAL label space
        old_to_new = np.load(os.path.join(path, "id_map.npy"))
        new_to_old = invert_permutation(old_to_new)
        vecs = vecs[old_to_new]
        codes = codes[old_to_new]
        g = graph[old_to_new]
        graph = np.where(g >= 0, new_to_old[np.where(g >= 0, g, 0)],
                         -1).astype(np.int32)
    idx, layout = from_arrays(vecs, graph, centroids, codes,
                              mode=meta["mode"],
                              block_bytes=meta["block_bytes"], device=dev)
    return idx, layout, meta["metric"]


# ---------------------------------------------------------------------------
# batched beam search (Algorithm 1 on the device)
# ---------------------------------------------------------------------------


def _mask_intra_dups(ids: torch.Tensor) -> torch.Tensor:
    """(nq, K) int -> bool mask of duplicate (non-first) occurrences."""
    order = torch.argsort(ids, dim=1, stable=True)
    srt = ids.gather(1, order)
    dup_sorted = torch.cat(
        [torch.zeros_like(srt[:, :1], dtype=torch.bool),
         srt[:, 1:] == srt[:, :-1]], dim=1)
    return torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)


def _smallest(d: torch.Tensor, k: int):
    """Values and positions of the k smallest per row; ties keep the lower
    position first, as `lax.top_k` of the negated values does."""
    vals, pos = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], pos[:, :k]


def _diskann_hop(index: DeviceIndex, fids: torch.Tensor, lut: torch.Tensor,
                 queries: torch.Tensor, layout: ChunkLayout, metric: str):
    """One hop of the DiskANN placement: exact distances and neighbour ids
    from the gathered chunk rows, neighbour ADC from the resident (N, m)
    code table (a gather and an in-order sum), +inf on invalid slots. The
    reference runs this outside any kernel, so it is plain torch here."""
    nq, w = fids.shape
    N, R = index.n, layout.R
    m, ks = lut.shape[1], lut.shape[2]
    exact, nids, _, _ = expand_rows_ref(index.chunk_words, fids, queries,
                                        layout, metric=metric)
    flat = nids.reshape(nq, w * R).long().clamp(0, N - 1)
    idx = index.pq_codes[flat].long() \
        + torch.arange(m, device=lut.device) * ks          # (nq, w*R, m)
    nd = sum_in_order(torch.gather(
        lut.reshape(nq, 1, m * ks).expand(nq, w * R, m * ks), 2, idx))
    nd = torch.where(nids >= 0, nd.reshape(nq, w, R), torch.inf)
    return exact, nids, nd


# hops that one CUDA graph replays between two reads of the loop's flag: a
# search reads the device ceil(hops / K) times and runs at most K - 1 hops
# in which no query is active (each leaves the state as it was)
HOPS_PER_SYNC = 8


def _pad_rows(nq: int) -> int:
    """Served batches come in every size up to the engine's max_batch; each
    is padded to the next power of two, so one graph serves a bucket."""
    return 1 << max(0, nq - 1).bit_length()


class _Search:
    """One batch's search state in fixed tensors, and the steps of the
    loop that write it in place: `prologue` (LUT, entry-point distances,
    state init), `hops(K)` (K hops, then the loop's flag and hop count into
    `status`). On the card both are captured once as CUDA graphs (see
    `_GraphedSearch`); on the CPU they run eagerly, the same code.

    Rows past `n_real` are padding: they start with no finite candidate,
    so they are never active, and their answers are dropped."""

    def __init__(self, index: DeviceIndex, nq: int, *, L: int, w: int,
                 max_hops: int, layout: ChunkLayout, metric: str,
                 backend: str, adc_dtype: str):
        dev = index.device
        self.index, self.layout, self.metric = index, layout, metric
        self.backend, self.adc_dtype = backend, adc_dtype
        self.L, self.w, self.max_hops = L, w, max_hops
        m, ks = index.centroids.shape[0], index.centroids.shape[1]
        self.eidx = (index.ep_codes.long()
                     + torch.arange(m, device=dev) * ks).reshape(-1)
        self.q = torch.zeros((nq, layout.dim), dtype=torch.float32,
                             device=dev)
        self.n_real = torch.zeros((), dtype=torch.int32, device=dev)
        self.lut = None
        self.cand_ids = torch.empty((nq, L), dtype=torch.int32, device=dev)
        self.cand_d = torch.empty((nq, L), dtype=torch.float32, device=dev)
        self.cand_exp = torch.empty((nq, L), dtype=torch.bool, device=dev)
        # visited set: one bit per node, 32 bits in each int64 word. Ids are
        # deduplicated before insertion, so each bit is added at most once
        # and scatter-add is a bitwise OR; two ids may share a word in one
        # hop, which a plain index_put would lose.
        self.inserted = torch.empty((nq, -(-index.n // 32)),
                                    dtype=torch.int64, device=dev)
        self.pool_ids = torch.empty((nq, L), dtype=torch.int32, device=dev)
        self.pool_d = torch.empty((nq, L), dtype=torch.float32, device=dev)
        self.hop_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.status = torch.zeros((2,), dtype=torch.int32, device=dev)

    def state(self) -> dict:
        return {f: getattr(self, f) for f in (
            "cand_ids", "cand_d", "cand_exp", "inserted", "pool_ids",
            "pool_d", "hop_count")}

    def load(self, queries: torch.Tensor) -> None:
        """The batch's queries into the first rows of the fixed buffer."""
        nq = queries.shape[0]
        self.q[:nq].copy_(queries)
        self.n_real.fill_(nq)

    def prologue(self) -> None:
        idx, nq = self.index, self.q.shape[0]
        self.lut = ops.build_lut(self.q, idx.centroids, metric=self.metric,
                                 backend=self.backend)
        m, ks = self.lut.shape[1], self.lut.shape[2]
        n_ep = idx.ep_ids.shape[0]
        ep_ids = idx.ep_ids[None, :].expand(nq, n_ep)
        ep_d = sum_in_order(self.lut.reshape(nq, m * ks)[:, self.eidx]
                            .reshape(nq, n_ep, m))
        real = torch.arange(nq, device=self.q.device) < self.n_real
        self.cand_ids.fill_(-1)
        self.cand_ids[:, :n_ep] = ep_ids
        self.cand_d.fill_(torch.inf)
        self.cand_d[:, :n_ep] = torch.where(real[:, None], ep_d, torch.inf)
        self.cand_exp.fill_(True)
        self.cand_exp[:, :n_ep] = False
        self.inserted.zero_()
        self.inserted.scatter_add_(1, (ep_ids >> 5).long(),
                                   torch.ones_like(ep_ids, dtype=torch.int64)
                                   << (ep_ids & 31).long())
        self.pool_ids.fill_(-1)
        self.pool_d.fill_(torch.inf)
        self.hop_count.zero_()

    def _active(self) -> torch.Tensor:
        """The reference's while_loop condition, on the device."""
        return (~self.cand_exp & torch.isfinite(self.cand_d)).any() \
            & (self.hop_count < self.max_hops)

    def hop(self) -> None:
        """One hop of every query, gated by `_active`: when it is false the
        frontier is all -1, so the hop emits +inf and -1, the stable sorts
        keep the pool and the candidate list as they were (the appended
        entries are +inf and sort after them) and no visited bit is added:
        the state stays bit-equal (tests/test_torch_search_loop.py)."""
        idx, layout, w, L = self.index, self.layout, self.w, self.L
        nq, N, R = self.q.shape[0], idx.n, layout.R
        active = self._active()
        cand_ids, cand_d, cand_exp = self.cand_ids, self.cand_d, self.cand_exp
        # 1. frontier: top-w unexpanded by PQ distance
        sel = torch.where(cand_exp, torch.inf, cand_d)
        fd, pos = _smallest(sel, w)
        fvalid = torch.isfinite(fd) & active
        fids = torch.where(fvalid, cand_ids.gather(1, pos), -1) \
            .to(torch.int32).contiguous()
        cand_exp = cand_exp.scatter(1, pos, cand_exp.gather(1, pos) | fvalid)
        # 2. expand: chunk gather + parse + exact dist + neighbour ADC
        if layout.mode == "aisaq":
            exact, nids, nd = ops.fused_hop(
                idx.chunk_words, fids, self.lut, self.q, layout=layout,
                metric=self.metric, backend=self.backend,
                adc_dtype=self.adc_dtype)
        else:
            exact, nids, nd = _diskann_hop(idx, fids, self.lut, self.q,
                                           layout, self.metric)
        # 3. rerank pool (exact distances of expanded nodes)
        pool_d, ppos = _smallest(torch.cat([self.pool_d, exact], 1), L)
        pool_ids = torch.cat([self.pool_ids, fids], 1).gather(1, ppos)
        # 4. neighbour insertion with dedup (packed-bitmask membership)
        nids_f = nids.reshape(nq, w * R)
        nd_f = nd.reshape(nq, w * R)
        safe = nids_f.clamp(0, N - 1).long()
        words = self.inserted.gather(1, safe >> 5)
        seen = ((words >> (safe & 31)) & 1).bool()
        bad = (nids_f < 0) | seen | _mask_intra_dups(nids_f)
        nd_f = torch.where(bad, torch.inf, nd_f)
        nids_f = torch.where(bad, -1, nids_f)
        safe = nids_f.clamp(0, N - 1).long()
        bits = torch.where(bad, 0, torch.ones_like(safe) << (safe & 31))
        self.inserted.scatter_add_(1, safe >> 5, bits)
        # 5. trim candidate list to L by PQ distance
        all_ids = torch.cat([cand_ids, nids_f], 1)
        all_exp = torch.cat([cand_exp, ~torch.isfinite(nd_f)], 1)
        new_d, cpos = _smallest(torch.cat([cand_d, nd_f], 1), L)
        self.cand_ids.copy_(all_ids.gather(1, cpos))
        self.cand_exp.copy_(all_exp.gather(1, cpos))
        self.cand_d.copy_(new_d)
        self.pool_ids.copy_(pool_ids)
        self.pool_d.copy_(pool_d)
        self.hop_count.add_(active.to(torch.int32))

    def hops(self, K: int) -> None:
        """K hops, then [any query still active, hops so far] into
        `status`: the one read of the device per K hops."""
        for _ in range(K):
            self.hop()
        torch.stack([self._active().to(torch.int32), self.hop_count],
                    out=self.status)

    def result(self, n: int, k: int):
        top_d, pos = _smallest(self.pool_d[:n], k)
        return self.pool_ids[:n].gather(1, pos), top_d


class _GraphedSearch:
    """A `_Search` whose prologue and K hops are CUDA graphs, captured at
    first use after one eager warm-up of both, and kept on the index
    (`DeviceIndex.graphs`). The prologue runs as its own graph before the
    hop graph; the final top-k runs eagerly after the loop. A lock holds
    the fixed buffers for one search at a time."""

    def __init__(self, search: _Search, K: int, queries: torch.Tensor):
        self.search = search
        self.lock = threading.Lock()
        search.load(queries)
        t0 = time.perf_counter()
        warm_up(search.prologue, lambda: search.hops(K))
        self.prologue = Graph(search.prologue)
        self.hops = Graph(lambda: search.hops(K), pool=self.prologue.pool)
        self.capture_s = time.perf_counter() - t0


_graphs_lock = threading.Lock()


def _loop(search: _Search, prologue, hops, k: int, n: int):
    """Run `prologue()` once, then `hops()` (K hops) with one read of
    `status` after each, until no query is active; the top k of the first
    n rows and the hop count."""
    prologue()
    while True:
        hops()
        more, n_hops = search.status.tolist()
        if not more:
            break
    ids, d = search.result(n, k)
    return ids, d, n_hops


def beam_search_device(index: DeviceIndex, queries: torch.Tensor, *, k: int,
                       L: int, w: int = 4, max_hops: int = 128,
                       layout: ChunkLayout, metric: str = "l2",
                       backend: str = "auto", adc_dtype: str = "f32",
                       hops_per_sync: int = HOPS_PER_SYNC,
                       cuda_graph: bool = True):
    """Batched DiskANN/AiSAQ beam search. Returns (topk_ids (nq, k) i32,
    topk_d (nq, k) f32, hops int): hops is the number of hops in which any
    query was active, as in the reference's `while_loop`.

    All queries hop together; finished queries pad their frontier with -1
    (the hop emits +inf for those lanes). In aisaq mode every hop is one
    `fused_hop`, and adc_dtype="int8" runs neighbour ADC through the int8
    hop; the pool's exact distances stay f32. In diskann mode neighbour
    codes come from the resident `index.pq_codes` table and ADC is always
    f32: adc_dtype is ignored there, as the reference ignores it.

    The loop's condition is computed on the device and read once every
    `hops_per_sync` hops (K); hops past the end change nothing. The batch
    is padded to a power of two. On the card the prologue and the K hops
    run as CUDA graphs, captured on first use for each (padded batch, L,
    w, max_hops, K, placement, adc_dtype, metric, backend, chunk table)
    and kept in `index.graphs`; `cuda_graph=False` launches the same steps
    eagerly (the yardstick of the graphs). On the CPU the steps always run
    eagerly.
    """
    if layout.mode == "diskann" and index.pq_codes is None:
        raise ValueError("diskann layout needs the resident pq_codes table")
    if not 0 < w <= L:
        raise ValueError(f"need 0 < w <= L, got w={w}, L={L}")
    if hops_per_sync < 1:
        raise ValueError(f"need hops_per_sync >= 1, got {hops_per_sync}")
    dev = index.device
    queries = queries.to(dev, torch.float32).contiguous()
    nq = queries.shape[0]
    K = hops_per_sync
    kw = dict(L=L, w=w, max_hops=max_hops, layout=layout, metric=metric,
              backend=backend, adc_dtype=adc_dtype)
    if dev.type != "cuda" or not cuda_graph:
        search = _Search(index, _pad_rows(nq), **kw)
        search.load(queries)
        return _loop(search, search.prologue, lambda: search.hops(K), k, nq)
    key = (_pad_rows(nq), L, w, max_hops, K, layout.mode, adc_dtype, metric,
           backend, index.chunk_words.data_ptr())
    with _graphs_lock:
        g = index.graphs.get(key)
        if g is None:
            g = _GraphedSearch(_Search(index, key[0], **kw), K, queries)
            index.graphs[key] = g
    with g.lock:
        g.search.load(queries)
        return _loop(g.search, g.prologue.replay, g.hops.replay, k, nq)
