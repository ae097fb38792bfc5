"""Device AiSAQ index: the chunk table in GPU memory + batched beam search.

Port of `repro.core.device_index`. The (N, device_stride/4) int32 chunk
table is the "storage tier"; in the AiSAQ placement the per-hop work
(chunk gather, parse, exact distance, inline-PQ ADC) is
`kernels.ops.fused_hop`, and the only per-query fast-tier state is the
(L,) candidate list, the (m, ks) LUT and the rerank pool. The DiskANN
placement (the paper's baseline) keeps every node's PQ code resident in
an (N, m) table and reads neighbour codes from it.

The reference runs its loop as a `lax.while_loop`; here the host drives
it with torch ops, one hop at a time, and reads one flag per hop to
decide whether any query still has an unexpanded candidate (one
device-to-host sync per hop).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chunk_layout import ChunkLayout, chunk_matrix, \
    pack_chunks_torch
from repro_torch.core.relabel import invert_permutation
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


def beam_search_device(index: DeviceIndex, queries: torch.Tensor, *, k: int,
                       L: int, w: int = 4, max_hops: int = 128,
                       layout: ChunkLayout, metric: str = "l2",
                       backend: str = "auto", adc_dtype: str = "f32"):
    """Batched DiskANN/AiSAQ beam search. Returns (topk_ids (nq, k) i32,
    topk_d (nq, k) f32, hops int).

    All queries hop together; finished queries pad their frontier with -1
    (the hop emits +inf for those lanes). In aisaq mode every hop is one
    `fused_hop`, and adc_dtype="int8" runs neighbour ADC through the int8
    hop; the pool's exact distances stay f32. In diskann mode neighbour
    codes come from the resident `index.pq_codes` table and ADC is always
    f32: adc_dtype is ignored there, as the reference ignores it.
    """
    if layout.mode == "diskann" and index.pq_codes is None:
        raise ValueError("diskann layout needs the resident pq_codes table")
    if not 0 < w <= L:
        raise ValueError(f"need 0 < w <= L, got w={w}, L={L}")
    dev = index.device
    queries = queries.to(dev, torch.float32).contiguous()
    nq = queries.shape[0]
    N, R = index.n, layout.R
    lut = ops.build_lut(queries, index.centroids, metric=metric,
                        backend=backend)
    m, ks = lut.shape[1], lut.shape[2]
    n_ep = index.ep_ids.shape[0]
    ep_ids = index.ep_ids[None, :].expand(nq, n_ep)
    eidx = (index.ep_codes.long() + torch.arange(m, device=dev) * ks) \
        .reshape(-1)
    ep_d = sum_in_order(lut.reshape(nq, m * ks)[:, eidx].reshape(nq, n_ep, m))
    pad = L - n_ep
    cand_ids = torch.cat(
        [ep_ids, torch.full((nq, pad), -1, dtype=torch.int32, device=dev)], 1)
    cand_d = torch.cat(
        [ep_d, torch.full((nq, pad), torch.inf, device=dev)], 1)
    cand_exp = torch.cat(
        [torch.zeros((nq, n_ep), dtype=torch.bool, device=dev),
         torch.ones((nq, pad), dtype=torch.bool, device=dev)], 1)
    # visited set: one bit per node, 32 bits in each int64 word. Ids are
    # deduplicated before insertion, so each bit is added at most once and
    # scatter-add is a bitwise OR; two ids may share a word in one hop,
    # which a plain index_put would lose.
    inserted = torch.zeros((nq, -(-N // 32)), dtype=torch.int64, device=dev)
    inserted.scatter_add_(1, (ep_ids >> 5).long(),
                          torch.ones_like(ep_ids, dtype=torch.int64)
                          << (ep_ids & 31).long())
    pool_ids = torch.full((nq, L), -1, dtype=torch.int32, device=dev)
    pool_d = torch.full((nq, L), torch.inf, device=dev)
    hops = 0
    while hops < max_hops:
        if not bool((~cand_exp & torch.isfinite(cand_d)).any()):
            break
        # 1. frontier: top-w unexpanded by PQ distance
        sel = torch.where(cand_exp, torch.inf, cand_d)
        fd, pos = _smallest(sel, w)
        fvalid = torch.isfinite(fd)
        fids = torch.where(fvalid, cand_ids.gather(1, pos), -1) \
            .to(torch.int32).contiguous()
        cand_exp = cand_exp.scatter(1, pos, cand_exp.gather(1, pos) | fvalid)
        # 2. expand: chunk gather + parse + exact dist + neighbour ADC
        if layout.mode == "aisaq":
            exact, nids, nd = ops.fused_hop(
                index.chunk_words, fids, lut, queries, layout=layout,
                metric=metric, backend=backend, adc_dtype=adc_dtype)
        else:
            exact, nids, nd = _diskann_hop(index, fids, lut, queries, layout,
                                           metric)
        # 3. rerank pool (exact distances of expanded nodes)
        pool_d, ppos = _smallest(torch.cat([pool_d, exact], 1), L)
        pool_ids = torch.cat([pool_ids, fids], 1).gather(1, ppos)
        # 4. neighbour insertion with dedup (packed-bitmask membership)
        nids_f = nids.reshape(nq, w * R)
        nd_f = nd.reshape(nq, w * R)
        safe = nids_f.clamp(0, N - 1).long()
        words = inserted.gather(1, safe >> 5)
        seen = ((words >> (safe & 31)) & 1).bool()
        bad = (nids_f < 0) | seen | _mask_intra_dups(nids_f)
        nd_f = torch.where(bad, torch.inf, nd_f)
        nids_f = torch.where(bad, -1, nids_f)
        safe = nids_f.clamp(0, N - 1).long()
        bits = torch.where(bad, 0, torch.ones_like(safe) << (safe & 31))
        inserted.scatter_add_(1, safe >> 5, bits)
        # 5. trim candidate list to L by PQ distance
        all_ids = torch.cat([cand_ids, nids_f], 1)
        all_exp = torch.cat([cand_exp, ~torch.isfinite(nd_f)], 1)
        cand_d, cpos = _smallest(torch.cat([cand_d, nd_f], 1), L)
        cand_ids = all_ids.gather(1, cpos)
        cand_exp = all_exp.gather(1, cpos)
        hops += 1
    top_d, pos = _smallest(pool_d, k)
    return pool_ids.gather(1, pos), top_d, hops
