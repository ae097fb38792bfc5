"""Multi-process sharded ANN search — the paper's Fig. 5 multi-server system
(port of `repro.core.sharded_search`, on `torch.distributed` where the
reference uses `shard_map`).

Each rank owns one dataset shard with its OWN sub-index (subgraph + entry
point), like the paper's per-server indices. A query fans out to every
shard, each rank runs the local AiSAQ beam search (`beam_search_device`),
and the local top-k lists merge by an all-gather and a global top-k.

Process grid (the reference's mesh): `launch.mesh.ProcessGrid`, the
world's ranks as a ("data", "model") grid, row-major (re-exported here).
  query batch  -> ("data",)   (paper: request load-balancer)
  index shards -> ("model",)  (paper: servers on the ethernet/Lustre tier)
`query_axes=()` replicates the queries over the grid ("mode B", the index
sharded over every axis).

The collective backend is the caller's: `init_process_group("gloo")` for
CPU tensors and for several ranks sharing one card, `"nccl"` where each
rank has its own card (NCCL refuses two ranks on one GPU). Gloo moves
host tensors, so with CUDA tensors the (B, k) results are copied to the
host for the all-gather and back (`launch.mesh.all_gather`); each rank's
search runs on its device.

The merge is the reference's: the gathered (S, B, k) lists laid out shard
by shard, (B, S*k), and a stable ascending sort of the distances, first k
(`lax.top_k` of the negated distances: ties go to the lower position,
which is not always the lower id). The process-level storage tier's
`merge_topk` (dist, then id) is a different merge; it is re-exported
below, with the shard assignment, as the reference re-exports it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.chunk_layout import ChunkLayout, pack_chunks_torch
from repro_torch.core.device_index import _smallest, beam_search_device, \
    from_numpy
from repro_torch.core.shard_math import (     # noqa: F401  (re-exported)
    ShardAssignment, contiguous_shards, merge_topk)
from repro_torch.device import DeviceLike, resolve_device, to_tensor
from repro_torch.launch.mesh import ProcessGrid, all_gather  # noqa: F401


class ShardedIndexArrays(NamedTuple):
    """Stacked per-shard index arrays; leading dim = shard."""

    chunk_words: torch.Tensor    # (S_h, N_s, W) int32
    centroids: torch.Tensor      # (m, ks, dsub) f32 — replicated
    ep_ids: torch.Tensor         # (S_h, n_ep) int32 (shard-local ids)
    ep_codes: torch.Tensor       # (S_h, n_ep, m) int32
    offsets: torch.Tensor        # (S_h,) int32 global-id offset per shard


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stack_shards(shards: Sequence[Tuple[int, object, object]], centroids,
                 codes_full, layout: ChunkLayout, *,
                 device: DeviceLike = None) -> ShardedIndexArrays:
    """shards: list of (global_offset, shard_vectors, shard_graph), as
    `vamana.build_sharded` returns them; codes_full: the (N, m) codes of
    the whole corpus, indexed by global id. Each shard's chunk table is
    packed on `device` by `pack_chunks_torch`; ragged shards are padded
    with zero rows that no edge reaches. The entry point is the vector
    nearest the shard's mean, computed on the host as the reference
    computes it (numpy float32, the first of `argsort`)."""
    dev = resolve_device(device)
    n_max = max(v.shape[0] for _, v, _ in shards)
    words, eps, epc, offs = [], [], [], []
    for off, vecs, graph in shards:
        n = vecs.shape[0]
        codes = codes_full[off:off + n]
        w = pack_chunks_torch(to_tensor(vecs, dev), to_tensor(graph, dev),
                              to_tensor(codes, dev), layout)
        if n < n_max:  # pad ragged shards with unreachable nodes
            w = torch.cat([w, w.new_zeros((n_max - n, w.shape[1]))])
        words.append(w)
        v = _host(vecs).astype(np.float32)
        mean = v.mean(axis=0)
        dd = ((v - mean) ** 2).sum(axis=1)
        ep = np.argsort(dd)[:1].astype(np.int32)
        eps.append(ep)
        epc.append(_host(codes)[ep].astype(np.int32))
        offs.append(off)
    return ShardedIndexArrays(
        chunk_words=words[0][None] if len(words) == 1 else torch.stack(words),
        centroids=to_tensor(centroids, dev, torch.float32),
        ep_ids=torch.from_numpy(np.stack(eps)).to(dev),
        ep_codes=torch.from_numpy(np.stack(epc)).to(dev),
        offsets=torch.tensor(offs, dtype=torch.int32, device=dev))


def merge_shards(all_ids: torch.Tensor, all_d: torch.Tensor, k: int):
    """The device tier's merge: (S, B, k') ids and distances, shard by
    shard, -> the (B, k) ids and distances of the k smallest distances of
    the (B, S*k') shard-major list; ties keep the lower position (the
    reference's `lax.top_k(-all_d, k)`), so a tie between shards goes to
    the lower shard and one within a shard to its earlier entry."""
    S, B, kk = all_ids.shape
    ids = all_ids.permute(1, 0, 2).reshape(B, S * kk)
    d = all_d.permute(1, 0, 2).reshape(B, S * kk)
    vals, pos = _smallest(d, k)
    return ids.gather(1, pos), vals


def sharded_search_fn(grid: ProcessGrid, *, k: int, L: int, w: int,
                      max_hops: int, layout: ChunkLayout, metric: str,
                      backend: str = "auto",
                      query_axes: Tuple[str, ...] = ("data",),
                      shard_axes: Tuple[str, ...] = ("model",),
                      query_chunk: int = 0, adc_dtype: str = "f32"
                      ) -> Callable:
    """Returns fn(arrays: ShardedIndexArrays, queries) -> (ids (B_l, k)
    int32, d (B_l, k) f32) on every rank of `grid`.

    `arrays` is this rank's own shard (leading dim 1) and `queries` the
    (B_l, d) rows of its query block over `query_axes` (empty: replicated,
    "mode B"), both placed by `input_sharding`; the answer is for the same
    rows, like the reference's output block on this device. The index
    shards over `shard_axes`: the rank at block s of those axes owns shard
    s, and the ranks that share its other coordinates gather their lists.

    query_chunk > 0 searches the queries in chunks of that many (the
    reference's `lax.map`), bounding the per-query visited bitmaps.
    Collective: every rank makes the fn with the same arguments (the
    first call for some `shard_axes` creates the process groups) and
    calls it together. The rank's `DeviceIndex` is made from `arrays`
    once (its CUDA graphs live on it) and made again only when another
    chunk table comes in.
    """
    query_axes = _norm_axes(query_axes)
    shard_axes = _norm_axes(shard_axes)
    group, members = grid.group(shard_axes)
    held = {}

    def local_index(arrays: ShardedIndexArrays):
        if arrays.chunk_words.shape[0] != 1:
            raise ValueError("sharded search takes this rank's own shard "
                             "(input_sharding), got "
                             f"{arrays.chunk_words.shape[0]} shards")
        key = arrays.chunk_words.data_ptr()
        if held.get("key") != key:
            held.update(key=key, index=from_numpy(
                arrays.chunk_words[0], arrays.centroids, arrays.ep_ids[0],
                arrays.ep_codes[0], device=arrays.chunk_words.device))
        return held["index"]

    def search(arrays: ShardedIndexArrays, queries: torch.Tensor):
        idx = local_index(arrays)
        kw = dict(k=k, L=L, w=w, max_hops=max_hops, layout=layout,
                  metric=metric, backend=backend, adc_dtype=adc_dtype)
        nq = queries.shape[0]
        if query_chunk and nq > query_chunk:
            parts = [beam_search_device(idx, qc, **kw)[:2]
                     for qc in queries.split(query_chunk)]
            ids = torch.cat([p[0] for p in parts])
            d = torch.cat([p[1] for p in parts])
        else:
            ids, d, _ = beam_search_device(idx, queries, **kw)
        valid = ids >= 0
        gids = torch.where(valid, ids + arrays.offsets[0], -1).to(torch.int32)
        d = torch.where(valid, d, torch.inf)
        # merge across shards: (S, B_l, k) -> top-k per query
        return merge_shards(all_gather(gids, group, members),
                            all_gather(d, group, members), k)

    return search


def _norm_axes(axes) -> Tuple[str, ...]:
    """Drop None placeholders: (None,) means 'replicated', as in the
    reference."""
    return tuple(a for a in (axes or ()) if a is not None)


def input_sharding(grid: ProcessGrid, query_axes=("data",),
                   shard_axes=("model",), *, device: DeviceLike = None):
    """The counterpart of the reference's NamedShardings: (place_arrays,
    place_queries), the functions that put this rank's inputs on `device`.
    place_arrays(arrays) keeps the rank's shard (block `grid.index(
    shard_axes)` of every stacked field; the centroids whole), or takes an
    arrays of one shard as the rank's own; place_queries(q) keeps the rows
    of the rank's block over `query_axes` (all rows when empty)."""
    query_axes = _norm_axes(query_axes)
    shard_axes = _norm_axes(shard_axes)
    dev = resolve_device(device)

    def place_arrays(arrays: ShardedIndexArrays) -> ShardedIndexArrays:
        S = arrays.chunk_words.shape[0]
        n_shards = grid.size(shard_axes)
        if S not in (1, n_shards):
            raise ValueError(f"{S} shards for {n_shards} blocks of "
                             f"{shard_axes}")
        s = grid.index(shard_axes) if S > 1 else 0
        return ShardedIndexArrays(
            chunk_words=to_tensor(arrays.chunk_words[s:s + 1], dev),
            centroids=to_tensor(arrays.centroids, dev, torch.float32),
            ep_ids=to_tensor(arrays.ep_ids[s:s + 1], dev),
            ep_codes=to_tensor(arrays.ep_codes[s:s + 1], dev),
            offsets=to_tensor(arrays.offsets[s:s + 1], dev))

    def place_queries(queries) -> torch.Tensor:
        q = to_tensor(queries, dev, torch.float32)
        nb = grid.size(query_axes)
        if q.shape[0] % nb:
            raise ValueError(f"{q.shape[0]} queries do not split into {nb} "
                             f"blocks of {query_axes}")
        rows = q.shape[0] // nb
        b = grid.index(query_axes)
        return q[b * rows:(b + 1) * rows]

    return place_arrays, place_queries
