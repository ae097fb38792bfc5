"""The beam-search traversal engine of the storage-backed index: frontier
selection, candidate bookkeeping, the exact-rerank tail and
``SearchStats`` (port of `repro.core.traversal`).

The host search core keeps the reference's three layers:

  ``core.adc``        LUT/ADC numerics, on the search's device
  ``core.traversal``  THIS module — the engine that walks the graph
  ``core.index_io``   on-disk format + ``HostIndex`` lifecycle (fd, cache,
                      residency accounting); delegates search to here

The engine functions are duck-typed over a ``HostIndex``-like object: they
use ``host.layout``, ``host.meta``, ``host.device``, ``host.centroids_t``,
``host.ep_codes``, ``host.mode`` / ``host.pq_codes`` (a tensor on the
device), ``host.nav``, ``host.cache``, ``host._read_chunk`` and
``host._frontier_offsets``, and return ids in STORAGE space — the caller
(``HostIndex``) maps them back to original labels.

Where the work runs
-------------------

As in the reference, storage, I/O and the candidate bookkeeping (the fresh
mask, the visited bitset, which grows with N, the stable sorts, the trim
to L and the prefetch plan) stay on the host: the host needs the next
frontier to issue its reads in any case. The arithmetic goes to the card
(`_DeviceHop`), which holds only per-query state: the queries, their LUTs,
one hop's staged rows and the rerank vectors — nothing that grows with N.
Each hop, in aisaq mode, the P chunks just read are packed into a staging
table of ``device_stride``-byte rows at the ``dev_off_*`` offsets (one
pinned buffer, reused across hops; one host-to-device copy with the hop's
index arrays), the fused hop kernel (`kernels.chunk_adc.fused_hop`) gives
each row's exact distance and its neighbours' ADC from the inline codes,
and both come back in one copy. The int8 ADC (one scale per query and
subspace, the host recipe) is a torch gather of the int8 LUT against the
staged rows' codes; the kernel then gives the exact distances only.
DiskANN mode gathers the codes from the (N, m) table on the device and
scores the frontier's vectors with the gathered `kernels.rerank.rerank`,
as does the exact rerank tier for its unexpanded candidates.

Pipelined traversal — the two-hop in-flight invariant
-----------------------------------------------------

With ``pipeline=True`` (the default whenever ``prefetch > 0``) the loop
keeps TWO hops in flight:

  1. the moment hop *t*'s frontier is SELECTED, the engine issues an async
     prefetch for the PREDICTED hop *t+1* frontier — the next ``prefetch``
     best unexpanded candidates of the current list;
  2. hop *t*'s demand fetch then runs (waiting only on blocks not already
     resident or in flight), and hop *t*'s scoring + bookkeeping run while
     the background thread reads hop *t+1*'s predicted blocks;
  3. after insertion/re-sort, the EXACT next frontier is known; a
     catch-up prefetch covers any block the prediction missed.

Mis-predicted blocks are ordinary speculative residents, accounted
(``prefetch_wasted``) and, because the block cache is exact, unable to
change a result. The batched path stays bit-identical to the scalar oracle
`search_ref`: both run each piece of arithmetic through the same
row-independent functions (`_DeviceHop` with a batch of one in the
oracle). If the background thread stalls or dies, the demand fetch falls
back to direct reads after a bounded wait: same results, no deadlock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import nav as _nav
from repro_torch.core.adc import adc_gather, build_lut_batch, host_lut_int8
from repro_torch.core.chunk_layout import B_NUM, parse_chunk
from repro_torch.kernels.chunk_adc import fused_hop
from repro_torch.kernels.ref import INV127
from repro_torch.kernels.rerank import rerank as rerank_kernel
from repro_torch.obs import trace as obs_trace

#: consecutive hops with failed background reads before search_batch
#: auto-disables its pipelined/prefetch path for the rest of the search —
#: a sick device should see the serial demand path (whose own RetryPolicy
#: still applies), not a speculative read storm.
DEGRADE_AFTER_FAILED_HOPS = 3

#: alignment of each array packed into one staging upload (bytes)
_STAGE_ALIGN = 16


@dataclass
class SearchStats:
    hops: int = 0
    ios: int = 0            # logical chunk reads (cache hit or miss)
    bytes_read: int = 0     # bytes actually pulled from storage
    pq_dists: int = 0
    latency_s: float = 0.0
    syscalls: int = 0       # batched preadv calls issued for this query
    cache_hits: int = 0
    cache_misses: int = 0
    # speculative next-hop prefetch accounting (whole-batch deltas, folded
    # into the batch's lead query like syscall attribution)
    prefetch_issued: int = 0    # blocks landed by the background thread
    prefetch_hits: int = 0      # prefetched blocks a demand fetch consumed
    prefetch_wasted: int = 0    # prefetched blocks dropped unused
    rerank_ios: int = 0     # chunk reads issued by the exact rerank tier
    # pipeline overlap accounting (whole-batch totals on the lead query):
    # blocked_wait_s is time the traversal thread spent INSIDE demand
    # fetches (syscalls + waiting on in-flight background reads);
    # compute_s is everything else in the hop loop (staging, the device's
    # arithmetic and its copies, bookkeeping).
    blocked_wait_s: float = 0.0
    compute_s: float = 0.0
    pipelined: int = 0      # 1 when the two-hop in-flight path was active
    # graceful degradation (whole-batch flag on the lead query): 1 when
    # DEGRADE_AFTER_FAILED_HOPS consecutive hops saw background-read
    # failures and the engine fell back to the serial demand path
    degraded: int = 0
    # entry seeding: entry_dist is the best seed's ADC distance; with
    # entry="nav", nav_hops/nav_dists count the in-RAM pivot beam's hops
    # and ADC evaluations (zero storage I/O) and nav_s is the beam's wall
    # time (whole-batch total on the lead query)
    entry_dist: float = 0.0
    nav_hops: int = 0
    nav_dists: int = 0
    nav_s: float = 0.0
    # the hop (1-based) at which the LAST member of the returned top-k
    # entered the search: expansion hop for the traversal-pool tier,
    # candidate-insertion hop for the rerank/PQ tiers; 0 when the result
    # came entirely from the entry seeds.
    convergence_hop: int = 0


# ---------------------------------------------------------------------------
# the device's half of a search
# ---------------------------------------------------------------------------


class _Stage:
    """Host arrays packed into one buffer and sent to the device in one
    copy. On the card the buffer is pinned and reused across the hops of
    a search (it grows when a hop needs more); on the CPU the packed
    arrays are used in place."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.buf = torch.empty(0, dtype=torch.uint8)
        self.parts: List[Tuple[int, np.ndarray]] = []
        self.used = 0

    def add(self, arr: np.ndarray) -> None:
        """Queue arr for the next `upload`."""
        arr = np.ascontiguousarray(arr)
        off = -(-self.used // _STAGE_ALIGN) * _STAGE_ALIGN
        self.parts.append((off, arr))
        self.used = off + arr.nbytes

    def upload(self) -> List[torch.Tensor]:
        """One copy of every queued array to the device; returns them as
        tensors there, in the order queued, and empties the queue."""
        if self.buf.numel() < self.used:
            self.buf = torch.empty(max(self.used, 2 * self.buf.numel()),
                                   dtype=torch.uint8,
                                   pin_memory=self.dev.type == "cuda")
        host = self.buf.numpy()
        for off, arr in self.parts:
            host[off:off + arr.nbytes] = arr.view(np.uint8).reshape(-1)
        if self.dev.type == "cuda":
            blob = torch.empty(self.used, dtype=torch.uint8, device=self.dev)
            blob.copy_(self.buf[:self.used], non_blocking=True)
        else:
            blob = self.buf[:self.used]
        out = []
        for off, arr in self.parts:
            t = blob[off:off + arr.nbytes].view(_TORCH_DTYPE[arr.dtype])
            out.append(t.reshape(arr.shape))
        self.parts, self.used = [], 0
        return out


_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.float32): torch.float32}


def _vectors(chunk: np.ndarray, lay) -> np.ndarray:
    """(P, chunk_bytes) u8 chunks -> (P, dim) f32 vectors."""
    if lay.data_dtype == "uint8":
        return chunk[:, :lay.b_full].astype(np.float32)
    return np.ascontiguousarray(chunk[:, :lay.b_full]) \
        .view(np.float32).reshape(chunk.shape[0], -1)


class _DeviceHop:
    """Per-search state on the search's device — the queries (nq, d), their
    f32 LUTs (nq, m, ks) and, for int8, the quantized LUTs and their
    (nq, m) dequant factors — and each hop's arithmetic on the rows the
    host read. Every result row depends on its own inputs only."""

    def __init__(self, host, Q: np.ndarray, adc_dtype: str):
        if adc_dtype not in ("f32", "int8"):
            raise ValueError(f"adc_dtype must be 'f32' or 'int8', "
                             f"got {adc_dtype!r}")
        self.dev = host.device
        self.lay = host.layout
        self.mode = host.mode
        self.metric = host.meta["metric"]
        self.pq_codes = host.pq_codes
        self.stage = _Stage(self.dev)
        self.Q = torch.from_numpy(np.array(Q, np.float32)).to(self.dev)
        self.lut = build_lut_batch(host.centroids_t, self.Q, self.metric)
        if adc_dtype == "int8":
            self.lut_g, scale = host_lut_int8(self.lut)
            self.dq = scale * float(INV127)
        else:
            self.lut_g, self.dq = self.lut, None

    @property
    def nq(self) -> int:
        return self.Q.shape[0]

    def adc(self, qidx: np.ndarray, codes: np.ndarray) -> np.ndarray:
        """ADC of codes (F, m) u8 for queries qidx (F,): (F,) f32."""
        qi, cd = self._upload(qidx.astype(np.int64), codes)
        return adc_gather(self.lut_g, self.dq, qi, cd).cpu().numpy()

    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        for a in arrays:
            self.stage.add(a)
        return self.stage.upload()

    def expand(self, chunk: np.ndarray, qf: np.ndarray, frank: np.ndarray,
               w: int, f_q: np.ndarray, f_slot: np.ndarray,
               f_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One hop's arithmetic. chunk (P, chunk_bytes) u8 holds the
        frontier rows, row i belonging to query qf[i] at beam slot
        frank[i] < w. The fresh neighbours are (f_q, f_slot, f_ids): their
        query, their slot in the flattened (P, R) neighbour lists and their
        id. Returns (exact (P,) f32 query-row distances, f_d (F,) f32 ADC
        distances of the fresh neighbours)."""
        lay, nq = self.lay, self.nq
        P, R = chunk.shape[0], lay.R
        if self.mode == "aisaq":
            rows = np.zeros((P, lay.device_stride), np.uint8)
            rows[:, :lay.b_full] = chunk[:, :lay.b_full]
            tail = lay.chunk_bytes - lay.off_deg
            rows[:, lay.dev_off_deg:lay.dev_off_deg + tail] = \
                chunk[:, lay.off_deg:]
            fids = np.full((nq, w), -1, np.int32)
            fids[qf, frank] = np.arange(P, dtype=np.int32)
            # fresh slot p*R + r -> its place in the kernel's (nq, w, R)
            # f32 output; in int8, the row of its codes in the staging
            p = f_slot // R
            f_at = f_slot if self.dq is not None else \
                (qf[p] * w + frank[p]) * R + f_slot % R
            rows_t, fids_t, fq_t, fat_t = self._upload(
                rows, fids, f_q.astype(np.int64), f_at.astype(np.int64))
            exact, _, nbr_d = fused_hop(rows_t.view(torch.int32), fids_t,
                                        self.lut, self.Q, layout=lay,
                                        metric=self.metric)
            if self.dq is None:
                f_d = nbr_d.reshape(-1)[fat_t]
            else:
                o = lay.dev_off_pq
                codes = rows_t[:, o:o + R * lay.pq_m] \
                    .reshape(P * R, lay.pq_m)[fat_t]
                f_d = adc_gather(self.lut_g, self.dq, fq_t, codes)
        else:
            cand = np.zeros((nq, w, lay.dim), np.float32)
            cand[qf, frank] = _vectors(chunk, lay)
            cand_t, fq_t, fi_t = self._upload(
                cand, f_q.astype(np.int64), f_ids.astype(np.int64))
            exact = rerank_kernel(self.Q, cand_t, metric=self.metric)
            f_d = adc_gather(self.lut_g, self.dq, fq_t,
                             self.pq_codes[fi_t])
        out = torch.cat([exact.reshape(-1), f_d]).cpu().numpy()
        return out[:nq * w].reshape(nq, w)[qf, frank], out[nq * w:]

    def rerank(self, nqi: np.ndarray, vf: np.ndarray) -> np.ndarray:
        """Exact distances of candidate vectors vf (P, d) f32 for queries
        nqi (P,) (non-decreasing): the candidates go to the device as one
        (nq, c, d) tensor, c the most any query has, and the gathered
        rerank kernel scores them. Returns (P,) f32."""
        rank = _group_rank(nqi)
        cand = np.zeros((self.nq, int(rank.max()) + 1, vf.shape[1]),
                        np.float32)
        cand[nqi, rank] = vf
        cand_t, = self._upload(cand)
        d = rerank_kernel(self.Q, cand_t, metric=self.metric)
        return d.cpu().numpy()[nqi, rank]


def _seeds(host, dh: _DeviceHop, entry: str, w: int):
    """The search's entry seeds, shared by the oracle and the batched path.
    Returns (mode, seed_ids (nq, s) -1 padded, seed_d (nq, s) +inf padded,
    nav_hops, nav_dists, nav_s); the nav counters are None in medoid mode,
    whose fixed pack-time seeds every query shares."""
    mode = _nav.resolve_entry(host, entry)
    if mode == "nav":
        t_nav = time.perf_counter()
        sid, sd, nh, nd = _nav.nav_seed_batch(host.nav, dh.lut_g, dh.dq, w)
        return mode, sid, sd, nh, nd, time.perf_counter() - t_nav
    eps = np.asarray(host.meta["entry_points"], dtype=np.int64)
    nq, e = dh.nq, eps.size
    d = dh.adc(np.repeat(np.arange(nq), e), np.tile(host.ep_codes, (nq, 1)))
    return mode, np.tile(eps, (nq, 1)), d.reshape(nq, e), None, None, 0.0


# ---------------------------------------------------------------------------
# scalar reference (paper Algorithm 1) — the semantics oracle
# ---------------------------------------------------------------------------


def search_ref(host, q: np.ndarray, k: int, L: int, w: int = 4, *,
               adc_dtype: str = "f32", rerank: Optional[int] = None,
               entry: str = "auto"
               ) -> Tuple[np.ndarray, SearchStats]:
    """Scalar DiskANN beam search, one pread per node expansion.  Kept as
    the semantics oracle for the vectorized hot path — `search_batch` must
    return bit-identical ids (per adc_dtype, per entry mode).  Its
    arithmetic runs through the same `_DeviceHop` as the batched path,
    with a batch of one query and one row; nav seeds come from the SAME
    `core.nav.nav_seed_batch` call.  Returns STORAGE-space ids."""
    t0 = time.perf_counter()
    q = np.asarray(q, dtype=np.float32)
    stats = SearchStats()
    lay = host.layout
    n = int(host.meta["n"])       # snapshot: ids >= n are clamped below
    dh = _DeviceHop(host, q[None], adc_dtype)
    entry_mode, sid, sd, nh, nd, nav_s = _seeds(host, dh, entry, w)
    svalid = sid[0] >= 0
    eps = sid[0][svalid]
    cand_ids = eps.copy()
    cand_d = sd[0][svalid]
    if entry_mode == "nav":
        stats.nav_s = nav_s
        stats.nav_hops = int(nh[0])
        stats.nav_dists = int(nd[0])
    else:
        stats.pq_dists += len(eps)
    stats.entry_dist = float(cand_d.min()) if cand_d.size else 0.0
    expanded: Dict[int, float] = {}                      # id -> exact dist
    exp_hop: Dict[int, int] = {}                         # id -> hop expanded
    ins_hop = {int(e): 0 for e in eps}                   # id -> hop inserted
    inserted = set(int(e) for e in eps)
    zero = np.zeros(1, np.int64)
    while True:
        order = np.argsort(cand_d, kind="stable")[:L]
        cand_ids, cand_d = cand_ids[order], cand_d[order]
        frontier = [int(i) for i in cand_ids if int(i) not in expanded][:w]
        if not frontier:
            break
        stats.hops += 1
        new_ids: List[np.ndarray] = []
        new_d: List[np.ndarray] = []
        for p in frontier:
            raw = host._read_chunk(p, stats)
            _, ids, _ = parse_chunk(raw, lay)
            # clamp to the n snapshot exactly like the -1 padding
            valid = (ids >= 0) & (ids < n)
            slots = np.flatnonzero(valid)
            ids = ids[valid]
            fresh = np.array([i for i in ids if int(i) not in inserted],
                             dtype=np.int64)
            f_slot = np.array([slots[int(np.flatnonzero(ids == f)[0])]
                               for f in fresh], dtype=np.int64)
            ex, d = dh.expand(raw[None], zero, zero, 1,
                              np.zeros(fresh.size, np.int64), f_slot, fresh)
            expanded[p] = float(ex[0])
            exp_hop[p] = stats.hops
            if fresh.size == 0:
                continue
            stats.pq_dists += int(fresh.size)
            inserted.update(int(f) for f in fresh)
            for f in fresh:
                ins_hop[int(f)] = stats.hops
            new_ids.append(fresh)
            new_d.append(d)
        if new_ids:
            cand_ids = np.concatenate([cand_ids] + new_ids)
            cand_d = np.concatenate([cand_d] + new_d)
    if rerank is None:
        # re-rank by full-precision distances collected along the path
        vids = np.array(list(expanded.keys()), dtype=np.int64)
        vd = np.array(list(expanded.values()), dtype=np.float32)
        topk = vids[np.argsort(vd, kind="stable")[:k]]
        if topk.size:
            stats.convergence_hop = max(exp_hop[int(t)] for t in topk)
    else:
        topk = _rerank_tail_ref(host, dh, k, rerank, cand_ids, expanded,
                                stats)
        if topk.size:
            stats.convergence_hop = max(ins_hop[int(t)] for t in topk)
    stats.latency_s = time.perf_counter() - t0
    return topk, stats


def _rerank_tail_ref(host, dh: _DeviceHop, k: int, rerank: int,
                     cand_ids: np.ndarray, expanded: Dict[int, float],
                     stats: SearchStats) -> np.ndarray:
    """Scalar oracle of the exact rerank tier: rescore the final
    (PQ-sorted) candidate list with full-precision vectors. Expanded
    candidates reuse the exact distance computed during traversal;
    unexpanded ones cost one chunk read each (accounted as
    ``rerank_ios``) and are scored together by `_DeviceHop.rerank`.
    ``rerank == 0`` returns the PQ-only ranking."""
    limit = max(int(rerank), k) if rerank else k
    sel = cand_ids[:limit]
    if not rerank:                   # PQ-only tier: no rescoring
        return sel[:k].copy()
    d = np.empty(sel.size, np.float32)
    need: List[int] = []
    vecs: List[np.ndarray] = []
    for j, p in enumerate(int(x) for x in sel):
        if p in expanded:
            d[j] = expanded[p]
            continue
        raw = host._read_chunk(p, stats)
        stats.rerank_ios += 1
        need.append(j)
        vecs.append(_vectors(raw[None], host.layout)[0])
    if need:
        d[need] = dh.rerank(np.zeros(len(need), np.int64), np.stack(vecs))
    return sel[np.argsort(d, kind="stable")[:k]]


def search_batch_ref(host, Q: np.ndarray, k: int, L: int, w: int = 4, *,
                     adc_dtype: str = "f32", rerank: Optional[int] = None,
                     entry: str = "auto"):
    """Scalar reference loop (the seed implementation's search_batch).
    Returns STORAGE-space ids."""
    ids = np.zeros((Q.shape[0], k), dtype=np.int64)
    stats = []
    for i in range(Q.shape[0]):
        ids[i], s = search_ref(host, Q[i], k, L, w, adc_dtype=adc_dtype,
                               rerank=rerank, entry=entry)
        stats.append(s)
    return ids, stats


# ---------------------------------------------------------------------------
# vectorized batched engine (the hot path; optionally pipelined)
# ---------------------------------------------------------------------------


def _slice_chunks(blocks: np.ndarray, inner: np.ndarray,
                  chunk_bytes: int) -> np.ndarray:
    """(P, chunk_bytes) chunks out of their (P, io_bytes) blocks: `inner`
    takes only nodes_per_block distinct values, so per-slot basic slicing
    beats a fancy-index gather."""
    chunk = np.empty((blocks.shape[0], chunk_bytes), np.uint8)
    for s in np.unique(inner):
        rows = inner == s
        chunk[rows] = blocks[rows, s:s + chunk_bytes]
    return chunk


def search_batch(host, Q: np.ndarray, k: int, L: int, w: int = 4, *,
                 prefetch: int = 0, adc_dtype: str = "f32",
                 rerank: Optional[int] = None,
                 pipeline: Optional[bool] = None,
                 gap: Optional[Union[int, str]] = None,
                 entry: str = "auto"):
    """Batched vectorized beam search over all queries at once.

    All queries hop together: each hop gathers the union of every active
    query's frontier blocks in ONE cache fetch, stages the chunks for the
    device, and scores every frontier row and every fresh neighbour of
    every query in one device step (`_DeviceHop.expand`).  Returns (ids
    (nq, k) in STORAGE space, [SearchStats]).

    ``prefetch=p`` (p > 0) speculatively queues, per query and hop, the
    blocks of its p best unexpanded candidates for background reading.
    ``pipeline`` (None = auto: on iff prefetch > 0) additionally issues
    the PREDICTED next frontier the moment this hop's frontier is
    selected (the two-hop in-flight discipline, module docstring).
    Results are unaffected in every mode (the cache is exact).  ``gap``
    controls miss-run readahead coalescing (None = prefetch depth; an int
    fixes it; "auto" lets the cache pick from its observed demand-miss
    run-length histogram).

    ``adc_dtype="int8"`` runs neighbor ADC through the quantized LUT (one
    scale per query and subspace, `core.adc.host_lut_int8`); exact
    distances stay f32.

    ``entry`` selects how the on-disk search is seeded: "medoid" (the
    fixed pack-time ``meta["entry_points"]``), "nav" (per-query entry
    vertices from the in-RAM navigation tier, ValueError without one) or
    "auto" (default: "nav" iff the index carries the tier).

    ``rerank`` selects the result tier, bit-identical to `search_ref`:
    None (default) ranks the nodes expanded during traversal by their
    exact distances; 0 is PQ-only (the final candidate list by ADC
    distance); r > 0 rescores the top-max(r, k) candidates of the final
    list exactly — expanded ones reuse the distance their hop gave them,
    unexpanded ones are fetched in one batched read (``rerank_ios``) and
    scored on the device as one (nq, c, d) batch.  The list holds at most
    L entries, so the depth is min(r, L).
    """
    t0 = time.perf_counter()
    Q = np.asarray(Q, dtype=np.float32)
    nq = Q.shape[0]
    lay = host.layout
    n = int(host.meta["n"])
    cache = host.cache
    if pipeline is None:
        pipeline = prefetch > 0
    pipeline = bool(pipeline) and prefetch > 0 and cache is not None
    gap_eff: Union[int, str] = prefetch if gap is None else gap
    blocked_s = 0.0
    compute_s = 0.0
    dh = _DeviceHop(host, Q, adc_dtype)
    pf0 = None
    if cache is not None:
        c = cache.counters
        pf0 = (c.prefetch_issued, c.prefetch_hits, c.prefetch_wasted)
    # tracing state resolved ONCE: the disabled hot path pays one
    # thread-local read here and a single `is None` branch per hop
    _tracing = obs_trace.current_span() is not None
    pf_err_last = cache.counters.prefetch_errors if cache is not None else 0
    pf_fail_hops = 0
    degraded = False
    was_pipelined = pipeline            # report the mode the search BEGAN in
    entry_mode, seed_ids, seed_d, nav_hops_a, nav_dists_a, nav_s = \
        _seeds(host, dh, entry, w)
    # per-query counters (numpy-resident; folded into SearchStats at end)
    hops_a = np.zeros(nq, np.int64)
    ios_a = np.zeros(nq, np.int64)
    bytes_a = np.zeros(nq, np.int64)
    pq_a = np.zeros(nq, np.int64)
    sys_a = np.zeros(nq, np.int64)
    hit_a = np.zeros(nq, np.int64)
    miss_a = np.zeros(nq, np.int64)
    rr_a = np.zeros(nq, np.int64)
    # candidate lists (sorted by PQ distance, stable; inf-padded to L);
    # -1 / inf seed padding starts expanded so it is never selected
    bits = np.zeros((nq, -(-n // 64)), np.uint64)  # visited uint64 bitset
    n_ep = seed_ids.shape[1]
    width = max(L, n_ep)
    cand_ids = np.full((nq, width), -1, np.int64)
    cand_d = np.full((nq, width), np.inf, np.float32)
    cand_exp = np.ones((nq, width), bool)
    svalid = seed_ids >= 0
    cand_ids[:, :n_ep] = seed_ids
    cand_d[:, :n_ep] = seed_d
    cand_exp[:, :n_ep] = ~svalid
    rows, vcols = np.nonzero(svalid)
    sid_v = seed_ids[rows, vcols]
    np.bitwise_or.at(bits, (rows, sid_v >> 6),
                     np.uint64(1) << (sid_v & 63).astype(np.uint64))
    if entry_mode != "nav":
        pq_a += n_ep
    # candidate-insertion hop (1-based; seeds are hop 0) — feeds
    # convergence_hop for the rerank/PQ result tiers
    cand_hop = np.zeros((nq, width), np.int32)
    order = np.argsort(cand_d, axis=1, kind="stable")[:, :L]
    cand_ids = np.take_along_axis(cand_ids, order, 1)
    cand_d = np.take_along_axis(cand_d, order, 1)
    cand_exp = np.take_along_axis(cand_exp, order, 1)
    cand_hop = np.take_along_axis(cand_hop, order, 1)
    entry_d0 = cand_d[:, 0].copy()     # best seed per query (entry_dist)
    conv_a = np.zeros(nq, np.int64)
    hop_no = 0
    pool_ids_cols: List[np.ndarray] = []
    pool_d_cols: List[np.ndarray] = []

    def _issue_prefetch(depth: int, exclude: Optional[np.ndarray] = None):
        """Queue the top `depth` unexpanded candidates per query for
        background reading (resident / already-queued blocks skipped).
        `exclude` drops blocks the CURRENT hop is about to demand-fetch,
        so its fast inline read never turns into a wait on the background
        thread."""
        psel = ~cand_exp & np.isfinite(cand_d)
        pn = cand_ids[psel & (np.cumsum(psel, axis=1) <= depth)]
        if not pn.size:
            return
        offs = host._frontier_offsets(pn)[0]
        if exclude is not None:
            offs = np.setdiff1d(offs, exclude)
        if offs.size:
            cache.prefetch_async(offs, gap=gap_eff)

    def _account(qidx: np.ndarray, blk_off: np.ndarray,
                 hit_mask: np.ndarray, n_sys: int):
        """Attribute unique-block hits/misses/bytes to the first query that
        asked for each block (hit_mask is in first-appearance order), and
        the fetch's syscalls to its lead query."""
        uq = qidx[np.sort(np.unique(blk_off, return_index=True)[1])]
        np.add.at(hit_a, uq[hit_mask], 1)
        np.add.at(miss_a, uq[~hit_mask], 1)
        np.add.at(bytes_a, uq[~hit_mask], lay.io_bytes)
        sys_a[qidx[0]] += n_sys

    while True:
        t_hop = time.perf_counter()
        # 1. frontier = first w unexpanded candidates per query
        sel = ~cand_exp & np.isfinite(cand_d)
        fmask = sel & (np.cumsum(sel, axis=1) <= w)
        if not fmask.any():
            break
        qf, cols = np.nonzero(fmask)       # row-major: grouped by query
        cand_exp |= fmask
        nf = cand_ids[qf, cols]
        hop_no += 1
        np.add.at(hops_a, np.unique(qf), 1)
        np.add.at(ios_a, qf, 1)
        # 1b. PIPELINE: the predicted hop-(t+1) frontier goes to the
        # background thread NOW, before this hop's fetch and scoring
        blk_off, inner = host._frontier_offsets(nf)
        hop_sp = obs_trace.begin("traversal.hop", frontier=int(nf.size)) \
            if _tracing else None
        if pipeline:
            _issue_prefetch(prefetch, exclude=blk_off)
        # 2. ONE batched fetch for every frontier chunk this hop
        t_f = time.perf_counter()
        if hop_sp is None:
            blocks, hit_mask, n_sys = cache.fetch(blk_off, gap=gap_eff)
        else:
            with obs_trace.activate(hop_sp):
                blocks, hit_mask, n_sys = cache.fetch(blk_off, gap=gap_eff)
        blocked_s += time.perf_counter() - t_f
        _account(qf, blk_off, hit_mask, n_sys)
        P = nf.size
        chunk = _slice_chunks(blocks, inner, lay.chunk_bytes)
        nbr = np.ascontiguousarray(
            chunk[:, lay.off_ids:lay.off_ids + lay.R * B_NUM]) \
            .view(np.int32).reshape(P, lay.R).astype(np.int64)
        # 3. fresh neighbors: valid, unvisited, first occurrence per query
        q_rep = np.repeat(qf, lay.R)
        ids_f = nbr.reshape(-1)
        # ids >= n clamp mirrors search_ref
        valid = (ids_f >= 0) & (ids_f < n)
        safe = np.where(valid, ids_f, 0)
        seen = (bits[q_rep, safe >> 6] >>
                (safe & 63).astype(np.uint64)) & np.uint64(1)
        first_occ = np.zeros(ids_f.size, bool)
        key = np.where(valid, q_rep * n + safe,
                       nq * n + np.arange(ids_f.size))
        first_occ[np.unique(key, return_index=True)[1]] = True
        fresh = valid & (seen == 0) & first_occ
        f_slot = np.flatnonzero(fresh)
        f_q = q_rep[f_slot]
        f_ids = ids_f[f_slot]
        # 4. the device step: exact distances of the frontier rows and the
        # ADC of the fresh neighbours (in aisaq mode from the codes of the
        # chunks just read — no N-sized table is touched)
        frank = _group_rank(qf)
        exact, f_d = dh.expand(chunk, qf, frank, w, f_q, f_slot, f_ids)
        np.add.at(pq_a, f_q, 1)
        np.bitwise_or.at(bits, (f_q, f_ids >> 6),
                         np.uint64(1) << (f_ids & 63).astype(np.uint64))
        # 5. insert fresh neighbors, re-sort, trim to L
        counts = np.bincount(f_q, minlength=nq)
        K = int(counts.max()) if counts.size else 0
        if K:
            nrank = _group_rank(f_q)
            new_ids = np.full((nq, K), -1, np.int64)
            new_d = np.full((nq, K), np.inf, np.float32)
            new_ids[f_q, nrank] = f_ids
            new_d[f_q, nrank] = f_d
            all_ids = np.concatenate([cand_ids, new_ids], axis=1)
            all_d = np.concatenate([cand_d, new_d], axis=1)
            all_exp = np.concatenate(
                [cand_exp, ~np.isfinite(new_d)], axis=1)
            all_hop = np.concatenate(
                [cand_hop, np.full((nq, K), hop_no, np.int32)], axis=1)
            order = np.argsort(all_d, axis=1, kind="stable")[:, :L]
            cand_ids = np.take_along_axis(all_ids, order, 1)
            cand_d = np.take_along_axis(all_d, order, 1)
            cand_exp = np.take_along_axis(all_exp, order, 1)
            cand_hop = np.take_along_axis(all_hop, order, 1)
        # 6. async next-hop prefetch: the list the NEXT hop selects from is
        # final here (under the pipeline, the catch-up issue)
        if prefetch > 0:
            _issue_prefetch(prefetch)
        # 6b. graceful degradation: several consecutive hops whose
        # background reads FAILED turn the prefetch path off for the rest
        # of this search (observable via SearchStats.degraded)
        if (prefetch > 0 or pipeline) and cache is not None:
            cur = cache.counters.prefetch_errors
            if cur > pf_err_last:
                pf_fail_hops += 1
                if pf_fail_hops >= DEGRADE_AFTER_FAILED_HOPS:
                    degraded = True
                    prefetch = 0
                    pipeline = False
            else:
                pf_fail_hops = 0
            pf_err_last = cur
        # 7. pool the exact distances of expanded nodes (re-rank pool)
        pcol_i = np.full((nq, w), -1, np.int64)
        pcol_d = np.full((nq, w), np.inf, np.float32)
        pcol_i[qf, frank] = nf
        pcol_d[qf, frank] = exact
        pool_ids_cols.append(pcol_i)
        pool_d_cols.append(pcol_d)
        compute_s += time.perf_counter() - t_hop
        if hop_sp is not None:
            hop_sp.annotate(syscalls=int(n_sys),
                            misses=int((~hit_mask).sum()),
                            fresh=int(f_ids.size))
            hop_sp.end()
    # the hop loop's compute_s included the fetch waits; carve them out
    compute_s = max(0.0, compute_s - blocked_s)
    out = np.full((nq, k), -1, np.int64)
    if rerank is not None:
        # -- exact rerank tier over the FINAL candidate list ------------
        r_eff = max(int(rerank), k) if rerank else 0
        exp_map: List[Dict[int, float]] = [{} for _ in range(nq)]
        if r_eff and pool_ids_cols:
            pool_ids = np.concatenate(pool_ids_cols, axis=1)
            pool_d = np.concatenate(pool_d_cols, axis=1)
            for i in range(nq):
                vmask = pool_ids[i] >= 0
                exp_map[i] = dict(zip(pool_ids[i][vmask].tolist(),
                                      pool_d[i][vmask].tolist()))
        sel_ids: List[np.ndarray] = []
        sel_d: List[Optional[np.ndarray]] = []
        sel_hops: List[np.ndarray] = []
        need_pairs: List[Tuple[int, int]] = []
        need_nodes: List[int] = []
        for i in range(nq):
            vmask = (cand_ids[i] >= 0) & np.isfinite(cand_d[i])
            sel = cand_ids[i][vmask][:max(r_eff, k)]
            sel_ids.append(sel)
            sel_hops.append(cand_hop[i][vmask][:max(r_eff, k)])
            if not r_eff:            # PQ-only tier: keep ADC ranking
                sel_d.append(None)
                continue
            d = np.full(sel.size, np.inf, np.float32)
            for j, p in enumerate(sel.tolist()):
                e = exp_map[i].get(p)
                if e is None:
                    need_pairs.append((i, j))
                    need_nodes.append(p)
                else:
                    d[j] = e
            sel_d.append(d)
        if need_nodes:
            # one batched cache fetch for every unexpanded candidate
            nodes = np.asarray(need_nodes, dtype=np.int64)
            nqi = np.asarray([pr[0] for pr in need_pairs], dtype=np.int64)
            blk_off, inner = host._frontier_offsets(nodes)
            rr_sp = obs_trace.begin("traversal.rerank",
                                    nodes=int(nodes.size)) \
                if _tracing else None
            t_f = time.perf_counter()
            if rr_sp is None:
                blocks, hit_mask, n_sys = cache.fetch(blk_off)
            else:
                with obs_trace.activate(rr_sp):
                    blocks, hit_mask, n_sys = cache.fetch(blk_off)
                rr_sp.end()
            blocked_s += time.perf_counter() - t_f
            _account(nqi, blk_off, hit_mask, n_sys)
            np.add.at(ios_a, nqi, 1)
            np.add.at(rr_a, nqi, 1)
            vf = _vectors(_slice_chunks(blocks, inner, lay.chunk_bytes), lay)
            ex = dh.rerank(nqi, vf)
            for (i, j), e in zip(need_pairs, ex):
                sel_d[i][j] = e
        for i in range(nq):
            if r_eff:
                oi = np.argsort(sel_d[i], kind="stable")[:k]
            else:
                oi = np.arange(min(k, sel_ids[i].size))
            top = sel_ids[i][oi]
            out[i, :top.size] = top
            if top.size:
                conv_a[i] = int(sel_hops[i][oi].max())
    elif pool_ids_cols:
        # re-rank over every expanded node, in expansion order
        # (stable ties) — the traversal-pool tier
        pool_ids = np.concatenate(pool_ids_cols, axis=1)
        pool_d = np.concatenate(pool_d_cols, axis=1)
        for i in range(nq):
            vmask = pool_ids[i] >= 0
            vids, vd = pool_ids[i][vmask], pool_d[i][vmask]
            oi = np.argsort(vd, kind="stable")[:k]
            top = vids[oi]
            out[i, :top.size] = top
            if top.size:
                # pool column c was appended on loop iteration c // w,
                # and a query's active iterations are exactly its first
                # `hops` — so this matches the oracle's expansion hop
                conv_a[i] = int(np.flatnonzero(vmask)[oi].max() // w) + 1
    wall = time.perf_counter() - t0
    stats = []
    for i in range(nq):
        stats.append(SearchStats(
            hops=int(hops_a[i]), ios=int(ios_a[i]),
            bytes_read=int(bytes_a[i]), pq_dists=int(pq_a[i]),
            latency_s=wall / nq, syscalls=int(sys_a[i]),
            cache_hits=int(hit_a[i]), cache_misses=int(miss_a[i]),
            rerank_ios=int(rr_a[i]),
            convergence_hop=int(conv_a[i]),
            entry_dist=float(entry_d0[i]),
            nav_hops=int(nav_hops_a[i]) if nav_hops_a is not None else 0,
            nav_dists=int(nav_dists_a[i])
            if nav_dists_a is not None else 0))
    if pf0 is not None:
        # whole-batch prefetch deltas, attributed to the lead query
        c = cache.counters
        stats[0].prefetch_issued = c.prefetch_issued - pf0[0]
        stats[0].prefetch_hits = c.prefetch_hits - pf0[1]
        stats[0].prefetch_wasted = c.prefetch_wasted - pf0[2]
    # whole-batch overlap accounting, attributed to the lead query
    stats[0].blocked_wait_s = blocked_s
    stats[0].compute_s = compute_s
    stats[0].pipelined = int(was_pipelined)
    stats[0].degraded = int(degraded)
    stats[0].nav_s = nav_s
    # SearchStats -> histograms: a pool-attached handle publishes hop /
    # I/O / blocked-vs-compute DISTRIBUTIONS per corpus (obs.metrics
    # SearchMetrics); bare HostIndex loads skip this with one getattr
    sm = getattr(host, "metrics", None)
    if sm is not None:
        sm.observe_batch(stats, wall, blocked_s, compute_s)
    return out, stats


def _group_rank(group_ids: np.ndarray) -> np.ndarray:
    """Rank within consecutive groups: [3,3,5,5,5,7] -> [0,1,0,1,2,0].
    `group_ids` must be non-decreasing (row-major np.nonzero guarantees it).
    """
    if group_ids.size == 0:
        return group_ids
    starts = np.flatnonzero(
        np.concatenate([[True], group_ids[1:] != group_ids[:-1]]))
    return np.arange(group_ids.size) - np.repeat(
        starts, np.diff(np.concatenate([starts, [group_ids.size]])))


def recall_at(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """k-recall@k over a batch: |pred_k ∩ gt_k| / k averaged (vectorized)."""
    p, g = ids[:, :k], gt[:, :k]
    srt = np.sort(p, axis=1)
    if k > 1 and (srt[:, 1:] == srt[:, :-1]).any():
        # duplicate predictions: fall back to exact set semantics
        hits = sum(len(set(map(int, rp)) & set(map(int, rg)))
                   for rp, rg in zip(p, g))
        return hits / (ids.shape[0] * k)
    hits = (p[:, :, None] == g[:, None, :]).any(axis=2).sum()
    return float(hits) / (ids.shape[0] * k)
