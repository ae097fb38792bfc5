"""Batched query serving over the device search (port of the device half
of `repro.serving.engine` plus a copy of its `Request` / `ServingEngine`).

The engine batches per corpus, switches indices, and runs the search
backend; `hedge=2` issues each batch to two replicas and takes the first
SUCCESSFUL completion, accounting the losers' work in `hedge_stats`.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.device_index import DeviceIndex, beam_search_device
from repro_torch.core.chunk_layout import ChunkLayout
from repro_torch.device import DeviceLike, resolve_device, to_tensor
from repro_torch.kernels import ops
from repro_torch.kernels.ref import unpack_u8


def make_device_search_fn(index: DeviceIndex, layout: ChunkLayout, *,
                          metric: str = "l2", L: int = 48, w: int = 4,
                          max_hops: int = 128, backend: str = "auto",
                          adc_dtype: str = "f32", rerank: int = 0,
                          device: DeviceLike = None):
    """Wrap the device beam search into the `(queries, k) -> ids` callable
    `ServingEngine` consumes. `adc_dtype="int8"` serves through the int8
    fused hop.

    `rerank=r` (r > 0) adds the exact rerank tier: beam search returns its
    top-max(r, k) pool, their full-precision vectors are gathered from the
    chunk table, and `kernels.rerank` rescores every query's candidates in
    one launch per batch before the final top-k.

    The index must live on `device` (default: the card).
    """
    if index.device.type != resolve_device(device).type:
        raise ValueError(f"index lives on {index.device}, not "
                         f"{resolve_device(device)}")
    dev = index.device
    vec_words = layout.padded_vec_bytes // 4

    def _gather_vecs(ids: torch.Tensor) -> torch.Tensor:
        """Candidate vectors read out of the chunk rows on demand: only
        nq*r rows per call, never an (N, d) resident copy of the corpus."""
        rows = index.chunk_words.index_select(0, ids.reshape(-1).long())
        vw = rows[:, :vec_words]
        if layout.data_dtype == "uint8":
            return unpack_u8(vw)[:, :layout.dim].float()
        return vw[:, :layout.dim].contiguous().view(torch.float32)

    def search(queries: np.ndarray, k: int) -> np.ndarray:
        q = to_tensor(queries, dev, torch.float32)
        if not rerank:
            ids, _, _ = beam_search_device(
                index, q, k=k, L=max(L, k), w=w, max_hops=max_hops,
                layout=layout, metric=metric, backend=backend,
                adc_dtype=adc_dtype)
            return ids.cpu().numpy()
        r = max(int(rerank), k)
        ids, _, _ = beam_search_device(
            index, q, k=r, L=max(L, r), w=w, max_hops=max_hops,
            layout=layout, metric=metric, backend=backend,
            adc_dtype=adc_dtype)
        nq = ids.shape[0]
        cand = _gather_vecs(ids.clamp(0, index.n - 1)).reshape(nq, r, -1)
        d = ops.rerank(q, cand, metric=metric, backend=backend)   # (nq, r)
        d = torch.where(ids >= 0, d, torch.inf)
        top = torch.argsort(d, dim=1, stable=True)[:, :k]
        return ids.gather(1, top).cpu().numpy()

    return search


@dataclass
class Request:
    query: np.ndarray
    corpus: str = "default"
    k: int = 10
    t_submit: float = field(default_factory=time.perf_counter)
    result: Optional[np.ndarray] = None
    t_done: float = 0.0
    event: threading.Event = field(default_factory=threading.Event)
    error: Optional[Exception] = None    # set instead of result on failure

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


class ServingEngine:
    """search_fns: corpus -> fn(queries (B,d), k) -> ids (B,k).

    Multiple entries in `replicas` enable hedging; `switch_fn(corpus)` is
    called when the batch's corpus differs from the active one (the paper's
    index-switch path)."""

    def __init__(self, search_fns: Dict[str, Callable], *,
                 max_batch: int = 32, max_wait_ms: float = 2.0,
                 hedge: int = 1, replicas: Optional[List[Callable]] = None,
                 switch_fn: Optional[Callable[[str], float]] = None):
        self.search_fns = search_fns
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.hedge = hedge
        self.replicas = replicas
        self.switch_fn = switch_fn
        self.q: "queue.Queue[Request]" = queue.Queue()
        self._held: "deque[Request]" = deque()   # other-corpus holdover
        self.metrics: List[float] = []
        self.switch_times: List[float] = []
        # hedge accounting: wasted = replicas that ran but lost the race,
        # failed = replicas that raised (the winner is the first SUCCESS)
        self.hedge_stats: Dict[str, int] = dict(batches=0, wasted=0, failed=0)
        self._hedge_lock = threading.Lock()
        # guards the _stop flag vs stop()'s queue drain: a submit racing a
        # concurrent stop() must either raise or have its request drained
        self._submit_lock = threading.Lock()
        self._active_corpus: Optional[str] = None
        self._stop = False
        self._pool = ThreadPoolExecutor(max_workers=max(2, hedge * 2))
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    # -- client API ----------------------------------------------------------
    def submit(self, query: np.ndarray, corpus: str = "default", k: int = 10
               ) -> Request:
        with self._submit_lock:
            if self._stop:
                raise RuntimeError("engine stopped")
            r = Request(query=query, corpus=corpus, k=k)
            self.q.put(r)
            return r

    def submit_wait(self, query, corpus="default", k=10, timeout=30.0):
        r = self.submit(query, corpus, k)
        r.event.wait(timeout)
        return r

    # -- engine loop ----------------------------------------------------------
    def _collect_batch(self) -> List[Request]:
        """Corpus-pure batch with FIFO-preserving holdover: a request for a
        DIFFERENT corpus encountered while collecting is parked in `_held`
        (never re-queued to the back of the FIFO, which would reorder it
        behind later arrivals and starve it under sustained foreign load);
        the next batch starts from the holdover before touching the
        queue."""
        if self._held:
            first = self._held.popleft()
        else:
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                return []
        batch = [first]
        # same-corpus requests already held keep their relative order
        for r in list(self._held):
            if len(batch) >= self.max_batch:
                break
            if r.corpus == first.corpus:
                try:
                    self._held.remove(r)
                except ValueError:
                    continue             # a concurrent stop() drained it
                batch.append(r)
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.max_batch:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                r = self.q.get(timeout=left)
            except queue.Empty:
                break
            if r.corpus != first.corpus:      # keep batches corpus-pure
                self._held.append(r)          # served at the NEXT batch head
                continue
            batch.append(r)
        return batch

    def _run_search(self, fn, queries, k):
        return fn(queries, k)

    def _count_hedge_loser(self, fut):
        """done-callback for replicas that lost the race: work that ran to
        completion for nothing is wasted; cancelled-before-running is
        free."""
        with self._hedge_lock:
            if fut.cancelled():
                return
            if fut.exception() is not None:
                self.hedge_stats["failed"] += 1
            else:
                self.hedge_stats["wasted"] += 1

    def _run_hedged(self, queries, k):
        """First SUCCESSFUL replica wins. `Future.cancel()` cannot stop an
        already-running thread, so losing replicas are accounted (wasted /
        failed) via done-callbacks rather than assumed dead."""
        futs = [self._pool.submit(self._run_search, rep, queries, k)
                for rep in self.replicas[:self.hedge]]
        with self._hedge_lock:
            self.hedge_stats["batches"] += 1
        pending = set(futs)
        ids = err = None
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                e = f.exception()
                if e is None and ids is None:
                    ids = f.result()
                else:
                    with self._hedge_lock:
                        if e is not None:
                            self.hedge_stats["failed"] += 1
                        else:
                            self.hedge_stats["wasted"] += 1
                    err = e if e is not None else err
            if ids is not None:
                break
        for p in pending:                 # losers still in flight
            p.cancel()
            p.add_done_callback(self._count_hedge_loser)
        if ids is None:                   # every replica failed
            raise err if err is not None else RuntimeError("hedge failed")
        return ids

    def _loop(self):
        try:
            self._loop_inner()
        finally:
            # the loop thread drains its own leftovers on exit: requests
            # it moved into _held after stop()'s drain ran would hang
            self._drain(RuntimeError("engine stopped"))

    def _loop_inner(self):
        while not self._stop:
            batch = self._collect_batch()
            if not batch:
                continue
            if self._stop:               # stopped mid-collect: fail the
                self._held.extend(batch)  # batch via the exit drain
                break
            corpus = batch[0].corpus
            err = None
            try:
                if self.switch_fn is not None \
                        and corpus != self._active_corpus:
                    self.switch_times.append(self.switch_fn(corpus))
                    self._active_corpus = corpus
                queries = np.stack([r.query for r in batch])
                k = max(r.k for r in batch)
                fn = self.search_fns[corpus]
                if self.hedge > 1 and self.replicas:
                    ids = self._run_hedged(queries, k)
                else:
                    ids = fn(queries, k)
                ids = np.asarray(ids)     # malformed returns fail the batch
                if ids.ndim != 2 or ids.shape[0] != len(batch):
                    raise ValueError(
                        f"search fn returned shape {ids.shape}, expected "
                        f"({len(batch)}, k)")
            except Exception as e:        # noqa: BLE001 — fail the batch,
                err = e                   # never kill the engine thread
            now = time.perf_counter()
            for i, r in enumerate(batch):
                r.t_done = now
                if err is not None:
                    r.error = err
                else:
                    r.result = ids[i, :r.k]
                    self.metrics.append(r.latency_s)
                r.event.set()

    def _drain(self, err: Exception):
        """Fail every request still parked in the holdover deque or the
        queue.  Safe to run from both the loop thread (on exit) and
        stop(): deque/queue pops are atomic, each request drains once."""
        leftovers = []
        while self._held:
            try:
                leftovers.append(self._held.popleft())
            except IndexError:
                break
        while True:
            try:
                leftovers.append(self.q.get_nowait())
            except queue.Empty:
                break
        for r in leftovers:
            r.error = err
            r.event.set()

    # -- stats ----------------------------------------------------------------
    def latency_percentiles(self):
        if not self.metrics:
            return {}
        a = np.array(self.metrics)
        return {"p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "p99_ms": float(np.percentile(a, 99) * 1e3),
                "n": len(a)}

    def stop(self):
        with self._submit_lock:
            self._stop = True
        self._t.join(timeout=2.0)
        self._pool.shutdown(wait=False)
        # fail whatever never made it into a batch (queue + holdover) so
        # submit_wait callers see an error instead of a silent timeout;
        # under _submit_lock no new request can slip in behind the drain.
        # The loop thread ALSO drains on its own exit, covering requests
        # it re-parks after this drain when join() timed out mid-collect.
        with self._submit_lock:
            self._drain(RuntimeError("engine stopped"))
