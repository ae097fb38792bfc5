"""Multi-tenant retrieval service: per-corpus queues + worker scheduling
(port of `repro.serving.service`, over the port's `WarmIndexPool`).

The worker threads share the pool's device: each batch's search is
`HostIndex.search_batch`, whose per-search state (queries, LUTs, the
pinned staging buffer of `core.traversal._DeviceHop`) belongs to that
search alone, and whose shared pieces (the block cache, the kernels'
launch counters) take their own locks.

`ServingEngine` (serving.engine) serializes every corpus through one FIFO
and one loop thread, so two tenants ping-ponging corpora destroy each
other's throughput.  This service is the scheduling layer the paper's
many-warm-corpora claim needs:

  * one queue PER corpus — a burst on one tenant can never reorder or
    starve another tenant's requests (each corpus stays strictly FIFO),
  * N workers pick corpora round-robin among the non-empty queues; a
    corpus is served by at most one worker at a time (per-corpus batches
    stay FIFO) while DIFFERENT corpora serve concurrently,
  * indices come from a `WarmIndexPool` lease — pinned for the duration of
    the batch so eviction can never close an index mid-search, and the
    pool-miss load time is recorded as that corpus's switch cost,
  * admission control: a queue deeper than `max_queue_depth` rejects the
    submit with `BackpressureError` (bounded memory, bounded tail) and
    counts it,
  * per-corpus telemetry — completed / rejected / batches / switches /
    latency percentiles / QPS — exported as one `stats()` dict.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import (COUNT_BUCKETS, MetricsRegistry,
                                     merged_quantile)
from repro_torch.serving.engine import Request, make_host_search_fn
from repro_torch.serving.pool import CorpusUnhealthyError, WarmIndexPool

__all__ = ["BackpressureError", "CorpusUnhealthyError",
           "ServiceClosedError", "RetrievalService"]


class BackpressureError(RuntimeError):
    """Raised by `submit` when a corpus queue is at max_queue_depth."""

    def __init__(self, corpus: str, depth: int, limit: int):
        super().__init__(
            f"corpus {corpus!r} queue at admission limit "
            f"({depth}/{limit}); retry later")
        self.corpus = corpus
        self.depth = depth
        self.limit = limit


class ServiceClosedError(RuntimeError):
    """The service is shutting down: raised by `submit` once `close()`
    (or `stop()`) has begun, and set on requests still queued when the
    drain deadline passes.  A RuntimeError subclass so callers that
    guarded the old untyped `RuntimeError("service stopped")` keep
    working; cluster workers map it to a clean per-request error frame
    instead of a dropped connection."""


class _CorpusTelemetry:
    """Per-corpus series handles into the service's MetricsRegistry.

    The registry is the single source of truth (bounded memory by
    construction: fixed-bucket histograms, no per-request state);
    `stats()` renders the legacy dict shape as a thin view over these
    handles, and percentiles are bucket-derived instead of sampled from
    a latency ring."""

    __slots__ = ("completed", "rejected", "errors", "expired",
                 "unhealthy_rejected", "batches", "latency", "batch_size",
                 "switch", "queue_depth", "first_submit", "last_done")

    def __init__(self, reg: MetricsRegistry, corpus: str):
        lbl = {"corpus": corpus}
        def outcome(o):
            return reg.counter("service_requests_total",
                               {**lbl, "outcome": o},
                               help="request outcomes per corpus")
        self.completed = outcome("completed")
        self.rejected = outcome("rejected")            # backpressure
        self.errors = outcome("error")
        self.expired = outcome("expired")              # deadline at assembly
        self.unhealthy_rejected = outcome("unhealthy")  # breaker fail-fast
        self.batches = reg.counter("service_batches_total", lbl,
                                   help="batches served per corpus")
        self.latency = reg.histogram(
            "service_latency_seconds", lbl,
            help="submit-to-done request latency", unit="seconds")
        self.batch_size = reg.histogram(
            "service_batch_size", lbl, buckets=COUNT_BUCKETS,
            help="requests per served batch")
        self.switch = reg.histogram(
            "service_switch_seconds", lbl,
            help="pool-miss index load (switch) cost", unit="seconds")
        self.queue_depth = reg.gauge("service_queue_depth", lbl,
                                     help="queued requests at snapshot")
        self.first_submit: Optional[float] = None
        self.last_done: Optional[float] = None


class RetrievalService:
    """search_fn(index, queries (B, d), k) -> ids (B, k); the default runs
    `HostIndex.search_batch` with this service's L/w/rerank/adc knobs."""

    def __init__(self, pool: WarmIndexPool, *, num_workers: int = 2,
                 max_batch: int = 16, max_wait_ms: float = 2.0,
                 max_queue_depth: int = 256, L: int = 48, w: int = 4,
                 rerank: Optional[int] = None, adc_dtype: str = "f32",
                 prefetch: int = 0, pipeline: Optional[bool] = None,
                 gap=None, entry: str = "auto",
                 search_fn: Optional[Callable] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.pool = pool
        # share the pool's registry by default so one snapshot carries
        # the whole process (service + pool + per-corpus search/cache)
        self.registry = registry or getattr(pool, "registry", None) \
            or MetricsRegistry()
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.max_queue_depth = max_queue_depth
        self.L, self.w = L, w
        self.rerank = rerank
        self.adc_dtype = adc_dtype
        self.prefetch = prefetch
        # pipeline=None: auto — two-hop in-flight traversal whenever
        # prefetch > 0 (core.traversal); gap=None: readahead follows the
        # prefetch depth, "auto" tunes it from the miss histogram
        self.pipeline = pipeline
        self.gap = gap
        # entry="auto": per-query nav entry vertices whenever the served
        # index carries a navigation tier, fixed medoid otherwise —
        # mixed pools (nav and nav-less corpora) serve correctly
        self.entry = entry
        self._search_fn = search_fn or self._default_search
        self._cond = threading.Condition()
        self._queues: Dict[str, deque] = {}
        self._busy: set = set()
        self._rr: List[str] = []         # round-robin corpus order
        self._rr_next = 0
        self._tel: Dict[str, _CorpusTelemetry] = {}
        self._stop = False
        self._closing = False    # close() begun: reject new, drain queued
        self._t0 = time.perf_counter()
        self._workers = [
            threading.Thread(target=self._worker, name=f"retrieval-w{i}",
                             daemon=True)
            for i in range(max(1, num_workers))]
        for t in self._workers:
            t.start()

    # -- client API ----------------------------------------------------------
    def _default_search(self, index, queries: np.ndarray, k: int
                        ) -> np.ndarray:
        # delegate to the factory so the beam-width-covers-rerank-depth
        # rule lives in exactly one place (engine.make_host_search_fn)
        return make_host_search_fn(
            index, L=self.L, w=self.w, prefetch=self.prefetch,
            adc_dtype=self.adc_dtype, rerank=self.rerank,
            pipeline=self.pipeline, gap=self.gap,
            entry=self.entry)(queries, k)

    def submit(self, query: np.ndarray, corpus: str = "default", k: int = 10,
               deadline_s: Optional[float] = None,
               span: Optional[object] = None) -> Request:
        """Queue one request.  `deadline_s` (seconds from now) attaches a
        drop-dead time: a worker assembling a batch skips the request once
        it has passed (TimeoutError on the request, `expired` telemetry)
        instead of serving it into the void.  `span` (obs.trace.Span)
        ties the request to a query trace: the serving batch, traversal
        hops, and cache reads parent onto it.  Raises
        CorpusUnhealthyError when the corpus is quarantined (fail fast)
        and BackpressureError at the admission depth."""
        self.pool._resolve(corpus)       # one source of the naming KeyError
        r = Request(query=query, corpus=corpus, k=k, span=span)
        if deadline_s is not None:
            r.deadline = r.t_submit + float(deadline_s)
        with self._cond:
            if self._stop or self._closing:
                raise ServiceClosedError("service stopped")
            q = self._queues.get(corpus)
            if q is None:
                q = self._queues[corpus] = deque()
                self._rr.append(corpus)
                self._tel[corpus] = _CorpusTelemetry(self.registry, corpus)
            tel = self._tel[corpus]
            try:
                self.pool.admit(corpus)  # circuit breaker: fail fast
            except CorpusUnhealthyError:
                tel.unhealthy_rejected.inc()
                raise
            if len(q) >= self.max_queue_depth:
                tel.rejected.inc()
                raise BackpressureError(corpus, len(q), self.max_queue_depth)
            if tel.first_submit is None:
                tel.first_submit = r.t_submit
            q.append(r)
            self._cond.notify()
        return r

    def submit_wait(self, query, corpus: str = "default", k: int = 10,
                    timeout: float = 30.0) -> Request:
        # the wait timeout doubles as the request deadline: if the caller
        # gives up, no worker should burn a search slot on the orphan
        r = self.submit(query, corpus, k, deadline_s=timeout)
        if not r.event.wait(timeout):
            raise TimeoutError(
                f"request to corpus {corpus!r} not served in {timeout}s")
        if r.error is not None:
            raise r.error
        return r

    def swap(self, corpus: str, new_path: str,
             share_centroids: bool = True) -> float:
        """Zero-downtime version switch: repoint `corpus` at `new_path`
        (e.g. a freshly compacted index) while this service keeps
        serving.  Requests already leased onto the old version finish on
        it; every later request sees the new one.  Returns the new
        handle's load time in seconds (the paper's switch-time metric)."""
        return self.pool.swap(corpus, new_path,
                              share_centroids=share_centroids)

    # -- scheduling ----------------------------------------------------------
    def _pick_corpus(self) -> Optional[str]:
        """Next non-empty, non-busy corpus, round-robin (lock held)."""
        n = len(self._rr)
        for off in range(n):
            c = self._rr[(self._rr_next + off) % n]
            if self._queues[c] and c not in self._busy:
                self._rr_next = (self._rr_next + off + 1) % n
                return c
        return None

    def _expire(self, r: Request, now: float):
        """Fail one deadline-passed request (lock held): the submitter
        already gave up — serving it would burn a search slot into the
        void AND count it `completed` (the abandoned-request bug)."""
        self._tel[r.corpus].expired.inc()
        r.error = TimeoutError(
            f"request to corpus {r.corpus!r} expired before service")
        r.t_done = now
        r.event.set()

    def _pop_live(self, corpus: str) -> Optional[Request]:
        """Pop the next non-expired request (lock held), failing expired
        entries along the way.  None when the queue drains."""
        q = self._queues[corpus]
        now = time.perf_counter()
        while q:
            r = q.popleft()
            if r.expired(now):
                self._expire(r, now)
                continue
            return r
        return None

    def _worker(self):
        while True:
            with self._cond:
                corpus = self._pick_corpus()
                while corpus is None:
                    if self._stop:
                        return
                    self._cond.wait(0.1)
                    corpus = self._pick_corpus()
                self._busy.add(corpus)
                first = self._pop_live(corpus)
            try:
                if first is None:
                    continue             # every queued request had expired
                batch = [first]
                # linger up to max_wait for the batch to fill
                deadline = time.perf_counter() + self.max_wait
                while len(batch) < self.max_batch:
                    with self._cond:
                        if self._queues[corpus]:
                            r = self._pop_live(corpus)
                            if r is not None:
                                batch.append(r)
                            continue
                        left = deadline - time.perf_counter()
                        if left <= 0 or self._stop:
                            break
                        self._cond.wait(left)
                self._serve(corpus, batch)
            finally:
                with self._cond:
                    self._busy.discard(corpus)
                    self._cond.notify_all()

    def _serve(self, corpus: str, batch: List[Request]):
        err: Optional[Exception] = None
        ids = None
        dists = None
        load_s = 0.0
        # one batch serves at most one trace's spans: the first traced
        # request wins (mixed batches annotate how many rode along)
        tspan = next((r.span for r in batch if r.span is not None), None)
        bspan = None
        if tspan is not None:
            bspan = tspan.tracer.start_span(
                "service.batch", parent=tspan,
                annotations=dict(
                    corpus=corpus, batch=len(batch),
                    traced=sum(r.span is not None for r in batch),
                    queue_wait_s=time.perf_counter() - batch[0].t_submit))
        try:
            # inside the try: a malformed query (ragged dims) must fail the
            # batch, not kill the worker thread
            queries = np.stack([r.query for r in batch])
            k = max(r.k for r in batch)
            with obs_trace.activate(bspan):
                with self.pool.lease(corpus) as (idx, load_s):
                    out = self._search_fn(idx, queries, k)
            # a search_fn may return (ids, dists) — cluster shard workers
            # do, because the scatter-gather merge needs exact scores
            if isinstance(out, tuple):
                ids, dists = out
                dists = np.asarray(dists)
            else:
                ids = out
            ids = np.asarray(ids)        # malformed returns fail the batch
            if ids.ndim != 2 or ids.shape[0] != len(batch):
                raise ValueError(
                    f"search_fn returned shape {ids.shape}, expected "
                    f"({len(batch)}, k)")
            if dists is not None and dists.shape != ids.shape:
                raise ValueError(
                    f"search_fn dists shape {dists.shape} != ids shape "
                    f"{ids.shape}")
        except Exception as e:           # noqa: BLE001 — fail the batch,
            err = e                      # never kill the worker thread
        # feed the pool's circuit breaker: OSError covers raw I/O errors,
        # injected faults that exhausted their retries, and persistent
        # checksum failures (CorruptBlockError is an OSError with EIO) —
        # the failures that mean THIS CORPUS'S STORAGE is sick, as opposed
        # to e.g. a malformed query, which says nothing about the disk
        if err is None:
            self.pool.record_success(corpus)
        elif isinstance(err, OSError):
            self.pool.record_io_failure(corpus)
        if bspan is not None:
            bspan.annotate(load_s=load_s,
                           error=(type(err).__name__ if err else None))
            bspan.end()                  # before event.set(): the worker
        now = time.perf_counter()        # ships spans once the event fires
        with self._cond:
            tel = self._tel[corpus]
            tel.batches.inc()
            tel.batch_size.observe(len(batch))
            if load_s:
                tel.switch.observe(load_s)
            for i, r in enumerate(batch):
                r.t_done = now
                if err is not None:
                    r.error = err
                    tel.errors.inc()
                else:
                    r.result = ids[i, :r.k]
                    if dists is not None:
                        r.dists = dists[i, :r.k]
                    tel.completed.inc()
                    tel.latency.observe(r.latency_s)
                tel.last_done = now
                r.event.set()

    # -- telemetry -----------------------------------------------------------
    def stats(self) -> dict:
        """Legacy dict shape, rendered as a thin view over the metrics
        registry (percentiles are histogram-bucket-derived), plus the
        full registry snapshot under ``"registry"`` — the mergeable form
        T_STATS carries to the cluster supervisor."""
        with self._cond:
            corpora = {}
            for c, tel in self._tel.items():
                completed = int(tel.completed.value)
                batches = int(tel.batches.value)
                span = None
                if tel.first_submit is not None and tel.last_done is not None:
                    span = max(tel.last_done - tel.first_submit, 1e-9)
                tel.queue_depth.set(len(self._queues.get(c, ())))
                lat = tel.latency
                # the pool's per-handle SearchMetrics feeds these series
                # into the same registry; the idempotent getter returns
                # the live series (or an empty one, skipped below)
                hops = self.registry.histogram(
                    "traversal_hops", {"corpus": c}, buckets=COUNT_BUCKETS)
                conv = self.registry.histogram(
                    "traversal_convergence_hops", {"corpus": c},
                    buckets=COUNT_BUCKETS)
                corpora[c] = dict(
                    completed=completed,
                    rejected=int(tel.rejected.value),
                    errors=int(tel.errors.value),
                    expired=int(tel.expired.value),
                    unhealthy_rejected=int(tel.unhealthy_rejected.value),
                    batches=batches,
                    mean_batch=(completed / batches if batches else 0.0),
                    switches=tel.switch.count,
                    switch_ms_total=tel.switch.sum * 1e3,
                    qps=(completed / span if span else 0.0),
                    queued=len(self._queues.get(c, ())),
                    **({"p50_ms": lat.quantile(0.50) * 1e3,
                        "p95_ms": lat.quantile(0.95) * 1e3,
                        "p99_ms": lat.quantile(0.99) * 1e3}
                       if lat.count else {}),
                    **({"hops_p50": hops.quantile(0.50),
                        "hops_p95": hops.quantile(0.95),
                        "hops_p99": hops.quantile(0.99)}
                       if hops.count else {}),
                    **({"convergence_hops_p50": conv.quantile(0.50)}
                       if conv.count else {}))
            tels = list(self._tel.values())
            p50 = merged_quantile([t.latency for t in tels], 0.50)
            p99 = merged_quantile([t.latency for t in tels], 0.99)
            out = dict(
                corpora=corpora,
                total_completed=sum(int(t.completed.value) for t in tels),
                total_rejected=sum(int(t.rejected.value) for t in tels),
                total_expired=sum(int(t.expired.value) for t in tels),
                total_unhealthy_rejected=sum(
                    int(t.unhealthy_rejected.value) for t in tels),
                total_switches=sum(t.switch.count for t in tels),
                uptime_s=time.perf_counter() - self._t0,
                **({"p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3}
                   if p50 is not None else {}))
        # pool snapshot taken OUTSIDE the service lock: the pool does its
        # own single-pass consistent capture under its own lock, and the
        # service never holds both locks at once (no ordering to get
        # wrong against serve-path pool calls).  The pool publishes its
        # gauges into the shared registry during stats(), so the registry
        # snapshot below already carries them.
        out["pool"] = self.pool.stats()
        out["registry"] = self.registry.snapshot()
        return out

    # -- lifecycle -----------------------------------------------------------
    def close(self, drain_s: float = 5.0, timeout: float = 5.0):
        """Graceful shutdown: stop admitting new requests (submits raise
        `ServiceClosedError` immediately), let the workers DRAIN what is
        already queued for up to `drain_s`, then fail whatever remains
        with the same typed error and join the workers.  This is what a
        cluster worker runs on SIGTERM — in-flight callers get answers
        or a typed rejection, never an abandoned request."""
        with self._cond:
            if self._stop:
                return
            self._closing = True
            self._cond.notify_all()
        deadline = time.perf_counter() + max(0.0, drain_s)
        while time.perf_counter() < deadline:
            with self._cond:
                if not any(self._queues.values()) and not self._busy:
                    break
            time.sleep(0.005)
        self.stop(timeout)

    def stop(self, timeout: float = 5.0):
        with self._cond:
            self._stop = True
            self._closing = True
            # fail whatever is still queued — nobody will serve it
            leftovers = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            self._cond.notify_all()
        err = ServiceClosedError("service stopped")
        for r in leftovers:
            r.error = err
            r.event.set()
        for t in self._workers:
            t.join(timeout)
