"""Scatter-gather shard router with explicit partial-result degradation
(port of `repro.serving.router`; host code, numpy and sockets).

One query fans out to every shard, each shard answers its local top-k
with EXACT distances, and `core.shard_math.merge_topk` folds the partial
lists into a global top-k — a deterministic (dist, id) merge, so a full-coverage routed answer is
bit-identical to a single-process reference over the same shards.

Failure is a first-class outcome, with a strict contract:

  * NEVER HANG — every shard attempt carries `shard_deadline_s`; a
    worker that doesn't answer in time counts as failed for this query,
  * NEVER SILENTLY SHORT — a result that lacks any shard's coverage is
    flagged `partial=True` with `shards_answered`/`shards_failed`
    telemetry; the caller decides whether a partial answer is
    acceptable, the router never passes one off as complete,
  * one HEDGED RETRY — a failed shard gets exactly one more attempt
    against a freshly resolved endpoint (the supervisor may have
    respawned the worker since the first try); retry storms are capped
    by construction,
  * QUORUM — fewer than `min_shards` answers raises the typed
    `DegradedServiceError` (a clean rejection, distinguishable from
    both success and partial success).

`ShardClient` is the transport abstraction: `SocketShardClient` speaks
the CRC-framed protocol to cluster workers (one connection per router
thread — connections are not multiplexed, parallelism comes from
threads); `LocalShardClient` wraps any in-process callable, which is how
the single-process reference for drills and the DEVICE-tier per-shard
search mount under the same router.
"""
from __future__ import annotations

import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.shard_math import merge_topk
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serving import protocol as proto

__all__ = ["ShardUnavailableError", "DegradedServiceError", "ShardClient",
           "SocketShardClient", "LocalShardClient", "RouterResult",
           "ShardRouter"]


class ShardUnavailableError(RuntimeError):
    """One shard attempt failed (connect/timeout/protocol/worker error).
    Router-internal: surfaces to callers only in aggregate, as partial
    results or DegradedServiceError."""


class DegradedServiceError(RuntimeError):
    """Fewer than `min_shards` shards answered — the router rejects the
    query cleanly rather than return an answer below quorum."""

    def __init__(self, answered: int, total: int, min_shards: int):
        super().__init__(
            f"only {answered}/{total} shards answered "
            f"(quorum min_shards={min_shards})")
        self.answered = answered
        self.total = total
        self.min_shards = min_shards


class ShardClient:
    """Transport to one shard: `search` returns (ids, dists) or raises
    ShardUnavailableError.  Implementations must be thread-safe."""

    def search(self, query: np.ndarray, k: int, *, corpus: str = "default",
               deadline_s: Optional[float] = None,
               trace: Optional[dict] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """`trace` is an obs span context dict ({tid, sid}); a transport
        that propagates it appends the remote side's finished spans to
        trace["spans"]."""
        raise NotImplementedError

    def reset(self):
        """Drop cached transport state (e.g. reconnect after a respawn)."""

    def close(self):
        pass


class SocketShardClient(ShardClient):
    """CRC-framed protocol client over a Unix socket.

    Connections are per-thread (`threading.local`): the worker serves
    one connection sequentially, so router-side parallelism maps each
    scatter thread to its own connection.  Any transport or protocol
    failure closes the connection (a framed stream cannot resync past
    corruption) and raises ShardUnavailableError; the next call
    reconnects — which is exactly what a hedged retry to a respawned
    worker needs."""

    def __init__(self, socket_path: str, *,
                 connect_timeout_s: float = 1.0):
        self.socket_path = socket_path
        self.connect_timeout_s = connect_timeout_s
        self._tls = threading.local()
        self._epoch = 0                # bumped by reset(): force reconnect
        self._next_id = 0
        self._id_lock = threading.Lock()

    def _conn(self, deadline_s: Optional[float]) -> socket.socket:
        tls = self._tls
        if getattr(tls, "sock", None) is None \
                or getattr(tls, "epoch", -1) != self._epoch:
            self._drop()
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.connect_timeout_s)
            s.connect(self.socket_path)
            tls.sock = s
            tls.epoch = self._epoch
        tls.sock.settimeout(deadline_s)
        return tls.sock

    def _drop(self):
        s = getattr(self._tls, "sock", None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass
        self._tls.sock = None

    def _req_id(self) -> int:
        with self._id_lock:
            self._next_id += 1
            return self._next_id

    def search(self, query, k, *, corpus="default", deadline_s=None,
               trace=None):
        rid = self._req_id()
        try:
            sock = self._conn(deadline_s)
            h, b = proto.encode_query(np.asarray(query), corpus=corpus,
                                      k=k, req_id=rid,
                                      deadline_s=deadline_s, trace=trace)
            proto.send_frame(sock, proto.T_SEARCH, h, b)
            rtype, header, blob = proto.recv_frame(sock)
        except (proto.ProtocolError, OSError, socket.timeout) as e:
            self._drop()
            raise ShardUnavailableError(
                f"{self.socket_path}: {type(e).__name__}: {e}") from e
        if rtype == proto.T_ERROR:
            # worker answered with a typed rejection — the connection is
            # still good, only this request failed
            raise ShardUnavailableError(
                f"{self.socket_path}: worker error "
                f"{header.get('etype')}: {header.get('msg')}")
        if rtype != proto.T_RESULT or header.get("req_id") != rid:
            self._drop()               # desynchronized: poison the conn
            raise ShardUnavailableError(
                f"{self.socket_path}: unexpected frame type {rtype}")
        if trace is not None and isinstance(header.get("spans"), list):
            # the worker's finished spans for this trace ride the result
            # header; hand them to the caller for tracer ingestion
            trace.setdefault("spans", []).extend(header["spans"])
        try:
            return proto.decode_result(header, blob)
        except proto.ProtocolError as e:
            self._drop()
            raise ShardUnavailableError(str(e)) from e

    def reset(self):
        self._epoch += 1               # every thread reconnects lazily

    def close(self):
        self._drop()


class LocalShardClient(ShardClient):
    """In-process shard: wraps `fn(query, k) -> (ids, dists)`.

    Mounts anything callable under the router — the single-process
    reference in drills, a device-tier per-shard search, a stub in
    tests.  Exceptions map to ShardUnavailableError like a dead
    worker's socket would."""

    def __init__(self, fn: Callable, name: str = "local"):
        self.fn = fn
        self.name = name

    def search(self, query, k, *, corpus="default", deadline_s=None,
               trace=None):
        try:
            ids, dists = self.fn(np.asarray(query), k)
            return np.asarray(ids, np.int64), np.asarray(dists, np.float32)
        except Exception as e:         # noqa: BLE001 — any local failure
            raise ShardUnavailableError(
                f"{self.name}: {type(e).__name__}: {e}") from e


@dataclass
class RouterResult:
    """One routed answer with its coverage telemetry."""
    ids: np.ndarray                    # (k,) global labels, -1 padding
    dists: np.ndarray                  # (k,) exact f32, +inf padding
    partial: bool                      # True: >=1 shard missing
    shards_answered: int
    shards_failed: int
    failed_shards: List[int] = field(default_factory=list)
    retried_shards: List[int] = field(default_factory=list)
    latency_s: float = 0.0


class ShardRouter:
    """Scatter-gather over a fixed shard set.

    `clients`: one ShardClient per shard (index = shard id).
    `endpoints_fn`: optional `() -> [socket_path | None per shard]`
    (e.g. `ShardCluster.endpoints`) consulted before the hedged retry so
    the retry targets the CURRENT worker, not the corpse the first
    attempt hit; shards currently reported None skip their retry (no
    point knocking on a quarantined door).
    """

    def __init__(self, clients: Sequence[ShardClient], *,
                 min_shards: int = 1,
                 shard_deadline_s: float = 2.0,
                 hedge_retry: bool = True,
                 endpoints_fn: Optional[Callable[[], List[Optional[str]]]]
                 = None,
                 tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None):
        if not clients:
            raise ValueError("router needs at least one shard client")
        self.clients = list(clients)
        self.min_shards = int(min_shards)
        if not 1 <= self.min_shards <= len(self.clients):
            raise ValueError(
                f"min_shards={min_shards} outside [1, {len(self.clients)}]")
        self.shard_deadline_s = float(shard_deadline_s)
        self.hedge_retry = hedge_retry
        self.endpoints_fn = endpoints_fn
        self.tracer = tracer
        self.registry = registry or MetricsRegistry()
        reg = self.registry
        self._c_queries = reg.counter(
            "router_queries_total", help="queries accepted by the router")
        self._c_answers = {
            o: reg.counter("router_answers_total",
                           help="routed answers by outcome",
                           labels={"outcome": o})
            for o in ("full", "partial", "rejected")}
        self._c_attempts = {
            a: reg.counter("router_shard_attempts_total",
                           help="per-shard attempts by kind",
                           labels={"attempt": a})
            for a in ("first", "hedge")}
        self._c_failures = {
            a: reg.counter("router_shard_failures_total",
                           help="failed per-shard attempts by kind",
                           labels={"attempt": a})
            for a in ("first", "hedge")}
        self._c_retry_ok = reg.counter(
            "router_retry_success_total",
            help="hedged retries that produced an answer")
        self._h_latency = reg.histogram(
            "router_latency_seconds", unit="s",
            help="end-to-end routed query latency")
        self._h_attempt = {
            a: reg.histogram("router_attempt_latency_seconds", unit="s",
                             help="per-shard attempt latency by kind "
                                  "(hedge vs first shows hedge payoff)",
                             labels={"attempt": a})
            for a in ("first", "hedge")}
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, len(self.clients)),
            thread_name_prefix="router-scatter")

    # -- per-shard attempt ---------------------------------------------------
    def _attempt(self, shard: int, query, k, corpus, kind: str,
                 root_span=None):
        """One timed transport attempt ('first' | 'hedge').  Returns
        (ids, dists) or None; never raises."""
        client = self.clients[shard]
        self._c_attempts[kind].inc()
        ctx = None
        sp = None
        if root_span is not None:
            sp = root_span.tracer.start_span(
                f"router.shard{shard}", parent=root_span,
                annotations=dict(shard=shard, attempt=kind, corpus=corpus))
            ctx = root_span.tracer.context(sp)
        t0 = time.perf_counter()
        try:
            out = client.search(query, k, corpus=corpus,
                                deadline_s=self.shard_deadline_s,
                                trace=ctx)
            self._h_attempt[kind].observe(time.perf_counter() - t0)
            if sp is not None:
                sp.annotate(ok=True)
            return out
        except ShardUnavailableError as e:
            self._h_attempt[kind].observe(time.perf_counter() - t0)
            self._c_failures[kind].inc()
            if sp is not None:
                sp.annotate(ok=False, error=str(e))
            return None
        finally:
            if sp is not None:
                sp.end()
                if ctx and ctx.get("spans"):
                    root_span.tracer.ingest(ctx["spans"])

    def _ask(self, shard: int, query, k, corpus, root_span=None
             ) -> Tuple[Optional[Tuple[np.ndarray, np.ndarray]], bool]:
        """One shard's answer with up to one hedged retry.
        Returns ((ids, dists) | None, retried)."""
        out = self._attempt(shard, query, k, corpus, "first",
                            root_span=root_span)
        if out is not None:
            return out, False
        if not self.hedge_retry:
            return None, False
        # hedged retry: re-resolve the endpoint first — the supervisor
        # may have respawned the worker since the failed attempt
        client = self.clients[shard]
        if self.endpoints_fn is not None:
            eps = self.endpoints_fn()
            ep = eps[shard] if shard < len(eps) else None
            if ep is None:
                return None, False     # shard is known-down: don't knock
            if isinstance(client, SocketShardClient) \
                    and ep != client.socket_path:
                client.socket_path = ep
            client.reset()
        out = self._attempt(shard, query, k, corpus, "hedge",
                            root_span=root_span)
        if out is not None:
            self._c_retry_ok.inc()
        return out, True

    # -- public API ----------------------------------------------------------
    def search(self, query: np.ndarray, k: int, *,
               corpus: str = "default") -> RouterResult:
        """Scatter `query` to every shard, gather within the per-shard
        deadline, merge.  Raises DegradedServiceError below quorum."""
        t0 = time.perf_counter()
        self._c_queries.inc()
        root = None
        if self.tracer is not None and self.tracer.sampled():
            root = self.tracer.start_span(
                "router.search",
                annotations=dict(corpus=corpus, k=int(k),
                                 shards=len(self.clients)))
        try:
            futs = [self._pool.submit(self._ask, s, query, k, corpus, root)
                    for s in range(len(self.clients))]
            parts_ids: List[np.ndarray] = []
            parts_dists: List[np.ndarray] = []
            failed: List[int] = []
            retried: List[int] = []
            for s, f in enumerate(futs):
                out, did_retry = f.result()  # _ask never raises; bounded by
                if did_retry:                # 2x shard deadline + connect
                    retried.append(s)
                if out is None:
                    failed.append(s)
                else:
                    parts_ids.append(out[0])
                    parts_dists.append(out[1])
            answered = len(self.clients) - len(failed)
            if answered < self.min_shards:
                self._c_answers["rejected"].inc()
                if root is not None:
                    root.annotate(outcome="rejected", answered=answered)
                raise DegradedServiceError(answered, len(self.clients),
                                           self.min_shards)
            ids, dists = merge_topk(parts_ids, parts_dists, k)
            partial = bool(failed)
            self._c_answers["partial" if partial else "full"].inc()
            lat = time.perf_counter() - t0
            self._h_latency.observe(lat)
            if root is not None:
                root.annotate(outcome="partial" if partial else "full",
                              answered=answered, failed=len(failed))
            return RouterResult(ids=ids, dists=dists, partial=partial,
                                shards_answered=answered,
                                shards_failed=len(failed),
                                failed_shards=failed,
                                retried_shards=retried,
                                latency_s=lat)
        finally:
            if root is not None:
                root.end()

    def stats(self) -> dict:
        """Compat view over the registry: the historical flat-counter
        shape plus the first/hedge latency split and a full snapshot."""
        first = self._h_attempt["first"]
        hedge = self._h_attempt["hedge"]

        def _lat(h):
            if not h.count:
                return None
            return dict(count=int(h.count),
                        mean_ms=h.sum / h.count * 1e3,
                        p50_ms=(h.quantile(0.50) or 0.0) * 1e3,
                        p99_ms=(h.quantile(0.99) or 0.0) * 1e3)

        out = dict(
            queries=int(self._c_queries.value),
            full=int(self._c_answers["full"].value),
            partial=int(self._c_answers["partial"].value),
            rejected=int(self._c_answers["rejected"].value),
            shard_attempts=int(self._c_attempts["first"].value
                               + self._c_attempts["hedge"].value),
            shard_failures=int(self._c_failures["first"].value
                               + self._c_failures["hedge"].value),
            retries=int(self._c_attempts["hedge"].value),
            retry_successes=int(self._c_retry_ok.value),
            attempt_latency=dict(first=_lat(first), hedge=_lat(hedge)),
        )
        out["registry"] = self.registry.snapshot()
        return out

    def close(self):
        self._pool.shutdown(wait=False)
        for c in self.clients:
            c.close()
