"""Supervised multi-process shard serving: N workers, one supervisor
(port of `repro.serving.cluster`; each worker searches on its `device`).

The GIL caps one Python process at roughly one core of host-side search;
AiSAQ's ~10 MB-per-index residency means one box WANTS to run many
shards.  This module is the process tier:

  * each shard worker is a separate OS process wrapping the existing
    single-process stack — a `WarmIndexPool` + `RetrievalService` over
    that shard's corpora — and serves the CRC-framed protocol
    (``serving.protocol``) on a Unix socket,
  * workers are started with the multiprocessing **spawn** context: the
    parent may carry BLAS threads and a CUDA context, and forking a
    threaded process inherits locked locks (and a context the child
    cannot use). A spawned worker imports torch (seconds) and, on the
    card, creates its CUDA context and loads the kernel library the
    parent built before it binds its socket,
  * a spawned worker is ``starting`` until its first heartbeat answers:
    the router is not given its socket, and missed heartbeats count only
    once it is ``serving``. A worker that does not answer within
    ``ready_timeout_s`` (the timeout ``start`` takes) is killed and
    counted as a failed start in its crash streak. (The reference marks
    a worker serving the moment its process starts, so a start slower
    than ``heartbeat_s * heartbeat_misses`` is killed as wedged and, six
    times over, quarantined: `repro/serving/cluster.py:312-324`,
    `:411-433`.)
  * the supervisor treats failure as the default case: a monitor thread
    watches liveness (`Process.is_alive`) AND responsiveness (heartbeat
    pings over the socket — a wedged worker that still has a pid gets
    SIGKILLed), respawns dead workers with capped exponential backoff,
    and QUARANTINES a worker that crash-loops (dies repeatedly within
    its stabilization window) the way `WarmIndexPool` quarantines a sick
    corpus — the router then serves partial answers from the survivors
    instead of feeding a crash loop,
  * SIGTERM to a worker runs `RetrievalService.close()`: queued requests
    drain or fail with the typed `ServiceClosedError`, never silently
    abandoned.

Global labels: shard indices are built with `write_index(labels=...)`
carrying each vector's GLOBAL id, so worker answers merge without any
per-shard offset arithmetic in the protocol.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.metrics import merge_snapshots
from repro_torch.serving import protocol as proto

__all__ = ["WorkerSpec", "ShardCluster", "serve_worker"]


@dataclass
class WorkerSpec:
    """Everything one shard worker needs, picklable for spawn."""
    shard_id: int
    socket_path: str
    corpora: Dict[str, str]            # corpus name -> index dir
    cache_bytes: int = 10 << 20
    budget_bytes: Optional[int] = None
    threads: int = 2                   # RetrievalService worker threads
    max_batch: int = 16
    max_wait_ms: float = 2.0
    max_queue_depth: int = 256
    L: int = 48
    w: int = 4
    rerank: Optional[int] = None
    adc_dtype: str = "f32"
    prefetch: int = 0
    pipeline: Optional[bool] = None
    gap: Optional[object] = None
    entry: str = "auto"                # nav-tier entry seeding (docs/navigation.md)
    drain_s: float = 2.0               # SIGTERM queue-drain budget
    default_deadline_s: float = 30.0   # requests that carry no deadline
    # observability knobs (see docs/observability.md)
    trace_sample: float = 1.0          # fraction of REMOTE traces served;
    #                                    router-side sampling is the primary
    #                                    knob, this one sheds worker cost
    slow_query_s: Optional[float] = None   # slow-query log threshold
    slow_log_path: Optional[str] = None    # JSONL file for slow span trees
    device: str = "cuda"               # where the worker's searches run


def _json_safe(obj):
    """stats() dicts hold plain ints/floats/bools already; anything
    exotic degrades to str rather than failing the frame."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------


def serve_worker(spec: WorkerSpec):          # pragma: no cover — subprocess
    """Entry point of one shard worker process (spawn target).

    Imports the serving stack and, on a CUDA device, creates the CUDA
    context and loads the kernel library, then binds the Unix socket
    (readiness = a heartbeat answers) and serves frames until
    SIGTERM/T_SHUTDOWN. Each accepted connection gets a thread; requests
    on one connection are served in order (the router opens one
    connection per router thread for parallelism)."""
    import numpy as np  # closed over by the handlers below
    import torch

    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.engine import make_host_search_dist_fn
    from repro_torch.serving.pool import CorpusUnhealthyError, WarmIndexPool
    from repro_torch.serving.service import (BackpressureError,
                                             RetrievalService,
                                             ServiceClosedError)

    from repro_torch.kernels import _build
    device = resolve_device(spec.device)
    if device.type == "cuda":
        torch.empty(1, device=device)    # the CUDA context, before bind
        _build.lib()

    stop_ev = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_ev.set())
    signal.signal(signal.SIGINT, signal.SIG_IGN)   # supervisor owns ctrl-C

    try:
        os.unlink(spec.socket_path)
    except FileNotFoundError:
        pass
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(spec.socket_path)
    listener.listen(64)
    listener.settimeout(0.2)

    registry = MetricsRegistry()
    tracer = Tracer(sample=spec.trace_sample,
                    slow_threshold_s=spec.slow_query_s,
                    slow_log_path=spec.slow_log_path)
    pool = WarmIndexPool(spec.corpora, budget_bytes=spec.budget_bytes,
                         cache_bytes=spec.cache_bytes, registry=registry,
                         device=device)
    service = RetrievalService(
        pool, num_workers=spec.threads, max_batch=spec.max_batch,
        max_wait_ms=spec.max_wait_ms, max_queue_depth=spec.max_queue_depth,
        L=spec.L, w=spec.w, rerank=spec.rerank, adc_dtype=spec.adc_dtype,
        prefetch=spec.prefetch, pipeline=spec.pipeline, gap=spec.gap,
        entry=spec.entry,
        # exact distances ride along with every answer: the router's
        # cross-shard merge needs comparable scores
        search_fn=lambda idx, q, k: make_host_search_dist_fn(
            idx, L=spec.L, w=spec.w, prefetch=spec.prefetch,
            adc_dtype=spec.adc_dtype, rerank=spec.rerank,
            pipeline=spec.pipeline, gap=spec.gap,
            entry=spec.entry)(q, k))

    def handle_search(conn, header, blob):
        req_id = int(header.get("req_id", -1))
        wspan = None
        try:
            q = proto.decode_query(header, blob)
            tctx = proto.trace_context(header)
            if tctx is not None and tracer.sampled():
                # continue the router's trace: this span + everything the
                # service/traversal nests under it ships back on T_RESULT
                wspan = tracer.start_remote(
                    "worker.serve", tctx,
                    annotations=dict(shard=spec.shard_id,
                                     pid=os.getpid()))
            deadline = header.get("deadline_s")
            wait_s = float(deadline) if deadline is not None \
                else spec.default_deadline_s
            r = service.submit(q, corpus=header.get("corpus", "default"),
                               k=int(header["k"]), deadline_s=wait_s,
                               span=wspan)
            if not r.event.wait(wait_s + 0.05):
                raise TimeoutError(
                    f"request not served within {wait_s}s")
            if r.error is not None:
                raise r.error
            ids = np.asarray(r.result, dtype=np.int64)
            dists = r.dists if r.dists is not None \
                else np.full(ids.shape, np.inf, np.float32)
            spans = None
            if wspan is not None:
                wspan.end()
                spans = tracer.take(wspan.trace_id)
                wspan = None
            h, b = proto.encode_result(ids, dists, req_id=req_id,
                                       spans=spans)
            proto.send_frame(conn, proto.T_RESULT, h, b)
        except (BackpressureError, CorpusUnhealthyError,
                ServiceClosedError, TimeoutError, KeyError,
                ValueError, OSError) as e:
            if wspan is not None:      # error frames carry no spans;
                wspan.end()            # discard rather than leak
                tracer.take(wspan.trace_id)
            # clean per-request rejection: the request RESOLVES with a
            # typed error frame — the never-silently-short contract
            proto.send_frame(conn, proto.T_ERROR,
                             dict(req_id=req_id, etype=type(e).__name__,
                                  msg=str(e)[:512]))

    def handle_conn(conn):
        conn.settimeout(None)          # workers wait for work; router
        try:                           # deadlines live on the ROUTER side
            while not stop_ev.is_set():
                try:
                    rtype, header, blob = proto.recv_frame(conn)
                except proto.ConnectionClosed:
                    return
                except proto.ProtocolError:
                    return             # poisoned stream: drop it
                if rtype == proto.T_SEARCH:
                    handle_search(conn, header, blob)
                elif rtype == proto.T_PING:
                    proto.send_frame(conn, proto.T_PONG,
                                     dict(pid=os.getpid(),
                                          shard_id=spec.shard_id))
                elif rtype == proto.T_STATS:
                    # the service's stats plus this process's kernel
                    # launches (which kernels its searches ran)
                    reply = service.stats()
                    reply["kernel_launches"] = dict(_build.launch_counts)
                    proto.send_frame(conn, proto.T_STATS_REPLY,
                                     _json_safe(reply))
                elif rtype == proto.T_SHUTDOWN:
                    stop_ev.set()
                    proto.send_frame(conn, proto.T_PONG,
                                     dict(pid=os.getpid(),
                                          shard_id=spec.shard_id))
                    return
        except OSError:
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    try:
        while not stop_ev.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=handle_conn, args=(conn,),
                             daemon=True).start()
    finally:
        listener.close()
        # graceful drain: answer or typed-fail everything queued
        service.close(drain_s=spec.drain_s)
        pool.close()
        try:
            os.unlink(spec.socket_path)
        except OSError:
            pass
    sys.exit(0)


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------


@dataclass
class _WorkerState:
    spec: WorkerSpec
    proc: Optional[object] = None      # multiprocessing.Process
    state: str = "down"     # down | starting | serving | quarantined
    restarts: int = 0                  # total respawns over the lifetime
    crash_streak: int = 0              # consecutive fast deaths
    spawned_at: float = 0.0
    ready_at: float = 0.0              # when the first heartbeat answered
    ready_s: Optional[float] = None    # spawn -> serving of the last spawn
    respawn_at: float = 0.0            # earliest next spawn (backoff)
    hb_misses: int = 0
    hb_sock: Optional[socket.socket] = None
    lock: threading.Lock = field(default_factory=threading.Lock)


class ShardCluster:
    """Spawns and supervises one worker per shard.

    `shards` is a list of corpus->index-dir dicts, one per shard.  The
    monitor thread restarts dead or wedged workers with capped
    exponential backoff (`backoff_s` doubling per consecutive fast
    crash up to `backoff_max_s`); a worker that dies `max_restarts`
    times in a row within `stable_s` of each spawn is quarantined.
    `endpoints()` is what the router polls — a starting, quarantined or
    down shard shows `None` and the router degrades to partial answers.
    `device` is where every worker searches (None is the card, raising
    without one); it travels to the workers as a string."""

    def __init__(self, shards: List[Dict[str, str]], *,
                 socket_dir: str,
                 heartbeat_s: float = 0.25,
                 heartbeat_misses: int = 3,
                 ping_timeout_s: float = 1.0,
                 backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 max_restarts: int = 5,
                 stable_s: float = 5.0,
                 device: DeviceLike = None,
                 **spec_kw):
        device = str(resolve_device(device))
        os.makedirs(socket_dir, exist_ok=True)
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_misses = int(heartbeat_misses)
        self.ping_timeout_s = float(ping_timeout_s)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.max_restarts = int(max_restarts)
        self.stable_s = float(stable_s)
        self.ready_timeout_s = 30.0      # set by start()
        self._workers = [
            _WorkerState(spec=WorkerSpec(
                shard_id=i,
                socket_path=os.path.join(socket_dir, f"shard{i}.sock"),
                corpora=dict(corpora), device=device, **spec_kw))
            for i, corpora in enumerate(shards)]
        self._ctx = None
        self._stop = False
        self._monitor_t: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.events: deque = deque(maxlen=256)   # (t, shard, what)

    # -- lifecycle -----------------------------------------------------------
    def _log(self, shard: int, what: str):
        self.events.append((time.monotonic(), shard, what))

    def _spawn(self, ws: _WorkerState):
        import multiprocessing as mp
        if self._ctx is None:
            self._ctx = mp.get_context("spawn")
        ws.proc = self._ctx.Process(target=serve_worker, args=(ws.spec,),
                                    daemon=True,
                                    name=f"shard-worker-{ws.spec.shard_id}")
        ws.proc.start()
        ws.spawned_at = time.monotonic()
        ws.state = "starting"
        ws.hb_misses = 0
        self._close_hb(ws)
        self._log(ws.spec.shard_id, f"spawned pid={ws.proc.pid}")

    def _ready(self, ws: _WorkerState, now: float):
        """A starting worker answered its first heartbeat: serving."""
        ws.state = "serving"
        ws.ready_at = now
        ws.ready_s = now - ws.spawned_at
        ws.hb_misses = 0
        self._log(ws.spec.shard_id, f"serving after {ws.ready_s:.2f}s")

    def start(self, ready_timeout_s: float = 30.0):
        """Spawn every worker and wait until each answers a ping. The
        timeout also bounds every later respawn's start."""
        self.ready_timeout_s = float(ready_timeout_s)
        for ws in self._workers:
            self._spawn(ws)
        deadline = time.monotonic() + ready_timeout_s
        for ws in self._workers:
            while not self._ping(ws):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"shard {ws.spec.shard_id} not ready within "
                        f"{ready_timeout_s}s")
                time.sleep(0.05)
            self._ready(ws, time.monotonic())
        self._monitor_t = threading.Thread(target=self._monitor,
                                           name="cluster-monitor",
                                           daemon=True)
        self._monitor_t.start()
        return self

    def stop(self, timeout: float = 10.0):
        with self._lock:
            self._stop = True
        if self._monitor_t is not None:
            self._monitor_t.join(timeout=self.heartbeat_s * 4 + 1.0)
        for ws in self._workers:
            self._close_hb(ws)
            p = ws.proc
            if p is None or not p.is_alive():
                continue
            p.terminate()              # SIGTERM -> service.close() drain
        deadline = time.monotonic() + timeout
        for ws in self._workers:
            p = ws.proc
            if p is None:
                continue
            p.join(max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()               # drain budget exhausted
                p.join(5.0)
            ws.state = "down"
            try:
                os.unlink(ws.spec.socket_path)
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- heartbeats ----------------------------------------------------------
    def _close_hb(self, ws: _WorkerState):
        if ws.hb_sock is not None:
            try:
                ws.hb_sock.close()
            except OSError:
                pass
            ws.hb_sock = None

    def _ping(self, ws: _WorkerState) -> bool:
        """One heartbeat over a persistent per-worker connection."""
        with ws.lock:
            try:
                if ws.hb_sock is None:
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.settimeout(self.ping_timeout_s)
                    s.connect(ws.spec.socket_path)
                    ws.hb_sock = s
                proto.send_frame(ws.hb_sock, proto.T_PING, {})
                rtype, header, _ = proto.recv_frame(ws.hb_sock)
                return rtype == proto.T_PONG
            except (proto.ProtocolError, OSError):
                self._close_hb(ws)
                return False

    # -- monitor loop --------------------------------------------------------
    def _monitor(self):
        while True:
            with self._lock:
                if self._stop:
                    return
            for ws in self._workers:
                self._check(ws)
            time.sleep(self.heartbeat_s)

    def _check(self, ws: _WorkerState):
        if ws.state == "quarantined":
            return
        now = time.monotonic()
        alive = ws.proc is not None and ws.proc.is_alive()
        if ws.state == "starting":
            if alive and self._ping(ws):
                self._ready(ws, now)
                return
            if alive and now - ws.spawned_at < self.ready_timeout_s:
                return                       # still starting up
            if alive:
                self._log(ws.spec.shard_id,
                          f"not ready within {self.ready_timeout_s:.1f}s; "
                          "killing")
                self._kill(ws)
            self._died(ws, now, fast=True)   # a failed start
        elif alive and ws.state == "serving":
            if self._ping(ws):
                ws.hb_misses = 0
                if now - ws.ready_at > self.stable_s:
                    ws.crash_streak = 0      # survived: streak over
                return
            ws.hb_misses += 1
            if ws.hb_misses < self.heartbeat_misses:
                return
            # responsive never, pid alive: wedged — treat as dead
            self._log(ws.spec.shard_id,
                      f"wedged after {ws.hb_misses} missed heartbeats; "
                      "killing")
            self._kill(ws)
            self._died(ws, now, fast=(now - ws.ready_at) < self.stable_s)
        elif ws.state == "serving":
            self._died(ws, now, fast=(now - ws.ready_at) < self.stable_s)
        if ws.state == "down" and now >= ws.respawn_at:
            ws.restarts += 1
            self._spawn(ws)

    def _kill(self, ws: _WorkerState):
        try:
            ws.proc.kill()
        except (OSError, AttributeError):
            pass
        ws.proc.join(2.0)

    def _died(self, ws: _WorkerState, now: float, fast: bool):
        """Death detected (a crash, a kill of a wedged worker, or a
        failed start): schedule a respawn with backoff, or quarantine a
        crash loop. `fast`: within `stable_s` of serving, or before it."""
        ws.crash_streak = ws.crash_streak + 1 if fast else 1
        self._close_hb(ws)
        if ws.crash_streak > self.max_restarts:
            ws.state = "quarantined"
            self._log(ws.spec.shard_id,
                      f"quarantined after {ws.crash_streak} "
                      "consecutive fast crashes")
            return
        backoff = min(self.backoff_s * (2.0 ** (ws.crash_streak - 1)),
                      self.backoff_max_s)
        ws.state = "down"
        ws.respawn_at = now + backoff
        self._log(ws.spec.shard_id,
                  f"died (streak={ws.crash_streak}); respawn in "
                  f"{backoff:.2f}s")

    # -- router / drill surface ----------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self._workers)

    def endpoints(self) -> List[Optional[str]]:
        """Socket path per shard, None when the shard is down or
        quarantined — the router's scatter set."""
        return [ws.spec.socket_path if ws.state == "serving" else None
                for ws in self._workers]

    def pid(self, shard_id: int) -> Optional[int]:
        """Live pid of one worker (ProcessKiller drills arm on this)."""
        ws = self._workers[shard_id]
        p = ws.proc
        return p.pid if p is not None and p.is_alive() else None

    def wait_healthy(self, timeout_s: float = 30.0) -> bool:
        """Block until every non-quarantined shard answers a ping —
        the drill's respawn-restored-full-coverage check."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(ws.state == "quarantined" or
                   (ws.state == "serving" and self._ping(ws))
                   for ws in self._workers):
                return True
            time.sleep(0.05)
        return False

    def worker_stats(self, shard_id: int) -> Optional[dict]:
        """Fetch one worker's RetrievalService.stats() over the wire."""
        ws = self._workers[shard_id]
        if ws.state != "serving":
            return None
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.ping_timeout_s)
            s.connect(ws.spec.socket_path)
            try:
                proto.send_frame(s, proto.T_STATS, {})
                rtype, header, _ = proto.recv_frame(s)
                return header if rtype == proto.T_STATS_REPLY else None
            finally:
                s.close()
        except (proto.ProtocolError, OSError):
            return None

    def stats(self) -> dict:
        """Supervisor telemetry: per-shard state machine + respawn
        accounting, plus ONE cluster-wide metrics view — each serving
        worker's registry snapshot rides T_STATS and is merged here
        (counters sum, histogram buckets add, percentiles recomputed),
        so `stats()["registry"]` reads like a single process served the
        whole cluster."""
        regs = []
        for ws in self._workers:
            w = self.worker_stats(ws.spec.shard_id)
            if w and isinstance(w.get("registry"), dict):
                regs.append(w["registry"])
        return dict(
            n_shards=self.n_shards,
            serving=sum(ws.state == "serving" for ws in self._workers),
            quarantined=sum(ws.state == "quarantined"
                            for ws in self._workers),
            shards={ws.spec.shard_id: dict(
                state=ws.state,
                pid=(ws.proc.pid if ws.proc is not None
                     and ws.proc.is_alive() else None),
                restarts=ws.restarts,
                crash_streak=ws.crash_streak,
                hb_misses=ws.hb_misses,
                ready_s=ws.ready_s,
            ) for ws in self._workers},
            events=[dict(t=t, shard=s, what=w)
                    for t, s, w in list(self.events)],
            registry=merge_snapshots(regs) if regs else None,
        )
