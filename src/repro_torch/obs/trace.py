"""Per-query span tracing across threads and processes.

One routed query produces one TRACE: a tree of SPANS — router scatter,
per-shard attempts, the worker's serve/batch stages, every traversal
hop, every block-cache read.  The propagation path:

    ShardRouter (root span, head-based sampling decision)
      -> trace context {tid, sid} rides the T_SEARCH frame header
      -> worker builds a remote-parented span, activates it around the
         service batch (thread-local span stack)
      -> `core.traversal` opens a span per hop, `BlockCache.fetch` a
         span per read — both keyed off the ACTIVE span, zero setup
      -> the worker's finished spans ride back in the T_RESULT header
         and the router ingests them into its own tracer

so `Tracer.export_chrome()` yields ONE Chrome trace-event JSON
(loadable in Perfetto / chrome://tracing) with the full cross-process
chain.  Span timestamps are wall-clock (`time.time`) so spans from
different processes land on one timeline; durations come from
`perf_counter` deltas.

Disabled-by-default cost: instrumented code calls `current_span()` —
one thread-local attribute read — and skips everything when no span is
active.  The module-level `set_enabled(False)` kill switch short-
circuits even that check (the <2% hot-path gate in
the reference's `bench_search.py --quick` compares the two).

Slow-query log: a Tracer built with `slow_threshold_s` dumps the full
span tree of any ROOT span that finishes over the threshold — to the
bounded `slow_queries` deque always, and as one JSON line per query to
`slow_log_path` when given.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

__all__ = ["Span", "Tracer", "current_span", "span", "activate",
           "set_enabled", "enabled"]

_tls = threading.local()
_ENABLED = True      # global kill switch; see set_enabled()


def set_enabled(flag: bool):
    """Global tracing kill switch.  When False, `span()`/`current_span()`
    short-circuit before touching thread-local state — the zero-cost
    baseline the disabled-overhead gate compares against."""
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def current_span() -> Optional["Span"]:
    """The innermost active span on this thread, or None."""
    if not _ENABLED:
        return None
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


@contextmanager
def activate(sp: Optional["Span"]):
    """Push `sp` as this thread's active span for the block (no-op when
    None).  Does NOT end the span — the creator owns its lifetime."""
    if sp is None:
        yield None
        return
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    st.append(sp)
    try:
        yield sp
    finally:
        st.pop()


@contextmanager
def span(name: str, **annotations):
    """Open a child of the current span for the block; no-op (yields
    None) when tracing is off or no span is active on this thread."""
    parent = current_span()
    if parent is None:
        yield None
        return
    sp = parent.tracer.start_span(name, parent=parent,
                                  annotations=annotations or None)
    st = _tls.stack
    st.append(sp)
    try:
        yield sp
    finally:
        st.pop()
        sp.end()


def begin(name: str, **annotations) -> Optional["Span"]:
    """Start (without activating) a child of the current span; None when
    inactive.  The caller must `end()` it — the explicit form hot loops
    use to keep the disabled path to one branch."""
    parent = current_span()
    if parent is None:
        return None
    return parent.tracer.start_span(name, parent=parent,
                                    annotations=annotations or None)


def _gen_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class Span:
    """One timed operation.  `trace_id` groups a query's spans across
    processes; `parent_id` builds the tree; annotations are free-form
    JSON-safe keyvals."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "t_start", "duration_s", "annotations", "pid", "tid",
                 "_t0", "_done")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str],
                 annotations: Optional[dict] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _gen_id(4)
        self.parent_id = parent_id
        self.t_start = time.time()
        self._t0 = time.perf_counter()
        self.duration_s = 0.0
        self.annotations = dict(annotations) if annotations else {}
        self.pid = os.getpid()
        self.tid = threading.get_ident()
        self._done = False

    def annotate(self, **kw):
        self.annotations.update(kw)
        return self

    def end(self):
        if self._done:
            return
        self._done = True
        self.duration_s = time.perf_counter() - self._t0
        self.tracer._on_end(self)

    def to_dict(self) -> dict:
        return dict(trace_id=self.trace_id, span_id=self.span_id,
                    parent_id=self.parent_id, name=self.name,
                    t_start=self.t_start, duration_s=self.duration_s,
                    pid=self.pid, tid=self.tid,
                    annotations=dict(self.annotations))


class Tracer:
    """Owns sampling, the finished-span buffer, exports, and the
    slow-query log.  Thread-safe; one per process side (router-side and
    worker-side tracers meet through span ingestion)."""

    def __init__(self, sample: float = 1.0, *, max_spans: int = 8192,
                 slow_threshold_s: Optional[float] = None,
                 slow_log_path: Optional[str] = None,
                 max_slow: int = 64):
        self.sample = float(sample)
        self.slow_threshold_s = slow_threshold_s
        self.slow_log_path = slow_log_path
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)   # finished, as dicts
        self.slow_queries: deque = deque(maxlen=max_slow)
        self._n = 0              # sampling counter
        self.dropped = 0         # spans evicted from the bounded buffer

    # -- sampling ------------------------------------------------------------
    def sampled(self) -> bool:
        """Deterministic counter-based head sampling: over any window of
        N decisions, floor(N * sample) say yes — no RNG, reproducible."""
        if self.sample <= 0.0:
            return False
        if self.sample >= 1.0:
            return True
        with self._lock:
            self._n += 1
            n = self._n
        return int(n * self.sample) > int((n - 1) * self.sample)

    # -- span creation -------------------------------------------------------
    def start_span(self, name: str, *, parent: Optional[Span] = None,
                   trace_id: Optional[str] = None,
                   parent_id: Optional[str] = None,
                   annotations: Optional[dict] = None) -> Span:
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        elif trace_id is None:
            trace_id = _gen_id(8)
        return Span(self, name, trace_id, parent_id, annotations)

    def start_remote(self, name: str, ctx: dict,
                     annotations: Optional[dict] = None) -> Span:
        """Continue a trace that arrived over the wire: `ctx` is the
        {tid, sid} dict a T_SEARCH frame header carries."""
        return Span(self, name, str(ctx["tid"]), str(ctx["sid"]),
                    annotations)

    def context(self, sp: Span) -> dict:
        """The wire form of a span: what encode_query puts in the frame
        header for the worker to parent onto."""
        return dict(tid=sp.trace_id, sid=sp.span_id)

    # -- finished-span plumbing ----------------------------------------------
    def _on_end(self, sp: Span):
        d = sp.to_dict()
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(d)
        if self.slow_threshold_s is not None and sp.parent_id is None \
                and sp.duration_s >= self.slow_threshold_s:
            self._log_slow(d)

    def ingest(self, span_dicts: Sequence[dict]):
        """Adopt spans finished elsewhere (a worker's T_RESULT payload)
        into this tracer's buffer."""
        with self._lock:
            for d in span_dicts:
                if len(self._spans) == self._spans.maxlen:
                    self.dropped += 1
                self._spans.append(dict(d))

    def take(self, trace_id: str) -> List[dict]:
        """Pop every finished span of one trace — what a worker ships
        back in the result frame."""
        with self._lock:
            keep, out = [], []
            for d in self._spans:
                (out if d["trace_id"] == trace_id else keep).append(d)
            self._spans.clear()
            self._spans.extend(keep)
        return out

    def finished(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()

    # -- slow-query log ------------------------------------------------------
    def _log_slow(self, root: dict):
        tree = self.span_tree(root["trace_id"])
        entry = dict(trace_id=root["trace_id"], name=root["name"],
                     duration_s=root["duration_s"], t_start=root["t_start"],
                     tree=tree)
        self.slow_queries.append(entry)
        if self.slow_log_path:
            try:
                with open(self.slow_log_path, "a") as f:
                    f.write(json.dumps(entry) + "\n")
            except OSError:
                pass             # telemetry must never fail the query

    def span_tree(self, trace_id: str) -> List[dict]:
        """The trace's spans as a nested tree (children under
        "children"), roots first."""
        spans = [d for d in self.finished() if d["trace_id"] == trace_id]
        nodes = {d["span_id"]: dict(d, children=[]) for d in spans}
        roots = []
        for d in spans:
            node = nodes[d["span_id"]]
            parent = nodes.get(d["parent_id"]) if d["parent_id"] else None
            if parent is not None:
                parent["children"].append(node)
            else:
                roots.append(node)
        for n in nodes.values():
            n["children"].sort(key=lambda c: c["t_start"])
        roots.sort(key=lambda c: c["t_start"])
        return roots

    # -- exports -------------------------------------------------------------
    def export_chrome(self, path: Optional[str] = None,
                      trace_id: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing).  Each
        span becomes one complete ("X") event; ts/dur are microseconds
        on the wall clock so cross-process spans share a timeline."""
        spans = self.finished()
        if trace_id is not None:
            spans = [d for d in spans if d["trace_id"] == trace_id]
        events = []
        for d in spans:
            args = dict(d["annotations"])
            args["trace_id"] = d["trace_id"]
            args["span_id"] = d["span_id"]
            if d["parent_id"]:
                args["parent_id"] = d["parent_id"]
            events.append(dict(
                name=d["name"], ph="X", cat="repro",
                ts=d["t_start"] * 1e6, dur=max(d["duration_s"], 1e-7) * 1e6,
                pid=d["pid"], tid=d["tid"], args=args))
        doc = dict(traceEvents=events, displayTimeUnit="ms")
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc
