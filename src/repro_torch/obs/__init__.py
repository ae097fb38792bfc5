"""Observability substrate: metrics registry + cross-process tracing
(a copy of `repro.obs`).

Deliberately jax-free AND numpy-free — this package sits on the
`repro_torch.serving` import chain that spawned cluster workers pay at
startup, and on the `core.traversal`/`core.block_cache` hot path.

  metrics — thread-safe counters/gauges/fixed-bucket histograms with
            derived p50/p95/p99, labeled series, cross-process
            `merge_snapshots`, JSON + Prometheus-text exposition
  trace   — per-query span trees propagated router -> frame header ->
            worker -> traversal hops -> block-cache reads; Chrome
            trace-event export; sampling knob; slow-query log

See docs/observability.md for the metric tables and span hierarchy.
"""
from repro_torch.obs.metrics import (COUNT_BUCKETS, DEFAULT_LATENCY_BUCKETS_S,
                               Counter, Gauge, Histogram, MetricsRegistry,
                               SearchMetrics, bucket_quantile,
                               merge_snapshots, to_prometheus_text)
from repro_torch.obs.trace import (Span, Tracer, activate, current_span, enabled,
                             set_enabled, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SearchMetrics",
    "DEFAULT_LATENCY_BUCKETS_S", "COUNT_BUCKETS", "bucket_quantile",
    "merge_snapshots", "to_prometheus_text",
    "Span", "Tracer", "activate", "current_span", "span",
    "enabled", "set_enabled",
]
