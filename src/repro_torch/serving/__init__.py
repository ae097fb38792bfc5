"""Serving layer (port of `repro.serving`): batching engine, warm-index
pool, multi-tenant service, and the multi-process cluster tier.

  engine   — `ServingEngine` (single-loop batching + hedging) and the
             `make_host_search_fn` / `make_device_search_fn` /
             `make_host_search_dist_fn` factories
  pool     — `WarmIndexPool`, the byte-budgeted LRU of open HostIndex
             handles with shared-centroid dedup and pin/unpin
  service  — `RetrievalService`, per-corpus queues + concurrent workers +
             admission control over a pool
  protocol — length-prefixed CRC-framed wire format (Unix sockets)
  cluster  — `ShardCluster`, a supervisor spawning one worker process
             per shard with heartbeats / backoff respawn / quarantine
  router   — `ShardRouter`, scatter-gather with partial-result
             degradation over `ShardClient` transports

`cluster` and `router` are not imported here: import them by module
(`repro_torch.serving.cluster`) where the process tier is wanted.
"""
from repro_torch.serving.engine import (Request, ServingEngine,
                                        exact_distances,
                                        make_device_search_fn,
                                        make_host_search_dist_fn,
                                        make_host_search_fn)
from repro_torch.serving.pool import CorpusUnhealthyError, WarmIndexPool
from repro_torch.serving.service import (BackpressureError,
                                         RetrievalService,
                                         ServiceClosedError)

__all__ = ["Request", "ServingEngine", "make_device_search_fn",
           "make_host_search_fn", "make_host_search_dist_fn",
           "exact_distances", "WarmIndexPool", "BackpressureError",
           "CorpusUnhealthyError", "ServiceClosedError",
           "RetrievalService"]

