"""Low-overhead, thread-safe metrics registry: counters, gauges, and
fixed-bucket latency histograms with derived percentiles.

Design constraints, in order:

  * JAX-FREE AND NUMPY-FREE — this module sits on the `repro_torch.serving`
    import chain, which must stay lean so spawned cluster workers start
    in fractions of a second,
  * CHEAP ON THE HOT PATH — a call site holds the series handle
    (`Counter`/`Gauge`/`Histogram` object) and pays one small lock plus
    one bisect per observation; no string formatting, no dict lookups,
  * MERGEABLE ACROSS PROCESSES — `snapshot()` emits a plain JSON-safe
    dict, and `merge_snapshots` folds any number of them (counters and
    gauges sum, histogram buckets add elementwise) so the supervisor can
    present one cluster-wide view from per-worker T_STATS payloads.
    Merging is ASSOCIATIVE and COMMUTATIVE by construction — the
    property tests of `tests/test_obs.py` (reference) pin this,
  * TWO EXPOSITIONS — the snapshot dict itself (JSON) and a
    Prometheus-text rendering (`to_prometheus_text`) with cumulative
    `_bucket{le=...}` / `_sum` / `_count` histogram series.

Histogram percentiles use linear interpolation inside the containing
bucket (lower bound of the first bucket is 0, values past the last
finite bound clamp to it), which keeps `quantile(q)` monotone in `q`
and a pure function of the bucket counts — so percentiles derived from
a merged snapshot are exactly the percentiles of the merged histogram.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_LATENCY_BUCKETS_S", "COUNT_BUCKETS",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "bucket_quantile", "merge_snapshots", "to_prometheus_text",
    "SearchMetrics",
]

#: Default latency bucket upper bounds (seconds): 100 µs .. 10 s, roughly
#: geometric.  An implicit +inf overflow bucket always follows the last
#: finite bound.
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: Power-of-two-ish bounds for small-count histograms (hops, batch size).
COUNT_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter series.  `inc` only; read via `.value`."""

    __slots__ = ("labels", "_value", "_lock")
    kind = "counter"

    def __init__(self, labels: Dict[str, str]):
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _series(self) -> dict:
        return dict(labels=dict(self.labels), value=self._value)


class Gauge(Counter):
    """Point-in-time value series; `set` replaces, `inc` adjusts."""

    __slots__ = ()
    kind = "gauge"

    def set(self, value: float):
        with self._lock:
            self._value = float(value)


class Histogram:
    """Fixed-bucket histogram series with derived quantiles.

    Bucket i counts observations v with bounds[i-1] < v <= bounds[i]
    (Prometheus `le` semantics); one extra overflow bucket counts
    v > bounds[-1].
    """

    __slots__ = ("labels", "bounds", "counts", "sum", "count", "_lock")
    kind = "histogram"

    def __init__(self, labels: Dict[str, str],
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"bucket bounds must strictly increase: {bounds}")
        self.labels = labels
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float):
        i = bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            counts = list(self.counts)
        return bucket_quantile(self.bounds, counts, q)

    def _series(self) -> dict:
        with self._lock:
            counts = list(self.counts)
            s, n = self.sum, self.count
        out = dict(labels=dict(self.labels), bounds=list(self.bounds),
                   counts=counts, sum=s, count=n)
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            out[name] = bucket_quantile(self.bounds, counts, q)
        return out


def bucket_quantile(bounds: Sequence[float], counts: Sequence[int],
                    q: float) -> Optional[float]:
    """q-quantile of a bucketed distribution; None when empty.

    Linear interpolation inside the containing bucket (first bucket's
    lower bound is 0; the overflow bucket clamps to the last finite
    bound).  Monotone in q, pure in (bounds, counts) — merged snapshots
    recompute percentiles with this same function.
    """
    total = sum(counts)
    if total == 0:
        return None
    rank = max(q, 0.0) * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c > 0:
            if i >= len(bounds):            # overflow: clamp, no upper bound
                return float(bounds[-1])
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            frac = (rank - (cum - c)) / c
            return lo + (hi - lo) * frac
    return float(bounds[-1])


class MetricsRegistry:
    """Families of labeled series.  `counter/gauge/histogram` are
    idempotent: the same (name, labels) returns the same handle, so call
    sites fetch once at setup and then pay only the series update."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, help, unit, {label_key: series})
        self._families: Dict[str, list] = {}

    def _get(self, name: str, kind: str, labels, factory, help_: str,
             unit: str):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = [kind, help_, unit, {}]
            if fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} is a {fam[0]}, not a {kind}")
            series = fam[3].get(key)
            if series is None:
                series = fam[3][key] = factory(dict(key))
            return series

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                *, help: str = "", unit: str = "") -> Counter:
        return self._get(name, "counter", labels, Counter, help, unit)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              *, help: str = "", unit: str = "") -> Gauge:
        return self._get(name, "gauge", labels, Gauge, help, unit)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  *, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                  help: str = "", unit: str = "") -> Histogram:
        return self._get(name, "histogram", labels,
                         lambda lb: Histogram(lb, buckets), help, unit)

    # -- exposition ----------------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-safe dict of every family and series.  Histogram
        series carry raw bucket counts (mergeable) plus derived
        p50/p95/p99 (recomputed after any merge)."""
        with self._lock:
            fams = {n: (f[0], f[1], f[2], list(f[3].values()))
                    for n, f in self._families.items()}
        return {name: dict(type=kind, help=h, unit=u,
                           series=[s._series() for s in series])
                for name, (kind, h, u, series) in fams.items()}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def to_prometheus(self) -> str:
        return to_prometheus_text(self.snapshot())

    @staticmethod
    def merge_snapshots(snaps: Sequence[dict]) -> dict:
        return merge_snapshots(snaps)


def merge_snapshots(snaps: Sequence[dict]) -> dict:
    """Fold snapshot dicts into one cluster-wide view.

    Counters and gauges SUM across snapshots (a merged gauge is the
    cluster total — queue depths and open-handle counts add); histogram
    buckets add elementwise and percentiles are recomputed from the
    merged counts.  Associative and commutative.  Raises ValueError on
    a kind or bucket-bounds conflict — merging those would silently
    produce garbage.
    """
    out: dict = {}
    for snap in snaps:
        for name, fam in snap.items():
            dst = out.get(name)
            if dst is None:
                out[name] = dict(
                    type=fam["type"], help=fam.get("help", ""),
                    unit=fam.get("unit", ""),
                    series=[dict(s) for s in fam["series"]])
                continue
            if dst["type"] != fam["type"]:
                raise ValueError(
                    f"metric {name!r}: kind conflict "
                    f"{dst['type']!r} vs {fam['type']!r}")
            by_key = {_label_key(s["labels"]): s for s in dst["series"]}
            for s in fam["series"]:
                d = by_key.get(_label_key(s["labels"]))
                if d is None:
                    dst["series"].append(dict(s))
                    continue
                if fam["type"] == "histogram":
                    if list(d["bounds"]) != list(s["bounds"]):
                        raise ValueError(
                            f"metric {name!r}: bucket bounds conflict")
                    d["counts"] = [a + b for a, b
                                   in zip(d["counts"], s["counts"])]
                    d["sum"] = d["sum"] + s["sum"]
                    d["count"] = d["count"] + s["count"]
                else:
                    d["value"] = d["value"] + s["value"]
    for fam in out.values():
        if fam["type"] == "histogram":
            for s in fam["series"]:
                for pname, q in (("p50", .50), ("p95", .95), ("p99", .99)):
                    s[pname] = bucket_quantile(s["bounds"], s["counts"], q)
    return out


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def to_prometheus_text(snapshot: dict) -> str:
    """Prometheus text exposition of a snapshot (or merged snapshot)."""
    lines: List[str] = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for s in fam["series"]:
            if fam["type"] == "histogram":
                cum = 0
                for bound, c in zip(s["bounds"], s["counts"]):
                    cum += c
                    le = 'le="%s"' % bound
                    lines.append(
                        f"{name}_bucket{_fmt_labels(s['labels'], le)} {cum}")
                le_inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{_fmt_labels(s['labels'], le_inf)} "
                    f"{s['count']}")
                lines.append(
                    f"{name}_sum{_fmt_labels(s['labels'])} {s['sum']}")
                lines.append(
                    f"{name}_count{_fmt_labels(s['labels'])} {s['count']}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(s['labels'])} {s['value']}")
    return "\n".join(lines) + "\n"


def merged_quantile(hists: Sequence[Histogram], q: float) -> Optional[float]:
    """Quantile over several same-bounds histogram series combined —
    the all-corpora view `RetrievalService.stats()` reports."""
    hists = [h for h in hists if h.count]
    if not hists:
        return None
    bounds = hists[0].bounds
    counts = [0] * (len(bounds) + 1)
    for h in hists:
        if h.bounds != bounds:
            raise ValueError("cannot combine histograms with differing "
                             "bucket bounds")
        with h._lock:
            for i, c in enumerate(h.counts):
                counts[i] += c
    return bucket_quantile(bounds, counts, q)


class SearchMetrics:
    """The histogram bundle a `HostIndex` publishes per `search_batch`
    call — `SearchStats` distributions instead of means-only fields.
    `WarmIndexPool` attaches one per open handle (`index.metrics`);
    `core.traversal` feeds it when present, and skips a single attribute
    check when not."""

    __slots__ = ("latency", "hops", "conv_hops", "nav_hops", "ios",
                 "blocked", "compute")

    def __init__(self, registry: MetricsRegistry, corpus: str):
        lbl = {"corpus": corpus}
        self.latency = registry.histogram(
            "search_batch_latency_seconds", lbl,
            help="wall time of one search_batch call", unit="seconds")
        self.hops = registry.histogram(
            "traversal_hops", lbl, buckets=COUNT_BUCKETS,
            help="on-disk beam-traversal hops per query")
        self.conv_hops = registry.histogram(
            "traversal_convergence_hops", lbl, buckets=COUNT_BUCKETS,
            help="hops until the returned top-k stopped changing")
        self.nav_hops = registry.histogram(
            "nav_beam_hops", lbl, buckets=COUNT_BUCKETS,
            help="in-RAM navigation-tier beam hops per query "
                 "(only observed when the nav tier seeded the search)")
        self.ios = registry.histogram(
            "search_ios", lbl, buckets=COUNT_BUCKETS,
            help="I/O requests per query")
        self.blocked = registry.histogram(
            "search_blocked_wait_seconds", lbl,
            help="per-batch wall time blocked on storage reads",
            unit="seconds")
        self.compute = registry.histogram(
            "search_compute_seconds", lbl,
            help="per-batch wall time in LUT/ADC compute", unit="seconds")

    def observe_batch(self, stats: Sequence, wall_s: float,
                      blocked_s: float, compute_s: float):
        for s in stats:
            self.hops.observe(s.hops)
            self.conv_hops.observe(s.convergence_hop)
            if s.nav_dists > 0:
                self.nav_hops.observe(s.nav_hops)
            self.ios.observe(s.ios)
        self.latency.observe(wall_s)
        self.blocked.observe(blocked_s)
        self.compute.observe(compute_s)
