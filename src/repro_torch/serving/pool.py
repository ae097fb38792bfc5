"""Warm-index pool: a byte-budgeted LRU of OPEN `HostIndex` handles (port
of `repro.serving.pool`; its handles search on the pool's `device`).

The paper's headline serving claim (§2.2, §4.4) is that ~10 MB-resident
AiSAQ indices make it cheap to hold *many* corpora warm simultaneously —
the RAG-retriever scenario.  The pool is that layer:

  * every open handle is charged for the DRAM it actually holds — the
    algorithmic residency (`HostIndex.resident_bytes`, paper Table 2) plus
    its block-cache capacity — and an LRU walk evicts (closes) the
    least-recently-used unpinned handle once the byte budget overflows,
  * indices built with the same PQ centroids (hash match in meta.json) are
    deduplicated: one centroid array is shared by every open handle and
    charged ONCE — the paper's Table-4 shared-centroid trick, promoted
    from "fast switch" to "cheap co-residency",
  * in-flight searches pin their handle (refcounted) so eviction can never
    close an index mid-read; a pinned-over-budget pool overflows rather
    than deadlocks and reports it (`budget_overflow`),
  * hit / miss / eviction / shared-centroid counters feed `stats()`,
  * per-corpus HEALTH: consecutive I/O failures (reported by the serving
    layer via `record_io_failure`) quarantine a corpus — `admit` then
    fails fast with `CorpusUnhealthyError` instead of queueing doomed
    work — and a half-open probe (one admitted request after the
    cooldown) recovers it; each failed probe doubles the cooldown up to
    a cap.  The state machine is the classic circuit breaker:
    healthy -> quarantined -> probing -> healthy | quarantined.

`IndexManager` (core.index_switch) is now a thin compat wrapper over a
budget-for-one pool (`max_open=1`).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.index_io import HostIndex
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.metrics import MetricsRegistry, SearchMetrics


class CorpusUnhealthyError(RuntimeError):
    """Raised by `WarmIndexPool.admit` (and so by `RetrievalService
    .submit`) for a quarantined corpus — fail fast instead of queueing
    work onto storage that keeps failing."""

    def __init__(self, corpus: str, state: str, retry_in_s: float):
        super().__init__(
            f"corpus {corpus!r} is {state} after repeated I/O failures; "
            f"retry in ~{max(0.0, retry_in_s):.2f}s")
        self.corpus = corpus
        self.state = state
        self.retry_in_s = max(0.0, retry_in_s)


class _Health:
    """Per-corpus circuit-breaker state (pool lock held for all access)."""
    __slots__ = ("state", "consec_failures", "quarantines", "recoveries",
                 "cooldown_s", "until", "probe_at")

    def __init__(self, cooldown_s: float):
        self.state = "healthy"          # healthy | quarantined | probing
        self.consec_failures = 0
        self.quarantines = 0            # transitions INTO quarantined
        self.recoveries = 0             # successful half-open probes
        self.cooldown_s = cooldown_s
        self.until = 0.0                # monotonic time quarantine lifts
        self.probe_at = 0.0             # when the in-flight probe was armed


class _Entry:
    __slots__ = ("index", "pins", "cent_hash", "load_s")

    def __init__(self, index: HostIndex, cent_hash: Optional[int],
                 load_s: float):
        self.index = index
        self.pins = 0
        self.cent_hash = cent_hash   # None when the entry OWNS its centroids
        self.load_s = load_s


class WarmIndexPool:
    """LRU pool of open `HostIndex` handles under an explicit byte budget.

    `budget_bytes=None` means unbounded; `max_open` additionally caps the
    handle count (the budget-for-one compat mode).  `cache_bytes` is the
    per-handle block-cache budget passed to `HostIndex.load` and charged
    to the pool (an open handle's cache IS DRAM the pool holds).
    """

    def __init__(self, paths: Optional[Dict[str, str]] = None, *,
                 budget_bytes: Optional[int] = None,
                 max_open: Optional[int] = None,
                 mode: Optional[str] = None,
                 cache_bytes: int = 10 << 20,
                 strict: bool = False,
                 quarantine_after: int = 3,
                 quarantine_cooldown_s: float = 1.0,
                 quarantine_cooldown_max_s: float = 30.0,
                 probe_timeout_s: float = 10.0,
                 preadv_factory: Optional[Callable] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device: DeviceLike = None):
        # one registry per process side by default; a RetrievalService
        # built over this pool shares it, and every open handle gets a
        # SearchMetrics bundle into it (per-corpus traversal histograms)
        self.registry = registry or MetricsRegistry()
        self._h_load = self.registry.histogram(
            "pool_load_seconds",
            help="cold index open / swap load time", unit="seconds")
        self.paths: Dict[str, str] = dict(paths or {})
        self.budget_bytes = budget_bytes
        self.max_open = max_open
        self.mode = mode
        self.device = resolve_device(device)
        self.cache_bytes = int(cache_bytes)
        # health knobs: `quarantine_after` consecutive I/O failures open
        # the breaker; the cooldown doubles on every failed probe up to
        # the cap; a probe unresolved for `probe_timeout_s` (e.g. its
        # request expired unserved) is re-armed rather than wedging the
        # corpus in `probing` forever
        self.quarantine_after = int(quarantine_after)
        self.quarantine_cooldown_s = float(quarantine_cooldown_s)
        self.quarantine_cooldown_max_s = float(quarantine_cooldown_max_s)
        self.probe_timeout_s = float(probe_timeout_s)
        # preadv_factory(name) -> preadv hook (or None) per corpus: the
        # fault-injection seam for drills — each corpus's BlockCache reads
        # through its own injector
        self.preadv_factory = preadv_factory
        self._health: Dict[str, _Health] = {}
        # strict=True: `pin` BLOCKS until the budget genuinely fits instead
        # of overflowing past pinned handles — the DRAM cap becomes a hard
        # admission resource (a budget-for-one pool then truly serializes
        # cross-corpus serving, like the single-active IndexManager did).
        # Waiting only happens while someone holds a pin (progress is
        # guaranteed: pins are release-after-search); with no pins
        # outstanding the pool overflows rather than deadlocks.
        self.strict = strict
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        # centroid dedup pool: hash -> (array, set of corpus names using it)
        self._cents: Dict[int, Tuple[np.ndarray, set]] = {}
        self._sizes: Dict[str, int] = {}   # last known entry bytes per name
        self._loading: set = set()         # names with a load in flight
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.budget_overflow = 0     # evict walks that could not fit budget
        self.centroid_shares = 0     # loads that reused a pooled array
        self.strict_waits = 0        # strict-mode pin acquisitions that slept
        self.swaps = 0               # zero-downtime version switches
        # handles replaced by swap() while searches still pinned them:
        # they serve their in-flight readers to completion, then close.
        # Excluded from the LRU and the byte budget — a retired handle is
        # transient by construction (bounded by in-flight search latency).
        self._retired: List[Tuple[str, _Entry]] = []
        # post-crash journal recoveries performed at open time, by corpus
        # (the dynamic index's recovery stats; none without it)
        self._recoveries: Dict[str, dict] = {}

    # -- registration --------------------------------------------------------
    def register(self, name: str, path: str):
        with self._lock:
            self.paths[name] = path

    def _resolve(self, name: str) -> str:
        try:
            return self.paths[name]
        except KeyError:
            raise KeyError(
                f"unknown corpus {name!r}; known corpora: "
                f"{sorted(self.paths)}") from None

    # -- accounting ----------------------------------------------------------
    def _entry_bytes(self, e: _Entry) -> int:
        """DRAM charged to one handle: algorithmic residency plus its
        block-cache capacity.  Centroids in the dedup pool are charged once
        at pool level; an entry that OWNS a private centroid copy
        (share_centroids=False, or no hash in meta) is charged for it."""
        return e.index.resident_bytes(include_centroids=e.cent_hash is None) \
            + e.index.cache.capacity_bytes

    def used_bytes(self) -> int:
        with self._lock:
            total = sum(self._entry_bytes(e) for e in self._entries.values())
            total += sum(a.nbytes for a, _ in self._cents.values())
            return int(total)

    def entry_bytes(self, name: str) -> int:
        with self._lock:
            return self._entry_bytes(self._entries[name])

    def centroid_bytes(self) -> int:
        with self._lock:
            return int(sum(a.nbytes for a, _ in self._cents.values()))

    # -- open / evict --------------------------------------------------------
    def _peek_shared(self, path: str, share_centroids: bool):
        """Pooled centroid array matching `path`'s meta hash, or None.
        Unreadable/corrupt meta just skips sharing — the real load below
        raises the typed CorruptIndexError."""
        if not share_centroids:
            return None
        try:
            with open(os.path.join(path, "meta.json")) as f:
                peek_hash = json.load(f).get("centroids_hash")
        except (OSError, ValueError, AttributeError):
            peek_hash = None
        if peek_hash is None:
            return None
        with self._lock:
            if peek_hash in self._cents:
                return self._cents[peek_hash][0]
        return None

    def _load_handle(self, name: str, path: str, shared) -> HostIndex:
        """Open one index handle (called OUTSIDE the pool lock) on the
        pool's device.

        A directory carrying a non-empty write-ahead journal means the
        previous writer crashed mid-mutation; `HostIndex.load` refuses it
        with CorruptIndexError. Recovering it (and recording the outcome
        in `stats()["recoveries"]`) is the dynamic index's work, which the
        port does not carry yet, so `_recoveries` stays empty."""
        preadv = self.preadv_factory(name) if self.preadv_factory else None
        return HostIndex.load(path, mode=self.mode, shared_centroids=shared,
                              cache_bytes=self.cache_bytes, preadv=preadv,
                              device=self.device)

    def _acquire(self, name: str, share_centroids: bool, do_pin: bool
                 ) -> Tuple[HostIndex, float]:
        """Hit-or-load a handle.  The disk I/O of a cold load runs OUTSIDE
        the pool lock (guarded by an in-flight `_loading` claim) so one
        miss never stalls pins of already-warm corpora; concurrent callers
        of the SAME corpus wait for the in-flight load instead of
        duplicating it."""
        path = self._resolve(name)    # KeyError before any waiting
        with self._lock:
            waited = False
            while True:
                e = self._entries.get(name)
                if e is not None:
                    self._entries.move_to_end(name)
                    self.hits += 1
                    if do_pin:
                        e.pins += 1
                    return e.index, 0.0
                if name in self._loading:      # someone is loading it now
                    self._cond.wait(0.05)
                    continue
                if do_pin and self.strict \
                        and self._must_wait_for_budget(name):
                    waited = True
                    self._cond.wait(0.05)
                    continue
                self._loading.add(name)
                break
            if waited:
                self.strict_waits += 1
            self.misses += 1
        try:
            t0 = time.perf_counter()
            shared = self._peek_shared(path, share_centroids)
            idx = self._load_handle(name, path, shared)
            load_s = time.perf_counter() - t0
            self._h_load.observe(load_s)
            # per-corpus traversal histograms (hops, blocked vs compute,
            # batch latency): core.traversal feeds them when the handle
            # carries this bundle
            idx.metrics = SearchMetrics(self.registry, name)
        except BaseException:
            with self._lock:
                self._loading.discard(name)
                self._cond.notify_all()
            raise
        with self._lock:
            cent_hash = idx.meta.get("centroids_hash") \
                if share_centroids else None
            e = _Entry(idx, cent_hash, load_s)
            if shared is not None:
                self.centroid_shares += 1
            if cent_hash is not None:
                if cent_hash not in self._cents:
                    self._cents[cent_hash] = (idx.centroids, set())
                elif idx.centroids is not self._cents[cent_hash][0]:
                    # two concurrent cold loads of the same hash: the loser
                    # loaded a private copy before the winner published —
                    # swap to the pooled array so dedup identity AND the
                    # charged-once accounting stay true
                    idx.centroids = self._cents[cent_hash][0]
                    self.centroid_shares += 1
                self._cents[cent_hash][1].add(name)
            self._entries[name] = e
            self._entries.move_to_end(name)
            self._sizes[name] = self._entry_bytes(e)
            if do_pin:
                e.pins += 1
            self._evict_to_budget()
            self._loading.discard(name)
            self._cond.notify_all()
            return e.index, load_s

    def _close_entry(self, name: str, e: _Entry):
        if e.cent_hash is not None and e.cent_hash in self._cents:
            _, users = self._cents[e.cent_hash]
            cur = self._entries.get(name)
            # a swapped-in successor with the SAME centroid hash still
            # uses the pooled array under this corpus name: closing the
            # retired predecessor must not drop the name's membership
            if cur is None or cur is e or cur.cent_hash != e.cent_hash:
                users.discard(name)
            if not users:
                del self._cents[e.cent_hash]
        e.index.close()

    def _over_budget(self) -> bool:
        if self.max_open is not None and len(self._entries) > self.max_open:
            return True
        if self.budget_bytes is None:
            return False
        total = sum(self._entry_bytes(e) for e in self._entries.values())
        total += sum(a.nbytes for a, _ in self._cents.values())
        return total > self.budget_bytes

    def _evict_to_budget(self):
        while self._over_budget():
            # never evict the MRU entry: it is the handle the caller is
            # acquiring RIGHT NOW (possibly pre-pin) — closing it would
            # hand out a dead fd
            names = list(self._entries)
            victim = next((n for n in names[:-1]
                           if self._entries[n].pins == 0), None)
            if victim is None:           # everything evictable is pinned:
                self.budget_overflow += 1  # overflow, don't deadlock
                return
            e = self._entries.pop(victim)
            self._close_entry(victim, e)
            self.evictions += 1

    # -- public acquisition --------------------------------------------------
    def ensure(self, name: str, share_centroids: bool = True) -> float:
        """Open corpus `name` if not already warm.  Returns the load
        wall-time in seconds (0.0 on a pool hit) — the paper's switch-time
        metric."""
        return self._acquire(name, share_centroids, do_pin=False)[1]

    def _must_wait_for_budget(self, name: str) -> bool:
        """strict-mode admission predicate (lock held): would opening
        `name` — after evicting every unpinned handle — still overflow?
        Only meaningful to wait while a pin is outstanding (its release is
        what frees memory); otherwise overflowing is the only way to make
        progress."""
        pinned = [e for e in self._entries.values() if e.pins > 0]
        if not pinned:
            return False
        est = self._sizes.get(name)
        if est is None:
            known = [self._entry_bytes(e) for e in self._entries.values()]
            est = int(sum(known) / len(known)) if known else 0
        if self.max_open is not None and len(pinned) + 1 > self.max_open:
            return True
        if self.budget_bytes is None:
            return False
        keep = sum(self._entry_bytes(e) for e in pinned)
        keep += sum(a.nbytes for a, _ in self._cents.values())
        return keep + est > self.budget_bytes

    def pin(self, name: str, share_centroids: bool = True
            ) -> Tuple[HostIndex, float]:
        """Acquire a handle for an in-flight search: opens (or touches) the
        corpus and increments its pin count so eviction cannot close it.
        Returns (index, load_seconds) — load_seconds is 0.0 on a hit.
        In a `strict` pool a miss blocks until the budget can fit the new
        handle (see __init__)."""
        return self._acquire(name, share_centroids, do_pin=True)

    def unpin(self, name: str, index: Optional[HostIndex] = None):
        """Release one pin.  `index` identifies WHICH handle the pin was
        taken on: after a `swap`, a lease acquired on the old version must
        decrement the retired entry, not its successor under the same
        name.  `index=None` keeps the legacy name-keyed behavior (correct
        whenever no swap raced the lease)."""
        with self._lock:
            e = self._entries.get(name)
            if e is not None and (index is None or e.index is index):
                e.pins = max(0, e.pins - 1)
                if e.pins == 0:
                    self._evict_to_budget()  # deferred eviction possible
                self._cond.notify_all()  # strict waiters re-check budget
                return
            for i, (rname, re_) in enumerate(self._retired):
                if rname == name and (index is None
                                      or re_.index is index):
                    re_.pins = max(0, re_.pins - 1)
                    if re_.pins == 0:        # last reader drained: retire
                        del self._retired[i]
                        self._close_entry(rname, re_)
                    self._cond.notify_all()
                    return
            # neither live nor retired: evicted under overflow — no-op

    @contextmanager
    def lease(self, name: str, share_centroids: bool = True):
        """Context-managed pin: `with pool.lease(c) as (idx, load_s): ...`
        Unpins by handle identity, so a lease that straddles a `swap`
        releases the version it actually searched."""
        idx, load_s = self.pin(name, share_centroids)
        try:
            yield idx, load_s
        finally:
            self.unpin(name, index=idx)

    # -- zero-downtime version switch ----------------------------------------
    def swap(self, name: str, new_path: str,
             share_centroids: bool = True) -> float:
        """Atomically repoint corpus `name` at the index directory
        `new_path` (e.g. a freshly published compaction) with ZERO dropped
        or wrong-answer requests:

          * the new handle is loaded OUTSIDE the pool lock (searches on
            the old version keep running throughout),
          * under the lock the name is repointed — every lease acquired
            after this instant pins the new version,
          * the old handle is closed immediately if idle, else parked on
            the retired list where in-flight leases drain it (identity-
            keyed `unpin` closes it with the last reader).

        Returns the new handle's load wall-time in seconds.  If `name`
        was not warm this is just `register` + cold `ensure`."""
        with self._lock:
            # wait out any in-flight cold load of the same name: two
            # handles for one name must serialize through _loading
            while name in self._loading:
                self._cond.wait(0.05)
            self._loading.add(name)
            self.paths[name] = new_path
        try:
            t0 = time.perf_counter()
            shared = self._peek_shared(new_path, share_centroids)
            idx = self._load_handle(name, new_path, shared)
            load_s = time.perf_counter() - t0
            self._h_load.observe(load_s)
            idx.metrics = SearchMetrics(self.registry, name)
        except BaseException:
            with self._lock:
                self._loading.discard(name)
                self._cond.notify_all()
            raise
        with self._lock:
            old = self._entries.pop(name, None)
            cent_hash = idx.meta.get("centroids_hash") \
                if share_centroids else None
            e = _Entry(idx, cent_hash, load_s)
            if shared is not None:
                self.centroid_shares += 1
            if cent_hash is not None:
                if cent_hash not in self._cents:
                    self._cents[cent_hash] = (idx.centroids, set())
                elif idx.centroids is not self._cents[cent_hash][0]:
                    idx.centroids = self._cents[cent_hash][0]
                    self.centroid_shares += 1
                self._cents[cent_hash][1].add(name)
            self._entries[name] = e
            self._entries.move_to_end(name)
            self._sizes[name] = self._entry_bytes(e)
            self.swaps += 1
            if old is not None:
                if old.pins == 0:
                    self._close_entry(name, old)
                else:
                    self._retired.append((name, old))
            self._evict_to_budget()
            self._loading.discard(name)
            self._cond.notify_all()
            return load_s

    def peek(self, name: str) -> Optional[HostIndex]:
        """The open handle for `name`, or None — no LRU touch, no load."""
        with self._lock:
            e = self._entries.get(name)
            return None if e is None else e.index

    def open_corpora(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def pinned(self, name: str) -> int:
        with self._lock:
            e = self._entries.get(name)
            return 0 if e is None else e.pins

    # -- per-corpus health (circuit breaker) ---------------------------------
    def _health_of(self, name: str) -> _Health:
        h = self._health.get(name)
        if h is None:
            h = self._health[name] = _Health(self.quarantine_cooldown_s)
        return h

    def admit(self, name: str):
        """Admission gate for new work on `name`.  Healthy corpora pass;
        a quarantined corpus whose cooldown has elapsed transitions to
        `probing` and admits THIS caller as the half-open probe; anything
        else raises CorpusUnhealthyError (fail fast, don't queue doomed
        work).  A probe left unresolved past `probe_timeout_s` (its
        request expired or was abandoned) is re-armed."""
        self._resolve(name)
        with self._lock:
            h = self._health.get(name)
            if h is None or h.state == "healthy":
                return
            now = time.monotonic()
            if h.state == "quarantined":
                if now >= h.until:
                    h.state = "probing"
                    h.probe_at = now
                    return               # this caller IS the probe
                raise CorpusUnhealthyError(name, "quarantined",
                                           h.until - now)
            # probing: one request is already out testing the waters
            if now - h.probe_at > self.probe_timeout_s:
                h.probe_at = now         # stale probe: re-arm with this one
                return
            raise CorpusUnhealthyError(
                name, "probing", self.probe_timeout_s - (now - h.probe_at))

    def record_io_failure(self, name: str):
        """An admitted request on `name` failed with an I/O error.  Opens
        the breaker after `quarantine_after` consecutive failures; a
        failing probe re-quarantines with a doubled cooldown."""
        with self._lock:
            h = self._health_of(name)
            h.consec_failures += 1
            now = time.monotonic()
            if h.state == "probing":
                # the half-open probe failed: back off harder
                h.cooldown_s = min(h.cooldown_s * 2.0,
                                   self.quarantine_cooldown_max_s)
                h.state = "quarantined"
                h.until = now + h.cooldown_s
                h.quarantines += 1
            elif h.state == "healthy" \
                    and h.consec_failures >= self.quarantine_after:
                h.state = "quarantined"
                h.until = now + h.cooldown_s
                h.quarantines += 1
            # already quarantined: stale in-flight failures change nothing

    def record_success(self, name: str):
        """An admitted request on `name` completed.  A successful probe
        closes the breaker (cooldown resets); successes that raced into a
        quarantine window are stale evidence and are ignored."""
        with self._lock:
            h = self._health.get(name)
            if h is None:
                return
            if h.state == "probing":
                h.state = "healthy"
                h.recoveries += 1
                h.cooldown_s = self.quarantine_cooldown_s
                h.consec_failures = 0
            elif h.state == "healthy":
                h.consec_failures = 0

    def health(self, name: str) -> dict:
        """Health snapshot for one corpus (fresh corpora are healthy)."""
        with self._lock:
            h = self._health.get(name)
            if h is None:
                return dict(state="healthy", consec_failures=0,
                            quarantines=0, recoveries=0)
            return dict(state=h.state,
                        consec_failures=h.consec_failures,
                        quarantines=h.quarantines,
                        recoveries=h.recoveries,
                        cooldown_s=h.cooldown_s)

    # -- stats / lifecycle ---------------------------------------------------
    def stats(self) -> dict:
        """One CONSISTENT snapshot of the pool, taken in a single pass
        under the pool lock.  Every per-handle figure (bytes charged,
        cache counters, pins) is read from ONE capture of the entry
        table, and each handle's counters come from one
        `CacheCounters.snapshot()` call — a `swap` racing this method
        sees either the old handle's report or the new one's, never a
        row mixing both, and a handle's counter row is internally
        coherent rather than attributes sampled at different instants."""
        with self._lock:
            entries = list(self._entries.items())
            cent_bytes = int(sum(a.nbytes for a, _ in self._cents.values()))
            used = cent_bytes
            caches = {}
            pinned = {}
            nav_bytes = {}
            for n, e in entries:
                used += self._entry_bytes(e)
                if e.pins:
                    pinned[n] = e.pins
                # navigation-tier residency is part of resident_bytes and
                # hence of `used`; broken out so operators can see what
                # the pivot graph costs against the budget
                if getattr(e.index, "nav", None) is not None:
                    nav_bytes[n] = int(e.index.nav.resident_nbytes())
                cache = e.index.cache
                if cache is None:
                    continue
                # per-handle I/O-engine telemetry: each open handle's
                # block cache carries the pipelined-traversal counters
                # (demand vs background syscalls, speculation accounting,
                # the histogram-chosen readahead gap) — surfaced here so
                # a multi-tenant operator sees which corpus is I/O-bound
                (hits, misses, _evic, syscalls, _bytes, _fetch,
                 _pf_issued, pf_syscalls, _pf_bytes, pf_hits, pf_wasted,
                 pf_errors, auto_gap, retries, crc_mm, crc_rr) = \
                    cache.counters.snapshot()
                total = hits + misses
                caches[n] = dict(
                    hit_rate=float(hits) / total if total else 0.0,
                    demand_syscalls=syscalls,
                    prefetch_syscalls=pf_syscalls,
                    prefetch_hits=pf_hits,
                    prefetch_wasted=pf_wasted,
                    prefetch_errors=pf_errors,
                    auto_gap=auto_gap,
                    read_retries=retries,
                    crc_mismatches=crc_mm,
                    crc_rereads=crc_rr,
                )
                # CacheCounters -> registry: published at snapshot time
                # as gauges (the counters object stays the hot-path
                # store; the registry is the exposition surface)
                lbl = {"corpus": n}
                for g, v in (("cache_hit_rate", caches[n]["hit_rate"]),
                             ("cache_demand_syscalls", syscalls),
                             ("cache_prefetch_syscalls", pf_syscalls),
                             ("cache_prefetch_hits", pf_hits),
                             ("cache_prefetch_wasted", pf_wasted),
                             ("cache_prefetch_errors", pf_errors),
                             ("cache_read_retries", retries),
                             ("cache_crc_mismatches", crc_mm)):
                    self.registry.gauge(g, lbl).set(v)
            for g, v in (("pool_open", len(entries)),
                         ("pool_hits", self.hits),
                         ("pool_misses", self.misses),
                         ("pool_evictions", self.evictions),
                         ("pool_swaps", self.swaps),
                         ("pool_used_bytes", used),
                         ("pool_nav_bytes", sum(nav_bytes.values())),
                         ("pool_retired", len(self._retired))):
                self.registry.gauge(g).set(v)
            return dict(
                open=len(entries),
                registered=len(self.paths),
                hits=self.hits,
                misses=self.misses,
                evictions=self.evictions,
                budget_overflow=self.budget_overflow,
                centroid_shares=self.centroid_shares,
                strict_waits=self.strict_waits,
                swaps=self.swaps,
                retired=len(self._retired),
                used_bytes=int(used),
                budget_bytes=self.budget_bytes,
                max_open=self.max_open,
                centroid_bytes=cent_bytes,
                nav_bytes=nav_bytes,
                nav_bytes_total=int(sum(nav_bytes.values())),
                pinned=pinned,
                caches=caches,
                health={n: dict(state=h.state,
                                consec_failures=h.consec_failures,
                                quarantines=h.quarantines,
                                recoveries=h.recoveries)
                        for n, h in self._health.items()},
                # journal recoveries performed at open time (see
                # _load_handle): corpus -> recovery stats
                recoveries={n: dict(r)
                            for n, r in self._recoveries.items()},
            )

    def close(self, timeout: float = 5.0):
        """Close every open handle.  Waits (bounded) for outstanding pins
        first — closing an fd under an in-flight search would turn the
        'pins protect readers' guarantee into an EBADF at teardown."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._loading \
                    or any(e.pins > 0 for e in self._entries.values()) \
                    or any(e.pins > 0 for _, e in self._retired):
                # in-flight loads must publish first, else their handle
                # would land in the pool (open fd) after close() returns
                left = deadline - time.monotonic()
                if left <= 0:
                    break                # give up: teardown wins
                self._cond.wait(min(left, 0.05))
            for name, e in list(self._entries.items()):
                self._close_entry(name, e)
            self._entries.clear()
            for name, e in self._retired:
                e.index.close()          # centroids pool is cleared below
            self._retired.clear()
            self._cents.clear()
