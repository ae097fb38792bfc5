"""Byte-budgeted LRU block cache + batched block I/O + async prefetch
(a copy of `repro.core.block_cache`: host memory and host I/O).

The paper's host tier reads one ``io_bytes`` unit (>= one 4 KiB LBA block)
per node expansion. The seed implementation paid one ``os.pread`` syscall
per *node*; this cache turns the per-hop frontier into ONE batched fetch:

  * cache hits are served from an LRU dict of resident blocks whose total
    size is capped by an explicit byte budget — the DRAM knob the disk-ANNS
    literature tunes (DiskANN++ hot-vertex caching; the paper's ~10 MB
    host budget made explicit),
  * cache misses are sorted, deduplicated, coalesced into contiguous runs,
    and each run is read with a single ``os.preadv`` — one syscall fills
    every block buffer of the run. ``gap`` > 0 additionally merges runs
    separated by up to that many absent blocks and reads the hole blocks
    along (readahead): with a graph-locality-relabeled layout the per-hop
    miss set is clustered, so a handful of gap-tolerant runs replaces
    dozens of exact ones, and the hole blocks land in the cache as
    speculative residents that later hops hit,
  * ``prefetch_async`` moves speculative next-hop reads off the demand
    path: a background thread reads queued blocks with the same coalesced
    preadv discipline and lands them in the LRU. A demand fetch that wants
    a block already *in flight* WAITS for the background read instead of
    duplicating it (condition-variable handoff — the double-buffer
    discipline), so every block is read from storage at most once.

Speculation is accounted honestly: ``prefetch_syscalls``/``prefetch_bytes``
count background I/O, ``prefetch_issued`` counts speculatively landed
blocks (background reads + readahead holes), ``prefetch_hits`` counts
those a demand fetch actually consumed, ``prefetch_wasted`` those evicted,
cleared, or invalidated unused. Counters feed ``SearchStats`` and the
bench_search report.

Storage fault tolerance: every raw read — demand, fallback, and
background — funnels through one ``_read_run`` that (a) retries
transient errors and short reads under a ``RetryPolicy`` with capped
exponential backoff, and (b) verifies each block against the per-block
CRC sidecar (``block_crc``) when the index carries one, with a
mismatch-triggers-one-reread policy before declaring the bytes corrupt
(``CorruptBlockError``).  The raw syscall is a pluggable ``preadv``
hook so ``core.faults.FaultInjector`` can drive a deterministic fault
schedule through the REAL read path.
"""
from __future__ import annotations

import errno
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from queue import Queue
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

import numpy as np

from repro_torch.obs import trace as obs_trace

from repro_torch.core.integrity import CorruptBlockError, _crc32

_PENDING_WAIT_S = 0.5       # bound on waiting for an in-flight prefetch
_AUTO_GAP_MAX = 8           # largest gap "auto" will ever pick
_AUTO_GAP_MIN_OBS = 8       # holes observed before "auto" trusts the data
_GAP_HIST_MAX = 64          # holes larger than this aren't coalescible


@dataclass(frozen=True)
class RetryPolicy:
    """Transient-error retry knob for every storage read the cache issues
    (demand AND background).  A read failing with a retryable errno — or
    returning fewer bytes than the run's buffers hold, which the
    block-multiple file format makes equally transient — is retried up to
    ``attempts`` total tries with capped exponential backoff.  The final
    failure propagates unchanged."""
    attempts: int = 3
    backoff_s: float = 0.002        # sleep before the first retry
    backoff_mult: float = 2.0
    backoff_max_s: float = 0.05
    retryable: Tuple[int, ...] = (errno.EIO, errno.EAGAIN, errno.EINTR,
                                  errno.ETIMEDOUT)


@dataclass
class CacheCounters:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    syscalls: int = 0        # demand-path preadv calls (block the search)
    bytes_read: int = 0      # demand-path bytes pulled from storage
    fetch_calls: int = 0     # batched fetch() invocations (one per hop)
    prefetch_issued: int = 0     # speculative blocks landed (async + holes)
    prefetch_syscalls: int = 0   # preadv calls issued off the demand path
    prefetch_bytes: int = 0      # bytes read off the demand path
    prefetch_hits: int = 0       # speculative blocks a demand fetch consumed
    prefetch_wasted: int = 0     # speculative blocks dropped unused
    prefetch_errors: int = 0     # background read batches that raised
    auto_gap: int = 0            # last gap chosen by fetch(gap="auto")
    read_retries: int = 0        # transient read failures absorbed by retry
    crc_mismatches: int = 0      # block reads whose checksum mismatched
    crc_rereads: int = 0         # policy rereads issued after a mismatch

    def snapshot(self) -> Tuple[int, ...]:
        return (self.hits, self.misses, self.evictions, self.syscalls,
                self.bytes_read, self.fetch_calls, self.prefetch_issued,
                self.prefetch_syscalls, self.prefetch_bytes,
                self.prefetch_hits, self.prefetch_wasted,
                self.prefetch_errors, self.auto_gap, self.read_retries,
                self.crc_mismatches, self.crc_rereads)

    def reset(self):
        """Zero every counter in place (phase boundaries in benchmarks)."""
        for f in self.__dataclass_fields__:
            setattr(self, f, 0)


class BlockCache:
    """LRU over fixed-size I/O units of one open file descriptor.

    capacity_bytes == 0 disables retention but keeps the batched coalesced
    read path (every fetch is a miss); the syscall batching win remains.
    All mutation of the resident set is guarded by one condition variable
    so the background prefetcher and the demand path compose safely.
    """

    def __init__(self, fd: int, io_bytes: int,
                 capacity_bytes: int = 10 << 20, *,
                 preadv: Optional[Callable] = None,
                 retry: Optional[RetryPolicy] = None,
                 block_crc: Optional[np.ndarray] = None,
                 crc: Optional[Callable] = None,
                 path: str = ""):
        self.fd = fd
        self.io_bytes = int(io_bytes)
        self.capacity_bytes = max(0, int(capacity_bytes))
        # the fault-tolerance hooks: `preadv` swaps the raw read syscall
        # (fault injection / alternative transports), `retry` bounds the
        # transient-error retry loop, `block_crc` (uint32 per io unit)
        # enables per-block verification of every demand and prefetch
        # read with a mismatch-triggers-one-reread policy
        self._preadv = preadv if preadv is not None else os.preadv
        self.retry = retry if retry is not None else RetryPolicy()
        self.block_crc = block_crc
        self._crc = crc if crc is not None else _crc32
        self._path = path               # error-message context only
        self.max_entries = self.capacity_bytes // self.io_bytes
        self._blocks: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.counters = CacheCounters()
        # demand-miss run structure, recorded on every fetch regardless of
        # the gap in use: lengths of contiguous miss runs and the hole
        # sizes separating consecutive runs (both in blocks).  gap="auto"
        # picks its coalescing gap from the hole distribution.
        self.miss_run_hist: Dict[int, int] = {}
        self.miss_gap_hist: Dict[int, int] = {}
        self._cond = threading.Condition()
        self._prefetched: Set[int] = set()   # resident but not yet demanded
        self._inflight: Set[int] = set()     # queued for background read
        self._pf_queue: Optional[Queue] = None
        self._pf_thread: Optional[threading.Thread] = None
        # invalidation epoch: bumped by invalidate()/clear().  A reader
        # snapshots it BEFORE its preadv and only inserts speculative
        # (hole) buffers if it is unchanged at landing time — hole blocks
        # have no _inflight claim token to cancel, so without this a
        # buffer read before an in-place chunk write could land stale
        # data in the cache after the write invalidated the range.
        self._epoch = 0

    # -- accounting ----------------------------------------------------------
    @property
    def used_bytes(self) -> int:
        return len(self._blocks) * self.io_bytes

    def hit_rate(self) -> float:
        """Demand-path hit rate; 0.0 (not NaN/ZeroDivisionError) when no
        fetch has happened yet."""
        c = self.counters
        total = c.hits + c.misses
        return float(c.hits) / total if total > 0 else 0.0

    def clear(self):
        with self._cond:
            self.counters.prefetch_wasted += len(self._prefetched)
            self._prefetched.clear()
            self._inflight.clear()           # in-flight reads land nowhere
            self._blocks.clear()
            self._epoch += 1                 # in-flight buffers are stale
            self._cond.notify_all()

    def invalidate(self, start: int, nbytes: int):
        """Drop any cached I/O unit overlapping [start, start+nbytes) —
        required after in-place chunk writes (dynamic index mutation).
        Handles ranges that straddle block boundaries: every block touched
        by ANY byte of the range is dropped, including the partial first
        and last blocks. nbytes <= 0 is a no-op. Pending prefetches of the
        range are cancelled so a stale in-flight read can never land."""
        if nbytes <= 0:
            return
        io = self.io_bytes
        first = start // io * io
        last = (start + nbytes - 1) // io * io
        with self._cond:
            for off in range(first, last + io, io):
                self._blocks.pop(off, None)
                self._inflight.discard(off)
                if off in self._prefetched:
                    self._prefetched.discard(off)
                    self.counters.prefetch_wasted += 1
            self._epoch += 1     # buffers read before this must not land
            self._cond.notify_all()

    # -- coalesced preadv ----------------------------------------------------
    def _iter_read_runs(self, offs: np.ndarray, gap: int):
        """Segment sorted unique block offsets into coalesced runs (runs
        separated by <= `gap` absent blocks are merged and the hole blocks
        read along) and yield, per ONE-preadv run:
        ({off: buf} for every block of the run, asked-offset set, bytes).
        The single copy of the run-segmentation algorithm — both the
        demand path (_read_runs) and the incremental background reader
        (_pf_read) drive it."""
        io = self.io_bytes
        span = (max(0, int(gap)) + 1) * io
        run_start = 0
        for i in range(1, offs.size + 1):
            if i < offs.size and offs[i] - offs[i - 1] <= span:
                continue
            lo, hi = int(offs[run_start]), int(offs[i - 1])
            nblk = (hi - lo) // io + 1
            bufs = [np.empty(io, np.uint8) for _ in range(nblk)]
            got = self._read_run(bufs, lo)
            yield ({lo + j * io: bufs[j] for j in range(nblk)},
                   set(offs[run_start:i].tolist()), int(got))
            run_start = i

    # -- fault-tolerant raw read (retry + verify) ---------------------------
    def _read_run(self, bufs: List[np.ndarray], lo: int) -> int:
        """One coalesced run read: retried preadv, then per-block checksum
        verification when the cache holds a CRC sidecar.  Every storage
        read — demand, fallback, and background — funnels through here."""
        got = self._preadv_retry(bufs, lo)
        if self.block_crc is not None:
            self._verify_run(bufs, lo)
        return got

    def _preadv_retry(self, bufs: List[np.ndarray], lo: int) -> int:
        """`self._preadv` with the RetryPolicy's capped exponential
        backoff.  A short read is treated as transient too: chunks.bin is
        always a whole multiple of io_bytes, so a run can never legally
        end mid-buffer."""
        pol = self.retry
        expect = len(bufs) * self.io_bytes
        delay = pol.backoff_s
        attempts = max(1, pol.attempts)
        for attempt in range(attempts):
            try:
                got = int(self._preadv(self.fd, bufs, lo))
                if got < expect:
                    raise OSError(
                        errno.EIO,
                        f"short read: {got}/{expect} bytes @ {lo}"
                        f"{' of ' + self._path if self._path else ''}")
                return got
            except OSError as e:
                if e.errno not in pol.retryable \
                        or attempt == attempts - 1:
                    raise
                self.counters.read_retries += 1
                time.sleep(delay)
                delay = min(delay * pol.backoff_mult, pol.backoff_max_s)
        raise AssertionError("unreachable")

    def _verify_run(self, bufs: List[np.ndarray], lo: int):
        """Check every block of a just-read run against the CRC sidecar.
        A mismatch triggers exactly ONE reread of that block (a transient
        in-flight corruption heals); a second mismatch means the bytes on
        storage are wrong -> CorruptBlockError (errno EIO)."""
        io = self.io_bytes
        crc = self.block_crc
        c = self.counters
        for j, buf in enumerate(bufs):
            off = lo + j * io
            bi = off // io
            if bi >= crc.shape[0]:
                continue        # block appended after the sidecar was cut
            want = int(crc[bi])
            if self._crc(buf) == want:
                continue
            c.crc_mismatches += 1
            c.crc_rereads += 1
            self._preadv_retry([buf], off)
            got = self._crc(buf)
            if got != want:
                raise CorruptBlockError(off, want, got, self._path)

    def refresh_crc(self, start: int, nbytes: int):
        """Recompute sidecar entries for every I/O unit overlapping
        [start, start+nbytes) after an in-place write (dynamic index
        mutation), growing the sidecar when an append opened new units.
        Reads raw bytes (no verification — the point is to re-anchor the
        checksums to what the write just put on storage)."""
        if self.block_crc is None or nbytes <= 0:
            return
        io = self.io_bytes
        first = start // io
        last = (start + nbytes - 1) // io
        with self._cond:
            if last >= self.block_crc.shape[0]:
                grown = np.zeros(last + 1, np.uint32)
                grown[:self.block_crc.shape[0]] = self.block_crc
                self.block_crc = grown
            buf = np.empty(io, np.uint8)
            for bi in range(first, last + 1):
                os.preadv(self.fd, [buf], bi * io)
                self.block_crc[bi] = self._crc(buf)

    def trim_crc(self, nblocks: int):
        """Shrink the CRC sidecar to `nblocks` entries after the backing
        file was truncated (crash-recovery rollback of an appended node):
        entries past the new end describe bytes that no longer exist and
        would poison `refresh_crc`'s growth arithmetic."""
        with self._cond:
            if self.block_crc is not None \
                    and nblocks < self.block_crc.shape[0]:
                self.block_crc = self.block_crc[:max(0, nblocks)].copy()

    def _read_runs(self, offs: np.ndarray, gap: int
                   ) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray],
                              int, int]:
        """preadv over sorted unique block offsets, one call per run.
        Returns (wanted off->buf, holes off->buf, syscalls, bytes)."""
        want: Dict[int, np.ndarray] = {}
        holes: Dict[int, np.ndarray] = {}
        n_sys = 0
        nbytes = 0
        for blocks, asked, got in self._iter_read_runs(offs, gap):
            n_sys += 1
            nbytes += got
            for o, buf in blocks.items():
                (want if o in asked else holes)[o] = buf
        return want, holes, n_sys, nbytes

    # -- readahead gap autotuning -------------------------------------------
    def _record_miss_runs(self, offs: np.ndarray):
        """Fold one fetch's sorted unique demand-miss offsets into the
        run-length / hole-size histograms (caller holds self._cond)."""
        if offs.size == 0:
            return
        steps = np.diff(offs) // self.io_bytes
        run = 1
        for step in steps.tolist():
            if step == 1:
                run += 1
                continue
            self.miss_run_hist[run] = self.miss_run_hist.get(run, 0) + 1
            hole = int(step) - 1
            if hole <= _GAP_HIST_MAX:
                self.miss_gap_hist[hole] = \
                    self.miss_gap_hist.get(hole, 0) + 1
            run = 1
        self.miss_run_hist[run] = self.miss_run_hist.get(run, 0) + 1

    def auto_gap(self) -> int:
        """Coalescing gap chosen from the observed demand-miss structure:
        the MEDIAN hole between consecutive miss runs, clamped to
        [0, _AUTO_GAP_MAX].  Rationale: merging a hole of g blocks costs g
        extra block reads but saves one syscall, so holes at or below the
        typical (median) size — the ones a graph-locality layout produces
        in bulk — are worth reading through, while a median beyond the
        clamp means the misses are genuinely scattered and coalescing
        would mostly read garbage (returns 0).  Needs
        ``_AUTO_GAP_MIN_OBS`` observed holes before trusting the data."""
        with self._cond:
            obs = sorted(self.miss_gap_hist.items())
        total = sum(c for _, c in obs)
        if total < _AUTO_GAP_MIN_OBS:
            return 0
        cum = 0
        for g, cnt in obs:
            cum += cnt
            if 2 * cum >= total:
                return g if g <= _AUTO_GAP_MAX else 0
        return 0

    # -- the batched demand fetch -------------------------------------------
    def fetch(self, offsets: np.ndarray, gap: Union[int, str] = 0,
              ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Fetch the I/O units starting at `offsets` (block-aligned, may
        repeat). Returns (data (B, io_bytes) uint8, hit mask over the
        *unique* offsets in first-appearance order, syscalls issued).

        A unique offset counts as a hit when it was served without demand
        I/O — resident, or landed by an in-flight background prefetch this
        fetch waited on. `gap` > 0 enables readahead coalescing of the
        miss runs (see class docstring); `gap="auto"` picks the gap from
        the demand-miss histograms (`auto_gap`) and reports the choice in
        ``counters.auto_gap``."""
        offsets = np.asarray(offsets, dtype=np.int64)
        c = self.counters
        c.fetch_calls += 1
        # read span: one per fetch when a query trace is active on this
        # thread (untraced traffic pays one thread-local read)
        _sp = obs_trace.begin("cache.fetch")
        if _sp is not None:
            try:
                return self._fetch_traced(_sp, offsets, gap)
            finally:
                _sp.end()
        return self._fetch_inner(offsets, gap)

    def _fetch_traced(self, sp, offsets, gap):
        out, hit_mask, n_sys = self._fetch_inner(offsets, gap)
        sp.annotate(blocks=int(offsets.size),
                    misses=int((~hit_mask).sum()), syscalls=int(n_sys),
                    bytes=int(offsets.size) * self.io_bytes)
        return out, hit_mask, n_sys

    def _fetch_inner(self, offsets: np.ndarray, gap: Union[int, str]
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
        c = self.counters
        uniq, first = np.unique(offsets, return_index=True)
        # first-appearance order (np.unique sorts; undo for caller attribution)
        order = np.argsort(first, kind="stable")
        uniq = uniq[order]
        local: Dict[int, np.ndarray] = {}
        pending: List[int] = []
        miss: List[int] = []
        with self._cond:
            for o in uniq.tolist():
                buf = self._blocks.get(o)
                if buf is not None:
                    self._blocks.move_to_end(o)
                    local[o] = buf
                    if o in self._prefetched:
                        self._prefetched.discard(o)
                        c.prefetch_hits += 1
                elif o in self._inflight:
                    pending.append(o)        # background read is coming
                else:
                    miss.append(o)
            # histogram over EVERY demanded non-resident block (pending
            # included): under the pipelined path most frontier blocks are
            # in flight at demand time, and recording only the leftovers
            # would teach gap="auto" from a biased scatter sample
            self._record_miss_runs(
                np.asarray(sorted(miss + pending), dtype=np.int64))
            epoch0 = self._epoch
        if gap == "auto":
            gap = self.auto_gap()
            c.auto_gap = gap
        want, holes, n_sys, nbytes = self._read_runs(
            np.asarray(sorted(miss), dtype=np.int64), gap)
        local.update(want)
        c.syscalls += n_sys
        c.bytes_read += nbytes
        # wait for in-flight prefetches instead of duplicating their I/O
        if pending:
            deadline = time.monotonic() + _PENDING_WAIT_S
            with self._cond:
                while True:
                    still = [o for o in pending if o not in local]
                    for o in still:
                        buf = self._blocks.get(o)
                        if buf is not None:
                            self._blocks.move_to_end(o)
                            local[o] = buf
                            if o in self._prefetched:
                                self._prefetched.discard(o)
                                c.prefetch_hits += 1
                    still = [o for o in pending if o not in local
                             and o in self._inflight]
                    if not still:
                        break
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._cond.wait(timeout=left):
                        break
            # cancelled (invalidate/clear/stop) or timed out: read directly
            fallback = np.asarray(sorted(o for o in pending
                                         if o not in local), dtype=np.int64)
            if fallback.size:
                fb, fb_holes, fb_sys, fb_bytes = self._read_runs(fallback, 0)
                local.update(fb)
                miss.extend(fallback.tolist())
                n_sys += fb_sys
                c.syscalls += fb_sys
                c.bytes_read += fb_bytes
        missed = set(miss)
        hit_mask = np.asarray([o not in missed for o in uniq.tolist()],
                              dtype=bool)
        c.hits += int(hit_mask.sum())
        c.misses += len(missed)
        # assemble BEFORE inserting: inserting misses may evict blocks this
        # very fetch still needs when the budget is smaller than the batch
        out = np.empty((offsets.size, self.io_bytes), np.uint8)
        for i, off in enumerate(offsets.tolist()):
            out[i] = local[off]
        with self._cond:
            # epoch gate: if invalidate()/clear() ran while our buffers
            # were in flight, they may hold pre-write bytes — return them
            # to the caller (it demanded the pre-write view) but never
            # RETAIN them past the invalidation
            fresh = self._epoch == epoch0
            for off in miss:
                self._inflight.discard(off)  # demand read beat the prefetch
                if fresh:
                    self._insert(off, local[off])
            # readahead holes: speculative insert (skipped entirely under
            # zero retention — an unretainable block is not speculation)
            if self.max_entries and fresh:
                for off, buf in holes.items():
                    # the demand read covered it: cancel any queued
                    # background read so storage sees each block once
                    self._inflight.discard(off)
                    if off not in self._blocks:
                        c.prefetch_issued += 1
                        self._prefetched.add(off)
                        self._insert(off, buf)
        return out, hit_mask, n_sys

    # -- async prefetch ------------------------------------------------------
    def prefetch_async(self, offsets: np.ndarray,
                       gap: Union[int, str] = 0) -> int:
        """Queue speculative background reads of block-aligned `offsets`.

        Already-resident and already-queued blocks are skipped; returns the
        number of blocks actually queued. No-op when retention is disabled
        (a zero-budget cache could never serve the prefetched block) and
        when a backlog of unprocessed batches exists (stale speculation is
        worse than none: it evicts useful residents).

        `gap` gives the background reader the same run-coalescing the
        demand path enjoys ("auto" resolves through `auto_gap`): fewer,
        larger preadv calls shrink the worker's time-to-land — which is
        exactly what a demand fetch waiting on an in-flight block pays."""
        if self.max_entries == 0:
            return 0
        if gap == "auto":
            gap = self.auto_gap()
            self.counters.auto_gap = gap
        gap = max(0, int(gap))
        if self._pf_queue is not None and self._pf_queue.qsize() > 2:
            return 0
        offsets = np.unique(np.asarray(offsets, dtype=np.int64))
        with self._cond:
            todo = [int(o) for o in offsets.tolist()
                    if o not in self._blocks and o not in self._inflight]
            self._inflight.update(todo)
        if not todo:
            return 0
        self._ensure_worker()
        # the gap travels WITH the batch: queued batches keep the knob
        # their caller set (no shared mutable state to race on)
        self._pf_queue.put((np.asarray(todo, dtype=np.int64), gap))
        return len(todo)

    def wait_prefetch(self):
        """Block until every queued prefetch batch has landed (used by
        tests and phase boundaries in benchmarks)."""
        if self._pf_queue is not None:
            self._pf_queue.join()

    def stop(self):
        """Join the background thread (idempotent; called by close())."""
        if self._pf_thread is not None and self._pf_thread.is_alive():
            self._pf_queue.put(None)
            self._pf_thread.join(timeout=10.0)
        self._pf_thread = None
        self._pf_queue = None
        with self._cond:
            self._inflight.clear()           # nothing can land any more
            self._cond.notify_all()

    def _ensure_worker(self):
        if self._pf_thread is None or not self._pf_thread.is_alive():
            self._pf_queue = Queue()
            self._pf_thread = threading.Thread(
                target=self._pf_loop, name="blockcache-prefetch", daemon=True)
            self._pf_thread.start()

    def _pf_loop(self):
        q = self._pf_queue
        while True:
            item = q.get()
            if item is None:
                q.task_done()
                return
            batch, gap = item
            try:
                self._pf_read(batch, gap)
            except Exception:       # noqa: BLE001 — a failing background
                # read must DEGRADE the pipeline, never deadlock it:
                # un-claim the batch so demand fetches stop waiting on
                # blocks that will never land and read them directly
                with self._cond:
                    self.counters.prefetch_errors += 1
                    for o in batch.tolist():
                        self._inflight.discard(int(o))
                    self._cond.notify_all()
            finally:
                q.task_done()

    def _pf_read(self, batch: np.ndarray, gap: int = 0):
        """Read one queued batch and land it INCREMENTALLY, run by run: a
        demand fetch waiting on an in-flight block wakes as soon as that
        block's run is read, not after the whole batch — the wait a
        pipelined traversal pays is one coalesced preadv, not ~a hop's
        worth of them."""
        with self._cond:                     # drop cancelled offsets cheaply
            offs = np.asarray(sorted(int(o) for o in batch.tolist()
                                     if o in self._inflight), dtype=np.int64)
            epoch0 = self._epoch
        if not offs.size:
            return
        for blocks, asked, got in self._iter_read_runs(offs, gap):
            with self._cond:
                c = self.counters
                c.prefetch_syscalls += 1
                c.prefetch_bytes += got
                # asked blocks carry an _inflight claim that invalidate()
                # cancels; HOLE blocks have no claim token, so they are
                # gated on the invalidation epoch instead — a hole buffer
                # read before an in-place write must never land after it
                fresh = self._epoch == epoch0
                epoch0 = self._epoch   # next run's preadv starts after this
                for o, buf in blocks.items():
                    if o in asked:
                        if o not in self._inflight:
                            continue         # invalidated/cleared mid-flight
                        self._inflight.discard(o)
                        if o in self._blocks:
                            continue         # a demand read got there first
                    elif not fresh or o in self._blocks \
                            or o in self._inflight:
                        continue             # stale/resident/claimed hole
                    c.prefetch_issued += 1
                    self._prefetched.add(o)
                    self._insert(o, buf)
                self._cond.notify_all()      # wake demand fetches waiting

    # -- LRU internals (caller holds self._cond) -----------------------------
    def _insert(self, off: int, buf: np.ndarray):
        if self.max_entries == 0:
            return
        if off in self._blocks:
            self._blocks.move_to_end(off)
            return
        while len(self._blocks) >= self.max_entries:
            old, _ = self._blocks.popitem(last=False)
            self.counters.evictions += 1
            if old in self._prefetched:
                self._prefetched.discard(old)
                self.counters.prefetch_wasted += 1
        self._blocks[off] = buf
