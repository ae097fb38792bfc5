"""Deterministic, seeded fault injection for the storage read path (copy
of `repro.core.faults`: the same seed draws the same schedule in both
packages).

The fault-tolerance layer (retrying reads, checksum rereads, traversal
degradation, corpus quarantine) is only testable if storage failures are
*reproducible*.  ``FaultInjector`` is a drop-in replacement for the
``os.preadv`` callable ``BlockCache`` uses: every read consults a seeded
schedule and may

  * raise a transient ``OSError`` (EIO or EAGAIN),
  * return a short read (fewer bytes than the buffers hold),
  * sleep (latency spike) before serving,
  * flip one bit in a served buffer (corruption — caught by the CRC
    layer, or silently wrong on an unchecksummed index).

Determinism discipline
----------------------
Faults are keyed by ``hash(seed, kind, offset, attempt)`` where
``attempt`` is a per-offset call counter.  Two properties follow:

  * a retry of the same offset is a NEW draw — so a schedule with
    ``eio_rate=r`` makes an n-attempt retry loop fail with probability
    ~``r^n``, exactly the behavior the retry layer is designed for, and
  * the schedule does not depend on wall clock or on global call order
    across offsets, so demand reads and background prefetch reads racing
    each other cannot change WHICH faults an offset sees, only when.

Persistent corruption is separate from the rate-based schedule:
``FaultPlan.corrupt_blocks`` maps a block index to how many reads of it
serve flipped bits (-1 = forever).  A finite count models a transiently
sick region that later heals — the substrate for quarantine-and-recover
drills.

Write-path crash injection
--------------------------
The write-side twin of the read schedule: ``KillSwitch`` is a
deterministic crash trigger the mutation path (``DynamicHostIndex`` +
``core.wal``) ticks at every durability-relevant write step — journal
frame halves, chunk pwrites, fsyncs, each atomic-flush stage.  Counting
mode (``at=None``) enumerates a workload's crash points; ``at=k`` raises
``CrashPoint`` at the k-th tick, freezing the on-storage state exactly
there.  The kill-at-every-offset drill replays a seeded workload once
per crash point and asserts recovery-on-load restores a consistent
index (``tests/test_torch_dynamic.py``, and ``chip_smoke.py``'s
``[crash_drill]`` on the card).
"""
from __future__ import annotations

import errno
import hashlib
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


class CrashPoint(Exception):
    """Raised by ``KillSwitch.tick`` to simulate a process crash at an
    exact point of the write path.  Deliberately an ``Exception`` (not
    BaseException): the mutation path must not swallow it, and the drill
    harness catches it at the workload boundary."""

    def __init__(self, label: str, op: int):
        super().__init__(f"injected crash at write op {op} ({label})")
        self.label = label
        self.op = op


class KillSwitch:
    """Deterministic crash trigger for the mutation path.

    Every durability-relevant write step calls ``tick(label)``.  With
    ``at=None`` the switch only counts (enumeration pass: ``count`` after
    a workload is the number of distinct crash points).  With ``at=k``
    the k-th tick raises ``CrashPoint`` exactly once — everything written
    before the tick stays on storage, nothing after it happens, which is
    precisely the state a power cut at that instant leaves behind."""

    def __init__(self, at: Optional[int] = None):
        self.at = at
        self.count = 0
        self.fired = False
        self.labels: list = []      # tick labels in order (enumeration aid)

    def tick(self, label: str):
        self.count += 1
        self.labels.append(label)
        if self.at is not None and not self.fired and self.count >= self.at:
            self.fired = True
            raise CrashPoint(label, self.count)


@dataclass
class FaultPlan:
    """Seeded fault schedule. All rates are per (offset, attempt) draw."""
    seed: int = 0
    eio_rate: float = 0.0           # transient EIO probability
    eagain_rate: float = 0.0        # transient EAGAIN probability
    short_read_rate: float = 0.0    # probability of returning a short read
    latency_rate: float = 0.0       # probability of a latency spike
    latency_s: float = 0.002        # spike duration
    #: block index -> number of reads served with one flipped bit
    #: (-1 = corrupted forever).  Block index = file_offset // io_bytes.
    corrupt_blocks: Dict[int, int] = field(default_factory=dict)
    #: stop injecting rate-based faults after this many (None = unlimited);
    #: lets a test script exact fault counts ("fail the first read only").
    max_faults: Optional[int] = None


class FaultInjector:
    """A ``preadv``-shaped callable wrapping ``os.preadv`` with the plan's
    deterministic fault schedule.  Pass ``injector.preadv`` (or the
    injector itself) as the BlockCache / HostIndex ``preadv`` hook."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._attempts: Dict[int, int] = {}       # offset -> reads so far
        self._corrupt_served: Dict[int, int] = {}  # block -> corrupt reads
        self.calls = 0
        self.injected_eio = 0
        self.injected_eagain = 0
        self.injected_short = 0
        self.injected_latency = 0
        self.injected_corrupt = 0

    def __call__(self, fd: int, bufs, offset: int) -> int:
        return self.preadv(fd, bufs, offset)

    # -- deterministic draws -------------------------------------------------
    def _u(self, kind: str, offset: int, attempt: int) -> float:
        h = hashlib.blake2b(
            f"{self.plan.seed}:{kind}:{offset}:{attempt}".encode(),
            digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def _budget_ok(self) -> bool:
        m = self.plan.max_faults
        if m is None:
            return True
        injected = (self.injected_eio + self.injected_eagain
                    + self.injected_short + self.injected_latency)
        return injected < m

    # -- the hook ------------------------------------------------------------
    def preadv(self, fd: int, bufs, offset: int) -> int:
        p = self.plan
        with self._lock:
            self.calls += 1
            attempt = self._attempts.get(offset, 0)
            self._attempts[offset] = attempt + 1
            budget = self._budget_ok()
            if budget and self._u("eio", offset, attempt) < p.eio_rate:
                self.injected_eio += 1
                raise OSError(errno.EIO,
                              f"injected transient EIO @ {offset}")
            if budget and self._u("eagain", offset, attempt) < p.eagain_rate:
                self.injected_eagain += 1
                raise OSError(errno.EAGAIN,
                              f"injected transient EAGAIN @ {offset}")
            spike = budget and \
                self._u("lat", offset, attempt) < p.latency_rate
            short = budget and \
                self._u("short", offset, attempt) < p.short_read_rate
            if spike:
                self.injected_latency += 1
            if short:
                self.injected_short += 1
        if spike:
            time.sleep(p.latency_s)
        got = os.preadv(fd, bufs, offset)
        io = len(bufs[0]) if bufs else 0
        if p.corrupt_blocks and io:
            with self._lock:
                for j, buf in enumerate(bufs):
                    blk = (offset + j * io) // io
                    limit = p.corrupt_blocks.get(blk)
                    if limit is None:
                        continue
                    served = self._corrupt_served.get(blk, 0)
                    if limit >= 0 and served >= limit:
                        continue        # healed: served its corrupt quota
                    pos = int(self._u("pos", blk, served) * io) % io
                    buf[pos] ^= 1 << (served % 8)
                    self._corrupt_served[blk] = served + 1
                    self.injected_corrupt += 1
        if short and got > io:
            # the buffers are fully populated, but a short return value
            # tells the caller the tail is garbage — a correct reader
            # must retry, an incorrect one silently consumes stale bytes
            return got - io
        return got

    def stats(self) -> dict:
        with self._lock:
            return dict(calls=self.calls,
                        injected_eio=self.injected_eio,
                        injected_eagain=self.injected_eagain,
                        injected_short=self.injected_short,
                        injected_latency=self.injected_latency,
                        injected_corrupt=self.injected_corrupt)


# ---------------------------------------------------------------------------
# process-level crash injection (the cluster tier's KillSwitch)
# ---------------------------------------------------------------------------


class ProcessKiller:
    """SIGKILL a chosen worker PROCESS at a deterministic tick.

    The cluster drill's twin of ``KillSwitch``: the drill loop calls
    ``tick()`` once per routed request, and at the ``at``-th tick the
    armed pid receives SIGKILL — no warning, no cleanup, exactly the
    failure a hardware fault or the OOM killer delivers.  ``arm`` takes
    a pid or a zero-arg callable resolving to one at fire time (the
    supervisor may have respawned the worker since arming, so the
    drill kills whoever owns the slot WHEN the tick lands).

    Thread-safe: concurrent router threads may tick; exactly one fires.
    """

    def __init__(self, at: Optional[int] = None,
                 sig: int = signal.SIGKILL):
        self.at = at
        self.sig = sig
        self.count = 0
        self.fired = False
        self.killed_pid: Optional[int] = None
        self._victim: Optional[Callable[[], Optional[int]]] = None
        self._lock = threading.Lock()

    def arm(self, victim) -> "ProcessKiller":
        """``victim``: a pid (int) or a zero-arg callable -> pid/None."""
        with self._lock:
            self._victim = victim if callable(victim) \
                else (lambda pid=int(victim): pid)
        return self

    def tick(self) -> bool:
        """Count one drill event; fire at the configured tick.  Returns
        True iff THIS call delivered the signal."""
        with self._lock:
            self.count += 1
            if (self.at is None or self.fired or self._victim is None
                    or self.count < self.at):
                return False
            self.fired = True
            pid = self._victim()
        if pid is None:
            return False
        try:
            os.kill(pid, self.sig)
        except ProcessLookupError:
            return False                 # already dead: the drill still ran
        self.killed_pid = pid
        return True


# ---------------------------------------------------------------------------
# socket-level fault shims (the wire's FaultInjector)
# ---------------------------------------------------------------------------


@dataclass
class SocketFaultPlan:
    """Deterministic fault schedule for one wrapped connection.  All
    rates are per-operation draws keyed by ``hash(seed, op, call#)`` —
    reconnecting resets the call counter, so a retry sees a fresh
    schedule exactly like ``FaultInjector``'s per-attempt draws."""
    seed: int = 0
    corrupt_rate: float = 0.0     # flip one bit in the bytes that flow
    drop_rate: float = 0.0        # sever the connection instead of serving
    delay_rate: float = 0.0       # sleep before serving
    delay_s: float = 0.002
    max_faults: Optional[int] = None


class FlakySocket:
    """Wraps a connected socket with the plan's deterministic faults.

    ``sendall``/``recv`` may (a) raise ``ConnectionResetError`` and close
    the underlying socket (severed wire), (b) flip one bit in the bytes
    that pass (the framed protocol's CRC must catch it), or (c) sleep
    (congestion).  Everything else proxies through, so the shim drops
    into ``serving.protocol`` helpers and router clients unchanged."""

    def __init__(self, sock, plan: SocketFaultPlan):
        self._sock = sock
        self.plan = plan
        self._calls = 0
        self._lock = threading.Lock()
        self.injected_corrupt = 0
        self.injected_drop = 0
        self.injected_delay = 0

    # -- deterministic draws -------------------------------------------------
    def _u(self, kind: str, call: int) -> float:
        h = hashlib.blake2b(
            f"{self.plan.seed}:{kind}:{call}".encode(),
            digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def _draw(self):
        """(corrupt, drop, delay) for this call, honoring max_faults."""
        p = self.plan
        with self._lock:
            call = self._calls
            self._calls += 1
            injected = (self.injected_corrupt + self.injected_drop
                        + self.injected_delay)
            if p.max_faults is not None and injected >= p.max_faults:
                return False, False, False
            corrupt = self._u("corrupt", call) < p.corrupt_rate
            drop = self._u("drop", call) < p.drop_rate
            delay = self._u("delay", call) < p.delay_rate
            self.injected_corrupt += corrupt
            self.injected_drop += drop
            self.injected_delay += delay
            return corrupt, drop, delay

    def _flip(self, data: bytes, call: int) -> bytes:
        if not data:
            return data
        pos = int(self._u("pos", call) * len(data)) % len(data)
        b = bytearray(data)
        b[pos] ^= 1 << (call % 8)
        return bytes(b)

    # -- the shimmed surface -------------------------------------------------
    def sendall(self, data: bytes):
        corrupt, drop, delay = self._draw()
        if delay:
            time.sleep(self.plan.delay_s)
        if drop:
            self._sock.close()
            raise ConnectionResetError(errno.ECONNRESET,
                                       "injected wire drop (send)")
        if corrupt:
            data = self._flip(data, self._calls)
        return self._sock.sendall(data)

    def recv(self, n: int) -> bytes:
        corrupt, drop, delay = self._draw()
        if delay:
            time.sleep(self.plan.delay_s)
        if drop:
            self._sock.close()
            raise ConnectionResetError(errno.ECONNRESET,
                                       "injected wire drop (recv)")
        data = self._sock.recv(n)
        if corrupt and data:
            data = self._flip(data, self._calls)
        return data

    def __getattr__(self, name):
        return getattr(self._sock, name)
