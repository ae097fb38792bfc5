"""Dynamic index maintenance: crash-safe in-place insertion, tombstone
deletion, filtered search and compaction (port of `repro.core.dynamic`).

The paper's conclusion: "[near-zero load time] will enable LLMs with RAG to
employ more simple index addition or filter search algorithms." This module
implements exactly that enablement on the storage-backed index:

  * insert(vec): FreshDiskANN-style — greedy-search for neighbor candidates,
    RobustPrune, APPEND a new node chunk to chunks.bin, patch the reverse
    edges' chunks in place (pwrite). AiSAQ's inline codes mean patching a
    neighbor's chunk also writes the new node's PQ code into it — the
    placement invariant is preserved under mutation.
  * delete(label): tombstone — removed from results and from future
    traversal expansion targets; space reclaimed by ``compact``.
  * filtered search: per-query predicate over result labels — candidates
    failing the filter still ROUTE (graph stays navigable) but never enter
    the result list.
  * compact(dst): re-pack the live nodes (tombstone reclaim + optional
    graph-locality relabel) into a sibling version directory published
    with ``write_index``'s atomic recipe — the input to
    ``WarmIndexPool.swap``'s zero-downtime version switch.

Where the work runs
-------------------

Every search — the insert's candidate search, the readers' searches, the
searches over a compacted directory — is `HostIndex`'s: chunks through the
block cache on the host, each hop's arithmetic on the index's `device` (the
card unless the caller passes device="cpu"). The rest of an insert stays on
the host in numpy float32 and the stdlib, as in the reference: the PQ
encode of the new vector (`_encode`), the exact distances of the two
RobustPrune loops (`_dist`) and the chunk ``pread``/``pwrite``/
``fdatasync``. A torch argmin or a reordered sum could break a tie
differently, and the files an insert writes are the reference's byte for
byte given the same candidate pool.

Crash-safety: every mutation is journaled in ``core.wal`` BEFORE it
touches ``chunks.bin`` — an insert's intent record carries the new id, its
code, the chosen neighbors, and the PRE-IMAGES of every reverse-edge chunk
it will patch; a commit record lands only after the data writes are
fdatasynced. ``load`` recovers: the journal is scanned (truncated at the
first torn frame), the uncommitted tail insert is rolled back from its
pre-images, committed-but-unflushed inserts are rolled forward
(``meta["n"]``, pending codes, and labels re-derived), journaled deletes
re-applied, the CRC sidecar re-anchored, and a full durable flush
checkpoints the result and empties the journal. Every crash point lands on
a state equal to a pre- or post-insert oracle.

Concurrency: one writer (``insert``/``delete``/``flush``/``compact`` are
serialized by an internal mutex) and any number of searching readers. A
writer-priority RW lock makes each insert's chunk writes atomic with
respect to in-process readers (no torn chunk, no half-applied insert is
ever observed), and the traversal engine clamps neighbor ids to its
``meta["n"]`` snapshot. The reference takes the write lock once per chunk
write; a reader holds the read lock for a whole search, so under a steady
stream of searches each of an insert's up to R + 1 chunk writes waited for
an in-flight search. Here the insert computes its reverse-edge patches
first and writes every chunk under one hold: the bytes written and the
crash points are the reference's. Every public search takes the read
lock once (``search`` is ``search_batch`` of one query), and the read side
is re-entrant per thread besides: in the reference ``search`` holds it and
reaches the overridden ``search_batch``, which takes it again, and with
writer priority a writer waiting between the two blocks the reader that
blocks it (the reference's deadlock, `repro/core/dynamic.py:94-99`,
`:594`, `:609`).

Throughput: in one interpreter, threads that search (or insert) side by
side hand the GIL to each other at every call that drops it, and all run
slower than one thread alone (`core.traversal`, one search at a time). So
every search takes the process's search gate, in arrival order, before
the read lock, and an insert holds the gate from its candidate search to
its commit record, going ahead of all but the first waiting search: an
insert waits for one search, and between two inserts one search runs. The
read lock does not rely on the gate: it alone keeps readers from a torn
chunk.

Filtering: ``search``, ``search_batch`` and ``search_ref`` all drop
tombstoned labels (and those a ``predicate`` refuses), refilling a thinned
row by one wider search. The reference filters in ``search`` only
(`repro/core/dynamic.py:608-614`), so a pool or service over a dynamic
directory, which reaches ``search_batch``, would serve deleted labels.

Label discipline: a relabeled (graph-locality packed) directory stores
nodes in NEW-id space with an external-label map. Insertion appends the
new node at the tail and extends the label map; ``compact`` re-packs with
explicit labels (``write_index(labels=...)``) so external labels survive
tombstone reclaim and re-relabeling.
"""
from __future__ import annotations

import json
import os
import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Set

import numpy as np

from repro_torch.core import wal as _wal
from repro_torch.core.chunk_layout import B_NUM, parse_chunk
from repro_torch.core.index_io import (HostIndex, _atomic_json, _atomic_npy,
                                       write_index)
from repro_torch.core.integrity import CRC_SIDECAR, resolve_crc
from repro_torch.core.traversal import SEARCH_GATE

__all__ = ["DynamicHostIndex", "DynamicIndexError"]


class DynamicIndexError(RuntimeError):
    """A directory or argument unusable for dynamic (mutating) operation.
    Typed — never ``assert`` — so the refusal survives ``python -O``."""


class _RWLock:
    """Writer-priority readers-writer lock, re-entrant per thread.

    Readers (searches) hold it across a whole traversal; the writer holds
    it across an insert's chunk writes, so a reader can never observe a
    torn chunk or half an insert. Writer priority keeps a stream of NEW
    searches from starving the ingest path; a thread that already holds a
    read lock takes it again at once, even while a writer waits (the
    writer is waiting for that very reader)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self._held = threading.local()   # this thread's read .depth

    @contextmanager
    def read(self):
        depth = getattr(self._held, "depth", 0)
        if depth == 0:
            with self._cond:
                while self._writer or self._writers_waiting:
                    self._cond.wait()
                self._readers += 1
        self._held.depth = depth + 1
        try:
            yield
        finally:
            self._held.depth = depth
            if depth == 0:
                with self._cond:
                    self._readers -= 1
                    if not self._readers:
                        self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class DynamicHostIndex(HostIndex):
    """HostIndex + journaled insert/delete/compaction (aisaq mode)."""

    #: HostIndex.load refuses dirs with a pending journal; THIS loader is
    #: the one that knows how to recover them.
    _allows_wal = True

    @classmethod
    def load(cls, path: str, *, kill=None, wal_sync: bool = True,
             **kw) -> "DynamicHostIndex":
        """Open for mutation. Runs journal recovery if a previous writer
        crashed (see module docstring); the outcome lands in
        ``self.recovery`` (a stats dict; ``journaled == 0`` means clean).

        ``kill`` attaches a ``core.faults.KillSwitch`` to every subsequent
        durability-relevant write step (crash drills) — recovery itself
        always runs un-instrumented. ``wal_sync=False`` skips the
        per-record journal fdatasync (throughput knob: consistency is
        kept, the latest unsynced mutations may be lost on crash). The
        other keywords are `HostIndex.load`'s, ``device`` among them (None
        is the card, raising without one)."""
        self = super().load(path, **kw)  # type: ignore[misc]
        if self.meta["mode"] != "aisaq":
            self.close()
            raise DynamicIndexError(
                f"{path!r} is mode={self.meta['mode']!r}: dynamic ops need "
                "inline neighbor codes (aisaq mode) so reverse-edge "
                "patches can carry the new node's code")
        os.close(self.fd)
        self.fd = os.open(os.path.join(path, "chunks.bin"), os.O_RDWR)
        if self.cache is not None:
            self.cache.fd = self.fd      # cache must read via the new fd
        # lazy (mmap) code table for build-time neighbor-code fetches; new
        # codes accumulate in RAM until flush()
        self._codes_mm = np.load(os.path.join(path, "pq_codes.npy"),
                                 mmap_mode="r")
        self._new_codes: List[np.ndarray] = []
        self.n = int(self.meta["n"])
        tomb = os.path.join(path, "tombstones.json")
        if os.path.exists(tomb):
            with open(tomb) as f:
                self.tombstones: Set[int] = set(json.load(f))
        else:
            self.tombstones = set()
        if "next_label" in self.meta:
            self._next_label = int(self.meta["next_label"])
        elif self.new_to_old is None:
            self._next_label = self.n            # labels ARE ids
        else:
            self._next_label = int(self.new_to_old.max()) + 1 \
                if len(self.new_to_old) else 0
        self._label_to_int: Optional[Dict[int, int]] = None  # built lazily
        self._rw = _RWLock()
        self._mut = threading.Lock()      # serializes the mutation API
        self.kill = None                  # armed AFTER recovery
        self.wal = _wal.WriteAheadLog(
            os.path.join(path, _wal.WAL_NAME), sync=wal_sync)
        self.recovery = self._recover()
        self.wal.kill = kill
        self.kill = kill
        return self

    def _load_crc_sidecar(self, path, verify):
        """Sidecar load tolerant of a pending journal: recovery may have
        been interrupted after truncating chunks.bin but before rewriting
        the sidecar, so 'sidecar longer than the file' is a RECOVERABLE
        state here (the base loader treats it as a truncated chunks.bin
        and refuses). Recovery re-anchors every touched block before any
        search runs."""
        spath = os.path.join(path, CRC_SIDECAR)
        wpath = os.path.join(path, _wal.WAL_NAME)
        if verify is not False and os.path.exists(spath) \
                and os.path.exists(wpath) and os.path.getsize(wpath):
            block_crc = np.load(spath).astype(np.uint32)
            nblk = os.fstat(self.fd).st_size // self.layout.io_bytes
            return block_crc[:nblk], \
                resolve_crc(self.meta.get("crc_algo", "crc32"))
        return super()._load_crc_sidecar(path, verify)

    # -- crash injection ----------------------------------------------------
    def _tick(self, label: str):
        if self.kill is not None:
            self.kill.tick(label)

    # -- label mapping -------------------------------------------------------
    def _label_of(self, node: int) -> int:
        return int(node) if self.new_to_old is None \
            else int(self.new_to_old[node])

    def _to_internal(self, label: int) -> int:
        if self.new_to_old is None:
            return int(label)
        if self._label_to_int is None:
            self._label_to_int = {
                int(l): i for i, l in enumerate(self.new_to_old)}
        return self._label_to_int[int(label)]

    # -- helpers (host numpy, as in the reference) ---------------------------
    def _code_of(self, node: int) -> np.ndarray:
        base = self._codes_mm.shape[0]
        if node < base:
            return np.asarray(self._codes_mm[node])
        return self._new_codes[node - base]

    def _encode(self, vec: np.ndarray) -> np.ndarray:
        c = self.centroids                      # (m, ks, dsub)
        m, ks, dsub = c.shape
        sub = vec.astype(np.float32).reshape(m, 1, dsub)
        d = ((c - sub) ** 2).sum(-1)            # (m, ks)
        return d.argmin(-1).astype(np.uint8)

    def _read_node(self, node: int):
        lay = self.layout
        raw = os.pread(self.fd, lay.chunk_bytes, lay.file_offset(node))
        return parse_chunk(np.frombuffer(raw, np.uint8), lay)

    def _write_node(self, node: int, vec, nbr_ids: np.ndarray,
                    nbr_codes: np.ndarray):
        lay = self.layout
        chunk = np.zeros(lay.chunk_bytes, np.uint8)
        vb = vec.astype(np.uint8) if lay.data_dtype == "uint8" else \
            vec.astype(np.float32).view(np.uint8)
        chunk[:lay.b_full] = vb
        ids = np.full(lay.R, -1, np.int32)
        ids[:len(nbr_ids)] = nbr_ids
        deg = np.int32(len(nbr_ids))
        chunk[lay.off_deg:lay.off_deg + B_NUM] = \
            deg.reshape(1).view(np.uint8)
        chunk[lay.off_ids:lay.off_ids + lay.R * B_NUM] = ids.view(np.uint8)
        pq_block = np.zeros((lay.R, lay.pq_m), np.uint8)
        pq_block[:len(nbr_ids)] = nbr_codes
        chunk[lay.off_pq:lay.off_pq + lay.R * lay.pq_m] = pq_block.reshape(-1)
        off = lay.file_offset(node)
        payload = chunk.tobytes()
        # the caller holds the write lock, which makes the chunk write
        # atomic w.r.t. in-process readers: a search can observe the chunk
        # before or after the patch, never mid-pwrite (and never a
        # half-refreshed sidecar)
        # extend the file to a whole block if the node opens a new one
        end = off - off % lay.block_bytes + lay.io_bytes
        cur = os.fstat(self.fd).st_size
        if end > cur:
            os.pwrite(self.fd, b"\0" * (end - cur), cur)
        self._tick(f"chunk.pre.{node}")
        if self.kill is not None:
            # two-half write: the drill visits the torn-chunk state
            half = len(payload) // 2
            os.pwrite(self.fd, payload[:half], off)
            self._tick(f"chunk.mid.{node}")
            os.pwrite(self.fd, payload[half:], off + half)
        else:
            os.pwrite(self.fd, payload, off)
        self._tick(f"chunk.post.{node}")
        if self.cache is not None:   # in-place write: drop stale blocks
            self.cache.invalidate(off, lay.chunk_bytes)
            # re-anchor the checksum sidecar to the new on-storage
            # bytes (grows it when the append opened a new block) so
            # verified reads keep passing under mutation
            self.cache.refresh_crc(off, lay.chunk_bytes)

    def _dist(self, a: np.ndarray, b: np.ndarray) -> float:
        a, b = a.astype(np.float32), b.astype(np.float32)
        if self.meta["metric"] == "mips":
            return float(-(a @ b))
        return float(((a - b) ** 2).sum())

    def _robust_prune(self, anchor: np.ndarray, pool: list, vecs: dict,
                      alpha: float) -> list:
        """RobustPrune of `pool` (node ids, `vecs` their vectors) around
        `anchor`: at most R survivors, in order of distance.

        The reference's two loops, with each pass over the pool done as
        one numpy expression in l2: a row's ``((a - b) ** 2).sum(-1)`` is
        the same float32 sum as the reference's ``_dist`` of that pair
        (numpy reduces a contiguous row with the same pairwise routine),
        the stable argsort is ``sorted``'s order, and the alpha test runs
        in float64 on those float32 values as Python's float product
        does. Survival is tracked per node id, as the reference's dict
        does. mips keeps the scalar loop: a matrix-vector product does not
        promise the summation order of the reference's 1-D ``a @ b``."""
        if self.meta["metric"] == "mips":
            return self._robust_prune_scalar(anchor, pool, vecs, alpha)
        if not pool:
            return []
        ids = np.asarray(pool, np.int64)
        V = np.stack([np.asarray(vecs[p], np.float32) for p in pool])
        a = anchor.astype(np.float32)
        order = np.argsort(((V - a) ** 2).sum(-1), kind="stable")
        ids, V = ids[order], V[order]
        d_anchor = ((V - a) ** 2).sum(-1).astype(np.float64)
        uniq, uid = np.unique(ids, return_inverse=True)
        alive = np.ones(len(uniq), bool)
        keep: list = []
        for i in range(len(ids)):
            if len(keep) >= self.layout.R:
                break
            if not alive[uid[i]]:
                continue
            keep.append(int(ids[i]))
            d_pq = ((V - V[i]) ** 2).sum(-1).astype(np.float64)
            hit = alive[uid] & (ids != ids[i]) & (alpha * d_pq <= d_anchor)
            alive[uid[hit]] = False
        return keep

    def _robust_prune_scalar(self, anchor: np.ndarray, pool: list,
                             vecs: dict, alpha: float) -> list:
        """The reference's RobustPrune loop, pair by pair."""
        order = sorted(pool, key=lambda p: self._dist(anchor, vecs[p]))
        keep: list = []
        alive = dict.fromkeys(order, True)
        for p in order:
            if len(keep) >= self.layout.R:
                break
            if not alive[p]:
                continue
            keep.append(p)
            for q in order:
                if alive[q] and q != p and \
                        alpha * self._dist(vecs[p], vecs[q]) <= \
                        self._dist(anchor, vecs[q]):
                    alive[q] = False
        return keep

    # -- insertion -----------------------------------------------------------
    def insert(self, vec: np.ndarray, *, L: int = 48, alpha: float = 1.2
               ) -> int:
        """Add one vector; returns its LABEL (== node id on an unmapped
        dir). O(search + R chunk writes), journaled: a crash at any point
        either rolls the insert back completely or (after the commit
        record) preserves it completely."""
        # the search gate from the candidate search to the commit record:
        # no search runs beside the insert's host work (see the module
        # docstring), and the insert waits for one search at most
        with self._mut, SEARCH_GATE.hold(ahead=True):
            return self._insert_locked(np.asarray(vec), L, alpha)

    def _candidates(self, vec: np.ndarray, L: int) -> list:
        """Internal ids of the insert's candidate search (on `device`),
        in rank order."""
        ids, _ = self.search(vec.astype(np.float32), k=min(L, 16), L=L)
        return [self._to_internal(int(i)) for i in ids]

    def _insert_locked(self, vec: np.ndarray, L: int, alpha: float) -> int:
        lay = self.layout
        new_id = self.n
        label = self._next_label
        code = self._encode(vec)
        # candidate pool: the result list of a search for `vec` (labels
        # out -> internal ids), widened by one hop of neighbor expansion
        pool = list(dict.fromkeys(self._candidates(vec, L)))
        extra = []
        for p in pool:
            _, nbrs, _ = self._read_node(p)
            extra += [int(x) for x in nbrs[(nbrs >= 0) & (nbrs < self.n)]]
        pool = list(dict.fromkeys(pool + extra))[:4 * lay.R]
        pool = [p for p in pool
                if self._label_of(p) not in self.tombstones]
        vecs = {p: self._read_node(p)[0] for p in pool}
        chosen = self._robust_prune(vec, pool, vecs, alpha)
        nbr_codes = np.stack([self._code_of(p) for p in chosen]) if chosen \
            else np.zeros((0, lay.pq_m), np.uint8)
        # ---- journal the intent BEFORE any byte of chunks.bin changes ----
        # pre-images cover every chunk the reverse-edge pass MAY patch
        # (the chosen set); rollback restores them and the file size
        file_end = os.fstat(self.fd).st_size
        pre = b"".join(os.pread(self.fd, lay.chunk_bytes,
                                lay.file_offset(p)) for p in chosen)
        self.wal.append(_wal.T_INSERT_BEGIN, dict(
            id=new_id, label=label, n_before=self.n, file_end=file_end,
            chunk_bytes=lay.chunk_bytes,
            chosen=[int(p) for p in chosen]), code.tobytes() + pre)
        # reverse edges: each chosen neighbor's patched chunk, computed
        # before any chunk is written (the patches change no byte they
        # read: only the chosen chunks, and of those only edges and codes)
        patches = []
        for p in chosen:
            pvec, pids, pcodes = self._read_node(p)
            valid = pids[(pids >= 0) & (pids < new_id)]
            if len(valid) < lay.R:
                ids2 = np.concatenate([valid, [new_id]]).astype(np.int32)
                codes2 = np.concatenate(
                    [pcodes[:len(valid)], code[None]], axis=0)
            else:
                # over-degree: RobustPrune p's neighborhood ∪ {new}
                npool = [int(x) for x in valid] + [new_id]
                nvecs = {new_id: vec}
                for q in valid:
                    nvecs[int(q)] = self._read_node(int(q))[0]
                keep = self._robust_prune(pvec, npool, nvecs, alpha)
                ids2 = np.asarray(keep, np.int32)
                codes2 = np.stack([code if q == new_id else
                                   self._code_of(q) for q in keep])
            patches.append((p, pvec, ids2, codes2))
        # ---- data writes: one write-lock hold for the whole insert, so
        # readers wait for at most one in-flight search per insert (not
        # one per chunk) and see the graph before or after it ----
        with self._rw.write():
            self._write_node(new_id, vec, np.asarray(chosen, np.int32),
                             nbr_codes)
            self._new_codes.append(code)
            if self.new_to_old is not None:
                if self._label_to_int is not None:
                    self._label_to_int[label] = new_id
                self.new_to_old = np.append(self.new_to_old, label)
            self._next_label = label + 1
            self.n += 1
            self.meta["n"] = self.n
            for p, pvec, ids2, codes2 in patches:
                self._write_node(p, pvec, ids2, codes2)
        # ---- durability point: data synced, then the commit record ----
        self._tick("data.sync")
        os.fdatasync(self.fd)
        self.wal.append(_wal.T_INSERT_COMMIT, dict(id=new_id, label=label))
        return label

    # -- deletion ------------------------------------------------------------
    def delete(self, node: int):
        """Tombstone one LABEL. Journaled: the delete survives a crash
        without waiting for a flush."""
        with self._mut:
            self.wal.append(_wal.T_DELETE, dict(label=int(node)))
            self.tombstones.add(int(node))

    # -- flush (the journal checkpoint) --------------------------------------
    def flush(self):
        """Persist appended codes + labels + tombstones + sidecar + meta,
        then truncate the journal. Every file is rewritten atomically
        (tmp sibling + fsync + rename): a crash mid-flush leaves a
        loadable directory plus a journal that re-derives whatever the
        flush had not yet persisted."""
        with self._mut:
            self._flush_locked()

    def _flush_locked(self):
        self._tick("flush.codes")
        if self._new_codes:
            codes = np.concatenate(
                [np.asarray(self._codes_mm),
                 np.stack(self._new_codes)], axis=0)
            _atomic_npy(os.path.join(self.path, "pq_codes.npy"),
                        codes.astype(np.uint8))
            self._codes_mm = np.load(os.path.join(self.path, "pq_codes.npy"),
                                     mmap_mode="r")
            self._new_codes = []
        self._tick("flush.labels")
        if self.new_to_old is not None:
            # insertion extends the map beyond a permutation of range(n):
            # persist it directly (labels.npy supersedes the id_map branch)
            _atomic_npy(os.path.join(self.path, "labels.npy"),
                        np.asarray(self.new_to_old, np.int64))
            self.meta["label_map"] = "direct"
        self._tick("flush.tombstones")
        _atomic_json(os.path.join(self.path, "tombstones.json"),
                     sorted(self.tombstones))
        self._tick("flush.crc")
        if self.cache is not None and self.cache.block_crc is not None:
            # persist the mutation-refreshed checksums so a reload of the
            # grown chunks.bin verifies cleanly
            _atomic_npy(os.path.join(self.path, CRC_SIDECAR),
                        self.cache.block_crc)
        self._tick("flush.meta")
        self.meta["next_label"] = self._next_label
        _atomic_json(os.path.join(self.path, "meta.json"), self.meta)
        self._tick("flush.wal")
        self.wal.truncate(0)

    # -- journal recovery ----------------------------------------------------
    def _recover(self) -> dict:
        """Reconcile the directory with its journal (load time). Safe to
        crash at any point DURING recovery too: every step is idempotent
        and the journal is only truncated after the checkpoint flush."""
        records, valid_end, torn = self.wal.scan()
        stats = dict(journaled=len(records), torn=bool(torn),
                     truncated_bytes=0,
                     rolled_back=0, rolled_forward=0, deletes=0)
        if torn:
            # bytes of torn tail dropped from the journal — serving
            # telemetry (WarmIndexPool.stats()["recoveries"]) surfaces
            # this so operators see how much of a crash was unwound
            stats["truncated_bytes"] = max(0, self.wal.size - valid_end)
            self.wal.truncate(valid_end)
        if not records:
            return stats
        lay = self.layout
        committed = {r.header["id"] for r in records
                     if r.rtype == _wal.T_INSERT_COMMIT}
        begins = [r for r in records if r.rtype == _wal.T_INSERT_BEGIN]
        touched: Set[int] = set()        # node ids needing a CRC re-anchor
        # 1. roll the uncommitted tail back from its pre-images (newest
        # first: a later insert's pre-images embed earlier inserts' edges)
        for r in reversed(begins):
            h = r.header
            if h["id"] in committed:
                continue
            cb = int(h["chunk_bytes"])
            pre = r.blob[lay.pq_m:]
            for j, p in enumerate(h["chosen"]):
                img = pre[j * cb:(j + 1) * cb]
                if len(img) == cb:
                    os.pwrite(self.fd, img, lay.file_offset(p))
                    touched.add(int(p))
            os.ftruncate(self.fd, int(h["file_end"]))
            # the aborted node's chunk may live in a block the file
            # ALREADY covered (file_size is whole blocks): truncation
            # leaves its half-written bytes behind, disagreeing with the
            # flushed sidecar — zero the region and re-anchor it
            noff = lay.file_offset(int(h["id"]))
            if noff + cb <= int(h["file_end"]):
                os.pwrite(self.fd, b"\0" * cb, noff)
                touched.add(int(h["id"]))
            stats["rolled_back"] += 1
        # 2. roll committed-but-unflushed inserts forward. Reconciliation
        # is by-id so a partially completed flush (codes persisted, meta
        # not, or vice versa) replays as a set of no-ops:
        #   code pending  iff id >= rows(pq_codes.npy) + already-pending
        #   label pending iff id >= len(label map)
        #   n             = max(disk n, max committed id + 1)
        base = self._codes_mm.shape[0]
        for r in begins:
            h = r.header
            if h["id"] not in committed:
                continue
            nid = int(h["id"])
            if nid >= base + len(self._new_codes):
                self._new_codes.append(
                    np.frombuffer(r.blob[:lay.pq_m], np.uint8).copy())
            if self.new_to_old is not None \
                    and nid >= len(self.new_to_old):
                self.new_to_old = np.append(self.new_to_old,
                                            int(h["label"]))
            self.n = max(self.n, nid + 1)
            self._next_label = max(self._next_label, int(h["label"]) + 1)
            touched.add(nid)
            touched.update(int(p) for p in h["chosen"])
            stats["rolled_forward"] += 1
        # 3. journaled deletes (set union: idempotent vs tombstones.json)
        for r in records:
            if r.rtype == _wal.T_DELETE:
                self.tombstones.add(int(r.header["label"]))
                stats["deletes"] += 1
        self.meta["n"] = self.n
        # 4. re-anchor the CRC sidecar: the on-disk sidecar describes the
        # pre-crash flush; every chunk recovery restored or rolled forward
        # gets a fresh checksum, and entries past the (possibly truncated)
        # file end are trimmed
        if self.cache is not None:
            fsize = os.fstat(self.fd).st_size
            self.cache.trim_crc(fsize // lay.io_bytes)
            for p in sorted(touched):
                off = lay.file_offset(p)
                if off < fsize:
                    self.cache.invalidate(off, lay.chunk_bytes)
                    self.cache.refresh_crc(off, lay.chunk_bytes)
        # 5. checkpoint: one durable flush, then the journal is history
        self._flush_locked()
        return stats

    # -- compaction ----------------------------------------------------------
    def compact(self, dst: str, *, relabel: bool = True) -> dict:
        """Re-pack the live (un-tombstoned) nodes into a NEW index dir at
        ``dst``: tombstone reclaim, edge remap (edges into dead nodes are
        dropped), optional graph-locality relabel, external labels
        preserved via ``write_index(labels=...)``. The source directory
        is untouched; ``dst`` is published atomically — hand it to
        ``WarmIndexPool.swap`` for a zero-downtime version switch.
        Returns the new directory's meta dict."""
        with self._mut:
            lay = self.layout
            n = self.n
            labels = np.array([self._label_of(i) for i in range(n)],
                              np.int64)
            live = [i for i in range(n)
                    if int(labels[i]) not in self.tombstones]
            if not live:
                raise DynamicIndexError(
                    "compaction would produce an empty index "
                    "(every node is tombstoned)")
            old_to_new = {p: j for j, p in enumerate(live)}
            dt = np.uint8 if lay.data_dtype == "uint8" else np.float32
            vectors = np.empty((len(live), self.meta["dim"]), dt)
            graph = np.full((len(live), lay.R), -1, np.int32)
            codes = np.empty((len(live), lay.pq_m), np.uint8)
            for j, p in enumerate(live):
                vec, nbrs, _ = self._read_node(p)
                vectors[j] = vec
                codes[j] = self._code_of(p)
                kept = [old_to_new[int(x)] for x in nbrs
                        if 0 <= int(x) < n and int(x) in old_to_new]
                graph[j, :len(kept)] = kept
            return write_index(
                dst, vectors=vectors, graph=graph,
                centroids=self.centroids, codes=codes,
                metric=self.meta["metric"], mode=self.meta["mode"],
                block_bytes=self.meta["block_bytes"],
                n_ep=len(self.meta["entry_points"]),
                relabel=relabel, labels=labels[live],
                extra_meta=dict(next_label=self._next_label))

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        super().close()
        if getattr(self, "wal", None) is not None:
            self.wal.close()

    def abandon(self):
        """Drop the handle WITHOUT flushing — the crash-drill teardown
        (and the honest way to model a dead process: nothing in RAM
        survives, only what the journal and fdatasync made durable)."""
        if self.cache is not None:
            self.cache.stop()
            self.cache.clear()
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1
        if getattr(self, "wal", None) is not None:
            self.wal.close()

    # -- filtered + tombstone-aware search -----------------------------------
    def _live(self, ids, predicate) -> list:
        """The labels of `ids` that are neither padding nor tombstoned and
        that `predicate` (if any) accepts, in rank order."""
        drop = self.tombstones
        return [int(i) for i in ids if int(i) >= 0 and int(i) not in drop
                and (predicate is None or predicate(int(i)))]

    def search(self, q, k, L, w=4,
               predicate: Optional[Callable[[int], bool]] = None):
        """`HostIndex.search` without tombstoned labels and, with
        `predicate`, only labels it accepts; a thinned list is refilled by
        one wider search (k * 4 results, L at least 8 * k). Returns at
        most k labels."""
        ids, stats = self.search_batch(np.asarray(q)[None], k, L, w,
                                       predicate=predicate)
        return ids[0][ids[0] >= 0].astype(np.int64), stats[0]

    def search_batch(self, Q, k, L, w=4,
                     predicate: Optional[Callable[[int], bool]] = None,
                     **kw):
        """`HostIndex.search_batch` filtered as `search` filters, each row
        on its own: the rows a filter thinned below k are searched again,
        once, wider. Returns (ids (nq, k), -1 padded, [SearchStats])."""
        # the read lock pairs with the insert's write lock: no torn chunk;
        # the search gate comes first (see the module docstring)
        with SEARCH_GATE.hold(), self._rw.read():
            ids, stats = super().search_batch(Q, k, L, w, **kw)
            if not self.tombstones and predicate is None:
                return ids, stats
            out = np.full((len(ids), k), -1, ids.dtype)
            short = []
            for r, row in enumerate(ids):
                ok = self._live(row, predicate)
                out[r, :len(ok)] = ok
                if len(ok) < k:
                    short.append(r)
            if short:
                # widen once: tombstones/filters thin the pool
                ids2, s2 = super().search_batch(
                    np.asarray(Q)[short], k * 4, max(L, 2 * k * 4), w, **kw)
                for r, row, st in zip(short, ids2, s2):
                    ok = self._live(row, predicate)[:k]
                    out[r] = -1
                    out[r, :len(ok)] = ok
                    stats[r].ios += st.ios
                    stats[r].bytes_read += st.bytes_read
            return out, stats

    def search_ref(self, q, k, L, w=4,
                   predicate: Optional[Callable[[int], bool]] = None,
                   **kw):
        """The scalar oracle, filtered and widened as `search`."""
        with SEARCH_GATE.hold(), self._rw.read():
            ids, stats = super().search_ref(q, k, L, w, **kw)
            ok = self._live(ids, predicate)
            if len(ok) < k and (self.tombstones or predicate is not None):
                ids2, s2 = super().search_ref(q, k * 4, max(L, 2 * k * 4),
                                              w, **kw)
                stats.ios += s2.ios
                stats.bytes_read += s2.bytes_read
                ok = self._live(ids2, predicate)
            return np.asarray(ok[:k], np.int64), stats
