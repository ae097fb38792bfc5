"""The port's `DynamicHostIndex` (device="cpu": its searches run the plain
versions of the kernels) on the cases of the reference's
tests/test_dynamic.py, and against `repro.core.dynamic.DynamicHostIndex`
on the same directories (built by the reference's `build_index`).

Tolerances:
  * recovery: the reference's writer, killed at every tick of one insert
    and its flush, leaves a directory; the port's recovery of a copy
    writes chunks.bin, the .npy files, meta.json, tombstones.json and the
    CRC sidecar byte-equal to the reference's recovery of another copy;
  * inserts: with the candidate search fixed to the reference's ids (the
    two searches may order a near tie differently), the port's inserts
    write chunks.bin and wal.log byte-equal to the reference's, and after
    the flush every file; unpatched, they meet the reference test's bars
    (self-recall 10/12, recall@5 >= 0.7 over the grown set);
  * compaction of the same mutated directory: every file byte-equal;
  * the concurrent insert test runs the writer in its own thread and
    joins every thread with a timeout: it fails rather than hangs.
"""
import os
import shutil
import threading
import time

import numpy as np
import pytest

from repro.configs.base import IndexConfig
from repro.core import pq as rpq
from repro.core.build import build_index
from repro.core.dynamic import DynamicHostIndex as RefDynamic
from repro.core.faults import CrashPoint as RefCrash
from repro.core.faults import KillSwitch as RefKill
from repro.data.vectors import make_clustered, make_queries
from repro_torch.core.dynamic import (DynamicHostIndex, DynamicIndexError,
                                      _RWLock)
from repro_torch.core.faults import CrashPoint, KillSwitch
from repro_torch.core.index_io import CorruptIndexError, HostIndex
from repro_torch.core.traversal import recall_at

CPU = dict(device="cpu")


def _load(p, **kw):
    return DynamicHostIndex.load(p, device="cpu", **kw)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def dyn_built(tmp_path_factory):
    base = make_clustered(900, 48, seed=7)
    cfg = IndexConfig(name="dyn", n_vectors=700, dim=48, R=16, pq_m=12,
                      build_L=32)
    p = str(tmp_path_factory.mktemp("dyn") / "dyn")
    build_index(p, base[:700], cfg, mode="aisaq", seed=0)
    return p, base


@pytest.fixture()
def dyn_index(dyn_built, tmp_path):
    src, base = dyn_built
    p = str(tmp_path / "dyn")
    shutil.copytree(src, p)
    return p, base


@pytest.fixture(scope="module")
def small_built(tmp_path_factory):
    base = make_clustered(260, 16, seed=3)
    cfg = IndexConfig(name="small", n_vectors=200, dim=16, R=8, pq_m=8,
                      build_L=24)
    p = str(tmp_path_factory.mktemp("small") / "idx")
    build_index(p, base[:200], cfg, mode="aisaq", seed=0)
    return p, base


def _copy(small_built, tmp_path, name="work"):
    src, base = small_built
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst, base


# ---------------------------------------------------------------------------
# the reference's cases
# ---------------------------------------------------------------------------

def test_insert_makes_new_vectors_findable(dyn_index):
    p, base = dyn_index
    idx = _load(p)
    new_ids = [idx.insert(base[700 + i]) for i in range(60)]
    assert new_ids == list(range(700, 760))
    hits = 0
    for i in range(0, 60, 5):
        ids, _ = idx.search(base[700 + i].astype(np.float32), 1, L=48)
        hits += int(ids[0] == 700 + i)
    assert hits >= 10                     # >= 10/12 self-recall
    q = make_queries(10, base[:760], seed=9)
    gt = np.asarray(rpq.groundtruth(q, base[:760], 5))
    got = np.stack([idx.search(q[i], 5, L=48)[0] for i in range(10)])
    assert recall_at(got, gt, 5) >= 0.7
    idx.flush()
    idx.close()


def test_insert_survives_reload(dyn_index):
    p, base = dyn_index
    idx = _load(p)
    nid = idx.insert(base[700])
    idx.flush()
    idx.close()
    idx2 = _load(p)
    assert idx2.meta["n"] == 701
    ids, _ = idx2.search(base[700].astype(np.float32), 1, L=48)
    assert int(ids[0]) == nid
    idx2.close()


def test_delete_tombstones(dyn_index):
    p, base = dyn_index
    idx = _load(p)
    q = base[5].astype(np.float32)
    ids, _ = idx.search(q, 3, L=48)
    victim = int(ids[0])
    idx.delete(victim)
    ids2, _ = idx.search(q, 3, L=48)
    assert victim not in set(int(i) for i in ids2)
    assert len(ids2) == 3                 # widened search refills the pool
    idx.flush()
    idx.close()
    idx3 = _load(p)                       # tombstones persist
    ids4, _ = idx3.search(q, 3, L=48)
    assert victim not in set(int(i) for i in ids4)
    idx3.close()


def test_filtered_search(dyn_index):
    p, base = dyn_index
    idx = _load(p)
    ids, _ = idx.search(base[10].astype(np.float32), 5, L=48,
                        predicate=lambda i: i % 2 == 0)
    assert all(int(i) % 2 == 0 for i in ids)
    assert len(ids) == 5
    idx.close()


@pytest.mark.parametrize("path", ["batch", "ref", "predicate"])
def test_every_search_path_drops_tombstones(dyn_index, path):
    """`search_batch` and `search_ref` filter as `search` does (the
    reference filters in `search` only): no deleted label in any row, a
    thinned row refilled to k, each row the row `search` returns."""
    p, base = dyn_index
    idx = _load(p)
    Q = base[:12].astype(np.float32)
    first, _ = idx.search_batch(Q, 1, L=48)
    dead = set(int(i) for i in first[:, 0])
    for lab in dead:
        idx.delete(lab)
    pred = (lambda i: i % 3 != 0) if path == "predicate" else None
    if path == "ref":
        rows = [idx.search_ref(q, 5, L=48)[0] for q in Q]
    else:
        ids, stats = idx.search_batch(Q, 5, L=48, predicate=pred)
        assert ids.shape == (len(Q), 5) and len(stats) == len(Q)
        rows = list(ids)
    for q, row in zip(Q, rows):
        assert len(row) == 5 and (np.asarray(row) >= 0).all()
        assert not dead & set(int(i) for i in row)
        if pred is not None:
            assert all(pred(int(i)) for i in row)
        np.testing.assert_array_equal(row, idx.search(q, 5, L=48,
                                                      predicate=pred)[0])
    idx.close()


def test_load_rejects_non_aisaq_mode(tmp_path):
    base = make_clustered(120, 16, seed=5)
    cfg = IndexConfig(name="dk", n_vectors=120, dim=16, R=8, pq_m=8,
                      build_L=24)
    p = str(tmp_path / "dk")
    build_index(p, base, cfg, mode="diskann", seed=0)
    with pytest.raises(DynamicIndexError, match="aisaq"):
        _load(p)


def test_static_load_refuses_pending_journal(small_built, tmp_path):
    p, base = _copy(small_built, tmp_path)
    with open(os.path.join(p, "wal.log"), "wb") as f:
        f.write(b"\x01" * 7)             # garbage = torn unrecovered tail
    with pytest.raises(CorruptIndexError, match="journal"):
        HostIndex.load(p, **CPU)
    idx = _load(p)                       # recovers: truncates the tail
    assert idx.recovery["journaled"] == 0 and idx.recovery["torn"]
    idx.close()
    HostIndex.load(p, **CPU).close()     # and loads statically again


def test_insert_is_journaled_and_commit_clears_nothing(small_built,
                                                       tmp_path):
    p, base = _copy(small_built, tmp_path)
    idx = _load(p)
    idx.insert(base[200])
    assert idx.wal.size > 0               # BEGIN + COMMIT until the flush
    idx.flush()
    assert idx.wal.size == 0
    idx.close()


def _drill_ticks(small_built, tmp_path, vec, kill_cls, load):
    """Ticks of one insert plus its flush (enumeration pass)."""
    p0, _ = _copy(small_built, tmp_path, "enum")
    ks = kill_cls()
    idx = load(p0, kill=ks)
    idx.insert(vec)
    idx.flush()
    idx.close()
    return ks.count


def _check_recovered(r, at, vec, committed):
    n = r.meta["n"]
    assert n in (200, 201), f"at={at}: n={n}"
    if committed:
        assert n == 201, f"at={at}: committed insert lost"
    for node in range(n):                 # every edge in range
        _, nbrs, _ = r._read_node(node)
        live = nbrs[nbrs >= 0]
        assert (live < n).all(), f"at={at}: dangling edge"
    ids, _ = r.search(vec.astype(np.float32), 3, L=24)
    assert len(ids) == 3
    if n == 201:                          # rolled forward: findable
        ids1, _ = r.search(vec.astype(np.float32), 1, L=24)
        assert int(ids1[0]) == 200, f"at={at}"
    assert r.cache.counters.crc_mismatches == 0
    assert r.wal.size == 0                # checkpointed


def test_recovery_after_kill_at_every_point(small_built, tmp_path):
    """Kill the port's writer at EVERY tick of one insert and its flush;
    each crash recovers to the pre- or post-insert state."""
    src, base = small_built
    vec = base[205]
    total = _drill_ticks(small_built, tmp_path, vec, KillSwitch, _load)
    assert total > 10
    for at in range(1, total + 1):
        d = str(tmp_path / f"k{at}")
        shutil.copytree(src, d)
        h = _load(d, kill=KillSwitch(at=at))
        committed = False
        try:
            h.insert(vec)
            committed = True
            h.flush()
        except CrashPoint:
            pass
        h.abandon()                       # nothing in RAM survives
        r = _load(d)                      # recovery runs here
        _check_recovered(r, at, vec, committed)
        r.close()
        shutil.rmtree(d)


def test_journaled_delete_survives_crash(small_built, tmp_path):
    p, base = _copy(small_built, tmp_path)
    idx = _load(p)
    idx.delete(7)
    idx.abandon()                         # crash before any flush
    r = _load(p)
    assert 7 in r.tombstones
    ids, _ = r.search(base[7].astype(np.float32), 3, L=24)
    assert 7 not in set(int(i) for i in ids)
    r.close()


def test_flush_is_crash_atomic(small_built, tmp_path):
    src, base = small_built
    for stage in range(1, 7):             # flush has 6 tick points
        d = str(tmp_path / f"f{stage}")
        shutil.copytree(src, d)
        h = _load(d)
        h.insert(base[210])
        h.delete(3)
        h.kill = KillSwitch(at=stage)     # arm AFTER the insert
        with pytest.raises(CrashPoint):
            h.flush()
        h.abandon()
        r = _load(d)
        assert r.meta["n"] == 201
        assert 3 in r.tombstones
        ids, _ = r.search(base[210].astype(np.float32), 1, L=24)
        assert int(ids[0]) == 200
        assert r.wal.size == 0
        r.close()
        shutil.rmtree(d)


def test_compaction_reclaims_and_preserves_labels(small_built, tmp_path):
    p, base = _copy(small_built, tmp_path)
    idx = _load(p)
    new_labels = [idx.insert(base[200 + i]) for i in range(8)]
    assert new_labels == list(range(200, 208))
    idx.delete(5)
    idx.delete(new_labels[0])             # delete one old, one new
    dst = str(tmp_path / "v2")
    meta = idx.compact(dst, relabel=True)
    idx.close()
    assert meta["n"] == 200 + 8 - 2
    c = _load(dst)                        # compacted dirs stay dynamic
    assert c.meta["n"] == 206
    assert 5 not in set(int(l) for l in c.new_to_old)
    for i in (1, 3, 7):
        ids, _ = c.search(base[200 + i].astype(np.float32), 1, L=24)
        assert int(ids[0]) == 200 + i
    nxt = c.insert(base[220])
    assert nxt == 208                     # next_label survived compaction
    ids, _ = c.search(base[220].astype(np.float32), 1, L=24)
    assert int(ids[0]) == nxt
    c.flush()
    c.close()


def test_concurrent_search_during_insert(small_built, tmp_path):
    """Readers race the writer: no torn chunk, no out-of-range result, no
    CRC mismatch. The writer runs in its own thread and every thread is
    joined with a timeout, so a lock fault fails the test, not the run."""
    p, base = _copy(small_built, tmp_path)
    idx = _load(p)
    stop = threading.Event()
    errors = []
    q = make_queries(4, base[:200], seed=1).astype(np.float32)

    def reader():
        rng = np.random.default_rng(0)
        while not stop.is_set():
            try:
                n_snap = int(idx.meta["n"])
                ids, _ = idx.search(q[rng.integers(0, 4)], 5, L=24)
                for i in ids:
                    assert 0 <= int(i) < idx.n + 1, int(i)
                assert len(ids) == 5
                assert n_snap <= int(idx.meta["n"])
            except Exception as e:        # pragma: no cover - failure path
                errors.append(e)
                return

    def writer():
        try:
            for i in range(40):
                idx.insert(base[200 + (i % 50)])
        except Exception as e:            # pragma: no cover - failure path
            errors.append(e)

    readers = [threading.Thread(target=reader, daemon=True)
               for _ in range(3)]
    w = threading.Thread(target=writer, daemon=True)
    for t in readers:
        t.start()
    w.start()
    w.join(timeout=60)
    stop.set()
    for t in readers:
        t.join(timeout=10)
    hung = [t for t in readers + [w] if t.is_alive()]
    assert not hung, f"{len(hung)} threads did not finish (lock fault?)"
    assert not errors, errors[0]
    assert idx.cache.counters.crc_mismatches == 0
    assert idx.meta["n"] == 240
    idx.flush()
    idx.close()
    r = _load(p)
    assert r.recovery["journaled"] == 0
    ids, _ = r.search(base[201].astype(np.float32), 1, L=24)
    assert len(ids) == 1
    r.close()


# ---------------------------------------------------------------------------
# the lock: re-entrant reads, writer priority for new readers
# ---------------------------------------------------------------------------

def _wait_for(cond, timeout=2.0):
    t_end = time.monotonic() + timeout
    while not cond() and time.monotonic() < t_end:
        time.sleep(0.001)
    return cond()


def test_read_reenters_while_a_writer_waits():
    """read() inside read() on one thread returns while a writer waits
    (the reference's lock blocks here: the writer waits for this reader,
    which waits for the writer)."""
    lock = _RWLock()
    got = threading.Event()
    order = []

    def writer():
        with lock.write():
            order.append("w")

    def reader():
        with lock.read():
            t = threading.Thread(target=writer, daemon=True)
            t.start()
            assert _wait_for(lambda: lock._writers_waiting == 1)
            with lock.read():             # re-entry: must not wait
                got.set()
                order.append("r2")
        t.join(2.0)

    r = threading.Thread(target=reader, daemon=True)
    r.start()
    assert got.wait(2.0), "re-entrant read blocked behind a waiting writer"
    r.join(2.0)
    assert not r.is_alive()
    assert order == ["r2", "w"]


def test_search_gate_order_and_reentry():
    """The holder takes the gate again at once; the waiters enter one at a
    time, in the order they arrived, but a thread that asks to go ahead
    (an insert) enters after the first waiter only."""
    from repro_torch.core.traversal import SearchGate
    gate = SearchGate()
    order, inside = [], []
    release = threading.Event()

    def holder():
        with gate.hold():
            with gate.hold():             # re-entry: must not wait
                order.append("a2")
            release.wait(2.0)

    def waiter(name):
        with gate.hold(ahead=name == "e"):
            inside.append(name)
            order.append(name)
            assert len(inside) == 1
            inside.remove(name)

    threads = [threading.Thread(target=holder, daemon=True)]
    threads[0].start()
    assert _wait_for(lambda: order == ["a2"])
    for name in "bcde":
        threads.append(threading.Thread(target=waiter, args=(name,),
                                        daemon=True))
        threads[-1].start()
        want = len(threads) - 1           # every waiter so far queued
        assert _wait_for(lambda: len(gate._queue) == want)
    release.set()
    for t in threads:
        t.join(2.0)
    assert not any(t.is_alive() for t in threads)
    assert order == ["a2", "b", "e", "c", "d"]


def test_concurrent_searches_take_turns(small_built, tmp_path,
                                        monkeypatch):
    """Readers and an inserting writer on one index: never two searches
    in the engine at once, the readers search between the inserts, and
    every thread ends."""
    from repro_torch.core import traversal
    p, base = _copy(small_built, tmp_path)
    idx = _load(p)
    live, peak, seq = [0], [0], []
    real = traversal.search_batch

    def counted(*a, **kw):
        live[0] += 1
        peak[0] = max(peak[0], live[0])
        seq.append("w" if threading.current_thread() is w else "r")
        try:
            time.sleep(0.001)             # widen the window for overlap
            return real(*a, **kw)
        finally:
            live[0] -= 1

    monkeypatch.setattr(traversal, "search_batch", counted)
    stop = threading.Event()
    errors = []

    def reader(r):
        while not stop.is_set():
            try:
                idx.search(base[r], 5, L=24)
            except Exception as e:        # reported below
                errors.append(repr(e))
                return

    def writer():
        for i in range(4):
            idx.insert(base[200 + i])

    readers = [threading.Thread(target=reader, args=(r,), daemon=True)
               for r in range(3)]
    w = threading.Thread(target=writer, daemon=True)
    for t in readers:
        t.start()
    assert _wait_for(lambda: seq.count("r") >= 3, timeout=30.0)
    w.start()
    w.join(60.0)
    stop.set()
    for t in readers:
        t.join(10.0)
    assert not w.is_alive() and not any(t.is_alive() for t in readers)
    assert not errors, errors[:3]
    assert peak[0] == 1 and idx.n == 204
    order = "".join(seq)                  # e.g. rrrrwrwrwrwrrr
    gaps = order[order.index("w"):order.rindex("w") + 1].split("w")[1:-1]
    assert order.count("w") == 4 and all(gaps), order
    idx.close()


def test_writer_priority_holds_for_new_readers():
    lock = _RWLock()
    entered = threading.Event()
    release = threading.Event()

    def first_reader():
        with lock.read():
            release.wait(2.0)

    def writer():
        with lock.write():
            pass

    def new_reader():
        with lock.read():
            entered.set()

    threads = [threading.Thread(target=first_reader, daemon=True)]
    threads[0].start()
    assert _wait_for(lambda: lock._readers == 1)
    threads.append(threading.Thread(target=writer, daemon=True))
    threads[1].start()
    assert _wait_for(lambda: lock._writers_waiting == 1)
    threads.append(threading.Thread(target=new_reader, daemon=True))
    threads[2].start()
    assert not entered.wait(0.1), "a new reader overtook a waiting writer"
    release.set()
    assert entered.wait(2.0)
    for t in threads:
        t.join(2.0)
    assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("d,R,seed", [(16, 8, 0), (48, 16, 1),
                                      (128, 56, 2), (128, 56, 3)])
def test_vectorized_prune_equals_the_reference_loop(d, R, seed):
    """The l2 RobustPrune, one numpy pass over the pool per survivor,
    keeps the same ids in the same order as the reference's pair-by-pair
    loop (`_robust_prune_scalar`), with duplicate ids and exact ties in
    the pool."""
    from types import SimpleNamespace
    rng = np.random.default_rng(seed)
    h = DynamicHostIndex()
    h.meta, h.layout = {"metric": "l2"}, SimpleNamespace(R=R)
    for _ in range(20):
        n = int(rng.integers(1, 4 * R))
        pool = [int(x) for x in rng.integers(0, 3 * n, n)]   # duplicates
        vecs = {p: rng.standard_normal(d).astype(np.float32) for p in pool}
        twins = [p for p in vecs][:3]
        for a, b in zip(twins, twins[1:]):                   # exact ties
            vecs[b] = vecs[a].copy()
        anchor = rng.standard_normal(d).astype(np.float32)
        for alpha in (1.0, 1.2):
            assert h._robust_prune(anchor, pool, vecs, alpha) == \
                h._robust_prune_scalar(anchor, pool, vecs, alpha)


def test_insert_takes_the_write_lock_once(small_built, tmp_path):
    """One write-lock hold per insert (every chunk write inside it), so a
    stream of readers delays an insert by at most one search."""
    p, base = _copy(small_built, tmp_path)
    idx = _load(p)
    holds = []
    real = idx._rw.write

    def counting():
        holds.append(1)
        return real()

    idx._rw.write = counting
    for i in range(3):
        idx.insert(base[200 + i])
    assert len(holds) == 3
    idx.close()


# ---------------------------------------------------------------------------
# cross-checks with the reference's DynamicHostIndex
# ---------------------------------------------------------------------------

def test_recovery_byte_equal_to_reference_at_every_tick(small_built,
                                                        tmp_path):
    src, base = small_built
    vec = base[205]
    total = _drill_ticks(small_built, tmp_path, vec, RefKill,
                         RefDynamic.load)
    assert total > 10
    for at in range(1, total + 1):
        crashed = str(tmp_path / f"c{at}")
        shutil.copytree(src, crashed)
        h = RefDynamic.load(crashed, kill=RefKill(at=at))
        committed = False
        try:
            h.insert(vec)
            committed = True
            h.flush()
        except RefCrash:
            pass
        h.abandon()
        mine, theirs = crashed + "_port", crashed + "_ref"
        shutil.copytree(crashed, mine)
        shutil.copytree(crashed, theirs)
        r_ref = RefDynamic.load(theirs)
        r_port = _load(mine)
        assert r_port.recovery == r_ref.recovery, f"at={at}"
        _check_recovered(r_port, at, vec, committed)
        r_ref.close(), r_port.close()
        want, got = _files(theirs), _files(mine)
        assert sorted(got) == sorted(want), f"at={at}"
        for f in want:
            assert got[f] == want[f], f"at={at}: {f} differs"
        for d in (crashed, mine, theirs):
            shutil.rmtree(d)


def _reference_candidates(ref, vec, L):
    """The internal ids the reference's insert would take as candidates."""
    ids, _ = ref.search(vec.astype(np.float32), k=min(L, 16), L=L)
    return [ref._to_internal(int(i)) for i in ids]


def _mutate_both(dyn_built, tmp_path, n_ins, deletes=()):
    """The same inserts (and deletes) through both packages on two copies
    of one directory, the port's candidate search fixed to the
    reference's ids. Returns the two (still open) handles."""
    src, base = dyn_built
    pr, pp = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, pr)
    shutil.copytree(src, pp)
    ref, port = RefDynamic.load(pr), _load(pp)
    for i in range(n_ins):
        vec = base[700 + i]
        cand = _reference_candidates(ref, vec, 48)
        port._candidates = lambda v, L, c=cand: c
        assert port.insert(vec) == ref.insert(vec)
    for lab in deletes:
        ref.delete(lab)
        port.delete(lab)
    return ref, port


def test_inserts_byte_equal_given_reference_candidates(dyn_built, tmp_path):
    ref, port = _mutate_both(dyn_built, tmp_path, 24, deletes=(3, 705))
    for f in ("chunks.bin", "wal.log"):    # before the flush
        assert open(os.path.join(port.path, f), "rb").read() == \
            open(os.path.join(ref.path, f), "rb").read(), f
    ref.flush(), port.flush()
    ref.close(), port.close()
    want, got = _files(ref.path), _files(port.path)
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f"{f} differs after the flush"


@pytest.mark.parametrize("relabel", [True, False])
def test_compaction_byte_equal_to_reference(dyn_built, tmp_path, relabel):
    ref, port = _mutate_both(dyn_built, tmp_path, 12,
                             deletes=(2, 40, 700, 711))
    ref.flush(), port.flush()
    mr = ref.compact(str(tmp_path / "c_ref"), relabel=relabel)
    mp = port.compact(str(tmp_path / "c_port"), relabel=relabel)
    ref.close(), port.close()
    assert mp == mr
    want, got = _files(str(tmp_path / "c_ref")), \
        _files(str(tmp_path / "c_port"))
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f"{f} differs"
