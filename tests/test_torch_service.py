"""The port's `RetrievalService` over its `WarmIndexPool` (handles on
device="cpu") on the service cases of the reference's
tests/test_serving.py, the pool's journal-recovery case of
tests/test_pool.py, and the service's answers against the reference's
service on the same directories and queries.

Tolerance (as tests/test_torch_host_index.py; the reference sums in
numpy's pairwise order, the port in a fixed order): ids equal in >= 99%
of (query, rank) entries, every differing entry a near tie — the exact
distances of the two ids there within 1e-5 relative. Against the port's
own `HostIndex.search_batch` the service's answers are equal.
"""
import os
import shutil
import threading
import time

import numpy as np
import pytest

from repro.core import index_io as jio
from repro.core.vamana import build_vamana
from repro_torch.core.index_io import HostIndex
from repro_torch.core.wal import WAL_NAME
from repro_torch.serving.pool import WarmIndexPool
from repro_torch.serving.service import (BackpressureError,
                                         RetrievalService,
                                         ServiceClosedError)

CACHE = 256 << 10


@pytest.fixture(scope="module")
def service_dirs(tmp_path_factory, small_corpus, pq_artifacts):
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    root = tmp_path_factory.mktemp("tservice")
    paths = {}
    for i in range(2):
        sl = slice(i * 700, (i + 1) * 700)
        p = str(root / f"t{i}")
        jio.write_index(p, vectors=base[sl],
                        graph=build_vamana(base[sl], R=12, L=24, seed=i),
                        centroids=cents, codes=codes[sl], metric="l2",
                        mode="aisaq")
        paths[f"t{i}"] = p
    return paths


@pytest.fixture()
def service_pool(service_dirs):
    pool = WarmIndexPool(service_dirs, cache_bytes=CACHE, device="cpu")
    yield pool
    pool.close()


def test_retrieval_service_multicorpus_integration(service_pool,
                                                   small_corpus):
    base, q, _ = small_corpus
    refs = {}
    for name, path in service_pool.paths.items():
        idx = HostIndex.load(path, device="cpu")
        refs[name], _ = idx.search_batch(q, 5, L=24)
        idx.close()
    svc = RetrievalService(service_pool, num_workers=2, max_batch=4,
                           max_wait_ms=1.0, L=24)
    reqs = [(f"t{i % 2}", i % len(q),
             svc.submit(q[i % len(q)], corpus=f"t{i % 2}", k=5))
            for i in range(16)]
    for name, qi, r in reqs:
        assert r.event.wait(10.0)
        assert r.error is None and r.result is not None
        np.testing.assert_array_equal(r.result, refs[name][qi])
    st = svc.stats()
    assert st["total_completed"] == 16
    for name in ("t0", "t1"):
        c = st["corpora"][name]
        assert c["completed"] == 8 and c["switches"] == 1
        assert c["p99_ms"] >= c["p50_ms"] > 0
        assert c["qps"] > 0
    assert st["pool"]["misses"] == 2      # one load per corpus, ever
    svc.stop()


def test_service_corpora_serve_concurrently():
    """Two corpora, two workers, a slow search: the wall time is closer
    to ONE search than two."""
    delay = 0.3

    def slow_fn(idx, queries, k):
        time.sleep(delay)
        return np.tile(np.arange(k)[None], (queries.shape[0], 1))

    pool = WarmIndexPool({"a": "/nonexistent-a", "b": "/nonexistent-b"},
                         device="cpu")
    pool.pin = lambda name, share_centroids=True: (None, 0.0)  # no disk
    pool.unpin = lambda name, index=None: None
    svc = RetrievalService(pool, num_workers=2, max_wait_ms=1.0,
                           search_fn=slow_fn)
    t0 = time.perf_counter()
    ra = svc.submit(np.ones(4, np.float32), corpus="a", k=5)
    rb = svc.submit(np.ones(4, np.float32), corpus="b", k=5)
    assert ra.event.wait(5.0) and rb.event.wait(5.0)
    wall = time.perf_counter() - t0
    assert ra.result is not None and rb.result is not None
    assert wall < 1.8 * delay             # overlapped, not serialized
    svc.stop()


def test_service_admission_control_rejects(service_pool, small_corpus):
    _, q, _ = small_corpus

    def stall(idx, queries, k):
        time.sleep(0.2)
        return np.zeros((queries.shape[0], k), np.int64)

    svc = RetrievalService(service_pool, num_workers=1, max_queue_depth=2,
                           max_wait_ms=0.5, search_fn=stall)
    rejected = 0
    for _ in range(12):
        try:
            svc.submit(q[0], corpus="t0", k=5)
        except BackpressureError as e:
            rejected += 1
            assert e.corpus == "t0" and e.limit == 2
    assert rejected > 0
    assert svc.stats()["total_rejected"] == rejected
    assert svc.stats()["corpora"]["t0"]["rejected"] == rejected
    svc.stop()


def test_service_unknown_corpus_and_stop_drains(service_pool, small_corpus):
    _, q, _ = small_corpus
    svc = RetrievalService(service_pool, num_workers=1, max_wait_ms=0.5)
    with pytest.raises(KeyError, match="unknown corpus"):
        svc.submit(q[0], corpus="nope")
    svc.stop()
    with pytest.raises(RuntimeError):
        svc.submit(q[0], corpus="t0")


def test_service_submit_wait_timeout_raises(service_pool, small_corpus):
    _, q, _ = small_corpus

    def stall(idx, queries, k):
        time.sleep(0.5)
        return np.zeros((queries.shape[0], k), np.int64)

    svc = RetrievalService(service_pool, num_workers=1, max_wait_ms=0.5,
                           search_fn=stall)
    with pytest.raises(TimeoutError):
        svc.submit_wait(q[0], corpus="t0", timeout=0.05)
    svc.stop()


def test_service_close_drains_then_rejects_typed(service_pool,
                                                 small_corpus):
    _, q, _ = small_corpus

    def slowish(idx, queries, k):
        time.sleep(0.05)
        return np.tile(np.arange(k)[None], (queries.shape[0], 1))

    svc = RetrievalService(service_pool, num_workers=1, max_batch=2,
                           max_wait_ms=0.5, search_fn=slowish)
    reqs = [svc.submit(q[0], corpus="t0", k=5) for _ in range(6)]
    svc.close(drain_s=10.0)
    for r in reqs:                        # drained, not dropped
        assert r.event.is_set()
        assert r.error is None and r.result is not None
    with pytest.raises(ServiceClosedError):
        svc.submit(q[0], corpus="t0", k=5)
    assert issubclass(ServiceClosedError, RuntimeError)


def test_service_stop_fails_queued_with_typed_error(service_pool,
                                                    small_corpus):
    _, q, _ = small_corpus

    def stall(idx, queries, k):
        time.sleep(0.3)
        return np.zeros((queries.shape[0], k), np.int64)

    svc = RetrievalService(service_pool, num_workers=1, max_batch=1,
                           max_wait_ms=0.5, search_fn=stall)
    reqs = [svc.submit(q[0], corpus="t0", k=5) for _ in range(4)]
    svc.stop(timeout=1.0)
    failed = [r for r in reqs if r.error is not None]
    assert failed, "stop() left queued requests silently unresolved"
    for r in failed:
        assert isinstance(r.error, ServiceClosedError)


def test_service_stats_one_snapshot_with_pool(service_pool, small_corpus):
    _, q, _ = small_corpus
    svc = RetrievalService(service_pool, num_workers=2, max_wait_ms=0.5,
                           L=24)
    for i in range(8):
        svc.submit_wait(q[i % len(q)], corpus=f"t{i % 2}", k=5,
                        timeout=10.0)
    st = svc.stats()
    assert st["total_completed"] == sum(
        c["completed"] for c in st["corpora"].values()) == 8
    assert st["pool"]["recoveries"] == {}   # clean boot: empty map
    svc.stop()


def test_service_workers_share_one_device_safely(service_pool,
                                                 small_corpus):
    """Eight client threads against four workers and two corpora: every
    answer equals a direct `HostIndex.search_batch` of its query, so no
    per-search state leaks between concurrent searches."""
    _, q, _ = small_corpus
    refs = {}
    for name, path in service_pool.paths.items():
        idx = HostIndex.load(path, device="cpu")
        refs[name], _ = idx.search_batch(q, 10, L=32)
        idx.close()
    svc = RetrievalService(service_pool, num_workers=4, max_batch=8,
                           max_wait_ms=1.0, L=32)
    bad = []

    def client(c):
        for i in range(12):
            name, qi = f"t{(c + i) % 2}", (c * 5 + i) % len(q)
            r = svc.submit_wait(q[qi], corpus=name, k=10, timeout=30.0)
            if not np.array_equal(r.result, refs[name][qi]):
                bad.append((name, qi))

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not any(t.is_alive() for t in threads)
    assert not bad, bad[:5]
    assert svc.stats()["total_completed"] == 96
    svc.stop()


def test_pool_surfaces_journal_recovery_in_stats(service_dirs, tmp_path):
    """A corpus left with a non-empty journal opens through the dynamic
    index's recovery, which lands in stats()["recoveries"]."""
    crashed = str(tmp_path / "crashed")
    shutil.copytree(service_dirs["t0"], crashed)
    garbage = b"\xde\xad\xbe\xef" + b"\x00" * 33   # half a torn frame
    with open(os.path.join(crashed, WAL_NAME), "wb") as f:
        f.write(garbage)
    pool = WarmIndexPool({"crashed": crashed, "clean": service_dirs["t1"]},
                         cache_bytes=CACHE, device="cpu")
    pool.ensure("crashed")
    pool.ensure("clean")
    rec = pool.stats()["recoveries"]
    assert set(rec) == {"crashed"}          # clean corpora don't report
    assert rec["crashed"]["truncated_bytes"] == len(garbage)
    assert rec["crashed"]["rolled_back"] == 0
    assert rec["crashed"]["rolled_forward"] == 0
    assert os.path.getsize(os.path.join(crashed, WAL_NAME)) == 0
    assert pool.peek("crashed").device.type == "cpu"
    pool.close()


def test_pool_over_journaled_deletes_serves_no_tombstone(service_dirs,
                                                        small_corpus,
                                                        tmp_path):
    """A writer deletes labels and dies before its flush: the pool opens
    the directory through recovery (the deletes re-applied from the
    journal), and the service's answers hold no deleted label."""
    from repro_torch.core.dynamic import DynamicHostIndex
    _, q, _ = small_corpus
    crashed = str(tmp_path / "deleted")
    shutil.copytree(service_dirs["t0"], crashed)
    dyn = DynamicHostIndex.load(crashed, device="cpu")
    first, _ = dyn.search_batch(q[:8], 1, L=32)
    dead = set(int(i) for i in first[:, 0])
    for lab in dead:
        dyn.delete(lab)
    dyn.abandon()                           # no flush: only the journal
    pool = WarmIndexPool({"deleted": crashed}, cache_bytes=CACHE,
                         device="cpu")
    svc = RetrievalService(pool, num_workers=2, max_batch=4,
                           max_wait_ms=1.0, L=32)
    for i in range(8):
        r = svc.submit_wait(q[i], corpus="deleted", k=5, timeout=30.0)
        assert r.error is None and len(r.result) == 5
        assert not dead & set(int(x) for x in r.result), (i, r.result)
    assert pool.stats()["recoveries"]["deleted"]["deletes"] == len(dead)
    svc.stop()
    pool.close()


def test_service_answers_match_reference_service(service_dirs,
                                                 small_corpus):
    from repro.serving.pool import WarmIndexPool as RefPool
    from repro.serving.service import RetrievalService as RefService
    base, q, _ = small_corpus
    answers = {}
    for name, pool, svc_cls in (
            ("port", WarmIndexPool(service_dirs, cache_bytes=CACHE,
                                   device="cpu"), RetrievalService),
            ("ref", RefPool(service_dirs, cache_bytes=CACHE), RefService)):
        svc = svc_cls(pool, num_workers=2, max_batch=4, max_wait_ms=1.0,
                      L=32)
        reqs = [svc.submit(q[i], corpus=c, k=10)
                for c in ("t0", "t1") for i in range(len(q))]
        for r in reqs:
            assert r.event.wait(30.0) and r.error is None
        answers[name] = np.stack([r.result for r in reqs])
        svc.stop()
        pool.close()
    a, b = answers["ref"], answers["port"]
    same = a == b
    assert same.mean() >= 0.99, f"ids agree in {same.mean():.4f}"
    offset = np.repeat([0, 700], len(q))        # corpus t1 holds rows 700+
    qq = np.concatenate([q, q])
    for r, j in zip(*np.nonzero(~same)):
        da = ((base[offset[r] + a[r, j]] - qq[r]) ** 2).sum()
        db = ((base[offset[r] + b[r, j]] - qq[r]) ** 2).sum()
        assert abs(da - db) <= 1e-5 * max(abs(da), 1e-12), (r, j, da, db)


def test_serving_package_exports_the_reference_names():
    import repro.serving as ref
    import repro_torch.serving as port
    assert port.__all__ == ref.__all__
    assert all(hasattr(port, name) for name in port.__all__)
