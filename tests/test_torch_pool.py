"""The port's `WarmIndexPool` and `IndexManager` (handles on device="cpu")
on the cases of the reference's tests/test_pool.py and the health cases of
tests/test_faults.py: budget-driven LRU eviction, pins, shared-centroid
dedup, concurrent leases under eviction pressure, version swaps and the
per-corpus circuit breaker. Every thread a test starts is joined with a
timeout."""
import threading
import time

import numpy as np
import pytest

from repro.core import index_io as jio
from repro.core.vamana import build_vamana
from repro_torch.core.index_io import HostIndex
from repro_torch.core.index_switch import IndexManager
from repro_torch.serving.pool import CorpusUnhealthyError, WarmIndexPool

CACHE = 256 << 10      # small per-handle block-cache budget for tests


@pytest.fixture(scope="module")
def corpora(tmp_path_factory, small_corpus, pq_artifacts):
    """Three sub-corpora sharing ONE PQ-centroid set (paper Table 4)."""
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    root = tmp_path_factory.mktemp("tpool")
    paths = {}
    for i in range(3):
        sl = slice(i * 500, (i + 1) * 500)
        p = str(root / f"c{i}")
        jio.write_index(p, vectors=base[sl],
                        graph=build_vamana(base[sl], R=12, L=24, seed=i),
                        centroids=cents, codes=codes[sl], metric="l2",
                        mode="aisaq")
        paths[f"c{i}"] = p
    return paths


def _pool(paths, **kw):
    return WarmIndexPool(paths, cache_bytes=CACHE, device="cpu", **kw)


def _budget_for(paths, n_slots):
    """Byte budget that fits exactly `n_slots` handles + shared centroids."""
    pool = _pool(paths)
    pool.ensure("c0")
    per = pool.entry_bytes("c0")
    cent = pool.centroid_bytes()
    pool.close()
    return cent + n_slots * per + per // 2


def test_lru_eviction_under_budget(corpora):
    pool = _pool(corpora, budget_bytes=_budget_for(corpora, 2))
    pool.ensure("c0")
    pool.ensure("c1")
    pool.ensure("c2")                       # c0 is LRU -> evicted
    assert pool.open_corpora() == ["c1", "c2"]
    s = pool.stats()
    assert s["evictions"] == 1 and s["misses"] == 3 and s["hits"] == 0
    pool.ensure("c1")                       # touching c1 protects it
    pool.ensure("c0")
    assert pool.open_corpora() == ["c1", "c0"]
    assert pool.used_bytes() <= pool.budget_bytes
    assert pool.peek("c0").device.type == "cpu"
    pool.close()


def test_pin_blocks_eviction(corpora):
    pool = _pool(corpora, budget_bytes=_budget_for(corpora, 1))
    idx0, load_s = pool.pin("c0")
    assert load_s > 0
    pool.ensure("c1")                       # over budget, but c0 is pinned
    assert "c0" in pool.open_corpora()
    assert pool.stats()["budget_overflow"] >= 1
    assert idx0.resident_bytes() > 0 and idx0.fd >= 0
    pool.unpin("c0")                        # deferred eviction fires now
    assert pool.open_corpora() == ["c1"]
    pool.close()


def test_shared_centroid_dedup(corpora):
    pool = _pool(corpora)
    pool.ensure("c0")
    u1 = pool.used_bytes()
    pool.ensure("c1")
    pool.ensure("c2")
    c0 = pool.peek("c0").centroids
    assert pool.peek("c1").centroids is c0 and pool.peek("c2").centroids \
        is c0
    assert pool.stats()["centroid_shares"] == 2
    assert pool.used_bytes() == u1 + 2 * pool.entry_bytes("c1")
    pool.close()


def test_unknown_corpus_keyerror(corpora):
    pool = _pool(corpora)
    with pytest.raises(KeyError, match=r"unknown corpus 'nope'.*c0.*c1.*c2"):
        pool.ensure("nope")
    mgr = IndexManager(corpora, device="cpu")
    with pytest.raises(KeyError, match=r"unknown corpus 'wiki'.*c0"):
        mgr.switch("wiki")
    pool.close(), mgr.close()


def test_concurrent_leases_under_eviction_pressure(corpora, small_corpus):
    """Threads lease and search different corpora while the budget fits
    two handles: every search completes on a live handle and matches a
    fresh load's answer."""
    _, q, _ = small_corpus
    refs = {}
    for name, path in corpora.items():
        idx = HostIndex.load(path, device="cpu")
        refs[name], _ = idx.search_batch(q, 5, L=24)
        idx.close()
    pool = _pool(corpora, budget_bytes=_budget_for(corpora, 2))
    errors = []

    def hammer(name):
        try:
            for _ in range(4):
                with pool.lease(name) as (idx, _load):
                    ids, _ = idx.search_batch(q, 5, L=24)
                    np.testing.assert_array_equal(ids, refs[name])
        except Exception as e:            # noqa: BLE001 — asserted below
            errors.append((name, e))

    threads = [threading.Thread(target=hammer, args=(n,))
               for n in corpora for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    s = pool.stats()
    assert s["evictions"] > 0 and not s["pinned"]
    pool.close()


def test_index_manager_is_budget_for_one_pool(corpora, small_corpus):
    _, q, _ = small_corpus
    mgr = IndexManager(corpora, device="cpu")
    assert mgr.switch("c0") > 0
    assert mgr.switch("c0") == 0.0        # already active
    ids, _ = mgr.search(q[0], 5, L=24)
    assert ids.shape == (5,)
    mgr.switch("c1")
    assert mgr.pool.open_corpora() == ["c1"]
    assert mgr.active is mgr.pool.peek("c1")
    mgr.close()
    assert mgr.active is None


def test_swap_drains_inflight_lease_and_shares_centroids(corpora):
    pool = _pool({"live": corpora["c0"]})
    old_idx, _ = pool.pin("live")
    cents_before = pool.centroid_bytes()
    pool.swap("live", corpora["c1"])
    assert pool.stats()["retired"] == 1 and old_idx.fd >= 0
    q = np.zeros(old_idx.meta["dim"], np.float32)
    assert len(old_idx.search(q, 3, L=16)[0]) == 3   # old still serves
    with pool.lease("live") as (idx2, _):
        assert idx2 is not old_idx
        assert idx2.centroids is old_idx.centroids
        assert len(idx2.search(q, 3, L=16)[0]) == 3
    assert pool.centroid_bytes() == cents_before
    pool.unpin("live", index=old_idx)
    assert old_idx.fd == -1 and pool.stats()["retired"] == 0
    pool.close()


def test_circuit_breaker_lifecycle(tmp_path):
    pool = WarmIndexPool({"c": str(tmp_path)}, quarantine_after=3,
                         quarantine_cooldown_s=0.05,
                         quarantine_cooldown_max_s=0.5, device="cpu")
    pool.admit("c")
    for _ in range(2):
        pool.record_io_failure("c")
    pool.admit("c")                              # below the threshold
    pool.record_io_failure("c")                  # third: opens
    assert pool.health("c")["state"] == "quarantined"
    with pytest.raises(CorpusUnhealthyError) as ei:
        pool.admit("c")
    assert ei.value.corpus == "c" and ei.value.retry_in_s >= 0
    time.sleep(0.06)
    pool.admit("c")                              # cooldown over: the probe
    assert pool.health("c")["state"] == "probing"
    with pytest.raises(CorpusUnhealthyError):    # only ONE probe admitted
        pool.admit("c")
    pool.record_io_failure("c")                  # probe failed: back off x2
    h = pool.health("c")
    assert h["state"] == "quarantined" and h["quarantines"] == 2
    assert h["cooldown_s"] == pytest.approx(0.1)
    time.sleep(0.11)
    pool.admit("c")
    pool.record_success("c")
    h = pool.health("c")
    assert h["state"] == "healthy" and h["recoveries"] == 1
    assert h["cooldown_s"] == pytest.approx(0.05)


def test_stats_snapshot(corpora):
    pool = _pool(corpora)
    q = np.random.default_rng(0).standard_normal(48).astype(np.float32)
    for name in corpora:
        idx, _ = pool.pin(name)
        idx.search_batch(q[None], 3, L=24)
        pool.unpin(name, idx)
    s = pool.stats()
    assert set(s["caches"]) == set(corpora) and s["open"] == len(corpora)
    assert s["used_bytes"] > 0 and s["recoveries"] == {}
    # the traversal fed each handle's SearchMetrics histograms
    hops = pool.registry.snapshot()["traversal_hops"]["series"]
    assert len(hops) == len(corpora)
    pool.close()
