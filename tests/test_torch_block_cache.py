"""The port's block cache (`repro_torch.core.block_cache`, a copy of the
reference's) on the cases of the reference's tests/test_block_cache.py,
tests/test_faults.py and tests/test_traversal_pipeline.py: LRU eviction,
readahead gaps and their autotuning, the async prefetcher, CRC
verification and retries through the real read path (the port's copy of
the fault injector as the preadv hook), and a port `HostIndex` whose
background reads are slow, failing or flaky keeping its oracle's results.
Every thread a test starts is joined with a timeout."""
import errno
import os
import shutil
import threading
import time

import numpy as np
import pytest

from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.block_cache import BlockCache, RetryPolicy
from repro_torch.core.index_io import HostIndex
from repro_torch.core.integrity import CorruptBlockError

IO = 4096
FAST_RETRY = RetryPolicy(attempts=6, backoff_s=1e-4, backoff_max_s=1e-3)


@pytest.fixture()
def blockfile(tmp_path):
    """A file of 64 distinct 4 KiB blocks + an open fd."""
    data = np.arange(64, dtype=np.uint8).repeat(IO)
    p = tmp_path / "blocks.bin"
    p.write_bytes(data.tobytes())
    fd = os.open(p, os.O_RDONLY)
    yield fd
    os.close(fd)


def offs(*blocks):
    return np.asarray(blocks, dtype=np.int64) * IO


def resident(cache):
    with cache._cond:
        return sorted(k // IO for k in cache._blocks)


def test_eviction_is_lru_order(blockfile):
    cache = BlockCache(blockfile, IO, capacity_bytes=3 * IO)
    for b in (0, 1, 2, 0, 3):     # refresh 0, then 3 evicts 1
        cache.fetch(offs(b))
    assert cache.counters.evictions == 1
    assert resident(cache) == [0, 2, 3]
    out, _, _ = cache.fetch(offs(*range(10)))
    assert (out[:, 0] == np.arange(10)).all()
    assert cache.used_bytes <= 3 * IO


@pytest.mark.parametrize("gap,syscalls", [(0, 3), (2, 1)])
def test_gap_coalesces_runs(blockfile, gap, syscalls):
    cache = BlockCache(blockfile, IO, capacity_bytes=16 * IO)
    out, hm, n_sys = cache.fetch(offs(0, 2, 4), gap=gap)
    assert (out[:, 0] == np.array([0, 2, 4])).all() and not hm.any()
    assert n_sys == syscalls
    # gap holes land as speculative residents (prefetch_issued)
    assert cache.counters.prefetch_issued == (2 if gap else 0)


def test_prefetch_lands_blocks_and_demand_hits(blockfile):
    cache = BlockCache(blockfile, IO, capacity_bytes=8 * IO)
    assert cache.prefetch_async(offs(3, 4, 5)) == 3
    cache.wait_prefetch()
    c = cache.counters
    assert c.prefetch_issued == 3 and c.syscalls == 0
    out, hm, n_sys = cache.fetch(offs(3, 4, 5))
    assert hm.all() and n_sys == 0 and c.prefetch_hits == 3
    assert (out[:, 0] == np.array([3, 4, 5])).all()
    cache.stop()


def test_demand_fetch_waits_for_inflight_instead_of_rereading(blockfile):
    cache = BlockCache(blockfile, IO, capacity_bytes=16 * IO)
    cache.prefetch_async(offs(*range(10)))
    out, hm, _ = cache.fetch(offs(*range(10)))
    cache.wait_prefetch()
    assert (out[:, 0] == np.arange(10)).all()
    c = cache.counters
    assert 10 * IO <= c.prefetch_bytes + c.bytes_read <= 20 * IO
    assert hm.sum() == 10 - c.misses
    cache.stop()


@pytest.mark.parametrize("pattern,rounds,want", [
    ((0, 2, 4), 1, 0),                                   # too few holes
    (tuple(b for b in range(30) if b % 3 != 2), 2, 1),   # 1-block holes
    ((0, 12, 24, 36), 4, 0),                             # scattered misses
], ids=["unobserved", "small_holes", "scattered"])
def test_auto_gap_learning(blockfile, pattern, rounds, want):
    cache = BlockCache(blockfile, IO, capacity_bytes=0)
    for _ in range(rounds):
        cache.fetch(offs(*pattern))
    assert cache.auto_gap() == want
    _, _, n_plain = cache.fetch(offs(*pattern), gap=0)
    _, _, n_auto = cache.fetch(offs(*pattern), gap="auto")
    assert cache.counters.auto_gap == want
    assert (n_auto < n_plain) == (want > 0)


@pytest.mark.parametrize("failing", ["every", "first"])
def test_background_failure_unclaims_and_worker_survives(blockfile,
                                                         monkeypatch,
                                                         failing):
    cache = BlockCache(blockfile, IO, capacity_bytes=16 * IO)
    orig = BlockCache._pf_read
    calls = {"n": 0}

    def broken(self, batch, gap=0):
        calls["n"] += 1
        if failing == "every" or calls["n"] == 1:
            raise OSError("injected background failure")
        return orig(self, batch, gap)

    monkeypatch.setattr(BlockCache, "_pf_read", broken)
    cache.prefetch_async(offs(0, 1, 2))
    cache.wait_prefetch()
    with cache._cond:
        assert not cache._inflight             # un-claimed, not leaked
    cache.prefetch_async(offs(4, 5))
    cache.wait_prefetch()
    assert cache.counters.prefetch_errors == (2 if failing == "every" else 1)
    out, hm, _ = cache.fetch(offs(0, 4, 5))
    assert (out[:, 0] == np.array([0, 4, 5])).all()
    assert hm[1:].all() == (failing == "first")   # second batch landed
    cache.stop()


# ---------------------------------------------------------------------------
# CRC verification and retries through HostIndex
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def faulty(index_dirs, small_corpus):
    """The conftest aisaq index, its queries, the clean answer and the
    entry point's I/O unit."""
    p = index_dirs["aisaq"]
    q = small_corpus[1][:6]
    idx = HostIndex.load(p, device="cpu")
    ep = int(idx.meta["entry_points"][0])
    ep_block = idx.layout.file_offset(ep) // idx.layout.io_bytes
    io_bytes = idx.layout.io_bytes
    ref, _ = idx.search_batch(q, 5, L=24)
    idx.close()
    return p, q, ref, ep_block, io_bytes


@pytest.mark.parametrize("case", ["transient_eio", "healed_corruption",
                                  "persistent_eio", "persistent_corruption"])
def test_crc_and_retries(faulty, case):
    p, q, ref, ep_block, _ = faulty
    plan = {"transient_eio": dict(eio_rate=1.0, max_faults=1),
            "healed_corruption": dict(corrupt_blocks={ep_block: 1}),
            "persistent_eio": dict(eio_rate=1.0),
            "persistent_corruption": dict(corrupt_blocks={ep_block: -1})}
    inj = FaultInjector(FaultPlan(seed=5, **plan[case]))
    retry = RetryPolicy(attempts=2, backoff_s=1e-4) \
        if case == "persistent_eio" else FAST_RETRY
    idx = HostIndex.load(p, preadv=inj, retry=retry, device="cpu")
    try:
        c = idx.cache.counters
        if case.startswith("persistent"):
            err = CorruptBlockError if "corruption" in case else OSError
            with pytest.raises(err) as ei:
                idx.search_batch(q, 5, L=24)
            assert ei.value.errno == errno.EIO
            return
        ids, _ = idx.search_batch(q, 5, L=24)
        np.testing.assert_array_equal(ids, ref)
        if case == "transient_eio":
            assert c.read_retries >= 1
        else:
            assert c.crc_mismatches == 1 and c.crc_rereads == 1
    finally:
        idx.close()


@pytest.mark.parametrize("verify", [None, False])
def test_on_disk_bitrot(faulty, tmp_path, verify):
    """Bytes flipped on storage: detected with the sidecar (the reread
    reads the same bytes), served silently with verification off."""
    p, q, _, ep_block, io_bytes = faulty
    p2 = str(tmp_path / "rot")
    shutil.copytree(p, p2)
    with open(os.path.join(p2, "chunks.bin"), "r+b") as f:
        f.seek(ep_block * io_bytes + 7)
        b = f.read(1)
        f.seek(ep_block * io_bytes + 7)
        f.write(bytes([b[0] ^ 0x40]))
    idx = HostIndex.load(p2, verify_checksums=verify, device="cpu")
    try:
        if verify is None:
            with pytest.raises(CorruptBlockError):
                idx.search_batch(q, 5, L=24)
        else:
            idx.search_batch(q, 5, L=24)
    finally:
        idx.close()


# ---------------------------------------------------------------------------
# slow, failing and flaky background reads keep the results
# ---------------------------------------------------------------------------


def _run_with_timeout(fn, seconds=60.0):
    """Run fn on a worker thread; fail instead of hanging on a deadlock."""
    out: dict = {}

    def target():
        try:
            out["result"] = fn()
        except BaseException as e:     # noqa: BLE001 — surfaced below
            out["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"deadlock: search did not finish in {seconds}s"
    if "error" in out:
        raise out["error"]
    return out["result"]


@pytest.mark.parametrize("behaviour", ["slow", "failing", "flaky"])
def test_background_reads_keep_results(index_dirs, small_corpus,
                                       monkeypatch, behaviour):
    _, q, _ = small_corpus
    idx = HostIndex.load(index_dirs["aisaq"], device="cpu")
    try:
        ref_ids, _ = idx.search_batch(q, 10, L=40)
        idx.cache.clear()
        orig = BlockCache._pf_read
        calls = {"n": 0}

        def hooked(self, batch, gap=0):
            calls["n"] += 1
            if behaviour == "slow":
                time.sleep(0.05)
            elif behaviour == "failing" or calls["n"] % 2:
                raise OSError("injected background failure")
            return orig(self, batch, gap)

        monkeypatch.setattr(BlockCache, "_pf_read", hooked)
        ids, st = _run_with_timeout(lambda: idx.search_batch(
            q, 10, L=40, prefetch=4, pipeline=True,
            gap=0 if behaviour == "failing" else None))
        np.testing.assert_array_equal(ids, ref_ids)
        c = idx.cache.counters
        assert calls["n"] >= 1
        if behaviour == "failing":
            assert c.prefetch_errors > 0 and c.prefetch_issued == 0
            assert st[0].degraded == 1
    finally:
        idx.close()
