"""The port's fault injection (`repro_torch.core.faults`) and the fault
tolerance around it, on the cases of the reference's tests/test_faults.py
that tests/test_torch_block_cache.py does not already copy: injector
determinism, the loader's refusals, CRC coherence under dynamic mutation,
oracle parity under injected faults, traversal degradation, the pool's
probe re-arm and the service's quarantine and deadlines. Every index
handle searches with device="cpu".

Cross-checks with `repro.core.faults`: the same plan draws the same
schedule (the same reads fail, the same bits flip) in both packages.
Tolerance: none — schedules, ids and bytes are compared exactly.
"""
import errno
import json
import os
import shutil
import time

import numpy as np
import pytest

from repro.core import faults as RF
from repro.core import index_io as jio
from repro_torch.core.block_cache import RetryPolicy
from repro_torch.core.faults import (FaultInjector, FaultPlan, FlakySocket,
                                     KillSwitch, CrashPoint, SocketFaultPlan)
from repro_torch.core.index_io import HostIndex
from repro_torch.core.integrity import CRC_SIDECAR, CorruptIndexError
from repro_torch.core.traversal import search_batch, search_batch_ref
from repro_torch.serving.pool import CorpusUnhealthyError, WarmIndexPool
from repro_torch.serving.service import RetrievalService

FAST_RETRY = RetryPolicy(attempts=6, backoff_s=1e-4, backoff_max_s=1e-3)
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def faulty(index_dirs, small_corpus):
    """The conftest aisaq index, its queries, the clean answer and the
    entry point's I/O unit."""
    p = index_dirs["aisaq"]
    q = small_corpus[1][:6]
    idx = HostIndex.load(p, **CPU)
    ep = int(idx.meta["entry_points"][0])
    ep_block = idx.layout.file_offset(ep) // idx.layout.io_bytes
    ref, _ = idx.search_batch(q, 5, L=24)
    idx.close()
    return p, q, ref, ep_block


def _read_log(mod, path, plan, offsets):
    inj = mod.FaultInjector(mod.FaultPlan(**plan))
    fd = os.open(path, os.O_RDONLY)
    log = []
    try:
        for off in offsets:
            buf = bytearray(512)
            try:
                got = inj.preadv(fd, [buf], off)
                log.append(("ok", got, bytes(buf)))
            except OSError as e:
                log.append(("err", e.errno))
    finally:
        os.close(fd)
    return log, inj.stats()


OFFSETS = [0, 512, 1024, 0, 512, 1024, 2048, 1024]


def test_injector_schedule_is_deterministic(tmp_path):
    f = tmp_path / "blob.bin"
    f.write_bytes(os.urandom(16 * 512))
    plan = dict(seed=11, eio_rate=0.3, eagain_rate=0.2, short_read_rate=0.2,
                corrupt_blocks={2: 3})
    import repro_torch.core.faults as TF
    log1, st1 = _read_log(TF, str(f), plan, OFFSETS)
    log2, st2 = _read_log(TF, str(f), plan, OFFSETS)
    assert log1 == log2 and st1 == st2
    assert st1["calls"] == 8


def test_injector_retry_is_a_fresh_draw(tmp_path):
    f = tmp_path / "blob.bin"
    payload = os.urandom(4 * 512)
    f.write_bytes(payload)
    inj = FaultInjector(FaultPlan(seed=0, eio_rate=1.0, max_faults=1))
    fd = os.open(str(f), os.O_RDONLY)
    try:
        buf = bytearray(512)
        with pytest.raises(OSError):
            inj.preadv(fd, [buf], 0)
        assert inj.preadv(fd, [buf], 0) == 512
        assert bytes(buf) == payload[:512]
    finally:
        os.close(fd)
    assert inj.stats()["injected_eio"] == 1


@pytest.mark.parametrize("seed", [0, 11, 29])
def test_injector_schedule_equals_reference(tmp_path, seed):
    f = tmp_path / "blob.bin"
    f.write_bytes(np.random.default_rng(seed).integers(
        0, 256, 16 * 512, dtype=np.uint8).tobytes())
    plan = dict(seed=seed, eio_rate=0.25, eagain_rate=0.15,
                short_read_rate=0.2, corrupt_blocks={1: 2, 3: -1})
    import repro_torch.core.faults as TF
    offsets = OFFSETS + [1536, 512, 1536, 3 * 512, 3 * 512]
    assert _read_log(TF, str(f), plan, offsets) == \
        _read_log(RF, str(f), plan, offsets)


@pytest.mark.parametrize("seed", [1, 4])
def test_socket_fault_schedule_equals_reference(seed):
    """A FlakySocket of either package over a byte-sink draws the same
    corruptions, drops and delays for the same calls."""
    class Sink:
        def __init__(self):
            self.sent, self.closed = [], False

        def sendall(self, data):
            self.sent.append(bytes(data))

        def recv(self, n):
            return b"\x5a" * n

        def close(self):
            self.closed = True

    plan = dict(seed=seed, corrupt_rate=0.4, drop_rate=0.2, delay_rate=0.2,
                delay_s=0.0)
    logs = []
    for mod in (RF, __import__("repro_torch.core.faults",
                               fromlist=["FlakySocket"])):
        sink = Sink()
        fs = mod.FlakySocket(sink, mod.SocketFaultPlan(**plan))
        log = []
        for i in range(24):
            try:
                if i % 2:
                    log.append(fs.recv(16))
                else:
                    fs.sendall(bytes(range(i, i + 32)))
                    log.append(sink.sent[-1])
            except ConnectionResetError:
                log.append("drop")
        logs.append((log, fs.injected_corrupt, fs.injected_drop,
                     fs.injected_delay))
    assert logs[0] == logs[1]


def test_kill_switch_counts_then_fires_exactly_once():
    ks = KillSwitch()
    for i in range(5):
        ks.tick(f"t{i}")
    assert ks.count == 5 and ks.labels == [f"t{i}" for i in range(5)]
    k = KillSwitch(at=3)
    k.tick("a"), k.tick("b")
    with pytest.raises(CrashPoint) as ei:
        k.tick("c")
    assert ei.value.label == "c" and ei.value.op == 3
    k.tick("d")                                  # never fires twice
    assert k.fired and k.count == 4


def test_flaky_socket_corruption_caught_by_crc():
    import socket
    from repro_torch.serving import protocol as proto
    a, b = socket.socketpair()
    flaky = FlakySocket(a, SocketFaultPlan(seed=3, corrupt_rate=1.0,
                                           max_faults=1))
    try:
        proto.send_frame(flaky, proto.T_SEARCH, {"k": 1}, b"z" * 256)
        with pytest.raises(proto.ProtocolError):
            proto.recv_frame(b)
        assert flaky.injected_corrupt == 1
    finally:
        a.close(), b.close()


# ---------------------------------------------------------------------------
# the loader's refusals and the legacy format
# ---------------------------------------------------------------------------

def test_legacy_dir_loads_without_verification(faulty, tmp_path):
    p, q, ref, _ = faulty
    p2 = str(tmp_path / "legacy")
    shutil.copytree(p, p2)
    os.remove(os.path.join(p2, CRC_SIDECAR))
    mp = os.path.join(p2, "meta.json")
    meta = json.load(open(mp))
    meta.pop("format_version"), meta.pop("crc_algo")
    json.dump(meta, open(mp, "w"))
    idx = HostIndex.load(p2, **CPU)              # no sidecar, no CRC
    assert idx.cache.block_crc is None
    ids, _ = idx.search_batch(q, 5, L=24)
    assert np.array_equal(ids, ref)
    idx.close()
    with pytest.raises(CorruptIndexError):       # explicit demand fails
        HostIndex.load(p2, verify_checksums=True, **CPU)


@pytest.mark.parametrize("damage", ["missing_meta", "truncated_meta",
                                    "future_version", "missing_chunks",
                                    "truncated_chunks"])
def test_loader_rejects_damaged_dirs(faulty, tmp_path, damage):
    from repro_torch.core.integrity import FORMAT_VERSION
    p2 = str(tmp_path / damage)
    shutil.copytree(faulty[0], p2)
    mp = os.path.join(p2, "meta.json")
    cbin = os.path.join(p2, "chunks.bin")
    if damage == "missing_meta":
        os.remove(mp)
    elif damage == "truncated_meta":
        raw = open(mp, "rb").read()
        open(mp, "wb").write(raw[:len(raw) // 2])
    elif damage == "future_version":
        meta = json.load(open(mp))
        meta["format_version"] = FORMAT_VERSION + 1
        json.dump(meta, open(mp, "w"))
    elif damage == "missing_chunks":
        os.remove(cbin)
    else:
        with open(cbin, "r+b") as f:
            f.truncate(os.path.getsize(cbin) // 2)
    with pytest.raises(CorruptIndexError):
        HostIndex.load(p2, **CPU)


def test_dynamic_mutation_keeps_crc_coherent(tmp_path):
    """In-place writes and appends re-anchor the sidecar: a reload after
    the flush verifies every block and answers the same."""
    from repro.configs.base import IndexConfig
    from repro.core.build import build_index
    from repro.data.vectors import make_clustered
    from repro_torch.core.dynamic import DynamicHostIndex
    base = make_clustered(500, 24, seed=7)
    cfg = IndexConfig(name="dyn", n_vectors=400, dim=24, R=12, pq_m=8,
                      build_L=24)
    p = str(tmp_path / "dyn")
    build_index(p, base[:400], cfg, mode="aisaq", seed=0)
    idx = DynamicHostIndex.load(p, **CPU)
    assert idx.cache.block_crc is not None
    for i in range(30):
        idx.insert(base[400 + i])
    ids, _ = idx.search(base[410], 3, L=24)      # reads mutated blocks
    idx.flush()
    idx.close()
    idx2 = DynamicHostIndex.load(p, **CPU)
    ids2, _ = idx2.search(base[410], 3, L=24)
    assert idx2.cache.counters.crc_mismatches == 0
    assert np.array_equal(ids, ids2)
    idx2.close()


# ---------------------------------------------------------------------------
# oracle parity under injected faults, degradation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def relabelled(tmp_path_factory, small_corpus, built_graph, pq_artifacts):
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    p = str(tmp_path_factory.mktemp("fgrid") / "rl1")
    jio.write_index(p, vectors=base, graph=built_graph, centroids=cents,
                    codes=codes, metric="l2", mode="aisaq", relabel=True)
    return p


@pytest.mark.parametrize("relabel", [False, True])
@pytest.mark.parametrize("adc_dtype", ["f32", "int8"])
@pytest.mark.parametrize("prefetch,pipeline", [(0, False), (4, False),
                                               (4, True)])
def test_faulty_parity_grid(index_dirs, relabelled, small_corpus, relabel,
                            adc_dtype, prefetch, pipeline):
    """Transient EIO + short reads absorbed by retries leave every
    configuration bit-identical to the fault-free scalar oracle."""
    q = small_corpus[1][:6]
    p = relabelled if relabel else index_dirs["aisaq"]
    clean = HostIndex.load(p, **CPU)
    ref, _ = search_batch_ref(clean, q, 5, L=24, adc_dtype=adc_dtype)
    clean.close()
    inj = FaultInjector(FaultPlan(seed=13, eio_rate=0.05,
                                  short_read_rate=0.05))
    idx = HostIndex.load(p, preadv=inj, retry=FAST_RETRY, **CPU)
    ids, _ = search_batch(idx, q, 5, L=24, adc_dtype=adc_dtype,
                          prefetch=prefetch, pipeline=pipeline)
    assert np.array_equal(ids, ref)
    assert inj.stats()["injected_eio"] + inj.stats()["injected_short"] > 0
    idx.close()


def test_traversal_degrades_on_persistent_prefetch_failure(faulty):
    p, q, ref, _ = faulty
    idx = HostIndex.load(p, **CPU)

    def boom(batch, gap=0):
        raise RuntimeError("injected background failure")

    idx.cache._pf_read = boom
    ids, stats = search_batch(idx, q[:4], 5, L=24, prefetch=4, pipeline=True)
    assert np.array_equal(ids, ref[:4])
    assert stats[0].degraded == 1 and stats[0].pipelined == 1
    assert idx.cache.counters.prefetch_errors >= 1
    idx.close()


# ---------------------------------------------------------------------------
# health-aware serving
# ---------------------------------------------------------------------------

def test_probe_timeout_rearms(tmp_path):
    pool = WarmIndexPool({"c": str(tmp_path)}, quarantine_after=1,
                         quarantine_cooldown_s=0.01, probe_timeout_s=0.05,
                         **CPU)
    pool.record_io_failure("c")
    time.sleep(0.02)
    pool.admit("c")                              # probe #1... then vanishes
    time.sleep(0.06)
    pool.admit("c")                              # stale probe re-armed
    pool.record_success("c")
    assert pool.health("c")["state"] == "healthy"


def test_service_quarantines_on_io_failures(faulty, tmp_path):
    """Persistent corruption -> failed batches -> quarantine -> fail-fast
    submits -> half-open recovery once the region heals."""
    p, q, ref, ep_block = faulty
    p2 = str(tmp_path / "served")
    shutil.copytree(p, p2)
    inj = FaultInjector(FaultPlan(seed=5, corrupt_blocks={ep_block: 4}))
    pool = WarmIndexPool({"c": p2}, preadv_factory=lambda n: inj,
                         quarantine_after=2, quarantine_cooldown_s=0.2,
                         **CPU)
    svc = RetrievalService(pool, num_workers=1, max_batch=4, L=24, w=4)
    for _ in range(2):                           # 2 failures x 2 reads each
        with pytest.raises(OSError) as ei:
            svc.submit_wait(q[0], corpus="c", k=5, timeout=10.0)
        assert ei.value.errno == errno.EIO
    assert pool.health("c")["state"] == "quarantined"
    with pytest.raises(CorpusUnhealthyError):
        svc.submit_wait(q[0], corpus="c", k=5, timeout=10.0)
    assert svc.stats()["corpora"]["c"]["unhealthy_rejected"] == 1
    time.sleep(0.25)                             # cooldown; block healed
    r = svc.submit_wait(q[0], corpus="c", k=5, timeout=10.0)
    assert np.array_equal(np.asarray(r.result), ref[0, :5])
    h = pool.health("c")
    assert h["state"] == "healthy" and h["recoveries"] == 1
    st = svc.stats()["corpora"]["c"]
    assert st["errors"] == 2 and st["completed"] == 1
    svc.stop()
    pool.close()


def test_request_deadline_expires_unserved(faulty):
    p, q, _, _ = faulty
    pool = WarmIndexPool({"c": p}, **CPU)

    def stall(idx, Q, k):
        time.sleep(0.3)
        return np.zeros((Q.shape[0], k), np.int64)

    svc = RetrievalService(pool, num_workers=1, max_batch=1,
                           max_wait_ms=0.1, search_fn=stall)
    a = svc.submit(q[0], corpus="c", k=5)        # occupies the one worker
    time.sleep(0.05)
    b = svc.submit(q[1], corpus="c", k=5, deadline_s=0.05)
    assert b.event.wait(5.0)
    assert isinstance(b.error, TimeoutError)
    assert a.event.wait(5.0) and a.error is None
    st = svc.stats()
    assert st["corpora"]["c"]["expired"] == 1
    assert st["corpora"]["c"]["completed"] == 1
    assert st["total_expired"] == 1
    svc.stop()
    pool.close()
