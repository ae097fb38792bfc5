"""The port's multi-process serving tier (`repro_torch.serving.protocol`,
`core.shard_math`, `serving.router`, `serving.cluster`) on the cases of
the reference's tests/test_cluster.py, with workers that search on
device="cpu".

Cross-checks with the reference package: frames, query and result
payloads and `merge_topk` outputs are byte-equal, and each package
decodes the other's frames. The spawned-cluster tests share one
module-scoped cluster (each worker imports torch, seconds of start-up):
its answers are bit-identical to `merge_topk` of single-process searches
of each shard, a SIGKILLed worker degrades the router to clean partial
answers, and the respawned worker — `heartbeat_s=0.1`, so three missed
heartbeats take 0.3 s, less than a worker's start — serves again without
ever being quarantined. The supervisor's start-up state machine is also
driven directly, with stand-in processes.
Tolerance: none — ids and distances are compared bit for bit.
"""
import os
import signal
import socket
import struct
import subprocess
import tempfile
import threading
import time

import numpy as np
import pytest

from repro.core import shard_math as RSM
from repro.serving import protocol as rproto
from repro_torch.core import shard_math as SM
from repro_torch.core.faults import ProcessKiller
from repro_torch.serving import protocol as proto
from repro_torch.serving.router import (DegradedServiceError,
                                        LocalShardClient, ShardRouter,
                                        ShardUnavailableError,
                                        SocketShardClient)

# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------


def test_frame_roundtrip():
    a, b = socket.socketpair()
    try:
        proto.send_frame(a, proto.T_SEARCH, {"k": 5, "corpus": "x"},
                         b"\x00\x01\xfe payload")
        rtype, header, blob = proto.recv_frame(b)
        assert rtype == proto.T_SEARCH
        assert header == {"k": 5, "corpus": "x"}
        assert blob == b"\x00\x01\xfe payload"
    finally:
        a.close(), b.close()


def test_query_and_result_roundtrip():
    q = np.random.default_rng(0).standard_normal(48).astype(np.float32)
    h, blob = proto.encode_query(q, corpus="c", k=7, req_id=3,
                                 deadline_s=1.5)
    np.testing.assert_array_equal(q, proto.decode_query(h, blob))
    assert (h["corpus"], h["k"], h["req_id"]) == ("c", 7, 3)
    ids = np.array([5, -1, 9], np.int64)
    dists = np.array([0.25, np.inf, 1.5], np.float32)
    h2, b2 = proto.encode_result(ids, dists, req_id=3)
    ids2, dists2 = proto.decode_result(h2, b2)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(dists, dists2)
    assert ids2.dtype == np.int64 and dists2.dtype == np.float32


def test_corrupt_byte_poisons_frame():
    raw = bytearray(proto.pack_frame(proto.T_RESULT, {"req_id": 1},
                                     b"x" * 64))
    raw[len(raw) // 2] ^= 0x40
    a, b = socket.socketpair()
    try:
        a.sendall(bytes(raw))
        with pytest.raises(proto.ProtocolError):
            proto.recv_frame(b)
    finally:
        a.close(), b.close()


def test_closed_peer_raises_connection_closed():
    a, b = socket.socketpair()
    a.close()
    try:
        with pytest.raises(proto.ConnectionClosed):
            proto.recv_frame(b)
    finally:
        b.close()


def test_oversized_length_field_rejected_before_allocation():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("<IBII", 0x31515341, proto.T_SEARCH,
                              0, 1 << 30))
        with pytest.raises(proto.ProtocolError, match="corrupt length"):
            proto.recv_frame(b)
    finally:
        a.close(), b.close()


_FRAMES = [
    (1, {"k": 5, "corpus": "x"}, b"\x00\x01\xfe payload"),
    (2, {"req_id": 9, "spans": [{"tid": "a", "sid": "b"}]}, b""),
    (3, {"req_id": 1, "etype": "KeyError", "msg": "unknown corpus 'ü'"},
     b""),
    (4, {}, bytes(range(256)) * 5),
]


@pytest.mark.parametrize("frame", range(len(_FRAMES)))
def test_frames_byte_equal_to_reference(frame):
    t, h, b = _FRAMES[frame]
    raw = proto.pack_frame(t, h, b)
    assert raw == rproto.pack_frame(t, h, b)
    for sender, receiver in ((proto, rproto), (rproto, proto)):
        a, c = socket.socketpair()
        try:
            sender.send_frame(a, t, h, b)
            assert receiver.recv_frame(c) == (t, h, b)
        finally:
            a.close(), c.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_payload_codecs_byte_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(24).astype(np.float32)
    kw = dict(corpus="c", k=10, req_id=seed, deadline_s=2.5,
              trace={"tid": "t1", "sid": "s1"})
    assert proto.encode_query(q, **kw) == rproto.encode_query(q, **kw)
    ids = rng.integers(-1, 1000, 10)
    d = rng.standard_normal(10).astype(np.float32)
    mine = proto.encode_result(ids, d, req_id=seed)
    assert mine == rproto.encode_result(ids, d, req_id=seed)
    for a, b in zip(proto.decode_result(*mine),
                    rproto.decode_result(*mine)):
        assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# shard math
# ---------------------------------------------------------------------------


def test_contiguous_shards_matches_array_split():
    for n, s in ((10, 3), (7, 7), (20000, 4), (5, 1)):
        asn = SM.contiguous_shards(n, s)
        sizes = [len(part) for part in np.array_split(np.arange(n), s)]
        assert list(asn.counts) == sizes
        assert asn.n == n and asn.n_shards == s
        lo = 0
        for sh in range(s):
            assert asn.bounds(sh) == (lo, lo + sizes[sh])
            lo += sizes[sh]
        for sh in range(s):
            blo, bhi = asn.bounds(sh)
            assert asn.shard_of(blo) == sh and asn.shard_of(bhi - 1) == sh


def test_merge_topk_matches_global_sort():
    rng = np.random.default_rng(1)
    parts_ids = [rng.permutation(100)[:8] + 100 * s for s in range(3)]
    parts_dists = [rng.standard_normal(8).astype(np.float32)
                   for _ in range(3)]
    ids, dists = SM.merge_topk(parts_ids, parts_dists, 10)
    all_ids = np.concatenate(parts_ids)
    all_d = np.concatenate(parts_dists)
    order = np.lexsort((all_ids, all_d))[:10]
    np.testing.assert_array_equal(ids, all_ids[order])
    np.testing.assert_array_equal(dists, all_d[order])


def test_merge_topk_pads_and_drops_invalid():
    ids, dists = SM.merge_topk([np.array([3, -1])],
                               [np.array([0.5, 0.1], np.float32)], 4)
    np.testing.assert_array_equal(ids, [3, -1, -1, -1])
    assert dists[0] == np.float32(0.5) and np.isinf(dists[1:]).all()


@pytest.mark.parametrize("seed", range(4))
def test_merge_and_shards_byte_equal_to_reference(seed):
    """Ties on distance (a coarse grid) exercise the id tie-break."""
    rng = np.random.default_rng(seed)
    s = int(rng.integers(1, 5))
    parts_ids = [rng.integers(-1, 50, int(rng.integers(0, 12)))
                 for _ in range(s)]
    parts_d = [np.round(rng.standard_normal(len(p)), 1).astype(np.float32)
               for p in parts_ids]
    k = int(rng.integers(1, 20))
    for a, b in zip(SM.merge_topk(parts_ids, parts_d, k),
                    RSM.merge_topk(parts_ids, parts_d, k)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    n = int(rng.integers(s, 1000))
    mine, theirs = SM.contiguous_shards(n, s), RSM.contiguous_shards(n, s)
    assert mine.offsets.tobytes() == theirs.offsets.tobytes()
    assert mine.counts.tobytes() == theirs.counts.tobytes()


# ---------------------------------------------------------------------------
# router degradation over in-process shards
# ---------------------------------------------------------------------------


def _const_client(ids, dists, name="c"):
    return LocalShardClient(
        lambda q, k, i=np.asarray(ids), d=np.asarray(dists): (i, d), name)


def _failing_client(name="dead"):
    def fn(q, k):
        raise OSError("shard is on fire")
    return LocalShardClient(fn, name)


def test_router_full_coverage_merges_exactly():
    r = ShardRouter([_const_client([1, 3], [0.1, 0.3]),
                     _const_client([2, 4], [0.2, 0.4])], min_shards=1)
    out = r.search(np.zeros(4, np.float32), 3)
    assert not out.partial and out.shards_answered == 2
    np.testing.assert_array_equal(out.ids, [1, 2, 3])
    st = r.stats()
    assert st["queries"] == 1 and st["full"] == 1 and st["partial"] == 0
    r.close()


def test_router_partial_on_one_dead_shard():
    r = ShardRouter([_const_client([1, 3], [0.1, 0.3]), _failing_client()],
                    min_shards=1, hedge_retry=False)
    out = r.search(np.zeros(4, np.float32), 3)
    assert out.partial and out.failed_shards == [1]
    np.testing.assert_array_equal(out.ids, [1, 3, -1])
    assert r.stats()["shard_failures"] == 1
    r.close()


def test_router_quorum_rejects_cleanly():
    r = ShardRouter([_failing_client("a"), _failing_client("b")],
                    min_shards=1, hedge_retry=False)
    with pytest.raises(DegradedServiceError) as ei:
        r.search(np.zeros(4, np.float32), 3)
    assert ei.value.answered == 0 and ei.value.min_shards == 1
    assert r.stats()["rejected"] == 1
    r.close()
    r2 = ShardRouter([_const_client([1], [0.1]), _failing_client()],
                     min_shards=2, hedge_retry=False)
    with pytest.raises(DegradedServiceError):
        r2.search(np.zeros(4, np.float32), 3)
    r2.close()


def test_router_hedged_retry_skips_shards_reported_down():
    calls = []

    def fn(q, k):
        calls.append(1)
        raise OSError("nope")

    r = ShardRouter([_const_client([1], [0.1]), LocalShardClient(fn, "down")],
                    min_shards=1, hedge_retry=True,
                    endpoints_fn=lambda: ["/ok", None])
    out = r.search(np.zeros(4, np.float32), 2)
    assert out.partial and len(calls) == 1      # no knock on a known corpse
    assert r.stats()["retries"] == 0
    r.close()


def test_local_client_wraps_errors_as_unavailable():
    with pytest.raises(ShardUnavailableError, match="on fire"):
        _failing_client().search(np.zeros(2, np.float32), 1)


def test_process_killer_fires_exactly_once_at_tick():
    p = subprocess.Popen(["sleep", "60"])
    try:
        k = ProcessKiller(at=3).arm(p.pid)
        assert not k.tick() and not k.tick()
        assert p.poll() is None
        assert k.tick()                 # third tick fires
        assert k.killed_pid == p.pid
        assert not k.tick()             # never fires twice
        assert p.wait(5.0) == -signal.SIGKILL
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


# ---------------------------------------------------------------------------
# the supervisor's start-up state machine, with stand-in processes
# ---------------------------------------------------------------------------


class _FakeProc:
    def __init__(self):
        self.alive, self.killed, self.pid = True, 0, 12345

    def is_alive(self):
        return self.alive

    def kill(self):
        self.killed += 1
        self.alive = False

    def join(self, timeout=None):
        pass


def _supervisor(tmp_path, **kw):
    from repro_torch.serving.cluster import ShardCluster
    c = ShardCluster([{"default": str(tmp_path)}],
                     socket_dir=str(tmp_path / "socks"), device="cpu",
                     heartbeat_s=0.01, backoff_s=60.0, **kw)
    ws = c._workers[0]
    ws.proc, ws.state, ws.spawned_at = _FakeProc(), "starting", \
        time.monotonic()
    return c, ws


def test_starting_worker_is_not_routed_and_misses_nothing(tmp_path):
    c, ws = _supervisor(tmp_path)
    for _ in range(10):                   # no socket yet: pings fail
        c._check(ws)
    assert ws.state == "starting" and ws.hb_misses == 0
    assert ws.proc.killed == 0 and c.endpoints() == [None]


def test_start_timeout_is_a_failed_start(tmp_path):
    c, ws = _supervisor(tmp_path, max_restarts=1)
    c.ready_timeout_s = 0.05
    ws.spawned_at -= 1.0
    c._check(ws)
    assert ws.proc.killed == 1 and ws.state == "down"
    assert ws.crash_streak == 1 and c.endpoints() == [None]
    assert any("not ready" in what for _, _, what in c.events)
    ws.proc, ws.state = _FakeProc(), "starting"
    ws.spawned_at = time.monotonic() - 1.0
    c._check(ws)                          # second failed start in a row
    assert ws.state == "quarantined" and ws.crash_streak == 2


def test_first_heartbeat_marks_serving(tmp_path):
    c, ws = _supervisor(tmp_path)
    path = ws.spec.socket_path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lst.bind(path)
    lst.listen(4)

    def pong():
        conn, _ = lst.accept()
        with conn:
            while True:
                try:
                    rtype, _, _ = proto.recv_frame(conn)
                except proto.ProtocolError:
                    return
                proto.send_frame(conn, proto.T_PONG, {"pid": 1})

    t = threading.Thread(target=pong, daemon=True)
    t.start()
    try:
        c._check(ws)
        assert ws.state == "serving" and ws.ready_s is not None
        assert c.endpoints() == [path]
        c._check(ws)                      # a serving worker's heartbeat
        assert ws.hb_misses == 0
    finally:
        c._close_hb(ws)
        lst.close()
        t.join(2.0)


# ---------------------------------------------------------------------------
# cluster end-to-end: spawn, serve, kill, respawn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory, small_corpus, pq_artifacts):
    """Two global-label shards over the test corpus's first 1000 vectors,
    written by the port's writer."""
    from repro.core.vamana import build_vamana
    from repro_torch.core.index_io import write_index
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    asn = SM.contiguous_shards(1000, 2)
    root = tmp_path_factory.mktemp("tcluster")
    shards = []
    for s in range(2):
        lo, hi = asn.bounds(s)
        p = str(root / f"shard{s}")
        write_index(p, vectors=base[lo:hi],
                    graph=build_vamana(base[lo:hi], R=12, L=24, seed=s),
                    centroids=cents, codes=codes[lo:hi], metric="l2",
                    mode="aisaq", labels=np.arange(lo, hi, dtype=np.int64))
        shards.append({"default": p})
    return shards


@pytest.fixture(scope="module")
def cluster(shard_dirs):
    from repro_torch.serving.cluster import ShardCluster
    sd = tempfile.mkdtemp(prefix="tclus")
    c = ShardCluster(shard_dirs, socket_dir=sd, L=24, w=4,
                     cache_bytes=1 << 20, heartbeat_s=0.1, backoff_s=0.2,
                     stable_s=1.0, device="cpu")
    c.start(ready_timeout_s=60.0)
    router = ShardRouter([SocketShardClient(p) for p in c.endpoints()],
                         min_shards=1, shard_deadline_s=5.0,
                         endpoints_fn=c.endpoints)
    yield c, router
    router.close()
    c.stop()


def _refs(shards, queries, k):
    from repro_torch.core.index_io import HostIndex
    from repro_torch.serving.engine import make_host_search_dist_fn
    ids, dists = [], []
    for corpora in shards:
        idx = HostIndex.load(corpora["default"], cache_bytes=1 << 20,
                             device="cpu")
        i, d = make_host_search_dist_fn(idx, L=24, w=4)(queries, k)
        ids.append(i), dists.append(d)
        idx.close()
    return ids, dists


def _merged(ref_ids, ref_dists, qi, k, shards=(0, 1)):
    return SM.merge_topk([ref_ids[s][qi] for s in shards],
                         [ref_dists[s][qi] for s in shards], k)


def test_cluster_worker_stats_over_the_wire(cluster, small_corpus):
    c, router = cluster
    _, q, _ = small_corpus
    assert not router.search(q[0], 5).partial
    st = c.worker_stats(0)
    assert st is not None and st["total_completed"] >= 1
    assert "pool" in st and "recoveries" in st["pool"]
    # the worker's launch counters ride along (all 0 on the CPU, where
    # the wrappers run their plain versions)
    assert set(st["kernel_launches"]) == {
        "fused_hop_f32", "fused_hop_int8", "pq_lut", "rerank", "pq_adc",
        "pq_adc_q8", "segment_sum"}
    assert not any(st["kernel_launches"].values())
    top = c.stats()
    assert top["serving"] == 2 and top["quarantined"] == 0
    assert all(s["state"] == "serving" and s["ready_s"] > 0
               for s in top["shards"].values())
    assert top["registry"] is not None


def test_cluster_kill_respawn_end_to_end(cluster, shard_dirs, small_corpus):
    """Full-coverage answers equal the merged single-process searches bit
    for bit; a SIGKILLed worker degrades the router to clean partials over
    the survivor; the respawned worker (slower to start than three missed
    heartbeats) restores full coverage and is never quarantined."""
    c, router = cluster
    _, q, _ = small_corpus
    q, k = q[:6], 5
    ref_ids, ref_dists = _refs(shard_dirs, q, k)
    for qi in range(len(q)):
        out = router.search(q[qi], k)
        assert not out.partial
        eids, edists = _merged(ref_ids, ref_dists, qi, k)
        np.testing.assert_array_equal(out.ids, eids)
        np.testing.assert_array_equal(out.dists, edists)

    os.kill(c.pid(1), signal.SIGKILL)
    saw_partial, deadline = None, time.monotonic() + 10.0
    while saw_partial is None and time.monotonic() < deadline:
        out = router.search(q[0], k)
        if out.partial:
            saw_partial = out
    assert saw_partial is not None, "kill never degraded coverage"
    assert saw_partial.failed_shards == [1]
    eids, edists = _merged(ref_ids, ref_dists, 0, k, shards=(0,))
    np.testing.assert_array_equal(saw_partial.ids, eids)
    np.testing.assert_array_equal(saw_partial.dists, edists)

    assert c.wait_healthy(60.0)
    deadline = time.monotonic() + 10.0
    out = router.search(q[1], k)
    while out.partial and time.monotonic() < deadline:
        out = router.search(q[1], k)
    assert not out.partial
    eids, edists = _merged(ref_ids, ref_dists, 1, k)
    np.testing.assert_array_equal(out.ids, eids)
    np.testing.assert_array_equal(out.dists, edists)
    st = c.stats()["shards"][1]
    assert st["state"] == "serving" and st["restarts"] >= 1
    assert st["ready_s"] > 0.3            # slower than 3 missed heartbeats
    assert not any("quarantined" in w or "wedged" in w
                   for _, _, w in c.events), list(c.events)
