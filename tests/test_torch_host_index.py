"""The port's storage-backed `HostIndex` (device="cpu": the plain versions
of the kernels) against the reference's `repro.core.index_io.HostIndex`
on the same directories and queries, and against its own scalar oracle.

Tolerances (the reference sums in numpy's pairwise order, the port in a
fixed left-to-right order, and its LUT in the kernel's expanded form):
ids equal in >= 99% of (query, rank) entries, and every differing entry a
near tie — the reference's distances of the two ids there (exact for the
exact tiers, ADC for the PQ-only tier) within 1e-5 relative. Where a
query's ids are equal, its SearchStats counters are equal; the cache
counters (hits, misses, bytes, syscalls) only without prefetch, whose
background reads land at times no run controls. Seed distances within
1e-5 relative, and the port's batched path bit-identical to its oracle.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import index_io as jio
from repro_torch.core import index_io as tio
from repro_torch.core.index_switch import IndexManager
from repro_torch.core.traversal import recall_at
from repro_torch.serving import engine as teng

STAT_KEYS = ("hops", "ios", "pq_dists", "rerank_ios", "nav_hops",
             "nav_dists", "convergence_hop")
CACHE_KEYS = ("bytes_read", "cache_hits", "cache_misses", "syscalls")
KINDS = ("aisaq", "diskann", "relabel", "nav", "u8")


def _u8(base):
    lo, hi = base.min(), base.max()
    return np.clip((base - lo) / (hi - lo) * 255, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, index_dirs, small_corpus, built_graph,
         pq_artifacts):
    """kind -> (path, vectors in label order): the conftest indices plus a
    relabelled one, one with the navigation tier and a uint8 one, all
    written by the reference."""
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    root = tmp_path_factory.mktemp("host")
    out = {"aisaq": (index_dirs["aisaq"], base),
           "diskann": (index_dirs["diskann"], base)}
    kw = dict(graph=built_graph, centroids=cents, codes=codes, metric="l2",
              mode="aisaq")
    for kind, extra, vecs in (("relabel", dict(relabel=True), base),
                              ("nav", dict(nav=True), base),
                              ("u8", {}, _u8(base))):
        p = str(root / kind)
        jio.write_index(p, vectors=vecs, **kw, **extra)
        out[kind] = (p, vecs)
    return out


def _exact(vecs, q, ids):
    v = vecs[np.where(ids >= 0, ids, 0)].astype(np.float32)
    return ((v - q[:, None, :]) ** 2).sum(-1)


def _adc(cents, codes, q, ids, adc_dtype):
    lut = jadc.np_build_lut_batch(cents, q, "l2")
    c = codes[np.where(ids >= 0, ids, 0)]
    if adc_dtype == "int8":
        q8, s = jadc.np_host_lut_int8(lut)
        return np.stack([jadc.np_adc_int8(q8[i], s[i], c[i])
                         for i in range(len(q))])
    return np.stack([jadc.np_adc(lut[i], c[i]) for i in range(len(q))])


def check_parity(a, sa, b, sb, q, vecs, cents, codes, *, rerank, adc_dtype,
                 cache_stats=True):
    """Reference result (a, sa) against the port's (b, sb)."""
    same = a == b
    assert same.mean() >= 0.99, f"ids agree in {same.mean():.4f}"
    if not same.all():
        if rerank == 0:
            da = _adc(cents, codes, q, a, adc_dtype)
            db = _adc(cents, codes, q, b, adc_dtype)
        else:
            da, db = _exact(vecs, q, a), _exact(vecs, q, b)
        gap = np.abs(da - db)[~same]
        scale = np.maximum(np.abs(da), np.abs(db))[~same]
        assert (gap <= 1e-5 * scale).all(), \
            f"a differing entry is no near tie: {gap} vs {scale}"
    keys = STAT_KEYS + (CACHE_KEYS if cache_stats else ())
    for i in np.flatnonzero(same.all(axis=1)):
        for key in keys:
            assert getattr(sa[i], key) == getattr(sb[i], key), (i, key)
        np.testing.assert_allclose(sb[i].entry_dist, sa[i].entry_dist,
                                   rtol=1e-5)


@pytest.mark.parametrize("prefetch,pipeline", [(0, None), (4, True),
                                               (4, False)],
                         ids=["serial", "pipelined", "prefetch"])
@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("rerank", [None, 0, 20], ids=["pool", "pq", "r20"])
@pytest.mark.parametrize("adc_dtype", ["f32", "int8"])
@pytest.mark.parametrize("kind", KINDS)
def test_search_batch_matches_reference(dirs, small_corpus, pq_artifacts,
                                        kind, adc_dtype, rerank, w,
                                        prefetch, pipeline):
    path, vecs = dirs[kind]
    _, q, _ = small_corpus
    cents, codes = pq_artifacts
    kw = dict(L=40, w=w, adc_dtype=adc_dtype, rerank=rerank,
              prefetch=prefetch, pipeline=pipeline)
    j = jio.HostIndex.load(path)
    t = tio.HostIndex.load(path, device="cpu")
    try:
        a, sa = j.search_batch(q, 10, **kw)
        b, sb = t.search_batch(q, 10, **kw)
    finally:
        j.close(), t.close()
    check_parity(a, sa, b, sb, q, vecs, cents, codes, rerank=rerank,
                 adc_dtype=adc_dtype, cache_stats=prefetch == 0)


@pytest.mark.parametrize("entry", ["auto", "nav", "medoid"])
@pytest.mark.parametrize("adc_dtype", ["f32", "int8"])
def test_nav_entry_modes_match_reference(dirs, small_corpus, pq_artifacts,
                                         entry, adc_dtype):
    path, vecs = dirs["nav"]
    _, q, _ = small_corpus
    cents, codes = pq_artifacts
    j = jio.HostIndex.load(path)
    t = tio.HostIndex.load(path, device="cpu")
    try:
        assert t.nav is not None
        a, sa = j.search_batch(q, 10, L=40, adc_dtype=adc_dtype, rerank=20,
                               entry=entry)
        b, sb = t.search_batch(q, 10, L=40, adc_dtype=adc_dtype, rerank=20,
                               entry=entry)
    finally:
        j.close(), t.close()
    check_parity(a, sa, b, sb, q, vecs, cents, codes, rerank=20,
                 adc_dtype=adc_dtype)
    assert (np.array([s.nav_hops for s in sb]) > 0).all() == \
        (entry != "medoid")


@pytest.mark.parametrize("rerank", [None, 0, 20], ids=["pool", "pq", "r20"])
@pytest.mark.parametrize("adc_dtype", ["f32", "int8"])
@pytest.mark.parametrize("kind", KINDS)
def test_search_batch_bit_identical_to_own_oracle(dirs, small_corpus, kind,
                                                  adc_dtype, rerank):
    """The port's batched path returns its scalar oracle's ids exactly, and
    the same logical I/O (half the queries: the oracle is slow)."""
    path, _ = dirs[kind]
    q = small_corpus[1][:6]
    t = tio.HostIndex.load(path, device="cpu")
    try:
        ref, sref = t.search_batch_ref(q, 10, L=40, adc_dtype=adc_dtype,
                                       rerank=rerank)
        t.cache.clear()
        ids, st = t.search_batch(q, 10, L=40, prefetch=4, pipeline=True,
                                 adc_dtype=adc_dtype, rerank=rerank)
        np.testing.assert_array_equal(ids, ref)
        assert [s.ios for s in st] == [s.ios for s in sref]
        assert [s.pq_dists for s in st] == [s.pq_dists for s in sref]
        one, s1 = t.search(q[3], 10, L=40, w=1, adc_dtype=adc_dtype,
                           rerank=rerank)
        ref1, sr1 = t.search_ref(q[3], 10, L=40, w=1, adc_dtype=adc_dtype,
                                 rerank=rerank)
        np.testing.assert_array_equal(one, ref1)
        assert s1.hops == sr1.hops
    finally:
        t.close()


@pytest.mark.parametrize("adc_dtype", ["f32", "int8"])
def test_recall_and_placement_identity(index_dirs, small_corpus, adc_dtype):
    """The reference's limits (tests/test_index_host.py): recall@1 >= 0.9
    and recall@10 >= 0.8 in both placements, and both give the same ids."""
    _, q, gt = small_corpus
    out = {}
    for mode, path in index_dirs.items():
        idx = tio.HostIndex.load(path, device="cpu")
        ids, stats = idx.search_batch(q, 10, L=40, adc_dtype=adc_dtype)
        out[mode] = ids
        assert recall_at(ids, gt, 1) >= 0.9, mode
        assert recall_at(ids, gt, 10) >= 0.8, mode
        assert stats[0].ios > 0 and stats[0].hops > 0
        idx.close()
    np.testing.assert_array_equal(out["aisaq"], out["diskann"])


def test_resident_bytes_identities(index_dirs, dirs, small_corpus):
    """Table 2: AiSAQ residency excludes the (N, m) code table, which
    diskann mode keeps on the search's device; the nav tier is charged."""
    base = small_corpus[0]
    a = tio.HostIndex.load(index_dirs["aisaq"], device="cpu")
    d = tio.HostIndex.load(index_dirs["diskann"], device="cpu")
    nav = tio.HostIndex.load(dirs["nav"][0], device="cpu")
    j = jio.HostIndex.load(dirs["nav"][0])
    try:
        n, m = base.shape[0], a.meta["pq_m"]
        assert d.resident_bytes() - a.resident_bytes() == n * m
        assert a.resident_bytes() == a.centroids.nbytes + a.ep_codes.nbytes
        assert isinstance(d.pq_codes, torch.Tensor) and d.pq_codes.shape \
            == (n, m)
        assert nav.resident_bytes() == j.resident_bytes() > \
            a.resident_bytes()
        assert a.load_time_s < d.load_time_s * 1.5 + 0.05
    finally:
        for h in (a, d, nav, j):
            h.close()


@pytest.mark.parametrize("kind", ["aisaq", "relabel"])
def test_exact_distances_and_host_search_fns(dirs, small_corpus, kind):
    """`exact_distances` equals the reference's for result labels (padding
    +inf), and the host search factories return the search's ids."""
    from repro.serving import engine as jeng
    path, _ = dirs[kind]
    _, q, _ = small_corpus
    t = tio.HostIndex.load(path, device="cpu")
    j = jio.HostIndex.load(path)
    try:
        fn = teng.make_host_search_dist_fn(t, L=40, rerank=20, prefetch=2)
        ids, dists = fn(q, 10)
        want_ids, _ = t.search_batch(q, 10, L=40, rerank=20, prefetch=2)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(
            teng.make_host_search_fn(t, L=40, rerank=20)(q, 10), want_ids)
        ids = ids.copy()
        ids[0, -2:] = -1
        got = teng.exact_distances(t, q, ids)
        want = jeng.exact_distances(j, q, ids)
        assert np.isinf(got[0, -2:]).all()
        np.testing.assert_allclose(got, want, rtol=1e-4)
    finally:
        t.close(), j.close()


def test_request_carries_deadline_dists_and_span():
    r = teng.Request(query=np.zeros(4, np.float32), deadline=0.0)
    assert r.expired(now=1.0) and not teng.Request(
        query=np.zeros(4, np.float32)).expired()
    assert r.dists is None and r.span is None


def test_loader_refuses_a_pending_journal(dirs, tmp_path):
    import shutil
    p = str(tmp_path / "idx")
    shutil.copytree(dirs["aisaq"][0], p)
    with open(os.path.join(p, tio.WAL_NAME), "wb") as f:
        f.write(b"x")
    with pytest.raises(tio.CorruptIndexError, match="write-ahead journal"):
        tio.HostIndex.load(p, device="cpu")


def test_shared_centroid_switch_reloads_nothing(tmp_path, small_corpus,
                                                pq_artifacts, monkeypatch):
    """Table 4 (tests/test_index_host.py): switching between indices that
    share PQ centroids reuses the pooled array and reads no
    pq_centroids.npy."""
    from repro_torch.configs import IndexConfig
    from repro_torch.core.build import build_index
    base, q, _ = small_corpus
    cents, _ = pq_artifacts
    cfg = IndexConfig(name="sub", n_vectors=400, dim=base.shape[1], R=12,
                      pq_m=12, build_L=24)
    paths = {}
    for i in range(3):
        p = str(tmp_path / f"sub{i}")
        build_index(p, base[i * 400:(i + 1) * 400], cfg, mode="aisaq",
                    shared_centroids=cents, device="cpu")
        paths[f"c{i}"] = p
    loads = []
    real_load = np.load

    def counting_load(f, *a, **kw):
        loads.append(os.path.basename(str(f)))
        return real_load(f, *a, **kw)

    mgr = IndexManager(paths, device="cpu")
    try:
        t_first = mgr.switch("c0")
        cents_c0 = mgr.active.centroids
        monkeypatch.setattr(np, "load", counting_load)
        t_shared = mgr.switch("c1")
        monkeypatch.undo()
        ids, stats = mgr.search(q[0], 5, L=24)
        assert ids.shape == (5,) and t_first > 0 and t_shared > 0
        assert mgr.active.centroids is cents_c0
        assert "pq_centroids.npy" not in loads and "ep_codes.npy" in loads
        assert mgr.resident_bytes() > 0
    finally:
        mgr.close()


def test_serve_main_on_the_cpu(dirs, capsys):
    """`launch.serve.main` over two corpora with --device cpu."""
    from repro_torch.launch import serve
    report = serve.main(["--device", "cpu", "--queries", "20",
                         "--corpora", f"a={dirs['aisaq'][0]}",
                         f"b={dirs['relabel'][0]}"])
    out = capsys.readouterr().out
    assert "served 20 queries" in out and "on cpu" in out
    assert report["qps"] > 0 and report["latency"]["n"] == 20
    assert report["switches"] >= 1 and report["resident_bytes"] > 0
