"""The port's index writer, metadata check, index build and build CLI
against `repro.core.index_io` / `repro.core.build` on the conftest corpus,
and the modules they need (`relabel`, `chunk_layout`, `pq`) on the cases
of the reference's own tests."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import IndexConfig as JIndexConfig
from repro.core import build as jbuild
from repro.core import chunk_layout as jcl
from repro.core import device_index as jdi
from repro.core import index_io as jio
from repro.core import pq as jpq
from repro.core import relabel as jrl
from repro_torch.configs import IndexConfig
from repro_torch.core import build as tbuild
from repro_torch.core import chunk_layout as tcl
from repro_torch.core import device_index as tdi
from repro_torch.core import index_io as tio
from repro_torch.core import pq as tpq
from repro_torch.core import relabel as trl
from repro_torch.core.integrity import CorruptIndexError

FILES = ("meta.json", "chunks.bin", "block_crc.npy", "pq_centroids.npy",
         "pq_codes.npy", "ep_codes.npy", "id_map.npy", "labels.npy")


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def _u8(base):
    lo, hi = base.min(), base.max()
    return np.clip((base - lo) / (hi - lo) * 255, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("labels", [False, True], ids=["ids", "labels"])
@pytest.mark.parametrize("relabel", [False, True], ids=["plain", "relabel"])
@pytest.mark.parametrize("mode", ["aisaq", "diskann"])
@pytest.mark.parametrize("dt", ["float32", "uint8"])
def test_write_index_bytes_equal_reference(tmp_path, small_corpus,
                                           built_graph, pq_artifacts, dt,
                                           mode, relabel, labels):
    """Same numpy inputs: every file of the directory is byte-equal, and
    the directory loads into the same arrays in HostIndex.load and both
    packages' load_device_index."""
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    vecs = base if dt == "float32" else _u8(base)
    lab = (np.arange(len(vecs)) * 7 + 3) if labels else None
    kw = dict(vectors=vecs, graph=built_graph, centroids=cents, codes=codes,
              metric="l2", mode=mode, relabel=relabel, labels=lab)
    want = jio.write_index(str(tmp_path / "ref"), **kw)
    got = tio.write_index(str(tmp_path / "port"), **kw)
    assert got == want
    a, b = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert set(a) == set(b) <= set(FILES)
    assert ("id_map.npy" in b) == relabel and ("labels.npy" in b) == labels
    for f in a:
        assert a[f] == b[f], f
    assert not os.path.exists(str(tmp_path / "port") + ".tmp")

    host = jio.HostIndex.load(str(tmp_path / "port"))
    try:
        jidx, jlay, _ = jdi.load_device_index(str(tmp_path / "port"))
        tidx, tlay, metric = tdi.load_device_index(str(tmp_path / "port"),
                                                   device="cpu")
        assert metric == "l2" and tlay.device_stride == jlay.device_stride
        for f in ("chunk_words", "centroids", "ep_ids", "ep_codes"):
            np.testing.assert_array_equal(getattr(tidx, f).numpy(),
                                          np.asarray(getattr(jidx, f)), f)
        np.testing.assert_array_equal(host.centroids, tidx.centroids.numpy())
        np.testing.assert_array_equal(host.ep_codes, tidx.ep_codes.numpy())
        if mode == "diskann":
            o2n = (np.load(tmp_path / "port" / "id_map.npy") if relabel
                   else np.arange(len(vecs)))
            np.testing.assert_array_equal(host.pq_codes[o2n],
                                          tidx.pq_codes.numpy())
    finally:
        host.close()


def test_write_index_replaces_an_index_atomically(tmp_path, small_corpus,
                                                  built_graph, pq_artifacts):
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    path = str(tmp_path / "idx")
    kw = dict(graph=built_graph, centroids=cents, codes=codes, metric="l2",
              mode="aisaq")
    tio.write_index(path, vectors=base, **kw)
    meta = tio.write_index(path, vectors=base[::-1].copy(), **kw)
    assert tio.load_meta(path) == meta
    assert sorted(os.listdir(tmp_path)) == ["idx"]
    tio._atomic_json(os.path.join(path, "extra.json"), {"a": 1})
    tio._atomic_npy(os.path.join(path, "extra.npy"), np.arange(3))
    assert json.load(open(os.path.join(path, "extra.json"))) == {"a": 1}
    np.testing.assert_array_equal(np.load(os.path.join(path, "extra.npy")),
                                  np.arange(3))


def test_write_index_takes_tensors(tmp_path, small_corpus, built_graph,
                                   pq_artifacts):
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    kw = dict(metric="l2", mode="aisaq")
    jio.write_index(str(tmp_path / "ref"), vectors=base, graph=built_graph,
                    centroids=cents, codes=codes, **kw)
    tio.write_index(str(tmp_path / "port"), vectors=torch.from_numpy(base),
                    graph=torch.from_numpy(built_graph),
                    centroids=torch.from_numpy(cents),
                    codes=torch.from_numpy(codes), **kw)
    assert _files(tmp_path / "ref") == _files(tmp_path / "port")


def test_nav_is_not_ported(tmp_path, small_corpus, built_graph,
                           pq_artifacts, monkeypatch):
    """The navigation tier is ported now (the name is kept from when nav
    raised): write_index(nav=True) and build_index(nav=True) write the
    reference's directory byte for byte. np.savez stamps each member with
    the local time, so the clock is held still while both write."""
    import time
    monkeypatch.setattr(time, "localtime",
                        lambda *a: time.struct_time((2024, 1, 1, 0, 0, 0,
                                                     0, 1, 0)))
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    for relabel in (False, True):
        kw = dict(vectors=base, graph=built_graph, centroids=cents,
                  codes=codes, metric="l2", mode="aisaq", nav=True,
                  nav_fraction=0.03, relabel=relabel)
        want = jio.write_index(str(tmp_path / f"ref{relabel}"), **kw)
        got = tio.write_index(str(tmp_path / f"port{relabel}"), **kw)
        assert got == want and "nav" in got
        a = _files(tmp_path / f"ref{relabel}")
        assert a == _files(tmp_path / f"port{relabel}")
        assert "nav_graph.npz" in a
    jcfg, cfg = _cfgs(len(base))
    kw = dict(graph=built_graph, seed=3, shared_centroids=cents, nav=True,
              nav_degree=6)
    want = jbuild.build_index(str(tmp_path / "bref"), base, jcfg, **kw)
    got = tbuild.build_index(str(tmp_path / "bport"), base, cfg, **kw,
                             device="cpu")
    times = ("build_pq_s", "build_graph_s")
    assert {k: v for k, v in got.items() if k not in times} == \
        {k: v for k, v in want.items() if k not in times}
    a, b = _files(tmp_path / "bref"), _files(tmp_path / "bport")
    for f in ("chunks.bin", "pq_codes.npy", "nav_graph.npz"):
        assert a[f] == b[f], f


@pytest.mark.parametrize("damage", ["missing", "truncated", "no_keys",
                                    "format_4", "not_a_dict"])
def test_load_meta_rejects_damaged_meta(index_dirs, tmp_path, damage):
    good = json.load(open(os.path.join(index_dirs["aisaq"], "meta.json")))
    assert tio.load_meta(index_dirs["aisaq"]) == \
        jio.load_meta(index_dirs["aisaq"]) == good
    path = tmp_path / "idx"
    path.mkdir()
    text = {"missing": None,
            "truncated": json.dumps(good)[:40],
            "no_keys": json.dumps({k: v for k, v in good.items()
                                   if k != "entry_points"}),
            "format_4": json.dumps(dict(good, format_version=4)),
            "not_a_dict": "[1, 2]"}[damage]
    if text is not None:
        (path / "meta.json").write_text(text)
    for load in (tio.load_meta, jio.load_meta):
        with pytest.raises(CorruptIndexError if load is tio.load_meta
                           else jio.CorruptIndexError):
            load(str(path))


def _cfgs(n, **kw):
    args = dict(name="t", n_vectors=n, dim=48, R=20, pq_m=12, build_L=40)
    args.update(kw)
    return JIndexConfig(**args), IndexConfig(**args)


@pytest.mark.parametrize("pq_from", ["init_idx", "shared_centroids"])
@pytest.mark.parametrize("mode", ["aisaq", "diskann"])
def test_build_index_matches_reference(tmp_path, small_corpus, built_graph,
                                       pq_artifacts, pq_from, mode):
    """Given the reference's initial centroid rows (its jax.random draw) or
    shared centroids, and a given graph: the same chunks.bin and
    pq_codes.npy, and the same meta.json apart from the build times."""
    base, _, _ = small_corpus
    jcfg, cfg = _cfgs(len(base), mode=mode)
    kw = dict(graph=built_graph, seed=3)
    if pq_from == "shared_centroids":
        kw["shared_centroids"] = pq_artifacts[0]
        tkw = {}
    else:
        tkw = dict(init_idx=np.asarray(jax.random.choice(
            jax.random.PRNGKey(3), len(base), shape=(256,), replace=False)))
    want = jbuild.build_index(str(tmp_path / "ref"), base, jcfg, **kw)
    got = tbuild.build_index(str(tmp_path / "port"), base, cfg, **kw, **tkw,
                             device="cpu")
    times = ("build_pq_s", "build_graph_s")
    assert {k: v for k, v in got.items() if k not in times} == \
        {k: v for k, v in want.items() if k not in times}
    a, b = _files(tmp_path / "ref"), _files(tmp_path / "port")
    for f in ("chunks.bin", "pq_codes.npy", "ep_codes.npy", "block_crc.npy"):
        assert a[f] == b[f], f
    np.testing.assert_allclose(np.load(tmp_path / "port/pq_centroids.npy"),
                               np.load(tmp_path / "ref/pq_centroids.npy"),
                               atol=1e-5)


def test_build_index_draws_init_from_a_torch_generator(tmp_path,
                                                       small_corpus,
                                                       built_graph):
    base, q, gt = small_corpus
    _, cfg = _cfgs(len(base))
    meta = tbuild.build_index(str(tmp_path / "a"), base, cfg, seed=5,
                              graph=built_graph, device="cpu")
    again = tbuild.build_index(str(tmp_path / "b"), base, cfg, seed=5,
                               graph=built_graph, device="cpu")
    assert meta["pq_init"] == "torch.Generator(seed=5)"
    assert _files(tmp_path / "a")["chunks.bin"] == \
        _files(tmp_path / "b")["chunks.bin"]
    assert {k: v for k, v in meta.items() if not k.startswith("build_")} \
        == {k: v for k, v in again.items() if not k.startswith("build_")}
    idx = tbuild.draw_init_idx(len(base), 256, 5)
    assert len(set(idx.tolist())) == 256
    assert len(tbuild.draw_init_idx(100, 256, 5)) == 256
    tidx, tlay, _ = tdi.load_device_index(str(tmp_path / "a"), device="cpu")
    ids, _, _ = tdi.beam_search_device(tidx, torch.from_numpy(q), k=10,
                                       L=40, layout=tlay)
    assert jio.recall_at(ids.numpy(), gt, 10) >= 0.8


def test_build_index_runs_on_the_card_unless_asked(tmp_path, small_corpus,
                                                   built_graph):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: build_index runs on it")
    base, _, _ = small_corpus
    _, cfg = _cfgs(len(base))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbuild.build_index(str(tmp_path / "x"), base, cfg, graph=built_graph)
    assert not os.path.exists(tmp_path / "x")


def test_build_cli_on_the_cpu(tmp_path):
    """python -m repro_torch.launch.build_index --device cpu: one index,
    then two shards; each loads in the reference's HostIndex."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    args = [sys.executable, "-m", "repro_torch.launch.build_index",
            "--n", "400", "--dim", "16", "--R", "8", "--pq-m", "4",
            "--build-L", "16", "--device", "cpu"]
    for extra, dirs in (([], ["one"]), (["--shards", "2"],
                                        ["two/shard0", "two/shard1"])):
        out = str(tmp_path / dirs[0].split("/")[0])
        res = subprocess.run(args + ["--out", out] + extra, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert "built" in res.stdout
        for d in dirs:
            meta = tio.load_meta(str(tmp_path / d))
            assert meta["pq_m"] == 4 and meta["R"] == 8
            host = jio.HostIndex.load(str(tmp_path / d))
            host.close()
    assert tio.load_meta(str(tmp_path / "two/shard0"))["n"] == 200


# ---------------------------------------------------------------------------
# the modules the writer needs, on the cases of the reference's tests
# ---------------------------------------------------------------------------


def _random_graph(rng, n, R):
    g = rng.integers(0, n, size=(n, R)).astype(np.int32)
    g[rng.random(size=g.shape) < 0.2] = -1      # ragged degrees
    return g


@pytest.mark.parametrize("n,R,npb,eps", [
    (500, 8, 4, [17]), (64, 6, 4, [3, 11]), (20, 3, 4, None),
    (300, 5, 0, [0]), (300, 5, 1, [2])])
def test_relabel_matches_reference(n, R, npb, eps):
    rng = np.random.default_rng(n + R)
    g = _random_graph(rng, n, R) if n != 20 else \
        np.full((20, 3), -1, dtype=np.int32)        # fully disconnected
    e = None if eps is None else np.array(eps)
    o2n = trl.locality_permutation(g, npb, e)
    np.testing.assert_array_equal(o2n, jrl.locality_permutation(g, npb, e))
    vecs = rng.normal(size=(n, 8)).astype(np.float32)
    codes = rng.integers(0, 256, size=(n, 4)).astype(np.uint8)
    ep = np.array(eps or [0])
    for a, b in zip(trl.apply_permutation(o2n, vecs, g, codes, ep),
                    jrl.apply_permutation(o2n, vecs, g, codes, ep)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trl.invert_permutation(o2n),
                                  jrl.invert_permutation(o2n))
    for p in (None, o2n):
        for k in (0, 2, 4):
            assert trl.block_locality_score(g, p, k) == \
                jrl.block_locality_score(g, p, k)


def test_relabel_improves_locality_as_reference(built_graph):
    for npb in (2, 4, 8):
        o2n = trl.locality_permutation(built_graph, npb, np.array([0]))
        assert trl.block_locality_score(built_graph, o2n, npb) > \
            trl.block_locality_score(built_graph, None, npb)


@pytest.mark.parametrize("dim,dt,R,m,bb", [
    (128, "float32", 56, 128, 4096), (128, "uint8", 52, 32, 4096),
    (1024, "float32", 69, 128, 4096), (32, "float32", 8, 8, 4096),
    (24, "float32", 10, 8, 4096), (24, "uint8", 10, 8, 512)])
@pytest.mark.parametrize("mode", ["aisaq", "diskann"])
def test_chunk_layout_matches_reference(mode, dim, dt, R, m, bb):
    t = tcl.ChunkLayout(mode, dim, dt, R, m, bb)
    j = jcl.ChunkLayout(mode, dim, dt, R, m, bb)
    assert t.describe() == j.describe()
    assert (t.off_vec, t.off_deg, t.off_ids) == (j.off_vec, j.off_deg,
                                                  j.off_ids)
    if mode == "aisaq":
        assert t.off_pq == j.off_pq
    else:
        with pytest.raises(ValueError):
            t.off_pq
    assert [t.file_offset(i) for i in range(60)] == \
        [j.file_offset(i) for i in range(60)]
    assert t.file_size(50) == j.file_size(50)
    rng = np.random.default_rng(dim + R)
    n = 50
    vecs = (rng.integers(0, 255, (n, dim)).astype(np.uint8) if dt == "uint8"
            else rng.normal(size=(n, dim)).astype(np.float32))
    adj = rng.integers(-1, n, (n, R)).astype(np.int32)
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    buf = tcl.pack_chunks_file(vecs, adj, codes, t, block_rows=7)
    assert buf == jcl.pack_chunks_file(vecs, adj, codes, j)
    raw = np.frombuffer(buf, np.uint8)
    for i in (0, 7, n - 1):
        off = t.file_offset(i)
        got = tcl.parse_chunk(raw[off:off + t.chunk_bytes], t)
        want = jcl.parse_chunk(raw[off:off + j.chunk_bytes], j)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[1], adj[i])


def test_layout_for_matches_reference():
    for mode in (None, "diskann"):
        a = tcl.layout_for(IndexConfig("x", 10, 96, R=24, pq_m=16), mode)
        b = jcl.layout_for(JIndexConfig("x", 10, 96, R=24, pq_m=16), mode)
        assert a.describe() == b.describe()


@pytest.fixture(scope="module")
def pq_data():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(2000, 32)).astype(np.float32)
    cb = jpq.train_codebooks(jax.random.PRNGKey(0), data, m=8, iters=4)
    return data, np.asarray(cb.centroids)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_pq_lut_adc_decode_match_reference(pq_data, metric):
    data, cents = pq_data
    jcb, tcb = jpq.PQCodebooks(jnp.asarray(cents)), \
        tpq.PQCodebooks(torch.from_numpy(cents))
    assert (tcb.m, tcb.ks, tcb.dsub, tcb.dim, tcb.nbytes()) == \
        (jcb.m, jcb.ks, jcb.dsub, jcb.dim, jcb.nbytes())
    codes = np.asarray(jpq.encode(jcb, data[:100]))
    q = data[500:503]
    lut = tpq.build_lut(tcb, torch.from_numpy(q), metric=metric)
    jlut = np.asarray(jpq.build_lut(jcb, q, metric=metric))
    np.testing.assert_allclose(lut.numpy(), jlut, rtol=1e-5, atol=1e-5)
    tc = torch.from_numpy(codes)
    d = tpq.adc(lut, tc)
    np.testing.assert_allclose(d.numpy(), np.asarray(jpq.adc(jlut, codes)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tpq.adc_onehot(lut, tc).numpy(), d.numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tpq.adc(lut[0], tc).numpy(), d[0].numpy())
    np.testing.assert_allclose(tpq.adc_onehot(lut[0], tc).numpy(),
                               d[0].numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tpq.adc(lut, tc.reshape(4, 25, 8)).numpy(),
                               d.numpy().reshape(3, 4, 25), rtol=1e-6)
    rec = tpq.decode(tcb, tc)
    np.testing.assert_array_equal(rec.numpy(),
                                  np.asarray(jpq.decode(jcb, codes)))
    # the reference's own check: ADC equals the exact distance to the
    # decoded vector
    exact = tpq.exact_distances(torch.from_numpy(q), rec, metric=metric)
    np.testing.assert_allclose(d.numpy(), exact.numpy(), rtol=2e-4,
                               atol=1e-3)
    with pytest.raises(ValueError, match="metric"):
        tpq.build_lut(tcb, torch.from_numpy(q), metric="cos")
