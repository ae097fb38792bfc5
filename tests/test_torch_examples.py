"""The port's five examples (`examples/*_torch.py`) against the reference's
own calls, on the CPU at tiny sizes: the same inputs and steps through the
JAX package and through each example's `run(device="cpu")`.

- quickstart: given the reference's `jax.random.choice` centroid rows
  (`init_idx`), both index directories equal the reference's file for
  file (the centroids within 1e-5, as tests/test_torch_build.py holds
  them; the clock held still for the navigation tier's npz), and the
  ids of the medoid, prefetch-4 and nav-entry searches are equal.
- dynamic_corpus: ids equal after the inserts, the deletes and the
  filter (the example calls `search`, which filters tombstones in both
  packages).
- rag_retrieval: given the reference's `jax.random.choice` rows for the
  shared codebook, the 12 answers and the pool's counts are equal.
- distributed_search: on a (2, 2) grid (4 spawned gloo ranks) against the
  reference's `sharded_search_fn` on 4 virtual XLA CPU devices in a
  subprocess: ids equal, distances within rtol 1e-5, atol 1e-4
  (tests/test_torch_sharded.py's).
- train_lm: tiny_lm, 30 steps with a failure before step 27 (resumed
  from the step-25 checkpoint): one restart, every loss bit-equal to an
  uninterrupted port run, the first within 1e-4 of the reference's
  `train_loop` from the same state (`train_state_from_jax`). The port's
  runs take one CPU thread: with several, torch's CPU backward adds some
  sums in an order that varies from run to run (two uninterrupted runs
  then differ by ~1e-6 within a dozen steps), while the card's restart
  is checked bit for bit by chip_smoke.py.

jax is imported inside the tests: the distributed example's spawned ranks
import only torch and the port.
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import distributed_search_torch  # noqa: E402
import dynamic_corpus_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import rag_retrieval_torch  # noqa: E402
import train_lm_torch  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
TOL_LOSS = 1e-4


def _ref_rows(n: int, seed: int = 0) -> np.ndarray:
    """The reference's initial centroid rows: `pq.train_codebooks`'s
    `jax.random.choice` draw from PRNGKey(seed)."""
    import jax
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                        shape=(256,), replace=n < 256))


def _files(path) -> dict:
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


QUICK = dict(n=600, d=32, nq=8, R=12, pq_m=8, build_L=24, L=24)


def test_quickstart_matches_the_reference(tmp_path, monkeypatch):
    import json

    from repro.configs.base import IndexConfig
    from repro.core.build import build_index
    from repro.core.index_io import HostIndex
    from repro.data.vectors import make_clustered, make_queries
    monkeypatch.setattr(time, "localtime",
                        lambda *a: time.struct_time((2024, 1, 1, 0, 0, 0,
                                                     0, 1, 0)))
    n, d, L = QUICK["n"], QUICK["d"], QUICK["L"]
    got = quickstart_torch.run(device="cpu", init_idx=_ref_rows(n),
                               workdir=str(tmp_path / "port"), **QUICK)
    base = make_clustered(n, d, seed=0)
    queries = make_queries(QUICK["nq"], base)
    cfg = IndexConfig(name="quickstart", n_vectors=n, dim=d, R=QUICK["R"],
                      pq_m=QUICK["pq_m"], build_L=QUICK["build_L"])
    times = ("build_pq_s", "build_graph_s")
    for mode in ("aisaq", "diskann"):
        path = str(tmp_path / "ref" / mode)
        build_index(path, base, cfg, mode=mode, seed=0,
                    nav=(mode == "aisaq"))
        a, b = _files(path), _files(tmp_path / "port" / mode)
        assert sorted(a) == sorted(b)
        for f in a:
            if f == "pq_centroids.npy":
                np.testing.assert_allclose(
                    np.load(tmp_path / "port" / mode / f),
                    np.load(os.path.join(path, f)), atol=1e-5)
            elif f == "meta.json":
                ma, mb = json.loads(a[f]), json.loads(b[f])
                assert {k: v for k, v in ma.items() if k not in times} == \
                    {k: v for k, v in mb.items() if k not in times}
            else:
                assert a[f] == b[f], f"{mode}/{f}"
        idx = HostIndex.load(path)
        r = got["modes"][mode]
        ids, _ = idx.search_batch(queries, 10, L=L, entry="medoid")
        np.testing.assert_array_equal(r["ids"], ids)
        idx.cache.clear()
        ids, _ = idx.search_batch(queries, 10, L=L, prefetch=4,
                                  entry="medoid")
        np.testing.assert_array_equal(r["ids_prefetch"], ids)
        if mode == "aisaq":
            ids, _ = idx.search_batch(queries, 10, L=L, entry="nav")
            np.testing.assert_array_equal(r["ids_nav"], ids)
            assert r["nav_pivots"] == idx.nav.params["pivots"]
        else:
            assert "ids_nav" not in r
        idx.close()
    assert got["same"]
    assert got["modes"]["aisaq"]["recall10"] >= 0.8


DYN = dict(n_base=500, n_new=40, d=32, R=12, pq_m=8, build_L=24, L=24,
           probe=520, deleted=(500, 505))


def test_dynamic_corpus_matches_the_reference(tmp_path):
    from repro.configs.base import IndexConfig
    from repro.core.build import build_index
    from repro.core.dynamic import DynamicHostIndex
    from repro.data.vectors import make_clustered
    nb, nn, L = DYN["n_base"], DYN["n_new"], DYN["L"]
    got = dynamic_corpus_torch.run(device="cpu", init_idx=_ref_rows(nb),
                                   workdir=str(tmp_path / "port"), **DYN)
    base = make_clustered(nb + nn, DYN["d"], seed=0)
    cfg = IndexConfig(name="dyn", n_vectors=nb, dim=DYN["d"], R=DYN["R"],
                      pq_m=DYN["pq_m"], build_L=DYN["build_L"])
    path = str(tmp_path / "ref")
    build_index(path, base[:nb], cfg, mode="aisaq", seed=0)
    idx = DynamicHostIndex.load(path)
    labels = [idx.insert(base[nb + i]) for i in range(nn)]
    assert got["labels"] == labels
    q = base[DYN["probe"]].astype(np.float32)
    ids, _ = idx.search(q, 5, L=L)
    np.testing.assert_array_equal(got["ids_fresh"], ids)
    assert got["fresh_found"] and DYN["probe"] in ids
    for v in range(*DYN["deleted"]):
        idx.delete(v)
    lo, hi = DYN["deleted"]
    ids, _ = idx.search(base[(lo + hi) // 2].astype(np.float32), 5, L=L)
    np.testing.assert_array_equal(got["ids_deleted"], ids)
    assert got["deleted_excluded"]
    ids, _ = idx.search(q, 5, L=L, predicate=lambda i: i % 2 == 0)
    np.testing.assert_array_equal(got["ids_filtered"], ids)
    idx.close()
    assert got["all_even"] and got["reload_same"]
    assert got["reload_n"] == nb + nn


RAG = dict(d=32, n_per=400, pq_m=8, R=12, build_L=24)


def test_rag_retrieval_matches_the_reference(tmp_path):
    import jax

    from repro.configs.base import IndexConfig
    from repro.core import pq
    from repro.core.build import build_index
    from repro.data.vectors import make_clustered, make_queries
    from repro.serving import RetrievalService, WarmIndexPool
    n_per = RAG["n_per"]
    everything = make_clustered(3 * n_per, RAG["d"], seed=0)
    cb = pq.train_codebooks(jax.random.PRNGKey(0), everything,
                            m=RAG["pq_m"])
    cents = np.asarray(cb.centroids)
    got = rag_retrieval_torch.run(device="cpu",
                                  init_idx=_ref_rows(3 * n_per),
                                  workdir=str(tmp_path / "port"), **RAG)
    cfg = IndexConfig(name="rag", n_vectors=n_per, dim=RAG["d"],
                      R=RAG["R"], pq_m=RAG["pq_m"],
                      build_L=RAG["build_L"])
    corpora = {}
    for i, name in enumerate(rag_retrieval_torch.CORPORA):
        p = str(tmp_path / "ref" / name)
        build_index(p, everything[i * n_per:(i + 1) * n_per], cfg,
                    mode="aisaq", shared_centroids=cents)
        corpora[name] = p
    pool = WarmIndexPool(corpora, budget_bytes=64 << 20,
                         cache_bytes=2 << 20)
    svc = RetrievalService(pool, num_workers=2, max_wait_ms=1.0, L=32,
                           rerank=20)
    chain = rag_retrieval_torch.CHAIN
    queries = make_queries(len(chain), everything, seed=3)
    try:
        want = [np.asarray(svc.submit_wait(queries[s], corpus=c, k=5)
                           .result) for s, c in enumerate(chain)]
        ps = svc.stats()["pool"]
    finally:
        svc.stop()
        pool.close()
    np.testing.assert_array_equal(got["queries"], queries)
    assert len(got["answers"]) == len(want) == 12
    for s, (a, b) in enumerate(zip(got["answers"], want)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {s}")
    for key in ("open", "registered", "evictions", "centroid_shares"):
        assert got["pool"][key] == ps[key], key
    assert got["pool"]["open"] == 3 and got["pool"]["evictions"] == 0


DIST = dict(n=800, d=32, m=8, R=12, nq=8, grid=(2, 2))

_REFERENCE_DIST = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import pq
from repro.core.chunk_layout import ChunkLayout
from repro.core.sharded_search import (input_sharding, sharded_search_fn,
                                       stack_shards)
from repro.core.vamana import build_sharded
from repro.data.vectors import make_clustered, make_queries
from repro.launch.mesh import make_test_mesh
out, kw = sys.argv[1], eval(sys.argv[2])
n, d, m, R = kw['n'], kw['d'], kw['m'], kw['R']
base = make_clustered(n, d, seed=0)
queries = make_queries(kw['nq'], base)
cb = pq.train_codebooks(jax.random.PRNGKey(0), base, m=m)
cents, codes = np.asarray(cb.centroids), np.asarray(pq.encode(cb, base))
lay = ChunkLayout('aisaq', d, 'float32', R, m)
shards = build_sharded(base, kw['grid'][1], R=R, L=32, seed=0)
arrays = stack_shards(shards, cents, codes, lay)
mesh = make_test_mesh(kw['grid'], ('data', 'model'))
search = jax.jit(sharded_search_fn(
    mesh, k=10, L=48, w=4, max_hops=64, layout=lay, metric='l2',
    backend='ref'))
ash, qsh = input_sharding(mesh)
arrays = jax.tree.map(jax.device_put, arrays, ash)
ids, dists = search(arrays, jax.device_put(jnp.asarray(queries), qsh))
np.savez(out, ids=np.asarray(ids), d=np.asarray(dists))
"""


def test_distributed_search_matches_the_reference(tmp_path):
    out = str(tmp_path / "ref.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run([sys.executable, "-c", _REFERENCE_DIST, out,
                          repr(DIST)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert ref.returncode == 0, ref.stdout + ref.stderr[-3000:]
    want = np.load(out)
    got = distributed_search_torch.run(device="cpu",
                                       init_idx=_ref_rows(DIST["n"]),
                                       workdir=str(tmp_path), **DIST)
    assert len(got["ranks"]) == 4 and got["n_shards"] == 2
    assert got["ids"].shape == (DIST["nq"], 10)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_allclose(got["d"], want["d"], rtol=RTOL, atol=ATOL)
    assert got["recall10"] >= 0.8
    # the CPU path launches no kernel
    assert not any(n for a in got["ranks"].values()
                   for n in a["launches"].values())


def _losses_by_step(out) -> dict:
    steps = {}
    for seg in out["segments"]:
        for i, loss in enumerate(seg["losses"]):
            steps.setdefault(seg["start"] + i, []).append(loss)
    return steps


def test_train_lm_restart_matches_an_uninterrupted_run_and_the_reference(
        tmp_path):
    import jax

    from repro.launch import train as jtrain
    from repro_torch.distributed.train_step import train_state_from_jax
    _, jinit, _, _, _ = jtrain.build_trainer("qwen3-1.7b", "train_4k",
                                             steps=30)
    jstate = jax.tree_util.tree_map(np.asarray, jinit())
    want = jtrain.train_loop("qwen3-1.7b", "train_4k", steps=30,
                             verbose=False)["losses"]
    kw = dict(device="cpu", steps=30, widths=None, verbose=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = train_lm_torch.run(
            fail_at=27, workdir=str(tmp_path / "restart"),
            init_state=train_state_from_jax(jstate, device="cpu"), **kw)
        full = train_lm_torch.run(
            workdir=str(tmp_path / "full"),
            init_state=train_state_from_jax(jstate, device="cpu"), **kw)
    finally:
        torch.set_num_threads(threads)
    assert got["final_step"] == full["final_step"] == 30
    assert got["restarts"] == 1 and full["restarts"] == 0
    assert [(s["start"], len(s["losses"]), s["failed"])
            for s in got["segments"]] == [(0, 27, True), (25, 5, False)]
    (once,) = full["segments"]
    steps = _losses_by_step(got)
    assert sorted(steps) == list(range(30))
    for step, losses in steps.items():
        for loss in losses:            # steps 25 and 26 ran twice
            assert loss == once["losses"][step], step
    assert all(np.isfinite(once["losses"]))
    assert once["losses"][0] == pytest.approx(want[0], abs=TOL_LOSS)
    assert once["losses"][-1] < once["losses"][0]
