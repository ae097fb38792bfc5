"""The port's device serving factory and ServingEngine against
`repro.serving.engine.make_device_search_fn(backend="ref")`."""
import threading
import time

import jax.numpy as jnp  # noqa: F401  (JAX stays on the CPU in this process)
import numpy as np
import pytest

from repro.core.device_index import from_arrays as j_from_arrays
from repro.core.traversal import recall_at
from repro.serving.engine import make_device_search_fn as j_make_fn
from repro_torch.core.device_index import from_arrays
from repro_torch.serving.engine import ServingEngine, make_device_search_fn


@pytest.fixture(scope="module")
def both_indices(small_corpus, built_graph, pq_artifacts):
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    return (j_from_arrays(base, built_graph, cents, codes),
            from_arrays(base, built_graph, cents, codes, device="cpu"))


@pytest.mark.parametrize("adc", ["f32", "int8"])
@pytest.mark.parametrize("rerank", [0, 32])
def test_served_ids_match_jax(both_indices, small_corpus, adc, rerank):
    base, q, gt = small_corpus
    (jidx, jlay), (idx, lay) = both_indices
    want = j_make_fn(jidx, jlay, metric="l2", L=40, backend="ref",
                     adc_dtype=adc, rerank=rerank)(q, 10)
    fn = make_device_search_fn(idx, lay, metric="l2", L=40, adc_dtype=adc,
                               rerank=rerank, device="cpu")
    eng = ServingEngine({"default": fn}, max_batch=8, max_wait_ms=1.0)
    try:
        reqs = [eng.submit(x, k=10) for x in q]
        for r in reqs:
            assert r.event.wait(60.0) and r.error is None
    finally:
        eng.stop()
    got = np.stack([r.result for r in reqs])
    assert got.shape == (len(q), 10)
    overlap = np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(got, want)])
    assert overlap >= 0.99
    assert abs(recall_at(got, gt, 10) - recall_at(want, gt, 10)) <= 0.01
    assert recall_at(got, gt, 10) >= 0.8


def test_search_fn_refuses_index_on_other_device(both_indices):
    _, (idx, lay) = both_indices
    with pytest.raises(ValueError, match="lives on"):
        make_device_search_fn(idx, lay, device="meta")


def _echo_fn(delay=0.0):
    def fn(queries, k):
        time.sleep(delay)
        return np.tile(np.arange(k), (len(queries), 1))
    return fn


def test_engine_batches_and_keeps_corpora_apart():
    seen = []

    def fn(queries, k):
        seen.append(len(queries))
        return np.zeros((len(queries), k), dtype=np.int64)

    eng = ServingEngine({"a": fn, "b": _echo_fn()}, max_batch=4,
                        max_wait_ms=20.0)
    try:
        reqs = [eng.submit(np.zeros(4), corpus="a", k=3) for _ in range(8)]
        reqs += [eng.submit(np.zeros(4), corpus="b", k=2)]
        for r in reqs:
            assert r.event.wait(10.0) and r.error is None
    finally:
        eng.stop()
    assert max(seen) <= 4 and sum(seen) == 8
    assert reqs[-1].result.tolist() == [0, 1]
    assert eng.latency_percentiles()["n"] == 9


def test_engine_hedge_takes_first_success():
    def failing(queries, k):
        raise OSError("replica down")

    eng = ServingEngine({"default": _echo_fn()}, hedge=2,
                        replicas=[failing, _echo_fn(0.01)], max_wait_ms=1.0)
    try:
        r = eng.submit_wait(np.zeros(4), k=3, timeout=10.0)
    finally:
        eng.stop()
    assert r.error is None and r.result.tolist() == [0, 1, 2]
    assert eng.hedge_stats["failed"] >= 1


def test_engine_fails_batch_not_thread_and_stop_drains():
    def bad(queries, k):
        return np.zeros(3)              # malformed: not (B, k)

    eng = ServingEngine({"default": bad, "ok": _echo_fn()}, max_wait_ms=1.0)
    try:
        r = eng.submit_wait(np.zeros(4), k=2, timeout=10.0)
        assert isinstance(r.error, ValueError)
        r2 = eng.submit_wait(np.zeros(4), corpus="ok", k=2, timeout=10.0)
        assert r2.error is None
    finally:
        eng.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(np.zeros(4))
    assert not any(t.name == eng._t.name and t.is_alive()
                   for t in threading.enumerate())
