"""A whole run of each cell at a CPU size: the result's keys, the
comparison with the reference, and the faults it must catch."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from annbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = ("sift1m.b256", "kilt-e5.open")


def _run(cell, traced=False, seed=2**31 + 5):
    return harness.run(cell, seed, 0.5, traced, "cpu",
                       __import__("time").perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct_with_the_contracts_keys(tiny_cell, name):
    out = _run(tiny_cell(name))
    assert list(out) == KEYS
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = tiny_cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    json.dumps(out)


def test_traced_run_reads_the_host_metrics(tiny_cell):
    out = _run(tiny_cell("kilt-e5.open"), traced=True)
    assert out["correct"] is True
    # the CPU has no device trace: only the serving layer's metrics
    assert set(out["metrics"]) == {"engine_wait_ms", "batch_mean"}
    assert "breakdown" not in out and list(out)[-1] == "checks"


def _state_unchanged(mp):
    # each hop leaves the search state as it was; only the hop counter
    # moves, so the loop still ends (at max_hops)
    from repro_torch.core import device_index
    mp.setattr(device_index._Search, "hop",
               lambda self: self.hop_count.add_(1))


def _half_batch(mp):
    from repro_torch.serving import engine
    real = engine.beam_search_device

    def half(index, queries, **kw):
        n = queries.shape[0]
        h = max(1, n // 2)
        ids, d, hops = real(index, queries[:h], **kw)
        reps = -(-n // h)
        return ids.repeat(reps, 1)[:n], d.repeat(reps, 1)[:n], hops

    mp.setattr(engine, "beam_search_device", half)


def _answer_altered(mp):
    from repro_torch.kernels import ops
    real = ops.rerank_rows

    def altered(*a, **kw):
        d = real(*a, **kw).clone()
        d[:, 0] = float("inf")
        return d

    mp.setattr(ops, "rerank_rows", altered)


def _wrong_entry(mp):
    # the index starts its searches from the row after the right one
    from repro_torch.core import device_index
    real = device_index.from_arrays

    def shifted(*a, **kw):
        idx, lay = real(*a, **kw)
        idx.ep_ids = (idx.ep_ids + 1) % idx.n
        idx.ep_codes = a[3][idx.ep_ids.long()].to(idx.ep_codes.dtype)
        return idx, lay

    mp.setattr(device_index, "from_arrays", shifted)


@pytest.mark.parametrize("fault, check", [
    (_state_unchanged, "answers_differing"),
    (_half_batch, "answers_differing"),
    (_answer_altered, "answers_differing"),
    (_wrong_entry, "answers_differing"),
    (_wrong_entry, "entry_gap")])
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_the_run_incorrect(tiny_cell, monkeypatch, name, fault,
                                       check):
    fault(monkeypatch)
    out = _run(tiny_cell(name))
    assert out["correct"] is False
    c = out["checks"][check]
    assert c["value"] > c["limit"]


def test_misrouted_calls_are_caught():
    pool = np.arange(12, dtype=np.float32).reshape(6, 2)
    rec = harness.Recorder(lambda q, k: np.zeros((len(q), k)), pool)
    rec(pool[:2], 3)
    with pytest.raises(RuntimeError):
        rec(pool[3:5], 3)
    assert rec.misrouted == 1


def test_arrivals_keep_the_gaps_and_shuffle_them():
    tr = {"arrival": "poisson", "rate_per_s": 500, "gap_seed": 9}
    a, b = harness.arrivals(tr, 2.0, 1), harness.arrivals(tr, 2.0, 2)
    assert len(a) == len(b) == 1000 and a[0] == b[0] == 0.0
    # the gaps, the last one running to the window's close
    gaps = [np.sort(np.append(np.diff(x), 2.0 - x[-1])) for x in (a, b)]
    assert np.allclose(gaps[0], gaps[1])
    assert not np.allclose(a, b) and a[-1] < 2.0


def test_unknown_arrivals_and_kinds_raise(tmp_path, monkeypatch):
    with pytest.raises(ValueError):
        harness.arrivals({"arrival": "bursts", "rate_per_s": 10,
                          "gap_seed": 1}, 1.0, 1)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "x.json").write_text('{"kind": "replay"}')
    monkeypatch.setattr(harness, "HERE", tmp_path)
    with pytest.raises(ValueError):
        harness.load_traffic("x")


@pytest.mark.parametrize("max_batch, sizes", [
    (64, [1, 2, 4, 8, 16, 32, 63, 64]),
    (48, [1, 2, 4, 8, 16, 32, 47, 48]),
    (2, [1, 2])])
def test_warm_sizes_cover_each_padded_size(max_batch, sizes):
    assert harness.warm_sizes({"kind": "open",
                               "max_batch": max_batch}) == sizes
    assert harness.warm_sizes({"kind": "closed", "batch": 256}) == [256] * 2


@pytest.mark.parametrize("seen, kept", [(200, True), (198, True),
                                         (197, False), (201, False)])
def test_traced_window_may_lose_one_percent_of_hops(seen, kept):
    import torch
    from annbench import reference, trace
    w = trace.Window(lo=0.0, hi=1.0)
    w.device = [(trace.HOP, i / 400, i / 400 + 1e-3) for i in range(seen)]
    ans = reference.Answers(ids=torch.zeros(4, 10), hops=torch.ones(4),
                            lanes=torch.ones(4))
    r = harness.Readings(config={}, traffic={}, device_kind="gpu",
                         setup_s=1.0, window_s=1.0, attempted=4,
                         completed=4)
    harness._traced_readings(r, (w, [(0.0, 1.0, 0, 4)], 200), ans, 2)
    assert (r.window is w) is kept


def test_without_a_card_the_command_prints_nothing():
    root = Path(__file__).resolve().parents[2]
    res = subprocess.run([sys.executable, "annbench/run.py", "--workload",
                          "sift1m.b256", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=root, capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout == ""
