"""The rate sweep at a CPU size: one row a step and a knee."""
from annbench import sweep


def test_sweep_finds_a_knee(tiny_cell):
    rows = sweep.sweep(tiny_cell("kilt-e5.open"), 11, 0.5, [40, 80], "cpu")
    steps, last = rows[:-1], rows[-1]
    assert [r["rate_per_s"] for r in steps] == [40, 80]
    assert all(r["failed"] == 0 and r["latency_p95_ms"] > 0
               and r["growth"] > 0 for r in steps)
    assert last["knee_per_s"] in (40, 80, None)
    assert last["workload"] == "kilt-e5.open"
