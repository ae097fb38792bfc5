"""The plain reference agrees with the port at a CPU size, and the
lower-precision control does not."""
import numpy as np
import torch

from annbench import harness, inputs, reference


def _port_and_reference(cell, seed, n=64):
    cfg = cell["config"]
    inp = inputs.draw_index(cfg, seed, "cpu")
    q = inputs.draw_queries(cfg, n, inp["vectors"], seed)
    _, _, fn = harness.build_program(cfg, inp, "cpu")
    port = fn(q.numpy(), cfg["k"])
    ref = reference.search(inp, q, cfg, block=24)
    return inp, q, port, ref


def test_reference_matches_port_closed(tiny_cell):
    _, _, port, ref = _port_and_reference(tiny_cell("sift1m.b256"), 3)
    assert harness.answers_differing(port, ref.ids.numpy()) == 0.0
    assert (ref.lanes >= ref.hops).all() and (ref.hops > 0).all()


def test_reference_matches_port_mips(tiny_cell):
    _, _, port, ref = _port_and_reference(tiny_cell("kilt-e5.open"), 4)
    assert harness.answers_differing(port, ref.ids.numpy()) == 0.0


def test_control_fails_the_comparison(tiny_cell):
    cell = tiny_cell("sift1m.b256")
    inp, q, _, ref = _port_and_reference(cell, 5)
    low = reference.search(inp, q, cell["config"], dtype=torch.bfloat16)
    limit = cell["config"]["check"]["answers_differing_max"]
    assert harness.answers_differing(low.ids.numpy(), ref.ids.numpy()) \
        > 3 * limit


def test_control_script_reads_not_correct(tiny_cell):
    from annbench import control
    row = control.control_reading(tiny_cell("kilt-e5.open"), 2**31 + 7,
                                  0.5, "cpu")
    assert row["correct"] is False and row["queries"] == 48
    c = row["checks"]["answers_differing"]
    assert c["value"] > 3 * c["limit"]


def test_entry_gap_is_relative_to_the_nearest_row():
    dist = torch.tensor([4.0, 2.0, 2.0 + 2e-7, 3.0], dtype=torch.float64)
    assert harness.entry_gap(dist, 1) == 0.0
    assert abs(harness.entry_gap(dist, 2) - 1e-7) < 1e-12
    assert harness.entry_gap(dist, 3) == 0.5


def test_entry_point_is_nearest_the_mean():
    v = torch.tensor([[0.0, 0.0], [4.0, 4.0], [1.9, 2.1], [8.0, 0.0]])
    assert reference.entry_point(v) == 2


def test_answers_differing_counts_rows():
    a = np.arange(12).reshape(4, 3)
    b = a.copy()
    b[1, 2] = -1
    assert harness.answers_differing(a, b) == 0.25
    assert harness.answers_differing(a[:0], b[:0]) == 1.0
