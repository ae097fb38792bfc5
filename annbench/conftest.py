"""Pytest settings of the benchmark's own tests: the `annbench_card`
marker for tests that need a CUDA card (they skip inside the `card`
fixture, never at import), and `tiny_cell`, a cell shrunk to run on the
CPU in well under a second."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "annbench_card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def shrink(cell: dict) -> dict:
    """The cell at a CPU size: every width and option kept in kind, the
    corpus, the widths and the traffic cut."""
    cfg = dict(cell["config"], n_vectors=1500, dim=32, R=10, pq_m=8, L=24,
               rerank=16, max_hops=48, pq_train={"sample": 1000, "iters": 3})
    tr = dict(cell["traffic"], sample=48, trace_calls=3)
    if tr["kind"] == "closed":
        tr.update(batch=16, query_pool=128)
    else:
        tr.update(rate_per_s=150, max_batch=8, grace_s=10.0)
    return dict(cell, config=cfg, traffic=tr)


@pytest.fixture
def tiny_cell():
    import torch
    from annbench import harness
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield lambda name: shrink(harness.load_cell(name))
    finally:
        torch.set_num_threads(threads)
