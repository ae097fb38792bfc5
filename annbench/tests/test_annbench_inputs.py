"""The seeded inputs repeat, and each stream stands alone."""
import torch

from annbench import inputs

CFG = {"n_vectors": 600, "dim": 16, "data_dtype": "float32", "R": 8,
       "pq_m": 4, "pq_ks": 16,
       "data": {"n_clusters": 8, "spread": 0.15, "normalize": False,
                "query_noise": 0.05},
       "pq_train": {"sample": 400, "iters": 3}}


def _draw(seed, cfg=CFG):
    idx = inputs.draw_index(cfg, seed, "cpu")
    idx["queries"] = inputs.draw_queries(cfg, 32, idx["vectors"], seed)
    return idx


def test_same_seed_same_inputs():
    a, b = _draw(2**31 + 11), _draw(2**31 + 11)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_other_seed_other_inputs():
    a, b = _draw(5), _draw(6)
    for key in a:
        assert not torch.equal(a[key], b[key]), key


def test_query_count_leaves_the_index_alone():
    a = _draw(7)
    inputs.draw_queries(CFG, 64, a["vectors"], 7)
    b = inputs.draw_index(CFG, 7, "cpu")
    for key in b:
        assert torch.equal(a[key], b[key]), key


def test_graph_is_regular_without_self_loops():
    g = inputs.random_regular_graph(200, 12, inputs.generator(3, "g", "cpu"))
    assert g.shape == (200, 12) and g.dtype == torch.int32
    assert not (g == torch.arange(200)[:, None]).any()
    srt = g.sort(1).values
    assert not (srt[:, 1:] == srt[:, :-1]).any()


def test_unit_rows_and_codes_in_range():
    cfg = dict(CFG, data=dict(CFG["data"], normalize=True))
    d = _draw(9, cfg)
    assert torch.allclose(d["vectors"].norm(dim=1), torch.ones(600),
                          atol=1e-5)
    assert torch.allclose(d["queries"].norm(dim=1), torch.ones(32),
                          atol=1e-5)
    assert d["codes"].dtype == torch.uint8 and d["codes"].shape == (600, 4)
    assert int(d["codes"].max()) < 16


def test_window_busy_and_gaps():
    from annbench import trace
    w = trace.Window(lo=0.0, hi=1.0)
    w.device = [("k1", 0.1, 0.3), ("k2", 0.2, 0.4), ("hop_kernel", 0.5, 0.6),
                ("k3", 0.600005, 0.7)]
    w.host = [("cudaGraphLaunch", 0.42, 0.48), (trace.SPAN, 0.0, 1.0)]
    assert w.busy() == [[0.1, 0.4], [0.5, 0.6], [0.600005, 0.7]]
    assert abs(w.busy_s - 0.499995) < 1e-12 and w.count("hop") == 1
    gaps = dict(w.idle_gaps())
    assert abs(gaps["cudaGraphLaunch"] - 0.1) < 1e-12
    assert abs(gaps[trace.SPAN] - 0.4) < 1e-12
    assert abs(gaps["between two device ops (< 20 us)"] - 5e-6) < 1e-12

