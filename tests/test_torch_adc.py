"""The port's storage-search numerics (`repro_torch.core.adc`) against the
reference's numpy twins (`repro.core.adc`), the device hop of the storage
search (`core.traversal._DeviceHop`) against numpy on the chunks of the
file, and the port's copy of `obs` around a traced search.

Tolerances: ADC distances within 1e-5 relative (int8: of the sum of the
terms' magnitudes, since the mid-centred int8 distances are offsets that
may lie near 0); LUT entries within 1e-5 relative plus 1e-5 of the
query's largest entry (the expanded form |q|^2 - 2 q.c + |c|^2, which the
kernel computes, cancels on small entries); exact distances within 1e-4
relative; int8 codes and scales equal given the same f32 LUT.
"""
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import index_io as jio
from repro_torch.core import adc as tadc
from repro_torch.core import index_io as tio
from repro_torch.core import traversal as ttr
from repro_torch.obs import trace as T


@pytest.fixture(scope="module")
def luts(small_corpus, pq_artifacts):
    _, q, _ = small_corpus
    cents, codes = pq_artifacts
    want = jadc.np_build_lut_batch(cents, q, "l2")
    got = tadc.build_lut_batch(torch.tensor(cents), torch.tensor(q),
                               "l2").numpy()
    return want, got, codes


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_build_lut_matches_reference(small_corpus, pq_artifacts, metric):
    _, q, _ = small_corpus
    cents, _ = pq_artifacts
    want = jadc.np_build_lut_batch(cents, q, metric)
    got = tadc.build_lut_batch(torch.tensor(cents), torch.tensor(q),
                               metric).numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * scale).all()
    one = tadc.build_lut(torch.tensor(cents), torch.tensor(q[5]),
                         metric).numpy()
    np.testing.assert_array_equal(one, got[5])     # row-independent
    np.testing.assert_allclose(
        one, jadc.np_build_lut(cents, q[5], metric), rtol=1e-5,
        atol=1e-5 * float(scale[5, 0, 0]))


def test_adc_matches_reference(luts):
    want_lut, got_lut, codes = luts
    for i in range(len(want_lut)):
        want = jadc.np_adc(want_lut[i], codes)
        got = tadc.adc(torch.from_numpy(got_lut[i]),
                       torch.tensor(codes)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _terms(lut_q8, scale, codes):
    g = lut_q8[np.arange(lut_q8.shape[0]), codes.astype(np.int64)]
    return np.abs(g.astype(np.float32) * (scale * np.float32(1 / 127))) \
        .sum(-1)


@pytest.mark.parametrize("recipe", ["host", "per_query"])
def test_int8_luts_and_adc_match_reference(luts, recipe):
    """Given the same f32 LUT: the same int8 codes and scales, and ADC
    distances within 1e-5 of the terms' magnitude."""
    want_lut, _, codes = luts
    if recipe == "host":
        wq, ws = jadc.np_host_lut_int8(want_lut)
        gq, gs = tadc.host_lut_int8(torch.from_numpy(want_lut))
    else:
        wq, ws = jadc.np_quantize_lut(want_lut)
        gq, gs = tadc.quantize_lut(torch.from_numpy(want_lut))
    np.testing.assert_array_equal(gq.numpy(), wq)
    np.testing.assert_array_equal(gs.numpy(), ws)
    for i in range(len(want_lut)):
        want = jadc.np_adc_int8(wq[i], ws[i], codes)
        got = tadc.adc_int8(gq[i], gs[i], torch.tensor(codes)).numpy()
        mag = _terms(wq[i], ws[i], codes) if recipe == "host" \
            else np.abs(want)
        assert (np.abs(got - want) <= 1e-5 * mag + 1e-6).all()


@pytest.mark.parametrize("adc_dtype", ["f32", "int8"])
def test_adc_gather_is_the_batched_adc(luts, adc_dtype):
    """adc_gather over (query, codes) rows equals the per-query ADC bit
    for bit (the batched path and the scalar oracle share it)."""
    _, got_lut, codes = luts
    lut = torch.from_numpy(got_lut)
    rng = np.random.default_rng(0)
    qi = rng.integers(0, len(got_lut), 200)
    rows = rng.integers(0, len(codes), 200)
    if adc_dtype == "int8":
        q8, s = tadc.host_lut_int8(lut)
        dq = s * float(1 / 127)
        got = tadc.adc_gather(q8, dq, torch.from_numpy(qi),
                              torch.from_numpy(codes[rows])).numpy()
        want = [tadc.adc_int8(q8[i], s[i], torch.tensor(codes[r]))
                for i, r in zip(qi, rows)]
    else:
        got = tadc.adc_gather(lut, None, torch.from_numpy(qi),
                              torch.from_numpy(codes[rows])).numpy()
        want = [tadc.adc(lut[i], torch.tensor(codes[r]))
                for i, r in zip(qi, rows)]
    np.testing.assert_array_equal(got, np.array([float(w) for w in want],
                                                np.float32))


@pytest.mark.parametrize("adc_dtype", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["aisaq", "diskann"])
def test_device_hop_matches_numpy(index_dirs, small_corpus, pq_artifacts,
                                  mode, adc_dtype):
    """One hop of the storage search on the file's chunks: each frontier
    row's exact distance (1e-4) and every fresh neighbour's ADC from the
    staged rows (aisaq) or the resident code table (diskann), against
    numpy on the same chunks."""
    _, q, _ = small_corpus
    cents, codes = pq_artifacts
    t = tio.HostIndex.load(index_dirs[mode], device="cpu")
    j = jio.HostIndex.load(index_dirs[mode])
    try:
        lay = t.layout
        dh = ttr._DeviceHop(t, q, adc_dtype)
        rng = np.random.default_rng(1)
        qf = np.repeat(np.arange(len(q)), 3)
        frank = np.tile(np.arange(3), len(q))
        nodes = rng.integers(0, t.meta["n"], qf.size)
        chunk = np.stack([t._read_chunk(int(p), ttr.SearchStats())
                          for p in nodes])
        nbr = chunk[:, lay.off_ids:lay.off_ids + 4 * lay.R].copy() \
            .view(np.int32).reshape(-1).astype(np.int64)
        f_slot = np.flatnonzero(nbr >= 0)[::3]
        f_q, f_ids = qf[f_slot // lay.R], nbr[f_slot]
        exact, f_d = dh.expand(chunk, qf, frank, 4, f_q, f_slot, f_ids)
        vf = ttr._vectors(chunk, lay)
        np.testing.assert_allclose(exact, ((vf - q[qf]) ** 2).sum(1),
                                   rtol=1e-4)
        lut = jadc.np_build_lut_batch(j.centroids, q, "l2")
        if adc_dtype == "int8":
            wq, ws = jadc.np_host_lut_int8(lut)
            want = np.array([jadc.np_adc_int8(wq[a], ws[a], codes[b])
                             for a, b in zip(f_q, f_ids)])
            mag = np.array([_terms(wq[a], ws[a], codes[b])
                            for a, b in zip(f_q, f_ids)])
            assert (np.abs(f_d - want) <= 1e-5 * mag + 1e-6).all()
        else:
            want = np.array([jadc.np_adc(lut[a], codes[b])
                             for a, b in zip(f_q, f_ids)])
            np.testing.assert_allclose(f_d, want, rtol=1e-5)
        ex_r = dh.rerank(qf, vf)
        np.testing.assert_allclose(ex_r, exact, rtol=1e-5)
    finally:
        t.close(), j.close()


def test_traced_search_records_hop_spans(index_dirs, small_corpus):
    """obs: an active span collects one traversal.hop span per hop (the
    block-cache reads nest under them)."""
    _, q, _ = small_corpus
    tr = T.Tracer(sample=1.0)
    idx = tio.HostIndex.load(index_dirs["aisaq"], device="cpu")
    try:
        root = tr.start_span("query")
        with T.activate(root):
            _, st = idx.search_batch(q[:2], 5, L=24, rerank=10)
        root.end()
        names = [d["name"] for d in tr.finished()]
        assert names.count("traversal.hop") == max(s.hops for s in st)
        assert "query" in names
    finally:
        idx.close()
