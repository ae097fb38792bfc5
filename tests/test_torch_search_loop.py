"""The port's search loop in K-hop steps (`core.device_index._Search`):
the steps that the card captures as CUDA graphs, run eagerly on the CPU
with the same gating. Ids and hops equal the JAX reference's
`while_loop` for every K, distances within 1e-4 (the exact distances sum
in another order) and bit-equal across K; a hop in which no query is
active leaves the state bit-equal; padded batch rows change no answer;
a capture's launches are counted per replay."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_index as jdi
from repro_torch.core import device_index as tdi
from repro_torch.kernels import _build

_JAX = {}


@pytest.fixture(scope="module")
def indices(small_corpus, built_graph, pq_artifacts):
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    return {mode: (jdi.from_arrays(base, built_graph, cents, codes,
                                   mode=mode),
                   tdi.from_arrays(base, built_graph, cents, codes,
                                   mode=mode, device="cpu"))
            for mode in ("aisaq", "diskann")}


def _jax_search(indices, q, mode, adc, max_hops):
    key = (mode, adc, max_hops)
    if key not in _JAX:
        (jidx, jlay), _ = indices[mode]
        ids, d, hops = jdi.beam_search_device(
            jidx, jnp.asarray(q), k=10, L=40, layout=jlay, metric="l2",
            backend="ref", adc_dtype=adc, max_hops=max_hops)
        _JAX[key] = np.asarray(ids), np.asarray(d), int(hops)
    return _JAX[key]


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("max_hops", [128, 10])
@pytest.mark.parametrize("adc", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["aisaq", "diskann"])
def test_k_hop_loop_matches_jax(indices, small_corpus, mode, adc, max_hops,
                                K):
    """max_hops 10 cuts the search (a multiple of neither 3 nor 8); 128
    lets it end by itself (14 hops here)."""
    _, q, _ = small_corpus
    _, (tidx, tlay) = indices[mode]
    jids, jd, jhops = _jax_search(indices, q, mode, adc, max_hops)
    kw = dict(k=10, L=40, layout=tlay, adc_dtype=adc, max_hops=max_hops)
    ids, d, hops = tdi.beam_search_device(tidx, torch.from_numpy(q),
                                          hops_per_sync=K, **kw)
    assert hops == jhops == min(max_hops, jhops) > 0
    np.testing.assert_array_equal(ids.numpy(), jids)
    fin = np.isfinite(jd)
    assert np.array_equal(np.isfinite(d.numpy()), fin)
    np.testing.assert_allclose(d.numpy()[fin], jd[fin], rtol=1e-4, atol=1e-4)
    one = tdi.beam_search_device(tidx, torch.from_numpy(q), hops_per_sync=1,
                                 **kw)
    assert torch.equal(ids, one[0]) and torch.equal(d, one[1])
    assert hops == one[2]


def _search(tidx, tlay, q, nq, *, adc="f32", max_hops=128):
    s = tdi._Search(tidx, nq, L=40, w=4, max_hops=max_hops, layout=tlay,
                    metric="l2", backend="auto", adc_dtype=adc)
    s.load(torch.from_numpy(q))
    s.prologue()
    return s


@pytest.mark.parametrize("max_hops", [128, 3], ids=["ended", "cut"])
@pytest.mark.parametrize("adc", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["aisaq", "diskann"])
def test_inactive_hop_leaves_state_bit_equal(indices, small_corpus, mode,
                                             adc, max_hops):
    """After the loop's end (no unexpanded candidate) or its cut (hops =
    max_hops, candidates left), a further hop changes no bit of the state:
    the K-hop graph may run past the end."""
    _, q, _ = small_corpus
    _, (tidx, tlay) = indices[mode]
    s = _search(tidx, tlay, q, 16, adc=adc, max_hops=max_hops)
    for _ in range(200):
        s.hops(1)
        more, hops = s.status.tolist()
        if not more:
            break
    assert not more and 0 < hops <= max_hops
    if max_hops == 3:                      # cut with work left
        assert bool((~s.cand_exp & torch.isfinite(s.cand_d)).any())
    before = {k: v.clone() for k, v in s.state().items()}
    for _ in range(2):
        s.hop()
        for k, v in s.state().items():
            assert torch.equal(v, before[k]), k
    s.hops(3)
    assert s.status.tolist() == [0, hops]


def test_padded_rows_change_no_answer(indices, small_corpus):
    """A batch padded to its bucket (12 -> 16; 5 -> 8) answers its real
    rows as the unpadded batch does, and as each query alone (ids and
    distances; hops differ: a batch runs until its last query ends)."""
    _, q, _ = small_corpus
    _, (tidx, tlay) = indices["aisaq"]
    assert [tdi._pad_rows(n) for n in (1, 2, 3, 5, 12, 64, 65)] == \
        [1, 2, 4, 8, 16, 64, 128]
    exact = _search(tidx, tlay, q, 12)
    padded = _search(tidx, tlay, q, 16)
    for s in (exact, padded):
        while True:
            s.hops(4)
            more, _ = s.status.tolist()
            if not more:
                break
    assert exact.status.tolist() == padded.status.tolist()
    for a, b in zip(exact.result(12, 10), padded.result(12, 10)):
        assert torch.equal(a, b)
    assert torch.isinf(padded.pool_d[12:]).all()
    kw = dict(k=10, L=40, layout=tlay)
    ids, d, _ = tdi.beam_search_device(tidx, torch.from_numpy(q[:5]), **kw)
    for i in range(5):
        one_ids, one_d, _ = tdi.beam_search_device(
            tidx, torch.from_numpy(q[i:i + 1]), **kw)
        assert torch.equal(one_ids[0], ids[i]) and torch.equal(one_d[0],
                                                                d[i])


def _packed(ids, n_words: int) -> np.ndarray:
    """The uint32 words of a visited set holding `ids`."""
    words = np.zeros(n_words, np.uint32)
    for i in ids:
        words[i >> 5] |= np.uint32(1) << np.uint32(i & 31)
    return words


@pytest.mark.parametrize("ep", [31, 63])
def test_visited_bit_31_is_an_int32_words_sign_bit(indices, small_corpus,
                                                   built_graph, pq_artifacts,
                                                   ep):
    """The visited set is int32 words, as the reference's uint32 ones:
    from an entry point whose bit is 31 (the sign bit), the words after
    the prologue and after one hop are the packed set of the nodes
    inserted (bit for bit as uint32), and the search's ids and hops equal
    the reference's from the same entry point."""
    import dataclasses
    _, q, _ = small_corpus
    _, codes = pq_artifacts
    (jidx, jlay), (tidx, tlay) = indices["aisaq"]
    ep_codes = codes[ep][None].astype(np.int32)
    tidx = dataclasses.replace(
        tidx, ep_ids=torch.tensor([ep], dtype=torch.int32),
        ep_codes=torch.from_numpy(ep_codes), graphs={})
    jidx = jidx._replace(ep_ids=jnp.asarray([ep], jnp.int32),
                         ep_codes=jnp.asarray(ep_codes))
    s = _search(tidx, tlay, q, 16)
    assert s.inserted.dtype == torch.int32
    n_words = s.inserted.shape[1]
    assert (s.inserted.numpy().view(np.uint32)
            == _packed([ep], n_words)).all()
    assert (s.inserted[:, ep >> 5] < 0).all()         # the sign bit
    s.hops(1)
    nbrs = built_graph[ep][built_graph[ep] >= 0].tolist()
    words = s.inserted.numpy().view(np.uint32)
    assert (words[:len(q)] == _packed([ep, *nbrs], n_words)).all()
    # padded rows never hop: the entry point's bit alone
    assert (words[len(q):] == _packed([ep], n_words)).all()
    for max_hops in (1, 128):
        jids, _, jhops = jdi.beam_search_device(
            jidx, jnp.asarray(q), k=10, L=40, layout=jlay, metric="l2",
            backend="ref", max_hops=max_hops)
        ids, _, hops = tdi.beam_search_device(
            tidx, torch.from_numpy(q), k=10, L=40, layout=tlay,
            max_hops=max_hops)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        assert hops == int(jhops)


def test_search_checks_its_arguments(indices, small_corpus):
    _, q, _ = small_corpus
    _, (tidx, tlay) = indices["aisaq"]
    with pytest.raises(ValueError, match="hops_per_sync"):
        tdi.beam_search_device(tidx, torch.from_numpy(q), k=10, L=40,
                               layout=tlay, hops_per_sync=0)
    with pytest.raises(ValueError, match="w <= L"):
        tdi.beam_search_device(tidx, torch.from_numpy(q), k=10, L=3, w=4,
                               layout=tlay)
    ids, d, hops = tdi.beam_search_device(tidx, torch.from_numpy(q), k=10,
                                          L=40, layout=tlay, max_hops=0)
    assert hops == 0 and (ids == -1).all() and torch.isinf(d).all()
    assert tidx.graphs == {}                 # graphs exist only on the card


def test_a_capture_counts_its_launches_per_replay():
    """Inside `recorded_launches` the wrappers' counts go to the capture's
    Counter; each replay adds them to launch_counts."""
    _build.reset_launch_counts()
    with _build.recorded_launches() as rec:
        _build.count_launch("pq_lut")
        for _ in range(3):
            _build.count_launch("fused_hop_f32")
        with pytest.raises(RuntimeError, match="already"):
            with _build.recorded_launches():
                pass
    assert dict(rec) == {"pq_lut": 1, "fused_hop_f32": 3}
    assert sum(_build.launch_counts.values()) == 0
    for _ in range(2):
        _build.count_replay(rec)
    _build.count_launch("rerank")
    assert _build.launch_counts["fused_hop_f32"] == 6
    assert _build.launch_counts["pq_lut"] == 2
    assert _build.launch_counts["rerank"] == 1
    _build.reset_launch_counts()
