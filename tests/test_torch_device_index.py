"""The port's device index and beam search against
`repro.core.device_index` (backend="ref") on the conftest corpus: search
results, the directory loader (plain and relabeled), the carry-across from
a JAX DeviceIndex, and the on-device chunk packer."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_index as jdi
from repro.core.chunk_layout import ChunkLayout as JLayout
from repro.core.chunk_layout import pack_chunks_device as j_pack
from repro.core.index_io import write_index
from repro.core.traversal import recall_at
from repro_torch.core import device_index as tdi
from repro_torch.core.chunk_layout import ChunkLayout, pack_chunks_device, \
    pack_chunks_torch
from repro_torch.core.vamana import random_regular_graph


def _index_pair(small_corpus, built_graph, pq_artifacts, mode):
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    jidx, jlay = jdi.from_arrays(base, built_graph, cents, codes, mode=mode)
    tidx, tlay = tdi.from_arrays(base, built_graph, cents, codes, mode=mode,
                                 device="cpu")
    return jidx, jlay, tidx, tlay


@pytest.fixture(scope="module")
def indices(small_corpus, built_graph, pq_artifacts):
    return _index_pair(small_corpus, built_graph, pq_artifacts, "aisaq")


@pytest.fixture(scope="module")
def diskann_indices(small_corpus, built_graph, pq_artifacts):
    return _index_pair(small_corpus, built_graph, pq_artifacts, "diskann")


def _same_index(tidx, jidx):
    for f in ("chunk_words", "centroids", "ep_ids", "ep_codes"):
        np.testing.assert_array_equal(getattr(tidx, f).numpy(),
                                      np.asarray(getattr(jidx, f)), err_msg=f)


def _same_layout(tlay, jlay):
    assert dataclasses.asdict(tlay) == dataclasses.asdict(jlay)
    assert tlay.device_stride == jlay.device_stride


@pytest.mark.parametrize("mode", ["aisaq", "diskann"])
@pytest.mark.parametrize("adc", ["f32", "int8"])
def test_beam_search_matches_jax(request, small_corpus, mode, adc):
    """Both placements, under the same limits. diskann mode ignores
    adc_dtype (its ADC reads the resident code table in f32), in the
    reference and in the port."""
    base, q, gt = small_corpus
    jidx, jlay, tidx, tlay = request.getfixturevalue(
        "indices" if mode == "aisaq" else "diskann_indices")
    jids, jd, jhops = jdi.beam_search_device(
        jidx, jnp.asarray(q), k=10, L=40, layout=jlay, metric="l2",
        backend="ref", adc_dtype=adc)
    ids, d, hops = tdi.beam_search_device(
        tidx, torch.from_numpy(q), k=10, L=40, layout=tlay, metric="l2",
        adc_dtype=adc)
    jids, ids = np.asarray(jids), ids.numpy()
    assert hops == int(jhops) > 0
    overlap = np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(ids, jids)])
    assert overlap >= 0.99
    assert abs(recall_at(ids, gt, 10) - recall_at(jids, gt, 10)) <= 0.01
    assert recall_at(ids, gt, 1) >= 0.9
    assert recall_at(ids, gt, 10) >= 0.8
    fin = np.isfinite(np.asarray(jd))
    np.testing.assert_allclose(d.numpy()[fin], np.asarray(jd)[fin],
                               rtol=1e-4, atol=1e-4)


def test_from_arrays_matches_jax(indices):
    jidx, jlay, tidx, tlay = indices
    _same_index(tidx, jidx)
    _same_layout(tlay, jlay)
    assert tidx.pq_codes is None


@pytest.mark.parametrize("mode", ["aisaq", "diskann"])
def test_load_device_index_matches_jax(index_dirs, mode):
    jidx, jlay, jmetric = jdi.load_device_index(index_dirs[mode])
    tidx, tlay, metric = tdi.load_device_index(index_dirs[mode],
                                               device="cpu")
    assert metric == jmetric == "l2"
    _same_layout(tlay, jlay)
    _same_index(tidx, jidx)
    if mode == "diskann":
        np.testing.assert_array_equal(tidx.pq_codes.numpy(),
                                      np.asarray(jidx.pq_codes))
    assert tidx.fast_tier_bytes(3, 40) == jidx.fast_tier_bytes(3, 40)


def test_load_relabeled_dir_restores_original_space(
        tmp_path, small_corpus, built_graph, pq_artifacts, index_dirs):
    """A relabeled directory loads into the same tensors as the plain one
    (the loader undoes the pack-time permutation), as the JAX loader does."""
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    path = str(tmp_path / "aisaq_rl")
    write_index(path, vectors=base, graph=built_graph, centroids=cents,
                codes=codes, metric="l2", mode="aisaq", relabel=True)
    tidx, tlay, _ = tdi.load_device_index(path, device="cpu")
    plain, _, _ = tdi.load_device_index(index_dirs["aisaq"], device="cpu")
    jidx, _, _ = jdi.load_device_index(path)
    _same_index(tidx, jidx)
    assert torch.equal(tidx.chunk_words, plain.chunk_words)


def test_from_numpy_round_trips_a_jax_index(indices, small_corpus):
    base, q, _ = small_corpus
    jidx, jlay, tidx, tlay = indices
    carried = tdi.from_numpy(np.asarray(jidx.chunk_words),
                             np.asarray(jidx.centroids),
                             np.asarray(jidx.ep_ids),
                             np.asarray(jidx.ep_codes), device="cpu")
    _same_index(carried, jidx)
    a, _, _ = tdi.beam_search_device(carried, torch.from_numpy(q[:4]), k=10,
                                     L=40, layout=tlay)
    b, _, _ = tdi.beam_search_device(tidx, torch.from_numpy(q[:4]), k=10,
                                     L=40, layout=tlay)
    assert torch.equal(a, b)


def test_fast_tier_residency_invariant(small_corpus, built_graph,
                                       pq_artifacts):
    """AiSAQ fast-tier bytes are independent of N; DiskANN's grow with N."""
    base, _, _ = small_corpus
    cents, codes = pq_artifacts
    idx_a, _ = tdi.from_arrays(base, built_graph, cents, codes,
                               device="cpu")
    idx_d, _ = tdi.from_arrays(base, built_graph, cents, codes,
                               mode="diskann", device="cpu")
    n, m = codes.shape
    assert idx_d.fast_tier_bytes(1, 40) - idx_a.fast_tier_bytes(1, 40) \
        == n * m
    half = n // 2
    g = np.clip(built_graph[:half], -1, half - 1)
    idx_h, _ = tdi.from_arrays(base[:half], g, cents, codes[:half],
                               device="cpu")
    assert idx_h.fast_tier_bytes(1, 40) == idx_a.fast_tier_bytes(1, 40)


@pytest.mark.parametrize("dt,mode,R,m,dim", [
    ("float32", "aisaq", 20, 12, 48), ("uint8", "aisaq", 52, 32, 130),
    ("float32", "diskann", 8, 8, 32), ("float32", "aisaq", 56, 128, 128),
])
def test_torch_packer_bytes_equal_numpy(dt, mode, R, m, dim):
    rng = np.random.default_rng(R + m)
    N = 37
    vecs = (rng.integers(0, 255, (N, dim)).astype(np.uint8) if dt == "uint8"
            else rng.normal(size=(N, dim)).astype(np.float32))
    adj = rng.integers(-1, N, (N, R)).astype(np.int32)
    codes = rng.integers(0, 256, (N, m)).astype(np.uint8)
    lay = ChunkLayout(mode, dim, dt, R, m)
    want = j_pack(vecs, adj, codes, JLayout(mode, dim, dt, R, m))
    np.testing.assert_array_equal(pack_chunks_device(vecs, adj, codes, lay),
                                  want)
    words = pack_chunks_torch(torch.from_numpy(vecs), torch.from_numpy(adj),
                              torch.from_numpy(codes), lay, block_rows=8)
    assert words.dtype == torch.int32 and words.shape == (N, lay.device_stride
                                                          // 4)
    np.testing.assert_array_equal(words.numpy().view(np.uint8), want)


def test_mask_intra_dups_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 6, (4, 30)).astype(np.int32)
    np.testing.assert_array_equal(
        tdi._mask_intra_dups(torch.from_numpy(ids)).numpy(),
        np.asarray(jdi._mask_intra_dups(jnp.asarray(ids))))


def test_random_regular_graph_rows_are_distinct():
    g = random_regular_graph(300, 56, seed=3)
    assert g.shape == (300, 56) and g.dtype == torch.int32
    srt = g.sort(dim=1).values
    assert not (srt[:, 1:] == srt[:, :-1]).any()
    assert not (g == torch.arange(300)[:, None]).any()
    assert int(g.min()) >= 0 and int(g.max()) < 300
    assert torch.equal(g, random_regular_graph(300, 56, seed=3))
