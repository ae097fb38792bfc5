"""The port's PQ training/encoding, exact distances, groundtruth and
recall against `repro.core.pq` on the conftest corpus."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as jpq
from repro.core.traversal import recall_at as jrecall_at
from repro_torch.core import pq


def test_train_codebooks_matches_jax(small_corpus, pq_artifacts):
    """Same data, same initial centroid rows (drawn with JAX, as the
    reference draws them): Lloyd centroids agree within 1e-4."""
    base, _, _ = small_corpus
    cents_jax, _ = pq_artifacts   # train_codebooks(PRNGKey(0), m=12, iters=8)
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(0), base.shape[0],
                                        shape=(256,), replace=False))
    cents = pq.train_codebooks(base, m=12, init_idx=init, iters=8,
                               device="cpu")
    assert cents.shape == cents_jax.shape and cents.dtype == torch.float32
    np.testing.assert_allclose(cents.numpy(), cents_jax, atol=1e-4)


def test_encode_matches_jax_except_ties(small_corpus, pq_artifacts):
    base, _, _ = small_corpus
    cents, codes_jax = pq_artifacts
    codes = pq.encode(cents, base, device="cpu").numpy()
    assert codes.dtype == np.uint8 and codes.shape == codes_jax.shape
    n, m = codes.shape
    diff = np.argwhere(codes != codes_jax)
    assert len(diff) <= 1e-3 * codes.size
    dsub = base.shape[1] // m
    for i, j in diff:                  # a differing code must be a tie
        x = base[i, j * dsub:(j + 1) * dsub]
        da = ((cents[j, codes[i, j]] - x) ** 2).sum()
        db = ((cents[j, codes_jax[i, j]] - x) ** 2).sum()
        assert abs(da - db) <= 1e-5 * max(1.0, abs(da))


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_exact_distances_and_groundtruth_match_jax(small_corpus, metric):
    base, q, gt = small_corpus
    d = pq.exact_distances(torch.from_numpy(q), torch.from_numpy(base),
                           metric=metric).numpy()
    np.testing.assert_allclose(
        d, np.asarray(jpq.exact_distances(jnp.asarray(q), jnp.asarray(base),
                                          metric=metric)),
        rtol=1e-4, atol=1e-3)
    want = gt if metric == "l2" else jpq.groundtruth(q, base, 10,
                                                     metric=metric)
    # several base blocks: the running top-k across blocks is exercised
    got = pq.groundtruth(q, base, 10, metric=metric, batch=400, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_recall_at_matches_reference():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, (20, 10))
    gt = rng.integers(0, 50, (20, 10))
    for k in (1, 5, 10):
        assert pq.recall_at(ids, gt, k) == jrecall_at(ids, gt, k)


def test_train_codebooks_rejects_bad_init(small_corpus):
    base, _, _ = small_corpus
    with pytest.raises(ValueError, match="init_idx"):
        pq.train_codebooks(base, m=12, init_idx=np.arange(10), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        pq.train_codebooks(base, m=7, init_idx=np.arange(256), device="cpu")
