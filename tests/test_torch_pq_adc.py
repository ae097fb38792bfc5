"""The port's bulk ADC (`repro_torch.kernels.pq_adc`, `ops.adc`) against
the JAX package: the Pallas kernels in interpret mode on the shape sweeps
of tests/test_kernels.py, and the plain reference where the Pallas body
refuses the shape (m % 8 != 0). Tolerances follow tests/test_kernels.py:
rtol 1e-5 / atol 1e-4 for f32 ADC, and 1e-6 of the largest distance for
the int8 variant, whose integer sums agree exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.pq_adc import pq_adc_q8 as jpq_adc_q8
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pq_adc import pq_adc, pq_adc_q8


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(nq, n, m, code_dt, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    lut = (rng.random((nq, m, 256)) * scale).astype(np.float32)
    codes = rng.integers(0, 256, (n, m)).astype(code_dt)
    return lut, codes


@pytest.mark.parametrize("nq,n,m,code_dt,jax_backend", [
    (1, 100, 8, np.uint8, "pallas_interpret"),
    (2, 700, 16, np.uint8, "pallas_interpret"),
    (3, 64, 32, np.int32, "pallas_interpret"),
    (1, 1500, 4, np.uint8, "pallas_interpret"),
    # SASRec's m=10 and m=50: the Pallas body needs m % 8 == 0, so these
    # are held against the JAX package's plain reference
    (2, 900, 10, np.uint8, "ref"),
    (1, 300, 50, np.int32, "ref"),
])
def test_adc_matches_jax(nq, n, m, code_dt, jax_backend):
    lut, codes = _case(nq, n, m, code_dt, seed=n + m)
    want = np.asarray(jops.adc(jnp.asarray(lut), jnp.asarray(codes),
                               backend=jax_backend))
    mine = ops.adc(_t(lut), _t(codes)).numpy()
    assert mine.shape == (nq, n) and mine.dtype == np.float32
    np.testing.assert_allclose(mine, want, rtol=1e-5, atol=1e-4)
    if jax_backend == "ref" and m <= 16:
        # XLA:CPU adds the m entries left to right, as sum_in_order does,
        # so ties between candidates break the same way
        np.testing.assert_array_equal(mine, want)
    # on CPU tensors the wrapper and both ops backends run the plain version
    np.testing.assert_array_equal(pq_adc(_t(lut), _t(codes)).numpy(), mine)
    np.testing.assert_array_equal(
        ops.adc(_t(lut), _t(codes), backend="ref").numpy(), mine)
    np.testing.assert_array_equal(ref.adc_ref(_t(lut), _t(codes)).numpy(),
                                  mine)


@pytest.mark.parametrize("nq,n,m", [(2, 500, 16), (1, 200, 32)])
def test_pq_adc_q8_matches_jax(nq, n, m):
    """The test_kernels.py:88 shapes: equal to the interpreted Pallas int8
    kernel, within the int8 error bound of f32 ADC, top-10 kept."""
    lut, codes = _case(nq, n, m, np.uint8, seed=m, scale=3.0)
    want = np.asarray(jpq_adc_q8(jnp.asarray(lut), jnp.asarray(codes),
                                 interpret=True))
    mine = pq_adc_q8(_t(lut), _t(codes)).numpy()
    assert mine.shape == (nq, n)
    assert np.abs(mine - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(
        ref.pq_adc_q8_ref(_t(lut), _t(codes)).numpy(), mine)
    exact = ops.adc(_t(lut), _t(codes), backend="ref").numpy()
    assert np.abs(mine - exact).max() <= m * np.abs(lut).max() / 127 + 1e-3
    for q in range(nq):
        top_a = set(np.argsort(mine[q], kind="stable")[:10].tolist())
        top_b = set(np.argsort(exact[q], kind="stable")[:10].tolist())
        assert len(top_a & top_b) >= 9


@pytest.mark.parametrize("m", [10, 16])
def test_two_d_lut_squeezes(m):
    """A 2-D (m, ks) LUT gives (n,), the first row of the batched call,
    as the JAX wrappers' squeeze rule does."""
    lut, codes = _case(2, 300, m, np.uint8, seed=7)
    full = pq_adc(_t(lut), _t(codes))
    one = pq_adc(_t(lut[0]), _t(codes))
    assert one.shape == (300,)
    assert torch.equal(one, full[0])
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jops.adc(jnp.asarray(lut[0]),
                                         jnp.asarray(codes), backend="ref")),
        rtol=1e-5, atol=1e-4)
    q8 = pq_adc_q8(_t(lut[0]), _t(codes))
    assert q8.shape == (300,)
    assert torch.equal(q8, pq_adc_q8(_t(lut[:1]), _t(codes))[0])
    assert torch.equal(ops.adc(_t(lut[0]), _t(codes)), one)


def test_adc_wrappers_refuse_mixed_devices():
    """A tensor that is not on the CPU never takes the plain version: the
    wrappers launch on CUDA or raise."""
    lut, codes = _case(1, 50, 10, np.uint8, seed=1)
    meta_lut = torch.zeros((1, 10, 256), device="meta")
    for fn in (pq_adc, pq_adc_q8, ops.adc):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(meta_lut, _t(codes))
        with pytest.raises(ValueError, match="CUDA device"):
            fn(_t(lut), torch.zeros((50, 10), dtype=torch.uint8,
                                    device="meta"))
    with pytest.raises(ValueError, match="backend"):
        ops.adc(_t(lut), _t(codes), backend="pallas")
