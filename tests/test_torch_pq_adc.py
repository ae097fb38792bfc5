"""The port's bulk ADC (`repro_torch.kernels.pq_adc`, `ops.adc`) against
the JAX package: the Pallas kernels in interpret mode on the shape sweeps
of tests/test_kernels.py, and the plain reference where the Pallas body
refuses the shape (m % 8 != 0). Tolerances follow tests/test_kernels.py:
rtol 1e-5 / atol 1e-4 for f32 ADC; the int8 variant is bit-equal (its
integer sums agree exactly, and both rescale by float32(1/127), as the
jitted reference does)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.pq_adc import pq_adc_q8 as jpq_adc_q8
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pq_adc import (ADC_HEADER_BYTES, SMEM_LIMIT,
                                        adc_plan, pq_adc, pq_adc_q8)


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
    """The test_kernels.py:88 shapes: bit-equal to the interpreted Pallas
    int8 kernel (exact int32 sums, the same float32 rescale), within the
    int8 error bound of f32 ADC, top-10 kept."""
    lut, codes = _case(nq, n, m, np.uint8, seed=m, scale=3.0)
    want = np.asarray(jpq_adc_q8(jnp.asarray(lut), jnp.asarray(codes),
                                 interpret=True))
    mine = pq_adc_q8(_t(lut), _t(codes)).numpy()
    assert mine.shape == (nq, n)
    np.testing.assert_array_equal(mine, want)
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


@pytest.mark.parametrize("seed", [2, 8, 9, 10, 13])
def test_pq_adc_q8_rescale_matches_jit(seed):
    """Seeds at which a true quotient scale / 127 differed from the jitted
    reference in the last bit on one query (XLA multiplies by the rounded
    reciprocal): the port rescales by scale * INV127 and is bit-equal."""
    rng = np.random.default_rng(seed)
    lut = (rng.random((4, 16, 256)) * 3).astype(np.float32)
    codes = rng.integers(0, 256, (200, 16)).astype(np.uint8)
    want = np.asarray(jpq_adc_q8(jnp.asarray(lut), jnp.asarray(codes),
                                 interpret=True))
    np.testing.assert_array_equal(pq_adc_q8(_t(lut), _t(codes)).numpy(),
                                  want)
    assert ref.INV127.view(np.uint32) == 0x3C010204


# ---------------------------------------------------------------------------
# adc_plan: the shared-memory plan of the bulk ADC kernel
# ---------------------------------------------------------------------------


def _plan_ok(plan, m, ks, code_dtype, lut_dtype):
    """The invariants the kernel's adc_plan_ok checks."""
    row = m * (1 if code_dtype == torch.uint8 else 4)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.tile_rows % 16 == 0 and plan.tile_rows >= 16
    assert (plan.tile_rows * row) % 16 == 0       # tiles start 16-B aligned
    assert plan.slot_bytes % 128 == 0
    assert plan.slot_bytes >= plan.tile_rows * row + 16
    assert plan.depth in (2, 3)
    entry = 4 if lut_dtype == "f32" else 1
    if plan.global_lut:
        assert (plan.group, plan.group_pad, plan.lut_bytes) == (1, 1, 0)
    else:
        assert 1 <= plan.group <= plan.group_pad
        assert plan.group_pad in (1, 2, 4, 8, 16)
        assert plan.lut_bytes >= m * ks * plan.group_pad * entry
    # a cluster stages int8 tables; packed int8 pair sums need m <= 256
    assert plan.cluster == (4 if lut_dtype == "int8"
                            and not plan.global_lut else 1)
    if lut_dtype == "int8" and m > 256:
        assert plan.group_pad == 1
    assert plan.smem_bytes == (ADC_HEADER_BYTES
                               + plan.depth * plan.slot_bytes
                               + plan.lut_bytes)


@pytest.mark.parametrize("nq,m,code_dtype,lut_dtype,want", [
    # retrieval (1, 1M, 10): the plain [j][code] LUT, 10 KB
    (1, 10, torch.uint8, "f32", dict(group=1, n_groups=1, lut_bytes=10240,
                                     cluster=1, tile_rows=512)),
    (1, 10, torch.uint8, "int8", dict(group=1, n_groups=1)),
    # bulk (8, 1M, 16): one group, so the codes are read once
    (8, 16, torch.uint8, "f32", dict(group=8, group_pad=8, n_groups=1,
                                     lut_bytes=131072)),
    (8, 16, torch.uint8, "int8", dict(group=8, group_pad=8, n_groups=1,
                                      lut_bytes=32768, cluster=4)),
    # wide (4, 50k, 128): a 128 KB f32 LUT a group, all four int8 LUTs
    (4, 128, torch.uint8, "f32", dict(group=1, n_groups=4,
                                      global_lut=False)),
    (4, 128, torch.uint8, "int8", dict(group=4, n_groups=1)),
    # more queries than one group
    (20, 16, torch.uint8, "f32", dict(group=8, n_groups=3)),
    (20, 16, torch.uint8, "int8", dict(group=16, group_pad=16, n_groups=2)),
    # a LUT too wide for shared memory: the global-LUT path
    (1, 256, torch.uint8, "f32", dict(global_lut=True, n_groups=1,
                                      cluster=1)),
    (2, 1024, torch.uint8, "int8", dict(global_lut=True, n_groups=2)),
    # i32 codes: 4 bytes a code, so rows of 256 leave room for two f32 LUTs
    (4, 50, torch.int32, "f32", dict(group=2, n_groups=2, tile_rows=256)),
    (3, 16, torch.int32, "int8", dict(group=3, group_pad=4)),
])
def test_adc_plan(nq, m, code_dtype, lut_dtype, want):
    plan = adc_plan(nq, m, 256, code_dtype, lut_dtype)
    _plan_ok(plan, m, 256, code_dtype, lut_dtype)
    for key, value in want.items():
        assert getattr(plan, key) == value, (key, plan)
    assert plan.n_groups * plan.group >= nq


def test_adc_plan_any_width():
    """Every m up to 2048 (u8 codes) or 1024 (i32) and every ks gets a plan
    that fits; none raises."""
    for m in (*range(1, 70), 100, 128, 200, 255, 256, 257, 511, 1024, 2048):
        for code_dtype in ((torch.uint8, torch.int32) if m <= 1024
                           else (torch.uint8,)):
            for lut_dtype in ("f32", "int8"):
                for nq, ks in ((1, 256), (9, 256), (3, 17)):
                    _plan_ok(adc_plan(nq, m, ks, code_dtype, lut_dtype), m,
                             ks, code_dtype, lut_dtype)


def test_adc_plan_refuses():
    with pytest.raises(ValueError, match="lut_dtype"):
        adc_plan(1, 16, 256, torch.uint8, "f16")
    with pytest.raises(TypeError, match="codes"):
        adc_plan(1, 16, 256, torch.int64, "f32")
    with pytest.raises(ValueError, match="nq, m, ks"):
        adc_plan(0, 16)
    # i32 rows of 64 KB: two tiles of 16 rows cannot fit
    with pytest.raises(ValueError, match="too wide"):
        adc_plan(1, 16384, 256, torch.int32, "f32")
