"""The port's plain kernel versions (and its wrappers on CPU tensors)
against the JAX package: `repro.kernels.ref` and the Pallas kernels in
interpret mode, on the shape sweeps of tests/test_kernels.py plus a
SIFT1M-width case. Tolerances follow tests/test_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adc import np_quantize_lut
from repro.core.chunk_layout import ChunkLayout as JLayout
from repro.core.chunk_layout import pack_chunks_device
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.chunk_adc import quantize_lut as jquantize_lut
from repro_torch import configs
from repro_torch.core.chunk_layout import ChunkLayout
from repro_torch.kernels import _build, chunk_adc, ops, ref
from repro_torch.kernels.chunk_adc import fused_hop as fused_hop_wrapper
from repro_torch.kernels.chunk_adc import hop_plan
from repro_torch.kernels.pq_adc import pq_adc_q8
from repro_torch.kernels.pq_lut import pq_lut as pq_lut_wrapper
from repro_torch.kernels.rerank import rerank as rerank_wrapper
from repro_torch.kernels.rerank import rerank_rows as rerank_rows_wrapper


def _t(a):
    return torch.from_numpy(np.array(a))


def _allclose(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _hop_close(got, want):
    """ids equal; finite patterns equal; distances within scaled 2e-6."""
    (e1, i1, d1), (e2, i2, d2) = got, want
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    for a, b in ((e1, e2), (d1, d2)):
        a, b = np.asarray(a), np.asarray(b)
        fin = np.isfinite(b)
        assert (np.isfinite(a) == fin).all()
        scale = np.abs(b[fin]).max() + 1e-6
        np.testing.assert_allclose(a[fin] / scale, b[fin] / scale, atol=2e-6)


# ---------------------------------------------------------------------------
# pq_lut
# ---------------------------------------------------------------------------


# dsub = d/m covers every subspace width of the repo's configurations: 1
# (SIFT1M), 2 (the short-slab layout), 4 (SIFT1B), 5 (SASRec's m=10 PQ of
# 50-wide embeddings) and 8 (KILT-E5-22M), plus 12
@pytest.mark.parametrize("nq,d,m,metric", [
    (1, 32, 4, "l2"), (3, 64, 16, "l2"), (5, 128, 32, "mips"),
    (2, 96, 8, "l2"), (4, 256, 64, "mips"), (3, 128, 128, "l2"),
    (4, 160, 80, "l2"), (1, 50, 10, "mips"), (3, 40, 8, "l2"),
    (2, 1024, 128, "mips"),
])
def test_pq_lut_matches_jax(nq, d, m, metric):
    rng = np.random.default_rng(nq * 1000 + d + m)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    cents = rng.normal(size=(m, 256, d // m)).astype(np.float32)
    mine = ref.pq_lut_ref(_t(q), _t(cents), metric=metric).numpy()
    _allclose(mine, jref.pq_lut_ref(jnp.asarray(q), jnp.asarray(cents),
                                    metric=metric))
    _allclose(mine, jops.build_lut(q, cents, metric=metric,
                                   backend="pallas_interpret"))
    # the wrapper and ops on CPU tensors run the plain version
    np.testing.assert_array_equal(
        pq_lut_wrapper(_t(q), _t(cents), metric=metric).numpy(), mine)
    np.testing.assert_array_equal(
        ops.build_lut(_t(q), _t(cents), metric=metric).numpy(), mine)


# ---------------------------------------------------------------------------
# fused_hop (f32 and int8)
# ---------------------------------------------------------------------------


def _hop_case(dt, R, m, dim, N=100, nq=2, w=4, seed=0):
    rng = np.random.default_rng(seed)
    if dt == "uint8":
        vecs = rng.integers(0, 255, (N, dim)).astype(np.uint8)
    else:
        vecs = rng.normal(size=(N, dim)).astype(np.float32)
    adj = rng.integers(-1, N, (N, R)).astype(np.int32)
    codes = rng.integers(0, 256, (N, m)).astype(np.uint8)
    jlay = JLayout("aisaq", dim, dt, R, m)
    words = np.ascontiguousarray(pack_chunks_device(vecs, adj, codes, jlay)) \
        .view(np.int32).reshape(N, -1)
    fids = rng.integers(-1, N, (nq, w)).astype(np.int32)
    qs = rng.normal(size=(nq, dim)).astype(np.float32)
    cents = rng.normal(size=(m, 256, dim // m)).astype(np.float32)
    return jlay, ChunkLayout("aisaq", dim, dt, R, m), words, fids, qs, cents


# (data dtype, metric, R, pq_m, dim): the sweep of tests/test_kernels.py,
# SIFT1M widths, and KILT-E5-22M widths (d=1024, R=69, m=128, mips), where
# w*R = 276 neighbours exceed one thread each and the hop's shared-memory
# plan is at its largest
HOP_SHAPES = [
    ("float32", "l2", 8, 8, 32), ("float32", "mips", 24, 16, 64),
    ("uint8", "l2", 12, 8, 48), ("uint8", "l2", 52, 32, 128),
    ("float32", "l2", 20, 12, 48), ("uint8", "mips", 16, 4, 16),
    ("float32", "l2", 56, 128, 128), ("float32", "mips", 69, 128, 1024),
]


@pytest.mark.parametrize("adc", ["f32", "int8"])
@pytest.mark.parametrize("dt,metric,R,m,dim", HOP_SHAPES)
def test_fused_hop_matches_jax(dt, metric, R, m, dim, adc):
    jlay, lay, words, fids, qs, cents = _hop_case(dt, R, m, dim)
    lut = np.asarray(jref.pq_lut_ref(jnp.asarray(qs), jnp.asarray(cents),
                                     metric=metric))
    jargs = (jnp.asarray(words), jnp.asarray(fids), jnp.asarray(lut),
             jnp.asarray(qs))
    targs = (_t(words), _t(fids), _t(lut), _t(qs))
    mine = ops.fused_hop(*targs, layout=lay, metric=metric, backend="ref",
                         adc_dtype=adc)
    _hop_close(mine, jops.fused_hop(*jargs, layout=jlay, metric=metric,
                                    backend="ref", adc_dtype=adc))
    if m % 8 == 0:           # the Pallas body needs m % 8 == 0
        _hop_close(mine, jops.fused_hop(*jargs, layout=jlay, metric=metric,
                                        backend="pallas_interpret",
                                        adc_dtype=adc))
    wrapped = fused_hop_wrapper(*targs, layout=lay, metric=metric,
                                adc_dtype=adc)
    for a, b in zip(wrapped, mine):
        assert torch.equal(a, b)
    if adc == "int8":        # quantization error bound against f32
        _, i32, d32 = ops.fused_hop(*targs, layout=lay, metric=metric,
                                    backend="ref")
        assert torch.equal(i32, mine[1])
        fin = torch.isfinite(d32)
        bound = m * float(np.abs(lut).max()) / 127
        assert float((mine[2][fin] - d32[fin]).abs().max()) <= bound + 1e-3


def _q8_hop_exact(words, fids, lut, qs, lay, metric):
    """The int8 hop's nbr_d from int32 sums of `ref.quantize_lut`'s codes,
    rescaled by scale * INV127: the CPU counterpart of chip_smoke.py's
    `hop_q8_exact`."""
    lut_q8, scale = ref.quantize_lut(lut)
    _, _, codes, nvalid = ref.expand_rows_ref(words, fids, qs, lay,
                                              metric=metric)
    nq, w, R, m = codes.shape
    ks = lut.shape[-1]
    idx = codes.long() + torch.arange(m) * ks
    flat = lut_q8.reshape(nq, 1, 1, m * ks).expand(nq, w, R, m * ks)
    acc = torch.gather(flat, 3, idx).sum(-1, dtype=torch.int32)
    d = acc.float() * ref.rescale127(scale)[:, None, None]
    return torch.where(nvalid, d, torch.inf)


@pytest.mark.parametrize("dt,metric,R,m,dim",
                         [s for s in HOP_SHAPES if s[3] % 8 == 0])
def test_int8_hop_int32_sums_match_pallas(dt, metric, R, m, dim):
    """int32 sums of the quantized LUT times scale * INV127 equal the
    interpreted Pallas int8 hop's nbr_d bit for bit (the jitted kernel
    multiplies by the rounded reciprocal of 127)."""
    jlay, lay, words, fids, qs, cents = _hop_case(dt, R, m, dim)
    lut = np.asarray(jref.pq_lut_ref(jnp.asarray(qs), jnp.asarray(cents),
                                     metric=metric))
    _, _, want = jops.fused_hop(jnp.asarray(words), jnp.asarray(fids),
                                jnp.asarray(lut), jnp.asarray(qs),
                                layout=jlay, metric=metric,
                                backend="pallas_interpret", adc_dtype="int8")
    mine = _q8_hop_exact(_t(words), _t(fids), _t(lut), _t(qs), lay, metric)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_dequantized_lut_matches_jit(seed, monkeypatch):
    """`ref.dequantize_lut`, the LUT that fused_hop_ref(adc_dtype="int8")
    sums, equals the one repro/kernels/ops.py builds for its int8
    emulation when run under jax.jit, as the device search runs it. The
    LUT is captured where ops.fused_hop hands it to the plain hop. An
    eager `scale / 127.0` (a true quotient) differs on these inputs."""
    jlay, _, words, _, _, _ = _hop_case("float32", 8, 16, 32, N=10)
    rng = np.random.default_rng(seed)
    nq = 64
    lut = (rng.random((nq, 16, 256))
           * rng.uniform(0.5, 40.0, (nq, 1, 1))).astype(np.float32)
    fids = np.zeros((nq, 4), dtype=np.int32)
    qs = np.zeros((nq, 32), dtype=np.float32)
    monkeypatch.setattr(jops._ref, "fused_hop_ref",
                        lambda cw, f, lut_q, q, layout, metric:
                        (lut_q, lut_q, lut_q))
    served = jax.jit(lambda l: jops.fused_hop(
        jnp.asarray(words), jnp.asarray(fids), l, jnp.asarray(qs),
        layout=jlay, backend="ref", adc_dtype="int8")[0])
    want = np.asarray(served(jnp.asarray(lut)))
    mine = ref.dequantize_lut(_t(lut))
    np.testing.assert_array_equal(mine.numpy(), want)
    q8, scale = ref.quantize_lut(_t(lut))
    true_quotient = (q8.float() * (scale / torch.full_like(scale, 127.0))
                     [:, None, None]).numpy()
    assert not np.array_equal(true_quotient, want)


def _configs():
    return [v for v in vars(configs).values()
            if isinstance(v, configs.IndexConfig)]


def test_index_configs_listed():
    assert {c.name for c in _configs()} >= {"sift1m", "sift1b",
                                             "kilt-e5-22m"}


@pytest.mark.parametrize("adc", ["f32", "int8"])
@pytest.mark.parametrize("shape", [
    *[(c.data_dtype, c.metric, c.R, c.pq_m, c.dim) for c in _configs()],
    *HOP_SHAPES])
def test_hop_plan_fits(shape, adc):
    """The plan fits Hopper's shared memory and holds the chunk row and the
    staged LUT (f32: two slabs; int8: all m*ks bytes and the CTA's f32
    share), and its slabs of lanes cover all m subspaces (the last one
    possibly short)."""
    dt, _, R, m, dim = shape
    lay = ChunkLayout("aisaq", dim, dt, R, m)
    plan = hop_plan(lay, adc_dtype=adc)
    assert plan.smem_bytes <= 232_448
    assert plan.smem_bytes == (chunk_adc.HOP_HEADER_BYTES
                               + lay.device_stride + plan.lut_bytes)
    assert plan.row_bytes == lay.device_stride
    # int8: the int8 LUT and a quarter of the f32 LUT (w=4)
    assert plan.lut_bytes == (m * 256 + m * 256 if adc == "int8"
                              else 2 * plan.group * 256 * 4)
    assert 1 <= plan.group <= 32
    assert (plan.n_slabs - 1) * plan.group < m <= plan.n_slabs * plan.group
    if m >= 32:
        assert plan.group == 32        # every lane has a subspace


def test_hop_plan_short_last_slab():
    plan = hop_plan(ChunkLayout("aisaq", 96, "float32", 20, 48))
    assert (plan.group, plan.n_slabs) == (32, 2)     # 32 + a slab of 16


def test_hop_plan_shrinks_slabs_then_raises():
    # a 172 KB row leaves room for f32 slabs of 16 subspaces, not 32
    wide = ChunkLayout("aisaq", 42_000, "float32", 32, 128)
    plan = hop_plan(wide)
    assert plan.group == 16 and plan.smem_bytes <= 232_448
    assert plan.n_slabs == 8
    # int8 stages the whole int8 LUT and a quarter of the f32 one: 64 KB
    for lay, kw in ((ChunkLayout("aisaq", 60_000, "float32", 56, 128), {}),
                    (wide, {"adc_dtype": "int8"}),
                    (ChunkLayout("aisaq", 128, "float32", 129, 128), {}),
                    (ChunkLayout("aisaq", 128, "float32", 56, 128),
                     {"ks": 254}),
                    (ChunkLayout("aisaq", 128, "float32", 56, 128), {"w": 9}),
                    (ChunkLayout("aisaq", 128, "float32", 56, 128),
                     {"adc_dtype": "bf16"}),
                    (ChunkLayout("aisaq", 30, "float32", 8, 6), {})):
        with pytest.raises(ValueError):
            hop_plan(lay, **kw)


def test_parse_chunks_words_matches_jax():
    jlay, lay, words, _, _, _ = _hop_case("uint8", 12, 8, 48, N=10)
    mine = ref.parse_chunks_words(_t(words), lay)
    theirs = jref.parse_chunks_words(jnp.asarray(words), jlay)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pq_adc_ref_matches_jax():
    rng = np.random.default_rng(3)
    lut = rng.random((16, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (300, 16)).astype(np.uint8)
    np.testing.assert_allclose(
        ref.adc_ref(_t(lut), _t(codes)).numpy(),
        np.asarray(jref.pq_adc_ref(jnp.asarray(lut), jnp.asarray(codes))),
        rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# quantize_lut
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_lut_bit_equal(seed):
    rng = np.random.default_rng(seed)
    lut = (rng.normal(size=(3, 12, 256)) * 5).astype(np.float32)
    # exact half-steps, where the rounding mode decides
    lut[0, 0, :8] = (np.arange(8) + 0.5) * np.abs(lut[0]).max() / 127
    q8, scale = ref.quantize_lut(_t(lut))
    jq8, jscale = jquantize_lut(jnp.asarray(lut))
    nq8, nscale = np_quantize_lut(lut)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(q8.numpy(), nq8)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(scale.numpy(), nscale)


# ---------------------------------------------------------------------------
# rerank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,c,d,metric", [
    (1, 64, 32, "l2"), (3, 1000, 128, "l2"), (2, 500, 64, "mips"),
])
def test_rerank_matches_jax(nq, c, d, metric):
    rng = np.random.default_rng(c + d)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    cand = rng.normal(size=(c, d)).astype(np.float32)
    mine = ref.rerank_ref(_t(q), _t(cand), metric=metric).numpy()
    _allclose(mine, jops.rerank(q, cand, metric=metric, backend="ref"))
    _allclose(mine, jops.rerank(q, cand, metric=metric,
                                backend="pallas_interpret"))
    np.testing.assert_array_equal(
        rerank_wrapper(_t(q), _t(cand), metric=metric).numpy(), mine)
    # a single query, and a candidate set per query (the serving layout)
    _allclose(ref.rerank_ref(_t(q[0]), _t(cand), metric=metric).numpy(),
              mine[0])
    per_q = np.stack([cand] * nq)
    _allclose(ops.rerank(_t(q), _t(per_q), metric=metric).numpy(), mine)


def _jax_gather_vecs(words, ids, jlay):
    """Candidate vectors read from the chunk rows as the reference engine
    reads them (repro/serving/engine.py make_device_search_fn
    `_gather_vecs`): rows by id, bitcast to bytes, the vector's bytes."""
    rows = jnp.asarray(words)[jnp.asarray(ids).reshape(-1)]
    by = jax.lax.bitcast_convert_type(rows, jnp.uint8) \
        .reshape(rows.shape[0], -1)
    vb = by[:, :jlay.b_full]
    if jlay.data_dtype == "uint8":
        return vb.astype(jnp.float32)
    return jax.lax.bitcast_convert_type(
        vb.reshape(rows.shape[0], jlay.dim, 4), jnp.float32)


# (data dtype, metric, R, pq_m, dim): both vector types, both metrics, a d
# that is not a multiple of 4 (u8: a partly used last word), SIFT1M widths
@pytest.mark.parametrize("dt,metric,R,m,dim", [
    ("float32", "l2", 8, 8, 32), ("float32", "mips", 12, 6, 30),
    ("uint8", "l2", 12, 8, 48), ("uint8", "mips", 16, 5, 50),
    ("uint8", "l2", 6, 2, 18), ("float32", "l2", 56, 128, 128),
])
def test_rerank_rows_matches_jax(dt, metric, R, m, dim):
    """The candidates read by id from the chunk rows and reranked: the
    port's plain version against the reference engine's gather, clip and
    where around the interpreted Pallas rerank (one call a query, as the
    reference engine makes them). Ids past the table clamp to its last
    row; ids < 0 give +inf."""
    N, nq, r = 40, 3, 24
    jlay, lay, words, _, _, _ = _hop_case(dt, R, m, dim, N=N)
    rng = np.random.default_rng(dim + R)
    qs = rng.normal(size=(nq, dim)).astype(np.float32)
    if dt == "uint8":
        qs = qs * 40 + 128
    ids = rng.integers(-1, N + 3, (nq, r)).astype(np.int32)
    ids[0, :4] = -1
    ids[1, :2] = N - 1 + np.arange(1, 3)
    cand = _jax_gather_vecs(words, np.clip(ids, 0, N - 1), jlay) \
        .reshape(nq, r, dim)
    want = np.stack([np.asarray(jops.rerank(
        jnp.asarray(qs[i]), cand[i], metric=metric,
        backend="pallas_interpret")) for i in range(nq)])
    want = np.where(ids >= 0, want, np.inf)
    targs = (_t(qs), _t(words), _t(ids))
    mine = ref.rerank_rows_ref(*targs, lay, metric=metric)
    np.testing.assert_array_equal(np.isinf(mine.numpy()), ids < 0)
    fin = ids >= 0
    _allclose(mine.numpy()[fin], want[fin])
    # the wrapper and ops on CPU tensors run the plain version
    assert torch.equal(rerank_rows_wrapper(*targs, lay, metric=metric), mine)
    assert torch.equal(ops.rerank_rows(*targs, lay, metric=metric), mine)
    assert torch.equal(ops.rerank_rows(*targs, lay, metric=metric,
                                       backend="ref"), mine)
    # the same as gathering the vectors and reranking them as a tensor
    gathered = ref.gather_vecs(_t(words), _t(ids).clamp(0, N - 1), lay)
    np.testing.assert_array_equal(gathered.numpy(), np.asarray(cand))
    direct = ops.rerank(_t(qs), gathered, metric=metric)
    assert torch.equal(torch.where(_t(ids) >= 0, direct, torch.inf), mine)


def test_rerank_rows_refuses_other_devices():
    """rerank_rows on a tensor that is neither on the CPU nor on CUDA
    raises instead of taking the plain version."""
    _, lay, words, _, qs, _ = _hop_case("float32", 8, 8, 32, N=10)
    ids = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        rerank_rows_wrapper(torch.zeros((2, 32), device="meta"), _t(words),
                            ids, lay)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.rerank_rows(_t(qs), _t(words), ids.to("meta"), lay)
    with pytest.raises(ValueError, match="backend"):
        ops.rerank_rows(_t(qs), _t(words), ids, lay, backend="pallas")


# ---------------------------------------------------------------------------
# wrapper contract
# ---------------------------------------------------------------------------


def test_wrappers_refuse_other_devices():
    """A tensor that is not on the CPU never takes the plain version: the
    wrappers launch on CUDA or raise."""
    q = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        pq_lut_wrapper(q, torch.zeros((2, 256, 4), device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        rerank_wrapper(q, torch.zeros((5, 8)))
    with pytest.raises(ValueError, match="backend"):
        ops.rerank(q, q, backend="pallas")


def test_launch_counts_untouched_on_cpu():
    _build.reset_launch_counts()
    _, lay, words, fids, qs, cents = _hop_case("float32", 8, 8, 32)
    lut = ops.build_lut(_t(qs), _t(cents))
    ops.fused_hop(_t(words), _t(fids), lut, _t(qs), layout=lay)
    ops.rerank(_t(qs), _t(qs))
    ops.rerank_rows(_t(qs), _t(words), _t(fids), lay)
    codes = _t(np.zeros((5, 8), dtype=np.uint8))
    ops.adc(lut, codes)
    pq_adc_q8(lut, codes)
    assert set(_build.launch_counts) == set(_build.KERNELS)
    assert all(v == 0 for v in _build.launch_counts.values())
