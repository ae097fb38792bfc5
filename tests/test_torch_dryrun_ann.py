"""The paper's ANN cells in the port's dry run (`launch.dryrun` through
`launch.ann_trace`'s stand-ins of `pq_lut` and `fused_hop`), on the CPU.

- All 12 records (3 indices x 2 shapes x 2 grids, one subprocess with
  the fake 256- and 512-rank worlds) carry the memory and cost fields of
  every traced cell, with temp = peak - (output - alias), no alias, the
  (B_l, 10) ids and distances as output, and the hop kernel's chunk rows
  equal to `launch.flops.ann_cell_terms(hops=1)`.
- Against the reference's six pod1 records (`repro.launch.dryrun` in a
  subprocess on 512 virtual CPU devices; jax runs only there): equal
  argument bytes, output bytes less XLA's 16-byte tuple table (8 B an
  output), equal collectives.
- A small ANN cell on a fake (2, 2) world (a subprocess): the stand-ins'
  charges equal the formulas written here, and the peak is the hand sum,
  term by term, of `_Search`'s fixed state, the LUT and what the hop
  holds at its last sort.
- The swap is scoped: the served functions are back after a trace and
  after one that raises, and importing the dry run installs nothing.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core import device_index as DI
from repro_torch.core import sharded_search as SS
from repro_torch.core.chunk_layout import ChunkLayout, layout_for
from repro_torch.kernels import ops
from repro_torch.launch import ann_trace, dryrun
from repro_torch.launch import inputs as I
from repro_torch.launch.flops import ann_cell_terms
from repro_torch.launch.mesh import ProcessGrid

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HERE = os.path.dirname(__file__)
ANN = ("aisaq-sift1m", "aisaq-sift1b", "aisaq-kilt-e5")
SHAPES = ("serve_q32", "serve_q1k")
GRIDS = {"pod1": ((16, 16), ("data", "model")),
         "pod2": ((2, 16, 16), ("pod", "data", "model"))}
RECORDS = [(a, s, g) for a in ANN for s in SHAPES for g in GRIDS]
K = 10                                   # the cells' k

_PORT = """
import sys
from repro_torch.launch import dryrun
for a in %r:
    assert dryrun.main(["--arch", a, "--both-meshes", "--out",
                        sys.argv[1]]) == 0, a
"""
_REF = """
import sys
from repro.launch import dryrun
for a in %r:
    dryrun.main(["--arch", a, "--out", sys.argv[1]])
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               **extra)
    env.pop("REPRO_GNN", None)
    env.pop("REPRO_MB_BUDGET_GB", None)
    return env


def _load(out, names):
    got = {}
    for a, s, g in names:
        with open(os.path.join(out, f"{a}__{s}__{g}.json")) as f:
            got[(a, s, g)] = json.load(f)
    return got


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(the port's 12 records, the reference's 6 pod1 records), both
    subprocesses run side by side."""
    port, ref = (str(tmp_path_factory.mktemp(n)) for n in ("port", "ref"))
    runs = [subprocess.Popen(
        [sys.executable, "-c", code % (ANN,), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for code, out, env in (
            (_PORT, port, _env()),
            (_REF, ref, _env(JAX_PLATFORMS="cpu", XLA_FLAGS=(
                "--xla_force_host_platform_device_count=512"))))]
    try:
        for r in runs:
            o, e = r.communicate(timeout=300)
            assert r.returncode == 0, o[-3000:] + e[-3000:]
    finally:
        for r in runs:
            r.kill()
    return (_load(port, RECORDS),
            _load(ref, [(a, s, "pod1") for a in ANN for s in SHAPES]))


def _rank_cell(arch_id, shape_name, grid_tag):
    """(the rank's query rows: the batch over dp in mode A, all of it in
    mode B; the cell; its grid as rank 0)."""
    shape, axes = GRIDS[grid_tag]
    grid = ProcessGrid(shape, axes, rank=0)
    cell = I.build_cell(arch_id, shape_name, grid)
    return I.local_args(cell, grid)[1].shape[0], cell, grid


@pytest.mark.parametrize("arch_id,shape_name,grid_tag", RECORDS,
                         ids=["-".join(r) for r in RECORDS])
def test_ann_record_has_the_traced_fields(records, arch_id, shape_name,
                                          grid_tag):
    rec = records[0][(arch_id, shape_name, grid_tag)]
    for section in ("memory", "cost", "collectives"):
        assert "error" not in rec[section], (section, rec[section])
    mem, cost = rec["memory"], rec["cost"]
    b_l, cell, grid = _rank_cell(arch_id, shape_name, grid_tag)
    assert mem["argument_size_in_bytes"] == I.local_bytes(cell, grid)
    assert mem["output_size_in_bytes"] == b_l * K * 8
    assert mem["alias_size_in_bytes"] == 0
    assert mem["temp_size_in_bytes"] == \
        mem["peak_bytes"] - (mem["output_size_in_bytes"]
                             - mem["alias_size_in_bytes"])
    assert 0 < mem["peak_bytes"] < 1e9
    assert cost["flops"] > 0 and cost["transcendentals"] == 0
    assert cost["flops_x_ranks_over_model"] == pytest.approx(
        cost["flops"] * grid.world / cell.meta["model_flops"])
    assert cost["hops_counted"] == 1
    assert 0 < cost["per_hop"]["flops"] < cost["flops"]
    assert 0 < cost["per_hop"]["bytes accessed"] < cost["bytes accessed"]
    assert dryrun.ANN_NOTE in mem["peak_note"]
    assert mem["peak_note"].startswith(dryrun.PEAK_NOTE)
    assert cost["note"] == "; ".join([dryrun.BYTES_NOTE, dryrun.ANN_NOTE])
    # a query chunk of 128 a launch in mode B, one launch in mode A
    chunks = -(-b_l // 128) if cell.meta["mode"] == "B" and b_l > 128 \
        else 1
    hop, lut = cost["kernels"]["fused_hop_f32"], cost["kernels"]["pq_lut"]
    assert hop["launches"] == lut["launches"] == chunks
    assert cost["per_hop"]["flops"] == hop["flops"]
    assert cost["flops"] == hop["flops"] + lut["flops"]
    # the hop kernel's chunk rows: the roofline's term for one hop
    arch = get_arch(arch_id)
    ways = dict(zip(grid.axis_names, grid.shape))
    terms = ann_cell_terms(
        arch, arch.shape(shape_name), grid.world, ways["model"],
        grid.world // ways["model"], mode_b=cell.meta["mode"] == "B",
        hops=1, w=arch.model.beamwidth)
    assert hop["chunk_row_bytes"] == terms["hbm_bytes"]
    # the merge's two all-gathers over the shard group
    each = cell.meta["n_shards"] * b_l * K * 4
    assert rec["collectives"] == {"all-gather": {"count": 2,
                                                 "bytes": 2 * each}}


def test_sift1m_q1k_counts_the_kernels_not_their_plain_versions(records):
    """The plain versions' trace held 46.5 MB at its peak and counted 2.6
    GB (the chunk table at each gather): the stand-ins keep both down."""
    rec = records[0][("aisaq-sift1m", "serve_q1k", "pod1")]
    assert rec["memory"]["peak_bytes"] < 12e6
    assert rec["cost"]["bytes accessed"] < 100e6


@pytest.mark.parametrize("arch_id,shape_name",
                         [(a, s) for a in ANN for s in SHAPES])
def test_ann_record_matches_the_reference(records, arch_id, shape_name):
    mine = records[0][(arch_id, shape_name, "pod1")]
    ref = records[1][(arch_id, shape_name, "pod1")]
    assert mine["meta"]["mode"] == ref["meta"]["mode"]
    assert mine["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]
    # XLA's output is a tuple of two arrays: 8 B of table an array
    assert mine["memory"]["output_size_in_bytes"] == \
        ref["memory"]["output_size_in_bytes"] - 16
    assert mine["collectives"] == ref["collectives"]


# ---------------------------------------------------------------------------
# a small cell by hand
# ---------------------------------------------------------------------------

SMALL = dict(n_vectors=4000, dim=32, pq_m=8, R=16)
SMALL_BATCH = 16


def _small_cell(grid):
    base = get_arch("aisaq-sift1m")
    arch = dataclasses.replace(base, model=base.model.scaled(**SMALL))
    shape = ShapeConfig("small", "ann_search", batch=SMALL_BATCH)
    return arch, shape, I._build_ann_cell(arch, shape, grid,
                                          {"model_flops": 1.0})


def small_trace() -> dict:
    """The small cell's trace as rank 0 of a fake (2, 2) world."""
    from repro_torch.launch.mesh import fake_world
    fake_world(4)
    grid = ProcessGrid((2, 2), ("data", "model"))
    _, _, cell = _small_cell(grid)
    got = dryrun.trace(cell.fn, I.local_args(cell, grid), ann_trace.standins)
    s = got.pop("standins")
    return dict(got, per_hop=s.per_hop, kernels=s.kernels)


_SMALL = """
import json
import torch.distributed as dist
import test_torch_dryrun_ann as T
print(json.dumps(T.small_trace()))
dist.destroy_process_group()
"""


def test_small_cell_counts_by_hand():
    r = subprocess.run([sys.executable, "-c", _SMALL], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    arch, shape, cell = _small_cell(ProcessGrid((2, 2), ("data", "model"),
                                                rank=0))
    cfg = arch.model
    lay = layout_for(cfg, "aisaq")
    assert cell.meta["mode"] == "A" and cell.meta["n_shards"] == 2
    nq = SMALL_BATCH // 2                # the rank's block, a power of two
    d, m, ks, R, w, L = cfg.dim, cfg.pq_m, cfg.pq_ks, cfg.R, 4, 128
    dsub, n_ep = d // m, cfg.n_ep
    N = cfg.n_vectors // 2               # the shard's rows
    stride = lay.device_stride
    assert cfg.metric == "l2" and w == cfg.beamwidth

    # the stand-ins' charges: pq_lut reads queries and centroids and
    # writes the LUT; an entry costs its cross product (an FMA a
    # dimension) and qn - 2 cross + cn, plus each query slab's and each
    # centroid's norm
    lut = got["kernels"]["pq_lut"]
    assert lut["bytes accessed"] == 4 * (nq * d + m * ks * dsub
                                         + nq * m * ks)
    assert lut["flops"] == nq * m * ks * (2 * dsub + 3) \
        + nq * m * 2 * dsub + m * ks * 2 * dsub
    # the hop reads w chunk rows a query at the stride, the query's LUT,
    # the query and its frontier ids, and writes (exact, ids, ADC);
    # a row costs 3 d for its exact distance and R m ADC additions
    hop = got["kernels"]["fused_hop_f32"]
    assert hop["chunk_row_bytes"] == nq * w * stride
    assert hop["bytes accessed"] == nq * w * stride + 4 * nq * m * ks \
        + 4 * nq * d + 4 * nq * w + 4 * nq * w * (1 + 2 * R)
    assert hop["flops"] == nq * w * (3 * d + R * m)
    assert got["per_hop"]["flops"] == hop["flops"]
    assert got["flops"] == lut["flops"] + hop["flops"]
    assert got["per_hop"]["bytes accessed"] > hop["bytes accessed"]
    assert hop["chunk_row_bytes"] == ann_cell_terms(
        arch, shape, 4, 2, 2, mode_b=False, hops=1, w=w)["hbm_bytes"]
    assert got["collectives"] == {"all-gather": {"count": 2, "bytes":
                                                 2 * 2 * nq * K * 4}}
    assert got["output_size_in_bytes"] == nq * K * 8
    assert got["alias_size_in_bytes"] == 0

    # the peak: at the hop's last sort (step 5, the candidate list cut
    # to L), every storage then alive
    wr, i32, f32, i64, b8 = w * R, 4, 4, 8, 1
    fixed = {
        "eidx": i64 * m * n_ep, "q": f32 * nq * d, "n_real": 4,
        "cand_ids": i32 * nq * L, "cand_d": f32 * nq * L,
        "cand_exp": b8 * nq * L,
        "inserted (int32 words)": i32 * nq * -(-N // 32),
        "pool_ids": i32 * nq * L, "pool_d": f32 * nq * L,
        "hop_count": 4, "status": 2 * 4}
    held_lut = f32 * nq * m * ks
    hop_live = {
        "active": b8,
        "sel": f32 * nq * L,
        "frontier sort (values, positions)": (f32 + i64) * nq * L,
        "fvalid": b8 * nq * w,
        "fids": i32 * nq * w,
        "cand_exp scattered": b8 * nq * L,
        "fused_hop (exact, ids, nbr_d)": f32 * nq * w + 2 * 4 * nq * wr,
        "pool sort (values, positions)": (f32 + i64) * nq * (L + w),
        "pool_ids": i32 * nq * L,
        "words": i32 * nq * wr,
        "seen": b8 * nq * wr,
        "bad": b8 * nq * wr,
        "nd_f, nids_f, bits masked": 3 * 4 * nq * wr,
        "safe (int64)": i64 * nq * wr,
        "all_ids": i32 * nq * (L + wr),
        "all_exp": b8 * nq * (L + wr),
        "cat of cand_d and nd_f": f32 * nq * (L + wr),
        "step-5 sort (values, positions)": (f32 + i64) * nq * (L + wr)}
    assert got["peak_bytes"] == sum(fixed.values()) + held_lut \
        + sum(hop_live.values())


# ---------------------------------------------------------------------------
# the swap is scoped
# ---------------------------------------------------------------------------

def _served():
    return ops.build_lut, ops.fused_hop, SS.beam_search_device


def _meta_search_args():
    lay = ChunkLayout(mode="aisaq", dim=8, data_dtype="float32", R=4,
                      pq_m=4)

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    idx = DI.DeviceIndex(
        chunk_words=meta((100, lay.device_stride // 4), torch.int32),
        centroids=meta((4, 256, 2)), ep_ids=meta((1,), torch.int32),
        ep_codes=meta((1, 4), torch.int32))
    return idx, lay, meta((3, 8))


def test_the_standins_are_scoped_to_a_trace():
    served = _served()
    # importing the dry run (this module did) installs nothing
    assert ops.build_lut.__module__ == ops.fused_hop.__module__ == \
        "repro_torch.kernels.ops"
    assert SS.beam_search_device is DI.beam_search_device
    idx, lay, q = _meta_search_args()
    seen = []

    def step(q):
        seen.append(_served())
        ids, d, hops = SS.beam_search_device(idx, q, k=2, L=8, w=2,
                                             layout=lay)
        assert hops == 1
        return ids, d

    got = dryrun.trace(step, (q,), ann_trace.standins)
    assert all(a is not b for a, b in zip(seen[0], served))
    assert _served() == served
    assert got["standins"].kernels["fused_hop_f32"]["launches"] == 1
    assert got["output_size_in_bytes"] == 3 * 2 * 8

    def boom(q):
        seen.append(_served())
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        dryrun.trace(boom, (q,), ann_trace.standins)
    assert all(a is not b for a, b in zip(seen[1], served))
    assert _served() == served
