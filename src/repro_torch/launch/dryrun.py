"""Dry run of every (arch x shape) cell on the production grids, on one
CPU with no card (port of `repro.launch.dryrun`):

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a --shape s]
        [--multi-pod | --both-meshes] [--force] [--cp-attn] [--tag t]
        [--out dryrun_out]

The reference lowers and compiles each cell for 256 (or 512) virtual
devices and reads XLA's memory and cost analyses and the collectives of
the partitioned HLO. The port has no compiler to ask, so it runs the step
instead, as rank 0 of a fake world of 256 (or 512) ranks
(`launch.mesh.fake_world`: collectives return at once) on tensors of the
meta device (shapes and dtypes, no storage): the rank's blocks of every
input (`launch.inputs.local_args`). Each cell writes one JSON record:

  * `arch`, `shape`, `mesh`, `mesh_axes`, `n_devices`, `meta` (the
    cell's: model flops, microbatches, parameter bytes, ANN mode);
  * `t_build_s` (the cell and its blocks) and `t_trace_s` (the step on
    meta), in place of the reference's lower and compile seconds;
  * `memory`: `argument_size_in_bytes` (the rank's blocks, exact) and
    `output_size_in_bytes` (the step's answer); no peak (`peak_note`
    says why);
  * `cost`: `flops`, the rank's (`torch.utils.flop_counter.
    FlopCounterMode`: matrix products and attention; elementwise ops,
    gathers and segment sums count 0), and `flops_x_ranks_over_model`,
    flops x ranks / the cell's model flops (1 where the ranks split the
    useful work, the world's size where each rank does all of it);
  * `collectives`: {op: {count, bytes}} of every collective of
    `launch.mesh` during the step (`record_collectives`: the reference's
    op names, bytes the output on this rank a time).

A section that cannot be had is `{"error": ...}` naming the step's
failure (the op without a meta kernel). An ANN cell's search runs CUDA
graphs and kernels, which meta tensors cannot run: its record counts the
merge's two all-gathers of (n_shards, B_l, k) from the output shapes
(`core.sharded_search`) and says so. Skipped cells write a skip record.
Exits 1 if any cell fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_arch
from repro_torch.launch.mesh import fake_world, make_production_grid, \
    record_collectives

# the k of the ANN cells' search (`inputs._build_ann_cell`)
ANN_K = 10
PEAK_NOTE = ("no peak: meta tensors have no allocator to read, and "
             "MemTracker over a meta trace gave 485 GB for one qwen3-1.7b "
             "decode_32k step (no rank holds that much), so no figure is "
             "given")


def _nbytes(tree) -> int:
    """Bytes of every tensor in a step's answer (tuples, lists, dicts,
    NamedTuples, modules; other values count 0)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (tuple, list, type({}.values()))):
        return sum(_nbytes(c) for c in tree)
    return 0


def _first_error(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"


def _ann_record(cell, local) -> dict:
    """The ANN search's merge on a rank: all-gathers of its (B_l, k)
    int32 ids and float32 distances over the n_shards of its shard
    group (this rank's `queries` block is B_l rows)."""
    n = cell.meta["n_shards"]
    b_l = local[1].shape[0]
    each = n * b_l * ANN_K * 4
    note = ("not traced: the hop loop runs CUDA graphs and kernels; the "
            "merge's two all-gathers are counted from the output shapes")
    return {"collectives": {"all-gather": {"count": 2, "bytes": 2 * each}},
            "collectives_note": note,
            "cost": {"flops": None, "note": note},
            "output_size_in_bytes": b_l * ANN_K * 8}


def trace(fn, args) -> dict:
    """One call of fn(*args) on meta tensors: its flops, collectives and
    output bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    with record_collectives() as coll, \
            FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return {"flops": float(fc.get_total_flops()), "collectives": coll,
            "output_size_in_bytes": _nbytes(out)}


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True, cp_attn: bool = False) -> dict:
    from repro_torch.distributed.act_sharding import set_policy
    from repro_torch.launch.inputs import build_cell, local_args, \
        local_bytes

    grid = make_production_grid(multi_pod=multi_pod)
    set_policy(grid, cp_attention=cp_attn)
    try:
        t0 = time.time()
        cell = build_cell(arch_id, shape_name, grid)
        local = local_args(cell, grid)
        t_build = time.time() - t0
        rec = {"arch": arch_id, "shape": shape_name,
               "mesh": list(grid.shape), "mesh_axes": list(grid.axis_names),
               "n_devices": grid.world, "t_build_s": round(t_build, 2),
               "meta": dict(cell.meta),
               "memory": {"argument_size_in_bytes": local_bytes(cell, grid)}}
        t0 = time.time()
        if get_arch(arch_id).family == "ann":
            got = _ann_record(cell, local)
            rec["collectives_note"] = got.pop("collectives_note")
        else:
            try:
                got = trace(cell.fn, local)
            except Exception as e:             # a section per failure
                if verbose:
                    traceback.print_exc()
                err = {"error": "trace: " + _first_error(e)}
                got = {"cost": err, "collectives": err}
        rec["t_trace_s"] = round(time.time() - t0, 2)
    finally:
        set_policy(None)
    mem = rec["memory"]
    if "output_size_in_bytes" in got:
        mem["output_size_in_bytes"] = got["output_size_in_bytes"]
    mem["peak_note"] = PEAK_NOTE
    if "cost" in got:
        rec["cost"] = got["cost"]
    else:
        mf = cell.meta["model_flops"]
        rec["cost"] = {"flops": got["flops"],
                       "flops_x_ranks_over_model":
                           got["flops"] * grid.world / mf if mf else None}
    rec["collectives"] = got["collectives"]
    if verbose:
        coll = rec["collectives"]
        ops = coll if "error" in coll else {
            k: (v["count"], round(v["bytes"] / 1e6, 1))
            for k, v in coll.items()}
        print(f"  args {mem['argument_size_in_bytes'] / 1e9:.4f} GB, "
              f"flops {rec['cost'].get('flops')}, collectives "
              f"(count, MB) {ops}", flush=True)
    return rec


def list_cells():
    """[(arch, shape, skipped)] in the reference's order: the assigned
    architectures' shapes (documented skips marked), then the paper's
    three indices."""
    cells = []
    for aid in ASSIGNED_ARCHS:
        arch = get_arch(aid)
        for s in arch.shapes:
            cells.append((aid, s.name, s.name in arch.skip_shapes))
    for aid in ("aisaq-sift1m", "aisaq-sift1b", "aisaq-kilt-e5"):
        arch = get_arch(aid)
        for s in arch.shapes:
            cells.append((aid, s.name, False))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--cp-attn", action="store_true",
                    help="context-parallel attention")
    ap.add_argument("--tag", default="",
                    help="record filename suffix")
    ap.add_argument("--out", default="dryrun_out")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = list_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]

    failures = []
    t_all = time.time()
    for multi_pod in meshes:
        tag = ("pod2" if multi_pod else "pod1") + \
            (f"__{args.tag}" if args.tag else "")
        fake_world(512 if multi_pod else 256)
        for arch_id, shape_name, skipped in cells:
            path = os.path.join(args.out,
                                f"{arch_id}__{shape_name}__{tag}.json")
            if skipped:
                rec = {"arch": arch_id, "shape": shape_name, "mesh_tag": tag,
                       "skipped": True,
                       "reason": get_arch(arch_id).skip_reason}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[skip] {arch_id} x {shape_name}: documented skip")
                continue
            if os.path.exists(path) and not args.force:
                print(f"[cached] {arch_id} x {shape_name} ({tag})")
                continue
            print(f"[dryrun] {arch_id} x {shape_name} ({tag}) ...",
                  flush=True)
            try:
                rec = run_cell(arch_id, shape_name, multi_pod=multi_pod,
                               cp_attn=args.cp_attn)
                rec["mesh_tag"] = tag
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"  OK build={rec['t_build_s']}s "
                      f"trace={rec['t_trace_s']}s", flush=True)
            except Exception as e:
                failures.append((arch_id, shape_name, tag, str(e)))
                traceback.print_exc()
                print(f"  FAIL {arch_id} x {shape_name}: {e}", flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"\nwall {time.time() - t_all:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f[:3], f[3][:200])
        return 1
    print("\nall dry-run cells OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
