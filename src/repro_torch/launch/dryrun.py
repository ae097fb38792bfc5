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
  * `memory`: `argument_size_in_bytes` (the rank's blocks, exact),
    `output_size_in_bytes` (the step's answer), `peak_bytes` (the most
    bytes of storages made during the step alive at once: a storage
    counts its bytes from the op that first returns it until it is
    freed; views and in-place ops add nothing, the argument blocks are
    not counted), `temp_size_in_bytes` (the peak less the outputs the
    step made: peak - (output - alias), at least 0) and
    `alias_size_in_bytes` (the outputs that are argument storages: the
    decode cache updated in place, the trained state), so the
    reference's argument + temp + output - alias is what must fit;
    `peak_note` states the convention and the meta-only branches that
    make the peak an upper bound;
  * `cost`: `flops`, the rank's (`torch.utils.flop_counter.
    FlopCounterMode`: matrix products and attention; elementwise ops,
    gathers and segment sums count 0; plus the ANN kernels' charges,
    below), and `flops_x_ranks_over_model`,
    flops x ranks / the cell's model flops (1 where the ranks split the
    useful work, the world's size where each rank does all of it);
    `bytes accessed`, op by op (every tensor argument read and every
    output written once, a sparse tensor its indices and values; views,
    metadata ops, empty allocations and collectives count 0: the eager
    port's traffic, not XLA's fused figure) and `transcendentals` (the
    output elements of exp, log, tanh, sigmoid, erf, rsqrt, sqrt, pow,
    sin and cos); `note` says what the counts are and where a meta-only
    branch makes them upper bounds; an ANN cell adds `hops_counted` (1),
    `per_hop` (the flops and bytes of its hops) and `kernels` (what its
    stand-ins charged, by kernel);
  * `collectives`: {op: {count, bytes}} of every collective of
    `launch.mesh` during the step (`record_collectives`: the reference's
    op names, bytes the output on this rank a time).

A section that cannot be had is `{"error": ...}` naming the step's
failure (the op without a meta kernel). Two sparse ops that the training
cells reach have no meta kernel in torch: the optimizer's coalesce of the
tables' sparse gradients and Wide&Deep's densified `wide/*` gradients.
`install_sparse_meta` registers both for the sparse meta tensors before
the first trace, in this process alone (no served module registers them):
a coalesce keeps its input's nnz, an upper bound (on the card it removes
the duplicate ids), and those cells' `cost` and `collectives` say so in a
`note`. An ANN cell's search runs kernels and a loop that reads its flag
from the card, which meta tensors cannot: its trace runs the cell's own
step through `launch.ann_trace`'s stand-ins (the prologue, one hop a
query chunk and the merge; the kernels charged as the card runs them),
and `ANN_NOTE` says so. Skipped cells write a skip record. Exits 1 if
any cell fails.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ASSIGNED_ARCHS, get_arch
from repro_torch.launch.mesh import fake_world, make_production_grid, \
    record_collectives

NNZ_NOTE = ("a sparse gradient's nnz is taken as the rows it read, an upper "
            "bound: on the card a coalesce removes the duplicate ids")
PEAK_NOTE = ("peak_bytes: the most bytes of storages made during the step "
             "alive at once (each from the op that first returns it until "
             "it is freed; views and in-place ops add nothing; the argument "
             "blocks are not counted)")
BYTES_NOTE = ("bytes accessed: op by op, every tensor argument read and "
              "every output written once (views, metadata ops, empty "
              "allocations and collectives count 0): the eager port's "
              "traffic, not XLA's fused figure")
# the meta-only branches a cell's step takes that change what it holds or
# moves; each makes the peak and the bytes an upper bound or leaves out
# what it says
ATTN_NOTE = ("attention runs at most 8 blocks a side on meta "
             "(models/layers._Blocks), not the card's (512, 1024) tiles: "
             "the peak and the bytes are upper bounds")
CSR_NOTE = ("prepare_csr builds shape-only CSRs on meta and the segment "
            "sums (a CUDA kernel) give their shape: their bytes are not "
            "counted")
LOOKUP_NOTE = ("a row-sharded lookup takes every id as local on meta "
               "(models/recsys._local_rows): the peak and the bytes are "
               "upper bounds")
WIDEN_NOTE = ("off the card mm_f32 widens bfloat16 operands to float32 "
              "(models/layers.bf16_bmm_route): the bytes and the peak "
              "count the widened copies")
ANN_NOTE = ("the search counts its prologue, one hop and the merge, as "
            "the reference's XLA counts the loop's body once (per_hop "
            "scales it to the hops a search takes); every query chunk is "
            "counted, where the reference counts one; the pq_lut and "
            "fused_hop kernels are charged as the card runs them "
            "(launch/ann_trace.py: the frontier rows, not the chunk "
            "table), not by their plain versions")


def _tensors(tree):
    """Every tensor of a step's arguments or answer (tuples, lists, dicts,
    NamedTuples; a module's parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, (tuple, list)):
        for c in tree:
            yield from _tensors(c)
    elif isinstance(tree, dict):
        for c in tree.values():
            yield from _tensors(c)


def _parts(t: torch.Tensor):
    """The dense tensors that hold t's data: t, or a sparse COO tensor's
    indices and values."""
    if t.layout is torch.sparse_coo:
        return (t._indices(), t._values())
    return (t,)


def _bytes(t: torch.Tensor) -> int:
    return sum(p.numel() * p.element_size() for p in _parts(t))


def _storages(t: torch.Tensor):
    return [p.untyped_storage() for p in _parts(t)]


def _nbytes(tree) -> int:
    """Bytes of every tensor in a step's answer."""
    return sum(_bytes(t) for t in _tensors(tree))


# ops that allocate their output without writing it
_ALLOCS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided"})
# ops whose output elements are the record's transcendentals (and their
# in-place forms)
_TRANSCENDENTAL = frozenset({"exp", "log", "tanh", "sigmoid", "erf",
                             "rsqrt", "sqrt", "pow", "sin", "cos"})
_COLLECTIVES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})


@functools.lru_cache(maxsize=None)
def _op_info(func):
    """(collective, allocation, names of its write-only `out=` arguments,
    mutable, transcendental) of an op."""
    name = func.overloadpacket.__name__
    return (func.namespace in _COLLECTIVES, name in _ALLOCS,
            frozenset(a.name for a in func._schema.arguments if a.is_out),
            func._schema.is_mutable, name.rstrip("_") in _TRANSCENDENTAL)


def _flat(x, acc: list) -> list:
    """acc + the tensors of an op's arguments or outputs (nested lists and
    tuples)."""
    for a in x:
        if isinstance(a, torch.Tensor):
            acc.append(a)
        elif isinstance(a, (list, tuple)):
            _flat(a, acc)
    return acc


class Tally(TorchDispatchMode):
    """While open, counts each op's bytes accessed and transcendentals
    (the conventions of `BYTES_NOTE`) and the bytes of the storages made
    while it is open that are alive: `peak` is their most. Storages that
    exist when it opens (`args`, and any other it first sees as an op's
    input) are not counted. `charge` adds what a stand-in of a kernel
    moves and computes (`flops`: those charges alone)."""

    def __init__(self, args=()):
        super().__init__()
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.flops = 0.0
        self.live = 0
        self.peak = 0
        # id(storage): (its bytes counted live, a weak reference whose
        # callback takes them off when the storage is freed)
        self._held = {}
        for t in _tensors(args):
            for st in _storages(t):
                self._hold(st, False)

    def _hold(self, st, made: bool) -> None:
        """Track st (its bytes live if `made`) unless it is tracked
        already."""
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes() if made else 0
        self._held[key] = (n, weakref.ref(st, functools.partial(
            self._free, key)))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, _ref) -> None:
        self.live -= self._held.pop(key)[0]

    def charge(self, *, bytes: int, flops: float) -> None:
        """Count the bytes a kernel reads and writes and its flops, for
        a stand-in that only allocates the kernel's outputs."""
        self.bytes_accessed += bytes
        self.flops += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        collective, alloc, write_only, mutable, trans = _op_info(func)
        if collective:
            return out
        outs = _flat(out if isinstance(out, (tuple, list)) else (out,), [])
        if not outs:                   # a metadata op (sizes, nnz, flags)
            return out
        reads, written = _flat(args, []), []
        for k, v in kwargs.items():
            _flat((v,), written if k in write_only else reads)
        in_st = set()
        for t in (*reads, *written):
            for st in _storages(t):
                self._hold(st, False)
                in_st.add(id(st))
        view = not mutable             # every output aliases an input
        for t in outs:
            for st in _storages(t):
                self._hold(st, True)
                view = view and id(st) in in_st
        if view or alloc:
            return out
        self.bytes_accessed += sum(map(_bytes, reads)) + \
            sum(map(_bytes, outs))
        if trans:
            self.transcendentals += sum(t.numel() for t in outs)
        return out


def _first_error(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"


_SPARSE_META = []            # the registration's Library, kept alive
_coalesced = [0]             # coalesces traced in this process


def _coalesce_meta(self):
    _coalesced[0] += 1
    nnz = self._nnz()
    idx = torch.empty((self.sparse_dim(), nnz), dtype=torch.int64,
                      device="meta")
    vals = torch.empty((nnz, *self.shape[self.sparse_dim():]),
                       dtype=self.dtype, device="meta")
    return torch.sparse_coo_tensor(idx, vals, self.shape, is_coalesced=True)


def _to_dense_meta(self, dtype=None, masked_grad=None):
    return torch.empty(self.shape, dtype=dtype or self.dtype, device="meta")


def install_sparse_meta() -> None:
    """Register `aten::_coalesce` (the output's nnz is the input's, the
    upper bound) and `aten::_to_dense` for SparseMeta, once a process."""
    if _SPARSE_META:
        return
    lib = torch.library.Library("aten", "IMPL")
    lib.impl("_coalesce", _coalesce_meta, "SparseMeta")
    lib.impl("_to_dense", _to_dense_meta, "SparseMeta")
    _SPARSE_META.append(lib)


def trace(fn, args, standins=None) -> dict:
    """One call of fn(*args) on meta tensors: its flops, collectives,
    bytes accessed, transcendentals, peak, output and alias bytes, and
    whether it coalesced a sparse tensor. `standins(tally, flops)`, a
    context manager (`ann_trace.standins`), is open during the call; what
    it yields is returned under "standins"."""
    from torch.utils.flop_counter import FlopCounterMode
    install_sparse_meta()
    before = _coalesced[0]
    arg_st = {id(st) for t in _tensors(args) for st in _storages(t)}
    with record_collectives() as coll, \
            FlopCounterMode(display=False) as fc, Tally(args) as tally:
        def flops():
            return fc.get_total_flops() + tally.flops
        with (standins(tally, flops) if standins
              else contextlib.nullcontext()) as extra:
            out = fn(*args)
    alias = sum(_bytes(t) for t in _tensors(out)
                if any(id(st) in arg_st for st in _storages(t)))
    return {"flops": float(flops()), "collectives": coll, "standins": extra,
            "bytes accessed": tally.bytes_accessed,
            "transcendentals": tally.transcendentals,
            "peak_bytes": tally.peak, "output_size_in_bytes": _nbytes(out),
            "alias_size_in_bytes": alias,
            "sparse": _coalesced[0] > before}


def branch_notes(cell, grid, *, cp_attn: bool = False) -> list:
    """The meta-only branches (`ATTN_NOTE`, `WIDEN_NOTE`, `CSR_NOTE`,
    `LOOKUP_NOTE`) that the cell's step takes where they change what it
    holds or moves."""
    from repro_torch.distributed import sharding as SH
    arch = get_arch(cell.arch_id)
    shape = arch.shape(cell.shape_name)
    notes = []
    if shape.kind in ("lm_train", "lm_prefill"):
        # `_Blocks` on meta: max(block, ceil(S / 8)) a side, the card's
        # blocks at most 512 queries (a rank's q rows under CP) and 1,024
        # keys
        S = shape.seq_len
        sq = S // grid.sizes["model"] if cp_attn else S
        if -(-sq // 8) > min(512, sq) or -(-S // 8) > min(1024, S):
            notes.append(ATTN_NOTE)
    if arch.family == "lm" and arch.model.dtype == "bfloat16":
        notes.append(WIDEN_NOTE)
    if shape.kind in ("gnn_full", "gnn_batched"):
        notes.append(CSR_NOTE)
    if arch.family == "recsys" and any(
            SH.spec_axes(sp) for n, sp in cell.place.params.items()
            if n.startswith(("tables/", "wide/"))):
        notes.append(LOOKUP_NOTE)
    return notes


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
        ann = get_arch(arch_id).family == "ann"
        standins = None
        if ann:
            from repro_torch.launch.ann_trace import standins
        try:
            got = trace(cell.fn, local, standins)
        except Exception as e:                 # a section per failure
            if verbose:
                traceback.print_exc()
            err = {"error": "trace: " + _first_error(e)}
            got = {"cost": err, "collectives": err}
        rec["t_trace_s"] = round(time.time() - t0, 2)
    finally:
        set_policy(None)
    mem = rec["memory"]
    notes = [ANN_NOTE] if ann else branch_notes(cell, grid, cp_attn=cp_attn)
    if got.get("sparse"):
        notes.append(NNZ_NOTE)
    if "output_size_in_bytes" in got:
        mem["output_size_in_bytes"] = got["output_size_in_bytes"]
    if "peak_bytes" in got:
        made = got["output_size_in_bytes"] - got["alias_size_in_bytes"]
        mem.update(peak_bytes=got["peak_bytes"],
                   temp_size_in_bytes=max(0, got["peak_bytes"] - made),
                   alias_size_in_bytes=got["alias_size_in_bytes"])
    mem["peak_note"] = "; ".join([PEAK_NOTE, *notes])
    if "cost" in got:
        rec["cost"] = got["cost"]
    else:
        mf = cell.meta["model_flops"]
        rec["cost"] = {"flops": got["flops"],
                       "flops_x_ranks_over_model":
                           got["flops"] * grid.world / mf if mf else None,
                       "bytes accessed": got["bytes accessed"],
                       "transcendentals": got["transcendentals"],
                       "note": "; ".join([BYTES_NOTE, *notes])}
        if ann:
            s = got["standins"]
            rec["cost"].update(hops_counted=1, per_hop=s.per_hop,
                               kernels=s.kernels)
    rec["collectives"] = got["collectives"]
    if got.get("sparse"):
        rec["collectives"]["note"] = NNZ_NOTE
    if verbose:
        coll = rec["collectives"]
        ops = coll if "error" in coll else {
            k: (v["count"], round(v["bytes"] / 1e6, 1))
            for k, v in coll.items() if k != "note"}
        print(f"  args {mem['argument_size_in_bytes'] / 1e9:.4f} GB, "
              f"peak {mem.get('peak_bytes', 0) / 1e9:.4f} GB, "
              f"flops {rec['cost'].get('flops')}, bytes "
              f"{rec['cost'].get('bytes accessed')}, collectives "
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
