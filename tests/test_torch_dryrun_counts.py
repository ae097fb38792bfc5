"""The dry run's memory and cost counts (`repro_torch.launch.dryrun.Tally`,
`trace`, `branch_notes`) and the blocks it traces (`launch.inputs.
local_args`), against hand arithmetic on meta tensors.

- A rank's blocks are fresh meta tensors: each leaf's storage is its own
  bytes, so qwen3-1.7b decode_32k's blocks hold 1.893 GB of storage, not
  the 484 GB of the global tensors they were views of.
- Bytes accessed and transcendentals of known op sequences: a matmul, an
  in-place add, a view chain, a reshape that copies, an exp and its
  in-place form, a power, an empty allocation, an `out=` variant, a
  sparse coalesce.
- The peak of storages made while the tally is open, through an
  allocate, free, allocate sequence; the alias bytes of a cache updated
  in place; no dispatch mode left behind.
- The meta-only branches each cell's record names.
"""
import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import ProcessGrid

M = "meta"
F32 = 4


def _e(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=M)


def _storage_bytes(tree) -> dict:
    return {id(st): st.nbytes() for t in dryrun._tensors(tree)
            for st in dryrun._storages(t)}


@pytest.mark.parametrize("arch_id,shape_name", [
    ("qwen3-1.7b", "decode_32k"), ("dlrm-rm2", "train_batch")])
def test_local_args_hold_only_their_blocks(arch_id, shape_name):
    """Every leaf of a rank's blocks (module parameters too) owns a
    storage of exactly its bytes. Over the blocked args (not the batch,
    which the step takes whole and cuts itself) they add up to
    local_bytes less the batch's dp block."""
    grid = ProcessGrid((16, 16), ("data", "model"), rank=0)
    cell = I.build_cell(arch_id, shape_name, grid)
    local = I.local_args(cell, grid)
    held = 0
    for i, a in enumerate(local):
        for t in dryrun._tensors(a):
            assert t.is_meta
            assert t.untyped_storage().nbytes() == t.numel() * \
                t.element_size()
        if i not in cell.whole:
            held += sum(_storage_bytes(a).values())
    batch_block = sum(
        I._block(t, s, grid, None).numel() * t.element_size()
        for p, t, s in I.arg_leaves(cell)
        if int(p.split("/")[0]) in cell.whole)
    assert held == I.local_bytes(cell, grid) - batch_block
    if shape_name == "decode_32k":
        # 256 x the storage before the blocks were fresh tensors
        assert I.local_bytes(cell, grid) == 1_892_984_868
        assert sum(_storage_bytes(local).values()) < 1.9e9


def _mm(a, b):
    return a @ b


def _cases():
    """(name, args, fn, bytes accessed, transcendentals, peak)."""
    n = 8 * 16 * F32
    i = torch.empty((1, 7), dtype=torch.int64, device=M)
    sp = torch.sparse_coo_tensor(i, _e(7, 3), (10, 3))
    sp_bytes = 7 * 8 + 7 * 3 * F32
    return [
        # read (8, 16) and (16, 4), write (8, 4)
        ("matmul", (_e(8, 16), _e(16, 4)), _mm,
         (8 * 16 + 16 * 4 + 8 * 4) * F32, 0, 8 * 4 * F32),
        # read a and b, write a: no new storage
        ("add_", (_e(8, 16), _e(8, 16)), lambda a, b: a.add_(b), 3 * n, 0,
         0),
        # views move nothing and make no storage
        ("view_chain", (_e(8, 16),),
         lambda a: a.view(16, 8).t().unsqueeze(0)[:, 1:5].transpose(1, 2),
         0, 0, 0),
        # a non-contiguous reshape copies once (the view after is free)
        ("reshape_copy", (_e(8, 16),), lambda a: a.t().reshape(128), 2 * n,
         0, n),
        # exp: read + write; exp_: read + write of its own output
        ("exp", (_e(8, 16),), lambda a: torch.exp(a).exp_(), 4 * n, 2 * 128,
         n),
        ("pow", (_e(8, 16),), lambda a: a ** 2, 2 * n, 128, n),
        # an allocation writes nothing but holds its storage
        ("empty", (), lambda: torch.empty((100,), device=M), 0, 0,
         100 * F32),
        # the out= argument is written, not read
        ("add_out", (_e(8, 16), _e(8, 16), _e(8, 16)),
         lambda a, b, c: torch.add(a, b, out=c), 3 * n, 0, 0),
        # indices and values read, the coalesced ones written
        ("coalesce", (sp,), lambda s: s.coalesce(), 2 * sp_bytes, 0,
         sp_bytes),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,args,fn,nbytes,trans,peak", CASES,
                         ids=[c[0] for c in CASES])
def test_tally_counts_equal_hand_arithmetic(name, args, fn, nbytes, trans,
                                            peak):
    dryrun.install_sparse_meta()
    with dryrun.Tally(args) as tally:
        out = fn(*args)
    assert tally.bytes_accessed == nbytes
    assert tally.transcendentals == trans
    assert tally.peak == peak
    del out


def test_peak_of_allocate_free_allocate():
    """100 floats, then 50 (written), the 100 freed, then 70: the peak is
    150 floats alive at once, 120 alive at the end."""
    with dryrun.Tally() as tally:
        x = torch.empty((100,), device=M)
        y = torch.zeros((50,), device=M)
        del x
        z = torch.empty((70,), device=M)
        assert tally.live == 120 * F32
    assert tally.peak == 150 * F32
    assert tally.bytes_accessed == 50 * F32          # the zeros written
    del y, z
    assert tally.live == 0


def _decode_like(w, cache, x):
    """A step that writes the cache in place and returns it with its
    logits, as the decode cells do."""
    cache.index_copy_(1, torch.zeros((1,), dtype=torch.int64, device=M),
                      x[:, None])
    return torch.tanh(x @ w), cache


def test_alias_of_an_in_place_cache_update():
    w, cache, x = _e(32, 64), _e(4, 128, 32), _e(4, 32)
    got = dryrun.trace(_decode_like, (w, cache, x))
    cache_b, logits_b = 4 * 128 * 32 * F32, 4 * 64 * F32
    assert got["alias_size_in_bytes"] == cache_b
    assert got["output_size_in_bytes"] == cache_b + logits_b
    # the index (8 B) is freed after the copy; the product is alive while
    # its tanh is made
    assert got["peak_bytes"] == 2 * logits_b
    # the index written; index_copy_ reads the cache, the index and x and
    # writes the cache; the product; the tanh
    assert got["bytes accessed"] == (
        8 + 2 * cache_b + 8 + 4 * 32 * F32             # zeros + index_copy_
        + (32 * 64 + 4 * 32 + 4 * 64) * F32           # mm
        + 2 * logits_b)                               # tanh
    assert got["transcendentals"] == 4 * 64
    assert torch._C._len_torch_dispatch_stack() == 0


@pytest.mark.parametrize("arch_id,shape_name,want", [
    ("qwen3-1.7b", "train_4k", ["WIDEN_NOTE"]),
    ("qwen3-1.7b", "prefill_32k", ["ATTN_NOTE", "WIDEN_NOTE"]),
    ("qwen3-1.7b", "decode_32k", ["WIDEN_NOTE"]),
    ("graphsage-reddit", "full_graph_sm", ["CSR_NOTE"]),
    ("graphsage-reddit", "minibatch_lg", []),
    ("dcn-v2", "serve_p99", ["LOOKUP_NOTE"]),
    ("dlrm-rm2", "train_batch", ["LOOKUP_NOTE"]),
])
def test_branch_notes_name_the_meta_only_branches(arch_id, shape_name,
                                                  want):
    """At 4k tokens the meta attention blocks are the card's (512, 1024);
    at 32k they are coarser. Decode attends without a block plan. A
    bfloat16 LM's float32 products widen their operands off the card.
    The full graph's CSRs are shape-only; a row-sharded table's lookup
    takes every id as local."""
    grid = ProcessGrid((16, 16), ("data", "model"), rank=0)
    cell = I.build_cell(arch_id, shape_name, grid)
    assert dryrun.branch_notes(cell, grid) == [getattr(dryrun, n)
                                               for n in want]


def test_tally_sees_each_op_once_beside_the_flop_counter():
    """The tally under FlopCounterMode (as `trace` opens them): the same
    counts as alone, and the flops of the product."""
    a, b = _e(8, 16), _e(16, 4)
    got = dryrun.trace(_mm, (a, b))
    assert got["flops"] == 2 * 8 * 16 * 4
    assert got["bytes accessed"] == (8 * 16 + 16 * 4 + 8 * 4) * F32
    assert got["peak_bytes"] == got["output_size_in_bytes"] == 8 * 4 * F32
    assert got["alias_size_in_bytes"] == 0
    assert got["transcendentals"] == 0
