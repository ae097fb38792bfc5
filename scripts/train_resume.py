#!/usr/bin/env python3
"""What resuming a full-width recommender trainer from its checkpoint
holds on one CUDA card.

    python3 scripts/train_resume.py [--arch dlrm-rm2] [--dir DIR]

Draws the arch at its published cardinalities (train_batch = 65,536 rows)
with `repro_torch.launch.train.build_trainer(scale="full")`, takes one
step, writes its checkpoint to DIR (default `.train_resume/` in the repo,
removed at the end), frees the state, and resumes as `train_loop` does:
`checkpoint.ckpt.restore` into a skeleton on the meta device. Then one
more step. Prints one `[train_resume]` line: the save and restore
seconds, the checkpoint's bytes, the peak device bytes of the restore
and of the step after it against the parameter and optimizer bytes, and
whether every leaf's sum came back equal; ends with the card's name and
power limit. Exits 1 when DIR's disk cannot hold the checkpoint. Where a
machine caps what a process may write to its disk below the checkpoint's
size (DLRM-rm2: 48.8 GB), give DIR on a RAM disk (`/dev/shm/...`).
"""
from __future__ import annotations

import argparse
import gc
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def leaf_sums(state) -> dict:
    from repro_torch.checkpoint.ckpt import _flatten
    # in each leaf's own dtype: a float64 sum would cast a copy of it
    return {n: float(t.detach().sum()) for n, t in _flatten(state).items()}


def nbytes(state) -> int:
    from repro_torch.checkpoint.ckpt import _flatten
    return sum(t.numel() * t.element_size()
               for t in _flatten(state).values())


def run(aid: str, ckpt_dir: str) -> dict:
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.device import to_tensor
    from repro_torch.launch import train
    dev = torch.device("cuda")
    _, state_init, step_fn, data = train.build_trainer(
        aid, "train_batch", scale="full", steps=3, device=dev)

    def step(state, i):
        batch = {k: to_tensor(v, dev) for k, v in data(i).items()}
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        return state, float(m["loss"])

    state, _ = step(state_init(), 0)
    total = nbytes(state)
    free = shutil.disk_usage(os.path.dirname(ckpt_dir)).free
    if free < 1.05 * total:
        raise SystemExit(f"train_resume: {free} bytes free under "
                         f"{ckpt_dir}, the checkpoint takes {total}")
    params = ckpt._flatten(state.params)
    param_bytes = nbytes(state.params)
    want = leaf_sums(state)
    t0 = time.perf_counter()
    ckpt.save(ckpt_dir, state, step=1)
    save_s = time.perf_counter() - t0
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = ckpt.restore(ckpt_dir, state_init(device="meta"), device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    peak_restore = torch.cuda.max_memory_allocated() - base
    got = leaf_sums(state)
    torch.cuda.reset_peak_memory_stats()
    state, loss = step(state, 1)
    peak_step = torch.cuda.max_memory_allocated() - base
    return dict(arch=aid, ckpt_bytes=total, param_bytes=param_bytes,
                opt_bytes=total - param_bytes, save_s=f"{save_s:.2f}",
                restore_s=f"{restore_s:.2f}",
                peak_restore_bytes=peak_restore,
                restore_above_state=peak_restore - total,
                peak_next_step_bytes=peak_step,
                leaves=len(want), sums_equal=got == want,
                loss_after_resume=f"{loss:.5f}", free_disk_bytes=free)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-rm2")
    ap.add_argument("--dir", default=os.path.join(ROOT, ".train_resume"))
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.dir)), exist_ok=True)
    try:
        out = run(args.arch, os.path.abspath(args.dir))
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    print("[train_resume] " + " ".join(f"{k}={v}" for k, v in out.items()),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if out["sums_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
