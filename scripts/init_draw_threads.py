#!/usr/bin/env python3
"""Repeat `tests/test_torch_recsys.py::test_init_recsys_matches_jax_shapes_
and_scales` (two seed-0 draws of `init_recsys` on the CPU must be
bit-equal) under each intra-op thread count, inside pytest-xdist workers
that run other test files beside it, as the tier-1 run does.

    python3 scripts/init_draw_threads.py [--threads 1 2 4 8] [--rounds 2]

Each round runs pytest with 6 workers (`--dist loadfile`) over the recsys
file and five neighbours; every worker first calls
`torch.set_num_threads(n)`. Prints one line a (threads, round): the
outcome of the draw test and the run's seconds; exits non-zero if any
draw test failed.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST = ("tests/test_torch_recsys.py::"
        "test_init_recsys_matches_jax_shapes_and_scales")
FILES = ("tests/test_torch_recsys.py", "tests/test_torch_pq.py",
         "tests/test_torch_kernels.py", "tests/test_torch_adc.py",
         "tests/test_torch_nav.py", "tests/test_torch_block_cache.py")
PLUGIN = '''
import os, torch
def pytest_configure(config):
    torch.set_num_threads(int(os.environ["INIT_DRAW_THREADS"]))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, nargs="+",
                    default=list(range(1, 9)))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    plugdir = os.path.join(ROOT, ".init_draw_plugin")
    os.makedirs(plugdir, exist_ok=True)
    with open(os.path.join(plugdir, "init_draw_threads_plugin.py"),
              "w") as f:
        f.write(PLUGIN)
    failed = 0
    for n in args.threads:
        for r in range(args.rounds):
            env = dict(os.environ, INIT_DRAW_THREADS=str(n),
                       PYTHONPATH=os.pathsep.join(
                           [os.path.join(ROOT, "src"), plugdir]),
                       JAX_PLATFORMS="cpu")
            t0 = time.time()
            res = subprocess.run(
                [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                 "-p", "init_draw_threads_plugin", "-n", "6", "--dist",
                 "loadfile", "-rA", *FILES], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=1800)
            lines = [l for l in res.stdout.splitlines() if TEST in l]
            outcome = lines[-1].split()[0] if lines else "MISSING"
            failed += outcome != "PASSED"
            print(f"threads={n} round={r} draw_test={outcome} "
                  f"rc={res.returncode} s={time.time() - t0:.1f}",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
