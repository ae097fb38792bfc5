"""Run one benchmark cell of the port and print its result line.

    python3 annbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix and metrics come from
`BENCHMARK.json` and the files under `annbench/`. The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, breakdown with --trace 1, then checks); the last lines of
standard error give each number compared beside its limit. Exits 1
without a result where the card is missing or too few, and 3 where JAX
or the JAX package `repro` was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".annbench_cache"
# build and kernel caches stay inside the checkout, at fixed paths (the
# port builds its own kernel library under src/repro_torch/kernels/build/)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# the tracing library stays up once started: on the card, a profiler
# session opened after another one lost its first launches
os.environ["TEARDOWN_CUPTI"] = "0"
os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from annbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        harness.log(f"run: the cell needs {cell['chips']} CUDA device(s); "
                    f"{have} available")
        return 1
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        harness.log(f"run: JAX or the JAX package was loaded: {loaded}")
        return 3
    for name, c in out["checks"].items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
