#!/usr/bin/env python3
"""Where the fused hop's time goes, phase by phase, on one NVIDIA card.

    python3 scripts/hop_trace.py

Builds `src/repro_torch/kernels/csrc/aisaq_kernels.cu` with AISAQ_HOP_TRACE
defined (into the gitignored `kernels/build/`), so that thread 0 of every
CTA stamps %globaltimer at each phase of `hop_kernel`. On a random table
at SIFT1M widths (10,000 rows, w=4) it times `fused_hop` at batches of 1,
64 and 256 (CUDA graph of 20 calls, as `chip_smoke.device_ms`), then runs
one stamped call and prints, per dtype and batch, the median over CTAs of
each phase's time since the CTA started (ns). Phases:
  int8 only: maxed (its share of max|lut| read), scale (first cluster
  barrier passed);
  both: staged (set-up done; int8: its share of the LUT quantized and
  written into the cluster), ready (the cluster barrier after set-up
  passed), row (its chunk row
  landed), slab0..slab3 (f32: each LUT slab landed; int8: each slab's
  lookups begin), adc (sums done), out (outputs written), exit.
Needs a CUDA card and nvcc; exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = {"maxed": 1, "scale": 2, "staged": 3, "ready": 4, "row": 5,
          "slab0": 9, "slab1": 10, "slab2": 11, "slab3": 12, "adc": 6,
          "out": 7, "exit": 8}
TRACE_CTAS = 1024              # kHopTraceCtas in the kernel source


def traced_library():
    """The kernels built with the phase stamps, bound like `_build.lib`."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "aisaq_kernels_trace.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DAISAQ_HOP_TRACE", "-o",
           str(out), *map(str, _build.SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.aisaq_hop_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.aisaq_hop_trace.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hop_trace: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.chunk_adc import fused_hop
    lib = traced_library()
    _build._lib = lib          # the wrappers launch the stamped kernels
    dev = torch.device("cuda")
    n, d, R, m, w = 10_000, 128, 56, 128, 4
    lay, words = chip_smoke.random_table(n, d, "float32", R, m, dev, 3)
    g = torch.Generator(device=dev).manual_seed(0)
    stamps = np.zeros(TRACE_CTAS * 16, dtype=np.uint64)
    print(chip_smoke.card_line(), flush=True)
    for nq in (1, 64, 256):
        q = torch.randn((nq, d), generator=g, device=dev)
        lut = torch.rand((nq, m, 256), generator=g, device=dev) * 5
        fids = [torch.randint(0, n, (nq, w), generator=g, device=dev,
                              dtype=torch.int32) for _ in range(20)]
        for adc in ("f32", "int8"):
            ms = chip_smoke.device_ms([lambda f=f: fused_hop(
                words, f, lut, q, layout=lay, adc_dtype=adc) for f in fids])
            torch.cuda.synchronize()
            _build.check(lib.aisaq_hop_trace(None, 1), "hop_trace clear")
            fused_hop(words, fids[0], lut, q, layout=lay, adc_dtype=adc)
            torch.cuda.synchronize()
            _build.check(lib.aisaq_hop_trace(stamps.ctypes.data, 0),
                         "hop_trace")
            ctas = min(nq * w, TRACE_CTAS)
            t = stamps[:ctas * 16].reshape(ctas, 16).astype(np.int64)
            rel = t - t[:, :1]
            phases = {k: int(np.median(rel[:, i])) for k, i in PHASES.items()
                      if (t[:, i] > 0).all()}
            print(json.dumps({"adc": adc, "nq": nq, "w": w, "ms": ms,
                              "span_ns": int(t[:, 8].max() - t[:, 0].min()),
                              "median_ns_since_cta_start": phases}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
