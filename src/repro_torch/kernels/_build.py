"""Build and bind the CUDA kernels (`csrc/aisaq_kernels.cu`).

At first use, `nvcc` compiles the source for `sm_90a` into a shared library
with a plain C interface under `kernels/build/` (listed in .gitignore),
keyed by a hash of the source and the flags, and ctypes loads it. Nothing
here runs at import time, so the module imports on machines without
`nvcc` or a card.

Every wrapper counts its launches in `launch_counts` (kernel name -> int),
adding one where it launches the kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "aisaq_kernels.cu",)
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# argtypes of each extern "C" launcher; all return a cudaError_t as int
_SIGNATURES = {
    "aisaq_fused_hop": [_P, _LL, _I, _P, _I, _I, _P, _I, _I, _I, _I, _P, _I,
                        _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "aisaq_hop_occupancy": [_I, _I, _I, _P],
    "aisaq_pq_lut": [_P, _I, _P, _I, _I, _I, _I, _P, _P],
    "aisaq_rerank": [_P, _I, _P, _LL, _I, _I, _I, _P, _P],
    "aisaq_pq_adc": [_P, _LL, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _P, _P],
    "aisaq_adc_occupancy": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P],
}

KERNELS = ("fused_hop_f32", "fused_hop_int8", "pq_lut", "rerank", "pq_adc",
           "pq_adc_q8")
launch_counts = {name: 0 for name in KERNELS}
build_seconds = None          # wall time of the nvcc run, None if cached
_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    with _lock:
        for name in KERNELS:
            launch_counts[name] = 0


def count_launch(name: str) -> None:
    with _lock:
        launch_counts[name] += 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return path


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"aisaq_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for this hash exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The bound kernel library, built at first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    tensor lies on the CPU; anything else raises (no silent copies)."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors must all be on one CUDA device or all on "
                     f"the CPU, got {sorted(str(t.device) for t in tensors)}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Check a kernel argument's dtype, shape and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
