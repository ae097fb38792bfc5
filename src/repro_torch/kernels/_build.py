"""Build and bind the CUDA kernels (`csrc/aisaq_kernels.cu`: the search
path's; `csrc/gnn_kernels.cu`: the GNN family's segment sum).

At first use, `nvcc` compiles each source for `sm_90a` into an object, all
of them at once in parallel processes, and links them into one shared
library with a plain C interface under `kernels/build/` (listed in
.gitignore), keyed by a hash of the sources and the flags, and ctypes
loads it. Nothing
here runs at import time, so the module imports on machines without
`nvcc` or a card.

Every wrapper counts its launches in `launch_counts` (kernel name -> int),
adding one where it launches the kernel and nowhere else. Inside a CUDA
graph capture (`recorded_launches`) nothing is launched: the wrappers'
launches are recorded instead, and each replay of the graph adds them to
the counts (`count_replay`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "aisaq_kernels.cu",
           _HERE / "csrc" / "gnn_kernels.cu")
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
    "aisaq_pq_lut": [_P, _I, _I, _P, _I, _I, _I, _I, _P, _P],
    "aisaq_lut_occupancy": [_I, _I, _I, _I, _I, _P],
    "aisaq_rerank": [_P, _I, _P, _LL, _I, _I, _I, _P, _P],
    "aisaq_rerank_rows": [_P, _I, _P, _LL, _I, _P, _I, _I, _I, _I, _P, _P],
    "aisaq_rerank_occupancy": [_I, _I, _P],
    "aisaq_pq_adc": [_P, _LL, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _P, _P],
    "aisaq_adc_occupancy": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P],
    "gnn_segment_sum": [_P, _I, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _I,
                        _P, _P, _I, _P, _P, _P, _P],
    "gnn_segment_occupancy": [_I, _I, _P],
}

KERNELS = ("fused_hop_f32", "fused_hop_int8", "pq_lut", "rerank", "pq_adc",
           "pq_adc_q8", "segment_sum")
launch_counts = {name: 0 for name in KERNELS}
build_seconds = None          # wall time of the nvcc run, None if cached
_lock = threading.Lock()
_lib = None
_capture = threading.local()      # .launches: the capture's Counter, or None


def reset_launch_counts() -> None:
    with _lock:
        for name in KERNELS:
            launch_counts[name] = 0


def count_launch(name: str) -> None:
    recording = getattr(_capture, "launches", None)
    if recording is not None:
        recording[name] += 1
        return
    with _lock:
        launch_counts[name] += 1


@contextmanager
def recorded_launches():
    """Within the block (a CUDA graph capture on this thread) the wrappers'
    launches go into the Counter it yields, not into `launch_counts`: a
    capture launches nothing, and each replay counts them (`count_replay`).
    """
    if getattr(_capture, "launches", None) is not None:
        raise RuntimeError("launches are already being recorded on this "
                           "thread")
    _capture.launches = Counter()
    try:
        yield _capture.launches
    finally:
        _capture.launches = None


def count_replay(launches: dict) -> None:
    """One replay of a graph whose capture recorded `launches`."""
    with _lock:
        for name, n in launches.items():
            launch_counts[name] += n


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
    """Compile the sources unless a library for this hash exists: one nvcc
    a source, started together, then one link."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *compile_flags, "-c", "-o", str(o),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, o in zip(SOURCES, objs)]
    errors = []
    for src, p in zip(SOURCES, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src.name} ({p.returncode}):\n{err}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
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
