"""The on-disk index format's writer and its metadata check (port of the
writer half of `repro.core.index_io`; the storage-backed `HostIndex` is
queued with the host search core, ROADMAP.md §1 item 6).

Directory format, byte-equal to what the reference writes from the same
inputs:

  meta.json          layout + search metadata (entry points, metric, ...)
  chunks.bin         block-aligned node chunks (chunk_layout.pack_chunks_file)
  block_crc.npy      one checksum per I/O unit of chunks.bin (integrity)
  pq_centroids.npy   (m, ks, dsub) f32 — the "PQ centroid" metadata
  pq_codes.npy       (N, m) u8 — loaded to RAM only in diskann mode
  ep_codes.npy       (n_ep, m) u8 — the ONLY per-node codes AiSAQ keeps in RAM
  id_map.npy         old->new ids, when the index is relabeled
  labels.npy         explicit external labels, when given

The device tier reads it with `core.device_index.load_device_index`.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.core.chunk_layout import ChunkLayout, pack_chunks_file
from repro_torch.core.integrity import (CRC_SIDECAR, FORMAT_VERSION,
                                        PREFERRED_ALGO, CorruptIndexError,
                                        block_checksums, resolve_crc)

#: meta.json keys a loadable index directory must carry — validated up
#: front so a truncated/corrupt dir fails with CorruptIndexError, not a
#: KeyError deep inside layout construction.
_REQUIRED_META = ("n", "dim", "data_dtype", "metric", "mode", "R",
                  "pq_m", "block_bytes", "entry_points")

_NAV_NOT_PORTED = ("nav=True: the navigation tier's build (core/nav.py) is "
                   "not ported yet; it is queued with its search half in "
                   "ROADMAP.md §1 item 6 (the host search core)")


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: str, payload: bytes):
    """Write + fsync one data file (durability half of crash-safety)."""
    with open(path, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def _save_npy(path: str, arr: np.ndarray):
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def _atomic_json(path: str, obj):
    """Crash-safe single-file JSON rewrite: tmp sibling + fsync + atomic
    rename + directory fsync — the per-file version of `write_index`'s
    whole-directory recipe. A crash leaves either the old file or the new
    one, never a truncated one the loader would reject."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _atomic_npy(path: str, arr: np.ndarray):
    """`_atomic_json`'s .npy twin."""
    tmp = path + ".tmp"
    _save_npy(tmp, arr)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _host(x) -> np.ndarray:
    """numpy array of x (a tensor on any device, or array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_index(path: str, *, vectors, graph, centroids, codes, metric: str,
                mode: str, block_bytes: int = 4096, n_ep: int = 1,
                entry_points=None, relabel: bool = False, labels=None,
                nav: bool = False, extra_meta: Optional[dict] = None
                ) -> dict:
    """Serialize one index. Returns the meta dict. The arrays may be numpy
    arrays or tensors on any device.

    ``relabel=True`` applies the graph-locality permutation at pack time
    (``core.relabel``): chunks.bin, pq_codes.npy, ep_codes.npy and the
    entry points are all written in NEW-id space; meta.json records
    ``relabeled: true`` and the old->new map lands in ``id_map.npy`` so
    loaders map results back to the ORIGINAL labels.

    ``labels`` (optional, shape (n,)) assigns each input vector an
    explicit external label instead of its positional id. The labels land,
    permuted to storage order when ``relabel`` is on, in a ``labels.npy``
    sidecar with ``meta["label_map"] = "direct"``.

    Crash-safety: every file is written into a ``path + ".tmp"`` sibling,
    fsynced, and the tmp dir is atomically renamed into place — a crash
    mid-write leaves either the old index or the new one. Integrity: one
    checksum per I/O unit of chunks.bin lands in the ``block_crc.npy``
    sidecar. ``nav=True`` (the navigation tier) is not ported yet and
    raises NotImplementedError.
    """
    if nav:
        raise NotImplementedError(_NAV_NOT_PORTED)
    vectors, graph = _host(vectors), _host(graph)
    centroids, codes = _host(centroids), _host(codes)
    path = os.path.normpath(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    n, d = vectors.shape
    data_dtype = "uint8" if vectors.dtype == np.uint8 else "float32"
    layout = ChunkLayout(mode=mode, dim=d, data_dtype=data_dtype,
                         R=graph.shape[1], pq_m=codes.shape[1],
                         block_bytes=block_bytes)
    if entry_points is None:
        mean = vectors.astype(np.float32).mean(axis=0)
        dd = ((vectors.astype(np.float32) - mean) ** 2).sum(axis=1)
        entry_points = np.argsort(dd)[:n_ep]
    entry_points = np.asarray(_host(entry_points), dtype=np.int64)[:n_ep]
    id_map = None
    if labels is not None:
        labels = np.asarray(_host(labels), dtype=np.int64)
        if labels.shape[0] != n:
            raise ValueError(
                f"labels has {labels.shape[0]} entries for {n} vectors")
    if relabel:
        from repro_torch.core.relabel import apply_permutation, \
            invert_permutation, locality_permutation
        id_map = locality_permutation(graph, layout.nodes_per_block,
                                      entry_points)
        vectors, graph, codes, entry_points = apply_permutation(
            id_map, vectors, graph, codes, entry_points)
        if labels is not None:
            # storage slot i now holds input row new_to_old[i]
            labels = labels[invert_permutation(id_map)]
    payload = pack_chunks_file(vectors, graph, codes, layout)
    _write_file(os.path.join(tmp, "chunks.bin"), payload)
    _save_npy(os.path.join(tmp, CRC_SIDECAR),
              block_checksums(payload, layout.io_bytes,
                              resolve_crc(PREFERRED_ALGO)))
    _save_npy(os.path.join(tmp, "pq_centroids.npy"),
              centroids.astype(np.float32))
    _save_npy(os.path.join(tmp, "pq_codes.npy"), codes.astype(np.uint8))
    _save_npy(os.path.join(tmp, "ep_codes.npy"),
              codes[entry_points].astype(np.uint8))
    cent_hash = int(np.abs(centroids.astype(np.float64)).sum() * 1e6) \
        & 0xFFFFFFFF
    meta = dict(
        n=int(n), dim=int(d), data_dtype=data_dtype, metric=metric, mode=mode,
        R=int(graph.shape[1]), pq_m=int(codes.shape[1]),
        pq_ks=int(centroids.shape[1]), block_bytes=int(block_bytes),
        entry_points=[int(e) for e in entry_points],
        chunk_bytes=layout.chunk_bytes, io_bytes=layout.io_bytes,
        centroids_hash=cent_hash, format_version=FORMAT_VERSION,
        crc_algo=PREFERRED_ALGO, **(extra_meta or {}))
    if id_map is not None:
        # O(N) sidecar, NOT inline json: meta.json must stay ~4 KiB so the
        # shared-centroids index switch (paper §4.4) stays near-free
        _save_npy(os.path.join(tmp, "id_map.npy"), id_map.astype(np.int64))
        meta["relabeled"] = True
    if labels is not None:
        _save_npy(os.path.join(tmp, "labels.npy"), labels)
        meta["label_map"] = "direct"
    # meta.json lands LAST: its presence marks the dir complete
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    # atomic publication: move any previous index aside, rename the tmp
    # sibling into place, then reclaim the old dir
    old = path + ".old"
    if os.path.exists(path):
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    try:
        os.rename(tmp, path)
    except OSError:
        if os.path.exists(old):          # restore the previous index
            os.rename(old, path)
        raise
    shutil.rmtree(old, ignore_errors=True)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    return meta


def load_meta(path: str) -> dict:
    """Read + validate an index dir's meta.json. Missing, truncated, or
    key-incomplete metadata raises CorruptIndexError with the failure
    spelled out — never a raw JSONDecodeError/KeyError traceback."""
    mpath = os.path.join(path, "meta.json")
    try:
        with open(mpath) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise CorruptIndexError(
            f"{path!r} is not a loadable index: meta.json is missing "
            "(incomplete write or wrong directory)") from None
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptIndexError(
            f"{path!r} has a truncated/corrupt meta.json: {e}") from None
    if not isinstance(meta, dict):
        raise CorruptIndexError(
            f"{path!r} meta.json holds {type(meta).__name__}, not an "
            "index description")
    missing = [k for k in _REQUIRED_META if k not in meta]
    if missing:
        raise CorruptIndexError(
            f"{path!r} meta.json is missing required keys {missing} "
            "(truncated write?)")
    fmt = int(meta.get("format_version", 1))
    if fmt > FORMAT_VERSION:
        raise CorruptIndexError(
            f"{path!r} has format_version {fmt}; this build understands "
            f"up to {FORMAT_VERSION} — rebuild or upgrade")
    return meta
