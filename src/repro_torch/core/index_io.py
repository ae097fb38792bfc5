"""The on-disk index format: its writer, its metadata check and the
storage-backed `HostIndex` (port of `repro.core.index_io`).

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

`HostIndex` serves searches from the file: real ``os.preadv`` reads
through the block cache, with only centroids and entry-point codes (plus,
in diskann mode, the (N, m) code table) resident. Its search runs the
`core.traversal` engine, whose arithmetic goes to `device` (the card
unless the caller passes device="cpu"). The device tier reads the same
directories with `core.device_index.load_device_index`.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import nav as _nav
from repro_torch.core import traversal as _traversal
from repro_torch.core.block_cache import BlockCache, RetryPolicy
from repro_torch.core.chunk_layout import ChunkLayout, pack_chunks_file
from repro_torch.core.integrity import (CRC_SIDECAR, FORMAT_VERSION,
                                        PREFERRED_ALGO, CorruptIndexError,
                                        block_checksums, resolve_crc)
from repro_torch.core.traversal import SearchStats
from repro_torch.device import DeviceLike, resolve_device

#: the write-ahead journal of a dynamic index (`repro.core.wal.WAL_NAME`);
#: a non-empty one means unflushed mutations that HostIndex cannot serve
WAL_NAME = "wal.log"

#: meta.json keys a loadable index directory must carry — validated up
#: front so a truncated/corrupt dir fails with CorruptIndexError, not a
#: KeyError deep inside layout construction.
_REQUIRED_META = ("n", "dim", "data_dtype", "metric", "mode", "R",
                  "pq_m", "block_bytes", "entry_points")

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
                nav: bool = False,
                nav_fraction: float = _nav.DEFAULT_FRACTION,
                nav_degree: int = _nav.DEFAULT_DEGREE, nav_seed: int = 0,
                nav_method: str = _nav.DEFAULT_METHOD,
                extra_meta: Optional[dict] = None) -> dict:
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
    sidecar.

    ``nav=True`` additionally builds the in-memory navigation tier
    (``core.nav``, on the host in numpy): ~``nav_fraction`` of nodes
    become pivots (``nav_method`` selection, seed-stable in ``nav_seed``),
    a degree-``nav_degree`` pivot graph plus the pivots' PQ codes land in
    the optional ``nav_graph.npz`` sidecar, and ``meta["nav"]`` records
    the params. Searches then take ``entry="nav"`` for per-query entry
    vertices.
    """
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
    nav_meta = None
    if nav:
        # after the relabel block: vectors/codes are in storage order, so
        # pivot ids land directly in storage-id space
        nav_obj = _nav.build_nav(vectors, codes, fraction=nav_fraction,
                                 degree=nav_degree, seed=nav_seed,
                                 method=nav_method, metric=metric)
        _nav.save_nav(os.path.join(tmp, _nav.NAV_SIDECAR), nav_obj)
        nav_meta = nav_obj.params
    cent_hash = int(np.abs(centroids.astype(np.float64)).sum() * 1e6) \
        & 0xFFFFFFFF
    meta = dict(
        n=int(n), dim=int(d), data_dtype=data_dtype, metric=metric, mode=mode,
        R=int(graph.shape[1]), pq_m=int(codes.shape[1]),
        pq_ks=int(centroids.shape[1]), block_bytes=int(block_bytes),
        entry_points=[int(e) for e in entry_points],
        chunk_bytes=layout.chunk_bytes, io_bytes=layout.io_bytes,
        centroids_hash=cent_hash, format_version=FORMAT_VERSION,
        crc_algo=PREFERRED_ALGO,
        **({"nav": nav_meta} if nav_meta is not None else {}),
        **(extra_meta or {}))
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


class HostIndex:
    """Storage-backed index: DiskANN mode (codes resident) or AiSAQ mode
    (only centroids and entry-point codes resident)."""

    def __init__(self):
        self.meta: dict = {}
        self.layout: Optional[ChunkLayout] = None
        self.mode: str = ""
        self.device: torch.device = torch.device("cpu")
        self.centroids: Optional[np.ndarray] = None
        self._centroids_t = None       # (centroids it copies, tensor)
        self.ep_codes: Optional[np.ndarray] = None
        # diskann mode only: the (N, m) u8 code table, on `device`
        self.pq_codes: Optional[torch.Tensor] = None
        self.fd: int = -1
        self.path: str = ""
        self.load_time_s: float = 0.0
        self.cache: Optional[BlockCache] = None
        self.new_to_old: Optional[np.ndarray] = None   # relabeled indices
        self.nav = None                # optional navigation tier (core.nav)

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def load(cls, path: str, mode: Optional[str] = None,
             shared_centroids: Optional[np.ndarray] = None,
             cache_bytes: int = 10 << 20, *,
             preadv: Optional[Callable] = None,
             retry: Optional[RetryPolicy] = None,
             verify_checksums: Optional[bool] = None,
             device: DeviceLike = None) -> "HostIndex":
        """Open an index. `mode` may force diskann/aisaq residency policy.

        `shared_centroids`: paper §4.4 — when switching between indices
        built with the same PQ centroids, skip the centroid load (only the
        ~4 KiB meta.json + entry-point codes move).

        `cache_bytes`: host memory budget of the LRU block cache (0
        disables retention but keeps batched reads). Not part of
        `resident_bytes` (the paper's Table 2 counts the algorithmic
        residency); see `cache_bytes_used`.

        `preadv` swaps the raw read syscall of the block cache (fault
        injection); `retry` overrides its transient-error RetryPolicy;
        `verify_checksums` forces per-block CRC verification on
        (CorruptIndexError if the dir has no sidecar) or off — None
        verifies iff the dir carries a block_crc.npy sidecar.

        `device`: where the search's arithmetic runs — None is the card
        (raising without one), "cpu" runs the plain versions. It holds the
        centroids, the entry-point codes and, in diskann mode, the (N, m)
        code table, plus each search's per-query state.
        """
        t0 = time.perf_counter()
        self = cls()
        self.device = resolve_device(device)
        self.path = path
        self.meta = load_meta(path)
        wal_path = os.path.join(path, WAL_NAME)
        if os.path.exists(wal_path) and os.path.getsize(wal_path):
            # a non-empty write-ahead journal means unflushed (possibly
            # half-applied) mutations: the npy/meta files here do NOT
            # describe chunks.bin, and serving the dir read-only would
            # answer from an inconsistent graph
            raise CorruptIndexError(
                f"{path!r} carries a non-empty write-ahead journal "
                "(wal.log): unrecovered dynamic mutations, which only the "
                "dynamic index's loader can reconcile")
        mode = mode or self.meta["mode"]
        self.mode = mode
        self.layout = ChunkLayout(
            mode=self.meta["mode"], dim=self.meta["dim"],
            data_dtype=self.meta["data_dtype"], R=self.meta["R"],
            pq_m=self.meta["pq_m"], block_bytes=self.meta["block_bytes"])
        if shared_centroids is not None:
            self.centroids = shared_centroids
        else:
            self.centroids = np.load(os.path.join(path, "pq_centroids.npy"))
        self.centroids_t                # the device copy, made now
        self.ep_codes = np.load(os.path.join(path, "ep_codes.npy"))
        # optional navigation tier: dirs without a "nav" meta key, and dirs
        # with a damaged sidecar, load with the tier disabled (load_nav
        # warns instead of raising)
        self.nav = _nav.load_nav(path, self.meta)
        if self.meta.get("label_map") == "direct":
            # explicit per-slot labels: the map is stored directly and is
            # generally NOT a permutation of range(n), so it takes
            # precedence over any id_map inversion
            self.new_to_old = np.load(os.path.join(path, "labels.npy"))
        elif self.meta.get("relabeled"):
            # graph-locality relabeled index: storage is in new-id space;
            # results are mapped back to the original labels
            from repro_torch.core.relabel import invert_permutation
            self.new_to_old = invert_permutation(
                np.load(os.path.join(path, "id_map.npy")))
        if mode == "diskann":
            # DiskANN residency policy: ALL pq codes pinned in fast memory
            # (here: the search's device)
            self.pq_codes = torch.from_numpy(
                np.load(os.path.join(path, "pq_codes.npy"))).to(self.device)
        cbin = os.path.join(path, "chunks.bin")
        try:
            self.fd = os.open(cbin, os.O_RDONLY)
        except FileNotFoundError:
            raise CorruptIndexError(
                f"{path!r} meta.json exists but chunks.bin is missing "
                "(torn write?)") from None
        block_crc, crc_fn = self._load_crc_sidecar(path, verify_checksums)
        self.cache = BlockCache(self.fd, self.layout.io_bytes,
                                capacity_bytes=cache_bytes,
                                preadv=preadv, retry=retry,
                                block_crc=block_crc, crc=crc_fn,
                                path=cbin)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_time_s = time.perf_counter() - t0
        return self

    @property
    def centroids_t(self) -> torch.Tensor:
        """`centroids` as a float32 tensor on `device`, copied once per
        array: a pool that swaps in a shared centroid array gets the copy
        of that array at the next search."""
        held = self._centroids_t
        if held is None or held[0] is not self.centroids:
            held = (self.centroids, torch.from_numpy(np.array(
                self.centroids, np.float32)).to(self.device))
            self._centroids_t = held
        return held[1]

    def _load_crc_sidecar(self, path: str,
                          verify: Optional[bool]
                          ) -> Tuple[Optional[np.ndarray],
                                     Optional[Callable]]:
        """Resolve the per-block checksum sidecar: (crc array, crc fn) or
        (None, None) when verification is off.  verify=None enables it
        iff the sidecar exists (legacy dirs load unverified)."""
        spath = os.path.join(path, CRC_SIDECAR)
        have = os.path.exists(spath)
        if verify is None:
            verify = have
        if not verify:
            return None, None
        if not have:
            raise CorruptIndexError(
                f"{path!r}: checksum verification requested but the "
                f"{CRC_SIDECAR} sidecar is missing")
        block_crc = np.load(spath)
        fsize = os.fstat(self.fd).st_size
        io = self.layout.io_bytes
        if block_crc.size * io > fsize:
            raise CorruptIndexError(
                f"{path!r}: chunks.bin holds {fsize // io} I/O units but "
                f"{CRC_SIDECAR} describes {block_crc.size} — chunks.bin "
                "is truncated")
        return block_crc.astype(np.uint32), \
            resolve_crc(self.meta.get("crc_algo", "crc32"))

    def close(self):
        if self.cache is not None:
            self.cache.stop()        # join the prefetch thread first
            self.cache.clear()
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    def _map_out(self, ids: np.ndarray) -> np.ndarray:
        """Internal (storage) ids -> original labels (-1 padding kept)."""
        if self.new_to_old is None:
            return ids
        valid = ids >= 0
        return np.where(valid, self.new_to_old[np.where(valid, ids, 0)], -1)

    def cache_bytes_used(self) -> int:
        return 0 if self.cache is None else self.cache.used_bytes

    def resident_bytes(self, include_centroids: bool = True) -> int:
        """Memory held by the index (paper Table 2's algorithmic portion):
        entry-point codes and centroids, the (N, m) code table in diskann
        mode (on the search's device) and the navigation tier."""
        total = self.ep_codes.nbytes
        if include_centroids:
            total += self.centroids.nbytes
        if self.pq_codes is not None:
            total += self.pq_codes.numel() * self.pq_codes.element_size()
        if self.nav is not None:
            # the tier pins pivot ids/codes/graph in RAM; it scales with N
            # (fraction * n), so it IS algorithmic residency
            total += self.nav.resident_nbytes()
        return int(total)

    # -- I/O -----------------------------------------------------------------
    def _read_chunk(self, node: int, stats: SearchStats) -> np.ndarray:
        lay = self.layout
        off = lay.file_offset(node)
        # the OS reads whole blocks: model that faithfully for stats
        blk_start = off // lay.block_bytes * lay.block_bytes
        nbytes = lay.io_bytes
        raw = os.pread(self.fd, nbytes, blk_start)
        stats.ios += 1
        stats.syscalls += 1
        stats.bytes_read += nbytes
        inner = off - blk_start
        return np.frombuffer(raw, dtype=np.uint8)[inner:inner + lay.chunk_bytes]

    def _frontier_offsets(self, nodes: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """node ids -> (block-aligned file offsets, inner chunk offsets)."""
        lay = self.layout
        if lay.nodes_per_block:
            blk, slot = np.divmod(nodes, lay.nodes_per_block)
            return blk * lay.block_bytes, slot * lay.chunk_bytes
        per = lay.blocks_per_chunk * lay.block_bytes
        return nodes * per, np.zeros_like(nodes)

    # -- search (delegates to the core.traversal engine) --------------------
    def search_ref(self, q: np.ndarray, k: int, L: int, w: int = 4, *,
                   adc_dtype: str = "f32", rerank: Optional[int] = None,
                   entry: str = "auto"
                   ) -> Tuple[np.ndarray, SearchStats]:
        """Scalar DiskANN beam search (paper Algorithm 1) — the semantics
        oracle the batched path must match bit for bit (per adc_dtype, per
        entry mode).  See ``core.traversal.search_ref``."""
        ids, stats = _traversal.search_ref(self, q, k, L, w,
                                           adc_dtype=adc_dtype,
                                           rerank=rerank, entry=entry)
        return self._map_out(ids), stats

    def search_batch_ref(self, Q: np.ndarray, k: int, L: int, w: int = 4, *,
                         adc_dtype: str = "f32",
                         rerank: Optional[int] = None,
                         entry: str = "auto"):
        """Scalar reference loop over the queries."""
        ids, stats = _traversal.search_batch_ref(self, Q, k, L, w,
                                                 adc_dtype=adc_dtype,
                                                 rerank=rerank, entry=entry)
        return self._map_out(ids), stats

    def search(self, q: np.ndarray, k: int, L: int, w: int = 4, *,
               prefetch: int = 0, adc_dtype: str = "f32",
               rerank: Optional[int] = None,
               pipeline: Optional[bool] = None,
               gap: Optional[Union[int, str]] = None,
               entry: str = "auto"
               ) -> Tuple[np.ndarray, SearchStats]:
        """Batched beam search of a single query; bit-identical results to
        `search_ref`. See `search_batch` for the knobs."""
        ids, stats = self.search_batch(q[None], k, L, w, prefetch=prefetch,
                                       adc_dtype=adc_dtype, rerank=rerank,
                                       pipeline=pipeline, gap=gap,
                                       entry=entry)
        return ids[0], stats[0]

    def search_batch(self, Q: np.ndarray, k: int, L: int, w: int = 4, *,
                     prefetch: int = 0, adc_dtype: str = "f32",
                     rerank: Optional[int] = None,
                     pipeline: Optional[bool] = None,
                     gap: Optional[Union[int, str]] = None,
                     entry: str = "auto"):
        """Batched beam search over all queries at once, with optional
        two-hop pipelining (``pipeline``, default on whenever
        ``prefetch > 0``), readahead-gap control (``gap``, including
        ``"auto"``) and entry seeding (``entry="nav"|"medoid"|"auto"``).
        Full knob documentation: ``core.traversal.search_batch``.
        Returns (ids (nq, k) in ORIGINAL labels, [SearchStats])."""
        ids, stats = _traversal.search_batch(self, Q, k, L, w,
                                             prefetch=prefetch,
                                             adc_dtype=adc_dtype,
                                             rerank=rerank,
                                             pipeline=pipeline, gap=gap,
                                             entry=entry)
        return self._map_out(ids), stats
