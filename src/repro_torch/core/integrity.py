"""On-disk integrity: per-block checksums + typed corruption errors (copy
of `repro.core.integrity`, so that both packages write and check the same
`format_version`, `crc_algo` and `block_crc.npy` sidecar).

The all-in-storage regime makes every search hop a storage read, so media
errors and torn writes are *correctness* hazards, not just latency ones.
Pure helpers with no other imports of the package:

  * ``block_checksums`` computes one 32-bit checksum per I/O unit of a
    packed chunks file; the writer stores them in a ``block_crc.npy``
    sidecar next to ``chunks.bin``, against which a storage reader
    verifies every block it reads,
  * ``resolve_crc`` picks the checksum implementation by name: CRC32C
    (Castagnoli) via the optional ``crc32c`` package when the environment
    has it, else zlib's C-speed CRC32 — both record their name in
    meta.json so a dir written on one machine verifies on another,
  * ``CorruptIndexError`` — a load-time rejection (missing/truncated
    meta.json, sidecar/file size mismatch, unknown format version),
  * ``CorruptBlockError`` — a read-time verification failure that
    SURVIVED the one-reread policy.  It subclasses OSError with errno
    EIO so the serving tier's health tracking classifies it as an I/O
    failure without special-casing.
"""
from __future__ import annotations

import errno
import zlib
from typing import Callable

import numpy as np

#: bump when the on-disk directory layout changes.  Version history:
#:   1 — (implicit; meta.json had no format_version key) the original
#:       chunks.bin + npy sidecars layout
#:   2 — adds the block_crc.npy checksum sidecar, ``format_version`` and
#:       ``crc_algo`` meta keys.  v1 dirs still load, with verification
#:       off (there is nothing to verify against).
#:   3 — adds the OPTIONAL nav_graph.npz navigation-tier sidecar and the
#:       ``nav`` meta key (pivot-selection params).  v1/v2 dirs still
#:       load, with the nav tier disabled; a v3 dir whose sidecar is
#:       damaged also loads nav-disabled (with a warning) — only core
#:       index damage raises CorruptIndexError.
FORMAT_VERSION = 3

#: sidecar filename: one uint32 checksum per ``io_bytes`` unit of
#: chunks.bin, in file order.
CRC_SIDECAR = "block_crc.npy"

try:                                    # optional accelerated Castagnoli
    import crc32c as _crc32c_mod        # noqa: F401
    _HAVE_CRC32C = True
except ImportError:                     # pragma: no cover - env dependent
    _HAVE_CRC32C = False


class CorruptIndexError(RuntimeError):
    """An index directory failed load-time validation (missing or
    truncated meta.json, checksum sidecar inconsistent with chunks.bin,
    or a format_version newer than this code understands)."""


class CorruptBlockError(OSError):
    """A block's checksum mismatched on read AND on the policy reread —
    the bytes on storage are wrong, not merely a transient transfer
    error.  errno is EIO so generic I/O-failure handling applies."""

    def __init__(self, offset: int, expected: int, actual: int,
                 path: str = ""):
        super().__init__(
            errno.EIO,
            f"persistent checksum mismatch at block offset {offset}"
            f"{' of ' + path if path else ''}: "
            f"expected {expected:#010x}, read {actual:#010x}")
        self.offset = offset
        self.expected = expected
        self.actual = actual
        self.path = path


def _crc32(data) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _crc32c(data) -> int:               # pragma: no cover - env dependent
    return _crc32c_mod.crc32c(bytes(data)) & 0xFFFFFFFF


#: algorithm recorded in meta.json by write_index on THIS machine.
PREFERRED_ALGO = "crc32c" if _HAVE_CRC32C else "crc32"


def resolve_crc(name: str) -> Callable[[bytes], int]:
    """Checksum function for the algo name recorded in meta.json."""
    if name == "crc32":
        return _crc32
    if name == "crc32c":
        if not _HAVE_CRC32C:            # pragma: no cover - env dependent
            raise CorruptIndexError(
                "index was written with crc32c checksums but the crc32c "
                "package is unavailable; reload with verification off or "
                "rebuild the index")
        return _crc32c
    raise CorruptIndexError(f"unknown checksum algorithm {name!r}")


def block_checksums(payload, io_bytes: int,
                    crc: Callable[[bytes], int] = _crc32) -> np.ndarray:
    """One checksum per ``io_bytes`` unit of `payload` (whose length must
    be a whole multiple — pack_chunks_file guarantees it)."""
    buf = np.frombuffer(memoryview(payload), dtype=np.uint8)
    if buf.size % io_bytes:
        raise ValueError(
            f"payload of {buf.size} bytes is not a multiple of the "
            f"{io_bytes}-byte I/O unit")
    n = buf.size // io_bytes
    out = np.empty(n, np.uint32)
    for i in range(n):
        out[i] = crc(buf[i * io_bytes:(i + 1) * io_bytes])
    return out
