"""Write-ahead journal for dynamic index mutation (copy of
`repro.core.wal`; the frame format is the reference's byte for byte, so
a journal written by either package is read by the other).

``DynamicHostIndex.insert`` appends a node chunk and patches up to R
reverse-edge chunks with in-place ``pwrite``s — a crash anywhere in that
sequence used to leave neighbors pointing at a node whose PQ code only
ever lived in RAM, a silently corrupt graph the CRC layer happily
verifies.  The journal closes that hole with the classic WAL discipline:

  * before ANY byte of ``chunks.bin`` changes, an ``INSERT_BEGIN`` frame
    records the intent — new id + label, the PQ code, the chosen
    neighbors, the file size, and the PRE-IMAGES of every reverse-edge
    chunk the insert will patch — and is fsynced,
  * after the chunk writes land (and ``chunks.bin`` is fdatasynced), an
    ``INSERT_COMMIT`` frame marks the insert durable,
  * deletes journal a ``DELETE`` frame before the tombstone enters RAM,
  * a successful ``flush()`` persists everything to the main files and
    truncates the journal to empty (the checkpoint).

Recovery (``DynamicHostIndex.load``) scans the journal, truncates it at
the first torn frame, rolls the uncommitted tail insert BACK from its
pre-images (restoring the file size), rolls committed-but-unflushed
inserts FORWARD (re-deriving ``meta["n"]``, pending codes, labels),
re-applies journaled deletes, and re-anchors the CRC sidecar — every
crash point lands on a bit-consistent index equal to a pre- or
post-insert oracle state.

Frame format (all little-endian)::

  magic   u32   0x314C4157 ("WAL1")
  type    u8    record type
  hlen    u32   JSON header length
  blen    u32   binary blob length
  header  bytes (JSON, UTF-8)
  blob    bytes (pre-images / codes, raw)
  crc     u32   CRC32 over type|hlen|blen|header|blob

A frame whose magic, bounds, or CRC fails validation ends the scan —
everything after it is a torn tail and is truncated.  Frames are
self-delimiting, so the journal needs no index and no compaction beyond
the flush-time truncate.

Crash injection: pass a ``core.faults.KillSwitch`` and every append
ticks before the frame, mid-frame (the torn-write state), and after —
the kill-at-every-offset drill enumerates exactly these points.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import List, Optional, Tuple

# record types
T_INSERT_BEGIN = 1
T_INSERT_COMMIT = 2
T_DELETE = 3

_MAGIC = 0x314C4157                       # "WAL1"
_HDR = struct.Struct("<IBII")             # magic, type, hlen, blen
_CRC = struct.Struct("<I")

WAL_NAME = "wal.log"


class WalRecord:
    __slots__ = ("rtype", "header", "blob", "offset")

    def __init__(self, rtype: int, header: dict, blob: bytes, offset: int):
        self.rtype = rtype
        self.header = header
        self.blob = blob
        self.offset = offset


def _frame(rtype: int, header: dict, blob: bytes) -> bytes:
    hj = json.dumps(header, separators=(",", ":")).encode()
    body = _HDR.pack(_MAGIC, rtype, len(hj), len(blob)) + hj + blob
    crc = zlib.crc32(body[4:]) & 0xFFFFFFFF   # over type|lens|header|blob
    return body + _CRC.pack(crc)


class WriteAheadLog:
    """CRC-framed, fsync'd journal over one file.  Single-writer: the
    owning ``DynamicHostIndex`` serializes appends; ``scan`` is safe on
    any byte prefix of a valid journal (that is the recovery contract).

    ``sync=False`` skips the per-append fdatasync (the ingest-throughput
    knob): a crash may then lose the *latest* journaled-but-unsynced
    mutations, but recovery still lands on a consistent earlier state —
    durability weakens, consistency does not."""

    def __init__(self, path: str, *, kill=None, sync: bool = True):
        self.path = path
        self.kill = kill          # Optional[core.faults.KillSwitch]
        self.sync = sync
        self.fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        self.appended = 0

    # -- crash injection -----------------------------------------------------
    def _tick(self, label: str):
        if self.kill is not None:
            self.kill.tick(label)

    # -- append --------------------------------------------------------------
    def append(self, rtype: int, header: dict, blob: bytes = b"") -> int:
        """Append one frame at the end; returns its start offset.  With a
        KillSwitch attached the frame is written in two halves with a
        tick between them, so the enumeration drill visits the torn-frame
        state of every record."""
        frame = _frame(rtype, header, blob)
        off = os.lseek(self.fd, 0, os.SEEK_END)
        self._tick(f"wal.pre.{rtype}")
        if self.kill is not None:
            half = len(frame) // 2
            os.pwrite(self.fd, frame[:half], off)
            self._tick(f"wal.mid.{rtype}")
            os.pwrite(self.fd, frame[half:], off + half)
        else:
            os.pwrite(self.fd, frame, off)
        self._tick(f"wal.post.{rtype}")
        if self.sync:
            os.fdatasync(self.fd)
        self.appended += 1
        return off

    def fsync(self):
        os.fdatasync(self.fd)

    # -- scan / recovery -----------------------------------------------------
    def scan(self) -> Tuple[List[WalRecord], int, bool]:
        """Parse the journal from byte 0.  Returns (records, valid_end,
        torn): ``valid_end`` is the offset just past the last whole valid
        frame; ``torn`` is True when trailing bytes past it exist (a
        partially written frame, or garbage)."""
        size = os.fstat(self.fd).st_size
        buf = os.pread(self.fd, size, 0)
        records: List[WalRecord] = []
        pos = 0
        while pos + _HDR.size + _CRC.size <= len(buf):
            magic, rtype, hlen, blen = _HDR.unpack_from(buf, pos)
            if magic != _MAGIC:
                break
            end = pos + _HDR.size + hlen + blen + _CRC.size
            if hlen > len(buf) or blen > len(buf) or end > len(buf):
                break                       # torn tail frame
            body = buf[pos + 4:end - _CRC.size]
            (crc,) = _CRC.unpack_from(buf, end - _CRC.size)
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                break                       # bit-rot or torn write
            try:
                header = json.loads(
                    buf[pos + _HDR.size:pos + _HDR.size + hlen])
            except ValueError:
                break
            blob = buf[pos + _HDR.size + hlen:end - _CRC.size]
            records.append(WalRecord(rtype, header, blob, pos))
            pos = end
        return records, pos, pos != len(buf)

    def truncate(self, size: int = 0):
        """Cut the journal at ``size`` (0 = the flush-time checkpoint)
        and make the cut durable."""
        os.ftruncate(self.fd, size)
        os.fdatasync(self.fd)

    @property
    def size(self) -> int:
        return os.fstat(self.fd).st_size

    def close(self):
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1
