"""Length-prefixed, CRC-framed request protocol over Unix sockets (copy
of `repro.serving.protocol`: the frames are the reference's byte for
byte).

The multi-process serving tier (``serving.cluster`` workers +
``serving.router``) speaks this wire format.  It deliberately reuses the
write-ahead journal's framing discipline (``core.wal``): a fixed header
with magic + lengths, a JSON header, a raw binary blob, and a CRC32
trailer over everything but the magic.  The failure contract mirrors the
journal's too:

  * a frame whose magic, bounds, or CRC fails validation raises the
    typed ``ProtocolError`` — the receiver treats the CONNECTION as
    poisoned (a stream protocol cannot resynchronize past a corrupt
    length field) and drops it; the router counts a failed shard attempt
    and retries or degrades, it never consumes garbage,
  * a clean EOF between frames raises ``ConnectionClosed`` (the peer
    went away — for a worker socket that usually means SIGKILL),
  * an EOF or timeout *mid-frame* is a torn frame: also
    ``ConnectionClosed`` — the caller cannot tell a crash from a torn
    write, and must not need to,
  * a declared payload larger than ``MAX_FRAME_BYTES`` is rejected
    before any allocation happens (a flipped length bit must not turn
    into a multi-GB allocation).

Every socket operation the helpers issue honors the socket's configured
timeout — the never-hang half of the router's degradation contract.

Query/result payloads ride as raw little-endian arrays in the blob with
dtype/shape in the JSON header (``encode_query``/``decode_query``,
``encode_result``/``decode_result``) so no pickle ever crosses a
process boundary.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "ProtocolError", "ConnectionClosed",
    "T_SEARCH", "T_RESULT", "T_ERROR", "T_PING", "T_PONG",
    "T_STATS", "T_STATS_REPLY", "T_SHUTDOWN",
    "pack_frame", "send_frame", "recv_frame",
    "encode_query", "decode_query", "encode_result", "decode_result",
    "trace_context",
]

# frame types
T_SEARCH = 1        # router -> worker: one query
T_RESULT = 2        # worker -> router: ids + dists
T_ERROR = 3         # worker -> router: typed failure for one request
T_PING = 4          # supervisor/router -> worker: heartbeat probe
T_PONG = 5          # worker -> prober
T_STATS = 6         # -> worker: telemetry snapshot request
T_STATS_REPLY = 7
T_SHUTDOWN = 8      # -> worker: graceful drain + exit

_MAGIC = 0x31515341                     # "ASQ1"
_HDR = struct.Struct("<IBII")           # magic, type, hlen, blen
_CRC = struct.Struct("<I")

#: upper bound on header+blob of one frame — a corrupt length field must
#: fail loudly, not allocate gigabytes
MAX_FRAME_BYTES = 64 << 20


class ProtocolError(RuntimeError):
    """Corrupt or malformed frame — the connection is unrecoverable."""


class ConnectionClosed(ProtocolError):
    """Peer closed the connection (cleanly between frames or mid-frame —
    the reader cannot distinguish a crash from a torn write)."""


def pack_frame(rtype: int, header: dict, blob: bytes = b"") -> bytes:
    hj = json.dumps(header, separators=(",", ":")).encode()
    body = _HDR.pack(_MAGIC, rtype, len(hj), len(blob)) + hj + blob
    crc = zlib.crc32(body[4:]) & 0xFFFFFFFF    # over type|lens|header|blob
    return body + _CRC.pack(crc)


def send_frame(sock, rtype: int, header: dict, blob: bytes = b""):
    """One sendall — the frame is small enough to serialize in memory and
    a partial send on a blocking socket surfaces as the socket error the
    caller already handles."""
    sock.sendall(pack_frame(rtype, header, blob))


def _recv_exact(sock, n: int) -> bytes:
    """Read exactly n bytes; ConnectionClosed on EOF (clean or torn)."""
    chunks = []
    got = 0
    while got < n:
        b = sock.recv(min(n - got, 1 << 20))
        if not b:
            raise ConnectionClosed(
                f"peer closed with {n - got} of {n} bytes outstanding")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def recv_frame(sock) -> Tuple[int, dict, bytes]:
    """Read one whole frame.  Raises ConnectionClosed on EOF,
    ProtocolError on a corrupt frame, socket.timeout/OSError pass
    through from the socket layer."""
    head = _recv_exact(sock, _HDR.size)
    magic, rtype, hlen, blen = _HDR.unpack(head)
    if magic != _MAGIC:
        raise ProtocolError(f"bad frame magic 0x{magic:08x}")
    if hlen + blen > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame declares {hlen + blen} payload bytes "
            f"(> {MAX_FRAME_BYTES}); corrupt length field")
    payload = _recv_exact(sock, hlen + blen + _CRC.size)
    body = head[4:] + payload[:hlen + blen]
    (crc,) = _CRC.unpack_from(payload, hlen + blen)
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ProtocolError("frame CRC mismatch (corrupt stream)")
    try:
        header = json.loads(payload[:hlen])
    except ValueError as e:
        raise ProtocolError(f"frame header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise ProtocolError("frame header is not an object")
    return rtype, header, payload[hlen:hlen + blen]


# -- payload codecs ----------------------------------------------------------


def encode_query(q: np.ndarray, *, corpus: str, k: int, req_id: int,
                 deadline_s: Optional[float],
                 trace: Optional[dict] = None) -> Tuple[dict, bytes]:
    """`trace` is an optional {tid, sid} span context (obs.trace): it
    rides the JSON header, so old receivers ignore it and old senders
    simply never trace — the frame format itself is unchanged."""
    q = np.ascontiguousarray(q, dtype=np.float32)
    header = dict(req_id=req_id, corpus=corpus, k=int(k),
                  dim=int(q.shape[-1]),
                  deadline_s=(None if deadline_s is None
                              else float(deadline_s)))
    if trace is not None:
        header["trace"] = dict(tid=str(trace["tid"]),
                               sid=str(trace["sid"]))
    return header, q.tobytes()


def trace_context(header: dict) -> Optional[dict]:
    """The span context a query frame carries, or None.  Malformed
    contexts (wrong shape, non-string ids) are treated as absent — a
    corrupted optional field must degrade to an untraced query, never
    fail it."""
    ctx = header.get("trace")
    if not isinstance(ctx, dict):
        return None
    tid, sid = ctx.get("tid"), ctx.get("sid")
    if not (isinstance(tid, str) and isinstance(sid, str) and tid and sid):
        return None
    return dict(tid=tid, sid=sid)


def decode_query(header: dict, blob: bytes) -> np.ndarray:
    dim = int(header["dim"])
    q = np.frombuffer(blob, dtype=np.float32)
    if q.size != dim:
        raise ProtocolError(
            f"query blob holds {q.size} floats, header says {dim}")
    return q


def encode_result(ids: np.ndarray, dists: np.ndarray, *, req_id: int,
                  spans: Optional[list] = None) -> Tuple[dict, bytes]:
    """`spans` is the worker's finished span list for this request's
    trace (obs.trace dicts) — it rides the JSON header back to the
    router, which ingests it into the query's trace."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    header = dict(req_id=req_id, k=int(ids.shape[-1]))
    if spans:
        header["spans"] = list(spans)
    return header, ids.tobytes() + dists.tobytes()


def decode_result(header: dict, blob: bytes
                  ) -> Tuple[np.ndarray, np.ndarray]:
    k = int(header["k"])
    need = k * (8 + 4)
    if len(blob) != need:
        raise ProtocolError(
            f"result blob holds {len(blob)} bytes, header implies {need}")
    ids = np.frombuffer(blob[:k * 8], dtype=np.int64)
    dists = np.frombuffer(blob[k * 8:], dtype=np.float32)
    return ids, dists
