"""Binary frame layer (framing version 1) for the persistent-socket
transport.

The codec (``repro_torch.serve.codec``) already makes every payload a
self-contained, CRC32-stamped binary message; HTTP added nothing but
text framing, header parsing, and a thread handoff per request.  This
module replaces that framing with a fixed 24-byte header:

    offset  size  field
    0       4     magic ``b"RPB1"`` (framing version is baked into the
                  magic — ``RPB2`` would be a new, incompatible framing)
    4       1     op (u8, ``OP_*``)
    5       1     flags (u8; reply-only ``FLAG_ERROR``)
    6       2     reserved (u16, must be 0)
    8       4     payload length (LE u32, bounded by
                  ``MAX_FRAME_BYTES``)
    12      8     request id (LE u64, client-chosen, echoed verbatim in
                  the reply)
    20      4     deadline budget (LE f32 relative seconds; 0 = none —
                  same no-clock-sync semantics as the HTTP
                  ``X-Repro-Deadline-S`` header)
    24      ...   payload: one ``repro_torch.serve.codec`` message

Request ids exist for **pipelining**: a client may write many frames
down one socket before reading anything back, and replies may return in
any order (the server's coalescer completes fused batches as they
finish) — each reply carries the id of the request it answers.  Ids
must be unique among a connection's in-flight requests; the server
closes the connection on a duplicate rather than risk handing one
reply to two callers.

Strictness is the point of the fixed header: bad magic, a nonzero
reserved field, an unknown op, an unknown flag bit, or a length beyond
``MAX_FRAME_BYTES`` all raise ``WireFormatError`` from the parser —
after which the stream offset can no longer be trusted, so both sides
close the connection instead of resynchronizing heuristically.  A
*truncated* frame is not an error (more bytes may arrive); the reader's
timeout bounds how long anyone waits for the remainder.

``FrameParser`` is the shared incremental reader (server event loop and
client demultiplexer both feed received bytes in and iterate complete
frames out); ``pack_frame`` is the shared writer.  Everything here is
transport-agnostic byte shuffling — no sockets, no threads.
"""
from __future__ import annotations

import math
import struct
from typing import Iterator, NamedTuple

from .codec import WireFormatError

__all__ = ["BIN_MAGIC", "FLAG_ERROR", "Frame", "FrameParser", "HEADER",
           "MAX_FRAME_BYTES", "OP_CACHE_STATS", "OP_HEALTH", "OP_METRICS",
           "OP_NAMES", "OP_SWEEP", "pack_frame"]

BIN_MAGIC = b"RPB1"

#: one frame's payload may not exceed this (mirrors the HTTP front end's
#: ``MAX_BODY_BYTES``: a 2^31-row table is a streamed lattice plan, not
#: an upload)
MAX_FRAME_BYTES = 1 << 30

HEADER = struct.Struct("<4sBBHIQf")

OP_HEALTH = 1        #: empty payload -> MSG_JSON health document
OP_CACHE_STATS = 2   #: empty payload -> MSG_JSON stats document
OP_SWEEP = 3         #: MSG_REQUEST payload -> MSG_WINNERS / MSG_TOTALS
OP_METRICS = 4       #: empty payload -> MSG_JSON Prometheus text snapshot

OP_NAMES = {OP_HEALTH: "health", OP_CACHE_STATS: "cache_stats",
            OP_SWEEP: "sweep", OP_METRICS: "metrics"}

#: reply flag: the payload is a ``MSG_ERROR`` codec message
FLAG_ERROR = 0x01

_KNOWN_FLAGS = FLAG_ERROR


class Frame(NamedTuple):
    op: int
    flags: int
    req_id: int
    deadline_s: float
    payload: bytes


def pack_frame(op: int, req_id: int, payload: bytes, *, flags: int = 0,
               deadline_s: float = 0.0) -> bytes:
    """One header + payload byte string (a single ``sendall`` per frame —
    with ``TCP_NODELAY`` that is one segment burst, no Nagle/delayed-ACK
    stall like the HTTP front end's split header/body writes)."""
    if op not in OP_NAMES:
        raise ValueError(f"unknown op {op}; valid: {sorted(OP_NAMES)}")
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"payload of {len(payload)} bytes exceeds "
                         f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES})")
    if not 0 <= int(req_id) < 1 << 64:
        raise ValueError(f"request id {req_id} outside u64 range")
    return HEADER.pack(BIN_MAGIC, op, flags, 0, len(payload),
                       int(req_id), float(deadline_s)) + payload


class FrameParser:
    """Incremental frame reader: ``feed()`` received bytes, iterate
    ``frames()``.  Malformed headers raise ``WireFormatError`` and poison
    the parser (the stream offset is untrustworthy after a framing error
    — the owner must close the connection)."""

    __slots__ = ("_buf", "_dead", "max_frame_bytes")

    def __init__(self, max_frame_bytes: int = MAX_FRAME_BYTES):
        self._buf = bytearray()
        self._dead = False
        self.max_frame_bytes = int(max_frame_bytes)

    def __len__(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> None:
        if self._dead:
            raise WireFormatError(
                "frame stream already failed — close the connection")
        self._buf += data

    def frames(self) -> Iterator[Frame]:
        """Yield every complete frame buffered so far; stop (without
        error) at a partial frame."""
        while True:
            frame = self._next()
            if frame is None:
                return
            yield frame

    def _next(self):
        buf = self._buf
        if self._dead:
            raise WireFormatError(
                "frame stream already failed — close the connection")
        if len(buf) < HEADER.size:
            return None
        magic, op, flags, reserved, length, req_id, deadline_s = \
            HEADER.unpack_from(buf)
        try:
            if magic != BIN_MAGIC:
                raise WireFormatError(
                    f"bad frame magic {bytes(magic)!r} (expected "
                    f"{BIN_MAGIC!r}) — stream desynchronized")
            if reserved != 0:
                raise WireFormatError(
                    f"nonzero reserved header field {reserved:#06x}")
            if op not in OP_NAMES:
                raise WireFormatError(f"unknown frame op {op}")
            if flags & ~_KNOWN_FLAGS:
                raise WireFormatError(
                    f"unknown frame flag bits {flags:#04x}")
            if length > self.max_frame_bytes:
                raise WireFormatError(
                    f"frame payload of {length} bytes exceeds "
                    f"{self.max_frame_bytes}")
            if math.isnan(deadline_s) or math.isinf(deadline_s) \
                    or deadline_s < 0.0:
                raise WireFormatError(
                    f"invalid frame deadline {deadline_s!r}: want a "
                    f"non-negative relative seconds budget")
        except WireFormatError:
            self._dead = True
            raise
        end = HEADER.size + length
        if len(buf) < end:
            return None
        payload = bytes(buf[HEADER.size:end])
        del buf[:end]
        return Frame(op, flags, req_id, float(deadline_s), payload)
