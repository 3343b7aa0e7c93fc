"""Framed columnar transport encoding for the cross-process data plane (a
copy of the JAX package's ``columnar/frames.py``).

The reference moves shuffle partitions between executors over UCX with
cuDF's serialized column format (buffer table + metadata header); this
module is the host-side analog the peer-to-peer shuffle (serve/shuffle.py)
speaks over sockets, pipes, or the same-host spool fast path: one
**frame** per message, length-prefixed and CRC32-protected, carrying a
control tuple plus zero or more raw column buffers with their offset
table and dtype/row-count signature.

Frame layout (little-endian)::

    MAGIC(4) | frame_len u32 | crc32 u32 | payload[frame_len]
    payload = header_len u32 | header_json | buf0 bytes | buf1 bytes | ...

``header_json`` = ``{"m": [tag, ...], "b": [[dtype, rows], ...]}`` — the
``m`` list is the control tuple (first element one of the ``FR_*`` tags
below), the ``b`` list the buffer signature, in payload order.  The CRC
covers the whole payload, so a flipped bit in EITHER the control tuple or
a column buffer fails verification; a frame cut short fails the length
check first.  Both failure modes raise :class:`FrameError` with a
machine-readable ``reason`` the transport's retry path keys on.

Like ``serve/rpc.py``'s pipe tuples, the control messages have ONE
declared schema (:data:`MESSAGE_FIELDS`) checked on both sides by the
analyze gate's wire-protocol pass — construct sites build tuples led by
an ``FR_*`` tag, destructure sites unpack under an ``if tag == FR_X``
guard.  A one-sided field drift between the fetch client and the serving
loop is a merge-time finding, not a 3 a.m. incident.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "MAGIC", "PREFIX", "FrameError",
    "FR_FETCH", "FR_DATA", "FR_NACK", "FR_RESULT", "MESSAGE_FIELDS",
    "encode_frame", "decode_frame", "frame_meta",
    "encode_table", "decode_table", "table_nbytes", "table_signature",
    "corrupt_frame", "truncate_frame",
]

MAGIC = b"SRTF"
#: the one definition of the frame prefix layout (magic, frame_len,
#: crc32) — socket readers (serve/shuffle.py) size their prefix reads
#: off this struct, so a format change cannot leave a stale mirror
PREFIX = struct.Struct("<4sII")
_U32 = struct.Struct("<I")

# peer-to-peer shuffle control tags (the socket wire protocol between two
# executors' ShuffleServices, serve/shuffle.py).  Declared exactly like
# serve/rpc.MESSAGE_FIELDS: tag -> field names after the tag, enforced on
# both sides by ci/analyze's wire-protocol pass.
FR_FETCH = "fetch"   # consumer -> producer: send me one partition
FR_DATA = "data"     # producer -> consumer: the partition (buffers ride
#                      the same frame; columns/rows describe them)
FR_NACK = "nack"     # producer -> consumer: can't serve it (reason:
#                      "not_ready" = keep backing off, "gone" = cleaned
#                      up or wrong incarnation — wait for a map update)
FR_RESULT = "rcached"  # result-cache disk tier (plans/rcache.py, round
#                      15): one cached query result at rest — the same
#                      CRC-over-payload framing the shuffle transport
#                      trusts, so a flipped bit in a cold cache file is
#                      a detected drop-and-recompute, never a wrong
#                      answer.  kind = table|array|blob; names lists the
#                      table's columns in buffer order (empty otherwise),
#                      shapes the original array shapes (buffers ride the
#                      frame flattened — frame buffers are 1-D), and key
#                      the FULL cache key's repr: the 32-bit token also
#                      names the file, so colliding tokens share a path
#                      and only the full key proves whose result this is
MESSAGE_FIELDS = {
    FR_FETCH: ("sid", "map_index", "part", "consumer"),
    FR_DATA: ("sid", "map_index", "part", "columns", "rows"),
    FR_NACK: ("sid", "map_index", "part", "reason"),
    FR_RESULT: ("token", "kind", "names", "shapes", "key"),
}


class FrameError(Exception):
    """A frame failed decoding; ``reason`` is one of ``"magic"``,
    ``"truncated"``, ``"crc"``, ``"header"`` — the transport retry path
    records it and re-fetches."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


def encode_frame(meta: Sequence, buffers: Sequence[np.ndarray] = ()) -> bytes:
    """One framed message: control tuple ``meta`` (first element an
    ``FR_*`` tag) plus raw 1-D buffers, CRC32 over the whole payload."""
    bufs = [np.ascontiguousarray(b) for b in buffers]
    header = json.dumps(
        {"m": list(meta), "b": [[str(b.dtype), int(b.shape[0])]
                                for b in bufs]},
        separators=(",", ":")).encode()
    parts = [_U32.pack(len(header)), header]
    parts.extend(b.tobytes() for b in bufs)
    payload = b"".join(parts)
    return PREFIX.pack(MAGIC, len(payload),
                       zlib.crc32(payload) & 0xFFFFFFFF) + payload


def decode_frame(data: bytes) -> Tuple[tuple, List[np.ndarray]]:
    """Inverse of :func:`encode_frame`; raises :class:`FrameError` on any
    damage (bad magic, short read, CRC mismatch, malformed header)."""
    if len(data) < PREFIX.size:
        raise FrameError("frame shorter than its prefix", "truncated")
    magic, frame_len, crc = PREFIX.unpack_from(data)
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic!r}", "magic")
    payload = data[PREFIX.size:]
    if len(payload) != frame_len:
        raise FrameError(
            f"frame payload {len(payload)}B, prefix says {frame_len}B",
            "truncated")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise FrameError("frame CRC32 mismatch", "crc")
    try:
        (hlen,) = _U32.unpack_from(payload)
        header = json.loads(payload[_U32.size:_U32.size + hlen])
        meta = tuple(header["m"])
        sigs = header["b"]
    except (struct.error, ValueError, KeyError, TypeError) as e:
        raise FrameError(f"malformed frame header: {e}", "header") from e
    bufs: List[np.ndarray] = []
    off = _U32.size + hlen
    for dtype, rows in sigs:
        dt = np.dtype(dtype)
        nbytes = dt.itemsize * int(rows)
        raw = payload[off:off + nbytes]
        if len(raw) != nbytes:
            raise FrameError(
                f"buffer {dtype}[{rows}] truncated ({len(raw)}B of "
                f"{nbytes}B)", "truncated")
        # .copy(): the frame bytes object is transient transport memory;
        # decoded columns must own their storage
        bufs.append(np.frombuffer(raw, dtype=dt).copy())
        off += nbytes
    return meta, bufs


def frame_meta(data: bytes) -> tuple:
    """Just the control tuple (still CRC-verified — a cheap peek is not
    worth trusting damaged bytes)."""
    return decode_frame(data)[0]


# ----------------------------------------------------------------- tables
# A partition crosses the wire as ONE frame: FR_DATA meta names the
# columns in buffer order, every buffer the same row count — the
# dtype/row-count signature in the header is the geometry the receiver
# validates before concatenating partitions.


def encode_table(meta: Sequence,
                 columns: Dict[str, np.ndarray]) -> bytes:
    """Frame a named column table: ``meta`` must be an ``FR_DATA``-shaped
    tuple whose ``columns`` field lists the names in iteration order and
    whose ``rows`` field is the shared row count."""
    names = sorted(columns)
    rows = {int(columns[n].shape[0]) for n in names}
    if len(rows) > 1:
        raise ValueError(f"ragged partition table: row counts {rows}")
    return encode_frame(meta, [columns[n] for n in names])


def decode_table(meta: tuple, bufs: List[np.ndarray]) -> Dict[str, np.ndarray]:
    """Rebuild the named columns of a decoded FR_DATA frame."""
    names = list(meta[4])
    if len(names) != len(bufs):
        raise FrameError(
            f"FR_DATA names {len(names)} columns, frame carries "
            f"{len(bufs)} buffers", "header")
    return dict(zip(names, bufs))


def table_nbytes(columns: Dict[str, np.ndarray]) -> int:
    return sum(int(v.nbytes) for v in columns.values())


def table_signature(columns: Dict[str, np.ndarray]) -> tuple:
    """(name, dtype, rows) per column, name-sorted — what the consumer
    checks against the map's advertised geometry before concat."""
    return tuple((n, str(columns[n].dtype), int(columns[n].shape[0]))
                 for n in sorted(columns))


# ------------------------------------------------------- chaos primitives
# Applied by the SENDER when obs/faultinj's shuffle-category verdict says
# so: the receiver's integrity checks are the code under test, so the
# damage must genuinely cross the wire.


def corrupt_frame(data: bytes, seed: int = 0) -> bytes:
    """Flip one payload byte (position seeded-deterministic): the CRC
    check on the far side must catch it."""
    if len(data) <= PREFIX.size:
        return data
    pos = PREFIX.size + (seed % (len(data) - PREFIX.size))
    return data[:pos] + bytes([data[pos] ^ 0x40]) + data[pos + 1:]


def truncate_frame(data: bytes, seed: int = 0) -> bytes:
    """Cut the frame short (at least the prefix survives, so the reader
    sees a length mismatch rather than a hang)."""
    if len(data) <= PREFIX.size + 1:
        return data
    keep = PREFIX.size + (seed % (len(data) - PREFIX.size - 1))
    return data[:max(PREFIX.size, keep)]
