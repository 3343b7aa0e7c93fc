"""Minimal TZif (RFC 8536) reader for building timezone transition tables (a
copy of the JAX package's ``utils/tzif.py``).

The reference builds its transition tables from ``java.time.ZoneRules`` on the
JVM (GpuTimeZoneDB.java:261-335).  Python's ``zoneinfo`` does not expose
transitions, so we read the TZif files (system ``/usr/share/zoneinfo`` or the
``tzdata`` wheel) directly.  Only the pieces the timezone DB needs are parsed:
the 64-bit transition instants, the pre/post offsets of each transition, and
the footer TZ string (used to decide whether the zone has recurring DST rules,
the equivalent of ``ZoneRules.getTransitionRules().isEmpty()``).
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct
from typing import List, Optional

import zoneinfo


@dataclasses.dataclass
class TzTransition:
    instant: int  # epoch seconds of the transition
    offset_before: int  # utc offset seconds in effect before
    offset_after: int  # utc offset seconds in effect after

    @property
    def is_gap(self) -> bool:
        return self.offset_after > self.offset_before


@dataclasses.dataclass
class TzRules:
    """Parsed rules of one zone."""

    transitions: List[TzTransition]
    initial_offset: int  # offset before the first transition (or the fixed offset)
    footer: str  # TZ string ('' for v1 files)

    @property
    def is_fixed(self) -> bool:
        return not self.transitions

    @property
    def has_recurring_dst(self) -> bool:
        """True if the footer TZ string specifies a DST name/rule part.

        Equivalent to Java's ``!ZoneRules.getTransitionRules().isEmpty()``:
        a POSIX TZ string ``std offset [dst [offset] [,start[/t],end[/t]]]``
        has recurring rules iff a dst part follows the std offset.
        """
        s = self.footer.strip()
        if not s:
            return False
        i = 0
        # std name: quoted <...> or alpha run
        if s[i] == "<":
            i = s.index(">", i) + 1
        else:
            while i < len(s) and (s[i].isalpha()):
                i += 1
        # offset: [+-]hh[:mm[:ss]]
        while i < len(s) and (s[i].isdigit() or s[i] in "+-:"):
            i += 1
        return i < len(s)  # anything left is a dst part


_KEY_PART = re.compile(r"^[A-Za-z0-9_.+-]+$")


def _valid_key(key: str) -> bool:
    """Reject path traversal: each '/'-part must be a plain name (no '..')."""
    parts = key.split("/")
    return bool(parts) and all(
        p not in ("", ".", "..") and _KEY_PART.match(p) for p in parts
    )


def _find_tzfile(key: str) -> Optional[str]:
    if not _valid_key(key):
        return None
    for base in zoneinfo.TZPATH:
        path = os.path.join(base, *key.split("/"))
        if os.path.isfile(path):
            return path
    try:
        import importlib.resources as res

        pkg = "tzdata.zoneinfo." + ".".join(key.split("/")[:-1])
        name = key.split("/")[-1]
        ref = res.files(pkg.rstrip(".")) / name
        if ref.is_file():
            return str(ref)
    except (ImportError, OSError):  # no tzdata wheel / unreadable resource
        pass
    return None


def read_tzif(key: str) -> TzRules:
    """Parse the TZif file of ``key`` (e.g. 'Asia/Shanghai')."""
    path = _find_tzfile(key)
    if path is None:
        raise KeyError(f"No TZif data found for zone '{key}'")
    with open(path, "rb") as f:
        data = f.read()
    return parse_tzif(data)


def _parse_header(data: bytes, pos: int):
    magic, version = data[pos : pos + 4], data[pos + 4 : pos + 5]
    if magic != b"TZif":
        raise ValueError("Not a TZif file")
    counts = struct.unpack(">6I", data[pos + 20 : pos + 44])
    return version, counts  # isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt


def _block_size(counts, time_size: int) -> int:
    isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt = counts
    return (
        timecnt * time_size
        + timecnt
        + typecnt * 6
        + charcnt
        + leapcnt * (time_size + 4)
        + isstdcnt
        + isutcnt
    )


def _parse_block(data: bytes, pos: int, counts, time_size: int):
    _, _, _, timecnt, typecnt, _ = counts
    fmt = ">%d%s" % (timecnt, "q" if time_size == 8 else "i")
    times = list(struct.unpack_from(fmt, data, pos)) if timecnt else []
    pos += timecnt * time_size
    type_idx = list(data[pos : pos + timecnt])
    pos += timecnt
    ttinfos = []
    for i in range(typecnt):
        utoff, isdst, _desig = struct.unpack_from(">iBB", data, pos + i * 6)
        ttinfos.append((utoff, bool(isdst)))
    return times, type_idx, ttinfos


def parse_tzif(data: bytes) -> TzRules:
    version, counts = _parse_header(data, 0)
    pos = 44
    if version == b"\x00":
        times, type_idx, ttinfos = _parse_block(data, pos, counts, 4)
        footer = ""
    else:
        pos += _block_size(counts, 4)  # skip v1 block
        version2, counts2 = _parse_header(data, pos)
        pos += 44
        times, type_idx, ttinfos = _parse_block(data, pos, counts2, 8)
        pos += _block_size(counts2, 8)
        footer = data[pos:].decode("ascii", errors="replace").strip("\n")

    if not ttinfos:
        raise ValueError("TZif file has no time types")

    # Offset in effect before the first transition: the first standard-time
    # (isdst == 0) type, falling back to type 0 (RFC 8536 §3.2 convention,
    # matching CPython zoneinfo and java.time's compiled rules).
    initial = next((off for off, isdst in ttinfos if not isdst), ttinfos[0][0])

    transitions = []
    prev_off = initial
    for t, ti in zip(times, type_idx):
        off_after = ttinfos[ti][0]
        if off_after != prev_off:
            transitions.append(TzTransition(t, prev_off, off_after))
        prev_off = off_after
    return TzRules(transitions, initial, footer)
