"""Timestamp <-> UTC conversion for timezones without recurring DST rules
(PyTorch port of ``ops/timezones.py``).

Capability parity with the reference's GpuTimeZoneDB + timezones.cu:
- the host side lazily builds per-zone transition tables
  (utcInstant, tzInstant, utcOffset) — GpuTimeZoneDB.java:261-335, here from
  TZif files via utils.tzif instead of java.time.ZoneRules;
- the device side does one ``torch.searchsorted(..., right=True)``
  (upper_bound) per batch over the zone's contiguous int64 transition
  instants and applies the found offset (timezones.cu:50-91
  convert_timestamp_tz_functor).  The tables are built once per process on
  the host and uploaded once per device they are asked for.

Spark's gap/overlap policy is encoded in the table itself
(GpuTimeZoneDB.java:296-316): for a gap the tzInstant is
``instant + offsetAfter``, for an overlap ``instant + offsetBefore``, and the
stored offset is always ``offsetAfter``.  The first row is a
``(INT64_MIN, INT64_MIN, initial offset)`` sentinel so the upper_bound index
is always >= 1.

Zones WITH recurring DST rules (America/New_York, ...) are rejected exactly
like the reference (GpuTimeZoneDB.java:277-279) — Spark falls back to CPU for
those.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.columnar.dtypes import Kind
from spark_rapids_jni_tpu_torch.utils import tzif

LONG_MIN = -(1 << 63)

# java.time.ZoneId.SHORT_IDS (deprecated 3-letter ids Spark still accepts).
SHORT_IDS = {
    "ACT": "Australia/Darwin", "AET": "Australia/Sydney",
    "AGT": "America/Argentina/Buenos_Aires", "ART": "Africa/Cairo",
    "AST": "America/Anchorage", "BET": "America/Sao_Paulo",
    "BST": "Asia/Dhaka", "CAT": "Africa/Harare", "CNT": "America/St_Johns",
    "CST": "America/Chicago", "CTT": "Asia/Shanghai",
    "EAT": "Africa/Addis_Ababa", "ECT": "Europe/Paris",
    "IET": "America/Indiana/Indianapolis", "IST": "Asia/Kolkata",
    "JST": "Asia/Tokyo", "MIT": "Pacific/Apia", "NET": "Asia/Yerevan",
    "NST": "Pacific/Auckland", "PLT": "Asia/Karachi", "PNT": "America/Phoenix",
    "PRT": "America/Puerto_Rico", "PST": "America/Los_Angeles",
    "SST": "Pacific/Guadalcanal", "VST": "Asia/Ho_Chi_Minh",
    "EST": "-05:00", "MST": "-07:00", "HST": "-10:00",
}

_OFFSET_RE = re.compile(
    r"^(?:UTC|GMT|UT)?([+-])(\d{1,2})(?::(\d{2})(?::(\d{2}))?)?$"
)


def normalize_zone_id(zone_id: str) -> str:
    """Spark's pre-normalization (GpuTimeZoneDB.java:250-258): map SHORT_IDS
    and pad the legacy ``(+|-)hh:m`` minute form."""
    zone_id = SHORT_IDS.get(zone_id, zone_id)
    return re.sub(r"([+-])(\d\d):(\d)$", r"\g<1>\g<2>:0\g<3>", zone_id)


def _parse_offset_id(zone_id: str) -> Optional[int]:
    """Fixed-offset zone id ('+08:00', 'UTC+8', 'GMT-05:30', 'Z') -> seconds."""
    if zone_id in ("Z", "UTC", "GMT", "UT"):
        return 0
    m = _OFFSET_RE.match(zone_id)
    if not m:
        return None
    sign = 1 if m.group(1) == "+" else -1
    h = int(m.group(2))
    mnt = int(m.group(3) or 0)
    sec = int(m.group(4) or 0)
    # java.time.ZoneOffset range rules: |offset| <= 18:00, mm/ss in [0,59].
    if h > 18 or mnt > 59 or sec > 59 or (h == 18 and (mnt or sec)):
        raise ValueError(f"Invalid zone offset id: {zone_id}")
    return sign * (h * 3600 + mnt * 60 + sec)


class TimeZoneDB:
    """Lazy singleton cache of transition tables (mirrors GpuTimeZoneDB.java)."""

    _instance: Optional["TimeZoneDB"] = None
    _lock = threading.Lock()

    def __init__(self):
        # zone id -> (utcInstant, tzInstant, offset) host rows as [rows, 3] int64
        self._rows: Dict[str, np.ndarray] = {}
        # (zone id, device) -> (utc_instants, tz_instants, offsets) tensors
        self._tables: Dict[Tuple[str, torch.device],
                           Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
        self._table_lock = threading.Lock()
        self._loader: Optional[threading.Thread] = None

    @classmethod
    def instance(cls) -> "TimeZoneDB":
        with cls._lock:
            if cls._instance is None:
                if cls._shutdown_called:
                    # GpuTimeZoneDB: once shut down, never load again
                    raise RuntimeError("TimeZoneDB was shut down")
                cls._instance = cls()
            return cls._instance

    @classmethod
    def shutdown(cls) -> None:
        """Drop the cache and refuse future loads until re-enabled
        (GpuTimeZoneDB.java:76 'whether a shutdown is called ever')."""
        with cls._lock:
            inst = cls._instance
            loader = inst._loader if inst is not None else None
        if loader is not None:
            try:
                loader.join(timeout=30)  # shutdown waits for async caching
            except RuntimeError:
                pass  # loader created but never started
        with cls._lock:
            cls._shutdown_called = True
            cls._instance = None

    _shutdown_called = False

    @classmethod
    def cache_database(cls, zone_ids=None) -> None:
        """Eagerly build the host transition tables
        (GpuTimeZoneDB.cacheDatabase:129); each device's copy is uploaded
        on its first use.

        ``zone_ids`` defaults to every zone the host tzdata provides whose
        rules the non-DST cache supports; unsupported/unknown zones are
        skipped, as the reference skips zones it cannot represent.
        """
        with cls._lock:
            if cls._shutdown_called:
                return  # reference: never load again after shutdown
        inst = cls.instance()
        if zone_ids is None:
            import zoneinfo

            zone_ids = sorted(zoneinfo.available_timezones())
        for z in zone_ids:
            try:
                inst.host_transitions(z)
            except (KeyError, ValueError):
                continue  # unknown or recurring-DST zone: not cacheable

    @classmethod
    def cache_database_async(cls, zone_ids=None) -> None:
        """Background-thread preload (GpuTimeZoneDB.cacheDatabaseAsync:88)."""
        with cls._lock:
            if cls._shutdown_called:
                return
        inst = cls.instance()
        t = threading.Thread(
            target=cls.cache_database, args=(zone_ids,),
            name="srt-tzdb-loader", daemon=True)
        t.start()
        inst._loader = t  # published only once started (shutdown joins it)

    def _build_rows(self, zone_id: str) -> List[Tuple[int, int, int]]:
        """(utcInstant, tzInstant, offset) rows per GpuTimeZoneDB.java:284-318."""
        offset = _parse_offset_id(zone_id)
        if offset is not None:
            return [(LONG_MIN, LONG_MIN, offset)]
        rules = tzif.read_tzif(zone_id)  # KeyError for unknown ids
        if rules.has_recurring_dst:
            raise ValueError(
                f"Timezone {zone_id} has recurring DST transition rules and is "
                "not supported (matches GpuTimeZoneDB's non-DST-only cache)"
            )
        rows = [(LONG_MIN, LONG_MIN, rules.initial_offset)]
        for t in rules.transitions:
            local = t.instant + (t.offset_after if t.is_gap else t.offset_before)
            rows.append((t.instant, local, t.offset_after))
        return rows

    def _host_rows(self, key: str) -> np.ndarray:
        """The zone's rows as a [rows, 3] int64 array (caller holds the lock)."""
        arr = self._rows.get(key)
        if arr is None:
            rows = self._build_rows(key)
            arr = self._rows[key] = np.asarray(rows, dtype=np.int64).reshape(len(rows), 3)
        return arr

    def transitions(self, zone_id: str, device: _device.DeviceLike = None):
        """The zone's transition tensors on ``device`` (the card unless the
        caller asks for the CPU): ``(utc_instants int64, tz_instants int64,
        offsets int32)``, built on first use and cached per device."""
        key = normalize_zone_id(zone_id)
        dev = _device.resolve(device)
        with self._table_lock:
            tables = self._tables.get((key, dev))
            if tables is None:
                arr = self._host_rows(key)
                tables = self._tables[(key, dev)] = (
                    torch.from_numpy(arr[:, 0].copy()).to(dev),
                    torch.from_numpy(arr[:, 1].copy()).to(dev),
                    torch.from_numpy(arr[:, 2].astype(np.int32)).to(dev),
                )
            return tables

    def host_transitions(self, zone_id: str) -> List[Tuple[int, int, int]]:
        """Host copy, for tests (GpuTimeZoneDB.getHostFixedTransitions)."""
        key = normalize_zone_id(zone_id)
        with self._table_lock:
            arr = self._host_rows(key)
        return [(int(u), int(t), int(np.int32(o))) for u, t, o in arr.tolist()]


_SCALE = {
    Kind.TIMESTAMP_SECONDS: 1,
    Kind.TIMESTAMP_MILLIS: 1_000,
    Kind.TIMESTAMP_MICROS: 1_000_000,
}


def _convert(input: Column, zone_id: str, to_utc: bool) -> Column:
    scale = _SCALE.get(input.dtype.kind)
    if scale is None:
        raise TypeError("Unsupported timestamp unit for timezone conversion")
    utc_instants, tz_instants, offsets = TimeZoneDB.instance().transitions(
        zone_id, input.device)

    ts = input.data.to(torch.int64)
    # duration_cast<seconds> truncates toward zero (timezones.cu:73-74)
    q = ts // scale
    epoch_seconds = q + ((ts < 0) & (ts % scale != 0)).to(torch.int64)

    instants = tz_instants if to_utc else utc_instants
    idx = torch.searchsorted(instants, epoch_seconds, right=True)
    offset = offsets[idx - 1].to(torch.int64) * scale
    out = ts - offset if to_utc else ts + offset
    return Column(out, input.validity, input.dtype)


def convert_timestamp_to_utc(input: Column, zone_id: str) -> Column:
    """Interpret ``input`` as local time in ``zone_id`` and return UTC
    (GpuTimeZoneDB.fromTimestampToUtcTimestamp)."""
    return _convert(input, zone_id, to_utc=True)


def convert_utc_timestamp_to_timezone(input: Column, zone_id: str) -> Column:
    """Convert UTC ``input`` to local time in ``zone_id``
    (GpuTimeZoneDB.fromUtcTimestampToTimestamp)."""
    return _convert(input, zone_id, to_utc=False)
