"""Proleptic Gregorian <-> Julian calendar rebase of DAYS / MICROS timestamps
(PyTorch port of ``ops/datetime_rebase.py``).

Spark-exact semantics of the reference's ``rebase_gregorian_to_julian`` /
``rebase_julian_to_gregorian`` (datetime_rebase.cu:59,130,227,293, matching
Spark's ``localRebaseGregorianToJulianDays`` family, timezone fixed to UTC).

The reference runs one thread per row over ``cuda::std::chrono`` date math;
here the same closed-form civil-calendar algorithms (Howard Hinnant's
``civil_from_days``/``days_from_civil`` and the 4-year-era Julian variants)
are elementwise int64 torch with no data-dependent control flow, only
``where`` selects.  torch's ``//`` on integer tensors floors, as jnp's does,
so negative day and microsecond numbers divide the same way.

Key facts encoded below:
- Gregorian calendar starts 1582-10-15, which is day -141427 since the epoch
  in BOTH calendars (they agree from that day on).
- Gregorian local dates 1582-10-05 .. 1582-10-14 (civil days
  -141437..-141428) do not exist in the hybrid Julian->Gregorian calendar;
  Spark clamps them to the Gregorian start day (datetime_rebase.cu:94-97).
- For MICROS, the time-of-day part is preserved verbatim; only the day part
  is rebased: ``result = rebased_day * 86_400_000_000 + floor_mod(micros,
  86_400_000_000)`` (the reference's trunc-div with negative fixups,
  datetime_rebase.cu:183-222, is algebraically floor div/mod).
"""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.columnar.dtypes import Kind

MICROS_PER_DAY = 86_400_000_000
# Day number of 1582-10-15 (Gregorian calendar start): same in both calendars.
GREGORIAN_START_DAYS = -141427
# Civil day number of 1582-10-04, the last day of the Julian calendar.
JULIAN_END_DAYS = GREGORIAN_START_DAYS - 11
LAST_SWITCH_GREGORIAN_MICROS = GREGORIAN_START_DAYS * MICROS_PER_DAY  # -12219292800000000


def _civil_from_days(days):
    """days since epoch -> (y, m, d) in the proleptic Gregorian calendar."""
    z = days.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097  # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
    mp = (5 * doy + 2) // 153  # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1  # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)  # [1, 12]
    return y + (m <= 2).to(torch.int64), m, d


def _days_from_civil(y, m, d):
    """(y, m, d) proleptic Gregorian -> days since epoch (int64)."""
    y = y - (m <= 2).to(torch.int64)
    era = y // 400
    yoe = y - era * 400  # [0, 399]
    doy = (153 * (m + torch.where(m > 2, -3, 9)) + 2) // 5 + d - 1  # [0, 365]
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy  # [0, 146096]
    return era * 146097 + doe - 719468


def _days_from_julian(y, m, d):
    """(y, m, d) in the Julian calendar -> days since epoch
    (datetime_rebase.cu:40)."""
    y = y - (m <= 2).to(torch.int64)
    era = y // 4
    yoe = y - era * 4  # [0, 3]
    doy = (153 * (m + torch.where(m > 2, -3, 9)) + 2) // 5 + d - 1  # [0, 365]
    doe = yoe * 365 + doy  # [0, 1460]
    return era * 1461 + doe - 719470


def _julian_from_days(days):
    """days since epoch -> (y, m, d) in the Julian calendar
    (datetime_rebase.cu:109)."""
    z = days.to(torch.int64) + 719470
    era = z // 1461
    doe = z - era * 1461  # [0, 1460]
    yoe = (doe - doe // 1460) // 365  # [0, 3]
    y = yoe + era * 4
    doy = doe - 365 * yoe  # [0, 365]
    mp = (5 * doy + 2) // 153  # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1  # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)  # [1, 12]
    return y + (m <= 2).to(torch.int64), m, d


def _gregorian_to_julian_day(days):
    """Rebase civil day numbers; returns int64 day numbers."""
    days = days.to(torch.int64)
    rebased = _days_from_julian(*_civil_from_days(days))
    in_gap = (days > JULIAN_END_DAYS) & (days < GREGORIAN_START_DAYS)
    rebased = torch.where(in_gap, GREGORIAN_START_DAYS, rebased)
    return torch.where(days >= GREGORIAN_START_DAYS, days, rebased)


def _julian_to_gregorian_day(days):
    days = days.to(torch.int64)
    rebased = _days_from_civil(*_julian_from_days(days))
    return torch.where(days >= GREGORIAN_START_DAYS, days, rebased)


def _rebase_micros(micros, day_fn):
    micros = micros.to(torch.int64)
    day = micros // MICROS_PER_DAY
    time_of_day = micros - day * MICROS_PER_DAY  # floor mod, in [0, MICROS_PER_DAY)
    rebased = day_fn(day) * MICROS_PER_DAY + time_of_day
    return torch.where(micros >= LAST_SWITCH_GREGORIAN_MICROS, micros, rebased)


def _dispatch(col: Column, day_fn) -> Column:
    if col.dtype.kind == Kind.DATE32:
        out = day_fn(col.data).to(torch.int32)
    elif col.dtype.kind == Kind.TIMESTAMP_MICROS:
        out = _rebase_micros(col.data, day_fn)
    else:
        raise TypeError(f"rebase requires DATE32 or TIMESTAMP_MICROS, got {col.dtype}")
    return Column(out, col.validity, col.dtype)


def rebase_gregorian_to_julian(col: Column) -> Column:
    """Spark ``rebaseGregorianToJulianDays``/``...Micros`` (UTC).

    Reinterprets each proleptic-Gregorian local date(-time) as a
    Julian-calendar local date(-time) and returns its day/microsecond number.
    Dates in the 1582-10-05..14 gap clamp to the Gregorian start day.
    """
    return _dispatch(col, _gregorian_to_julian_day)


def rebase_julian_to_gregorian(col: Column) -> Column:
    """Spark ``rebaseJulianToGregorianDays``/``...Micros`` (UTC)."""
    return _dispatch(col, _julian_to_gregorian_day)
