"""The PyTorch port's calendar rebase and timezone conversion against the
JAX package on the CPU, bit for bit.

Rebase: both directions, DATE32 and TIMESTAMP_MICROS, at the reference's
JUnit vectors (DateTimeRebaseTest.java), at the edges (year 1, 1582-10-04,
the 1582-10-05..14 gap, 1582-10-15, 1900, the epoch, micros just below and
above midnight and negative micros that are not whole seconds) and over a
seeded sweep of years 1-2100.  Timezones: the TimeZoneDB tables of the zones
tests/test_timezones.py uses equal the JAX package's, the Asia/Shanghai JUnit
vectors (TimeZoneTest.java), a seeded sweep 1900-2100 in three units and
both directions, the rejection of recurring-DST zones and ``parse_tzif`` over
the TZif files committed under tests/data/tzif/ (tzdata 2025b).
"""

import datetime
import os
import zoneinfo

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import columnar as jc
from spark_rapids_jni_tpu.ops import datetime_rebase as jrb
from spark_rapids_jni_tpu.ops import timezones as jtz
from spark_rapids_jni_tpu.utils import tzif as jtzif
from spark_rapids_jni_tpu_torch import ops
from spark_rapids_jni_tpu_torch.columnar import DATE32, TIMESTAMP_MICROS, Column, column
from spark_rapids_jni_tpu_torch.columnar.dtypes import TIMESTAMP_MILLIS, TIMESTAMP_SECONDS
from spark_rapids_jni_tpu_torch.ops import datetime_rebase as rb
from spark_rapids_jni_tpu_torch.ops import timezones as tz
from spark_rapids_jni_tpu_torch.utils import tzif
from tests.test_datetime_rebase import (
    G2J_DAYS_IN,
    G2J_DAYS_OUT,
    G2J_MICROS_IN,
    G2J_MICROS_OUT,
    J2G_MICROS_IN,
    J2G_MICROS_OUT,
)
from tests.test_timezones import FROM_UTC_SECONDS, TO_UTC_SECONDS

TZIF_DIR = os.path.join(os.path.dirname(__file__), "data", "tzif")
EPOCH = datetime.date(1970, 1, 1)
US_PER_DAY = 86_400_000_000


def _day(y, m, d):
    return (datetime.date(y, m, d) - EPOCH).days


EDGE_DAYS = [_day(1, 1, 1), _day(1, 3, 1), _day(100, 2, 28), _day(1582, 10, 4),
             _day(1582, 10, 5), _day(1582, 10, 10), _day(1582, 10, 14), _day(1582, 10, 15),
             _day(1582, 10, 16), _day(1900, 1, 1), _day(1900, 3, 1), -1, 0, 1,
             _day(2000, 2, 29), _day(2100, 12, 31)]
EDGE_MICROS = ([d * US_PER_DAY + off for d in EDGE_DAYS
                for off in (0, 1, -1, 999_999, -1_000_001, US_PER_DAY - 1)]
               + [-1, -999_999, -1_000_001, -45446999900, -12219292800000000,
                  -12219292800000001, -12219292799999999])


def seeded_days(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(_day(1, 1, 1), _day(2100, 12, 31), n).astype(np.int32)


def seeded_micros(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(_day(1, 1, 1) * US_PER_DAY, _day(2100, 12, 31) * US_PER_DAY, n,
                        dtype=np.int64)


def _pair(values, dtype, valid=None):
    """The same values as a port Column (CPU) and a JAX column of the same
    type."""
    arr = np.asarray(values)
    jcol = jc.Column(jnp.asarray(arr), None if valid is None else jnp.asarray(valid),
                     getattr(jc, dtype.kind.name))
    pcol = Column(torch.from_numpy(arr.copy()),
                  None if valid is None else torch.from_numpy(valid.copy()), dtype)
    return pcol, jcol


def _equal(p, j):
    want = np.asarray(j.data)
    assert p.data.numpy().dtype == want.dtype
    np.testing.assert_array_equal(p.data.numpy(), want)
    if j.validity is None:
        assert p.validity is None
    else:
        np.testing.assert_array_equal(p.validity.numpy(), np.asarray(j.validity))


DIRECTIONS = [("g2j", rb.rebase_gregorian_to_julian, jrb.rebase_gregorian_to_julian),
              ("j2g", rb.rebase_julian_to_gregorian, jrb.rebase_julian_to_gregorian)]


@pytest.mark.parametrize("name,port_fn,jax_fn", DIRECTIONS, ids=[d[0] for d in DIRECTIONS])
@pytest.mark.parametrize("kind", ["days", "micros"])
def test_rebase_matches_jax_at_edges_and_sweep(name, port_fn, jax_fn, kind):
    if kind == "days":
        vals = np.concatenate([np.array(EDGE_DAYS, np.int32), seeded_days(4096, 3)])
        dtype = DATE32
    else:
        vals = np.concatenate([np.array(EDGE_MICROS, np.int64), seeded_micros(4096, 4)])
        dtype = TIMESTAMP_MICROS
    valid = np.arange(len(vals)) % 13 != 6
    p, j = _pair(vals, dtype, valid)
    _equal(port_fn(p), jax_fn(j))


def test_reference_vectors():
    days = column(G2J_DAYS_IN, DATE32, device="cpu")
    assert rb.rebase_gregorian_to_julian(days).to_list() == G2J_DAYS_OUT
    micros = column(G2J_MICROS_IN, TIMESTAMP_MICROS, device="cpu")
    assert rb.rebase_gregorian_to_julian(micros).to_list() == G2J_MICROS_OUT
    back = column(J2G_MICROS_IN, TIMESTAMP_MICROS, device="cpu")
    assert rb.rebase_julian_to_gregorian(back).to_list() == J2G_MICROS_OUT
    # the gap clamps to the Gregorian start, and the start itself is fixed
    gap = column([_day(1582, 10, 5), _day(1582, 10, 14), _day(1582, 10, 15)], DATE32,
                 device="cpu")
    assert rb.rebase_gregorian_to_julian(gap).to_list() == [rb.GREGORIAN_START_DAYS] * 3
    # negative micros that are not whole seconds keep their time of day
    out = rb.rebase_gregorian_to_julian(column([_day(1, 1, 1) * US_PER_DAY - 1],
                                               TIMESTAMP_MICROS, device="cpu"))
    assert out.to_list()[0] % US_PER_DAY == US_PER_DAY - 1


def test_rebase_rejects_bad_dtype():
    with pytest.raises(TypeError, match="DATE32 or TIMESTAMP_MICROS"):
        ops.rebase_gregorian_to_julian(column([1], TIMESTAMP_SECONDS, device="cpu"))


TABLE_ZONES = ["Asia/Shanghai", "Asia/Kolkata", "Asia/Ho_Chi_Minh", "UTC", "UTC+8", "+05:30",
               "GMT-05:30", "CTT", "EST", "+08:3", "Z"]


@pytest.mark.parametrize("zone", TABLE_ZONES)
def test_timezone_tables_match_jax(zone):
    got = tz.TimeZoneDB.instance().host_transitions(zone)
    assert got == jtz.TimeZoneDB.instance().host_transitions(zone)
    u, t, o = tz.TimeZoneDB.instance().transitions(zone, "cpu")
    assert (u.dtype, t.dtype, o.dtype) == (torch.int64, torch.int64, torch.int32)
    assert u.is_contiguous() and t.is_contiguous()
    assert [tuple(r) for r in zip(u.tolist(), t.tolist(), o.tolist())] == got


def test_tables_cached_once_per_device():
    db = tz.TimeZoneDB.instance()
    first = db.transitions("Asia/Kolkata", "cpu")
    assert db.transitions("Asia/Kolkata", torch.device("cpu")) is first
    assert ("Asia/Kolkata", torch.device("cpu")) in db._tables


def test_shanghai_junit_vectors():
    for unit, scale in ((TIMESTAMP_SECONDS, 1), (TIMESTAMP_MILLIS, 1000),
                        (TIMESTAMP_MICROS, 1_000_000)):
        inp = [a * scale for a, _ in TO_UTC_SECONDS] + [None]
        out = ops.convert_timestamp_to_utc(column(inp, unit, device="cpu"), "Asia/Shanghai")
        assert out.to_list() == [b * scale for _, b in TO_UTC_SECONDS] + [None]
        inp = [a * scale for a, _ in FROM_UTC_SECONDS]
        out = ops.convert_utc_timestamp_to_timezone(column(inp, unit, device="cpu"),
                                                    "Asia/Shanghai")
        assert out.to_list() == [b * scale for _, b in FROM_UTC_SECONDS]


def _sweep(n, unit_scale, seed):
    rng = np.random.default_rng(seed)
    lo = (datetime.datetime(1900, 1, 1) - datetime.datetime(1970, 1, 1)).total_seconds()
    hi = (datetime.datetime(2100, 12, 31) - datetime.datetime(1970, 1, 1)).total_seconds()
    secs = rng.integers(int(lo), int(hi), n)
    frac = rng.integers(-unit_scale + 1, unit_scale, n) if unit_scale > 1 else 0
    edges = np.array([-1, 1, -unit_scale, unit_scale - 1, 0], np.int64)
    return np.concatenate([secs * unit_scale + frac, edges]).astype(np.int64)


@pytest.mark.parametrize("zone", ["Asia/Shanghai", "Asia/Kolkata", "+05:30"])
@pytest.mark.parametrize("unit,scale", [(TIMESTAMP_SECONDS, 1), (TIMESTAMP_MILLIS, 1000),
                                        (TIMESTAMP_MICROS, 1_000_000)],
                         ids=["s", "ms", "us"])
def test_conversion_matches_jax(zone, unit, scale):
    vals = _sweep(2048, scale, seed=scale % 97)
    valid = np.arange(len(vals)) % 7 != 2
    for port_fn, jax_fn in ((tz.convert_timestamp_to_utc, jtz.convert_timestamp_to_utc),
                            (tz.convert_utc_timestamp_to_timezone,
                             jtz.convert_utc_timestamp_to_timezone)):
        p, j = _pair(vals, unit, valid)
        _equal(port_fn(p, zone), jax_fn(j, zone))


def test_recurring_dst_zone_rejected_like_jax():
    col = column([0], TIMESTAMP_SECONDS, device="cpu")
    with pytest.raises(ValueError, match="recurring DST"):
        ops.convert_utc_timestamp_to_timezone(col, "America/New_York")
    with pytest.raises(ValueError, match="recurring DST"):
        jtz.TimeZoneDB.instance().transitions("America/New_York")
    with pytest.raises(KeyError):
        ops.convert_timestamp_to_utc(col, "No/Such_Zone")
    with pytest.raises(ValueError, match="Invalid zone offset"):
        ops.convert_timestamp_to_utc(col, "+19:00")
    with pytest.raises(TypeError, match="Unsupported timestamp unit"):
        ops.convert_timestamp_to_utc(column([0], DATE32, device="cpu"), "UTC")


@pytest.mark.parametrize("zone", ["Asia/Shanghai", "Asia/Kolkata", "Asia/Ho_Chi_Minh",
                                  "America/New_York"])
def test_parse_tzif_over_committed_files(zone):
    with open(os.path.join(TZIF_DIR, *zone.split("/")), "rb") as f:
        data = f.read()
    got, want = tzif.parse_tzif(data), jtzif.parse_tzif(data)
    assert [(t.instant, t.offset_before, t.offset_after) for t in got.transitions] == \
        [(t.instant, t.offset_before, t.offset_after) for t in want.transitions]
    assert (got.initial_offset, got.footer, got.has_recurring_dst) == \
        (want.initial_offset, want.footer, want.has_recurring_dst)
    assert got.has_recurring_dst == (zone == "America/New_York")


def test_zones_read_from_the_committed_tzif_directory():
    """With TZPATH set to tests/data/tzif alone (chip_smoke.py's fallback on
    a machine with neither zoneinfo nor the tzdata wheel), the tables equal
    those from the system's."""
    want = jtz.TimeZoneDB.instance().host_transitions("Asia/Shanghai")
    saved = zoneinfo.TZPATH
    zoneinfo.reset_tzpath(to=[os.path.abspath(TZIF_DIR)])
    try:
        path = tzif._find_tzfile("Asia/Shanghai")
        assert path is not None and path.startswith(os.path.abspath(TZIF_DIR))
        db = tz.TimeZoneDB()
        assert db.host_transitions("Asia/Shanghai") == want
        assert tzif._find_tzfile("../etc/passwd") is None
    finally:
        zoneinfo.reset_tzpath(to=saved)


def test_cache_database_async_and_shutdown():
    try:
        tz.TimeZoneDB._shutdown_called = False
        tz.TimeZoneDB._instance = None
        tz.TimeZoneDB.cache_database_async(["Asia/Shanghai", "UTC", "No/Such_Zone"])
        tz.TimeZoneDB.instance()._loader.join(timeout=30)
        inst = tz.TimeZoneDB.instance()
        assert "Asia/Shanghai" in inst._rows and "UTC" in inst._rows
        assert "No/Such_Zone" not in inst._rows
        tz.TimeZoneDB.shutdown()
        tz.TimeZoneDB.cache_database(["UTC"])  # silent no-op
        assert tz.TimeZoneDB._instance is None
        with pytest.raises(RuntimeError, match="shut down"):
            tz.TimeZoneDB.instance()
    finally:
        tz.TimeZoneDB._shutdown_called = False
        tz.TimeZoneDB._instance = None
