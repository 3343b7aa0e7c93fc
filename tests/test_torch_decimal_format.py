"""The PyTorch port's ``format_float`` (Spark ``format_number``) and
``decimal_to_string`` (``BigDecimal.toString``) against the JAX package on
the CPU, and the reference gtest vectors (tests/test_decimal_format.py).

Seeded numpy inputs go through both packages; tolerance 0 on offsets, the
logical chars and validity.  The decimal corpora reach 38 digits, both
sides of 10**19 (the port splits magnitudes there), INT64_MIN for
DECIMAL64, and the plain / scientific switch at every scale.
"""

import decimal
import importlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import FLOAT32 as JF32
from spark_rapids_jni_tpu.columnar import FLOAT64 as JF64
from spark_rapids_jni_tpu.columnar.column import column as jcolumn
from spark_rapids_jni_tpu.columnar.column import decimal128_column as jdecimal128_column
from spark_rapids_jni_tpu.columnar.dtypes import decimal as jdecimal
from spark_rapids_jni_tpu.ops.cast_decimal_to_string import decimal_to_string as jdecimal_to_string
from spark_rapids_jni_tpu.ops.format_float import format_float as jformat_float
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops import decimal_to_string, format_float


def _logical(col):
    if isinstance(col.offsets, torch.Tensor):
        offs, chars, valid = col.offsets.numpy(), col.chars.numpy(), col.is_valid().numpy()
    else:
        offs, chars, valid = (np.asarray(col.offsets), np.asarray(col.chars),
                              np.asarray(col.is_valid()))
    return offs.tolist(), chars[: offs[-1]].tobytes(), valid.tolist()


def _float_bits(seed, n=1500):
    """Doubles of every magnitude, rounding ties at 0-5 fraction digits,
    subnormals, zeros, infs, NaN and nulls' positions."""
    rng = np.random.RandomState(seed)
    with np.errstate(over="ignore"):
        vals = np.concatenate([
            rng.rand(n // 3) * np.exp(rng.uniform(-30, 30, n // 3)),
            np.round(rng.rand(n // 3) * 1000, 2), rng.randint(1, 10**7, n // 6).astype(float),
            [0.5, 1.5, 2.5, 0.125, 0.005, 0.015, 0.99999, 999.5, 9.995, 123.456, 1e15, 1e16,
             1e22, 1.7976931348623157e308, 5e-324, 2.2250738585072014e-308, 0.0, -0.0,
             np.inf, -np.inf, np.nan, 3.4028235e38, 1e-7, 9.9999e-6]])
    vals = vals * np.where(rng.rand(vals.size) < 0.3, -1.0, 1.0)
    return np.concatenate([vals.view(np.int64), rng.randint(-(2**63), 2**63, n // 6,
                                                            dtype=np.int64)])


@pytest.mark.parametrize("digits", [0, 2, 5])
def test_format_float_equals_jax(digits):
    rng = np.random.RandomState(digits)
    bits = _float_bits(digits + 40)
    valid = rng.rand(bits.size) > 0.05
    j64 = JColumn(jnp.asarray(bits), jnp.asarray(valid), JF64)
    with np.errstate(over="ignore", invalid="ignore"):
        f32 = bits.view(np.float64).astype(np.float32)
    j32 = JColumn(jnp.asarray(f32), jnp.asarray(valid), JF32)
    for jcol in (j64, j32):
        got = format_float(interop.port_column(jcol, "cpu"), digits)
        assert got.chars.numel() == int(got.offsets[-1])
        assert _logical(got) == _logical(jformat_float(jcol, digits))
    # a width hint that covers the rows changes nothing
    fits = np.abs(np.nan_to_num(bits.view(np.float64), posinf=0.0, neginf=0.0)) < 1e15
    col = interop.port_column(JColumn(jnp.asarray(bits[fits]), None, JF64), "cpu")
    assert _logical(format_float(col, digits, width_hint=18)) == _logical(
        format_float(col, digits))


def test_format_float_gtest_vectors():
    vals32 = [100.0, 654321.25, -12761.125, 0.0, 5.0, -4.0, float("nan"), 123456789012.34,
              -0.0]
    assert format_float(tc.column(vals32, tc.FLOAT32, device="cpu"), 5).to_list() == [
        "100.00000", "654,321.25000", "-12,761.12500", "0.00000", "5.00000", "-4.00000",
        "�", "123,456,790,000.00000", "-0.00000"]
    vals64 = [100.0, 654321.25, -12761.125, 1.123456789123456789,
              0.000000000000000000123456789123456789, 0.0, 5.0, -4.0, float("nan"),
              839542223232.794248339, 3232.794248339, 11234000000.0, -0.0]
    assert format_float(tc.column(vals64, tc.FLOAT64, device="cpu"), 5).to_list() == [
        "100.00000", "654,321.25000", "-12,761.12500", "1.12346", "0.00000", "0.00000",
        "5.00000", "-4.00000", "�", "839,542,223,232.79420", "3,232.79425",
        "11,234,000,000.00000", "-0.00000"]

    def fmt(vals, d):
        return format_float(tc.column(vals, tc.FLOAT64, device="cpu"), d).to_list()

    assert fmt([float("inf"), float("-inf")], 2) == ["∞", "-∞"]
    assert fmt([0.9999, 123.456, 999.5], 0) == ["0", "123", "1,000"]
    assert fmt([0.99999, 0.005, 0.015], 2) == ["1.00", "0.00", "0.02"]
    assert fmt([1.5, None], 1) == ["1.5", None]
    assert fmt([], 2) == []
    with pytest.raises(TypeError):
        format_float(tc.column([1], tc.INT32, device="cpu"), 2)
    with pytest.raises(ValueError):
        format_float(tc.column([1.0], tc.FLOAT64, device="cpu"), -1)


def _unscaled(seed, precision, n=300):
    """Unscaled values of 1..precision digits (the digit count uniform), both
    signs, the specials first: 0, +-1, +-(10**p - 1), and the 10**19 edges."""
    rng = random.Random(seed)
    top = 10**precision - 1
    vals = [0, 1, -1, top, -top, top // 7, 10**19 - 1, 10**19, -(10**19), 10**19 + 1,
            2**63 - 1, -(2**63), 2**64 - 1, 2**64, None]
    vals = [v for v in vals if v is None or abs(v) <= top]
    if precision == 18:
        vals.append(-(2**63))  # INT64_MIN: its magnitude is 2**63 as u64 bits
    while len(vals) < n:
        d = rng.randint(1, precision)
        vals.append(rng.randrange(10**(d - 1), 10**d) * rng.choice([1, -1]))
    return vals


def _jax_decimal(vals, precision, scale):
    if precision > 18:
        return jdecimal128_column(vals, precision, scale)
    return jcolumn(vals, jdecimal(precision, scale))


_CTX = decimal.Context(prec=60)


@pytest.mark.parametrize("precision,scale", [(38, 2), (38, 10), (38, 37), (38, -3), (18, 7),
                                             (9, -1)])
def test_decimal_to_string_equals_jax(precision, scale):
    vals = _unscaled(precision * 100 + scale, precision)
    jcol = _jax_decimal(vals, precision, scale)
    got = decimal_to_string(interop.port_column(jcol, "cpu"))
    assert _logical(got) == _logical(jdecimal_to_string(jcol))
    assert got.to_list() == [None if v is None else str(decimal.Decimal(v).scaleb(-scale, _CTX))
                             for v in vals]


def test_decimal_to_string_gtest_vectors():
    def dec(vals, p, s):
        if p > 18:
            return tc.decimal128_column(vals, p, s, device="cpu")
        return tc.column(vals, tc.decimal(p, s), device="cpu")

    assert decimal_to_string(dec(list(range(11)), 9, 0)).to_list() == [
        str(i) for i in range(11)]
    assert decimal_to_string(dec([0, 100000000], 18, 6)).to_list() == ["0.000000",
                                                                       "100.000000"]
    assert decimal_to_string(dec([0, 100000000], 18, 7)).to_list() == ["0E-7", "10.0000000"]
    assert decimal_to_string(dec([0, 1000000000], 18, 8)).to_list() == ["0E-8",
                                                                        "10.00000000"]
    assert decimal_to_string(dec([21, -30, 5], 9, -1)).to_list() == ["2.1E+2", "-3.0E+2",
                                                                     "5E+1"]
    vals = [12345678901234567890123456789012345678, -1, 0, None, -(10**37), 10**30 + 7]
    assert decimal_to_string(dec(vals, 38, 10)).to_list() == [
        None if v is None else str(decimal.Decimal(v).scaleb(-10, _CTX)) for v in vals]
    with pytest.raises(TypeError):
        decimal_to_string(tc.column([1], tc.INT64, device="cpu"))


def test_digit_tables_equal_jax_at_the_u64_edges():
    """The divide-by-10 digit table and the digit count read u64 lanes
    unsigned: 2**63 - 1, 2**63, 10**19 - 1, 10**19, 2**64 - 1."""
    # each package's ``ops.float_to_string`` attribute is the function
    jf2s = importlib.import_module("spark_rapids_jni_tpu.ops.float_to_string")
    tf2s = importlib.import_module("spark_rapids_jni_tpu_torch.ops.float_to_string")
    rng = np.random.RandomState(71)
    edges = [0, 1, 9, 10, 99, 2**53, 2**63 - 1, 2**63, 2**63 + 1, 10**18, 10**19 - 1, 10**19,
             2**64 - 2, 2**64 - 1]
    vals = np.concatenate([np.array(edges, dtype=np.uint64),
                           rng.randint(-(2**63), 2**63, 200, dtype=np.int64).view(np.uint64)])
    t = torch.from_numpy(vals.view(np.int64))
    j = jnp.asarray(vals)
    np.testing.assert_array_equal(tf2s.digit_table_u64(t).numpy(),
                                  np.asarray(jf2s.digit_table_u64(j)))
    np.testing.assert_array_equal(tf2s._decimal_length_u64(t, 20).numpy(),
                                  np.asarray(jf2s._decimal_length_u64(j, 20)))
    k = torch.from_numpy(rng.randint(-2, 22, (vals.size, 5)))
    tab = tf2s.digit_table_u64(t)
    np.testing.assert_array_equal(
        tf2s.digit_from_table(tab, k).numpy(),
        np.asarray(jf2s.digit_from_table(jnp.asarray(tab.numpy()), jnp.asarray(k.numpy()))))
