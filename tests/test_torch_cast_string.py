"""The PyTorch port's string -> integer / decimal casts, Spark ``conv()`` base
casts and the bucket helpers under them, against the JAX package on the CPU.

Seeded numpy corpora go through both packages; every comparison is exact
(tolerance 0): values, (hi, lo) words, validity and ANSI error rows.  The
JAX package compiles one program per bucket shape and configuration, so
each configuration gets one call over a whole corpus.  The
``CastStringsTest`` vectors (tests/test_cast_string.py) are held on the
port as well.
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import buckets as jbuckets
from spark_rapids_jni_tpu.columnar import dtypes as jdtypes
from spark_rapids_jni_tpu.columnar.column import column as jcolumn
from spark_rapids_jni_tpu.columnar.column import strings_column as jstrings_column
from spark_rapids_jni_tpu.ops import cast_string as jcs
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.columnar import buckets as tbuckets
from spark_rapids_jni_tpu_torch.ops import cast_string as tcs

INT_KINDS = {"INT8": (jdtypes.INT8, tc.INT8, np.int8), "INT32": (jdtypes.INT32, tc.INT32, np.int32),
             "INT64": (jdtypes.INT64, tc.INT64, np.int64)}


def _cols(vals):
    """The same strings as a JAX column and as a port column on the CPU."""
    j = jstrings_column(vals)
    return j, interop.port_column(j, "cpu")


def _assert_fixed_equal(got, want):
    """A port fixed-width or decimal128 column equals a JAX one exactly."""
    g = interop.column_to_numpy(got)
    np.testing.assert_array_equal(got.is_valid().numpy(), np.asarray(want.is_valid()))
    if hasattr(want, "hi"):
        np.testing.assert_array_equal(g[0], np.asarray(want.hi))
        np.testing.assert_array_equal(g[1], np.asarray(want.lo))
    else:
        np.testing.assert_array_equal(g[0], np.asarray(want.data))


def _assert_strings_equal(got, want):
    """Offsets, the logical chars (the JAX column over-allocates) and validity."""
    offs = np.asarray(want.offsets)
    np.testing.assert_array_equal(got.offsets.numpy(), offs)
    assert got.chars.numpy().tobytes() == np.asarray(want.chars)[: offs[-1]].tobytes()
    np.testing.assert_array_equal(got.is_valid().numpy(), np.asarray(want.is_valid()))


def _int_corpus(seed, n=600):
    """Random strings over the parser's alphabet plus the edges: the bounds of
    every integer width and one past them, whitespace, signs, dots, junk."""
    rng = np.random.RandomState(seed)
    alphabet = list("0123456789+-. e\t") + ["", "\x00", "\x1f", "\x9f"]
    vals = ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 14)))
            for _ in range(n)]
    for b in (7, 15, 31, 63):
        vals += [str(2**b - 1), str(2**b), str(-(2**b)), str(-(2**b) - 1),
                 f"  {2**b - 1}  ", f"+{2**b}", f"{2**b - 1}.99"]
    vals += ["9" * 25, "-" + "9" * 25, "0" * 30 + "1", "", " ", None, "1 2", "12 ", " 12",
             "+", "-", "5-", ".5", "3.", "7.6asd", "\x00 \x1f1\x14", "１２"]
    return vals


@pytest.mark.parametrize("kind", ["INT8", "INT32", "INT64"])
@pytest.mark.parametrize("strip", [True, False])
def test_string_to_integer_equals_jax(kind, strip):
    jdt, tdt, _ = INT_KINDS[kind]
    j, t = _cols(_int_corpus(3 + len(kind) + strip))
    got = tcs.string_to_integer(t, tdt, strip=strip)
    assert got.data.dtype == tdt.torch_dtype
    _assert_fixed_equal(got, jcs.string_to_integer(j, jdt, strip=strip))


def test_string_to_integer_ansi_row_equals_jax():
    vals = ["1", " 22 ", "-3", "4.5", "x"]
    j, t = _cols(vals)
    with pytest.raises(jcs.CastException) as je:
        jcs.string_to_integer(j, jdtypes.INT64, ansi_mode=True)
    with pytest.raises(tcs.CastException) as te:
        tcs.string_to_integer(t, tc.INT64, ansi_mode=True)
    assert (te.value.row_with_error, te.value.string_with_error) == (
        je.value.row_with_error, je.value.string_with_error) == (3, "4.5")
    ok = tcs.string_to_integer(_cols(vals[:3])[1], tc.INT64, ansi_mode=True)
    assert ok.to_list() == [1, 22, -3]


def test_string_to_integer_cast_strings_test_vectors():
    def cast(vals, dt, strip=True):
        return tcs.string_to_integer(tc.strings_column(vals, device="cpu"), dt,
                                     strip=strip).to_list()

    assert cast([" 3", "9", "4", "2", "20.5", None, "7.6asd", "\x00 \x1f1\x14"],
                tc.INT64) == [3, 9, 4, 2, 20, None, None, 1]
    assert cast(["2", "3", " 4 ", "5.6", " 9.2 ", None, "7.8.3"], tc.INT8,
                strip=False) == [2, 3, None, 5, None, None, None]
    assert cast(["127", "128", "-128", "-129"], tc.INT8) == [127, None, -128, None]
    assert cast(["9223372036854775807", "9223372036854775808", "-9223372036854775808"],
                tc.INT64) == [2**63 - 1, None, -(2**63)]
    assert cast(["+5", "-5", "+", "-", "", "  ", "5-", "5+"], tc.INT32) == [
        5, -5, None, None, None, None, None, None]
    assert cast([".5", "0.", "3.9999", "3."], tc.INT32) == [0, 0, 3, 3]
    with pytest.raises(tcs.CastException) as e:
        tcs.string_to_integer(tc.strings_column(["asdf", "9.0.2"], device="cpu"), tc.INT64,
                              ansi_mode=True)
    assert (e.value.string_with_error, e.value.row_with_error) == ("asdf", 0)
    empty = tcs.string_to_integer(tc.strings_column([], device="cpu"), tc.INT32)
    assert empty.size == 0 and empty.data.dtype == torch.int32
    with pytest.raises(ValueError):
        tcs.string_to_integer(tc.strings_column(["1"], device="cpu"), tc.FLOAT64)


def _decimal_corpus(seed, n=500):
    """Prices, scientific notation, half-up rounding edges, 38-digit values,
    whitespace and junk."""
    rng = np.random.RandomState(seed)
    vals = []
    for _ in range(n):
        r = rng.randint(0, 6)
        if r == 0:
            vals.append(f"{rng.randint(0, 10**6) / 100:.2f}")
        elif r == 1:
            vals.append(f"{rng.uniform(-1e4, 1e4):.{rng.randint(0, 8)}f}")
        elif r == 2:
            vals.append(f"{rng.uniform(1, 10):.4f}e{rng.randint(-12, 12)}")
        elif r == 3:
            vals.append(("-" if rng.rand() < 0.5 else "")
                        + "".join(rng.choice(list("0123456789"), rng.randint(1, 42))))
        elif r == 4:
            vals.append("".join(rng.choice(list("0123456789.eE+- \t"), rng.randint(0, 10))))
        else:
            vals.append(f" {rng.randint(0, 999)}.{rng.randint(0, 99999):05d}5 ")
    vals += ["9" * 38, "-" + "9" * 38, "9" * 39, "1" + "0" * 37, "12345678901234567890.5",
             "9.99", "9.995", "-9.995", "1.25", "-1.35", "1e-3", "0.5e-2", "1.5e2", "15E1",
             "1500e-1", "1e", "1e+", "1e99999999999999999999", "0.000", "", None, ".",
             "\x00 \x1f1\x14", "7.8.3", "  4 "]
    return vals


@pytest.mark.parametrize("precision,scale", [(38, 2), (7, 2), (18, 5), (38, 0), (3, 1),
                                             (12, -2)])
def test_string_to_decimal_equals_jax(precision, scale):
    j, t = _cols(_decimal_corpus(precision * 100 + scale))
    got = tcs.string_to_decimal(t, precision, scale)
    _assert_fixed_equal(got, jcs.string_to_decimal(j, precision, scale))
    assert got.dtype == tc.decimal(precision, scale)


def test_string_to_decimal_no_strip_and_ansi_equal_jax():
    vals = [" 3", "9", "4", "2", "20.5", None, "7.6asd", "5.07 "]
    j, t = _cols(vals)
    _assert_fixed_equal(tcs.string_to_decimal(t, 3, 1, strip=False),
                        jcs.string_to_decimal(j, 3, 1, strip=False))
    with pytest.raises(jcs.CastException) as je:
        jcs.string_to_decimal(j, 3, 1, ansi_mode=True)
    with pytest.raises(tcs.CastException) as te:
        tcs.string_to_decimal(t, 3, 1, ansi_mode=True)
    assert te.value.row_with_error == je.value.row_with_error == 6


def test_string_to_decimal_cast_strings_test_vectors():
    def unscaled(vals, p, s, strip=True):
        col = tcs.string_to_decimal(tc.strings_column(vals, device="cpu"), p, s, strip=strip)
        if hasattr(col, "hi"):
            return col.unscaled_to_list()
        return col.to_list()

    assert unscaled([" 3", "9", "4", "2", "20.5", None, "7.6asd", "\x00 \x1f1\x14"], 2, 0) == [
        3, 9, 4, 2, 21, None, None, 1]
    assert unscaled(["2", "3", " 4 ", "5.07", "9.23", None, "7.8.3"], 3, 1,
                    strip=False) == [20, 30, None, 51, 92, None, None]
    assert unscaled(["1.5e2", "15E1", "1500e-1", "2e0"], 5, 0) == [150, 150, 150, 2]
    assert unscaled(["1.25", "1.35", "-1.25", "-1.35"], 5, 1) == [13, 14, -13, -14]
    assert unscaled(["9.99"], 3, 1) == [100]
    assert unscaled(["123", "1234"], 3, 0) == [123, None]
    assert unscaled(["9" * 38, "-" + "9" * 38], 38, 0) == [int("9" * 38), -int("9" * 38)]
    assert unscaled(["12345678901234567890.5"], 38, 0) == [12345678901234567891]
    empty = tcs.string_to_decimal(tc.strings_column([], device="cpu"), 38, 2)
    assert empty.size == 0 and isinstance(empty, tc.Decimal128Column)


def _base_corpus(seed, n=400):
    rng = np.random.RandomState(seed)
    vals = ["".join(rng.choice(list("0123456789abcdefABCDEFxz- \t\n"), rng.randint(0, 22)))
            for _ in range(n)]
    vals += [None, " ", "", "junk-510junk510", "--510", "   -510junk510", "  510junk510",
             "510", "00510", "00-510", "f", "5a", "-5A", "NzGGImWNRh", "ffffffffffffffff",
             "10000000000000000", "18446744073709551615", "18446744073709551616",
             "-9223372036854775808", "9223372036854775808"]
    return vals


@pytest.mark.parametrize("base", [10, 16])
def test_base_casts_equal_jax(base):
    j, t = _cols(_base_corpus(base))
    got = tcs.to_integers_with_base(t, base)
    want = jcs.to_integers_with_base(j, base)
    assert got.dtype == tc.UINT64
    _assert_fixed_equal(got, want)
    for out_base in (10, 16):
        _assert_strings_equal(tcs.from_integers_with_base(got, out_base),
                              jcs.from_integers_with_base(want, out_base))


@pytest.mark.parametrize("kind", ["INT8", "INT32", "INT64"])
def test_from_integers_with_base_signed_equals_jax(kind):
    jdt, _, np_dt = INT_KINDS[kind]
    info = np.iinfo(np_dt)
    rng = np.random.RandomState(len(kind))
    vals = [int(v) for v in rng.randint(info.min, info.max, 200, dtype=np.int64)]
    vals += [info.min, info.max, 0, -1, 1, 10, -10, None]
    j = jcolumn(vals, jdt)
    t = interop.port_column(j, "cpu")
    for base in (10, 16):
        _assert_strings_equal(tcs.from_integers_with_base(t, base),
                              jcs.from_integers_with_base(j, base))


def test_base_cast_vectors_and_int64_min():
    inp = [None, " ", "junk-510junk510", "--510", "   -510junk510", "  510junk510", "510",
           "00510", "00-510"]
    ints = tcs.to_integers_with_base(tc.strings_column(inp, device="cpu"), 10)
    assert tcs.from_integers_with_base(ints, 10).to_list() == [
        None, None, "0", "0", "18446744073709551106", "510", "510", "510", "0"]
    assert tcs.from_integers_with_base(ints, 16).to_list() == [
        None, None, "0", "0", "FFFFFFFFFFFFFE02", "1FE", "1FE", "1FE", "0"]
    edge = tc.column([-(2**63), 2**63 - 1, -1, 0], tc.INT64, device="cpu")
    assert tcs.from_integers_with_base(edge, 10).to_list() == [
        "-9223372036854775808", "9223372036854775807", "-1", "0"]
    assert tcs.from_integers_with_base(edge, 16).to_list() == [
        "8000000000000000", "7FFFFFFFFFFFFFFF", "FFFFFFFFFFFFFFFF", "0"]
    u = interop.column_from_numpy(np.array([2**64 - 1, 2**63, 10**19 - 1, 10**19],
                                           dtype=np.uint64), None, tc.UINT64, device="cpu")
    assert tcs.from_integers_with_base(u, 10).to_list() == [
        str(2**64 - 1), str(2**63), str(10**19 - 1), str(10**19)]
    with pytest.raises(tcs.CastException):
        tcs.to_integers_with_base(tc.strings_column(["1"], device="cpu"), 8)


# --- the bucket helpers ----------------------------------------------------------


def test_padded_and_mapped_buckets_equal_jax():
    rng = np.random.RandomState(17)
    lens = np.concatenate([rng.randint(0, 40, 300), [0, 1, 31, 32, 33, 64, 65, 300]])
    vals = ["".join(chr(c) for c in rng.randint(33, 127, n)) for n in lens]
    vals[5] = None
    j, t = _cols(vals)
    jb = jbuckets.padded_buckets(j)
    tb = tbuckets.padded_buckets(t)
    assert [b.width for b in tb] == [b.width for b in jb]
    for b_t, b_j in zip(tb, jb):
        nv = b_j.n_valid
        np.testing.assert_array_equal(b_t.rows.numpy(), np.asarray(b_j.rows)[:nv])
        np.testing.assert_array_equal(b_t.bytes.numpy(), np.asarray(b_j.bytes)[:nv])
        np.testing.assert_array_equal(b_t.lengths.numpy(), np.asarray(b_j.lengths)[:nv])

    def kernel(b, ln, v):
        return b[:, 0].to(torch.int32) + ln, v

    got_first, got_valid = tbuckets.map_buckets(t, kernel, [((), torch.int32), ((), torch.bool)],
                                                row_args=[t.is_valid()])
    offs = t.offsets.numpy()
    chars = t.chars.numpy()
    n_bytes = np.diff(offs)
    want = [(int(chars[offs[i]]) if n_bytes[i] else 0) + int(n_bytes[i]) for i in range(len(vals))]
    assert got_first.tolist() == want
    assert got_valid.tolist() == [v is not None for v in vals]

    results = [(b.rows, b.bytes, b.lengths) for b in tb]
    back = tbuckets.strings_from_buckets(t.size, results, t.validity)
    assert back.to_list() == t.to_list()
    assert back.chars.numel() == int(t.offsets[-1])


def test_class_and_length_buckets_equal_jax():
    rng = np.random.RandomState(19)
    classes = rng.randint(0, 4, 500)
    classes[classes == 2] = 3  # an empty class is left out
    got = tbuckets.class_buckets(classes, 4)
    want = jbuckets.class_buckets(classes, 4, round_rows=False)
    assert [c for c, _ in got] == [c for c, _, _ in want] == [0, 1, 3]
    for (_, r_t), (_, r_j, nv) in zip(got, want):
        np.testing.assert_array_equal(r_t, r_j[:nv])
    lens = rng.randint(0, 100, 400)
    for min_width in (1, 4, 32):
        got = tbuckets.length_buckets(torch.from_numpy(lens), min_width)
        want = jbuckets.length_buckets(lens, min_width, round_rows=False)
        assert [w for w, _ in got] == [w for w, _, _ in want]
        for (_, r_t), (_, r_j, _) in zip(got, want):
            np.testing.assert_array_equal(r_t.numpy(), r_j)


def test_map_classes_scatters_each_class_back():
    classes = np.array([2, 0, 2, 1, 0, 2], dtype=np.int8)
    vals = torch.arange(6, dtype=torch.int64) * 10

    def kernel(cid, v):
        return v + cid, torch.full(v.shape, cid, dtype=torch.int32)

    out, cls = tbuckets.map_classes(classes, 3, kernel, [((), torch.int64), ((), torch.int32)],
                                    row_args=[vals])
    assert out.tolist() == [2, 10, 22, 31, 40, 52]
    assert cls.tolist() == classes.tolist()
    one, = tbuckets.map_classes(np.zeros(3, np.int8), 3, lambda c, v: (v * 2,),
                                [((), torch.int64)], row_args=[vals[:3]])
    assert one.tolist() == [0, 20, 40]
