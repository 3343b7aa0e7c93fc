"""The PyTorch port's float <-> string casts (``float_to_string``,
``string_to_float``) against the JAX package on the CPU, every arm.

The port's arms: the torch lane arm, pinned on CPU tensors with
``float_device_render=True`` / ``cast_device_parse=True``; the monolithic
oracle (``float_bucketed=False``); the numpy twin, which ``"auto"`` picks for
CPU tensors.  Seeded corpora (the adversarial ones of
tests/test_straggler_fastpaths.py, rebuilt here) go through each arm and
through the JAX package; tolerance 0: FLOAT bit patterns, chars, offsets,
validity and ANSI error rows.  The reference gtest vectors
(tests/test_float_to_string.py, tests/test_cast_string_to_float.py) are held
on every arm.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import FLOAT32 as JF32
from spark_rapids_jni_tpu.columnar import FLOAT64 as JF64
from spark_rapids_jni_tpu.columnar.column import strings_column as jstrings_column
from spark_rapids_jni_tpu.ops import cast_string_to_float as js2f
from spark_rapids_jni_tpu.ops.cast_string import CastException as JCastException
from spark_rapids_jni_tpu.ops.float_to_string import float_to_string as jfloat_to_string
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch import config, interop
from spark_rapids_jni_tpu_torch.ops import cast_string_to_float as ts2f
from spark_rapids_jni_tpu_torch.ops.cast_string import CastException

# the package's ``float_to_string`` attribute is the function of that name
tf2s = importlib.import_module("spark_rapids_jni_tpu_torch.ops.float_to_string")

F2S_ARMS = {
    "lane": dict(float_device_render=True, float_bucketed=True),
    "oracle": dict(float_device_render=True, float_bucketed=False),
    "twin": dict(float_device_render="auto"),
}
S2F_ARMS = {"lane": dict(cast_device_parse=True), "twin": dict(cast_device_parse="auto")}


def _f64_bits_corpus():
    """Adversarial FLOAT64 bit patterns: subnormals, +-0, exponent edges,
    17-digit round-trip values, random bits (NaN payloads included)."""
    rng = np.random.RandomState(2020)
    vals = [0.0, -0.0, 1.0, -1.0, 0.5, 1.5, 1e-310, -1e-310, 5e-324, -5e-324,
            2.2250738585072014e-308, 1e291, 1e-291, 9.999999999999999e290,
            1.0000000000000002e-291, 1e308, 1.7976931348623157e308, -1e-308, 1e-3, 0.001,
            0.0009999999999999998, 1e7, 9999999.0, 10000000.0, 0.1, 0.2,
            0.30000000000000004, 1 / 3, 123456789012345.6, 1.2345678901234567e16,
            float("inf"), float("-inf"), float("nan")]
    bits = np.array(vals, dtype=np.float64).view(np.int64)
    extra = rng.randint(-(2**63), 2**63, size=1500, dtype=np.int64)
    sub = rng.randint(0, 1 << 52, size=64, dtype=np.int64)  # exponent field 0
    top = (np.int64(0x7FE) << np.int64(52)) | rng.randint(0, 1 << 52, size=64, dtype=np.int64)
    # the value classes the card's phase draws: wide magnitudes, prices, integers
    wide = rng.rand(300) * np.exp(rng.uniform(-30, 30, 300))
    prices = np.round(rng.rand(200) * 1000, 2)
    ints = rng.randint(1, 10**7, 200).astype(np.float64)
    return np.concatenate([bits, extra, sub, top, -sub, top | np.int64(-2**63),
                           np.concatenate([wide, prices, ints]).view(np.int64)])


def _f32_bits_corpus():
    rng = np.random.RandomState(7)
    return np.concatenate([
        _f64_bits_corpus().view(np.uint64).astype(np.uint32).view(np.int32),
        rng.randint(-(2**31), 2**31, size=512).astype(np.int32),
        np.array([0, -2**31, 1, 0x7F800000, -8388608, 0x00000001, 0x007FFFFF, 0x7F7FFFFF],
                 dtype=np.int32)])


def _s2f_text_corpus():
    """Adversarial parse strings: truncation (19+ digits), exponent edges,
    whitespace and control quirks, junk, empties, nulls."""
    rng = np.random.RandomState(2021)
    vals = [
        "0", "-0", "0.0", "-0.0", "1", "-1", ".5", "5.", "+3",
        "1e291", "-1e291", "1e-291", "1e292", "1e-292", "1e308", "-1e308",
        "1e309", "1e-309", "1e-310", "4.9e-324", "1e-324", "1e-400", "1e400",
        "17976931348623157e292", "9999999999999999999", "18446744073709551609",
        "18446744073709551610", "-18446744073709551609", "184467440737095516091234",
        "0.01234567890123456789", "0." + "0" * 30 + "123456789012345678901234",
        "123456789012345678.99e-10", "nan", "NaN", "-nan", "inf", "-inf", "Infinity",
        "-Infinity", "+inf", " inf", "\riNf", "infinity7", "infx", "INFINITY", "iNfInItY",
        "7f", "8d", "0f", "0d", "0 ", "1.3e+7f", "46037e\t", "2F.", "", ".", "e", "E15", "A",
        "null", "na7.62", "--1", "1..2", "1e", "1e+", "1e-", "1.5e3e4", "0x1p3",
        " " * 36 + "7d", "1.1\x00", "1.2\x14", "1.6\x9f", "1.7!", "1e12345", "-1.5E-0010",
        None, None,
    ]
    for _ in range(600):
        ndig = rng.randint(1, 26)
        digs = "".join(rng.choice(list("0123456789"), ndig))
        point = rng.randint(0, ndig + 1)
        s = digs[:point] + "." + digs[point:] if rng.rand() < 0.6 else digs
        if rng.rand() < 0.6:
            s += "e" + str(rng.choice(["", "+", "-"])) + str(rng.randint(0, 330))
        if rng.rand() < 0.5:
            s = "-" + s
        if rng.rand() < 0.1:
            s = " \t"[rng.randint(0, 2)] + s + rng.choice(["f", "D", " ", ""])
        vals.append(s)
    for _ in range(200):  # pure junk
        vals.append("".join(rng.choice(list("0123456789.eE+-fdx \t\rZ"), 10)))
    return vals


def _logical(col):
    """(offsets, chars, validity) of a string column of either package."""
    offs = np.asarray(col.offsets.cpu() if isinstance(col.offsets, torch.Tensor) else col.offsets)
    chars = col.chars.cpu().numpy() if isinstance(col.chars, torch.Tensor) else \
        np.asarray(col.chars)
    valid = col.is_valid()
    valid = valid.cpu().numpy() if isinstance(valid, torch.Tensor) else np.asarray(valid)
    return offs.tolist(), chars[: offs[-1]].tobytes(), valid.tolist()


def _f2s_arms(tcol):
    out = {}
    for name, flags in F2S_ARMS.items():
        with config.override(**flags):
            res = tf2s.float_to_string(tcol)
        assert res.chars.numel() == int(res.offsets[-1])  # exact, no over-allocation
        out[name] = _logical(res)
    return out


def _jax_f64(bits, validity=None):
    return JColumn(jnp.asarray(bits), None if validity is None else jnp.asarray(validity), JF64)


@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_float_to_string_every_arm_equals_jax(kind):
    if kind == "f64":
        jcol = _jax_f64(_f64_bits_corpus())
    else:
        jcol = JColumn(jnp.asarray(_f32_bits_corpus().view(np.float32)), None, JF32)
    want = _logical(jfloat_to_string(jcol))
    arms = _f2s_arms(interop.port_column(jcol, "cpu"))
    for name, got in arms.items():
        assert got == want, name


def test_float_to_string_null_dense_empty_and_boundaries():
    rng = np.random.RandomState(3)
    bits = _f64_bits_corpus()[:512]
    validity = rng.rand(bits.size) > 0.9  # 90% null
    jcol = _jax_f64(bits, validity)
    want = _logical(jfloat_to_string(jcol))
    for got in _f2s_arms(interop.port_column(jcol, "cpu")).values():
        assert got == want
    empty = tc.Column(torch.zeros(0, dtype=torch.int64), None, tc.FLOAT64)
    for got in _f2s_arms(empty).values():
        assert got == ([0], b"", [])
    # values straddling every classifier boundary: the simple-integer
    # cutoffs, the scientific switch at 1e-3 / 1e7, 16/17-digit output
    vals = []
    for e in (-4, -3, -2, 6, 7, 8):
        v = 10.0 ** e
        vals += [v, np.nextafter(v, 0), np.nextafter(v, np.inf), -v]
    vals += [9999999.999999998, 1e16 - 2, 1e16, 1.5, 2.0, 1024.0, 0.001953125, 123.25, -8.0,
             65536.0, 9007199254740992.0, 9007199254740993.0, 1e7 - 1, 1e7 + 1]
    jcol = _jax_f64(np.array(vals, dtype=np.float64).view(np.int64))
    want = _logical(jfloat_to_string(jcol))
    for got in _f2s_arms(interop.port_column(jcol, "cpu")).values():
        assert got == want


def test_float_to_string_gtest_vectors_on_every_arm():
    cases = [
        (tc.FLOAT32, [100.0, 654321.25, -12761.125, 0.0, 5.0, -4.0, float("nan"),
                      123456789012.34, -0.0],
         ["100.0", "654321.25", "-12761.125", "0.0", "5.0", "-4.0", "NaN", "1.2345679E11",
          "-0.0"]),
        (tc.FLOAT64, [100.0, 654321.25, -12761.125, 1.123456789123456789,
                      0.000000000000000000123456789123456789, 0.0, 5.0, -4.0, float("nan"),
                      839542223232.794248339, -0.0],
         ["100.0", "654321.25", "-12761.125", "1.1234567891234568", "1.234567891234568E-19",
          "0.0", "5.0", "-4.0", "NaN", "8.395422232327942E11", "-0.0"]),
        (tc.FLOAT64, [float("inf"), float("-inf"), 1e7, 9999999.0, 1e-3, 9.0e-4, 5e-324,
                      1.7976931348623157e308, 2.2250738585072014e-308, 1.5, None],
         ["Infinity", "-Infinity", "1.0E7", "9999999.0", "0.001", "9.0E-4", "5.0E-324",
          "1.7976931348623157E308", "2.2250738585072014E-308", "1.5", None]),
    ]
    for dtype, vals, want in cases:
        col = tc.column(vals, dtype, device="cpu")
        for name, flags in F2S_ARMS.items():
            with config.override(**flags):
                assert tf2s.float_to_string(col).to_list() == want, name
    with pytest.raises(TypeError):
        tf2s.float_to_string(tc.column([1], tc.INT32, device="cpu"))


def _s2f_bits(col, dtype):
    data = col.data.numpy()
    return data.view(np.int32) if dtype.kind == tc.FLOAT32.kind else data


@pytest.mark.parametrize("dtype", ["FLOAT64", "FLOAT32"])
def test_string_to_float_every_arm_equals_jax(dtype):
    tdt, jdt = (tc.FLOAT64, JF64) if dtype == "FLOAT64" else (tc.FLOAT32, JF32)
    jcol = jstrings_column(_s2f_text_corpus())
    want = js2f.string_to_float(jcol, False, jdt)
    w_data = np.asarray(want.data)
    w_data = w_data.view(np.int32) if dtype == "FLOAT32" else w_data
    tcol = interop.port_column(jcol, "cpu")
    for name, flags in S2F_ARMS.items():
        with config.override(**flags):
            got = ts2f.string_to_float(tcol, False, tdt)
        assert got.dtype == tdt
        assert got.data.dtype == (torch.float32 if dtype == "FLOAT32" else torch.int64)
        np.testing.assert_array_equal(got.is_valid().numpy(), np.asarray(want.is_valid()))
        np.testing.assert_array_equal(_s2f_bits(got, tdt), w_data, err_msg=name)


def test_string_to_float_ansi_row_on_every_arm_and_jax():
    rng = np.random.RandomState(31)
    vals = [f"{v:.6f}" for v in rng.uniform(-1e6, 1e6, 300)]
    bad = int(rng.randint(0, 300))
    vals[bad] = "1.5x"
    vals[bad + 1:bad + 1] = ["infx"]  # null without an ANSI error (check_for_inf quirk)
    jcol = jstrings_column(vals)
    with pytest.raises(JCastException) as je:
        js2f.string_to_float(jcol, True, JF64)
    tcol = interop.port_column(jcol, "cpu")
    for flags in S2F_ARMS.values():
        with config.override(**flags), pytest.raises(CastException) as te:
            ts2f.string_to_float(tcol, True, tc.FLOAT64)
        assert (te.value.row_with_error, te.value.string_with_error) == (
            je.value.row_with_error, je.value.string_with_error) == (bad, "1.5x")
    ok = tc.strings_column(["1.5", "infx", None], device="cpu")
    for flags in S2F_ARMS.values():
        with config.override(**flags):
            assert ts2f.string_to_float(ok, True, tc.FLOAT64).to_list() == [1.5, None, None]


def test_string_to_float_gtest_vectors_on_every_arm():
    tricky = ["7f", "\riNf", "1.3e5ef", "1.3e+7f", "9\n", "46037e\t", "8d", "0\n", ".\r",
              "2F.", " " * 36 + "7d", " " * 28 + "98392.5e-1f", ".", "e",
              "-1.6721969836937668E-304", "-2.21363921575273728E17", "0",
              "00000000000000000000", "-0000000000000000000E0", "0000000000000000000E0",
              "0000000000000000000000000000000017", "18446744073709551609"]
    expected = [7.0, math.inf, None, 13000000.0, 9.0, None, 8.0, 0.0, None, None, 7.0,
                9839.25, None, None, None, -2.21363921575273728e17, 0.0, 0.0, -0.0, 0.0, 17.0,
                18446744073709551609.0]
    simple = ["-1.8946e-10", "0001", "0000.123", "123", "123.45", "45.123", "-45.123",
              "0.45123", "-0.45123"]
    for flags in S2F_ARMS.values():
        with config.override(**flags):
            got = ts2f.string_to_float(tc.strings_column(tricky, device="cpu"), False,
                                       tc.FLOAT64).to_list()
            # row 14: CUDA's exp10(-291) is 1 ulp below the table's value
            w14 = -1.6721969836937668e-304
            assert abs(got[14] - w14) <= abs(w14 - np.nextafter(w14, 0)) * 2
            got[14] = None
            assert got == expected
            assert math.copysign(1.0, got[18]) == -1.0
            got = ts2f.string_to_float(tc.strings_column(simple, device="cpu"), False,
                                       tc.FLOAT64).to_list()
            assert got == [float(s) for s in simple]
            got = ts2f.string_to_float(tc.strings_column(
                ["NaN", "-Infinity", "inf", "-nan", "A", "null", "", "f", "infinity7",
                 "0f", "0 ", "1.1\x00", "1.6\x9f", "1e-310", "1e-400"], device="cpu"),
                False, tc.FLOAT64).to_list()
            assert math.isnan(got[0])
            assert got[1:] == [-math.inf, math.inf, None, None, None, None, None, None, None,
                               0.0, 1.1, None, 1e-310, 0.0]
            got = ts2f.string_to_float(tc.strings_column(
                ["1.5", "3.5e38", "7f"], device="cpu"), False, tc.FLOAT32).to_list()
            assert got == [1.5, math.inf, 7.0]
    with pytest.raises(TypeError):
        ts2f.string_to_float(tc.strings_column(["1"], device="cpu"), False, tc.INT32)


def test_scan_fields_equal_jax_and_the_twins_across_bucket_widths():
    """The lane scan (``_scan_padded``, kept for the JSON family) gives the
    JAX package's fields on one rectangle; the bucketed twin ``_scan_np``,
    its monolithic ``_scan_rect_np`` and the pinned ``_scan_padded_np``
    agree on strings straddling every pow2 bucket width."""
    rng = np.random.RandomState(11)
    vals = []
    for width in (1, 2, 3, 4, 7, 8, 9, 15, 16, 17, 31, 32, 33):
        for _ in range(8):
            digs = "".join(rng.choice(list("0123456789"), width))
            vals.append(digs[: max(1, width)])
            vals.append(("-" + digs)[:width] if width > 1 else digs)
            if width > 4:
                vals.append(digs[: width - 4] + "e" + str(rng.randint(0, 99)))
    vals += _s2f_text_corpus()[:120]
    tcol = tc.strings_column([v or "" for v in vals], device="cpu")
    padded, lens = tcol.padded()
    j_fields = js2f._scan_padded(jnp.asarray(padded.numpy()), jnp.asarray(lens.numpy()))
    t_fields = ts2f._scan_padded(padded, lens)
    for (name, _), g, w in zip(ts2f._SCAN_FIELDS, t_fields, j_fields):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(g.numpy().dtype),
                                      err_msg=name)
    bucketed = ts2f._scan_np(tcol)
    mono = ts2f._scan_rect_np(padded.numpy(), lens.numpy())
    twin = ts2f._scan_padded_np(padded.numpy(), lens.numpy())
    lane = ts2f._scan(tcol)
    for k, dt in ts2f._SCAN_FIELDS_NP.items():
        assert (bucketed[k] == mono[k].astype(dt)).all(), k
        assert (bucketed[k] == twin[k].astype(dt)).all(), k
        assert (lane[k].numpy().view(np.dtype(dt)) == bucketed[k]).all(), k


def test_lane_assembly_equals_the_hardware_twin():
    """The integer-softfloat assembly equals the hardware-binary64 twin bit
    for bit on the same fields, and the FLOAT32 ends agree."""
    rng = np.random.RandomState(77)
    vals = []
    for _ in range(400):
        choice = rng.randint(0, 6)
        if choice == 0:
            vals.append(str(rng.randint(-10**18, 10**18)))
        elif choice == 1:
            vals.append(f"{rng.uniform(-1e3, 1e3):.12f}")
        elif choice == 2:
            vals.append(f"{rng.uniform(1, 10):.15f}e{rng.randint(-330, 320)}")
        elif choice == 3:
            vals.append("0." + "0" * rng.randint(0, 25) + str(rng.randint(1, 10**9)))
        elif choice == 4:
            vals.append(str(rng.randint(1, 10**9)) + str(rng.randint(0, 10**16)).zfill(16))
        else:
            vals.append(rng.choice(["nan", "inf", "-infinity", "+inf", " inf", "x"]))
    f = ts2f._scan(tc.strings_column(vals, device="cpu"))
    bits, valid, exc = ts2f._assemble_device(f)
    for out_np in (np.float64, np.float32):
        out, valid_h, exc_h = ts2f._assemble({k: v.numpy() for k, v in f.items()
                                              if k not in ("val19", "d20")} | {
            "val19": f["val19"].numpy().view(np.uint64),
            "d20": f["d20"].numpy().view(np.uint64)}, out_np)
        np.testing.assert_array_equal(valid.numpy(), valid_h)
        np.testing.assert_array_equal(exc.numpy(), exc_h)
        if out_np is np.float64:
            np.testing.assert_array_equal(bits.numpy(), out.view(np.int64))
        else:
            f32 = ts2f.f64_bits_to_f32_bits(bits).numpy()
            np.testing.assert_array_equal(f32, out.view(np.int32))


def test_round_trip_whole_slice_equals_jax():
    """A FLOAT64 column through float_to_string and back through
    string_to_float, in both packages, on every arm: the same strings, the
    same bits.  Not every row comes back exact: the reference's parse is not
    correctly rounded at 17 digits and extreme exponents."""
    bits = _f64_bits_corpus()
    jcol = _jax_f64(bits)
    j_str = jfloat_to_string(jcol)
    j_back = np.asarray(js2f.string_to_float(j_str, False, JF64).data)
    tcol = interop.port_column(jcol, "cpu")
    for f_flags, s_flags in zip(F2S_ARMS.values(), list(S2F_ARMS.values()) * 2):
        with config.override(**f_flags, **s_flags):
            t_str = tf2s.float_to_string(tcol)
            t_back = ts2f.string_to_float(t_str, False, tc.FLOAT64).data.numpy()
        assert _logical(t_str) == _logical(j_str)
        np.testing.assert_array_equal(t_back, j_back)
    # prices and integers (<= 15 digits, small exponents: one exact IEEE op
    # in the parse) come back exact; the corpus ends with 400 of them
    np.testing.assert_array_equal(t_back[-400:], bits[-400:])


def test_auto_picks_the_arm_by_device_and_never_falls_back(monkeypatch):
    cuda = torch.device("cuda")
    with config.override(cast_device_parse="auto", float_device_render="auto"):
        assert ts2f._device_parse_enabled(cuda) and tf2s._device_render_enabled(cuda)
        assert not ts2f._device_parse_enabled(torch.device("cpu"))
        assert not tf2s._device_render_enabled(torch.device("cpu"))
    with config.override(cast_device_parse=False, float_device_render=False):
        assert not ts2f._device_parse_enabled(cuda) and not tf2s._device_render_enabled(cuda)

    def boom(*a, **k):
        raise RuntimeError("arm failed")

    scol = tc.strings_column(["1.5"], device="cpu")
    fcol = tc.column([1.5], tc.FLOAT64, device="cpu")
    monkeypatch.setattr(ts2f, "_scan_np", boom)
    monkeypatch.setattr(tf2s, "_render_host", boom)
    with config.override(cast_device_parse="auto", float_device_render="auto"):
        with pytest.raises(RuntimeError, match="arm failed"):
            ts2f.string_to_float(scol, False, tc.FLOAT64)
        with pytest.raises(RuntimeError, match="arm failed"):
            tf2s.float_to_string(fcol)
    with config.override(cast_device_parse=True, float_device_render=True):
        assert ts2f.string_to_float(scol, False, tc.FLOAT64).to_list() == [1.5]
        assert tf2s.float_to_string(fcol).to_list() == ["1.5"]
    monkeypatch.setattr(ts2f, "_scan", boom)
    monkeypatch.setattr(tf2s, "_render_device", boom)
    with config.override(cast_device_parse=True, float_device_render=True):
        with pytest.raises(RuntimeError, match="arm failed"):
            ts2f.string_to_float(scol, False, tc.FLOAT64)
        with pytest.raises(RuntimeError, match="arm failed"):
            tf2s.float_to_string(fcol)
