"""The PyTorch port's JCUDF row conversion, bitmask and float-bit helpers
against the JAX package, on the CPU.

Tables are drawn from seeds (numpy, python's ``random``) and handed to both
packages; every comparison is bit-exact (tolerance 0): row bytes, row
offsets, batch boundaries, and the columns read back (values, DECIMAL words,
FLOAT64 bits, validity).  The JAX package runs its default arm on the CPU
(the numpy host arm); the port runs all three of its arms on the same CPU
tensors: the host arm (``rows_device_path="auto"`` on CPU tensors), the
device arm (forced with ``rows_device_path=True``) and the scatter-chain
oracle (``rows_plan_cache=False``).
"""

import math
import random
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import columnar as jc
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.utils import bitmask as jbm
from spark_rapids_jni_tpu.utils import floatbits as jfb
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch import config, interop
from spark_rapids_jni_tpu_torch.ops import (
    convert_from_rows,
    convert_from_rows_fixed_width_optimized,
    convert_to_rows,
    convert_to_rows_fixed_width_optimized,
)
from spark_rapids_jni_tpu_torch.ops import row_conversion as trc
from spark_rapids_jni_tpu_torch.utils import bitmask, floatbits

ARMS = {
    "host": {},
    "device": {"rows_device_path": True},
    "oracle": {"rows_plan_cache": False},
}


def _f64_bits(rng, n):
    """FLOAT64 values as bits: specials (NaN payloads, -0.0, infinities,
    subnormals) first, then random bit patterns."""
    specials = [0x7FF8000000000001, 0xFFF0000000000000, 0x8000000000000000, 0,
                0x7FF0000000000000, 0x0000000000000001, 0x7FF4000000000000]
    bits = specials + [rng.getrandbits(64) for _ in range(n - len(specials))]
    return np.array(bits, dtype=np.uint64).view(np.int64)


def _table(seed, n, kinds, null_frac=0.1):
    """A JAX column per kind name, drawn from ``seed``."""
    rng = random.Random(seed)
    cols = []
    for kind in kinds:
        valid = np.array([rng.random() >= null_frac for _ in range(n)])
        if kind == "string":
            words = ["", "a", "héllo", "x" * 40, "JCUDF\x00row", "é中"]
            vals = [rng.choice(words) + str(rng.randrange(1000)) * rng.randrange(3)
                    for _ in range(n)]
            cols.append(jc.strings_column([v if ok else None for v, ok in zip(vals, valid)]))
            continue
        if kind == "decimal128":
            vals = [rng.choice([0, 1, -1, 10**38 - 1, -(10**38) + 1, (1 << 127) - 1])
                    if i < 6 else rng.randrange(-(10**38), 10**38) for i in range(n)]
            cols.append(jc.decimal128_column(
                [v if ok else None for v, ok in zip(vals, valid)], 38, 2))
            continue
        if kind == "float64":
            data = _f64_bits(rng, n)
            dtype = jc.FLOAT64
        elif kind == "float32":
            data = np.array([0x7FC00001, 0xFF800000, 0x80000000] +
                            [rng.getrandbits(32) for _ in range(n - 3)],
                            dtype=np.uint32).view(np.float32)
            dtype = jc.FLOAT32
        elif kind == "bool":
            data, dtype = np.array([rng.random() < 0.5 for _ in range(n)]), jc.BOOL
        else:
            dtype = {"int8": jc.INT8, "int16": jc.INT16, "int32": jc.INT32,
                     "int64": jc.INT64, "date32": jc.DATE32,
                     "timestamp": jc.TIMESTAMP_MICROS,
                     "decimal32": jc.decimal(7, 2), "decimal64": jc.decimal(15, 3)}[kind]
            width = dtype.fixed_width * 8
            data = np.array([rng.randrange(-(1 << (width - 1)), 1 << (width - 1))
                             for _ in range(n)], dtype=np.dtype(dtype.jnp_dtype))
        cols.append(jc.Column(jnp.asarray(data), jnp.asarray(valid), dtype))
    return cols


def _rows_np(batches):
    """Each batch's (offsets, row bytes) as numpy (either package; a JAX
    batch's child may be longer than its last offset)."""
    out = []
    for b in batches:
        if isinstance(b, tc.ListColumn):
            out.append((b.offsets.numpy(), b.child.data.numpy()))
        else:
            offs = np.asarray(b.offsets)
            out.append((offs, np.asarray(b.child.data)[: int(offs[-1])]))
    return out


def _assert_same_rows(got, want):
    g, w = _rows_np(got), _rows_np(want)
    assert len(g) == len(w)
    for (go, gd), (wo, wd) in zip(g, w):
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gd, wd)


def _assert_same_columns(got, want):
    """Port columns equal (field by field, validity included) to columns of
    either package."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = interop.port_column(w, "cpu") if not isinstance(w, type(g)) else w
        assert g.dtype == w.dtype
        gf, wf = interop.column_to_numpy(g), interop.column_to_numpy(w)
        for a, b in zip(gf, wf):
            if b is None:  # an all-valid input reads back as all-True validity
                assert a is None or bool(np.all(a))
            else:
                np.testing.assert_array_equal(a, b)


def _convert_both(jcols, arm, **kw):
    tcols = [interop.port_column(c, "cpu") for c in jcols]
    with config.override(**ARMS[arm]):
        got = convert_to_rows(tcols, **kw)
        back = [convert_from_rows(b, [c.dtype for c in tcols]) for b in got]
    return tcols, got, back


SCHEMAS = {
    "fixed_width": ["bool", "int8", "int16", "int32", "int64", "float32", "float64",
                    "date32", "timestamp"],
    "decimal128": ["int32", "decimal128", "int8", "decimal128"],
    "decimal32_64": ["decimal32", "int8", "decimal64", "decimal32"],
    "strings": ["int32", "string", "decimal128", "string", "bool"],
    "many_columns": ["int8", "string", "int64", "int16", "decimal32", "float64", "bool",
                     "int32", "string", "decimal128", "int8", "float32"],
}


@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_rows_equal_jax_and_round_trip(schema, arm):
    jcols = _table(sorted(SCHEMAS).index(schema), 150, SCHEMAS[schema])
    tcols, got, back = _convert_both(jcols, arm)
    want = jrc.convert_to_rows(jcols)
    _assert_same_rows(got, want)
    assert all(o % 8 == 0 for b in got for o in b.offsets.tolist())
    (tback,) = back
    _assert_same_columns(tback, tcols)
    _assert_same_columns(tback, jrc.convert_from_rows(want[0], [c.dtype for c in jcols]))


def test_compute_layout_equals_jax_for_the_smoke_schemas():
    store_sales = [tc.INT32] * 9 + [tc.INT64, tc.INT32] + [tc.decimal(7, 2)] * 12
    keys_strings = [tc.INT32, tc.STRING, tc.decimal(38, 2)]
    j_store_sales = [jc.INT32] * 9 + [jc.INT64, jc.INT32] + [jc.decimal(7, 2)] * 12
    j_keys_strings = [jc.INT32, jc.STRING, jc.decimal(38, 2)]
    assert trc.compute_layout(store_sales) == jrc.compute_layout(j_store_sales)
    assert trc.compute_layout(store_sales)[3] == 103
    assert trc.compute_layout(keys_strings) == jrc.compute_layout(j_keys_strings)
    assert trc.compute_layout(keys_strings)[3] == 33
    assert trc.compute_layout([tc.BOOL, tc.INT16, tc.INT32]) == ([0, 2, 4], [1, 2, 4], 8, 9)
    with pytest.raises(TypeError, match="Unsupported"):
        trc.compute_layout([tc.LIST])


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_batching_on_32_row_boundaries_equals_jax(arm):
    jcols = _table(7, 300, ["int32", "string", "int64"], null_frac=0.2)
    _, got, back = _convert_both(jcols, arm, max_batch_bytes=2048)
    want = jrc.convert_to_rows(jcols, max_batch_bytes=2048)
    _assert_same_rows(got, want)
    sizes = [b.size for b in got]
    assert len(sizes) > 2 and all(s % 32 == 0 for s in sizes[:-1]) and sum(sizes) == 300
    tcols = [interop.port_column(c, "cpu") for c in jcols]
    for c, col in enumerate(tcols):
        assert sum((b[c].to_list() for b in back), []) == col.to_list()


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_batching_exact_fit_and_fixed_width_batches(arm):
    col = tc.column(list(range(100)), tc.INT64, "cpu")  # 16-byte rows
    with config.override(**ARMS[arm]):
        assert [b.size for b in convert_to_rows([col], max_batch_bytes=16 * 32)] == \
            [32, 32, 32, 4]
        batches = convert_to_rows([col], max_batch_bytes=16 * 40)
        assert [b.size for b in batches] == [32, 32, 36]
        got = sum((convert_from_rows(b, [tc.INT64])[0].to_list() for b in batches), [])
    assert got == list(range(100))
    j = jrc.convert_to_rows([jc.column(list(range(100)), jc.INT64)], max_batch_bytes=16 * 40)
    _assert_same_rows(batches, j)


def test_row_size_and_fixed_width_errors():
    with pytest.raises(ValueError, match="larger than the maximum batch"):
        convert_to_rows([tc.column([1, 2], tc.INT64, "cpu")], max_batch_bytes=8)
    with pytest.raises(ValueError, match="at least one column"):
        convert_to_rows([])
    with pytest.raises(TypeError, match="fixed width"):
        convert_to_rows_fixed_width_optimized([tc.strings_column(["a"], "cpu")])
    with pytest.raises(TypeError, match="fixed width"):
        convert_from_rows_fixed_width_optimized(None, [tc.STRING])
    with pytest.raises(ValueError, match="Too many columns"):
        convert_to_rows_fixed_width_optimized([tc.column([1], tc.INT32, "cpu")] * 100)
    with pytest.raises(ValueError, match="too large"):
        convert_to_rows_fixed_width_optimized([tc.decimal128_column([1], 38, 0, "cpu")] * 64)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_fixed_width_optimized_equals_jax(arm):
    jcols = _table(9, 90, ["int32", "int64", "decimal32", "float64", "int16"])
    tcols = [interop.port_column(c, "cpu") for c in jcols]
    with config.override(**ARMS[arm]):
        got = convert_to_rows_fixed_width_optimized(tcols)
        back = convert_from_rows_fixed_width_optimized(got[0], [c.dtype for c in tcols])
    want = jrc.convert_to_rows_fixed_width_optimized(jcols)
    _assert_same_rows(got, want)
    _assert_same_columns(back, tcols)


def test_plan_is_shared_and_device_copies_cached_per_device():
    dtypes = [tc.INT32, tc.STRING]
    plan = trc._get_row_plan(dtypes, 100)
    assert trc._get_row_plan(dtypes, 120) is plan  # the same pow2 bucket
    perm, keep = trc._plan_tensors(plan, torch.device("cpu"))
    assert trc._plan_tensors(plan, torch.device("cpu"))[0] is perm
    np.testing.assert_array_equal(perm.numpy(), plan["perm"])
    jplan = jrc._build_row_plan(jrc._row_plan_sig([jc.INT32, jc.STRING]))
    np.testing.assert_array_equal(plan["perm"], jplan["perm"])
    np.testing.assert_array_equal(plan["keep"], jplan["keep"])


def test_phases_accumulate():
    trc.PHASES.reset()
    convert_to_rows([tc.column([1, 2, 3], tc.INT32, "cpu")])
    snap = trc.PHASES.snapshot()
    assert set(snap) == {"plan", "lanes", "gather", "emit"} and snap["gather"] > 0


# --- bitmask and floatbits -----------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64, 333])
def test_bitmask_equals_jax(n):
    rng = np.random.RandomState(n)
    mask = rng.rand(n) < 0.5
    packed = bitmask.pack_bits(torch.from_numpy(mask))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jbm.pack_bits(jnp.asarray(mask))))
    np.testing.assert_array_equal(bitmask.unpack_bits(packed, n).numpy(), mask)
    other = rng.randint(0, 256, packed.numel()).astype(np.uint8)
    for fn in ("bitmask_or", "bitmask_and"):
        got = getattr(bitmask, fn)([packed, torch.from_numpy(other)])
        want = getattr(jbm, fn)([jnp.asarray(packed.numpy()), jnp.asarray(other)])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_floatbits_equal_jax_with_nan_payloads_and_negative_zero():
    bits64 = _f64_bits(random.Random(4), 64)
    f64 = floatbits.bits_to_f64(torch.from_numpy(bits64))
    np.testing.assert_array_equal(floatbits.f64_to_bits(f64).numpy(), bits64)
    np.testing.assert_array_equal(
        np.asarray(jfb.f64_to_bits(jfb.bits_to_f64(jnp.asarray(bits64)))), bits64)
    assert math.copysign(1.0, float(f64[2])) == -1.0 and math.isnan(float(f64[0]))
    bits32 = np.array([0x7FC00001, 0x7F800001, 0x80000000, 0, 0x3F800000, 0xFF800000],
                      dtype=np.uint32).view(np.int32)
    f32 = floatbits.bits_to_f32(torch.from_numpy(bits32))
    np.testing.assert_array_equal(floatbits.f32_to_bits(f32).numpy(), bits32)
    np.testing.assert_array_equal(
        np.asarray(jfb.f32_to_bits(jfb.bits_to_f32(jnp.asarray(bits32)))), bits32)
    assert struct.pack("<f", float(f32[4])) == struct.pack("<I", 0x3F800000)
