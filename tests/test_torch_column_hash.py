"""The PyTorch port's column hash over strings, binary, decimal128, structs and
lists, against the JAX package and Spark's vectors, on the CPU.

Inputs are seeded (numpy, or python's ``random`` where ``tests/test_hash.py``
draws its own) and handed to both packages; every comparison is bit-exact
(tolerance 0: integer hashing).  The JAX side runs under the ``xla`` hash
backend and, for a few small cases, under ``pallas`` (Pallas interpret mode
off-TPU, 0.5-3.5 s a call).  The port's ``mm_hash_bytes`` wrapper takes its
plain PyTorch version here because the tensors lie on the CPU; the CUDA kernel
itself is held against that plain version on the card by ``chip_smoke.py``.
"""

import random
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import columnar as jc
from spark_rapids_jni_tpu import config
from spark_rapids_jni_tpu.columnar.buckets import length_buckets as jax_length_buckets
from spark_rapids_jni_tpu.ops import hashing as jh
from spark_rapids_jni_tpu.ops import murmur_hash32 as jax_murmur_hash32
from spark_rapids_jni_tpu.ops import xxhash64 as jax_xxhash64
from spark_rapids_jni_tpu.ops.hash_pallas import mm_bytes_words_pallas
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.columnar.buckets import length_buckets
from spark_rapids_jni_tpu_torch.ops import hash_cuda, hashing, murmur_hash32, xxhash64

import spark_oracles as oracle

LONG_STR = (
    "A very long (greater than 128 bytes/char string) to test a multi hash-step data point "
    "in the MD5 hash function. This string needed to be longer.A 60 character string to "
    "test MD5's message padding algorithm"
)
MIXED_LONG_STR = (
    "A very long (greater than 128 bytes/char string) to test a multi hash-step data point "
    "in the MD5 hash function. This string needed to be longer."
)
DEC128 = [0, 1, -1, 255, -255, 10**20, -(10**20), (1 << 127) - 1, -(1 << 127),
          0x00FF, 0x7F, -0x80, -0x100, 12345678901234567890123456789012345678]


def _t(a):
    return interop.tensor_from_numpy(a, "cpu")


def _f32(bits):
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _f64(bits):
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


# --- (a) the byte-string contribution against the JAX word kernel + tail -----


def _spans(rows, gaps):
    """(chars, starts, lens) with ``gaps[i]`` filler bytes before row i, or,
    where ``gaps`` is None, with the fewest filler bytes that start every row
    off a 4-byte boundary."""
    chars, starts = bytearray(), []
    for i, row in enumerate(rows):
        gap = gaps[i] if gaps is not None else 1 + ((len(chars) + 1) % 4 == 0)
        chars += b"\xa5" * gap
        starts.append(len(chars))
        chars += row
    return (np.frombuffer(bytes(chars), np.uint8), np.array(starts, np.int32),
            np.array([len(r) for r in rows], np.int32))


def _padded(rows):
    out = np.zeros((len(rows), max(1, max(len(r) for r in rows))), np.uint8)
    for i, r in enumerate(rows):
        out[i, :len(r)] = np.frombuffer(r, np.uint8)
    return out


def _byte_rows(case):
    rng = np.random.RandomState(17)
    if case == "random":
        rows = [rng.randint(0, 256, rng.randint(0, 42)).astype(np.uint8).tobytes()
                for _ in range(300)]
        return rows, [0] * len(rows), rng.randint(0, 2**32, len(rows), dtype=np.uint64)
    ragged = [b"", b"\x80", b"\xff\x7f", b"abc", b"abcd", b"\xfe\xff\x80\x81\x00",
              b"\x90" * 7, b"12345678", b"\xc0" * 12, b"\x81" * 13, b"x" * 41, b"\x7f\x80\x81"]
    if case == "ragged":
        return ragged, [0] * len(ragged), 0x9747B28C
    return ragged, None, rng.randint(0, 2**32, len(ragged), dtype=np.uint64)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("case", ["random", "ragged", "unaligned"])
def test_mm_hash_bytes_torch_matches_jax(case, backend):
    rows, gaps, h = _byte_rows(case)
    chars, starts, lens = _spans(rows, gaps)
    if case == "unaligned":
        assert (starts % 4 != 0).all()
    padded = jnp.asarray(_padded(rows))
    jlens = jnp.asarray(lens)
    jh_in = jnp.full((len(rows),), np.uint32(h), jnp.uint32) if isinstance(h, int) else \
        jnp.asarray(h.astype(np.uint32))
    if backend == "xla":
        want = jh._mm_hash_bytes_xla(padded, jlens, jh_in)
    else:
        nwords = jlens // 4
        words, padded4 = jh._mm_bytes_words(padded)
        want = jh._mm_bytes_tail(padded4, jlens, nwords,
                                 mm_bytes_words_pallas(words, nwords, jh_in))
    port_h = h if isinstance(h, int) else _t(h.astype(np.uint32))
    got = hash_cuda.mm_hash_bytes_torch(_t(chars), _t(starts), _t(lens), port_h)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_mm_hash_bytes_torch_matches_oracle_on_random_bytes():
    rng = random.Random(5)
    rows = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 70))) for _ in range(200)]
    chars, starts, lens = _spans(rows, [rng.randrange(4) for _ in rows])
    seeds = [rng.randrange(2**32) for _ in rows]
    got = hash_cuda.mm_hash_bytes_torch(_t(chars), _t(starts), _t(lens),
                                        _t(np.array(seeds, np.uint32)))
    assert got.tolist() == [oracle.to_signed32(oracle.murmur32_bytes(r, s))
                            for r, s in zip(rows, seeds)]


# --- (b) the public hashes against the JAX package ----------------------------


def _mixed_columns():
    """HashTest's mixed row (tests/test_hash.py:143-155), JAX columns."""
    return (
        jc.strings_column(["a", "B\n", "dE\"Ā\tā 휠휡", MIXED_LONG_STR, None, None]),
        jc.column([0, 100, -100, -(2**31), 2**31 - 1, None], jc.INT32),
        jc.column([0.0, 100.0, -100.0, _f64(0x7FF0000000000001), _f64(0x7FFFFFFFFFFFFFFF),
                   None], jc.FLOAT64),
        jc.column([0.0, 100.0, -100.0, _f32(0xFF800001), _f32(0xFFFFFFFF), None], jc.FLOAT32),
        jc.column([True, False, None, False, True, None], jc.BOOL),
    )


def _strings_with_nulls():
    rng = np.random.RandomState(1)
    vals = ["".join(chr(rng.randint(32, 0x800)) for _ in range(rng.randint(0, 12)))
            for _ in range(64)]
    return [jc.strings_column([None if i % 7 == 3 else v for i, v in enumerate(vals)])]


def _binary():
    rng = np.random.RandomState(2)
    return [jc.strings_from_bytes(
        [None if i % 11 == 5 else rng.randint(0, 256, rng.randint(0, 40)).astype(np.uint8)
         .tobytes() for i in range(48)])]


def _decimal128():
    return [jc.decimal128_column(DEC128 + [None, -(10**37), 10**36 + 7], 38, 2)]


def _struct():
    strings, ints, doubles, floats, bools = _mixed_columns()
    return [jc.StructColumn((strings, ints, doubles, floats, bools),
                            np.array([True, True, False, True, True, True]))]


def _nested_struct():
    strings, ints, doubles, floats, bools = _mixed_columns()
    s1 = jc.StructColumn((strings, ints), np.array([True, False, True, True, True, True]))
    s2 = jc.StructColumn((s1, doubles), None)
    return [jc.StructColumn((s2, floats, jc.StructColumn((bools,), None)), None)]


def _list_int32():
    rng = np.random.RandomState(4)
    child = jc.column([None if i % 9 == 4 else int(v) for i, v in
                       enumerate(rng.randint(-(2**31), 2**31, 120))], jc.INT32)
    offs = np.concatenate([[0], np.cumsum(rng.randint(0, 6, 40))]).astype(np.int32)
    offs = np.minimum(offs, 120)
    return [jc.ListColumn(offs, child, rng.rand(40) >= 0.15)]


def _list_string():
    rng = np.random.RandomState(6)
    leaves = [None if i % 5 == 2 else "w" * int(rng.randint(0, 30)) + str(i) for i in range(40)]
    offs = np.concatenate([[0], np.cumsum(rng.randint(0, 5, 16))]).astype(np.int32)
    return [jc.ListColumn(np.minimum(offs, 40), jc.strings_column(leaves),
                          rng.rand(16) >= 0.15)]


def _list_list_string():
    leaf = jc.strings_column(["a", "bb", LONG_STR, "", "x", None, "\xff\x80", "tail"])
    inner = jc.ListColumn(np.array([0, 1, 3, 4, 5, 8, 8], np.int32), leaf, None)
    return [jc.ListColumn(np.array([0, 3, 4, 4, 6], np.int32), inner,
                          np.array([True, True, True, False]))]


def _list_decimal128():
    child = jc.decimal128_column(DEC128 + [None, 10**30], 38, 2)
    return [jc.ListColumn(np.array([0, 3, 3, 9, 16], np.int32), child,
                          np.array([True, True, False, True]))]


def _skewed_strings():
    return [jc.strings_column(["s%d" % i for i in range(1000)] + ["x" * 4096])]


COLUMN_CASES = {
    "strings_with_nulls": _strings_with_nulls,
    "binary": _binary,
    "decimal128": _decimal128,
    "struct": _struct,
    "nested_struct": _nested_struct,
    "list_int32": _list_int32,
    "list_string": _list_string,
    "list_list_string": _list_list_string,
    "list_decimal128": _list_decimal128,
    "skewed_strings": _skewed_strings,
}
PALLAS_CASES = ["strings_with_nulls", "decimal128", "list_string"]


@pytest.mark.parametrize("case,backend", [(c, "xla") for c in COLUMN_CASES]
                         + [(c, "pallas") for c in PALLAS_CASES])
def test_column_hash_matches_jax(case, backend):
    jcols = COLUMN_CASES[case]()
    pcols = [interop.port_column(c, "cpu") for c in jcols]
    with config.override(hash_backend=backend):
        want_mm = jax_murmur_hash32(jcols, seed=42).to_list()
        want_xx = jax_xxhash64(jcols).to_list()
    assert murmur_hash32(pcols, seed=42).to_list() == want_mm
    assert xxhash64(pcols).to_list() == want_xx


def test_decimal128_java_bytes_match_jax():
    jcol = _decimal128()[0]
    be, lens = jh._decimal128_java_bytes(jcol)
    pbe, plens = hashing._decimal128_java_bytes(interop.port_column(jcol, "cpu"))
    np.testing.assert_array_equal(plens.numpy(), np.asarray(lens))
    np.testing.assert_array_equal(pbe.numpy(), np.asarray(be))


@pytest.mark.parametrize("draw", ["uniform", "skewed"])
def test_length_buckets_match_jax(draw):
    rng = np.random.RandomState(8)
    lens = rng.randint(0, 300, 500) if draw == "uniform" else \
        np.minimum(rng.zipf(1.5, 500), 5000)
    lens[:3] = [0, 1, 2**20]
    want = jax_length_buckets(lens, min_width=1, round_rows=False)
    got = length_buckets(_t(lens))
    assert [w for w, _ in got] == [w for w, _, _ in want]
    for (_, rows), (_, jrows, n_valid) in zip(got, want):
        assert rows.tolist() == jrows[:n_valid].tolist()


# --- (c) Spark's vectors (tests/test_hash.py, from HashTest.java) ------------


def _cpu(values):
    return tc.strings_column(values, device="cpu")


def _offs(a):
    return torch.tensor(a, dtype=torch.int32)


def _vec_murmur_strings():
    col = _cpu(["a", "B\nc", "dE\"Ā\tā 휠휡\\Fg2'", LONG_STR, "hiJ휠휡휠휡", None])
    assert murmur_hash32([col], seed=42).to_list() == [
        1485273170, 1709559900, 1423943036, 176121990, 1199621434, 42]


def _vec_xxhash64_strings():
    col = _cpu(["a", "B\nc", "dE\"Ā\tā 휠휡\\Fg2'", LONG_STR, "hiJ휠휡휠휡", None])
    assert xxhash64([col]).to_list() == [
        -8582455328737087284, 2221214721321197934, 5798966295358745941,
        -4834097201550955483, -3782648123388245694, 42]


def _port_mixed():
    return [interop.port_column(c, "cpu") for c in _mixed_columns()]


def _vec_murmur_mixed():
    assert murmur_hash32(_port_mixed(), seed=1868).to_list() == [
        1936985022, 720652989, 339312041, 1400354989, 769988643, 1868]


def _vec_xxhash64_mixed():
    assert xxhash64(_port_mixed()).to_list() == [
        7451748878409563026, 6024043102550151964, 3380664624738534402,
        8444697026100086329, -5888679192448042852, 42]


def _vec_murmur_struct_matches_flat():
    cols = _port_mixed()
    assert murmur_hash32([tc.StructColumn(tuple(cols), None)], seed=1868).to_list() == \
        murmur_hash32(cols, seed=1868).to_list()


def _vec_murmur_nested_struct_matches_flat():
    strings, integers, doubles, floats, bools = _port_mixed()
    s2 = tc.StructColumn((tc.StructColumn((strings, integers), None), doubles), None)
    top = tc.StructColumn((s2, floats, tc.StructColumn((bools,), None)), None)
    assert murmur_hash32([top], seed=1868).to_list() == \
        murmur_hash32([strings, integers, doubles, floats, bools], seed=1868).to_list()


def _vec_murmur_int_lists():
    child = tc.column([0, -2, 3, 2**31 - 1, 5, -6, None, -(2**31)], tc.INT32, device="cpu")
    lst = tc.ListColumn(_offs([0, 0, 3, 4, 7, 8, 8]), child,
                        torch.tensor([False, True, True, True, True, False]))
    i1 = tc.column([None, 0, None, 5, -(2**31), None], tc.INT32, device="cpu")
    i2 = tc.column([None, -2, 2**31 - 1, None, None, None], tc.INT32, device="cpu")
    i3 = tc.column([None, 3, None, -6, None, None], tc.INT32, device="cpu")
    assert murmur_hash32([lst], seed=1868).to_list() == \
        murmur_hash32([i1, i2, i3], seed=1868).to_list()


def _vec_murmur_string_lists():
    strs = [None, "a", "B\n", "", "dE\"Ā\tā", " 휠휡",
            "A very long (greater than 128 bytes/char string) to test a multi"
            " hash-step data point in the Murmur3 hash function. This string needed to be longer.",
            ""]
    lst = tc.ListColumn(_offs([0, 2, 4, 6, 7, 8, 8]), _cpu(strs),
                        torch.tensor([True, True, True, True, True, False]))
    s1 = _cpu(["a", "B\n", "dE\"Ā\tā", strs[6], None, None])
    s2 = _cpu([None, "", " 휠휡", None, "", None])
    assert murmur_hash32([lst], seed=1868).to_list() == \
        murmur_hash32([tc.StructColumn((s1, s2), None)], seed=1868).to_list()


def _vec_decimal128_vs_oracle():
    col = tc.decimal128_column(DEC128, 38, 2, device="cpu")
    mm = murmur_hash32([col], seed=42).to_list()
    xx = xxhash64([col]).to_list()
    for i, v in enumerate(DEC128):
        b = oracle.java_bigdecimal_bytes(v)
        assert mm[i] == oracle.to_signed32(oracle.murmur32_bytes(b, 42)), f"mm row {i}"
        assert xx[i] == oracle.to_signed64(oracle.xxh64_bytes(b, 42)), f"xx row {i}"


def _vec_random_strings_vs_oracle():
    rng = random.Random(1234)
    strs = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 200)))
            for _ in range(100)]
    col = tc.strings_from_bytes(strs, device="cpu")
    mm = murmur_hash32([col], seed=7).to_list()
    xx = xxhash64([col], seed=99).to_list()
    for i, s in enumerate(strs):
        assert mm[i] == oracle.to_signed32(oracle.murmur32_bytes(s, 7)), f"mm row {i}"
        assert xx[i] == oracle.to_signed64(oracle.xxh64_bytes(s, 99)), f"xx row {i}"


def _vec_list_of_list_flattens_to_leaf():
    leaf = tc.column([1, 2, 3, 4, 5, 6], tc.INT32, device="cpu")
    inner = tc.ListColumn(_offs([0, 2, 3, 3, 6]), leaf, None)
    outer = tc.ListColumn(_offs([0, 2, 3, 4]), inner, None)
    flat = tc.ListColumn(_offs([0, 3, 3, 6]), leaf, None)
    assert murmur_hash32([outer], seed=1868).to_list() == \
        murmur_hash32([flat], seed=1868).to_list()


def _vec_list_of_list_of_strings():
    leaf = _cpu(["a", "bb", LONG_STR, "", "x"])
    inner = tc.ListColumn(_offs([0, 1, 3, 4, 5]), leaf, None)
    outer = tc.ListColumn(_offs([0, 3, 4]), inner, None)
    flat = tc.ListColumn(_offs([0, 4, 5]), leaf, None)
    assert murmur_hash32([outer], seed=42).to_list() == murmur_hash32([flat], seed=42).to_list()


def _vec_list_null_rows_pass_seed():
    leaf = tc.column([7, 8], tc.INT32, device="cpu")
    inner = tc.ListColumn(_offs([0, 1, 2]), leaf, None)
    outer = tc.ListColumn(_offs([0, 2, 2]), inner, torch.tensor([True, False]))
    assert murmur_hash32([outer], seed=5).to_list()[1] == oracle.to_signed32(5)


def _vec_struct_of_lists_matches_flat():
    lst = tc.ListColumn(_offs([0, 3, 4]), tc.column([0, -2, 3, 9], tc.INT32, device="cpu"),
                        None)
    dbl = tc.column([1.5, -2.25], tc.FLOAT64, device="cpu")
    assert murmur_hash32([tc.StructColumn((lst, dbl), None)], seed=1868).to_list() == \
        murmur_hash32([lst, dbl], seed=1868).to_list()


def _vec_deep_list_vs_oracle():
    rng = random.Random(11)
    leaf_vals = [rng.randrange(-(2**31), 2**31) for _ in range(64)]
    o1 = sorted(rng.sample(range(65), 9))
    o1[0], o1[-1] = 0, 64
    o2 = sorted(rng.sample(range(9), 4))
    o2[0], o2[-1] = 0, 8
    inner = tc.ListColumn(_offs(o1), tc.column(leaf_vals, tc.INT32, device="cpu"), None)
    got = murmur_hash32([tc.ListColumn(_offs(o2), inner, None)], seed=77).to_list()
    for r in range(len(o2) - 1):
        h = 77
        for v in leaf_vals[o1[o2[r]]:o1[o2[r + 1]]]:
            h = oracle.murmur32_int(v, h)
        assert got[r] == oracle.to_signed32(h), f"row {r}"


def _vec_skewed_string_lengths():
    strs = ["s%d" % i for i in range(1000)] + ["x" * 4096]
    got = murmur_hash32([_cpu(strs)], seed=9).to_list()
    for i in (0, 500, 999, 1000):
        assert got[i] == oracle.to_signed32(oracle.murmur32_bytes(strs[i].encode(), 9))


def _vec_skewed_list_of_strings():
    leaf_strs = ["e%d" % i for i in range(50)] + ["L" * 2048] + ["t"]
    offs = list(range(0, 51)) + [52]
    got = murmur_hash32([tc.ListColumn(_offs(offs), _cpu(leaf_strs), None)], seed=4).to_list()
    for r in (0, 49, 50):
        h = 4
        for s in leaf_strs[offs[r]:offs[r + 1]]:
            h = oracle.murmur32_bytes(s.encode(), h)
        assert got[r] == oracle.to_signed32(h), f"row {r}"


def _vec_strings_canaries():
    col = _cpu(["a", None])
    assert murmur_hash32([col], seed=42).to_list() == [1485273170, 42]
    assert xxhash64([col]).to_list() == [-8582455328737087284, 42]


SPARK_NESTED_VECTORS = {name[len("_vec_"):]: fn for name, fn in list(globals().items())
                        if name.startswith("_vec_")}


@pytest.mark.parametrize("case", sorted(SPARK_NESTED_VECTORS))
def test_spark_vectors_nested_and_bytes(case):
    SPARK_NESTED_VECTORS[case]()


@pytest.mark.parametrize("seed", [0, 42, 0xFFFFFFFF])
def test_random_byte_strings_vs_oracle(seed):
    rng = random.Random(seed)
    strs = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 100))) for _ in range(64)]
    col = tc.strings_from_bytes(strs, device="cpu")
    assert murmur_hash32([col], seed=seed).to_list() == \
        [oracle.to_signed32(oracle.murmur32_bytes(s, seed)) for s in strs]
    assert xxhash64([col], seed=seed).to_list() == \
        [oracle.to_signed64(oracle.xxh64_bytes(s, seed)) for s in strs]


# --- (d) interop round trips for the nested and variable-width columns -------


INTEROP_CASES = {
    "string": lambda: jc.strings_column(["a", None, "", "휠휡", LONG_STR]),
    "decimal128": lambda: jc.decimal128_column([0, -1, None, (1 << 127) - 1, -(1 << 127)],
                                               38, 4),
    "list": lambda: _list_list_string()[0],
    "struct": lambda: _nested_struct()[0],
}


def _jax_fields(col):
    """A JAX column's fields in the order of ``interop.column_to_numpy``."""
    valid = None if col.validity is None else np.asarray(col.validity)
    if isinstance(col, jc.StringColumn):
        offs = np.asarray(col.offsets)
        return np.asarray(col.chars)[:offs[-1]], offs, valid
    if isinstance(col, jc.Decimal128Column):
        return np.asarray(col.hi), np.asarray(col.lo), valid
    if isinstance(col, jc.ListColumn):
        return np.asarray(col.offsets), _jax_fields(col.child), valid
    if isinstance(col, jc.StructColumn):
        return tuple(_jax_fields(c) for c in col.children), valid
    return np.asarray(col.data), valid


def _assert_fields_equal(got, want):
    assert type(got) is type(want) or got is None or want is None
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_fields_equal(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", list(INTEROP_CASES))
def test_interop_round_trip_nested(case):
    jcol = INTEROP_CASES[case]()
    pcol = interop.port_column(jcol, device="cpu")
    if case == "decimal128":
        assert pcol.dtype == tc.DType(tc.Kind.DECIMAL128, 38, 4)
        assert pcol.lo.dtype == torch.int64
        assert pcol.unscaled_to_list() == jcol.unscaled_to_list()
    if case in ("string", "decimal128"):
        assert pcol.to_list() == jcol.to_list()
    _assert_fields_equal(interop.column_to_numpy(pcol), _jax_fields(jcol))


# --- (e) CPU tensors launch nothing; builders check their input --------------


def test_cpu_column_hash_launches_no_kernel():
    hash_cuda.reset_launches()
    cols = [_strings_with_nulls()[0], _decimal128()[0], _list_string()[0], _struct()[0]]
    for c in cols:
        murmur_hash32([interop.port_column(c, "cpu")])
        xxhash64([interop.port_column(c, "cpu")])
    rng = np.random.RandomState(3)
    chars = _t(rng.randint(0, 256, 100).astype(np.uint8))
    starts = _t(rng.randint(0, 50, 20).astype(np.int32))
    lens = _t(rng.randint(0, 50, 20).astype(np.int32))
    h = _t(rng.randint(-(2**31), 2**31, 20).astype(np.int32))
    assert torch.equal(hash_cuda.mm_hash_bytes_cuda(chars, starts, lens, h),
                       hash_cuda.mm_hash_bytes_torch(chars, starts, lens, h))
    assert hash_cuda.launches["mm_hash_bytes"] == 0
    assert set(hash_cuda.launches.values()) == {0}


@pytest.mark.parametrize("make", [
    lambda: tc.strings_column([], device="cpu"),
    lambda: tc.decimal128_column([], 38, 2, device="cpu"),
    lambda: tc.ListColumn(torch.zeros(1, dtype=torch.int32),
                          tc.strings_column([], device="cpu"), None),
    lambda: tc.StructColumn((tc.strings_column([], device="cpu"),), None),
])
def test_empty_columns_hash_to_empty(make):
    col = make()
    assert murmur_hash32([col]).to_list() == []
    assert xxhash64([col]).to_list() == []


@pytest.mark.parametrize("offsets,match", [
    ([1, 2], "start at 0"),
    ([0, 3, 2], "must not decrease"),
    ([0, 2, 9], "end within chars"),
])
def test_strings_from_arrays_checks_offsets(offsets, match):
    with pytest.raises(ValueError, match=match):
        tc.strings_from_arrays(np.zeros(4, np.uint8), np.array(offsets, np.int32),
                               device="cpu")


def test_strings_from_arrays_cuts_chars_to_the_last_offset():
    col = tc.strings_from_arrays(np.arange(10, dtype=np.uint8), np.array([0, 2, 5], np.int32),
                                 np.array([True, False]), device="cpu")
    assert col.chars.numel() == 5 and col.size == 2
    assert col.lengths().tolist() == [2, 3]
    assert col.to_list() == ["\x00\x01", None]


@pytest.mark.parametrize("make,match", [
    (lambda: tc.StringColumn(torch.zeros(4, dtype=torch.uint8), _offs([0, 5]), None),
     "end within chars"),
    (lambda: tc.StringColumn(torch.zeros(4, dtype=torch.int32), _offs([0, 2]), None),
     "uint8"),
    (lambda: tc.StringColumn(torch.zeros(4, dtype=torch.uint8),
                             torch.tensor([0, 2], dtype=torch.int64), None), "int32"),
    (lambda: tc.StringColumn(torch.zeros(4, dtype=torch.uint8), _offs([0, 2, 4]),
                             torch.tensor([True])), "one bool per row"),
    (lambda: tc.ListColumn(_offs([0, 3, 2]), _cpu(["a", "b", "c"]), None), "not decrease"),
    (lambda: tc.ListColumn(_offs([0, 2, 4]), _cpu(["a", "b", "c"]), None),
     "end within the child's rows"),
    (lambda: interop.port_column(jc.ListColumn(np.array([0, 2, 5], np.int32),
                                               jc.strings_column(["a", "b", "c"]), None),
                                 "cpu"), "end within the child's rows"),
    (lambda: interop.port_column(jc.ListColumn(np.array([1, 2], np.int32),
                                               jc.strings_column(["a", "b", "c"]), None),
                                 "cpu"), "start at 0"),
])
def test_columns_check_offsets_where_built(make, match):
    with pytest.raises(ValueError, match=match):
        make()


@pytest.mark.parametrize("starts,lens", [
    ([0, -1], [2, 1]),  # a start before the buffer
    ([0, 2], [2, -1]),  # a negative length
    ([0, 6], [2, 3]),  # a span past the buffer's end
])
def test_mm_hash_bytes_wrapper_refuses_bad_spans_on_cpu(starts, lens):
    chars = torch.arange(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not lie within chars"):
        hash_cuda.mm_hash_bytes_cuda(chars, _offs(starts), _offs(lens), 0)


def test_decimal128_hash_refuses_rows_whose_starts_would_wrap(monkeypatch):
    # xxhash64 walks the Java bytes as 16-byte rows with int32 starts and
    # refuses; murmur3 builds them per row from (hi, lo) and has no such cap
    vals = [1, -(1 << 100), 3]
    col = tc.decimal128_column(vals, 38, 2, device="cpu")
    monkeypatch.setattr(hashing, "_MAX_DECIMAL_ROWS", 2)
    with pytest.raises(ValueError, match="int32 starts"):
        xxhash64([col])
    assert murmur_hash32([col], seed=42).to_list() == \
        jax_murmur_hash32([jc.decimal128_column(vals, 38, 2)], seed=42).to_list()
