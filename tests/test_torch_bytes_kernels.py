"""The byte kernel's three entry points (``mm_hash_strings``, ``mm_hash_bytes``,
``mm_hash_decimal128``) against the JAX package and Spark's oracles, on the CPU.

Inputs are made from numpy (or python ``random``) seeds and handed to both
packages; every comparison is bit-exact (tolerance 0: integer hashing).  The
JAX side runs its XLA scan and, on small cases, the Pallas word kernel in
interpret mode followed by ``_mm_bytes_tail``.  The port's wrappers take their
plain PyTorch versions here because the tensors lie on the CPU; those repeat
the kernels' own arithmetic (aligned words joined by funnel shifts, the
decimal's Java bytes built from a leading-bit count), and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import columnar as jc
from spark_rapids_jni_tpu import config
from spark_rapids_jni_tpu.ops import hashing as jh
from spark_rapids_jni_tpu.ops import murmur_hash32 as jax_murmur_hash32
from spark_rapids_jni_tpu.ops.hash_pallas import mm_bytes_words_pallas
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops import hash_cuda, hashing, murmur_hash32, xxhash64

import spark_oracles as oracle

BYTE_KERNELS = ("mm_hash_strings", "mm_hash_bytes", "mm_hash_decimal128")


def _t(a):
    return interop.tensor_from_numpy(a, "cpu")


# --- mm_hash_strings: a column's rows through its offsets ---------------------


def _rows(case):
    rng = np.random.RandomState(19)
    if case == "ragged":
        return [rng.randint(0, 256, rng.randint(0, 42)).astype(np.uint8).tobytes()
                for _ in range(257)]
    if case == "long":  # rows longer than a shared-memory stage, among short ones
        lens = [5, 0, 16384 + 3, 7, 40000, 1, 2, 3, 4, 0, 99]
        return [rng.randint(0, 256, n).astype(np.uint8).tobytes() for n in lens]
    if case == "empty_rows":
        return [b""] * 300 + [b"\x80\xff\x01"] + [b""] * 5
    assert case == "empty_chars"
    return [b""] * 17


def _column_arrays(rows):
    offsets = np.zeros(len(rows) + 1, np.int32)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    return np.frombuffer(b"".join(rows), np.uint8), offsets


def _padded(rows):
    out = np.zeros((len(rows), max(1, max(len(r) for r in rows))), np.uint8)
    for i, r in enumerate(rows):
        out[i, :len(r)] = np.frombuffer(r, np.uint8)
    return out


def _jax_bytes_hash(rows, h, backend):
    """JAX's murmur3 over padded byte rows (per-row u32 hashes ``h``)."""
    padded = jnp.asarray(_padded(rows))
    lens = jnp.asarray(np.array([len(r) for r in rows], np.int32))
    jh_in = jnp.asarray(h.astype(np.uint32))
    if backend == "xla":
        return np.asarray(jh._mm_hash_bytes_xla(padded, lens, jh_in))
    nwords = lens // 4
    words, padded4 = jh._mm_bytes_words(padded)
    return np.asarray(jh._mm_bytes_tail(padded4, lens, nwords,
                                        mm_bytes_words_pallas(words, nwords, jh_in)))


def _offset_view(chars, base):
    """``chars`` as a view that starts ``base`` bytes into a larger buffer."""
    buf = torch.zeros(chars.numel() + base + 3, dtype=torch.uint8)
    buf[base:base + chars.numel()] = chars
    return buf[base:base + chars.numel()]


@pytest.mark.parametrize("form", ["row", "scalar"])
@pytest.mark.parametrize("case,backend,base", [
    ("ragged", "xla", 0), ("ragged", "xla", 3), ("ragged", "pallas", 1),
    ("long", "xla", 2), ("empty_rows", "xla", 0), ("empty_rows", "pallas", 0),
    ("empty_chars", "xla", 0),
])
def test_mm_hash_strings_torch_matches_jax(case, backend, base, form):
    rows = _rows(case)
    if backend == "pallas" and case == "ragged":
        rows = rows[:40]  # interpret mode is slow; a small case
    chars, offsets = _column_arrays(rows)
    rng = np.random.RandomState(len(rows))
    h = rng.randint(0, 2**32, len(rows), dtype=np.uint64) if form == "row" else \
        np.full(len(rows), 0x9747B28C, np.uint64)
    want = _jax_bytes_hash(rows, h, backend)
    tchars = _offset_view(_t(chars), base)
    port_h = _t(h.astype(np.uint32)) if form == "row" else 0x9747B28C
    got = hash_cuda.mm_hash_strings_cuda(tchars, _t(offsets), port_h)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(got, hash_cuda.mm_hash_strings_torch(tchars, _t(offsets), port_h))


def test_mm_hash_strings_matches_spans_and_oracle():
    rng = random.Random(7)
    rows = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 70))) for _ in range(150)]
    chars, offsets = _column_arrays(rows)
    seeds = [rng.randrange(2**32) for _ in rows]
    h = _t(np.array(seeds, np.uint32))
    got = hash_cuda.mm_hash_strings_torch(_t(chars), _t(offsets), h)
    starts = _t(offsets[:-1].copy())
    lens = _t(np.diff(offsets).astype(np.int32))
    assert torch.equal(got, hash_cuda.mm_hash_bytes_torch(_t(chars), starts, lens, h))
    assert got.tolist() == [oracle.to_signed32(oracle.murmur32_bytes(r, s))
                            for r, s in zip(rows, seeds)]


@pytest.mark.parametrize("offsets,match", [
    ([0, 5], "does not lie within chars"),  # past the buffer's end
    ([0, 3, 2], "does not lie within chars"),  # a negative length
])
def test_mm_hash_strings_plain_refuses_bad_offsets(offsets, match):
    with pytest.raises(ValueError, match=match):
        hash_cuda.mm_hash_strings_cuda(torch.zeros(4, dtype=torch.uint8),
                                       torch.tensor(offsets, dtype=torch.int32), 0)


@pytest.mark.parametrize("call,exc", [
    (lambda: hash_cuda.mm_hash_strings_cuda(torch.zeros(4, dtype=torch.int32),
                                            torch.zeros(2, dtype=torch.int32), 0), TypeError),
    (lambda: hash_cuda.mm_hash_strings_cuda(torch.zeros(4, dtype=torch.uint8),
                                            torch.zeros(0, dtype=torch.int32), 0), TypeError),
    (lambda: hash_cuda.mm_hash_strings_cuda(torch.zeros(4, dtype=torch.uint8),
                                            torch.zeros(3, dtype=torch.int32),
                                            torch.zeros(3, dtype=torch.int32)), TypeError),
    (lambda: hash_cuda.mm_hash_decimal128_cuda(torch.zeros(2, dtype=torch.int64),
                                               torch.zeros(3, dtype=torch.int64), 0), TypeError),
    (lambda: hash_cuda.mm_hash_decimal128_cuda(torch.zeros(2, dtype=torch.int32),
                                               torch.zeros(2, dtype=torch.int64), 0), TypeError),
    (lambda: hash_cuda.mm_hash_decimal128_cuda(torch.zeros(2, dtype=torch.int64),
                                               torch.zeros(2, dtype=torch.int64),
                                               torch.zeros(2, dtype=torch.int64)), TypeError),
])
def test_new_wrappers_check_their_arguments(call, exc):
    with pytest.raises(exc):
        call()


# --- mm_hash_bytes: gathered spans, aligned word loads ------------------------


@pytest.mark.parametrize("form", ["row", "scalar"])
def test_mm_hash_bytes_gathered_spans_match_oracle(form):
    """Spans in any order and overlapping, at every start alignment, as a
    list walk's element step gathers them."""
    rng = random.Random(23)
    buf = bytes(rng.randrange(256) for _ in range(700))
    spans = [(rng.randrange(0, 600), rng.randrange(0, 100)) for _ in range(400)]
    spans += [(s, 0) for s in range(4)] + [(700 - n, n) for n in range(1, 9)]
    starts = _t(np.array([s for s, _ in spans], np.int32))
    lens = _t(np.array([n for _, n in spans], np.int32))
    seeds = [rng.randrange(2**32) for _ in spans] if form == "row" else [42] * len(spans)
    h = _t(np.array(seeds, np.uint32)) if form == "row" else 42
    got = hash_cuda.mm_hash_bytes_cuda(_t(np.frombuffer(buf, np.uint8)), starts, lens, h)
    assert got.tolist() == [oracle.to_signed32(oracle.murmur32_bytes(buf[s:s + n], sd))
                            for (s, n), sd in zip(spans, seeds)]


# --- mm_hash_decimal128: Java bytes built from (hi, lo) -----------------------


def _decimal_specials(seed):
    """Unscaled values at every Java byte length 1..16: each length's
    extremes, the values one past them, random values of that length, and
    0, 1, -1."""
    r = random.Random(seed)
    vals = [0, 1, -1]
    for nbytes in range(1, 17):
        top = 1 << (8 * nbytes - 1)
        vals += [top - 1, -top]
        if nbytes < 16:
            vals += [top, -top - 1]
        vals += [r.randrange(-top, top) for _ in range(4)]
    return vals


def _hi_lo(vals):
    u = [v & ((1 << 128) - 1) for v in vals]
    hi = np.array([x >> 64 for x in u], np.uint64).view(np.int64)
    lo = np.array([x & ((1 << 64) - 1) for x in u], np.uint64).view(np.int64)
    return _t(hi), _t(lo)


@pytest.mark.parametrize("form", ["row", "scalar"])
def test_mm_hash_decimal128_torch_matches_java_bytes_oracle(form):
    vals = _decimal_specials(31)
    assert sorted({len(oracle.java_bigdecimal_bytes(v)) for v in vals}) == list(range(1, 17))
    rng = random.Random(5)
    seeds = [rng.randrange(2**32) for _ in vals] if form == "row" else [0x9747B28C] * len(vals)
    h = _t(np.array(seeds, np.uint32)) if form == "row" else 0x9747B28C
    got = hash_cuda.mm_hash_decimal128_cuda(*_hi_lo(vals), h)
    assert got.tolist() == [
        oracle.to_signed32(oracle.murmur32_bytes(oracle.java_bigdecimal_bytes(v), s))
        for v, s in zip(vals, seeds)]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_mm_hash_decimal128_matches_jax_column_hash(backend):
    vals = _decimal_specials(37)
    if backend == "pallas":
        vals = vals[::5]  # interpret mode is slow; a small case, still every length
    vals = vals + [None]
    jcol = jc.decimal128_column(vals, 38, 2)
    with config.override(hash_backend=backend):
        want = jax_murmur_hash32([jcol], seed=42).to_list()
    assert murmur_hash32([interop.port_column(jcol, "cpu")], seed=42).to_list() == want


def test_mm_hash_decimal128_per_row_hashes_match_jax_bytes():
    """Per-row running hashes through the JAX package's own Java bytes."""
    vals = _decimal_specials(41)
    jcol = jc.decimal128_column(vals, 38, 2)
    be, lens = jh._decimal128_java_bytes(jcol)
    h = np.random.RandomState(3).randint(0, 2**32, len(vals), dtype=np.uint64)
    want = np.asarray(jh._mm_hash_bytes_xla(be, lens, jnp.asarray(h.astype(np.uint32))))
    pcol = interop.port_column(jcol, "cpu")
    got = hash_cuda.mm_hash_decimal128_torch(pcol.hi, pcol.lo, _t(h.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_clz64_matches_bit_length():
    rng = random.Random(9)
    vals = [0, 1, 2, 3, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    vals += [rng.randrange(1 << rng.randrange(1, 65)) for _ in range(300)]
    x = _t(np.array(vals, np.uint64).view(np.int64))
    assert hash_cuda._clz64(x).tolist() == [64 - v.bit_length() for v in vals]


# --- routing: which entry point each column takes, and no launch on the CPU ---


def _recording(monkeypatch):
    calls = []
    for name in BYTE_KERNELS:
        fn = getattr(hashing, f"{name}_cuda")
        monkeypatch.setattr(hashing, f"{name}_cuda",
                            lambda *a, _n=name, _f=fn, **k: (calls.append(_n), _f(*a, **k))[1])
    return calls


def _nested_batch():
    strs = tc.strings_column(["a", None, "bcd", "", "efgh" * 9], device="cpu")
    dec = tc.decimal128_column([0, -1, None, 10**30, -(10**37)], 38, 2, device="cpu")
    lst = tc.ListColumn(torch.tensor([0, 2, 2, 3, 5, 5], dtype=torch.int32),
                        tc.strings_column(["x", "yy", None, "zzz", "w" * 20], device="cpu"),
                        None)
    st = tc.StructColumn((tc.strings_column(["p", "q", None, "", "r"], device="cpu"),), None)
    return strs, dec, lst, st


def test_murmur3_routes_each_column_to_its_entry_point(monkeypatch):
    calls = _recording(monkeypatch)
    strs, dec, lst, st = _nested_batch()
    murmur_hash32([strs, strs, dec])
    assert calls == ["mm_hash_strings", "mm_hash_strings", "mm_hash_decimal128"]
    del calls[:]
    murmur_hash32([lst])
    assert set(calls) == {"mm_hash_bytes"}
    del calls[:]
    murmur_hash32([st])
    assert calls == ["mm_hash_strings"]
    del calls[:]
    list_dec = tc.ListColumn(torch.tensor([0, 3, 5], dtype=torch.int32), dec, None)
    murmur_hash32([list_dec])
    assert set(calls) == {"mm_hash_decimal128"}
    del calls[:]
    for col in (strs, dec, lst, st):
        xxhash64([col])
    assert calls == []


def test_cpu_byte_entry_points_launch_nothing():
    hash_cuda.reset_launches()
    strs, dec, lst, st = _nested_batch()
    for col in (strs, dec, lst, st):
        murmur_hash32([col])
        xxhash64([col])
    chars = torch.arange(20, dtype=torch.uint8)
    offsets = torch.tensor([0, 3, 3, 11, 20], dtype=torch.int32)
    assert torch.equal(hash_cuda.mm_hash_strings_cuda(chars, offsets, 5),
                       hash_cuda.mm_hash_strings_torch(chars, offsets, 5))
    hi, lo = torch.tensor([0, -1], dtype=torch.int64), torch.tensor([7, -8], dtype=torch.int64)
    assert torch.equal(hash_cuda.mm_hash_decimal128_cuda(hi, lo, 5),
                       hash_cuda.mm_hash_decimal128_torch(hi, lo, 5))
    assert all(hash_cuda.launches[k] == 0 for k in BYTE_KERNELS)
    assert set(hash_cuda.launches.values()) == {0}
