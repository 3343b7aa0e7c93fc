"""Spark-exact row hashing: murmur3-32 and xxhash64 (PyTorch port of
``spark_rapids_jni_tpu/ops/hashing.py``, the reference's ``murmur_hash.cu`` +
``xxhash64.cu``).  Spark's conventions:

- the running hash is the *seed* for the next column (serial chaining);
- a null element contributes nothing: the seed passes through;
- floats/doubles normalize NaN -> canonical quiet NaN and -0.0 -> +0.0;
- DECIMAL32/64 hash their unscaled value as an 8-byte long; DECIMAL128 hashes
  the minimal big-endian two's-complement bytes of the unscaled value, as
  java.math.BigDecimal.unscaledValue().toByteArray() gives them;
- strings and binary hash their bytes; Spark murmur gives each of the <=3
  trailing bytes a full round, sign-extended to an int;
- a struct chains its children in order, and a null struct row masks them all;
- a list chains its leaf elements serially, descending nested lists.

Each fixed-width contribution, and murmur3 over bytes, goes through a wrapper
of ``hash_cuda``, which launches the CUDA kernel for a tensor on the card and
runs the plain version for a tensor on the CPU: the device of the data
decides, nothing else.  Murmur3 over bytes takes one of three entry points by
how the bytes lie: a string column through its offsets (``mm_hash_strings``),
a decimal128 column from its (hi, lo) words (``mm_hash_decimal128``), and the
gathered spans of a list walk's element step (``mm_hash_bytes``).  xxhash64
over bytes has no kernel in either package and is plain torch here, over the
decimals' Java bytes built in torch.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from spark_rapids_jni_tpu_torch.columnar.buckets import length_buckets
from spark_rapids_jni_tpu_torch.columnar.column import (
    Column,
    Decimal128Column,
    ListColumn,
    StringColumn,
    StructColumn,
)
from spark_rapids_jni_tpu_torch.columnar.dtypes import INT32, INT64, Kind
from spark_rapids_jni_tpu_torch.ops.hash_cuda import (
    M32,
    M64,
    XX_P1,
    XX_P2,
    XX_P4,
    XX_P5,
    _as_int32,
    _mm_fmix,
    _mm_mix_k1,
    _rotl32,
    _rotl64,
    _xx_finalize,
    mm_hash_bytes_cuda,
    mm_hash_decimal128_cuda,
    mm_hash_int_cuda,
    mm_hash_long_cuda,
    mm_hash_strings_cuda,
    signed32,
    signed64,
    xx_hash_fixed4_cuda,
    xx_hash_fixed8_cuda,
    xx_round4,
    xx_round8,
)

DEFAULT_XXHASH64_SEED = 42  # hash.cuh:29

HashInput = Union[Column, StringColumn, Decimal128Column, StructColumn, ListColumn]

_P1, _P2, _P4, _P5 = (signed64(p) for p in (XX_P1, XX_P2, XX_P4, XX_P5))

# xxhash64 over decimals walks their Java bytes as 16-byte rows with int32
# starts, so 16 * rows must stay below 2**31
_MAX_DECIMAL_ROWS = 1 << 27


def _normalize_float_bits(col: Column) -> torch.Tensor:
    """NaN -> canonical quiet NaN, -0.0 -> +0.0, as integer bit patterns:
    int32 for FLOAT32, int64 for FLOAT64 (whose data already holds bits)."""
    if col.dtype.kind == Kind.FLOAT32:
        bits = col.data.view(torch.int32)
        bits = torch.where(torch.isnan(col.data), 0x7FC00000, bits)
        return torch.where(col.data == 0.0, 0, bits)
    bits = col.data
    mag = bits & 0x7FFFFFFFFFFFFFFF
    bits = torch.where(mag > 0x7FF0000000000000, 0x7FF8000000000000, bits)
    return torch.where(mag == 0, 0, bits)


# ---------------------------------------------------------------------------
# byte strings
# ---------------------------------------------------------------------------


def _mm_hash_bytes(chars: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """Spark Murmur3.hashUnsafeBytes of ``chars[starts[i] : starts[i] + lens[i]]``
    per row, chained onto ``h`` (int32 bits): the ``mm_hash_bytes`` kernel."""
    return mm_hash_bytes_cuda(chars, starts.to(torch.int32).contiguous(),
                              lens.to(torch.int32).contiguous(), h)


def _load_le(buf: torch.Tensor, pos: torch.Tensor, nbytes: int) -> torch.Tensor:
    """The ``nbytes`` (4 or 8) little-endian bytes at each ``pos`` as int64
    (a 4-byte word zero-extended); reads past the buffer are clamped, and the
    callers discard the rows that make them."""
    idx = torch.clamp(pos[:, None] + torch.arange(nbytes, device=pos.device), 0,
                      buf.numel() - 1)
    if nbytes == 8:
        return buf[idx].view(torch.int64).flatten()
    return buf[idx].view(torch.int32).flatten().to(torch.int64) & M32


def _xx_hash_bytes_rows(buf: torch.Tensor, s: torch.Tensor, ln: torch.Tensor,
                        seed: torch.Tensor, max_len: int) -> torch.Tensor:
    """XXH64 of ``buf[s : s + ln]`` per row (xxhash64.cu:110-177), rows in
    lockstep up to ``max_len`` bytes; int64 positions, lengths and seed bits."""
    nstripes = ln // 32
    v = [seed + signed64(XX_P1 + XX_P2), seed + _P2, seed, seed - _P1]
    for stripe in range(max_len // 32):
        active = stripe < nstripes
        for lane in range(4):
            w = _load_le(buf, s + 32 * stripe + 8 * lane, 8)
            v[lane] = torch.where(active, _rotl64(v[lane] + w * _P2, 31) * _P1, v[lane])
    merged = _rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12) + _rotl64(v[3], 18)
    for vl in v:
        merged = (merged ^ (_rotl64(vl * _P2, 31) * _P1)) * _P1 + _P4
    h = torch.where(ln >= 32, merged, seed + _P5) + ln

    pos = s + 32 * nstripes  # first byte after the stripes
    rem = ln % 32
    for j in range(3):  # up to three 8-byte words
        h = torch.where(8 * j + 8 <= rem, xx_round8(h, _load_le(buf, pos + 8 * j, 8)), h)
    pos = pos + 8 * (rem // 8)
    has4 = rem % 8 >= 4
    h = torch.where(has4, xx_round4(h, _load_le(buf, pos, 4)), h)
    pos = pos + torch.where(has4, 4, 0)
    end = s + ln
    for j in range(3):  # up to three single bytes
        b = buf[torch.clamp(pos + j, 0, buf.numel() - 1)].to(torch.int64)
        h = torch.where(pos + j < end, _rotl64(h ^ (b * _P5), 11) * _P1, h)
    return _xx_finalize(h)


def _xx_hash_bytes(chars: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                   seed: torch.Tensor) -> torch.Tensor:
    """XXH64 of ``chars[starts[i] : starts[i] + lens[i]]`` per row, seeded by
    ``seed`` (int64 bits).  Plain torch, vectorized over rows, walked one
    power-of-two length class at a time so one long row does not set the
    number of stripe steps for the whole column."""
    buf = chars if chars.numel() else torch.zeros(1, dtype=torch.uint8, device=chars.device)
    s = starts.to(torch.int64)
    ln = lens.to(torch.int64)
    out = torch.empty_like(seed)
    for width, rows in length_buckets(ln):
        out[rows] = _xx_hash_bytes_rows(buf, s[rows], ln[rows], seed[rows], width)
    return out


def _hash_bytes(chars, starts, lens, h, *, mm: bool) -> torch.Tensor:
    if mm:
        return _mm_hash_bytes(chars, starts, lens, h)
    return _xx_hash_bytes(chars, starts, lens, h)


def _decimal128_java_bytes(col: Decimal128Column):
    """Minimal big-endian two's-complement bytes of the unscaled value.

    Mirrors hash.cuh:56-104 (to_java_bigdecimal): drop leading sign bytes,
    keep at least one byte, re-add one byte if the sign bit of the top
    remaining byte disagrees with the value's sign.  Returns ([n, 16] uint8
    big-endian bytes, zero past each row's length; int32 lengths)."""
    dev = col.hi.device
    shifts = 8 * torch.arange(8, dtype=torch.int64, device=dev)
    # little-endian bytes 0..7 from lo, 8..15 from hi; the mask undoes the
    # arithmetic shift's sign fill
    le = torch.cat([(col.lo[:, None] >> shifts) & 0xFF,
                    (col.hi[:, None] >> shifts) & 0xFF], dim=1)  # [n, 16] int64
    is_neg = col.hi < 0
    filler = torch.where(is_neg, 0xFF, 0)
    pos = torch.arange(16, dtype=torch.int64, device=dev)
    top = torch.where(le != filler[:, None], pos, -1).max(dim=1).values
    length = torch.clamp(top + 1, min=1)
    top_byte = torch.gather(le, 1, (length - 1)[:, None])[:, 0]
    msb = (top_byte & 0x80) != 0
    length = torch.where((length < 16) & (is_neg ^ msb), length + 1, length)
    # big-endian: be[p] = le[length - 1 - p] for p < length
    src = torch.clamp(length[:, None] - 1 - pos, 0, 15)
    be = torch.where(pos < length[:, None], torch.gather(le, 1, src), 0)
    return be.to(torch.uint8), length.to(torch.int32)


def _decimal128_spans(col: Decimal128Column):
    """(chars, starts, lens) of the Java bytes, one 16-byte row each, for
    xxhash64 (murmur3 builds them on the card: ``mm_hash_decimal128``)."""
    if col.size > _MAX_DECIMAL_ROWS:
        raise ValueError(f"hashing a decimal128 column of {col.size} rows: at most "
                         f"{_MAX_DECIMAL_ROWS}, so that its 16-byte rows' int32 starts "
                         "do not wrap")
    be, lens = _decimal128_java_bytes(col)
    starts = 16 * torch.arange(col.size, dtype=torch.int32, device=be.device)
    return be.reshape(-1), starts, lens


# ---------------------------------------------------------------------------
# columns
# ---------------------------------------------------------------------------


def _hash_element(col, h: torch.Tensor, *, mm: bool) -> torch.Tensor:
    """One column's contribution: h' per row, ignoring validity (caller masks)."""
    if isinstance(col, StringColumn):
        if mm:
            return mm_hash_strings_cuda(col.chars, col.offsets.contiguous(), h)
        return _xx_hash_bytes(col.chars, col.offsets[:-1], col.lengths(), h)
    if isinstance(col, Decimal128Column):
        if mm:
            return mm_hash_decimal128_cuda(col.hi.contiguous(), col.lo.contiguous(), h)
        return _xx_hash_bytes(*_decimal128_spans(col), h)
    kind = col.dtype.kind
    if kind in (Kind.FLOAT32, Kind.FLOAT64):
        bits = _normalize_float_bits(col)
        if kind == Kind.FLOAT32:
            return mm_hash_int_cuda(bits, h) if mm else xx_hash_fixed4_cuda(bits, h)
        return mm_hash_long_cuda(bits, h) if mm else xx_hash_fixed8_cuda(bits, h)
    if kind in (Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32, Kind.DATE32):
        v = col.data.to(torch.int32).contiguous()  # sign-extend to 4 bytes
        return mm_hash_int_cuda(v, h) if mm else xx_hash_fixed4_cuda(v, h)
    if kind in (Kind.INT64, Kind.TIMESTAMP_MICROS, Kind.DECIMAL32, Kind.DECIMAL64):
        # decimals hash their unscaled value as an 8-byte long (xxhash64.cu:248-260)
        v = col.data.to(torch.int64).contiguous()
        return mm_hash_long_cuda(v, h) if mm else xx_hash_fixed8_cuda(v, h)
    raise ValueError(f"unsupported column type for hashing: {col.dtype}")


def _hash_column(col, h: torch.Tensor, *, mm: bool) -> torch.Tensor:
    """Chain one column into the running hash, with Spark's null and nesting
    rules."""
    if isinstance(col, StructColumn):
        # children in order (murmur_hash.cu:117-131); a null struct row masks
        # out all of its children's contributions
        h_in = h
        for child in col.children:
            h = _hash_column(child, h, mm=mm)
        return h if col.validity is None else torch.where(col.validity, h, h_in)
    if isinstance(col, ListColumn):
        return _hash_list(col, h, mm=mm)
    upd = _hash_element(col, h, mm=mm)
    if col.validity is None:
        return upd
    return torch.where(col.validity, upd, h)


def _leaf_step(leaf, idx: torch.Tensor, h: torch.Tensor, *, mm: bool) -> torch.Tensor:
    """Contribution of leaf element ``idx[r]`` chained onto ``h[r]``."""
    if isinstance(leaf, StringColumn):
        starts = leaf.offsets[idx]
        return _hash_bytes(leaf.chars, starts, leaf.offsets[idx + 1] - starts, h, mm=mm)
    if isinstance(leaf, Decimal128Column):
        return _hash_element(Decimal128Column(leaf.hi[idx], leaf.lo[idx], None, leaf.dtype),
                             h, mm=mm)
    return _hash_element(Column(leaf.data[idx], None, leaf.dtype), h, mm=mm)


def _hash_list(col: ListColumn, h: torch.Tensor, *, mm: bool) -> torch.Tensor:
    """Serial leaf-element hashing of (arbitrarily nested) LIST rows.

    Mirrors murmur_hash.cu:119-142: nested lists descend to the leaf child by
    composing offsets, so a row of ``[[1,2],[3]]`` hashes the flattened leaf
    span ``1,2,3`` serially, each element's hash seeding the next.  Null rows
    and null leaf elements pass the seed through.  LIST-of-STRUCT is rejected
    as check_hash_compatibility does (murmur_hash.cu:164-171).  Rows walk one
    power-of-two span-length class at a time, so one long list does not set
    the number of element steps for the whole column.
    """
    starts = col.offsets[:-1].to(torch.int64)
    ends = col.offsets[1:].to(torch.int64)
    leaf = col.child
    while isinstance(leaf, ListColumn):
        starts = leaf.offsets[starts].to(torch.int64)
        ends = leaf.offsets[ends].to(torch.int64)
        leaf = leaf.child
    if isinstance(leaf, StructColumn):
        raise ValueError("hashing a LIST of STRUCT column is not supported")  # murmur_hash.cu:169

    lens = ends - starts
    live = torch.nonzero((lens > 0) & col.is_valid()).flatten()  # the rest pass h through
    if live.numel() == 0:
        return h
    leaf_valid = leaf.is_valid()
    last = leaf.size - 1
    h = h.clone()
    for _, sub in length_buckets(lens[live]):
        rows = live[sub]
        bstart, blen, hb = starts[rows], lens[rows], h[rows]
        for j in range(int(blen.max())):
            idx = torch.clamp(bstart + j, max=last)
            upd = _leaf_step(leaf, idx, hb, mm=mm)
            hb = torch.where((j < blen) & leaf_valid[idx], upd, hb)
        h[rows] = hb
    return h


# ---------------------------------------------------------------------------
# raw-array entry points (for shuffle partitioning and the query step)
# ---------------------------------------------------------------------------


def murmur3_raw_int64(data: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Spark murmur3-32 of an int64 vector, as int32 holding the u32 bits."""
    return mm_hash_long_cuda(data.to(torch.int64).contiguous(), seed & M32)


def xxhash64_raw_int64(data: torch.Tensor,
                       seed: int = DEFAULT_XXHASH64_SEED) -> torch.Tensor:
    """xxhash64 of an int64 vector, as int64 holding the u64 bits."""
    return xx_hash_fixed8_cuda(data.to(torch.int64).contiguous(), seed & M64)


def partition_mix32(data: torch.Tensor) -> torch.Tensor:
    """Cheap 32-bit mix of an int64 key vector for shuffle placement, as int32
    holding the u32 bits: murmur3's k1 mix of each half, the high one rotated
    by 13, xor'd, then fmix32 with length 8.  Not Spark-compatible and never
    user-visible: placement only needs every rank to agree.  It has no kernel
    in either package; it is elementwise int64 torch on any device."""
    v = data.to(torch.int64)
    h = _mm_mix_k1(v & M32) ^ _rotl32(_mm_mix_k1((v >> 32) & M32), 13)
    return _as_int32(_mm_fmix(h, 8))


# ---------------------------------------------------------------------------
# public API (mirrors Hash.java:40-91)
# ---------------------------------------------------------------------------


def _first_size_and_device(columns, name: str):
    if not columns:
        raise ValueError(f"{name} requires at least one column")
    return columns[0].size, columns[0].device


def murmur_hash32(columns: Sequence[HashInput], seed: int = 0) -> Column:
    """Spark-exact Murmur3-32 row hash of the given columns (Hash.java:40-56),
    computed on the columns' device."""
    n, dev = _first_size_and_device(columns, "murmur_hash32")
    h = torch.full((n,), signed32(seed), dtype=torch.int32, device=dev)
    for col in columns:
        h = _hash_column(col, h, mm=True)
    return Column(h, None, INT32)


def xxhash64(columns: Sequence[HashInput], seed: int = DEFAULT_XXHASH64_SEED) -> Column:
    """Spark-exact xxhash64 row hash of the given columns (Hash.java:58-91),
    computed on the columns' device."""
    n, dev = _first_size_and_device(columns, "xxhash64")
    h = torch.full((n,), signed64(seed), dtype=torch.int64, device=dev)
    for col in columns:
        h = _hash_column(col, h, mm=False)
    return Column(h, None, INT64)
