"""Spark-exact row hashing over fixed-width columns: murmur3-32 and xxhash64.

PyTorch port of the fixed-width half of ``spark_rapids_jni_tpu/ops/hashing.py``
(the reference's ``murmur_hash.cu`` + ``xxhash64.cu``).  Spark's conventions:

- the running hash is the *seed* for the next column (serial chaining);
- a null element contributes nothing: the seed passes through;
- floats/doubles normalize NaN -> canonical quiet NaN and -0.0 -> +0.0;
- DECIMAL32/64 hash their unscaled value as an 8-byte long.

Each column's contribution goes through a wrapper of ``hash_cuda``, which
launches the CUDA kernel for a tensor on the card and runs the plain version
for a tensor on the CPU: the device of the data decides, nothing else.
String, decimal128, struct and list columns arrive with the column-hash slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.columnar.dtypes import INT32, INT64, Kind
from spark_rapids_jni_tpu_torch.ops.hash_cuda import (
    M32,
    M64,
    mm_hash_int_cuda,
    mm_hash_long_cuda,
    signed32,
    signed64,
    xx_hash_fixed4_cuda,
    xx_hash_fixed8_cuda,
)

DEFAULT_XXHASH64_SEED = 42  # hash.cuh:29

_LATER = (Kind.STRING, Kind.DECIMAL128, Kind.LIST, Kind.STRUCT)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"hashing {what} is not ported yet: string, decimal128, struct and list "
        "inputs arrive with the column-hash slice")


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


def _hash_element(col: Column, h: torch.Tensor, *, mm: bool) -> torch.Tensor:
    """One column's contribution: h' per row, ignoring validity (caller masks)."""
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
    if kind in _LATER:
        raise _not_ported(f"{col.dtype} columns")
    raise ValueError(f"unsupported column type for hashing: {col.dtype}")


def _hash_column(col: Column, h: torch.Tensor, *, mm: bool) -> torch.Tensor:
    """Chain one column into the running hash, with Spark's null rule."""
    if not isinstance(col, Column):
        raise _not_ported(type(col).__name__)
    upd = _hash_element(col, h, mm=mm)
    if col.validity is None:
        return upd
    return torch.where(col.validity, upd, h)


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


# ---------------------------------------------------------------------------
# public API (mirrors Hash.java:40-91)
# ---------------------------------------------------------------------------


def _first_size_and_device(columns, name: str):
    if not columns:
        raise ValueError(f"{name} requires at least one column")
    first = columns[0]
    if not isinstance(first, Column):
        raise _not_ported(type(first).__name__)
    return first.size, first.device


def murmur_hash32(columns: Sequence[Column], seed: int = 0) -> Column:
    """Spark-exact Murmur3-32 row hash of the given columns (Hash.java:40-56),
    computed on the columns' device."""
    n, dev = _first_size_and_device(columns, "murmur_hash32")
    h = torch.full((n,), signed32(seed), dtype=torch.int32, device=dev)
    for col in columns:
        h = _hash_column(col, h, mm=True)
    return Column(h, None, INT32)


def xxhash64(columns: Sequence[Column], seed: int = DEFAULT_XXHASH64_SEED) -> Column:
    """Spark-exact xxhash64 row hash of the given columns (Hash.java:58-91),
    computed on the columns' device."""
    n, dev = _first_size_and_device(columns, "xxhash64")
    h = torch.full((n,), signed64(seed), dtype=torch.int64, device=dev)
    for col in columns:
        h = _hash_column(col, h, mm=False)
    return Column(h, None, INT64)
