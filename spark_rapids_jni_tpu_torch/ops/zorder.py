"""DeltaLake z-order clustering ops: interleave_bits and hilbert_index
(PyTorch port of ``ops/zorder.py``).

Spark-exact semantics of the reference's zorder ops (zorder.cu:138
interleave_bits, zorder.cu:224 hilbert_index; Hilbert transform per David
Moten's port of Skilling's "Programming the Hilbert curve", zorder.cu:66-74).

Both ops are dense bit-plane arithmetic over int64 lanes:

- ``interleave_bits``: each value is exploded to a big-endian bit plane
  ``bits[n, width]`` (arithmetic right shifts of the int64 value and a mask
  of 1: bit k of the two's-complement pattern at every k); the interleave is
  a transpose to ``bits[n, width*ncols]``, packed back to bytes with shifts
  and ors.
- ``hilbert_index``: Skilling's inverse-undo loop has a static trip count
  (num_bits x num_dims <= 64), so it unrolls into xor/select lane ops over
  ``x[dim][n]`` vectors.  The JAX package holds those as uint32; torch's
  unsigned types lack shifts, so the port holds each u32 value in int64
  (never negative, so every shift is logical) and builds the 64-bit distance
  in int64 bits.

Null handling matches the reference: null cells read as 0 and the outputs
carry no null mask (zorder.cu:205-207,:262).
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_jni_tpu_torch.columnar.column import Column, ListColumn
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType, Kind, UINT8
from spark_rapids_jni_tpu_torch.utils.floatbits import f32_to_bits


def _to_bit_planes(col: Column, width_bits: int) -> torch.Tensor:
    """``bits[n, width_bits]`` uint8 of each value, most significant bit first.

    Nulls read as 0 (matches zorder.cu:205 ``column.is_valid(...) ? data : 0``).
    """
    data = col.data
    if col.dtype.kind == Kind.FLOAT32:
        # interleave operates on the IEEE-754 bit pattern, not the value
        # (FLOAT64 columns already store their bits in int64; see columnar.column)
        data = f32_to_bits(data)
    v = data.to(torch.int64)
    if col.validity is not None:
        v = torch.where(col.validity, v, 0)
    shifts = torch.arange(width_bits - 1, -1, -1, dtype=torch.int64, device=v.device)
    return ((v[:, None] >> shifts[None, :]) & 1).to(torch.uint8)


def _pack_bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """``bits[n, 8*k]`` uint8 (MSB first) -> ``bytes[n, k]`` uint8."""
    n, total = bits.shape
    assert total % 8 == 0
    grouped = bits.reshape(n, total // 8, 8)
    out = torch.zeros((n, total // 8), dtype=torch.uint8, device=bits.device)
    for j in range(8):
        out |= grouped[:, :, j] << (7 - j)
    return out


def interleave_bits(columns: Sequence[Column]) -> ListColumn:
    """DeltaLake ``interleaveBits``: LIST<UINT8> of round-robin interleaved bits.

    Bit ``b`` (MSB-first) of every column is emitted before bit ``b+1`` of any,
    column 0 first: the deltalake source-of-truth loop shape
    (InterleaveBitsTest.java:44-66).  Output row width is
    ``ncols * value_byte_width`` bytes.
    """
    if not columns:
        raise ValueError("The input table must have at least one column.")
    kinds = {c.dtype.kind for c in columns}
    if len(kinds) != 1:
        raise TypeError("All columns of the input table must be the same type.")
    width_bytes = columns[0].dtype.fixed_width
    if width_bytes == 0 or not all(isinstance(c, Column) for c in columns):
        raise TypeError("Only fixed width columns can be used")
    if any(c.size != columns[0].size for c in columns):
        raise ValueError("All columns of the input table must be the same size.")
    n = columns[0].size
    ncols = len(columns)
    width_bits = width_bytes * 8

    # bits[n, ncols, width_bits] -> [n, width_bits, ncols] so that flattening
    # yields (bit0 of col0, bit0 of col1, ..., bit1 of col0, ...)
    planes = torch.stack([_to_bit_planes(c, width_bits) for c in columns], dim=1)
    interleaved = planes.transpose(1, 2).reshape(n, width_bits * ncols)
    data = _pack_bits_to_bytes(interleaved).reshape(n * width_bytes * ncols)

    row_bytes = width_bytes * ncols
    offsets = torch.arange(n + 1, dtype=torch.int32, device=data.device) * row_bytes
    return ListColumn(offsets, Column(data, None, UINT8), None)


def hilbert_index(num_bits_per_entry: int, columns: Sequence[Column]) -> Column:
    """Hilbert-curve distance of each row's point (zorder.cu:224).

    Each INT32 column is one coordinate using the low ``num_bits_per_entry``
    bits; the result is the INT64 position along the ``ndims``-dimensional
    Hilbert curve (Skilling transpose + gray decode, zorder.cu:95-133).
    """
    if not (0 < num_bits_per_entry <= 32):
        raise ValueError("the number of bits must be >0 and <= 32.")
    if not columns:
        raise ValueError("at least one column is required.")
    ndims = len(columns)
    if num_bits_per_entry * ndims > 64:
        raise ValueError("we only support up to 64 bits of output right now.")
    for c in columns:
        if not isinstance(c, Column) or c.dtype.kind != Kind.INT32:
            raise TypeError("All columns of the input table must be INT32.")
        if c.size != columns[0].size:
            raise ValueError("All columns of the input table must be the same size.")

    nb = num_bits_per_entry
    mask_val = (1 << nb) - 1
    x = []
    for c in columns:
        v = c.data.to(torch.int64) & mask_val  # the u32 value, held in int64
        if c.validity is not None:
            v = torch.where(c.validity, v, 0)
        x.append(v)

    # Inverse undo (static unroll: nb-1 outer x ndims inner iterations).
    m = 1 << (nb - 1)
    q = m
    while q > 1:
        p = q - 1
        for i in range(ndims):
            cond = (x[i] & q) != 0
            if i == 0:
                x[0] = torch.where(cond, x[0] ^ p, x[0])
            else:
                t = (x[0] ^ x[i]) & p
                x0_else, xi_else = x[0] ^ t, x[i] ^ t
                x[0] = torch.where(cond, x[0] ^ p, x0_else)
                x[i] = torch.where(cond, x[i], xi_else)
        q >>= 1

    # Gray encode.
    for i in range(1, ndims):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = m
    while q > 1:
        t = torch.where((x[ndims - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    for i in range(ndims):
        x[i] = x[i] ^ t

    # Transposed form -> distance: bit (nb-1-i) of each dim j, MSB-first
    # (zorder.cu:76-93 to_hilbert_index); at most 64 bits, so the int64
    # shifts hold the u64 distance's bits
    b = torch.zeros_like(x[0])
    for i in range(nb - 1, -1, -1):
        for j in range(ndims):
            b = (b << 1) | ((x[j] >> i) & 1)
    return Column(b, None, DType(Kind.INT64))
