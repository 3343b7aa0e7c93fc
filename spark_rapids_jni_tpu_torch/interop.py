"""Moving columns and bloom filters between the JAX package and the port,
through numpy.

A JAX column's fields give numpy arrays (``np.asarray(col.data)``,
``np.asarray(col.validity)``) and its dtype carries a ``kind`` enum whose
``value`` names the Spark type.  These helpers turn such arrays into port
columns on a chosen device and back, without importing the JAX package:
unsigned arrays (a decimal128 column's ``lo``) cross as the signed tensors of
the same bits.  Both packages name their column fields alike (``data``;
``hi``/``lo``; ``chars``/``offsets``; ``offsets``/``child``; ``children``),
which is what :func:`port_column` reads.  A bloom filter crosses as its
``longs`` (uint64 words in the JAX package, their int64 bits in the port) and
its two sizes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar.column import (
    Column,
    Decimal128Column,
    ListColumn,
    StringColumn,
    StructColumn,
    strings_from_arrays,
)
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType, Kind
from spark_rapids_jni_tpu_torch.ops.bloom_filter import BloomFilter

_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


def port_dtype(dtype) -> DType:
    """The port's DType for a DType of either package (matched by kind name)."""
    if isinstance(dtype, DType):
        return dtype
    return DType(Kind(dtype.kind.value), dtype.precision, dtype.scale)


def tensor_from_numpy(arr, device: _device.DeviceLike = None) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; u16/u32/u64 become the signed
    type of the same width and bits."""
    a = np.ascontiguousarray(arr)
    if a.dtype in _SIGNED:
        a = a.view(_SIGNED[a.dtype])
    return torch.from_numpy(a.copy()).to(_device.resolve(device))


def column_from_numpy(data, validity, dtype,
                      device: _device.DeviceLike = None) -> Column:
    """A port Column from numpy ``data`` and ``validity`` (None == all valid)."""
    dt = port_dtype(dtype)
    valid = None if validity is None else tensor_from_numpy(
        np.asarray(validity, dtype=bool), device)
    return Column(tensor_from_numpy(data, device), valid, dt)


def port_column(col, device: _device.DeviceLike = None):
    """The port column holding the same values as ``col``, a column of either
    package (fixed-width, decimal128, string, list or struct; lists and
    structs recursively).  A string column's ``chars`` are cut to
    ``offsets[-1]``, dropping the JAX package's pow2 over-allocation."""
    v = None if col.validity is None else np.asarray(col.validity, dtype=bool)
    if hasattr(col, "chars"):
        return strings_from_arrays(np.asarray(col.chars), np.asarray(col.offsets), v, device)
    valid = None if v is None else tensor_from_numpy(v, device)
    if hasattr(col, "hi"):
        return Decimal128Column(tensor_from_numpy(np.asarray(col.hi), device),
                                tensor_from_numpy(np.asarray(col.lo), device),
                                valid, port_dtype(col.dtype))
    if hasattr(col, "children"):
        return StructColumn(tuple(port_column(c, device) for c in col.children), valid)
    if hasattr(col, "child"):
        return ListColumn(tensor_from_numpy(np.asarray(col.offsets, dtype=np.int32), device),
                          port_column(col.child, device), valid)
    return column_from_numpy(np.asarray(col.data), v, col.dtype, device)


def column_to_numpy(col) -> Tuple:
    """The numpy fields of a port column, in the order of the JAX package's
    dataclass fields for the same type (its dtype left out), as that package
    holds them: ``(data, validity)``, ``(hi, lo as uint64, validity)``,
    ``(chars, offsets, validity)``, ``(offsets, child, validity)`` or
    ``(children, validity)``, with the fields of nested columns as nested
    tuples.  ``validity`` is None where every row is valid."""
    validity = None if col.validity is None else col.validity.cpu().numpy()
    if isinstance(col, StringColumn):
        return col.chars.cpu().numpy(), col.offsets.cpu().numpy(), validity
    if isinstance(col, Decimal128Column):
        return col.hi.cpu().numpy(), col.lo.cpu().numpy().view(np.uint64), validity
    if isinstance(col, ListColumn):
        return col.offsets.cpu().numpy(), column_to_numpy(col.child), validity
    if isinstance(col, StructColumn):
        return tuple(column_to_numpy(c) for c in col.children), validity
    data = col.data.cpu().numpy()
    if col.dtype.kind == Kind.UINT64:
        data = data.view(np.uint64)
    return data, validity


def port_bloom_filter(jax_filter, device: _device.DeviceLike = None) -> BloomFilter:
    """The port's BloomFilter holding the same words as the JAX package's
    ``jax_filter``, on ``device`` (the card unless the caller asks for the
    CPU)."""
    return BloomFilter(tensor_from_numpy(np.asarray(jax_filter.longs), device),
                       int(jax_filter.num_hashes), int(jax_filter.num_longs))


def bloom_filter_to_numpy(bloom_filter: BloomFilter) -> np.ndarray:
    """A port filter's words as the JAX package holds them: numpy uint64."""
    return bloom_filter.longs.cpu().numpy().view(np.uint64)
