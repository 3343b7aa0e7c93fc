"""Columnar table shuffle: ``all_to_all`` of whole batches over the mesh
(PyTorch port of ``parallel/table_shuffle.py``).

Fixed-width columns travel with their validity, DECIMAL128 columns as their
(hi, lo) limb pairs with validity, and string columns as a dense padded
``bytes[n, width]`` rectangle plus lengths and validity
(:class:`PaddedStrings`), so that every buffer is one equal-split collective
payload.  :func:`materialize_strings` turns a received padded column back
into Arrow chars and offsets.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from spark_rapids_jni_tpu_torch.columnar.column import (
    Column,
    Decimal128Column,
    StringColumn,
    strings_from_padded,
)
from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS
from spark_rapids_jni_tpu_torch.parallel.shuffle import all_to_all_shuffle

__all__ = [
    "PaddedStrings",
    "ShuffledTable",
    "pad_strings",
    "shuffle_table",
    "materialize_strings",
]


class PaddedStrings(NamedTuple):
    """Exchange form of a string column: dense padded bytes + lengths."""

    bytes: torch.Tensor  # uint8[n, width]
    lengths: torch.Tensor  # int32[n]
    validity: torch.Tensor  # bool[n]


class ShuffledTable(NamedTuple):
    columns: Dict[str, object]  # Column / Decimal128Column / PaddedStrings
    valid: torch.Tensor  # bool[ndev * capacity] slot occupancy
    dropped: torch.Tensor  # int32: local rows lost to capacity overflow


def pad_strings(col: StringColumn, width: Optional[int] = None) -> PaddedStrings:
    """Padded exchange view of a string column, ``width`` bytes a row (the
    longest row's length when omitted)."""
    b, lens = col.padded(width)
    return PaddedStrings(b, lens, col.is_valid())


def shuffle_table(columns: Dict[str, object], part: torch.Tensor, capacity: int,
                  mesh: DeviceMesh, axis: str = DATA_AXIS,
                  row_valid: Optional[torch.Tensor] = None) -> ShuffledTable:
    """Exchange a table so that each rank receives the rows whose ``part`` is
    its index along ``axis``.  Each column's validity survives the exchange
    and is masked with slot occupancy on arrival, so pad slots read as nulls.
    A :class:`StringColumn` must be padded first (:func:`pad_strings`)."""
    flat: Dict[str, torch.Tensor] = {}
    kinds: Dict[str, tuple] = {}
    for name, col in columns.items():
        if isinstance(col, Column):
            flat[name + ".data"] = col.data
            flat[name + ".v"] = col.is_valid()
            kinds[name] = ("fixed", col.dtype)
        elif isinstance(col, Decimal128Column):
            flat[name + ".hi"] = col.hi
            flat[name + ".lo"] = col.lo
            flat[name + ".v"] = col.is_valid()
            kinds[name] = ("dec128", col.dtype)
        elif isinstance(col, PaddedStrings):
            flat[name + ".bytes"] = col.bytes
            flat[name + ".len"] = col.lengths
            flat[name + ".v"] = col.validity
            kinds[name] = ("strings", None)
        elif isinstance(col, StringColumn):
            raise TypeError(f"column {name!r}: convert the StringColumn to PaddedStrings "
                            "(pad_strings) before shuffling")
        else:
            raise TypeError(f"column {name!r}: unsupported type {type(col)}")

    res = all_to_all_shuffle(flat, part, capacity, mesh, axis, row_valid=row_valid)
    r = res.columns
    out: Dict[str, object] = {}
    for name, (kind, dtype) in kinds.items():
        v = r[name + ".v"] & res.valid
        if kind == "fixed":
            out[name] = Column(r[name + ".data"], v, dtype)
        elif kind == "dec128":
            out[name] = Decimal128Column(r[name + ".hi"], r[name + ".lo"], v, dtype)
        else:
            out[name] = PaddedStrings(r[name + ".bytes"], r[name + ".len"], v)
    return ShuffledTable(out, res.valid, res.dropped)


def materialize_strings(ps: PaddedStrings) -> StringColumn:
    """Arrow chars + offsets of a received padded string column; pad slots
    and null rows become nulls of length 0."""
    return strings_from_padded(ps.bytes, torch.where(ps.validity, ps.lengths, 0), ps.validity)
