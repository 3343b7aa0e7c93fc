"""Split-planned parquet reading into port Columns (PyTorch port of
``io/parquet_read.py``).

The footer filter IS the planner (parity: ``filter_groups`` feeding the
columnar reader, NativeParquetJni.cpp:584 / ParquetFooter.java:190-215):
``read_split`` parses the file's thrift footer with
:class:`~spark_rapids_jni_tpu_torch.io.ParquetFooter`, prunes its schema to
the expected columns, selects the row groups whose byte midpoint falls inside
``[part_offset, part_offset + part_length)``, and then materializes ONLY
those groups and ONLY the surviving columns through the host columnar
decoder (pyarrow -- the cuIO stand-in on this host path; the reference JNI
likewise plans on the CPU and hands the filtered footer to a separate
reader).  Byte-range splits partition a file: every row group belongs to
exactly one split, so N executors reading N splits see each row exactly
once.

Columns come back in the port's layout on the caller's device (the card
unless the caller asks for the CPU): fixed-width data as ``Column``
(FLOAT64 as IEEE-754 bits in int64, the columnar convention), DECIMAL by
precision as ``Column`` or ``Decimal128Column``, strings as
``StringColumn``.  pyarrow is imported inside the functions that decode, so
importing this module needs none.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.io.parquet_footer import ParquetFooter, StructElement

__all__ = ["footer_bytes", "plan_byte_splits", "read_split",
           "iter_split_batches", "SplitPlan"]

_MAGIC = b"PAR1"


def footer_bytes(path: str) -> bytes:
    """The raw thrift FileMetaData bytes of a parquet file (no magic)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        f.seek(max(0, size - 8))
        tail = f.read(8)
        if tail[-4:] != _MAGIC:
            raise ValueError(f"{path}: not a parquet file (missing PAR1)")
        n = int.from_bytes(tail[:4], "little")
        f.seek(size - 8 - n)
        return f.read(n)


def plan_byte_splits(path: str, n_splits: int) -> List[Tuple[int, int]]:
    """Even byte-range splits of a file, Spark-style ``(offset, length)``.

    The ranges partition ``[0, file_size)`` exactly -- never a negative or
    zero length (a negative length would read as read_and_filter's
    "filtering disabled" mode and double-count every row group) -- so the
    midpoint rule assigns each row group to exactly one split.  Asking
    for more splits than bytes yields fewer splits.
    """
    size = os.path.getsize(path)
    n_splits = max(1, min(n_splits, max(1, size)))
    bounds = sorted({i * size // n_splits for i in range(n_splits)} | {size})
    return [(lo, hi - lo) for lo, hi in zip(bounds, bounds[1:]) if hi > lo]


class SplitPlan:
    """What one executor reads of one file: surviving row-group indices +
    surviving column projection, both decided by the filtered footer."""

    def __init__(self, path: str, group_indexes: List[int],
                 columns: List[str], num_rows: int):
        self.path = path
        self.group_indexes = group_indexes
        self.columns = columns
        self.num_rows = num_rows


def plan_split(path: str, part_offset: int, part_length: int,
               schema: StructElement, ignore_case: bool = False) -> SplitPlan:
    """Plan a split: ONE footer parse yields both the surviving row-group
    indices and the pruned column projection."""
    fb = footer_bytes(path)
    footer = ParquetFooter.read_and_filter(
        fb, part_offset, part_length, schema, ignore_case)
    return SplitPlan(path, footer.kept_group_indexes,
                     footer.column_names, footer.num_rows)


def _arrow_to_column(arr, dev: torch.device):
    """One pyarrow ChunkedArray/Array -> a port Column, Decimal128Column or
    StringColumn on ``dev``."""
    import pyarrow as pa

    from spark_rapids_jni_tpu_torch import columnar as c

    def t(a):
        return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(dev)

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    typ = arr.type
    if pa.types.is_string(typ) or pa.types.is_large_string(typ):
        return c.strings_from_bytes(
            [v.as_py().encode() if v.is_valid else None for v in arr], dev)

    validity = None
    if arr.null_count:
        validity = t(np.asarray(arr.is_valid()))

    if pa.types.is_decimal128(typ):
        # Parquet DECIMAL(p, s) -> unscaled storage by precision, the same
        # storage rule as dtypes.decimal(): int32/int64 Columns for p<=9 /
        # p<=18, two's-complement limb pairs above (the reference's pruner
        # round-trips the decimal Tag tree, NativeParquetJni.cpp:102-109).
        # Arrow decimal128 buffers are 16-byte little-endian two's
        # complement; decode limbs straight from the buffer.
        n = len(arr)
        raw = np.frombuffer(arr.buffers()[1], np.uint8)
        raw = raw[arr.offset * 16:(arr.offset + n) * 16].reshape(n, 16)
        lo = raw[:, :8].copy().view("<i8").ravel()  # the low word's bits
        hi = raw[:, 8:].copy().view("<i8").ravel()
        dt = c.decimal(typ.precision, typ.scale)
        if dt.kind == c.Kind.DECIMAL128:
            return c.Decimal128Column(t(hi), t(lo), validity, dt)
        # p<=18 fits the low limb exactly (int64 two's complement)
        unscaled = lo.astype(np.int32) if dt.kind == c.Kind.DECIMAL32 else lo
        return c.Column(t(unscaled), validity, dt)
    if pa.types.is_int32(typ):
        np_vals, dt = arr.fill_null(0).to_numpy().astype(np.int32), c.INT32
    elif pa.types.is_int64(typ):
        np_vals, dt = arr.fill_null(0).to_numpy().astype(np.int64), c.INT64
    elif pa.types.is_float64(typ):
        # FLOAT64 columns carry IEEE-754 bits as int64 (columnar convention)
        np_vals = arr.fill_null(0.0).to_numpy().astype(np.float64)
        np_vals, dt = np_vals.view(np.int64), c.FLOAT64
    elif pa.types.is_date32(typ):
        np_vals = np.asarray(arr.fill_null(0).cast(pa.int32()))
        dt = c.DATE32
    elif pa.types.is_timestamp(typ) and typ.unit == "us":
        np_vals = np.asarray(arr.fill_null(0).cast(pa.int64()))
        dt = c.TIMESTAMP_MICROS
    else:
        raise NotImplementedError(f"parquet_read: unsupported type {typ}")
    return c.Column(t(np_vals), validity, dt)


def _table_columns(table, columns, as_numpy: bool,
                   dev: Optional[torch.device]) -> Dict[str, object]:
    """One decoded arrow table -> port Columns on ``dev`` (or, with
    ``as_numpy``, raw ``(values, validity)`` host pairs)."""
    import pyarrow as pa

    out: Dict[str, object] = {}
    for name in columns:
        col = table.column(name)
        if as_numpy:
            arr = col.combine_chunks() if isinstance(
                col, pa.ChunkedArray) else col
            valid: Optional[np.ndarray] = None
            if arr.null_count:
                valid = np.asarray(arr.is_valid())
            if pa.types.is_string(arr.type):
                vals = [v.as_py() if v.is_valid else None for v in arr]
            else:
                filled = arr.fill_null(0)
                try:
                    # decimals need an explicit copy (object array of
                    # decimal.Decimal); numeric types stay zero-copy
                    vals = filled.to_numpy(zero_copy_only=False)
                except TypeError:  # ChunkedArray.to_numpy always copies
                    vals = filled.to_numpy()
            out[name] = (vals, valid)
        else:
            out[name] = _arrow_to_column(col, dev)
    return out


def read_split(path: str, part_offset: int, part_length: int,
               schema: StructElement, ignore_case: bool = False,
               as_numpy: bool = False,
               device: _device.DeviceLike = None) -> Dict[str, object]:
    """Read one split of one parquet file into port Columns on ``device``
    (the card unless the caller asks for the CPU).

    Only the row groups the footer filter selected and only the columns
    surviving the schema prune are ever decoded -- the projection list
    handed to the decoder comes from the filtered footer itself.  With
    ``as_numpy`` the raw host arrays are returned instead of Columns
    (for host-side pipelines that shard before upload); no device is
    touched then.
    """
    import pyarrow.parquet as pq

    dev = None if as_numpy else _device.resolve(device)
    plan = plan_split(path, part_offset, part_length, schema, ignore_case)
    pf = pq.ParquetFile(path)
    tables = [pf.read_row_group(g, columns=plan.columns)
              for g in plan.group_indexes]
    if tables:
        import pyarrow as pa

        table = pa.concat_tables(tables)
    else:
        table = pf.schema_arrow.empty_table().select(plan.columns)
    if table.num_rows != plan.num_rows:
        raise AssertionError(
            f"{path}: footer planned {plan.num_rows} rows, "
            f"decoder produced {table.num_rows}")
    return _table_columns(table, plan.columns, as_numpy, dev)


def iter_split_batches(path: str, part_offset: int, part_length: int,
                       schema: StructElement, ignore_case: bool = False,
                       as_numpy: bool = False,
                       device: _device.DeviceLike = None):
    """Chunked scan of one split: yield ONE decoded batch per surviving
    row group, never materializing the whole split.

    This is the composition of the footer planner with out-of-core
    execution: each batch feeds the external grace-hash shuffle
    (io/spill.py) with host memory bounded by a single row group -- the
    reason the reference's footer filter exists is to plan scans of files
    too big to hold (NativeParquetJni.cpp:584 filter_groups handing the
    filtered footer to a chunked reader).  The split's planned row count
    is re-checked across the yielded batches.
    """
    import pyarrow.parquet as pq

    dev = None if as_numpy else _device.resolve(device)
    plan = plan_split(path, part_offset, part_length, schema, ignore_case)
    pf = pq.ParquetFile(path)
    got = 0
    for g in plan.group_indexes:
        table = pf.read_row_group(g, columns=plan.columns)
        got += table.num_rows
        yield _table_columns(table, plan.columns, as_numpy, dev)
    if got != plan.num_rows:
        raise AssertionError(
            f"{path}: footer planned {plan.num_rows} rows, "
            f"chunked decoder produced {got}")
