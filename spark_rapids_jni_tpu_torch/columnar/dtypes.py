"""Spark SQL type descriptors for columnar data (PyTorch port).

The same small, explicit descriptor as the JAX package keeps, so ops can
implement Spark-exact semantics (sign extension widths, decimal
precision/scale, hash byte widths) without a host dataframe library.  The
element types are torch dtypes.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Kind(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"
    # Days since unix epoch, int32 (Spark DateType).
    DATE32 = "date32"
    # Microseconds since unix epoch, int64 (Spark TimestampType).
    TIMESTAMP_MICROS = "timestamp[us]"
    TIMESTAMP_MILLIS = "timestamp[ms]"
    TIMESTAMP_SECONDS = "timestamp[s]"
    # Unscaled value in an int32/int64/(int64 hi, uint64 lo) pair; see DType.precision.
    DECIMAL32 = "decimal32"
    DECIMAL64 = "decimal64"
    DECIMAL128 = "decimal128"
    # Nested types (children carried by the column, not the dtype).
    LIST = "list"
    STRUCT = "struct"


# torch's unsigned 64-bit type lacks most arithmetic, so UINT64 columns hold
# their bit patterns in int64.  FLOAT64 columns also store int64 bits (see
# column.column), as the JAX package does.
_TORCH = {
    Kind.BOOL: torch.bool,
    Kind.INT8: torch.int8,
    Kind.INT16: torch.int16,
    Kind.INT32: torch.int32,
    Kind.INT64: torch.int64,
    Kind.UINT8: torch.uint8,
    Kind.UINT64: torch.int64,
    Kind.FLOAT32: torch.float32,
    Kind.FLOAT64: torch.float64,
    Kind.DATE32: torch.int32,
    Kind.TIMESTAMP_MICROS: torch.int64,
    Kind.TIMESTAMP_MILLIS: torch.int64,
    Kind.TIMESTAMP_SECONDS: torch.int64,
    Kind.DECIMAL32: torch.int32,
    Kind.DECIMAL64: torch.int64,
}

_WIDTH = {
    Kind.BOOL: 1,
    Kind.INT8: 1,
    Kind.INT16: 2,
    Kind.INT32: 4,
    Kind.INT64: 8,
    Kind.UINT8: 1,
    Kind.UINT64: 8,
    Kind.FLOAT32: 4,
    Kind.FLOAT64: 8,
    Kind.DATE32: 4,
    Kind.TIMESTAMP_MICROS: 8,
    Kind.TIMESTAMP_MILLIS: 8,
    Kind.TIMESTAMP_SECONDS: 8,
    Kind.DECIMAL32: 4,
    Kind.DECIMAL64: 8,
    Kind.DECIMAL128: 16,
}

# Spark's max decimal precision (matches reference decimal_utils.cu overflow rules).
MAX_DECIMAL_PRECISION = 38
MAX_DECIMAL64_PRECISION = 18
MAX_DECIMAL32_PRECISION = 9


@dataclasses.dataclass(frozen=True)
class DType:
    """A Spark SQL data type. Hashable and static."""

    kind: Kind
    precision: int = 0  # decimals only
    scale: int = 0  # decimals only

    @property
    def is_decimal(self) -> bool:
        return self.kind in (Kind.DECIMAL32, Kind.DECIMAL64, Kind.DECIMAL128)

    @property
    def is_floating(self) -> bool:
        return self.kind in (Kind.FLOAT32, Kind.FLOAT64)

    @property
    def is_integral(self) -> bool:
        return self.kind in (Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64)

    @property
    def fixed_width(self) -> int:
        """Byte width in the JCUDF row format (row_conversion); 0 for variable."""
        return _WIDTH.get(self.kind, 0)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH[self.kind]

    def __repr__(self) -> str:
        if self.is_decimal:
            return f"DType({self.kind.value}({self.precision},{self.scale}))"
        return f"DType({self.kind.value})"


def decimal(precision: int, scale: int) -> DType:
    """Spark decimal type, stored like cuDF picks storage by precision."""
    if precision <= MAX_DECIMAL32_PRECISION:
        kind = Kind.DECIMAL32
    elif precision <= MAX_DECIMAL64_PRECISION:
        kind = Kind.DECIMAL64
    else:
        kind = Kind.DECIMAL128
    return DType(kind, precision, scale)


BOOL = DType(Kind.BOOL)
INT8 = DType(Kind.INT8)
INT16 = DType(Kind.INT16)
INT32 = DType(Kind.INT32)
INT64 = DType(Kind.INT64)
UINT8 = DType(Kind.UINT8)
UINT64 = DType(Kind.UINT64)
FLOAT32 = DType(Kind.FLOAT32)
FLOAT64 = DType(Kind.FLOAT64)
STRING = DType(Kind.STRING)
DATE32 = DType(Kind.DATE32)
TIMESTAMP_MICROS = DType(Kind.TIMESTAMP_MICROS)
TIMESTAMP_MILLIS = DType(Kind.TIMESTAMP_MILLIS)
TIMESTAMP_SECONDS = DType(Kind.TIMESTAMP_SECONDS)
LIST = DType(Kind.LIST)
STRUCT = DType(Kind.STRUCT)
