"""Arrow-layout columns as torch tensors (PyTorch port of columnar/column.py).

Every column carries an optional unpacked ``validity[n]`` bool tensor (None ==
all valid) and lives on one device:

- fixed-width: ``data[n]``.  FLOAT64 columns store the IEEE-754 bit pattern in
  int64, as the JAX package does, so the double paths stay pure integer
  arithmetic and the two packages compare like with like;
- decimal128: two's-complement ``(hi int64, lo int64)`` per row; ``lo`` holds
  the bits of the JAX package's uint64 low word;
- strings and binary: Arrow ``chars[total]`` (uint8) + ``offsets[n+1]`` (int32).
  ``chars`` is exactly ``offsets[-1]`` bytes: the hash kernel reads each row's
  bytes where they lie, so no pow2 over-allocation.  A dense padded view
  (``padded`` / ``strings_from_padded``) serves only the table shuffle;
- list: ``offsets[n+1]`` into a child column; struct: equal-length children.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType, Kind, LIST, STRING, STRUCT
from spark_rapids_jni_tpu_torch.obs.seam import TRANSFER, instrument


def _apply_nulls(vals: list, validity: Optional[torch.Tensor]) -> list:
    if validity is None:
        return vals
    return [v if m else None for v, m in zip(vals, validity.cpu().tolist())]


def _all_valid(size: int, device: torch.device) -> torch.Tensor:
    return torch.ones((size,), dtype=torch.bool, device=device)


def _check_offsets(what: str, offsets: torch.Tensor, end: int, end_name: str,
                   validity: Optional[torch.Tensor]) -> None:
    """The Arrow invariants that the hash kernel relies on, checked once where
    a column is built: ``offsets`` is a 1-D int32 tensor of n+1 entries that
    starts at 0, never decreases and ends within ``end`` (the bytes of
    ``chars``, or the rows of a list's child), and ``validity`` is None or
    one bool per row on the same device."""
    if not isinstance(offsets, torch.Tensor) or offsets.dtype != torch.int32 or \
            offsets.dim() != 1 or offsets.numel() == 0:
        raise ValueError(f"{what}: offsets must be a 1-D int32 tensor of n+1 entries")
    if validity is not None and (validity.dtype != torch.bool or
                                 validity.shape != (offsets.numel() - 1,) or
                                 validity.device != offsets.device):
        raise ValueError(f"{what}: validity must be None or one bool per row on "
                         f"{offsets.device}")
    first, decreasing, past = torch.stack([
        offsets[0] != 0, (offsets[1:] < offsets[:-1]).any(), offsets[-1] > end]).tolist()
    if first:
        raise ValueError(f"{what}: offsets must start at 0")
    if decreasing:
        raise ValueError(f"{what}: offsets must not decrease")
    if past:
        raise ValueError(f"{what}: offsets must end within {end_name} ({end})")


@dataclasses.dataclass
class Column:
    """Fixed-width column: data[n] with optional validity[n] (True == valid)."""

    data: torch.Tensor
    validity: Optional[torch.Tensor]
    dtype: DType

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def size(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def is_valid(self) -> torch.Tensor:
        if self.validity is None:
            return _all_valid(self.size, self.device)
        return self.validity

    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int((~self.validity).sum())

    def to_list(self):
        """Host materialization with None for nulls (test/oracle use)."""
        data = self.data.cpu().numpy()
        if self.dtype.kind == Kind.BOOL:
            vals = [bool(v) for v in data]
        elif self.dtype.kind == Kind.FLOAT64:
            vals = [float(v) for v in data.view(np.float64)]
        elif self.dtype.is_floating:
            vals = [float(v) for v in data]
        else:
            vals = [int(v) for v in data]
        return _apply_nulls(vals, self.validity)


@dataclasses.dataclass
class Decimal128Column:
    """DECIMAL128 column as two's-complement (hi, lo) 64-bit limb pairs."""

    hi: torch.Tensor  # int64
    lo: torch.Tensor  # int64 holding the unsigned low word's bits
    validity: Optional[torch.Tensor]
    dtype: DType  # kind == DECIMAL128, carries precision/scale

    def __len__(self) -> int:
        return self.hi.shape[0]

    @property
    def size(self) -> int:
        return self.hi.shape[0]

    @property
    def device(self) -> torch.device:
        return self.hi.device

    def is_valid(self) -> torch.Tensor:
        if self.validity is None:
            return _all_valid(self.size, self.device)
        return self.validity

    def unscaled_to_list(self):
        """Unscaled int128 values (or None), reconstructed on the host."""
        hi = self.hi.cpu().tolist()
        lo = self.lo.cpu().tolist()
        vals = [h * (1 << 64) + (lo_ & 0xFFFFFFFFFFFFFFFF) for h, lo_ in zip(hi, lo)]
        return _apply_nulls(vals, self.validity)

    def to_list(self):
        """Decimal values, the unscaled ones times 10**-scale (None for nulls)."""
        import decimal as pydec

        scale = self.dtype.scale
        return [None if v is None else pydec.Decimal(v).scaleb(-scale)
                for v in self.unscaled_to_list()]


@dataclasses.dataclass
class StringColumn:
    """UTF-8 string or binary column in Arrow layout: row i is
    ``chars[offsets[i]:offsets[i+1]]``."""

    chars: torch.Tensor  # uint8[offsets[-1]]
    offsets: torch.Tensor  # int32[n+1]
    validity: Optional[torch.Tensor]
    dtype: DType = STRING

    def __post_init__(self):
        if not isinstance(self.chars, torch.Tensor) or self.chars.dtype != torch.uint8 or \
                self.chars.dim() != 1 or self.chars.device != getattr(self.offsets, "device",
                                                                      None):
            raise ValueError("StringColumn: chars must be a 1-D uint8 tensor on the "
                             "offsets' device")
        _check_offsets("StringColumn", self.offsets, self.chars.numel(), "chars",
                       self.validity)

    def __len__(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def size(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def is_valid(self) -> torch.Tensor:
        if self.validity is None:
            return _all_valid(self.size, self.device)
        return self.validity

    def lengths(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def max_len(self) -> int:
        """The longest row's byte length (0 for no rows), read on the host."""
        return int(self.lengths().max()) if self.size else 0

    def padded(self, max_len: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense ``(bytes[n, max_len] uint8, lengths[n] int32)`` view: each row
        right-padded with zeros (cut at ``max_len`` if longer).  ``max_len``
        defaults to the longest row, and is at least 1."""
        if max_len is None:
            max_len = max(self.max_len(), 1)
        lens = self.lengths()
        pos = torch.arange(max_len, dtype=torch.int64, device=self.device)
        in_row = pos[None, :] < lens[:, None]
        if self.chars.numel() == 0:
            return torch.zeros((self.size, max_len), dtype=torch.uint8, device=self.device), lens
        idx = torch.clamp(self.offsets[:-1, None].to(torch.int64) + pos[None, :],
                          max=self.chars.numel() - 1)
        return torch.where(in_row, self.chars[idx], 0), lens

    def to_list(self):
        chars = self.chars.cpu().numpy().tobytes()
        offs = self.offsets.cpu().tolist()
        vals = [chars[offs[i]:offs[i + 1]].decode("utf-8", errors="surrogatepass")
                for i in range(self.size)]
        return _apply_nulls(vals, self.validity)


@dataclasses.dataclass
class ListColumn:
    """LIST column: offsets[n+1] into a child column."""

    offsets: torch.Tensor  # int32[n+1]
    child: Any
    validity: Optional[torch.Tensor]
    dtype: DType = LIST

    def __post_init__(self):
        if self.child.device != getattr(self.offsets, "device", None):
            raise ValueError("ListColumn: child and offsets on different devices")
        _check_offsets("ListColumn", self.offsets, self.child.size, "the child's rows",
                       self.validity)

    def __len__(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def size(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def is_valid(self) -> torch.Tensor:
        if self.validity is None:
            return _all_valid(self.size, self.device)
        return self.validity

    def to_list(self):
        """Each row as a python list of its child's values (None for nulls)."""
        child = self.child.to_list()
        offs = self.offsets.cpu().tolist()
        return _apply_nulls([child[offs[i]:offs[i + 1]] for i in range(self.size)],
                            self.validity)


@dataclasses.dataclass
class StructColumn:
    """STRUCT column: tuple of equal-length children."""

    children: Tuple[Any, ...]
    validity: Optional[torch.Tensor]
    dtype: DType = STRUCT

    def __len__(self) -> int:
        return self.children[0].size

    @property
    def size(self) -> int:
        return self.children[0].size

    @property
    def device(self) -> torch.device:
        return self.children[0].device

    def is_valid(self) -> torch.Tensor:
        if self.validity is None:
            return _all_valid(self.size, self.device)
        return self.validity

    def to_list(self):
        """Each row as a tuple of its children's values (None for nulls)."""
        return _apply_nulls(list(zip(*(c.to_list() for c in self.children))),
                            self.validity)


def _validity_from(values: Sequence, dev: torch.device) -> Optional[torch.Tensor]:
    if any(v is None for v in values):
        return torch.tensor([v is not None for v in values], dtype=torch.bool, device=dev)
    return None


@instrument(TRANSFER, "column")
def column(values: Sequence, dtype: DType, device: _device.DeviceLike = None) -> Column:
    """Build a fixed-width Column from a python sequence (None == null) on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    zero = False if dtype.kind == Kind.BOOL else 0
    filled = [zero if v is None else v for v in values]
    if dtype.kind == Kind.FLOAT64:
        arr = np.array(filled, dtype=np.float64).view(np.int64)
    else:
        np_dtype = np.dtype(str(dtype.torch_dtype).removeprefix("torch."))
        arr = np.array(filled, dtype=np_dtype)
    return Column(torch.from_numpy(arr).to(dev), _validity_from(values, dev), dtype)


@instrument(TRANSFER, "decimal128_column")
def decimal128_column(unscaled: Sequence, precision: int, scale: int,
                      device: _device.DeviceLike = None) -> Decimal128Column:
    """Build a Decimal128Column from python-int unscaled values (None == null)."""
    dev = _device.resolve(device)
    hi = np.zeros(len(unscaled), dtype=np.int64)
    lo = np.zeros(len(unscaled), dtype=np.uint64)
    for i, v in enumerate(unscaled):
        if v is None:
            continue
        v128 = v & ((1 << 128) - 1)  # two's complement
        hi[i] = np.uint64(v128 >> 64).astype(np.int64)
        lo[i] = np.uint64(v128 & 0xFFFFFFFFFFFFFFFF)
    return Decimal128Column(torch.from_numpy(hi).to(dev),
                            torch.from_numpy(lo.view(np.int64)).to(dev),
                            _validity_from(unscaled, dev),
                            DType(Kind.DECIMAL128, precision, scale))


def strings_from_arrays(chars, offsets, validity=None,
                        device: _device.DeviceLike = None) -> StringColumn:
    """Build a StringColumn from numpy ``chars`` (uint8), ``offsets`` (int32,
    n+1 of them) and ``validity`` (bool or None), for batches too large for
    python strings.  Checks the Arrow invariants the hash kernel relies on:
    offsets start at 0, never decrease, and end within ``chars``; ``chars``
    is cut to ``offsets[-1]``."""
    dev = _device.resolve(device)
    offs = np.ascontiguousarray(offsets, dtype=np.int32)
    buf = np.ascontiguousarray(chars, dtype=np.uint8).reshape(-1)
    # cut to offsets[-1]; offsets that overrun chars are left for the column to refuse
    buf = buf[:max(int(offs[-1]), 0)] if offs.ndim == 1 and offs.size else buf[:0]
    valid = None if validity is None else torch.from_numpy(np.array(validity, dtype=bool)).to(dev)
    return StringColumn(torch.from_numpy(buf.copy()).to(dev), torch.from_numpy(offs.copy()).to(dev),
                        valid)


def strings_from_padded(padded: torch.Tensor, lengths: torch.Tensor,
                        validity: Optional[torch.Tensor] = None) -> StringColumn:
    """Arrow layout from a dense padded view, the inverse of
    :meth:`StringColumn.padded`: row i is the first ``lengths[i]`` bytes of
    ``padded[i]``, every length in [0, width].  ``chars`` holds exactly the
    rows' bytes, read in row order."""
    n, width = padded.shape
    lens = lengths.to(torch.int32)
    if n and bool(((lens < 0) | (lens > width)).any()):
        raise ValueError(f"strings_from_padded: lengths must lie in [0, {width}]")
    offsets = torch.zeros((n + 1,), dtype=torch.int32, device=padded.device)
    offsets[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    in_row = torch.arange(width, device=padded.device)[None, :] < lens[:, None]
    return StringColumn(padded[in_row], offsets, validity)


def _strings_from_bytes(values: Sequence[Optional[bytes]],
                        device: _device.DeviceLike) -> StringColumn:
    bufs = [b"" if v is None else v for v in values]
    offsets = np.zeros(len(bufs) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(b) for b in bufs], dtype=np.int64)
    chars = np.frombuffer(b"".join(bufs), dtype=np.uint8)
    validity = [v is not None for v in values]
    return strings_from_arrays(chars, offsets, None if all(validity) else validity, device)


@instrument(TRANSFER, "strings_from_bytes")
def strings_from_bytes(values: Sequence[Optional[bytes]],
                       device: _device.DeviceLike = None) -> StringColumn:
    """Build a StringColumn from raw byte strings (None == null)."""
    return _strings_from_bytes(values, device)


@instrument(TRANSFER, "strings_column")
def strings_column(values: Sequence[Optional[str]],
                   device: _device.DeviceLike = None) -> StringColumn:
    """Build a StringColumn from python strings (None == null).  Unpaired
    surrogates are encoded with surrogatepass, matching the JVM's permissive
    UTF-8 handling in the reference tests.  Crosses its own seam only, as the
    JAX package's does: it shares an unseamed body with
    :func:`strings_from_bytes`."""
    return _strings_from_bytes(
        [None if v is None else v.encode("utf-8", errors="surrogatepass") for v in values],
        device)


def next_pow2(total: int) -> int:
    """Next power of two (min 1): the canonical buffer-capacity quantizer."""
    return 1 << max(0, int(total) - 1).bit_length() if total > 1 else 1
