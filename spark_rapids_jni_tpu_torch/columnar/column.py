"""Fixed-width columns as torch tensors (PyTorch port of columnar/column.py).

A column is ``data[n]`` plus an optional unpacked ``validity[n]`` bool tensor
(None == all valid), on one device.  FLOAT64 columns store the IEEE-754 bit
pattern in int64, as the JAX package does, so the double paths stay pure
integer arithmetic and the two packages compare like with like.

String, decimal128, list and struct columns arrive with the column-hash slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType, Kind


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
            return torch.ones((self.size,), dtype=torch.bool, device=self.device)
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
        if self.validity is None:
            return vals
        mask = self.validity.cpu().numpy()
        return [v if m else None for v, m in zip(vals, mask)]


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
    validity = None
    if any(v is None for v in values):
        validity = torch.tensor([v is not None for v in values], dtype=torch.bool,
                                device=dev)
    return Column(torch.from_numpy(arr).to(dev), validity, dtype)


def next_pow2(total: int) -> int:
    """Next power of two (min 1): the canonical buffer-capacity quantizer."""
    return 1 << max(0, int(total) - 1).bit_length() if total > 1 else 1
