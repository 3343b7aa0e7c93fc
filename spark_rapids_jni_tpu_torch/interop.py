"""Moving columns between the JAX package and the port, through numpy.

A JAX ``Column``'s fields give numpy arrays (``np.asarray(col.data)``,
``np.asarray(col.validity)``) and its dtype carries a ``kind`` enum whose
``value`` names the Spark type.  These helpers turn such arrays into a port
:class:`Column` on a chosen device and back, without importing the JAX
package: unsigned arrays cross as the signed tensors of the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType, Kind

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


def column_to_numpy(col: Column) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(data, validity) numpy arrays of a port Column, as a JAX Column holds
    them for the same type."""
    data = col.data.cpu().numpy()
    validity = None if col.validity is None else col.validity.cpu().numpy()
    if col.dtype.kind == Kind.UINT64:
        data = data.view(np.uint64)
    return data, validity
