"""float <-> integer IEEE-754 bit-pattern conversion (PyTorch port of
``utils/floatbits.py``).

FLOAT64 column data is carried as IEEE-754 bits in int64 (``columnar.column``
doc), so Spark-exact double semantics are done over the exact bits.  torch
reinterprets a tensor's bytes with ``Tensor.view(dtype)``: an exact
reinterpretation, NaN payloads and -0.0 included, on every device (the JAX
package goes through uint32 limbs because the TPU cannot bitcast 64-bit
values).
"""

from __future__ import annotations

import torch


def f64_to_bits(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 IEEE-754 bit pattern."""
    return x.to(torch.float64).contiguous().view(torch.int64)


def bits_to_f64(bits: torch.Tensor) -> torch.Tensor:
    """int64 IEEE-754 bit pattern -> float64."""
    return bits.to(torch.int64).contiguous().view(torch.float64)


def f32_to_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 IEEE-754 bit pattern."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """int32 IEEE-754 bit pattern -> float32."""
    return bits.to(torch.int32).contiguous().view(torch.float32)
