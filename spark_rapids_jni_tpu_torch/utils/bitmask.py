"""Arrow validity-bitmask pack/unpack and bitwise utilities (PyTorch port of
``utils/bitmask.py``).

The reference keeps validity as packed bits (cudf) and provides
`bitmask_bitwise_or` (utilities.cu:24-72) for merging.  The port, like the
JAX package, keeps validity unpacked (one bool per row) inside ops and packs
only at interchange boundaries (JCUDF rows, serialized bloom filters).
"""

from __future__ import annotations

import torch


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[n] -> uint8[ceil(n/8)], LSB-first (Arrow order)."""
    n = mask.shape[0]
    m = torch.zeros((n + (-n) % 8,), dtype=torch.int32, device=mask.device)
    m[:n] = mask.to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=mask.device)
    return (m.view(-1, 8) * weights).sum(dim=1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """uint8[ceil(n/8)] -> bool[n], LSB-first."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def bitmask_or(masks) -> torch.Tensor:
    """Bitwise OR of equal-length packed masks (utilities.hpp:33-40 analog)."""
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out


def bitmask_and(masks) -> torch.Tensor:
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out
