"""Unsigned 64-bit lane arithmetic on int64 tensors.

torch's uint64 has no ``+``, shifts, compares or division, so the port
carries u64 values as the int64 tensors of the same bits (as ``int128``
does).  int64 ``+``, ``-``, ``*``, ``&``, ``|``, ``^`` and ``<<`` by 0..63
give the unsigned results' bits.  What does not carry over, and what this
module supplies:

- compares: a signed compare after flipping the top bit (:func:`ult` and
  friends);
- right shifts: torch's ``>>`` on int64 is arithmetic, so :func:`shr` masks
  off the sign fill;
- shift counts outside [0, 63]: XLA (the JAX package's backend) gives 0 for
  a logical shift by 64 or more (and by a negative count, which it reads as
  unsigned), torch fills with the sign or differs by build, so :func:`shl`
  and :func:`shr` return 0 there explicitly;
- division: torch floors signed values, so :func:`divmod_const` and
  :func:`divmod_tensor` divide the halved value and fix up the last bit.

Python-int u64 constants go through :func:`s64` to become int64 literals.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

SIGN = -(1 << 63)
MAX63 = (1 << 63) - 1
M32 = 0xFFFFFFFF

Shift = Union[int, torch.Tensor]


def s64(v: int) -> int:
    """The int64 value with the bits of the u64 python int ``v``."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def ult(a, b):
    """Unsigned ``a < b``."""
    return (a ^ SIGN) < (b ^ SIGN)


def ule(a, b):
    return (a ^ SIGN) <= (b ^ SIGN)


def ugt(a, b):
    return (a ^ SIGN) > (b ^ SIGN)


def uge(a, b):
    return (a ^ SIGN) >= (b ^ SIGN)


def shr(x: torch.Tensor, k: Shift) -> torch.Tensor:
    """Logical ``x >> k``; 0 where ``k`` is 64 or more, or negative."""
    if isinstance(k, int):
        if k <= 0:
            return x if k == 0 else torch.zeros_like(x)
        return torch.zeros_like(x) if k >= 64 else (x >> k) & (MAX63 >> (k - 1))
    kc = torch.clamp(k, 0, 63).to(torch.int64)
    out = (x >> kc) & ~(torch.bitwise_left_shift(torch.bitwise_right_shift(SIGN, kc), 1))
    return torch.where((k < 0) | (k >= 64), 0, out)


def shl(x: torch.Tensor, k: Shift) -> torch.Tensor:
    """``x << k`` with the bits past 64 dropped; 0 where ``k`` is 64 or more,
    or negative."""
    if isinstance(k, int):
        return x << k if 0 <= k < 64 else torch.zeros_like(x)
    kc = torch.clamp(k, 0, 63).to(torch.int64)
    return torch.where((k < 0) | (k >= 64), 0, x << kc)


def divmod_const(x: torch.Tensor, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned ``(x // d, x % d)`` for a python-int divisor in [1, 2**63).

    ``x >>> 1`` is non-negative, so torch's floor division is exact on it:
    ``x = 2 * (q1 * d + r1) + b`` gives ``x // d = 2 * q1 + (2 * r1 + b >= d)``.
    """
    if not 1 <= d <= MAX63:
        raise ValueError(f"divmod_const: divisor {d} outside [1, 2**63)")
    q = ((x >> 1) & MAX63) // d * 2
    r = x - q * d
    ge = uge(r, d)
    return q + ge.to(torch.int64), r - torch.where(ge, d, 0)


def divmod_tensor(x: torch.Tensor, d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned ``(x // d, x % d)`` for per-lane u64 divisors ``d >= 1``,
    including divisors of 2**63 and above (quotient 0 or 1)."""
    big = d < 0
    dd = torch.where(big, 1, d)
    q = ((x >> 1) & MAX63) // dd * 2
    r = x - q * dd
    ge = uge(r, dd)
    q = q + ge.to(torch.int64)
    r = r - torch.where(ge, dd, 0)
    qb = uge(x, d).to(torch.int64)
    return torch.where(big, qb, q), torch.where(big, x - qb * d, r)


def umul128(a: torch.Tensor, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of the full 128-bit product of two u64 lanes, from 32-bit
    halves: every partial product fits 64 bits, and the carries come out of
    logical shifts."""
    a_lo, a_hi = a & M32, shr(a, 32)
    b_lo, b_hi = b & M32, shr(b, 32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = shr(ll, 32) + (lh & M32) + (hl & M32)
    lo = (ll & M32) | ((mid & M32) << 32)
    hi = hh + shr(lh, 32) + shr(hl, 32) + shr(mid, 32)
    return hi, lo
