"""Vectorized 128-bit integer arithmetic as (hi int64, lo int64) limb pairs
(PyTorch port of ``utils/int128.py``).

value = hi * 2**64 + lo, with ``hi`` signed and ``lo`` the bits of the
unsigned low word (the JAX package holds it as uint64).  torch has no usable
uint64, so every unsigned compare of a ``lo`` word is a signed compare after
flipping the top bit (:func:`_ult`), and every logical right shift masks off
the sign fill (:func:`_ushr`).  int64 ``+``, ``-`` and ``*`` wrap modulo
2**64, which gives the unsigned sums and products their bits.  ``int256``
reuses both helpers.
"""

from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1
_SIGN = -(1 << 63)


def _signed64(x: int) -> int:
    x &= MASK64
    return x - (1 << 64) if x >> 63 else x


def _ult(a, b):
    """Unsigned a < b of u64 bits held in int64."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _ushr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift by ``k`` (1..63) of u64 bits held in int64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def const128(v: int):
    """Split a python int into (hi, lo) python ints with int64 bits."""
    v &= (1 << 128) - 1
    return _signed64(v >> 64), _signed64(v)


def add_small(hi, lo, d):
    """(hi, lo) + d where d is a small non-negative int64 (tensor or int)."""
    lo2 = lo + d
    return hi + _ult(lo2, lo).to(torch.int64), lo2


def sub_small(hi, lo, d):
    lo2 = lo - d
    return hi - _ult(lo, lo2).to(torch.int64), lo2


def neg(hi, lo):
    lo2 = ~lo + 1
    # +1 carries into hi exactly when ~lo was all-ones, i.e. lo2 wrapped to 0
    return ~hi + (lo2 == 0).to(torch.int64), lo2


def abs_(hi, lo):
    is_neg = hi < 0
    nh, nl = neg(hi, lo)
    return torch.where(is_neg, nh, hi), torch.where(is_neg, nl, lo)


def mul_small(hi, lo, k: int):
    """(hi, lo) * k for a small positive python-int k (fits in 32 bits).  The
    low-limb product is built from 32-bit halves, so every partial product
    fits in 64 bits."""
    a = _ushr(lo, 32)
    b = lo & _MASK32
    t = b * k
    u = a * k + _ushr(t, 32)
    lo2 = (u << 32) | (t & _MASK32)
    return hi * k + _ushr(u, 32), lo2


def lt(ah, al, bh, bl):
    """Signed (ah, al) < (bh, bl)."""
    return (ah < bh) | ((ah == bh) & _ult(al, bl))


def gt(ah, al, bh, bl):
    return (ah > bh) | ((ah == bh) & _ult(bl, al))


def eq(ah, al, bh, bl):
    return (ah == bh) & (al == bl)


# |value| >= 10**k comparisons, used for digit counting of 128-bit magnitudes.
_POW10_TABLE = [const128(10**k) for k in range(40)]


def count_digits(hi, lo):
    """Number of base-10 digits of |value| (0 -> 0 digits, like the
    reference's count_digits, cast_string.cu:490-497)."""
    mh, ml = abs_(hi, lo)
    count = torch.zeros(hi.shape, dtype=torch.int32, device=hi.device)
    for ph, pl in _POW10_TABLE:
        count += (~lt(mh, ml, ph, pl)).to(torch.int32)
    return count
