"""Vectorized 128-bit integer arithmetic as (hi int64, lo int64) limb pairs
(PyTorch port of ``utils/int128.py``).

value = hi * 2**64 + lo, with ``hi`` signed and ``lo`` the bits of the
unsigned low word (the JAX package holds it as uint64).  torch has no usable
uint64, so every unsigned compare of a ``lo`` word and every logical right
shift goes through ``utils.u64`` (``ult``, ``shr``).  int64 ``+``, ``-`` and
``*`` wrap modulo 2**64, which gives the unsigned sums and products their
bits.
"""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch.utils.u64 import M32, s64, shr, ult


def const128(v: int):
    """Split a python int into (hi, lo) python ints with int64 bits."""
    v &= (1 << 128) - 1
    return s64(v >> 64), s64(v)


def add_small(hi, lo, d):
    """(hi, lo) + d where d is a small non-negative int64 (tensor or int)."""
    lo2 = lo + d
    return hi + ult(lo2, lo).to(torch.int64), lo2


def sub_small(hi, lo, d):
    lo2 = lo - d
    return hi - ult(lo, lo2).to(torch.int64), lo2


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
    a = shr(lo, 32)
    b = lo & M32
    t = b * k
    u = a * k + shr(t, 32)
    lo2 = (u << 32) | (t & M32)
    return hi * k + shr(u, 32), lo2


def lt(ah, al, bh, bl):
    """Signed (ah, al) < (bh, bl)."""
    return (ah < bh) | ((ah == bh) & ult(al, bl))


def gt(ah, al, bh, bl):
    return (ah > bh) | ((ah == bh) & ult(bl, al))


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
