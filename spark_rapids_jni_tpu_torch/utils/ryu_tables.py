"""Ryu power-of-5 lookup tables, generated exactly with python big ints (a
copy of the JAX package's framework-neutral ``utils/ryu_tables.py``).

The reference computes these on device from compressed tables
(ftos_converter.cuh:404-456 double_computePow5/double_computeInvPow5, matching
ryu's PrintDoubleLookupTable).  Here the full split tables are materialized at
import with exact integer arithmetic:

- DOUBLE_POW5_SPLIT[i]  = 5^i normalized to 125 bits (floor), i in [0, 326)
- DOUBLE_POW5_INV_SPLIT[i] = floor(2^k / 5^i) + 1 normalized to 125 bits,
  i in [0, 292)
- FLOAT_POW5_SPLIT / FLOAT_POW5_INV_SPLIT: the 64-bit (61-bit count) variants.

Each 125-bit double entry is stored as (lo uint64, hi uint64).
"""

from __future__ import annotations

import numpy as np

DOUBLE_POW5_BITCOUNT = 125
DOUBLE_POW5_INV_BITCOUNT = 125
FLOAT_POW5_BITCOUNT = DOUBLE_POW5_BITCOUNT - 64  # 61
FLOAT_POW5_INV_BITCOUNT = DOUBLE_POW5_INV_BITCOUNT - 64  # 61

_MASK64 = (1 << 64) - 1


def _pow5bits(e: int) -> int:
    """ceil(e * log2(5)) + 1, the bit length of 5^e (ftos_converter.cuh:185)."""
    return ((e * 1217359) >> 19) + 1


def _gen_double_tables():
    n_pow, n_inv = 326, 292
    pow_lo = np.zeros(n_pow, np.uint64)
    pow_hi = np.zeros(n_pow, np.uint64)
    inv_lo = np.zeros(n_inv, np.uint64)
    inv_hi = np.zeros(n_inv, np.uint64)
    for i in range(n_pow):
        p = 5**i
        bits = _pow5bits(i)
        # normalize to exactly DOUBLE_POW5_BITCOUNT bits: exact left shift for
        # small powers, truncating right shift (floor) for large ones
        shift = DOUBLE_POW5_BITCOUNT - bits
        v = p << shift if shift >= 0 else p >> -shift
        pow_lo[i] = v & _MASK64
        pow_hi[i] = v >> 64
    for i in range(n_inv):
        p = 5**i
        bits = _pow5bits(i)
        v = ((1 << (bits + DOUBLE_POW5_INV_BITCOUNT - 1)) // p) + 1
        inv_lo[i] = v & _MASK64
        inv_hi[i] = v >> 64
    return pow_lo, pow_hi, inv_lo, inv_hi


def _gen_float_tables():
    n_pow, n_inv = 47, 55
    pw = np.zeros(n_pow, np.uint64)
    inv = np.zeros(n_inv, np.uint64)
    for i in range(n_pow):
        p = 5**i
        bits = _pow5bits(i)
        shift = FLOAT_POW5_BITCOUNT - bits
        pw[i] = (p << shift if shift >= 0 else p >> -shift) & _MASK64
    for i in range(n_inv):
        p = 5**i
        bits = _pow5bits(i)
        inv[i] = ((1 << (bits + FLOAT_POW5_INV_BITCOUNT - 1)) // p) + 1
    return pw, inv


(
    DOUBLE_POW5_SPLIT_LO,
    DOUBLE_POW5_SPLIT_HI,
    DOUBLE_POW5_INV_SPLIT_LO,
    DOUBLE_POW5_INV_SPLIT_HI,
) = _gen_double_tables()

FLOAT_POW5_SPLIT, FLOAT_POW5_INV_SPLIT = _gen_float_tables()
