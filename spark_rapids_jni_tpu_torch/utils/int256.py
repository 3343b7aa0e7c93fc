"""Vectorized 256-bit integer arithmetic as 8x32-bit limb tensors (PyTorch
port of ``utils/int256.py``).

The reference's DECIMAL128 math (decimal_utils.cu ``chunked256``, multiply at
decimal_utils.cu:126, long division at :148, half-up rounding at :192) runs on
native 64/128-bit scalars per CUDA thread.  Here, as in the JAX package, a
256-bit value is a little-endian tensor of eight 32-bit limbs, ``[..., 8]``,
and every operation is elementwise over the leading (row) axes.  The limbs are
int64 tensors holding values in [0, 2**32), so limb compares are plain
compares and a limb product plus two limbs fits in 64 bits; where such a sum
reaches 2**63 it wraps negative in int64, so its carry is taken with a logical
shift (``u64.shr``), never a bare ``>>``.  128-bit remainders and
divisors are (hi int64, lo int64-bits) pairs as in ``int128``.

Sign convention: two's complement over the full 256 bits (limb 7's top bit).
Plain eager torch: the 256-step division runs a few thousand small ops per
call (see ``divide_unsigned``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.utils.u64 import shr, ult

NLIMBS = 8
_M32 = 0xFFFFFFFF


def const256(v: int) -> np.ndarray:
    """Python int -> (8,) int64 little-endian two's-complement 32-bit limbs."""
    v &= (1 << 256) - 1
    return np.array([(v >> (32 * i)) & _M32 for i in range(NLIMBS)], dtype=np.int64)


# 10**k for k in 0..76 (product of two decimal-38 values is < 10**76), the
# vectorized analog of the reference's generated pow_ten switch
# (decimal_utils.cu:246+).
POW10 = np.stack([const256(10**k) for k in range(77)])  # (77, 8) int64
_POW10_DEV: Dict[torch.device, torch.Tensor] = {}


def _pow10_table(device: torch.device) -> torch.Tensor:
    t = _POW10_DEV.get(device)
    if t is None:
        t = _POW10_DEV[device] = torch.from_numpy(POW10).to(device)
    return t


def from_i128(hi, lo):
    """Sign-extend (hi int64, lo int64-bits) into limbs[..., 8]."""
    sign = torch.where(hi < 0, _M32, 0)
    return torch.stack([lo & _M32, shr(lo, 32), hi & _M32, shr(hi, 32),
                        sign, sign, sign, sign], dim=-1)


def from_i64(x):
    """Sign-extend int64 into limbs[..., 8]."""
    x = x.to(torch.int64)
    return from_i128(torch.where(x < 0, -1, 0), x)


def to_i128(limbs):
    """Truncate to the low 128 bits as (hi int64, lo int64-bits)."""
    lo = limbs[..., 0] | (limbs[..., 1] << 32)
    hi = limbs[..., 2] | (limbs[..., 3] << 32)
    return hi, lo


def to_i64(limbs):
    """Truncate to the low 64 bits as signed int64 (reference as_64_bits)."""
    return limbs[..., 0] | (limbs[..., 1] << 32)


def is_negative(limbs):
    return (limbs[..., 7] >> 31) != 0


def add(a, b):
    """256-bit add, carries rippled limb by limb."""
    out = []
    carry = 0
    for i in range(NLIMBS):
        s = a[..., i] + b[..., i] + carry
        out.append(s & _M32)
        carry = s >> 32
    return torch.stack(out, dim=-1)


def add_small(a, d):
    """a + d for signed int64/int32 d (sign-extended); d may be a tensor."""
    d = torch.as_tensor(d, dtype=torch.int64, device=a.device)
    return add(a, from_i64(torch.broadcast_to(d, a.shape[:-1])))


def negate(a):
    out = []
    carry = 1
    for i in range(NLIMBS):
        s = (a[..., i] ^ _M32) + carry
        out.append(s & _M32)
        carry = s >> 32
    return torch.stack(out, dim=-1)


def abs256(a):
    return torch.where(is_negative(a)[..., None], negate(a), a)


def multiply(a, b):
    """Schoolbook 8x8 32-bit-limb multiply keeping the low 256 bits
    (reference multiply, decimal_utils.cu:126).  ``au*bu + r + carry`` can
    reach 2**64 - 1, so its carry is a logical shift."""
    au = [a[..., i].contiguous() for i in range(NLIMBS)]
    bu = [b[..., i].contiguous() for i in range(NLIMBS)]
    r = [torch.zeros_like(au[0]) for _ in range(NLIMBS)]
    for b_idx in range(NLIMBS):
        carry = 0
        for a_idx in range(NLIMBS - b_idx):
            r_idx = a_idx + b_idx
            m = au[a_idx] * bu[b_idx] + r[r_idx] + carry
            r[r_idx] = m & _M32
            carry = shr(m, 32)
    return torch.stack(r, dim=-1)


def lt_unsigned(a, b):
    """Unsigned a < b, lexicographic from the high limb down."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(NLIMBS - 1, -1, -1):
        lt = lt | (eq & (a[..., i] < b[..., i]))
        eq = eq & (a[..., i] == b[..., i])
    return lt


def gte_unsigned(a, b):
    return ~lt_unsigned(a, b)


def eq256(a, b):
    return torch.all(a == b, dim=-1)


def _bcast(table_row: np.ndarray, like):
    """Broadcast a host (8,) limb constant against limbs[..., 8]."""
    c = torch.from_numpy(table_row).to(like.device)
    return torch.broadcast_to(c, like.shape[:-1] + (NLIMBS,))


def pow_ten(k, like):
    """10**k as limbs broadcast to ``like``'s shape; k is an int tensor
    (clipped to [0, 76]) or a python int."""
    if isinstance(k, int):
        return _bcast(POW10[k], like)
    return _pow10_table(like.device)[torch.clamp(k, 0, 76).to(torch.int64)]


def precision10(a):
    """Smallest i with 10**i >= |a| (reference precision10,
    decimal_utils.cu:520: NOT digit count — exact powers of ten return their
    exponent).  Equals the number of k in [0, 76] with 10**k < |a|, counted
    one k at a time so no [rows, 77] temporary is built."""
    mag = abs256(a)
    limbs = [mag[..., i].contiguous() for i in range(NLIMBS)]
    count = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    for k in range(77):
        p = [int(x) for x in POW10[k]]
        lt = torch.zeros_like(count, dtype=torch.bool)
        eq = torch.ones_like(count, dtype=torch.bool)
        for i in range(NLIMBS - 1, -1, -1):
            lt = lt | (eq & (limbs[i] > p[i]))
            eq = eq & (limbs[i] == p[i])
        count += lt.to(torch.int32)
    return count


def is_greater_than_decimal_38(a):
    """|a| >= 10**38: Spark's precision-38 overflow test
    (decimal_utils.cu:537)."""
    return gte_unsigned(abs256(a), _bcast(POW10[38], a))


def _u128_lt(ahi, alo, bhi, blo):
    """Unsigned 128-bit (ahi, alo) < (bhi, blo), every word u64 bits."""
    return ult(ahi, bhi) | ((ahi == bhi) & ult(alo, blo))


def divide_unsigned(n, d_hi, d_lo):
    """256-bit / 128-bit long division (reference divide_unsigned,
    decimal_utils.cu:148): returns (quotient limbs, remainder (hi, lo) as u64
    bits in int64).

    n must be non-negative (as unsigned), d positive and < 2**127.  Bitwise
    restoring division: 256 sequential steps of elementwise work, every row in
    lockstep, about 28 torch ops a step.
    """
    r_hi = torch.zeros_like(d_hi)
    r_lo = torch.zeros_like(d_lo)
    q_limbs = []
    for block in range(NLIMBS - 1, -1, -1):
        nb = n[..., block].contiguous()
        q_block = torch.zeros_like(r_lo)
        for i in range(32):
            bit_pos = 31 - i
            read = (nb >> bit_pos) & 1
            r_hi = (r_hi << 1) | shr(r_lo, 63)
            r_lo = (r_lo << 1) | read
            ge = ~_u128_lt(r_hi, r_lo, d_hi, d_lo)
            new_lo = r_lo - d_lo
            borrow = ult(r_lo, new_lo).to(torch.int64)
            new_hi = r_hi - d_hi - borrow
            r_hi = torch.where(ge, new_hi, r_hi)
            r_lo = torch.where(ge, new_lo, r_lo)
            q_block = q_block | torch.where(ge, 1 << bit_pos, 0)
        q_limbs.append(q_block & _M32)
    q_limbs.reverse()
    return torch.stack(q_limbs, dim=-1), r_hi, r_lo


def _neg128(hi, lo):
    """Two's-complement negation of 128-bit (hi, lo) u64 bits."""
    n_lo = ~lo + 1
    return ~hi + (n_lo == 0).to(torch.int64), n_lo


def divide(n, d_hi, d_lo):
    """Signed divide: 256-bit n / 128-bit d -> (quotient limbs, remainder
    (hi int64, lo int64-bits) signed).  Truncating (toward zero), like the
    reference divide (decimal_utils.cu:170): quotient negative iff signs
    differ, remainder carries n's sign."""
    n_neg = is_negative(n)
    d_neg = d_hi < 0
    nd_hi, nd_lo = _neg128(d_hi, d_lo)
    ad_hi = torch.where(d_neg, nd_hi, d_hi)
    ad_lo = torch.where(d_neg, nd_lo, d_lo)
    q, r_hi, r_lo = divide_unsigned(abs256(n), ad_hi, ad_lo)
    q = torch.where((d_neg != n_neg)[..., None], negate(q), q)
    nr_hi, nr_lo = _neg128(r_hi, r_lo)
    return q, torch.where(n_neg, nr_hi, r_hi), torch.where(n_neg, nr_lo, r_lo)


def _abs_i128(hi, lo):
    neg = hi < 0
    n_hi, n_lo = _neg128(hi, lo)
    return torch.where(neg, n_hi, hi), torch.where(neg, n_lo, lo)


def round_from_remainder(q, r_hi, r_lo, n_neg, d_hi, d_lo):
    """Half-up rounding increment from a division remainder (reference
    round_from_remainder, decimal_utils.cu:192): bump |q| by one ulp away from
    zero when |2r| >= |d|, with the doubled-remainder-overflow short circuit.
    The doubled remainder's high word shifts back arithmetically, its low
    word logically, as in the JAX package."""
    dbl_hi = (r_hi << 1) | shr(r_lo, 63)
    dbl_lo = r_lo << 1
    # did (r << 1) >> 1 lose information?
    back_hi = dbl_hi >> 1
    back_lo = shr(dbl_lo, 1) | (dbl_hi << 63)
    lost = (back_hi != r_hi) | (back_lo != r_lo)
    # |2r| and |d| as unsigned 128
    a2_hi, a2_lo = _abs_i128(dbl_hi, dbl_lo)
    ad_hi, ad_lo = _abs_i128(d_hi, d_lo)
    ge = ~_u128_lt(a2_hi, a2_lo, ad_hi, ad_lo)
    need_inc = lost | ge
    round_down = n_neg != (d_hi < 0)
    inc = torch.where(need_inc, torch.where(round_down, -1, 1), 0)
    return add(q, from_i64(inc))


def divide_and_round(n, d_hi, d_lo):
    """n / d with Java HALF_UP rounding (decimal_utils.cu:228)."""
    q, r_hi, r_lo = divide(n, d_hi, d_lo)
    return round_from_remainder(q, r_hi, r_lo, is_negative(n), d_hi, d_lo)


def integer_divide(n, d_hi, d_lo):
    """n / d truncated toward zero — Java DOWN rounding (decimal_utils.cu:238)."""
    q, _, _ = divide(n, d_hi, d_lo)
    return q
