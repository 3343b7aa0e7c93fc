"""Exact IEEE-754 binary64 arithmetic in integer lane ops (PyTorch port of
``utils/softfloat.py``).

The string -> float cast must reproduce the reference's double math
(cast_string_to_float.cu:153-199) bit for bit on every device, so its lane
arm assembles the result with the three operations below as pure integer
arithmetic, exactly as the JAX package does:

- :func:`u64_to_f64_bits`: u64 -> nearest binary64 (round to nearest even);
- :func:`f64_mul_bits`: IEEE multiply with subnormal output and overflow to
  inf, one rounding;
- :func:`f64_div_bits`: IEEE divide by 54-step restoring long division;
- :func:`f64_bits_to_f32_bits`: the C ``(float)d`` cast.

Values travel as int64 bit patterns (the FLOAT64 column convention); u64
mantissas are int64 tensors of the same bits, handled through ``utils.u64``
(torch has no usable uint64).  Zero and inf inputs propagate; a NaN result is
the default quiet NaN.
"""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch.utils.u64 import shl, shr, uge, ult, umul128

__all__ = [
    "u64_to_f64_bits",
    "f64_mul_bits",
    "f64_div_bits",
    "f64_from_parts",
    "f64_bits_to_f32_bits",
]

_I32 = torch.int32
_I64 = torch.int64
_MANT_MASK = (1 << 52) - 1
_IMPLICIT = 1 << 52
_INF_BITS = 0x7FF0000000000000
_QNAN_BITS = 0x7FF8000000000000


def _clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u64 lanes (64 for 0), by binary search; int32."""
    n = torch.zeros(x.shape, dtype=_I32, device=x.device)
    cur = x
    for shift in (32, 16, 8, 4, 2, 1):
        big = uge(cur, 1 << shift)
        n = n + torch.where(big, 0, shift).to(_I32)
        cur = torch.where(big, shr(cur, shift), cur)
    return torch.where(x == 0, 64, n).to(_I32)


def _shr_sticky(m: torch.Tensor, k: torch.Tensor):
    """(m >>> k, sticky: any shifted-out bit) for k in [0, 63]."""
    kept = shr(m, k)
    return kept, (m ^ shl(kept, k)) != 0


def _rne(mant_with_grs: torch.Tensor, sticky_extra: torch.Tensor) -> torch.Tensor:
    """Round a mantissa carrying 2 extra bits (guard, round) plus a sticky
    flag to nearest even; the result may reach the next power of two."""
    mant = shr(mant_with_grs, 2)
    guard = shr(mant_with_grs, 1) & 1
    sticky = ((mant_with_grs & 1) != 0) | sticky_extra
    round_up = (guard != 0) & (sticky | ((mant & 1) != 0))
    return mant + round_up.to(_I64)


def f64_from_parts(sign, e_unb, mant53, guard, sticky) -> torch.Tensor:
    """Bits from a sign (0/1), the unbiased exponent of the leading mantissa
    bit, a 53-bit mantissa in [2**52, 2**53) with a guard bit and a sticky
    flag: round to nearest even, subnormal shift and overflow to inf.
    value = mant53 * 2**(e_unb - 52)."""
    sign = sign.to(_I64)
    e_b = e_unb.to(_I32) + 1023

    sub_shift = torch.clamp(1 - e_b, 0, 63)
    total = shl(mant53, 2) | shl(guard, 1)
    shifted, lost = _shr_sticky(total, sub_shift)
    mant = _rne(shifted, sticky | lost)
    e_b = torch.where(sub_shift > 0, 1, e_b).to(_I32)

    ovf = uge(mant, 1 << 53)  # rounding carried into bit 53
    mant = torch.where(ovf, shr(mant, 1), mant)
    e_b = e_b + ovf.to(_I32)

    is_sub = ult(mant, _IMPLICIT)
    exp_field = torch.where(is_sub, 0, e_b).to(_I64)
    inf = e_b >= 2047
    bits = (sign << 63) | torch.where(inf, _INF_BITS, (exp_field << 52) | (mant & _MANT_MASK))
    return torch.where(mant == 0, sign << 63, bits)


def u64_to_f64_bits(x: torch.Tensor) -> torch.Tensor:
    """Nearest binary64 of u64 lanes (int64 bits, read as unsigned: 2**63 and
    above are large, never negative), as int64 bits.  Exact below 2**53."""
    bitlen = 64 - _clz64(x)
    left = torch.clamp(53 - bitlen, 0, 63)
    right = torch.clamp(bitlen - 53, 0, 63)
    mant_exact = shl(x, left)
    kept, _ = _shr_sticky(x, right)
    shifted_g, lost_g = _shr_sticky(x, torch.clamp(right - 1, min=0))
    guard = torch.where(right > 0, shifted_g & 1, 0)
    below = lost_g & (right > 1)
    mant = torch.where(right > 0, kept, mant_exact)
    bits = f64_from_parts(torch.zeros_like(x), bitlen - 1, mant, guard, below)
    return torch.where(x == 0, 0, bits)


def _decompose(bits: torch.Tensor):
    """(sign, unbiased exponent, 53-bit mantissa, is_zero, is_inf, is_nan);
    subnormals are normalized into the same (exponent, mantissa) form."""
    b = bits.to(_I64)
    sign = (b >> 63) & 1
    e_field = ((b >> 52) & 0x7FF).to(_I32)
    frac = b & _MANT_MASK
    is_zero = (e_field == 0) & (frac == 0)
    is_inf = (e_field == 2047) & (frac == 0)
    is_nan = (e_field == 2047) & (frac != 0)
    sub_shift = torch.clamp(_clz64(frac) - 11, 0, 63)  # frac < 2**52: lz >= 12
    mant = torch.where(e_field == 0, shl(frac, sub_shift), frac | _IMPLICIT)
    e_unb = torch.where(e_field == 0, 1 - 1023 - sub_shift, e_field - 1023).to(_I32)
    return sign, e_unb, mant, is_zero, is_inf, is_nan


def f64_mul_bits(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """IEEE binary64 multiply on bit patterns (RNE, subnormals, inf)."""
    sa, ea, ma, za, ia, na = _decompose(a_bits)
    sb, eb, mb, zb, ib, nb = _decompose(b_bits)
    s = sa ^ sb

    hi, lo = umul128(ma, mb)  # product in [2**104, 2**106)
    top = shr(hi, 41) != 0  # bit 105 set
    sh = torch.where(top, 53, 52).to(_I64)
    mant = shl(hi, 64 - sh) | shr(lo, sh)
    guard = shr(lo, sh - 1) & 1
    sticky = (lo & (shl(torch.ones_like(lo), sh - 1) - 1)) != 0
    e = ea + eb + top.to(_I32)

    bits = f64_from_parts(s, e, mant, guard, sticky)

    any_nan = na | nb | (za & ib) | (zb & ia)
    any_inf = (ia | ib) & ~any_nan
    any_zero = (za | zb) & ~any_nan & ~any_inf
    bits = torch.where(any_zero, s << 63, bits)
    bits = torch.where(any_inf, (s << 63) | _INF_BITS, bits)
    return torch.where(any_nan, _QNAN_BITS, bits)


def f64_div_bits(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """IEEE binary64 divide on bit patterns (RNE, subnormals, inf)."""
    sa, ea, ma, za, ia, na = _decompose(a_bits)
    sb, eb, mb, zb, ib, nb = _decompose(b_bits)
    s = sa ^ sb
    e = ea - eb

    # pre-align so the quotient lands in [1, 2)
    small = ma < mb  # both mantissas < 2**53: signed compares are exact
    rem = torch.where(small, ma << 1, ma)
    e = e - small.to(_I32)

    # 54 quotient bits (1 integer + 52 fraction + guard), restoring division;
    # rem < 2 * mb < 2**54 throughout, so the compares stay signed
    q = torch.zeros_like(ma)
    for _ in range(54):
        ge = rem >= mb
        q = (q << 1) | ge.to(_I64)
        rem = torch.where(ge, rem - mb, rem) << 1
    bits = f64_from_parts(s, e, shr(q, 1), q & 1, rem != 0)

    any_nan = na | nb | (za & zb) | (ia & ib)
    div_zero = zb & ~any_nan
    res_zero = (za | ib) & ~any_nan & ~div_zero
    res_inf = (ia | div_zero) & ~any_nan
    bits = torch.where(res_zero, s << 63, bits)
    bits = torch.where(res_inf, (s << 63) | _INF_BITS, bits)
    return torch.where(any_nan, _QNAN_BITS, bits)


def f64_bits_to_f32_bits(bits: torch.Tensor) -> torch.Tensor:
    """``(float)d`` on bit patterns: binary64 -> binary32 int32 bits with
    RNE, subnormal flushing and overflow to inf."""
    sign, e_unb, mant, is_zero, is_inf, is_nan = _decompose(bits)
    s32 = sign.to(_I32) << 31

    # 53 -> 24 bits is a right shift of 29 (+ the subnormal shift); keep two
    # of those bits as guard and round for _rne and fold the rest into sticky
    e_b = e_unb + 127
    sub_shift = torch.clamp(1 - e_b, 0, 34)
    kept, lost = _shr_sticky(mant, (27 + sub_shift).to(_I64))
    mant24 = _rne(kept, lost)
    e_b = torch.where(sub_shift > 0, 1, e_b).to(_I32)

    ovf = mant24 >= (1 << 24)
    mant24 = torch.where(ovf, mant24 >> 1, mant24)
    e_b = e_b + ovf.to(_I32)

    exp_field = torch.where(mant24 < (1 << 23), 0, e_b).to(_I32)
    out = s32 | torch.where(e_b >= 255, 0x7F800000,
                            (exp_field << 23) | (mant24 & 0x7FFFFF).to(_I32)).to(_I32)
    out = torch.where((mant24 == 0) | is_zero, s32, out)
    out = torch.where(is_inf, s32 | 0x7F800000, out)
    return torch.where(is_nan, 0x7FC00000, out).to(_I32)
