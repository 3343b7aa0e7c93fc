"""Spark DECIMAL128 arithmetic with precision-38 overflow detection (PyTorch
port of ``ops/decimal128.py``).

The reference's decimal_utils.cu (dec128_multiplier :662, dec128_divider
:738, dec128_add_sub :560, dec128_remainder :845) behind the Java façade
DecimalUtils.java:46-178.  All intermediate math runs in 256-bit limb tensors
(``utils.int256``), every row a lane, in plain eager torch on the columns'
device: no kernel of its own, and no ``torch.compile`` (the 256-step division
would unroll).  Rounding is Java HALF_UP; overflow is Spark's
|v| >= 10**38 rule.

Public functions mirror DecimalUtils.java: each returns ``(overflow,
result)`` where ``overflow`` is a BOOL Column (true where the row overflowed)
and ``result`` carries the requested Spark scale, both on the inputs' device.
Scales at this API are *Spark-convention* python ints (positive = fraction
digits); internally the formulas use cudf-convention scales (negated) to stay
aligned with the reference kernels.

The reference's ``interimCast`` flag (DecimalUtils.java:55-70) reproduces a
Spark <3.4.2 bug (SPARK-40129/SPARK-45786): the raw product is first rounded
to 38 digits of precision, then rounded again to the target scale.  Both
behaviors are implemented.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spark_rapids_jni_tpu_torch.columnar import dtypes
from spark_rapids_jni_tpu_torch.columnar.column import Column, Decimal128Column
from spark_rapids_jni_tpu_torch.utils import int256 as i256


def _and_validity(a, b):
    if a.validity is None and b.validity is None:
        return None
    return a.is_valid() & b.is_valid()


def _result(valid, ov, hi, lo, spark_scale) -> Tuple[Column, Decimal128Column]:
    overflow = Column(ov, valid, dtypes.BOOL)
    res = Decimal128Column(
        hi, lo, valid, dtypes.DType(dtypes.Kind.DECIMAL128, 38, spark_scale))
    return overflow, res


def _multiply_kernel(a_hi, a_lo, b_hi, b_lo, *, a_cs, b_cs, prod_cs, interim):
    a = i256.from_i128(a_hi, a_lo)
    b = i256.from_i128(b_hi, b_lo)
    product = i256.multiply(a, b)

    mult_cs = torch.full(a_hi.shape, a_cs + b_cs, dtype=torch.int32, device=a_hi.device)
    if interim:
        # Spark <3.4.2: round the raw product to 38 digits first
        # (dec128_multiplier, decimal_utils.cu:687-716).
        fdp = i256.precision10(product) - 38
        div = i256.pow_ten(torch.clamp(fdp, min=0), product)  # fdp<=0 rows divide by 1
        d_hi, d_lo = i256.to_i128(div)
        rounded = i256.divide_and_round(product, d_hi, d_lo)
        take = fdp > 0
        product = torch.where(take[..., None], rounded, product)
        mult_cs = mult_cs + torch.where(take, fdp, 0)

    exponent = prod_cs - mult_cs

    # exponent < 0: scale the product up, overflowing if that adds digits past 38
    new_precision = i256.precision10(product)
    up_overflow = (new_precision - exponent) > 38
    mult = i256.pow_ten(torch.clamp(-exponent, min=0), product)
    scaled_up = i256.multiply(product, mult)

    # exponent >= 0: divide-and-round down to the target scale
    dv_hi, dv_lo = i256.to_i128(i256.pow_ten(torch.clamp(exponent, min=0), product))
    scaled_down = i256.divide_and_round(product, dv_hi, dv_lo)

    up = exponent < 0
    final = torch.where(up[..., None], scaled_up, scaled_down)
    overflow = torch.where(
        up,
        up_overflow | i256.is_greater_than_decimal_38(scaled_up),
        i256.is_greater_than_decimal_38(scaled_down),
    )
    r_hi, r_lo = i256.to_i128(final)
    return overflow, r_hi, r_lo


def multiply128(
    a: Decimal128Column,
    b: Decimal128Column,
    product_scale: int,
    interim_cast: bool = True,
) -> Tuple[Column, Decimal128Column]:
    """a * b at Spark scale ``product_scale`` (DecimalUtils.multiply128,
    DecimalUtils.java:46-71)."""
    ov, hi, lo = _multiply_kernel(
        a.hi, a.lo, b.hi, b.lo,
        a_cs=-a.dtype.scale, b_cs=-b.dtype.scale, prod_cs=-product_scale,
        interim=interim_cast,
    )
    return _result(_and_validity(a, b), ov, hi, lo, product_scale)


def _safe_divisor(d_hi, d_lo):
    """Replace zero divisors with 1 (rows masked out by the caller)."""
    is_zero = (d_hi == 0) & (d_lo == 0)
    return is_zero, torch.where(is_zero, 0, d_hi), torch.where(is_zero, 1, d_lo)


def _divide_kernel(a_hi, a_lo, b_hi, b_lo, *, n_shift_exp, is_int_div):
    """dec128_divider (decimal_utils.cu:738-834).  ``n_shift_exp`` is the
    cudf-scale shift quot_cs - (a_cs - b_cs), a python int; the three
    branches of the reference are python branches here."""
    n = i256.from_i128(a_hi, a_lo)
    div_zero, d_hi, d_lo = _safe_divisor(b_hi, b_lo)

    if n_shift_exp > 0:
        # divide twice: truncating divide, then scale down with rounding
        q1, _, _ = i256.divide(n, d_hi, d_lo)
        p_hi, p_lo = i256.to_i128(i256.pow_ten(n_shift_exp, q1))
        if is_int_div:
            result = i256.integer_divide(q1, p_hi, p_lo)
        else:
            result = i256.divide_and_round(q1, p_hi, p_lo)
    else:
        # scale the numerator up before dividing.  When the shift exceeds 38
        # the reference stages the multiply around a first divide so the
        # scaled numerator cannot wrap 256 bits (decimal_utils.cu:788-812);
        # in exact arithmetic the staged form equals
        # divide_and_round(n * 10**shift, d).
        shift = -n_shift_exp
        if shift <= 38:
            if shift > 0:
                n = i256.multiply(n, i256.pow_ten(shift, n))
            if is_int_div:
                result = i256.integer_divide(n, d_hi, d_lo)
            else:
                result = i256.divide_and_round(n, d_hi, d_lo)
        else:
            n = i256.multiply(n, i256.pow_ten(38, n))
            q1, r1_hi, r1_lo = i256.divide(n, d_hi, d_lo)
            scale_mult = i256.pow_ten(shift - 38, q1)
            result = i256.multiply(q1, scale_mult)
            scaled_r = i256.multiply(i256.from_i128(r1_hi, r1_lo), scale_mult)
            q2, r2_hi, r2_lo = i256.divide(scaled_r, d_hi, d_lo)
            result = i256.add(result, q2)
            if not is_int_div:
                result = i256.round_from_remainder(
                    result, r2_hi, r2_lo, i256.is_negative(scaled_r), d_hi, d_lo)

    overflow = div_zero | i256.is_greater_than_decimal_38(result)
    if is_int_div:
        return overflow, torch.where(div_zero, 0, i256.to_i64(result))
    r_hi, r_lo = i256.to_i128(result)
    return overflow, torch.where(div_zero, 0, r_hi), torch.where(div_zero, 0, r_lo)


def divide128(
    a: Decimal128Column, b: Decimal128Column, quotient_scale: int
) -> Tuple[Column, Decimal128Column]:
    """a / b at Spark scale ``quotient_scale`` with HALF_UP rounding
    (DecimalUtils.divide128, DecimalUtils.java:86)."""
    n_shift_exp = -quotient_scale - (-a.dtype.scale - -b.dtype.scale)
    ov, hi, lo = _divide_kernel(a.hi, a.lo, b.hi, b.lo, n_shift_exp=n_shift_exp,
                                is_int_div=False)
    return _result(_and_validity(a, b), ov, hi, lo, quotient_scale)


def integer_divide128(a: Decimal128Column, b: Decimal128Column) -> Tuple[Column, Column]:
    """a div b -> INT64 quotient, truncated (DecimalUtils.integerDivide128,
    DecimalUtils.java:108: divide at cudf scale 0 with DOWN rounding)."""
    n_shift_exp = 0 - (-a.dtype.scale - -b.dtype.scale)
    ov, q64 = _divide_kernel(a.hi, a.lo, b.hi, b.lo, n_shift_exp=n_shift_exp,
                             is_int_div=True)
    valid = _and_validity(a, b)
    return Column(ov, valid, dtypes.BOOL), Column(q64, valid, dtypes.INT64)


def _remainder_kernel(a_hi, a_lo, b_hi, b_lo, *, a_cs, b_cs, rem_cs):
    """dec128_remainder (decimal_utils.cu:845-966): Java remainder semantics,
    a % b = a - (a // b) * b, result sign follows the dividend."""
    n = i256.from_i128(a_hi, a_lo)
    div_zero, d_hi, d_lo = _safe_divisor(b_hi, b_lo)

    d_shift_exp = rem_cs - b_cs
    n_shift_exp = rem_cs - a_cs

    ad_hi, ad_lo = i256.to_i128(i256.abs256(i256.from_i128(d_hi, d_lo)))
    if d_shift_exp > 0:
        # shift the divisor itself down to rem_scale, rounding
        p_hi, p_lo = i256.to_i128(i256.pow_ten(d_shift_exp, n))
        abs_d = i256.divide_and_round(i256.from_i128(ad_hi, ad_lo), p_hi, p_lo)
        ad_hi, ad_lo = i256.to_i128(abs_d)
    else:
        n_shift_exp -= d_shift_exp

    n_neg = i256.is_negative(n)
    abs_n = i256.abs256(n)
    # guard again: a down-rounded divisor can hit zero
    rz = (ad_hi == 0) & (ad_lo == 0)
    div_zero = div_zero | rz
    ad_lo = torch.where(rz, 1, ad_lo)

    if n_shift_exp > 0:
        q1, _, _ = i256.divide(abs_n, ad_hi, ad_lo)
        p_hi, p_lo = i256.to_i128(i256.pow_ten(n_shift_exp, q1))
        int_div = i256.integer_divide(q1, p_hi, p_lo)
    else:
        if n_shift_exp < 0:
            abs_n = i256.multiply(abs_n, i256.pow_ten(-n_shift_exp, abs_n))
        int_div = i256.integer_divide(abs_n, ad_hi, ad_lo)

    less_n = i256.multiply(int_div, i256.from_i128(ad_hi, ad_lo))
    if d_shift_exp < 0:
        less_n = i256.multiply(less_n, i256.pow_ten(-d_shift_exp, less_n))
    rem = i256.add(abs_n, i256.negate(less_n))

    overflow = div_zero | i256.is_greater_than_decimal_38(rem)
    rem = torch.where(n_neg[..., None], i256.negate(rem), rem)
    r_hi, r_lo = i256.to_i128(rem)
    return overflow, torch.where(div_zero, 0, r_hi), torch.where(div_zero, 0, r_lo)


def remainder128(
    a: Decimal128Column, b: Decimal128Column, remainder_scale: int
) -> Tuple[Column, Decimal128Column]:
    """a % b at Spark scale ``remainder_scale`` (DecimalUtils.remainder128,
    DecimalUtils.java:128)."""
    ov, hi, lo = _remainder_kernel(
        a.hi, a.lo, b.hi, b.lo,
        a_cs=-a.dtype.scale, b_cs=-b.dtype.scale, rem_cs=-remainder_scale,
    )
    return _result(_and_validity(a, b), ov, hi, lo, remainder_scale)


def _set_scale_and_round(x, old_cs, new_cs):
    """set_scale_and_round (decimal_utils.cu:544), python-int scales."""
    if old_cs == new_cs:
        return x
    if new_cs < old_cs:
        return i256.multiply(x, i256.pow_ten(old_cs - new_cs, x))
    p_hi, p_lo = i256.to_i128(i256.pow_ten(new_cs - old_cs, x))
    return i256.divide_and_round(x, p_hi, p_lo)


def _add_sub_kernel(a_hi, a_lo, b_hi, b_lo, *, a_cs, b_cs, res_cs, sub):
    """dec128_add_sub (decimal_utils.cu:560-611): align to the smaller cudf
    scale, add/sub in 256 bits, round to the result scale."""
    a = i256.from_i128(a_hi, a_lo)
    b = i256.from_i128(b_hi, b_lo)
    inter_cs = min(a_cs, b_cs)
    a = _set_scale_and_round(a, a_cs, inter_cs)
    b = _set_scale_and_round(b, b_cs, inter_cs)
    if sub:
        b = i256.negate(b)
    s = _set_scale_and_round(i256.add(a, b), inter_cs, res_cs)
    overflow = i256.is_greater_than_decimal_38(s)
    r_hi, r_lo = i256.to_i128(s)
    return overflow, r_hi, r_lo


def _add_sub(a, b, target_scale, sub):
    if abs(a.dtype.scale - b.dtype.scale) > 77:
        raise ValueError("The scale of the input columns is too far apart")
    ov, hi, lo = _add_sub_kernel(
        a.hi, a.lo, b.hi, b.lo,
        a_cs=-a.dtype.scale, b_cs=-b.dtype.scale, res_cs=-target_scale, sub=sub,
    )
    return _result(_and_validity(a, b), ov, hi, lo, target_scale)


def add128(
    a: Decimal128Column, b: Decimal128Column, target_scale: int
) -> Tuple[Column, Decimal128Column]:
    """a + b at Spark scale ``target_scale`` (DecimalUtils.add128,
    DecimalUtils.java:172)."""
    return _add_sub(a, b, target_scale, sub=False)


def subtract128(
    a: Decimal128Column, b: Decimal128Column, target_scale: int
) -> Tuple[Column, Decimal128Column]:
    """a - b at Spark scale ``target_scale`` (DecimalUtils.subtract128,
    DecimalUtils.java:149)."""
    return _add_sub(a, b, target_scale, sub=True)
