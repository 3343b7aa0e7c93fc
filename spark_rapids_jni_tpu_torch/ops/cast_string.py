"""Spark-exact string -> integer / decimal casts, and ``conv``-style base
casts (PyTorch port of ``ops/cast_string.py``).

Reference behavior reproduced:

- ``CastStrings.toInteger`` (``CastStrings.java:36-68``, ``cast_string.cu:159``
  ``string_to_integer_kernel``): optional whitespace strip, sign, digit
  accumulation with exact overflow detection, non-ANSI truncation at a
  decimal point, ANSI error row capture (``CastException``);
- ``CastStrings.toDecimal`` (``cast_string.cu:392`` with the two-pass
  ``validate_and_exponent`` design, ``:248-374``): scientific notation,
  half-up rounding at the scale boundary, precision overflow checks;
- ``CastStrings.toIntegersWithBase`` / ``fromIntegersWithBase``
  (``CastStringJni.cpp:159-257``): Spark ``conv()`` semantics.

The reference walks each row with one GPU thread.  Here, as in the JAX
package, every character position is one step over all rows: the parser's
state machine advances column by column across a padded byte rectangle
(``columnar.buckets.map_buckets``), one small state vector per row.  The JAX
package's ``lax.scan`` over the columns is a python loop over them, each
step a handful of eager torch ops on the column's device; there is no kernel
of its own.  u64 words are int64 tensors of the same bits (``utils.u64``).
"""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch.columnar import dtypes
from spark_rapids_jni_tpu_torch.columnar.buckets import map_buckets
from spark_rapids_jni_tpu_torch.columnar.column import (
    Column,
    Decimal128Column,
    StringColumn,
    strings_from_padded,
)
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType, Kind
from spark_rapids_jni_tpu_torch.utils import int128
from spark_rapids_jni_tpu_torch.utils.u64 import divmod_const, shr

__all__ = [
    "CastException",
    "string_to_integer",
    "string_to_decimal",
    "to_integers_with_base",
    "from_integers_with_base",
]

_I32 = torch.int32
_I64 = torch.int64


class CastException(ValueError):
    """ANSI-mode cast failure; carries the first offending row, mirroring the
    reference's ``CastException`` (``CastException.java``, thrown from
    ``validate_ansi_column`` at ``cast_string.cu:602-635``)."""

    def __init__(self, string_with_error: str, row_with_error: int):
        super().__init__(f"Error casting data on row {row_with_error}: {string_with_error}")
        self.string_with_error = string_with_error
        self.row_with_error = row_with_error


# Whitespace per the reference's is_whitespace (cast_string.cu:46-56): any
# byte <= 0x20 (C0 controls plus ' '); bytes >= 0x80 never are.
def _is_ws(c):
    return c <= 0x20


def _is_digit(c):
    return (c >= ord("0")) & (c <= ord("9"))


_INT_BOUNDS = {
    Kind.INT8: (-(2**7), 2**7 - 1),
    Kind.INT16: (-(2**15), 2**15 - 1),
    Kind.INT32: (-(2**31), 2**31 - 1),
    Kind.INT64: (-(2**63), 2**63 - 1),
}


def _first_true(mask: torch.Tensor, default: int) -> torch.Tensor:
    """Per-row index of the first True of ``[n, L]`` ``mask`` (int32), else
    ``default``."""
    m = mask.to(torch.uint8)
    idx = m.argmax(dim=1)
    found = torch.gather(m, 1, idx[:, None])[:, 0] != 0
    return torch.where(found, idx, default).to(_I32)


def _char_at(padded: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Byte at per-row position ``p`` (clamped into the rectangle)."""
    L = padded.shape[1]
    return torch.gather(padded, 1, torch.clamp(p, 0, max(L - 1, 0)).to(_I64)[:, None])[:, 0]


def _sign_and_start(padded, lens, strip: bool, signed: bool):
    """Leading-whitespace skip (only when ``strip``) and one optional +/-
    (signed types only): (sign, first position after them).  Mirrors
    cast_string.cu:184-201 (integer) and :325-341 (decimal)."""
    n, L = padded.shape
    pos = torch.arange(L, dtype=_I32, device=padded.device)[None, :]
    if strip:
        p = _first_true(~(_is_ws(padded) & (pos < lens[:, None])), L)
    else:
        p = torch.zeros((n,), dtype=_I32, device=padded.device)
    if not signed:
        return torch.ones((n,), dtype=_I32, device=padded.device), p
    c = _char_at(padded, p)
    in_range = p < lens
    is_minus = in_range & (c == ord("-"))
    is_plus = in_range & (c == ord("+"))
    return torch.where(is_minus, -1, 1).to(_I32), p + (is_minus | is_plus).to(_I32)


def _string_to_integer_kernel(padded, lens, valid_in, *, ansi_mode: bool, strip: bool,
                              min_v: int, max_v: int):
    """string_to_integer_kernel (cast_string.cu:159-245), one column of the
    rectangle per step."""
    n, L = padded.shape
    signed = min_v < 0
    sign, i0 = _sign_and_start(padded, lens, strip, signed)
    positive = sign > 0
    valid0 = valid_in & (lens > 0) & (i0 < lens)

    max_div10 = max_v // 10
    min_div10 = -((-min_v) // 10) if signed else 0  # C++ truncates toward zero

    dev = padded.device
    val = torch.zeros((n,), dtype=_I64, device=dev)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    trunc = torch.zeros((n,), dtype=torch.bool, device=dev)
    trailing = torch.zeros((n,), dtype=torch.bool, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    cols = padded.t().contiguous()
    for j in range(L):
        c = cols[j]
        active = valid0 & (j >= i0) & (j < lens) & valid & ~done
        ws = _is_ws(c)
        dig = _is_digit(c)

        # decision chain, in reference order (cast_string.cu:205-236)
        inv_trailing = trailing & ~ws
        if ansi_mode:
            set_trunc = torch.zeros_like(ws)
        else:
            set_trunc = ~inv_trailing & ~trunc & (c == ord("."))
        other = ~inv_trailing & ~set_trunc & ~dig
        if strip:
            set_trailing = other & ws & (i0 != j)
        else:
            set_trailing = torch.zeros_like(ws)
        invalid_now = active & (inv_trailing | (other & ~set_trailing))
        trunc = trunc | (active & set_trunc)
        trailing = trailing | (active & set_trailing)

        acc = active & ~invalid_now & ~trunc & ~trailing & dig
        first = i0 == j
        d = (c - ord("0")).to(_I64)  # uint8 wrap-around, as the JAX package
        ov1 = ~first & torch.where(positive, val > max_div10, val < min_div10)
        val1 = torch.where(first, val, val * 10)
        ov2 = torch.where(positive, val1 > max_v - d, val1 < min_v + d)
        overflow = acc & (ov1 | ov2)
        val = torch.where(acc & ~overflow, torch.where(positive, val1 + d, val1 - d), val)
        invalid_now = invalid_now | overflow
        valid = valid & ~invalid_now
        done = done | invalid_now
    valid = valid0 & valid
    return torch.where(valid, val, 0), valid


def _row_string(col: StringColumn, row: int, errors: str) -> str:
    offs = col.offsets[row:row + 2].tolist()
    return bytes(col.chars[offs[0]:offs[1]].cpu().numpy()).decode("utf-8", errors=errors)


def _raise_if_ansi_error(col: StringColumn, valid_out):
    """validate_ansi_column (cast_string.cu:602-635): the first row that was
    non-null on input but null on output raises CastException.  The decision
    is one scalar sync; the row's bytes are read only on the throw path."""
    errors = col.is_valid() & ~valid_out
    if not bool(errors.any()):
        return
    row = int(errors.to(torch.uint8).argmax())
    raise CastException(_row_string(col, row, "surrogatepass"), row)


def string_to_integer(col: StringColumn, dtype: DType, ansi_mode: bool = False,
                      strip: bool = True) -> Column:
    """Cast a string column to an integral column with Spark semantics
    (``CastStrings.toInteger``, CastStrings.java:36-68): invalid rows become
    null (or raise :class:`CastException` in ANSI mode), values after a
    decimal point are truncated in non-ANSI mode, whitespace (bytes <= 0x20)
    is stripped when ``strip``."""
    if dtype.kind not in _INT_BOUNDS:
        raise ValueError(f"not an integral type: {dtype}")
    min_v, max_v = _INT_BOUNDS[dtype.kind]
    if col.size == 0:
        return Column(torch.zeros((0,), dtype=dtype.torch_dtype, device=col.device), None, dtype)
    val, valid = map_buckets(
        col,
        lambda b, ln, v: _string_to_integer_kernel(b, ln, v, ansi_mode=ansi_mode, strip=strip,
                                                   min_v=min_v, max_v=max_v),
        [((), _I64), ((), torch.bool)],
        row_args=[col.is_valid()],
    )
    if ansi_mode:
        _raise_if_ansi_error(col, valid)
    return Column(val.to(dtype.torch_dtype), valid, dtype)


# ---------------------------------------------------------------------------
# string -> decimal
# ---------------------------------------------------------------------------

# validate_and_exponent states (cast_string.cu:261-270)
_ST_DIGITS = 0
_ST_EXPONENT = 1
_ST_DECIMAL_POINT = 2
_ST_EXPONENT_OR_SIGN = 3
_ST_EXPONENT_SIGN = 4
_ST_TRAILING_WS = 5
_ST_INVALID = 6

_ZCAP = 40  # zero-pad multiplies that cover any in-range value


def _string_to_decimal_kernel(padded, lens, valid_in, *, precision: int, scale: int,
                              strip: bool):
    """string_to_decimal_kernel + validate_and_exponent (cast_string.cu:248-582).
    ``scale`` is cudf-convention here (value = unscaled * 10**scale), to keep
    the formulas aligned with the reference.  The value accumulates in 128-bit
    (hi int64, lo u64 bits) words whatever the target width; the overflow
    guards compare against the target width's bounds, which makes the wider
    accumulator exactly equivalent to the reference's in-type arithmetic."""
    n, L = padded.shape
    dev = padded.device
    sign, i0 = _sign_and_start(padded, lens, strip, signed=True)
    positive = sign > 0
    first_digit = i0
    valid0 = valid_in & (lens > 0) & (i0 < lens)
    cols = padded.t().contiguous()

    B_DOT, B_E1, B_E2 = ord("."), ord("e"), ord("E")
    B_PLUS, B_MINUS = ord("+"), ord("-")

    # ---- pass 1: validate + find the decimal location (validate_and_exponent)
    st = torch.full((n,), _ST_DIGITS, dtype=_I32, device=dev)
    dl = torch.full((n,), -1, dtype=_I32, device=dev)
    expv = torch.zeros((n,), dtype=_I64, device=dev)
    exp_pos = torch.ones((n,), dtype=torch.bool, device=dev)
    last_digit = lens.to(_I32).clone()
    maxd10, mind10 = (2**63 - 1) // 10, -((2**63) // 10)
    for j in range(L):
        c = cols[j]
        active = valid0 & (j >= i0) & (j < lens) & (st != _ST_INVALID)
        char_num = j - i0
        ws = _is_ws(c)
        dig = _is_digit(c)
        allow_trailing = ws & (char_num != 0) & strip

        in_digits = (st == _ST_DIGITS) | (st == _ST_DECIMAL_POINT)
        # ST_DIGITS / ST_DECIMAL_POINT transitions (cast_string.cu:278-293)
        d_dot = in_digits & ~dig & (c == B_DOT) & (dl == -1)
        d_exp = in_digits & ~dig & ~d_dot & ((c == B_E1) | (c == B_E2))
        d_tws = in_digits & ~dig & ~d_dot & ~d_exp & allow_trailing
        st_digits_next = torch.where(dig, _ST_DIGITS, torch.where(
            d_dot, _ST_DECIMAL_POINT, torch.where(
                d_exp, _ST_EXPONENT_OR_SIGN, torch.where(d_tws, _ST_TRAILING_WS, _ST_INVALID))))
        # ST_EXPONENT_OR_SIGN transitions (:294-308)
        eos = st == _ST_EXPONENT_OR_SIGN
        e_sign = (c == B_PLUS) | (c == B_MINUS)
        st_eos_next = torch.where(e_sign, _ST_EXPONENT_SIGN, torch.where(
            ~e_sign & allow_trailing, _ST_TRAILING_WS,
            torch.where(dig, _ST_EXPONENT, _ST_INVALID)))
        # ST_EXPONENT_SIGN / ST_EXPONENT (:309-316), ST_TRAILING_WHITESPACE (:275-277)
        in_exp = (st == _ST_EXPONENT) | (st == _ST_EXPONENT_SIGN)
        st_exp_next = torch.where(dig, _ST_EXPONENT, _ST_INVALID)
        st_tws_next = torch.where(ws, _ST_TRAILING_WS, _ST_INVALID)
        st_next = torch.where(in_digits, st_digits_next, torch.where(
            eos, st_eos_next, torch.where(in_exp, st_exp_next, st_tws_next))).to(_I32)
        st2 = torch.where(active, st_next, st)

        dl = torch.where(active & d_dot, char_num, dl)
        exp_pos = torch.where(active & eos & (c == B_MINUS), False, exp_pos)

        # where the digits ended (:353-356)
        left_digits = (active & (st == _ST_DIGITS) & (st2 != _ST_DIGITS)
                       & (st2 != _ST_DECIMAL_POINT) & (last_digit == lens))
        last_digit = torch.where(left_digits, j, last_digit).to(_I32)

        # exponent accumulation (:358-364), int64 guards
        acc = active & (st2 == _ST_EXPONENT) & dig
        d = (c - ord("0")).to(_I64)
        first = expv == 0
        ov1 = ~first & torch.where(exp_pos, expv > maxd10, expv < mind10)
        ev1 = torch.where(first, expv, expv * 10)
        ov2 = torch.where(exp_pos, ev1 > (2**63 - 1) - d, ev1 < -(2**63) + d)
        exp_overflow = acc & (ov1 | ov2)
        expv = torch.where(acc & ~exp_overflow, torch.where(exp_pos, ev1 + d, ev1 - d), expv)
        st = torch.where(exp_overflow, _ST_INVALID, st2).to(_I32)

    valid = valid0 & (st != _ST_INVALID)
    # decimal location defaults to the end of the digits, then the exponent
    # shift (:367-371), clamped into int32 (absurd exponents fail the
    # significant-digit check below anyway)
    dl = torch.where(dl < 0, last_digit - first_digit, dl)
    dl = torch.clamp(dl.to(_I64) + expv, -(2**31), 2**31 - 1).to(_I32)

    # ---- pass 2a: significant digits before the decimal (:425-441)
    digits_found = torch.zeros((n,), dtype=_I32, device=dev)
    sig_in_string = torch.zeros((n,), dtype=_I32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    for j in range(L):
        c = cols[j]
        active = valid & (j >= first_digit) & (j < lens) & ~done & (digits_found < dl)
        is_e = (c == B_E1) | (c == B_E2)
        done = done | (active & is_e)
        is_num = active & ~is_e & (c != B_DOT)
        digits_found = digits_found + is_num.to(_I32)
        sig = is_num & ((sig_in_string != 0) | (c != ord("0")))
        sig_in_string = sig_in_string + sig.to(_I32)

    # target-width bounds for the overflow guards
    if precision <= dtypes.MAX_DECIMAL32_PRECISION:
        tmin, tmax = -(2**31), 2**31 - 1
    elif precision <= dtypes.MAX_DECIMAL64_PRECISION:
        tmin, tmax = -(2**63), 2**63 - 1
    else:
        tmin, tmax = -(2**127), 2**127 - 1
    maxd10_h, maxd10_l = int128.const128(tmax // 10)
    mind10_h, mind10_l = int128.const128(-((-tmin) // 10))
    tmax_h, tmax_l = int128.const128(tmax)
    tmin_h, tmin_l = int128.const128(tmin)

    def will_ov_mul10(vh, vl, pos):
        return torch.where(pos, int128.gt(vh, vl, maxd10_h, maxd10_l),
                           int128.lt(vh, vl, mind10_h, mind10_l))

    def will_ov_add(vh, vl, d, pos):
        # pos: v > tmax - d ; neg: v < tmin + d  (d in [0, 9])
        bh, bl = int128.sub_small(torch.full_like(vh, tmax_h), torch.full_like(vh, tmax_l), d)
        ch, cl = int128.add_small(torch.full_like(vh, tmin_h), torch.full_like(vh, tmin_l), d)
        return torch.where(pos, int128.gt(vh, vl, bh, bl), int128.lt(vh, vl, ch, cl))

    # last processable digit count: scale units past the decimal (:450-452)
    last_digit = dl - scale

    # ---- pass 2b: march the digits, accumulate with rounding (:462-529)
    vh = torch.zeros((n,), dtype=_I64, device=dev)
    vl = torch.zeros((n,), dtype=_I64, device=dev)
    total = torch.zeros((n,), dtype=_I32, device=dev)
    precise = torch.zeros((n,), dtype=_I32, device=dev)
    found_sig = torch.zeros((n,), dtype=torch.bool, device=dev)
    rdigits = torch.zeros((n,), dtype=_I32, device=dev)
    dloc = dl
    valid_m = torch.ones((n,), dtype=torch.bool, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    one = torch.ones((n,), dtype=_I64, device=dev)
    for j in range(L):
        c = cols[j]
        active = valid_m & (j >= first_digit) & (j < lens) & ~done & (last_digit >= 0)
        dig = _is_digit(c)
        # '.' continues; any other non-digit stops the march
        done2 = done | (active & ~dig & (c != B_DOT))
        proc = active & dig
        d = (c - ord("0")).to(_I64)
        needs_round = proc & ((precise + 1 > precision) | (total + 1 > last_digit))

        # rounding (:474-512): half-up away from zero
        do_inc = needs_round & (d >= 5)
        inc_ov = do_inc & will_ov_add(vh, vl, one, positive)
        apply_inc = do_inc & ~inc_ov
        grew = torch.zeros_like(apply_inc)
        vh2, vl2 = vh, vl
        if bool(apply_inc.any()):  # rounding happens once per row at most
            rh, rl = int128.add_small(vh, vl, one)
            rh2, rl2 = int128.sub_small(vh, vl, one)
            nh = torch.where(positive, rh, rh2)
            nl = torch.where(positive, rl, rl2)
            orig_zero = (vh == 0) & (vl == 0)
            grew = (apply_inc & ~orig_zero
                    & (int128.count_digits(nh, nl) > int128.count_digits(vh, vl)))
            vh2 = torch.where(apply_inc, nh, vh)
            vl2 = torch.where(apply_inc, nl, vl)
        g = grew.to(_I32)
        total2, precise2, dloc, rdigits = total + g, precise + g, dloc + g, rdigits + g
        done2 = done2 | needs_round
        valid2 = valid_m & ~inc_ov

        # normal accumulate (:515-527)
        acc = proc & ~needs_round
        total = total2 + acc.to(_I32)
        sig_now = acc & (found_sig | (total > dloc) | (d != 0))
        found_sig = found_sig | sig_now
        precise = precise2 + sig_now.to(_I32)

        first = first_digit == j
        ov1 = acc & ~first & will_ov_mul10(vh2, vl2, positive)
        th, tl = int128.mul_small(vh2, vl2, 10)
        vh3 = torch.where(acc & ~first, th, vh2)
        vl3 = torch.where(acc & ~first, tl, vl2)
        ov2 = acc & will_ov_add(vh3, vl3, d, positive)
        ah, al = int128.add_small(vh3, vl3, d)
        sh, sl = int128.sub_small(vh3, vl3, d)
        apply = acc & ~ov1 & ~ov2
        # on overflow the reference breaks with valid = false, value kept
        vh = torch.where(apply, torch.where(positive, ah, sh), vh2)
        vl = torch.where(apply, torch.where(positive, al, sl), vl2)
        acc_ov = acc & (ov1 | ov2)
        valid_m = valid2 & ~acc_ov
        done = done2 | acc_ov
    valid = valid & valid_m

    # ---- post-march scaling (:531-575)
    preceding_zeros = torch.where(dloc < 0, -dloc, 0)
    if scale > 0:
        zeros_to_decimal = torch.clamp(dloc - total - scale, min=0)
    else:
        zeros_to_decimal = torch.clamp(dloc - total, min=0)
    sig_before_decimal = sig_in_string + zeros_to_decimal + rdigits
    valid = valid & (precision + scale >= sig_before_decimal)

    # zero-pad loops (:548-555 and :562-573): _ZCAP multiplies cover any
    # in-range value; a nonzero value needing more overflows, caught directly
    zero_val = (vh == 0) & (vl == 0)

    def pad_zeros(count, vh, vl, valid):
        valid = valid & ~((count > _ZCAP) & ~zero_val)
        steps = min(_ZCAP, int(count.max())) if count.numel() else 0
        for i in range(steps):  # rows with count <= i are left as they are
            run = (i < count) & valid
            ov = run & will_ov_mul10(vh, vl, positive)
            th, tl = int128.mul_small(vh, vl, 10)
            apply = run & ~ov
            vh, vl, valid = torch.where(apply, th, vh), torch.where(apply, tl, vl), valid & ~ov
        return vh, vl, valid

    vh, vl, valid = pad_zeros(zeros_to_decimal, vh, vl, valid)
    precise = precise + zeros_to_decimal
    digits_after_decimal = precise - sig_before_decimal + preceding_zeros
    digits_needed = torch.clamp(precision - sig_before_decimal, max=-scale)
    vh, vl, valid = pad_zeros(torch.clamp(digits_needed - digits_after_decimal, min=0),
                              vh, vl, valid)
    return torch.where(valid, vh, 0), torch.where(valid, vl, 0), valid


def string_to_decimal(col: StringColumn, precision: int, scale: int, ansi_mode: bool = False,
                      strip: bool = True):
    """Cast strings to a Spark decimal(precision, scale) column
    (``CastStrings.toDecimal``, CastStrings.java:70-100).  ``scale`` is
    Spark-convention (digits after the point); storage follows precision as
    in cudf: <= 9 int32, <= 18 int64, else a Decimal128Column."""
    dtype = dtypes.decimal(precision, scale)
    if col.size == 0:
        z = torch.zeros((0,), dtype=_I64, device=col.device)
        if dtype.kind == Kind.DECIMAL128:
            return Decimal128Column(z, z.clone(), None, dtype)
        return Column(z.to(dtype.torch_dtype), None, dtype)
    vh, vl, valid = map_buckets(
        col,
        lambda b, ln, v: _string_to_decimal_kernel(b, ln, v, precision=precision,
                                                   scale=-scale, strip=strip),
        [((), _I64), ((), _I64), ((), torch.bool)],
        row_args=[col.is_valid()],
    )
    if ansi_mode:
        _raise_if_ansi_error(col, valid)
    if dtype.kind == Kind.DECIMAL128:
        return Decimal128Column(vh, vl, valid, dtype)
    return Column(vl.to(dtype.torch_dtype), valid, dtype)


# ---------------------------------------------------------------------------
# Spark conv(): to/from integers with base
# ---------------------------------------------------------------------------


def _digit_value(c, base: int):
    """Digit value of each byte in ``base`` (10 or 16), or 255."""
    dec = torch.where(_is_digit(c), c - ord("0"), 255)
    if base == 10:
        return dec.to(torch.uint8)
    up = torch.where((c >= ord("A")) & (c <= ord("F")), c - (ord("A") - 10), 255)
    lo = torch.where((c >= ord("a")) & (c <= ord("f")), c - (ord("a") - 10), 255)
    return torch.minimum(dec, torch.minimum(up, lo)).to(torch.uint8)


def _is_regex_ws(c):
    """``\\s`` in cudf's regex: space, \\t, \\n, \\r, \\f, \\v."""
    return (c == 0x20) | ((c >= 0x09) & (c <= 0x0D))


def _to_integers_with_base_kernel(padded, lens, valid_in, *, base: int):
    """Spark conv() parse: ``^\\s*(-?[digits]+).*`` -> u64 with wraparound;
    junk -> 0; empty or whitespace-only -> null (CastStringJni.cpp:159-227)."""
    n, L = padded.shape
    pos = torch.arange(L, dtype=_I32, device=padded.device)[None, :]
    inb = pos < lens[:, None]
    lead = _first_true(~(_is_regex_ws(padded) & inb), L)
    all_ws = lead >= lens  # matches ^\s*$ (also empty)
    neg = (_char_at(padded, lead) == ord("-")) & (lead < lens)
    start = lead + neg.to(_I32)

    dv = _digit_value(padded, base)
    after_start = pos >= start[:, None]
    # the digit run directly at `start` ends at the first non-digit after it
    stop = _first_true(after_start & ~((dv != 255) & inb), L)
    matched = stop > start

    val = torch.zeros((n,), dtype=_I64, device=padded.device)
    cols = dv.t().contiguous()
    for j in range(L):
        take = (start <= j) & (j < stop)
        val = torch.where(take, val * base + cols[j].to(_I64), val)
    val = torch.where(neg, -val, val)
    return torch.where(matched, val, 0), valid_in & ~all_ws


def to_integers_with_base(col: StringColumn, base: int = 10) -> Column:
    """Spark ``conv(str, base, 10)``'s front half (CastStrings.java:116-130):
    parse in ``base`` to UINT64 (int64 bits) with wraparound for negatives."""
    if base not in (10, 16):
        raise CastException(f"Bases supported 10, 16; Actual: {base}", 0)
    if col.size == 0:
        return Column(torch.zeros((0,), dtype=_I64, device=col.device), None, dtypes.UINT64)
    val, valid = map_buckets(
        col,
        lambda b, ln, v: _to_integers_with_base_kernel(b, ln, v, base=base),
        [((), _I64), ((), torch.bool)],
        row_args=[col.is_valid()],
    )
    return Column(val, valid, dtypes.UINT64)


def _format_int_kernel(data, *, base: int, signed: bool, width: int):
    """integer -> digit bytes without leading zeros (uppercase hex).  Hex
    shows the two's-complement bits at the column's type width (cudf
    integers_to_hex: int32 -5 -> "FFFFFFFB")."""
    max_digits = 20 if base == 10 else 16
    i = data.to(_I64)
    if signed and base == 10:
        negative = i < 0
        mag = torch.where(negative, -i, i)  # |INT64_MIN| is 2**63 as u64 bits
    else:
        negative = torch.zeros(i.shape, dtype=torch.bool, device=i.device)
        mag = i & ((1 << (8 * width)) - 1) if width < 8 else i

    # digit k counted from the least-significant end, and whether any digit
    # at or above it is nonzero
    digs, has = [], []
    q = mag
    for k in range(max_digits):
        if base == 16:
            above = shr(mag, 4 * k)
            digs.append(above & 0xF)
            has.append(above != 0)
        else:
            has.append(q != 0)
            q, r = divmod_const(q, 10)  # unsigned: mag reaches 2**64 - 1
            digs.append(r)
    digs = torch.stack(digs, dim=1).to(torch.uint8)
    ndig = torch.clamp(torch.stack(has, dim=1).sum(dim=1, dtype=_I32), min=1)
    lengths = ndig + negative.to(_I32)

    out_pos = torch.arange(max_digits + 1, dtype=_I32, device=i.device)[None, :]
    src = ndig[:, None] - 1 - (out_pos - negative.to(_I32)[:, None])
    dsel = torch.gather(digs, 1, torch.clamp(src, 0, max_digits - 1).to(_I64))
    chars = torch.where(dsel < 10, dsel + ord("0"), dsel + (ord("A") - 10)).to(torch.uint8)
    chars = torch.where((out_pos == 0) & negative[:, None], ord("-"), chars).to(torch.uint8)
    return torch.where(out_pos < lengths[:, None], chars, 0).to(torch.uint8), lengths


def from_integers_with_base(col: Column, base: int = 10) -> StringColumn:
    """Format integers as strings in ``base`` (CastStrings.java:133-152).

    base 10: signed columns print a leading '-', UINT64 columns (the Spark
    ``conv`` path) print unsigned.  base 16 is always unsigned uppercase over
    the two's-complement bits at the column's type width, with no leading
    zeros (zero -> "0").
    """
    if base not in (10, 16):
        raise CastException(f"Bases supported 10, 16; Actual: {base}", 0)
    if col.size == 0:
        return StringColumn(torch.zeros((0,), dtype=torch.uint8, device=col.device),
                            torch.zeros((1,), dtype=torch.int32, device=col.device), None)
    signed = col.data.dtype.is_signed and col.dtype.kind != Kind.UINT64
    padded, lengths = _format_int_kernel(col.data, base=base, signed=signed,
                                         width=col.data.element_size())
    return strings_from_padded(padded, lengths, col.validity)
