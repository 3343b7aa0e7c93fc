"""Spark ``format_number`` for float columns, ``#,###,###.##`` layout
(PyTorch port of ``ops/format_float.py``).

Parity with the reference's format_float (format_float.cu:113; layout kernel
to_formatted_chars ftos_converter.cuh:1271-1383, round_half_even :1247,
specials copy_format_special_str :1413-1432): Ryu's shortest digits, grouped
with commas, rounded half-even to a fixed number of fraction digits;
NaN -> U+FFFD, +-inf -> U+221E, zero keeps its sign ("-0.00000").

The Ryu cores of ``float_to_string`` (``_d2d`` / ``_f2d``) give (mantissa,
exponent); every output byte is then grid arithmetic over ``[rows, width]``:
each position computes its distance from the right ``q``, decides comma
(q % 4 == 3) or digit (q - q // 4), and gathers the digit.  One arm, eager
torch on the column's device; the only host read is the column's largest
exponent, which sizes the grid.
"""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch.columnar.column import Column, StringColumn, strings_from_padded
from spark_rapids_jni_tpu_torch.columnar.dtypes import Kind
from spark_rapids_jni_tpu_torch.ops.float_to_string import (
    _d2d,
    _decimal_length_u64,
    _f2d,
    digit_from_table,
    digit_table_u64,
    render_grid,
)
from spark_rapids_jni_tpu_torch.utils.floatbits import f32_to_bits
from spark_rapids_jni_tpu_torch.utils.u64 import M32, divmod_tensor, s64, shr, uge, ugt

_I32 = torch.int32
_I64 = torch.int64
_U8 = torch.uint8
_POW10 = [s64(10**k) for k in range(20)]  # 10**19 is past 2**63: u64 bits


def _pow10(k: torch.Tensor) -> torch.Tensor:
    """10**clamp(k, 0, 19) as u64 bits."""
    tab = torch.tensor(_POW10, dtype=_I64, device=k.device)
    return tab[torch.clamp(k, 0, 19).to(_I64)]


def _round_half_even(value, olength, digits):
    """round_half_even (ftos_converter.cuh:1247): keep ``digits`` leading
    decimal digits of ``value`` (which has ``olength`` digits)."""
    div = _pow10(olength - digits)
    num, mod = divmod_tensor(value, div)
    half = shr(div, 1)
    inc = ugt(mod, half) | ((mod == half) & ((num & 1) == 1) & (mod != 0))
    return torch.where(digits >= olength, value, num + inc.to(_I64))


def format_float(col: Column, digits: int, width_hint: int = 0) -> StringColumn:
    """Format FLOAT32/FLOAT64 like Spark's ``format_number(col, digits)``.

    ``width_hint`` (optional) caps the integer-part digit count that sizes
    the render grid; without it the grid is sized from the column's largest
    exponent.
    """
    if digits < 0:
        raise ValueError("digits must be >= 0")
    if col.dtype.kind == Kind.FLOAT64:
        bits = col.data.to(_I64)
        negative = bits < 0
        mant_f = bits & ((1 << 52) - 1)
        expo_f = shr(bits, 52) & 0x7FF
        is_nan = (expo_f == 0x7FF) & (mant_f != 0)
        is_inf = (expo_f == 0x7FF) & (mant_f == 0)
        is_zero = (expo_f == 0) & (mant_f == 0)
        output, e10 = _d2d(bits)
        max_exp, bias = 309, 1023
    elif col.dtype.kind == Kind.FLOAT32:
        bits32 = f32_to_bits(col.data)
        bits = bits32.to(_I64) & M32
        negative = bits32 < 0
        mant_f = bits & ((1 << 23) - 1)
        expo_f = shr(bits, 23) & 0xFF
        is_nan = (expo_f == 0xFF) & (mant_f != 0)
        is_inf = (expo_f == 0xFF) & (mant_f == 0)
        is_zero = (expo_f == 0) & (mant_f == 0)
        output, e10 = _f2d(bits)
        max_exp, bias = 39, 127
    else:
        raise TypeError("Values for format_float function must be a float type.")

    n = output.shape[0]
    dev = output.device
    # bound the grid by the column's largest finite magnitude (host read of
    # the exponent field): decimal digits <= floor(e2 * log10(2)) + 2.  NaN
    # and inf rows render at most 4 fixed bytes, so unlike the JAX package's
    # bound they do not widen every row to the type's maximum; the rows'
    # bytes are the same
    if width_hint > 0:
        max_exp = min(max_exp, width_hint)
    elif n > 0:
        e2_max = int(torch.where(is_nan | is_inf, 0, expo_f).max())
        max_exp = max(2, min(max_exp, int((max(e2_max - bias, 1)) * 0.30103) + 3))
    width = 1 + max_exp + (max_exp - 1) // 3 + 1 + digits + 1
    olength = _decimal_length_u64(output, 17)
    exp = e10 + olength - 1
    s = negative.to(_I32)
    D = digits

    normal = ~(is_nan | is_inf | is_zero)
    b1 = normal & (exp < 0)
    b23 = normal & (exp >= 0)
    b2 = b23 & (exp + 1 >= olength)
    b3 = b23 & (exp + 1 < olength)

    # ---- branch 1: 0.xxx (ftos_converter.cuh:1280-1314)
    nz_full = -exp - 1  # zeros between '.' and the first value digit
    early = b1 & (nz_full > D)  # the rounding window ends inside the zeros
    nz = torch.clamp(nz_full, max=D)
    actual_round = torch.clamp(D - nz, min=0)
    aol1 = torch.minimum(olength, actual_round)
    r1 = _round_half_even(output, olength, actual_round)
    # digits == 0 returns the bare '0' before any rounding (cuh:1284)
    p10_aol1 = _pow10(aol1)
    carry1 = b1 & ~early & (D > 0) & uge(r1, p10_aol1)
    r1 = torch.where(carry1, r1 - p10_aol1, r1)
    carrier_pos = torch.where(nz > 0, s + 2 + nz - 1, s)

    # ---- branch 3 rounding (ftos_converter.cuh:1343-1357); the trailing
    # zeros after the temp_d fraction digits fall out of the in_frac grid
    temp_d = torch.clamp(olength - exp - 1, max=D)
    r3 = _round_half_even(output, olength, exp + temp_d + 1)
    int3, dec3 = divmod_tensor(r3, _pow10(temp_d))
    il3 = _decimal_length_u64(int3, 19)

    # integer-section lengths (with commas)
    fl2 = exp + 1 + torch.div(exp, 3, rounding_mode="floor")
    fl3 = il3 + torch.div(il3 - 1, 3, rounding_mode="floor")
    z2 = exp + 1 - olength  # trailing zeros appended to output in branch 2
    int_fl = torch.where(b2, fl2, fl3)
    # row lengths (format_size :1386-1410, and the specials)
    len_norm = torch.where(b1, s + 2 + D, s + int_fl + 1 + D)
    if digits == 0:
        len_norm = len_norm - 1
    lens = torch.where(is_nan, 3, torch.where(
        is_inf, s + 3, torch.where(is_zero, s + 2 + D if D > 0 else s + 1, len_norm)))

    # ---- render the [n, width] grid, a block of rows at a time
    def u8(ch):
        return torch.tensor(ch if isinstance(ch, int) else ord(ch), dtype=_U8, device=dev)

    ZERO, ONE, DOT, COMMA, MINUS = u8("0"), u8("1"), u8("."), u8(","), u8("-")
    nan_bytes = [u8(b) for b in "\ufffd".encode()]
    inf_bytes = [u8(b) for b in "\u221e".encode()]
    p = torch.arange(width, dtype=_I32, device=dev)[None, :]
    tab_r1 = digit_table_u64(r1)
    tab_dec3 = digit_table_u64(dec3)
    # branches 2/3: the integer section's digits
    tab_int = digit_table_u64(torch.where(b2, output, int3))

    def render(lo, hi):
        rows = slice(lo, hi)
        sC = s[rows, None]
        nzC, carry1C = nz[rows, None], carry1[rows, None]
        # branch 1 grid
        in_zeros = (p >= sC + 2) & (p < sC + 2 + nzC)
        j1 = p - (sC + 2 + nzC)  # index into the value digits (from the left)
        in_val1 = (j1 >= 0) & (j1 < aol1[rows, None])
        ch1 = torch.where(
            p == sC,
            torch.where(carry1C & (nzC == 0), ONE, ZERO),
            torch.where(
                p == sC + 1, DOT,
                torch.where(
                    in_zeros,
                    torch.where(carry1C & (p == carrier_pos[rows, None]), ONE, ZERO),
                    torch.where(in_val1,
                                digit_from_table(tab_r1[rows], aol1[rows, None] - 1 - j1),
                                ZERO))))

        # branches 2/3 grid: integer section with commas, then '.', the fraction
        z = torch.where(b2[rows], z2[rows], 0)[:, None]
        fl = int_fl[rows, None]
        q = fl - 1 - (p - sC)  # distance from the right within the integer section
        in_int = (p >= sC) & (q >= 0)
        is_comma = in_int & (torch.remainder(q, 4) == 3)
        dr = q - torch.div(q, 4, rounding_mode="floor")  # digit index from the right
        int_digit = torch.where(dr < z, ZERO, digit_from_table(tab_int[rows],
                                                               torch.clamp(dr - z, min=0)))
        frac_t = p - (sC + fl + 1)  # fraction digit index (0-based)
        in_frac = (frac_t >= 0) & (frac_t < D)
        # branch 2's fraction is all zeros; branch 3's: temp_d digits then zeros
        tdC = temp_d[rows, None]
        frac_digit = torch.where(b3[rows, None] & (frac_t < tdC),
                                 digit_from_table(tab_dec3[rows], tdC - 1 - frac_t), ZERO)
        ch23 = torch.where(is_comma, COMMA, torch.where(
            in_int, int_digit, torch.where(p == sC + fl, DOT,
                                           torch.where(in_frac, frac_digit, ZERO))))

        grid = torch.where(b1[rows, None], ch1, ch23)
        # sign for normal, inf and zero rows
        grid = torch.where((p == 0) & (sC == 1), MINUS, grid)
        # zero rows: "0." + zeros
        zero_m = is_zero[rows, None]
        grid = torch.where(zero_m & (p == sC), ZERO, grid)
        grid = torch.where(zero_m & (p == sC + 1), DOT, grid)
        grid = torch.where(zero_m & (p > sC + 1), ZERO, grid)
        # specials
        for k in range(3):
            grid = torch.where(is_nan[rows, None] & (p == k), nan_bytes[k], grid)
            grid = torch.where(is_inf[rows, None] & (p == sC + k), inf_bytes[k], grid)
        return grid

    grid = render_grid(n, width, dev, render)
    return strings_from_padded(grid, lens, col.validity)
