"""Decimal -> string with Java ``BigDecimal.toString`` semantics (PyTorch port
of ``ops/cast_decimal_to_string.py``).

Parity with the reference's decimal_to_non_ansi_string
(cast_decimal_to_string.cu:52-160): plain ``[-]integer.fraction`` when the
(cudf) scale <= 0 and the adjusted exponent >= -6, scientific ``d.dddE±x``
otherwise, including the ``0E-7`` edge for zero at scale -7.  The reference
takes cuDF scales (negative = fraction digits); DType carries Spark scales,
so ``spark_scale = -cudf_scale`` throughout.

The JAX package splits each magnitude at 10^K (K the row's fraction width)
with the 256-bit limb divider, then splits both parts at 10^19 for their
digit tables.  The port takes the digits of the whole magnitude once
instead: one exact division by 10^19, done as ``(v >> 19) / 5**19`` over
16-bit limbs (every partial remainder fits int64), gives a 39-digit table;
the integer part is its digits from K up and the zero-padded fraction its
digits below K, the same bytes as the JAX package's three divisions without
their 768 sequential steps.  Each output byte is then grid arithmetic, as in
``ops.format_float``.
"""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch.columnar.column import (
    Column,
    Decimal128Column,
    StringColumn,
    strings_from_padded,
)
from spark_rapids_jni_tpu_torch.columnar.dtypes import Kind
from spark_rapids_jni_tpu_torch.ops.float_to_string import (
    digit_from_table,
    digit_table_u64,
    render_grid,
)
from spark_rapids_jni_tpu_torch.utils.int128 import const128
from spark_rapids_jni_tpu_torch.utils.u64 import shl, shr, uge, ugt

_I32 = torch.int32
_I64 = torch.int64
_U8 = torch.uint8

MAX_LEN = 48  # sign + 39 digits + '.' + 'E' + sign + 3 exp digits

_P10 = [const128(10**k) for k in range(39)]  # (hi, lo) int64 bits
_FIVE19 = 5**19  # < 2**45


def _split_1919(ahi, alo):
    """u128 magnitude (ahi, alo) below 2**127 + 1 -> (h19, l19) u64 bits with
    value = h19 * 10^19 + l19.  value // 10^19 = (value >> 19) // 5^19:
    the top 45 bits of value >> 19 are already below 5^19 (value <= 2**127),
    so the division runs over its low 64 bits in 16-bit limbs from the top,
    each partial remainder times 2**16 below 2**61."""
    r = shr(ahi, 19)  # bits 83.. of value: < 2**44 < 5**19
    w_lo = shl(ahi, 45) | shr(alo, 19)
    q = torch.zeros_like(alo)
    for shift in (48, 32, 16, 0):
        cur = (r << 16) | (shr(w_lo, shift) & 0xFFFF)
        qd = cur // _FIVE19
        r = cur - qd * _FIVE19
        q = q | (qd << shift)
    return q, (r << 19) | (alo & ((1 << 19) - 1))


def decimal_to_string(col) -> StringColumn:
    """Convert DECIMAL32/64/128 to strings (decimal_to_non_ansi_string)."""
    if isinstance(col, Decimal128Column):
        hi, lo = col.hi.to(_I64), col.lo.to(_I64)
        neg = hi < 0
        nlo = ~lo + 1
        nhi = ~hi + (nlo == 0).to(_I64)
        ahi = torch.where(neg, nhi, hi)
        alo = torch.where(neg, nlo, lo)
    elif isinstance(col, Column) and col.dtype.kind in (Kind.DECIMAL32, Kind.DECIMAL64):
        v = col.data.to(_I64)
        neg = v < 0
        alo = torch.abs(v)  # |INT64_MIN| is 2**63 as u64 bits
        ahi = torch.zeros_like(alo)
    else:
        raise TypeError("decimal_to_string requires a decimal column")
    ss = col.dtype.scale
    dev = alo.device

    # digit count via u128 >= 10^k comparisons
    nd = torch.ones(alo.shape, dtype=_I32, device=dev)
    for k in range(1, 39):
        ph, pl = _P10[k]
        nd = nd + (ugt(ahi, ph) | ((ahi == ph) & uge(alo, pl))).to(_I32)
    adj = -ss + nd - 1  # adjusted exponent (cu:72)
    plain = (adj >= -6) & (ss >= 0)
    K = torch.where(plain, ss, nd - 1).to(_I32)  # fraction width

    h19, l19 = _split_1919(ahi, alo)
    tab = torch.cat([digit_table_u64(l19, 19), digit_table_u64(h19, 20)], dim=-1)  # [n, 39]

    il = torch.clamp(nd - K, min=1)  # integer digit count ("0" included)
    s = neg.to(_I32)
    has_dot = K > 0
    eabs = torch.abs(adj)
    elen = 1 + (eabs >= 10).to(_I32) + (eabs >= 100).to(_I32)
    sci = ~plain
    lens = s + il + has_dot.to(_I32) * (1 + K) + sci.to(_I32) * (2 + elen)

    # ---- render the [n, MAX_LEN] grid, a block of rows at a time
    def u8(ch):
        return torch.tensor(ord(ch), dtype=_U8, device=dev)

    MINUS, PLUS, DOT, E, NUL = u8("-"), u8("+"), u8("."), u8("E"), u8("\0")
    p = torch.arange(MAX_LEN, dtype=_I32, device=dev)[None, :]

    def render(lo, hi):
        rows = slice(lo, hi)
        sC, ilC, KC, dotC = s[rows, None], il[rows, None], K[rows, None], has_dot[rows, None]
        sciC, elenC = sci[rows, None], elen[rows, None]
        tab_r = tab[rows]
        in_int = (p >= sC) & (p < sC + ilC)
        int_digit = digit_from_table(tab_r, KC + ilC - 1 - (p - sC))
        dot_pos = sC + ilC
        frac_t = p - (dot_pos + 1)
        in_frac = dotC & (frac_t >= 0) & (frac_t < KC)
        frac_digit = digit_from_table(tab_r, KC - 1 - frac_t)
        pE = dot_pos + torch.where(dotC, 1 + KC, 0)
        exp_t = p - (pE + 2)
        k10 = elenC - 1 - exp_t
        p10 = torch.where(k10 >= 2, 100, torch.where(k10 >= 1, 10, 1)).to(_I32)
        exp_digit = (torch.remainder(eabs[rows, None] // p10, 10) + ord("0")).to(_U8)
        return torch.where(
            (p == 0) & (sC == 1), MINUS, torch.where(
                in_int, int_digit, torch.where(
                    dotC & (p == dot_pos), DOT, torch.where(
                        in_frac, frac_digit, torch.where(
                            sciC & (p == pE), E, torch.where(
                                sciC & (p == pE + 1),
                                torch.where(adj[rows, None] < 0, MINUS, PLUS),
                                torch.where(sciC & (exp_t >= 0) & (exp_t < elenC), exp_digit,
                                            NUL)))))))

    grid = render_grid(alo.shape[0], MAX_LEN, dev, render)
    return strings_from_padded(grid, lens, col.validity)
