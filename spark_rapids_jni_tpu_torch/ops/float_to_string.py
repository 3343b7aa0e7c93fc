"""Java ``Double.toString`` / ``Float.toString``: vectorized Ryu (PyTorch port
of ``ops/float_to_string.py``).

Capability parity with the reference's device Ryu (ftos_converter.cuh: d2d
:480, f2d :575, to_chars :797/:922, special strings :259; driver
cast_float_to_string.cu:34-128): the shortest decimal that round-trips,
laid out per the Java spec: plain in [1e-3, 1e7), scientific ``d.dddE±x``
otherwise, ``NaN`` / ``Infinity`` / ``-0.0`` specials.

The reference runs scalar Ryu per GPU thread.  Here, as in the JAX package,
every step is lane arithmetic over the column: 128-bit products from 32-bit
limbs, per-lane shifts, the exact power-of-5 tables (``utils.ryu_tables``)
gathered per row, the shortest-search loop as masked iterations, and the
characters scattered into a padded byte matrix.  u64 lanes are int64
tensors of the same bits: compares, right shifts and division go through
``utils.u64``.

Three arms, bit-identical by test:

- the lane arm (``float_device_render=True``, ``float_bucketed=True``):
  value-class buckets (``columnar.buckets.map_classes``) — specials skip
  Ryu, exact integers in [1, 1e7) strip trailing zeros, only the residue
  pays full Ryu — and one-gather emission (``_emit_fast``).  The classes
  are host metadata: one device-to-host copy of the bits per call, timed
  under the ``bucket`` phase;
- the monolithic oracle (``float_bucketed=False``): every row pays full Ryu
  and per-position emission (``_emit``);
- the numpy twin (``float_device_render=False``), copied from the JAX
  package, with branch and active-set compaction.

``"auto"`` gives a CUDA column the lane arm and a CPU column the twin; the
result is on the column's device either way.  FLOAT64 input is the int64
bit-pattern convention, exactly what Ryu wants; FLOAT32 goes through
``utils.floatbits.f32_to_bits``.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.columnar.buckets import class_buckets, map_classes
from spark_rapids_jni_tpu_torch.columnar.column import (
    Column,
    StringColumn,
    strings_from_padded,
)
from spark_rapids_jni_tpu_torch.columnar.dtypes import Kind
from spark_rapids_jni_tpu_torch.obs.phases import PhaseTimes
from spark_rapids_jni_tpu_torch.utils import ryu_tables as rt
from spark_rapids_jni_tpu_torch.utils.floatbits import f32_to_bits
from spark_rapids_jni_tpu_torch.utils.u64 import (
    M32,
    divmod_const,
    divmod_tensor,
    s64,
    shl,
    shr,
    uge,
    ugt,
    ule,
    ult,
    umul128,
)

_I32 = torch.int32
_I64 = torch.int64
_U8 = torch.uint8

MAX_D2S_LEN = 24  # sign + 17 digits + '.' + pad0 + 'E' + '-' + 3 exp digits

_POW10_NP = np.array([10**k for k in range(20)], dtype=np.uint64)
_POW5_NP = np.array([5**k for k in range(24)], dtype=np.uint64)

# pipeline phase timers (obs/phases.py): bucket = classification + class
# split, ryu = digit computation (shortest search or strip), emit =
# character emission + column assembly
PHASES = PhaseTimes("bucket", "ryu", "emit", name="float_to_string")

# value classes (class_buckets ids): specials render from a 5-row table,
# simple integers take the strip loop, the residue pays full Ryu
CLS_SPECIAL = 0
CLS_SIMPLE = 1
CLS_RYU = 2

_TABLES = {}


def _table(name: str, device: torch.device) -> torch.Tensor:
    """A numpy constant table as a tensor on ``device`` (u64 entries as
    int64 bits), uploaded once per device."""
    key = (name, device)
    t = _TABLES.get(key)
    if t is None:
        if name == "pow5":
            arr = _POW5_NP
        elif name == "special":
            arr = _special_table()[0]
        elif name == "special_len":
            arr = _special_table()[1]
        else:
            arr = getattr(rt, name)
        if arr.dtype == np.uint64:
            arr = arr.view(np.int64)
        t = _TABLES[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t


def digit_table_u64(v: torch.Tensor, maxd: int = 20) -> torch.Tensor:
    """``[n, maxd]`` uint8 decimal digits of u64 ``v`` (int64 bits), index k
    = digit from the RIGHT (ones digit at k=0), zero above the value's
    length.  A divide-by-10 chain: the first step is unsigned (``v`` may
    reach 2**64 - 1); after it every value is below 2**61, so the rest use
    torch's (signed) division."""
    cols = []
    for k in range(maxd):
        if k == 0:
            q, r = divmod_const(v, 10)
        else:
            q, r = torch.div(v, 10, rounding_mode="floor"), torch.remainder(v, 10)
        cols.append(r.to(_U8))
        v = q
    return torch.stack(cols, dim=-1)


def digit_from_table(tab: torch.Tensor, k) -> torch.Tensor:
    """ASCII digits gathered at (broadcast) right-index ``k``; out-of-range
    k clamps (callers mask those positions)."""
    maxd = tab.shape[-1]
    kc = torch.clamp(k, 0, maxd - 1).to(_I64)
    if kc.ndim == tab.ndim - 1:
        return torch.gather(tab, -1, kc[..., None])[..., 0] + ord("0")
    return torch.gather(tab, -1, kc) + ord("0")


GRID_CELLS = 1 << 25  # cells of a render grid's [rows, width] temporaries at a time


def render_grid(n: int, width: int, device, render) -> torch.Tensor:
    """The ``[n, width]`` uint8 byte grid of a grid-arithmetic renderer, built
    GRID_CELLS cells at a time: ``render(lo, hi)`` returns rows [lo, hi).
    The grid's position and index temporaries are int32 and int64 ``[rows,
    width]`` matrices, so a whole 2**24-row column would hold tens of GB."""
    out = torch.empty((n, width), dtype=_U8, device=device)
    step = max(1, GRID_CELLS // max(width, 1))
    for lo in range(0, n, step):
        out[lo:lo + step] = render(lo, min(lo + step, n))
    return out


def _shiftright128(lo, hi, dist):
    """(hi:lo) >>> dist per lane, 0 < dist < 64 (a shift of 64 or more, or a
    negative one, contributes 0 as in XLA)."""
    return shl(hi, 64 - dist) | shr(lo, dist)


def _mul_shift64(m, mul_lo, mul_hi, j):
    """Ryu mulShift64 (ftos_converter.cuh:375): ((m * mul) >> j), low 64."""
    hi1, lo1 = umul128(m, mul_hi)
    hi0, _ = umul128(m, mul_lo)
    s = hi0 + lo1
    hi1 = hi1 + ult(s, hi0).to(_I64)  # carry
    return _shiftright128(s, hi1, j - 64)


def _pow5bits(e):
    return ((e * 1217359) >> 19) + 1


def _log10_pow2(e):
    return (e * 78913) >> 18


def _log10_pow5(e):
    return (e * 732923) >> 20


def _multiple_of_pow5(value, q):
    """value % 5^q == 0 for q in [0, 23] lanes (exact u64 modulo)."""
    pow5 = _table("pow5", value.device)[torch.clamp(q, 0, 23)]
    return divmod_tensor(value, pow5)[1] == 0


def _multiple_of_pow2(value, q):
    mask = shl(torch.ones_like(value), torch.clamp(q, 0, 63)) - 1
    return (value & mask) == 0


def _decimal_length_u64(v, max_digits):
    """number of decimal digits of u64 ``v`` (>= 1), int32."""
    n = torch.ones(v.shape, dtype=_I32, device=v.device)
    for k in range(1, max_digits):
        n = n + uge(v, s64(10**k)).to(_I32)
    return n


def _div10(x):
    return divmod_const(x, 10)


# twin: f2s_d2d
def _d2d(bits):
    """Vectorized Ryu d2d (ftos_converter.cuh:480): bit patterns ->
    (mantissa u64, exponent int32) of the shortest decimal."""
    u = bits.to(_I64)
    ieee_mantissa = u & ((1 << 52) - 1)
    ieee_exponent = (shr(u, 52) & 0x7FF).to(_I32)

    denormal = ieee_exponent == 0
    e2 = torch.where(denormal, 1 - 1023 - 52 - 2, ieee_exponent - (1023 + 52 + 2)).to(_I32)
    m2 = torch.where(denormal, ieee_mantissa, ieee_mantissa | (1 << 52))
    accept_bounds = (m2 & 1) == 0

    mv = 4 * m2  # < 2**55: signed ops on mv are exact
    mm_shift = ((ieee_mantissa != 0) | (ieee_exponent <= 1)).to(_I64)
    mm = mv - 1 - mm_shift  # wraps to u64 2**64 - 1 or - 2 at zero

    # --- branch A: e2 >= 0 (inverse powers of 5) ---
    qa = torch.clamp(_log10_pow2(e2) - (e2 > 3).to(_I32), min=0)
    ka = rt.DOUBLE_POW5_INV_BITCOUNT + _pow5bits(qa) - 1
    ja = (-e2 + qa + ka).to(_I64)
    qa_c = torch.clamp(qa, 0, len(rt.DOUBLE_POW5_INV_SPLIT_LO) - 1)
    inv_lo = _table("DOUBLE_POW5_INV_SPLIT_LO", u.device)[qa_c]
    inv_hi = _table("DOUBLE_POW5_INV_SPLIT_HI", u.device)[qa_c]
    vr_a = _mul_shift64(mv, inv_lo, inv_hi, ja)
    vp_a = _mul_shift64(mv + 2, inv_lo, inv_hi, ja)
    vm_a = _mul_shift64(mm, inv_lo, inv_hi, ja)
    guard_a = qa <= 21
    mv_mod5 = torch.remainder(mv, 5) == 0
    vr_tz_a = guard_a & mv_mod5 & _multiple_of_pow5(mv, qa)
    vm_tz_a = guard_a & ~mv_mod5 & accept_bounds & _multiple_of_pow5(mm, qa)
    vp_a = vp_a - (guard_a & ~mv_mod5 & ~accept_bounds
                   & _multiple_of_pow5(mv + 2, qa)).to(_I64)

    # --- branch B: e2 < 0 (powers of 5) ---
    neg_e2 = -e2
    qb = torch.clamp(_log10_pow5(neg_e2) - (neg_e2 > 1).to(_I32), min=0)
    ib = neg_e2 - qb
    kb = _pow5bits(ib) - rt.DOUBLE_POW5_BITCOUNT
    jb = (qb - kb).to(_I64)
    ib_c = torch.clamp(ib, 0, len(rt.DOUBLE_POW5_SPLIT_LO) - 1)
    pw_lo = _table("DOUBLE_POW5_SPLIT_LO", u.device)[ib_c]
    pw_hi = _table("DOUBLE_POW5_SPLIT_HI", u.device)[ib_c]
    vr_b = _mul_shift64(mv, pw_lo, pw_hi, jb)
    vp_b = _mul_shift64(mv + 2, pw_lo, pw_hi, jb)
    vm_b = _mul_shift64(mm, pw_lo, pw_hi, jb)
    e10_b = qb + e2
    q_le1 = qb <= 1
    vr_tz_b = q_le1 | ((qb < 63) & _multiple_of_pow2(mv, qb))
    vm_tz_b = q_le1 & (mm_shift == 1)
    vp_b = vp_b - (q_le1 & ~accept_bounds).to(_I64)

    pos = e2 >= 0
    return _shortest_loop(
        torch.where(pos, vr_a, vr_b), torch.where(pos, vp_a, vp_b),
        torch.where(pos, vm_a, vm_b), torch.where(pos, qa, e10_b).to(_I32),
        torch.where(pos, vm_tz_a, vm_tz_b), torch.where(pos, vr_tz_a, vr_tz_b),
        accept_bounds, 22)


def _mul_shift32(m, factor, shift):
    """Ryu mulShift32 (ftos_converter.cuh:242) in u64 lanes; shift > 32."""
    bits0 = m * (factor & M32)
    bits1 = m * shr(factor, 32)
    return shr(shr(bits0, 32) + bits1, shift.to(_I64) - 32)


# twin: f2s_f2d
def _f2d(bits):
    """Vectorized Ryu f2d (ftos_converter.cuh:575) in u64 lanes."""
    u = bits.to(_I64) & M32
    ieee_mantissa = u & ((1 << 23) - 1)
    ieee_exponent = (shr(u, 23) & 0xFF).to(_I32)

    denormal = ieee_exponent == 0
    e2 = torch.where(denormal, 1 - 127 - 23 - 2, ieee_exponent - (127 + 23 + 2)).to(_I32)
    m2 = torch.where(denormal, ieee_mantissa, ieee_mantissa | (1 << 23))
    accept_bounds = (m2 & 1) == 0

    mv = 4 * m2
    mp = mv + 2
    mm_shift = ((ieee_mantissa != 0) | (ieee_exponent <= 1)).to(_I64)
    mm = mv - 1 - mm_shift

    inv_tab = _table("FLOAT_POW5_INV_SPLIT", u.device)
    pow_tab = _table("FLOAT_POW5_SPLIT", u.device)

    def mul_pow5_inv_div_pow2(m, q, j):
        return _mul_shift32(m, inv_tab[torch.clamp(q, 0, len(rt.FLOAT_POW5_INV_SPLIT) - 1)], j)

    def mul_pow5_div_pow2(m, i, j):
        return _mul_shift32(m, pow_tab[torch.clamp(i, 0, len(rt.FLOAT_POW5_SPLIT) - 1)], j)

    def last_removed(vp, vm, q, value):
        # (vp - 1) // 10 <= vm // 10, unsigned: vp - 1 wraps at vp == 0
        keep = (q != 0) & ule(_div10(vp - 1)[0], _div10(vm)[0])
        return torch.where(keep, _div10(value)[1], 0)

    # branch A: e2 >= 0
    qa = torch.clamp(_log10_pow2(e2), min=0)
    ka = rt.FLOAT_POW5_INV_BITCOUNT + _pow5bits(qa) - 1
    ja = -e2 + qa + ka
    vr_a = mul_pow5_inv_div_pow2(mv, qa, ja)
    vp_a = mul_pow5_inv_div_pow2(mp, qa, ja)
    vm_a = mul_pow5_inv_div_pow2(mm, qa, ja)
    la = rt.FLOAT_POW5_INV_BITCOUNT + _pow5bits(torch.clamp(qa - 1, min=0)) - 1
    lrd_a = last_removed(vp_a, vm_a, qa, mul_pow5_inv_div_pow2(
        mv, torch.clamp(qa - 1, min=0), -e2 + qa - 1 + la))
    guard_a = qa <= 9
    mv_mod5 = torch.remainder(mv, 5) == 0
    vr_tz_a = guard_a & mv_mod5 & _multiple_of_pow5(mv, qa)
    vm_tz_a = guard_a & ~mv_mod5 & accept_bounds & _multiple_of_pow5(mm, qa)
    vp_a = vp_a - (guard_a & ~mv_mod5 & ~accept_bounds & _multiple_of_pow5(mp, qa)).to(_I64)

    # branch B: e2 < 0
    neg_e2 = -e2
    qb = torch.clamp(_log10_pow5(neg_e2), min=0)
    ib = neg_e2 - qb
    kb = _pow5bits(ib) - rt.FLOAT_POW5_BITCOUNT
    jb = qb - kb
    vr_b = mul_pow5_div_pow2(mv, ib, jb)
    vp_b = mul_pow5_div_pow2(mp, ib, jb)
    vm_b = mul_pow5_div_pow2(mm, ib, jb)
    e10_b = qb + e2
    jb2 = qb - 1 - (_pow5bits(ib + 1) - rt.FLOAT_POW5_BITCOUNT)
    lrd_b = last_removed(vp_b, vm_b, qb, mul_pow5_div_pow2(mv, ib + 1, jb2))
    q_le1 = qb <= 1
    vr_tz_b = q_le1 | ((qb < 31) & _multiple_of_pow2(mv, torch.clamp(qb - 1, min=0)))
    vm_tz_b = q_le1 & (mm_shift == 1)
    vp_b = vp_b - (q_le1 & ~accept_bounds).to(_I64)

    pos = e2 >= 0
    return _shortest_loop(
        torch.where(pos, vr_a, vr_b), torch.where(pos, vp_a, vp_b),
        torch.where(pos, vm_a, vm_b), torch.where(pos, qa, e10_b).to(_I32),
        torch.where(pos, vm_tz_a, vm_tz_b), torch.where(pos, vr_tz_a, vr_tz_b),
        accept_bounds, 11, last_removed=torch.where(pos, lrd_a, lrd_b))


# twin: f2s_shortest
def _shortest_loop(vr, vp, vm, e10, vm_tz, vr_tz, accept_bounds, max_iter,
                   last_removed=None):
    """Ryu step 4 (ftos_converter.cuh:570-650): masked digit removal.

    The reference's div100 fast path is an optimization of the same
    recurrence; the general loop with correctly initialized flags gives
    identical output.  A lane that fails a loop's condition never meets it
    again (only active lanes change), so each loop stops at the first step
    with no active lane: one scalar sync per step instead of the JAX
    package's full ``max_iter`` unroll, and the same bits.
    """
    removed = torch.zeros(vr.shape, dtype=_I32, device=vr.device)
    lrd = torch.zeros_like(vr) if last_removed is None else last_removed

    for _ in range(max_iter):
        vr_q, vr_r = _div10(vr)
        vp_q, _ = _div10(vp)
        vm_q, vm_r = _div10(vm)
        act = ugt(vp_q, vm_q)
        if not bool(act.any()):
            break
        vm_tz = torch.where(act, vm_tz & (vm_r == 0), vm_tz)
        vr_tz = torch.where(act, vr_tz & (lrd == 0), vr_tz)
        lrd = torch.where(act, vr_r, lrd)
        vr = torch.where(act, vr_q, vr)
        vp = torch.where(act, vp_q, vp)
        vm = torch.where(act, vm_q, vm)
        removed = removed + act.to(_I32)

    for _ in range(max_iter):
        vr_q, vr_r = _div10(vr)
        vm_q, vm_r = _div10(vm)
        act = vm_tz & (vm_r == 0)
        if not bool(act.any()):
            break
        vr_tz = torch.where(act, vr_tz & (lrd == 0), vr_tz)
        lrd = torch.where(act, vr_r, lrd)
        vr = torch.where(act, vr_q, vr)
        vp = torch.where(act, _div10(vp)[0], vp)
        vm = torch.where(act, vm_q, vm)
        removed = removed + act.to(_I32)

    lrd = torch.where(vr_tz & (lrd == 5) & ((vr & 1) == 0), 4, lrd)
    round_up = ((vr == vm) & (~accept_bounds | ~vm_tz)) | (lrd >= 5)
    return vr + round_up.to(_I64), e10 + removed


def _layout(output, exp10, negative, is_float):
    """The Java layout of each row (d2s_size, ftos_converter.cuh:877-906):
    (olength, exp, s, neg_e, eabs, elen, sci, lens)."""
    olength = _decimal_length_u64(output, 9 if is_float else 17)
    exp = exp10 + olength - 1
    sci = (exp < -3) | (exp >= 7)
    s = negative.to(_I32)
    neg_e = exp < 0
    eabs = torch.abs(exp)
    elen = 1 + (eabs >= 10).to(_I32) + (eabs >= 100).to(_I32)
    len_sci = s + olength + 1 + (olength == 1).to(_I32) + 1 + neg_e.to(_I32) + elen
    len_pn = s + 1 - exp + olength
    len_pb = s + exp + 3
    len_pm = s + olength + 1
    lens = torch.where(sci, len_sci, torch.where(exp < 0, len_pn, torch.where(
        exp + 1 >= olength, len_pb, len_pm)))
    return olength, exp, s, neg_e, eabs, elen, sci, lens


def _exp_digit(eabs, elen, j):
    """Exponent digit j (MSB first) of the elen-digit ``eabs``, ASCII."""
    p10 = torch.where(elen - 1 - j >= 2, 100, torch.where(elen - 1 - j >= 1, 10, 1))
    return (torch.remainder(eabs // p10, 10) + ord("0")).to(_U8)


def _with_specials(out, lens, special_id):
    normal = special_id < 0
    sid = torch.clamp(special_id, 0, 4).to(_I64)
    out = torch.where(normal[:, None], out, _table("special", out.device)[sid])
    lens = torch.where(normal, lens, _table("special_len", out.device)[sid])
    return out, lens.to(_I32)


def _emit(output, exp10, negative, special_id, is_float):
    """Scatter the decimal into a padded byte matrix per Java formatting
    (to_chars, ftos_converter.cuh:797-893), one masked write per position
    and layout: the parity oracle the fast paths are held against."""
    n = output.shape[0]
    max_digits = 9 if is_float else 17
    olength, exp, s, neg_e, eabs, elen, sci, lens = _layout(output, exp10, negative, is_float)
    out = torch.zeros((n, MAX_D2S_LEN + 1), dtype=_U8, device=output.device)
    normal = special_id < 0

    def put(pos, ch, mask):
        p = torch.where(mask, pos, MAX_D2S_LEN).to(_I64)  # the last column is dropped
        src = ch if isinstance(ch, torch.Tensor) else torch.full((n,), ch, dtype=_U8,
                                                                  device=output.device)
        out.scatter_(1, p[:, None], src.to(_U8)[:, None])

    put(torch.zeros_like(s), ord("-"), normal & negative)

    # digits (MSB-first digit k)
    plain_neg = normal & ~sci & (exp < 0)
    plain_big = normal & ~sci & (exp >= 0) & (exp + 1 >= olength)
    plain_mid = normal & ~sci & (exp >= 0) & (exp + 1 < olength)
    sci_m = normal & sci
    out_tab = digit_table_u64(output, max_digits)
    for k in range(max_digits):
        have = olength > k
        digit = digit_from_table(out_tab, olength - 1 - k)
        put(s + k + (1 if k > 0 else 0), digit, sci_m & have)
        put(s + 2 + (-exp - 1) + k, digit, plain_neg & have)
        put(s + k, digit, plain_big & have)
        put(s + k + (exp < k).to(_I32), digit, plain_mid & have)

    # scientific: '.', pad '0' when olength == 1, 'E', exponent sign + digits
    put(s + 1, ord("."), sci_m)
    put(s + 2, ord("0"), sci_m & (olength == 1))
    p_e = s + olength + 1 + (olength == 1).to(_I32)
    put(p_e, ord("E"), sci_m)
    put(p_e + 1, ord("-"), sci_m & neg_e)
    pe0 = p_e + 1 + neg_e.to(_I32)
    for j in range(3):
        put(pe0 + j, _exp_digit(eabs, elen, j), sci_m & (elen > j))

    # plain, exp < 0: "0." + (-exp-1) zeros + digits
    put(s, ord("0"), plain_neg)
    put(s + 1, ord("."), plain_neg)
    for t in range(2):  # exp >= -3: at most 2 leading zeros
        put(s + 2 + t, ord("0"), plain_neg & (-exp - 1 > t))
    # plain, exp + 1 >= olength: digits + zeros + ".0"
    for t in range(7):  # exp < 7: at most 7 trailing zeros
        put(s + olength + t, ord("0"), plain_big & (exp + 1 - olength > t))
    put(s + exp + 1, ord("."), plain_big)
    put(s + exp + 2, ord("0"), plain_big)
    # plain, dot between the digits
    put(s + exp + 1, ord("."), plain_mid)
    return _with_specials(out[:, :MAX_D2S_LEN], lens, special_id)


def _special_table():
    """(chars[5, MAX_D2S_LEN] u8, lens[5] i32) of the special strings."""
    specials = ["0.0", "-0.0", "Infinity", "-Infinity", "NaN"]
    tab = np.zeros((5, MAX_D2S_LEN), np.uint8)
    slen = np.zeros(5, np.int32)
    for i, sp in enumerate(specials):
        b = sp.encode()
        tab[i, : len(b)] = np.frombuffer(b, np.uint8)
        slen[i] = len(b)
    return tab, slen


def _classify_np(bits: np.ndarray, special_id: np.ndarray,
                 is_float: bool) -> np.ndarray:
    """[n] int8 value classes from the host bit patterns.

    "simple" = an exact integer v in [1, 1e7): unbiased exponent E in
    [0, mbits] with all fractional mantissa bits zero and the shifted
    value under 10^7 (E <= mbits keeps the shift non-negative; any
    integer < 10^7 satisfies it since 10^7 < 2^24).  The Ryu interval
    around such a v is far narrower than 1 (ulp/2 <= 0.5 even at the
    float32 worst case), so the shortest round-trip decimal is v itself
    with trailing zeros stripped — proven bit-identical to the full-Ryu
    oracle by the fuzz corpora."""
    mbits = 23 if is_float else 52
    bias = 127 if is_float else 1023
    emask = 0xFF if is_float else 0x7FF
    mant = bits & np.uint64((1 << mbits) - 1)
    expo = ((bits >> np.uint64(mbits)) & np.uint64(emask)).astype(np.int32)
    E = expo - bias
    m2 = mant | np.uint64(1 << mbits)
    frac_bits = np.clip(mbits - E, 0, 63).astype(np.uint64)
    frac_mask = (np.uint64(1) << frac_bits) - np.uint64(1)
    v = m2 >> frac_bits
    simple = (
        (expo != 0)
        & (E >= 0)
        & (E <= mbits)
        & ((m2 & frac_mask) == 0)
        & (v < np.uint64(10**7))
    )
    return np.where(
        special_id >= 0, CLS_SPECIAL, np.where(simple, CLS_SIMPLE, CLS_RYU)
    ).astype(np.int8)




# twin: f2s_simple
def _simple_digits(bits, is_float):
    """Shortest digits of a 'simple' value, an exact integer v in [1, 1e7):
    strip trailing zeros (<= 6 for v < 10^7), no shortest search needed
    (see _classify_np for the interval argument).  v < 2**53, so torch's
    signed division is exact here."""
    mbits = 23 if is_float else 52
    bias = 127 if is_float else 1023
    emask = 0xFF if is_float else 0x7FF
    u = bits.to(_I64)
    mant = u & ((1 << mbits) - 1)
    expo = (shr(u, mbits) & emask).to(_I32)
    m2 = mant | (1 << mbits)
    v = shr(m2, torch.clamp(mbits - (expo - bias), 0, 63).to(_I64))
    e10 = torch.zeros(v.shape, dtype=_I32, device=v.device)
    for _ in range(6):
        strip = (v > 9) & (torch.remainder(v, 10) == 0)
        v = torch.where(strip, v // 10, v)
        e10 = e10 + strip.to(_I32)
    return v, e10


# twin: f2s_emit
def _emit_fast(output, exp10, negative, special_id, is_float):
    """Strength-reduced twin of the ``_emit`` oracle: one gather of the
    digits and two grouped scatters replace ~85 per-position writes.  Layout
    classes, positions and length formulas mirror d2s_size
    (ftos_converter.cuh:877-906) byte for byte."""
    n = output.shape[0]
    dev = output.device
    max_digits = 9 if is_float else 17
    olength, exp, s, neg_e, eabs, elen, sci, lens = _layout(output, exp10, negative, is_float)
    normal = special_id < 0
    sci_m = normal & sci
    plain_neg = normal & ~sci & (exp < 0)
    plain_big = normal & ~sci & (exp >= 0) & (exp + 1 >= olength)
    plain_mid = normal & ~sci & (exp >= 0) & (exp + 1 < olength)

    # MSB-first digit characters: one gather from the divide-by-10 table
    # (digit k from the left sits at right-index olength-1-k)
    karr = torch.arange(max_digits, dtype=_I32, device=dev)[None, :]
    tab = digit_table_u64(output, max_digits)
    msb = torch.clamp(olength[:, None] - 1 - karr, 0, max_digits - 1).to(_I64)
    digits = torch.gather(tab, 1, msb) + ord("0")

    # per-layout digit positions, one [n, max_digits] matrix
    sC, expC = s[:, None], exp[:, None]
    dpos = torch.where(sci[:, None], sC + karr + (karr > 0).to(_I32), torch.where(
        plain_neg[:, None], sC + 2 + (-expC - 1) + karr, torch.where(
            plain_big[:, None], sC + karr, sC + karr + (karr > expC).to(_I32))))
    have = (karr < olength[:, None]) & normal[:, None]

    OOB = MAX_D2S_LEN  # one extra column takes the masked-out writes
    out = torch.zeros((n, MAX_D2S_LEN + 1), dtype=_U8, device=dev)
    out.scatter_(1, torch.where(have, dpos, OOB).to(_I64), digits)

    # the ~19 per-layout scalar characters, grouped into one scatter
    p_e = s + olength + 1 + (olength == 1).to(_I32)
    pe0 = p_e + 1 + neg_e.to(_I32)
    ps, cs = [], []

    def sput(pos, ch, mask):
        ps.append(torch.where(mask, pos, OOB))
        cs.append(ch if isinstance(ch, torch.Tensor) else torch.full((n,), ch, dtype=_U8,
                                                                     device=dev))

    sput(s * 0, ord("-"), normal & negative)
    sput(s + 1, ord("."), sci_m)
    sput(s + 2, ord("0"), sci_m & (olength == 1))
    sput(p_e, ord("E"), sci_m)
    sput(p_e + 1, ord("-"), sci_m & neg_e)
    for j in range(3):
        sput(pe0 + j, _exp_digit(eabs, elen, j), sci_m & (elen > j))
    sput(s, ord("0"), plain_neg)
    sput(s + 1, ord("."), plain_neg)
    for t in range(2):
        sput(s + 2 + t, ord("0"), plain_neg & (-exp - 1 > t))
    for t in range(7):
        sput(s + olength + t, ord("0"), plain_big & (exp + 1 - olength > t))
    sput(s + exp + 1, ord("."), plain_big)
    sput(s + exp + 2, ord("0"), plain_big)
    sput(s + exp + 1, ord("."), plain_mid)
    out.scatter_(1, torch.stack(ps, dim=1).to(_I64), torch.stack(cs, dim=1))
    return _with_specials(out[:, :MAX_D2S_LEN], lens, special_id)


# twin: f2s_simple
def _simple_digits_np(bits, is_float):
    """numpy twin of _simple_digits."""
    mbits = 23 if is_float else 52
    bias = 127 if is_float else 1023
    emask = 0xFF if is_float else 0x7FF
    u = bits.astype(np.uint64)
    mant = u & np.uint64((1 << mbits) - 1)
    expo = ((u >> np.uint64(mbits)) & np.uint64(emask)).astype(np.int32)
    E = expo - bias
    m2 = mant | np.uint64(1 << mbits)
    v = m2 >> np.clip(mbits - E, 0, 63).astype(np.uint64)
    e10 = np.zeros(v.shape, np.int32)
    for _ in range(6):
        strip = (v > np.uint64(9)) & (v % np.uint64(10) == 0)
        v = np.where(strip, v // np.uint64(10), v)
        e10 = e10 + strip.astype(np.int32)
    return v, e10



# twin: f2s_emit
def _emit_np(output, exp10, negative, special_id, is_float):
    """numpy twin of _emit_fast.

    The layout math (classes, exponent split, length formulas) is pinned
    line-for-line against the device twin; the character emission itself
    compacts rows per layout class and writes the digit run as contiguous
    column-slice copies (str(v) is left-aligned, so each layout is a few
    block moves plus a handful of masked scalar stores), where the
    lockstep device twin must scatter through position matrices."""
    n = output.shape[0]
    max_digits = 9 if is_float else 17
    olength = _decimal_length_np(output, max_digits)
    exp = exp10 + olength - 1
    sci = (exp < -3) | (exp >= 7)
    s = negative.astype(np.int32)
    normal = special_id < 0
    neg_e = exp < 0
    eabs = np.abs(exp)
    elen = 1 + (eabs >= 10).astype(np.int32) + (eabs >= 100).astype(np.int32)

    sci_m = normal & sci
    plain_neg = normal & ~sci & (exp < 0)
    plain_big = normal & ~sci & (exp >= 0) & (exp + 1 >= olength)
    plain_mid = normal & ~sci & (exp >= 0) & (exp + 1 < olength)

    # MSB-first digit codepoints, left-aligned: scale by 10^(max_digits -
    # olength) so the value is exactly max_digits wide (no overflow: output
    # has olength digits), then peel digits with divmod-by-10 over u32
    # halves — ~4x cheaper than per-row str() formatting (astype("U17")).
    # Columns past olength hold '0', not '\0'; every emit layout below
    # either overwrites them or leaves them past lens, and
    # _strings_from_padded_np extracts padded[j < lens] only.
    scaled = output.astype(np.uint64) * _POW10_NP[
        np.clip(max_digits - olength, 0, 19)]
    dcols = np.empty((max_digits, n), np.uint8)
    lo10 = (scaled % np.uint64(10**9)).astype(np.uint32)
    hi10 = (scaled // np.uint64(10**9)).astype(np.uint32)
    for j in range(min(9, max_digits)):
        lo10, r = np.divmod(lo10, np.uint32(10))
        dcols[max_digits - 1 - j] = r
    for j in range(max_digits - 9):
        hi10, r = np.divmod(hi10, np.uint32(10))
        dcols[max_digits - 10 - j] = r
    digits32 = dcols.T + np.uint8(ord("0"))

    p_e = s + olength + 1 + (olength == 1).astype(np.int32)
    pe0 = p_e + 1 + neg_e.astype(np.int32)
    p10 = np.array([1, 10, 100], np.int32)

    out = np.zeros((n, MAX_D2S_LEN), np.uint8)
    flat = out.reshape(-1)
    rowoff = np.arange(n, dtype=np.int64) * MAX_D2S_LEN
    DOT = np.uint8(ord("."))
    ZERO = np.uint8(ord("0"))

    ridx = np.nonzero(normal & negative)[0]
    if ridx.size:
        flat[rowoff[ridx]] = np.uint8(ord("-"))

    if sci_m.any():
        # d0 '.' d1..d_{ol-1} 'E' [-] exp -- digit run at fixed columns per
        # sign; trailing '\0's land past the E block and under lens
        for sgn in (0, 1):
            ridx = np.nonzero(sci_m & (s == sgn))[0]
            if not ridx.size:
                continue
            dsub = digits32[ridx]
            out[ridx, sgn] = dsub[:, 0]
            out[ridx, sgn + 1] = DOT
            out[ridx, sgn + 2:sgn + 1 + max_digits] = dsub[:, 1:]
        ridx = np.nonzero(sci_m)[0]
        base = rowoff[ridx]
        pad = ridx[olength[ridx] == 1]
        flat[rowoff[pad] + s[pad] + 2] = ZERO
        flat[base + p_e[ridx]] = np.uint8(ord("E"))
        rneg = ridx[neg_e[ridx]]
        flat[rowoff[rneg] + p_e[rneg] + 1] = np.uint8(ord("-"))
        eb = eabs[ridx]
        el = elen[ridx]
        p0 = pe0[ridx] + base
        for j in range(3):
            rj = np.nonzero(el > j)[0]
            if rj.size:
                edc = (
                    (eb[rj] // p10[np.clip(el[rj] - 1 - j, 0, 2)]) % 10
                ).astype(np.uint8) + ZERO
                flat[p0[rj] + j] = edc

    if plain_big.any():
        # digits, pad zeros to the ones place, then ".0"
        for sgn in (0, 1):
            ridx = np.nonzero(plain_big & (s == sgn))[0]
            if ridx.size:
                out[ridx, sgn:sgn + max_digits] = digits32[ridx]
        ridx = np.nonzero(plain_big)[0]
        base = rowoff[ridx]
        nz = exp[ridx] + 1 - olength[ridx]
        for t in range(7):  # exp < 7 -> at most 7 trailing zeros
            rz = np.nonzero(nz > t)[0]
            if rz.size:
                flat[base[rz] + s[ridx[rz]] + olength[ridx[rz]] + t] = ZERO
        flat[base + s[ridx] + exp[ridx] + 1] = DOT
        flat[base + s[ridx] + exp[ridx] + 2] = ZERO

    if plain_mid.any():
        # dot inside the digit run: exp in [0, 7), so two block moves per
        # (sign, exp) group
        for sgn in (0, 1):
            for e in range(7):
                ridx = np.nonzero(plain_mid & (s == sgn) & (exp == e))[0]
                if not ridx.size:
                    continue
                dsub = digits32[ridx]
                out[ridx, sgn:sgn + e + 1] = dsub[:, : e + 1]
                out[ridx, sgn + e + 1] = DOT
                out[ridx, sgn + e + 2:sgn + max_digits + 1] = dsub[:, e + 1:]

    if plain_neg.any():
        # "0." + up to 2 zeros + digits (exp in [-3, -1))
        for sgn in (0, 1):
            for e in (-1, -2, -3):
                ridx = np.nonzero(plain_neg & (s == sgn) & (exp == e))[0]
                if not ridx.size:
                    continue
                out[ridx, sgn] = ZERO
                out[ridx, sgn + 1] = DOT
                for t in range(-e - 1):
                    out[ridx, sgn + 2 + t] = ZERO
                z0 = sgn + 1 - e
                out[ridx, z0:z0 + max_digits] = digits32[ridx]

    len_sci = s + olength + 1 + (olength == 1).astype(np.int32) + 1 + neg_e.astype(np.int32) + elen
    len_pn = s + 1 - exp + olength
    len_pb = s + exp + 3
    len_pm = s + olength + 1
    lens = np.where(
        sci, len_sci, np.where(exp < 0, len_pn, np.where(exp + 1 >= olength, len_pb, len_pm))
    )

    tab_sp, slen_sp = _special_table()
    sid = np.clip(special_id, 0, 4)
    if not normal.all():
        out = np.where(normal[:, None], out, tab_sp[sid])
    lens = np.where(normal, lens, slen_sp[sid])
    return out, lens



# --------------------------------------------------------------------------
# numpy host Ryu twins (branch + active-set compaction the lockstep
# compiled path cannot do; helpers mirror the device ones 1:1)
# --------------------------------------------------------------------------


def _umul128_np(a, b):
    a_lo, a_hi = a & np.uint64(0xFFFFFFFF), a >> np.uint64(32)
    b_lo, b_hi = b & np.uint64(0xFFFFFFFF), b >> np.uint64(32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> np.uint64(32)) + (lh & np.uint64(0xFFFFFFFF)) + (
        hl & np.uint64(0xFFFFFFFF))
    lo = (ll & np.uint64(0xFFFFFFFF)) | (
        (mid & np.uint64(0xFFFFFFFF)) << np.uint64(32))
    hi = hh + (lh >> np.uint64(32)) + (hl >> np.uint64(32)) + (
        mid >> np.uint64(32))
    return hi, lo


def _shiftright128_np(lo, hi, dist):
    dist = dist.astype(np.uint64)
    return (hi << (np.uint64(64) - dist)) | (lo >> dist)


def _shiftright128_safe_np(lo, hi, dist):
    """_shiftright128_np that also tolerates dist == 0 lanes (the halved-
    product shift in _mul_shift_all64_np can hit it)."""
    dist = dist.astype(np.uint64)
    lsh = np.where(dist == 0, np.uint64(1), np.uint64(64) - dist)
    return np.where(dist == 0, lo, (hi << lsh) | (lo >> dist))


def _mul_shift_all64_np(mv, mul_lo, mul_hi, j, mm_shift):
    """Upstream Ryu's mulShiftAll64: two umul128s instead of six.

    One exact 192-bit product of m = 2*m2 (mv/2) with the 128-bit pow5
    factor; the (mv, mv+2, mv-1-mmShift) products differ from it by
    +-factor, so they're derived additively and shifted by j-65 (the
    halving).  mmShift == 0 lanes (whole powers of two, rare) need the
    odd mv-1 multiplier: doubled product minus factor at shift j-64.
    Exact integer arithmetic throughout — bit-identical to three
    independent _mul_shift64_np calls."""
    m = mv >> np.uint64(1)  # 2*m2; mv = 4*m2 is always even
    hi0, lo = _umul128_np(m, mul_lo)
    hi1, lo1 = _umul128_np(m, mul_hi)
    mid = hi0 + lo1
    hi = hi1 + (mid < hi0).astype(np.uint64)  # carry
    d1 = j - 65
    vr = _shiftright128_safe_np(mid, hi, d1)
    lo2 = lo + mul_lo
    mid2 = mid + mul_hi + (lo2 < lo).astype(np.uint64)
    hi2 = hi + (mid2 < mid).astype(np.uint64)
    vp = _shiftright128_safe_np(mid2, hi2, d1)
    lo3 = lo - mul_lo
    mid3 = mid - mul_hi - (lo3 > lo).astype(np.uint64)
    hi3 = hi - (mid3 > mid).astype(np.uint64)
    vm = _shiftright128_safe_np(mid3, hi3, d1)
    z = np.nonzero(mm_shift == 0)[0]
    if z.size:
        lo3b = lo[z] + lo[z]
        mid3b = mid[z] + mid[z] + (lo3b < lo[z]).astype(np.uint64)
        hi3b = hi[z] + hi[z] + (mid3b < mid[z]).astype(np.uint64)
        lo4 = lo3b - mul_lo[z]
        mid4 = mid3b - mul_hi[z] - (lo4 > lo3b).astype(np.uint64)
        hi4 = hi3b - (mid4 > mid3b).astype(np.uint64)
        vm[z] = _shiftright128_np(mid4, hi4, j[z] - 64)
    return vr, vp, vm


def _mul_shift64_np(m, mul_lo, mul_hi, j):
    hi1, lo1 = _umul128_np(m, mul_hi)
    hi0, _lo0 = _umul128_np(m, mul_lo)
    s = hi0 + lo1
    hi1 = hi1 + (s < hi0).astype(np.uint64)  # carry
    return _shiftright128_np(s, hi1, j - 64)


def _mul_shift32_np(m, factor, shift):
    factor_lo = factor & np.uint64(0xFFFFFFFF)
    factor_hi = factor >> np.uint64(32)
    bits0 = m * factor_lo
    bits1 = m * factor_hi
    s = (bits0 >> np.uint64(32)) + bits1
    return s >> (shift.astype(np.uint64) - np.uint64(32))


def _pow5bits_np(e):
    return ((e * np.int32(1217359)) >> 19) + np.int32(1)


def _log10_pow2_np(e):
    return (e * np.int32(78913)) >> 18


def _log10_pow5_np(e):
    return (e * np.int32(732923)) >> 20


def _multiple_of_pow5_np(value, q):
    return value % _POW5_NP[np.clip(q, 0, 23)] == 0


def _multiple_of_pow2_np(value, q):
    mask = (np.uint64(1) << np.clip(q, 0, 63).astype(np.uint64)) - np.uint64(1)
    return (value & mask) == 0


def _decimal_length_np(v, max_digits):
    n = np.ones(v.shape, np.int32)
    for k in range(1, max_digits):
        n = n + (v >= _POW10_NP[k]).astype(np.int32)
    return n


def _d2d_pos_np(e2, mv, mm_shift, accept_bounds):
    """Branch A of _d2d (e2 >= 0, inverse powers of 5), compacted rows."""
    qa = np.maximum(_log10_pow2_np(e2) - (e2 > 3).astype(np.int32), 0)
    ka = np.int32(rt.DOUBLE_POW5_INV_BITCOUNT) + _pow5bits_np(qa) - 1
    ja = -e2 + qa + ka
    qa_c = np.clip(qa, 0, len(rt.DOUBLE_POW5_INV_SPLIT_LO) - 1)
    inv_lo = rt.DOUBLE_POW5_INV_SPLIT_LO[qa_c]
    inv_hi = rt.DOUBLE_POW5_INV_SPLIT_HI[qa_c]
    vr, vp, vm = _mul_shift_all64_np(mv, inv_lo, inv_hi, ja, mm_shift)
    # trailing-zero flags only exist under the q <= 21 guard; the u64
    # pow5 modulos run on those survivor rows alone
    vr_tz = np.zeros(mv.shape, np.bool_)
    vm_tz = np.zeros(mv.shape, np.bool_)
    gi = np.nonzero(qa <= 21)[0]
    if gi.size:
        mv_g = mv[gi]
        q_g = qa[gi]
        mod5_g = mv_g % np.uint64(5) == 0
        ab_g = accept_bounds[gi]
        vr_tz[gi] = mod5_g & _multiple_of_pow5_np(mv_g, q_g)
        vm_tz[gi] = ~mod5_g & ab_g & _multiple_of_pow5_np(
            mv_g - np.uint64(1) - mm_shift[gi], q_g
        )
        vp[gi] -= (
            ~mod5_g & ~ab_g & _multiple_of_pow5_np(mv_g + np.uint64(2), q_g)
        ).astype(np.uint64)
    return vr, vp, vm, qa, vm_tz, vr_tz


def _d2d_neg_np(e2, mv, mm_shift, accept_bounds):
    """Branch B of _d2d (e2 < 0, powers of 5), compacted rows."""
    neg_e2 = -e2
    qb = np.maximum(_log10_pow5_np(neg_e2) - (neg_e2 > 1).astype(np.int32), 0)
    ib = neg_e2 - qb
    kb = _pow5bits_np(ib) - np.int32(rt.DOUBLE_POW5_BITCOUNT)
    jb = qb - kb
    ib_c = np.clip(ib, 0, len(rt.DOUBLE_POW5_SPLIT_LO) - 1)
    pw_lo = rt.DOUBLE_POW5_SPLIT_LO[ib_c]
    pw_hi = rt.DOUBLE_POW5_SPLIT_HI[ib_c]
    vr, vp, vm = _mul_shift_all64_np(mv, pw_lo, pw_hi, jb, mm_shift)
    e10 = qb + e2
    q_le1 = qb <= 1
    vr_tz = q_le1 | ((qb < 63) & _multiple_of_pow2_np(mv, qb))
    vm_tz = q_le1 & (mm_shift == 1)
    vp = vp - (q_le1 & ~accept_bounds).astype(np.uint64)
    return vr, vp, vm, e10, vm_tz, vr_tz


# twin: f2s_d2d
def _d2d_np(bits):
    """numpy twin of _d2d with branch compaction: each power-of-5 branch
    (and its 128-bit limb multiplies) runs only on its survivor rows."""
    u = bits.astype(np.uint64)
    ieee_mantissa = u & np.uint64((1 << 52) - 1)
    ieee_exponent = ((u >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int32)

    denormal = ieee_exponent == 0
    e2 = np.where(denormal, np.int32(1 - 1023 - 52 - 2), ieee_exponent - (1023 + 52 + 2))
    m2 = np.where(denormal, ieee_mantissa, ieee_mantissa | np.uint64(1 << 52))
    even = (m2 & np.uint64(1)) == 0
    accept_bounds = even

    mv = np.uint64(4) * m2
    mm_shift = ((ieee_mantissa != 0) | (ieee_exponent <= 1)).astype(np.uint64)

    pos = e2 >= 0
    n = u.shape[0]
    vr = np.zeros(n, np.uint64)
    vp = np.zeros(n, np.uint64)
    vm = np.zeros(n, np.uint64)
    e10 = np.zeros(n, np.int32)
    vm_tz = np.zeros(n, np.bool_)
    vr_tz = np.zeros(n, np.bool_)
    for sel, branch in ((pos, _d2d_pos_np), (~pos, _d2d_neg_np)):
        idx = np.nonzero(sel)[0]
        if idx.size:
            (vr[idx], vp[idx], vm[idx], e10[idx], vm_tz[idx],
             vr_tz[idx]) = branch(
                e2[idx], mv[idx], mm_shift[idx], accept_bounds[idx])
    return _shortest_loop_np(vr, vp, vm, e10, vm_tz, vr_tz, accept_bounds, 22)


def _f2d_mul_inv_np(m, q, j):
    factor = rt.FLOAT_POW5_INV_SPLIT[
        np.clip(q, 0, len(rt.FLOAT_POW5_INV_SPLIT) - 1)]
    return _mul_shift32_np(m, factor, j)


def _f2d_mul_pow_np(m, i, j):
    factor = rt.FLOAT_POW5_SPLIT[np.clip(i, 0, len(rt.FLOAT_POW5_SPLIT) - 1)]
    return _mul_shift32_np(m, factor, j)


def _f2d_pos_np(e2, mv, mp, mm, mm_shift, accept_bounds):
    """Branch A of _f2d (e2 >= 0), compacted rows."""
    qa = np.maximum(_log10_pow2_np(e2), 0)
    ka = np.int32(rt.FLOAT_POW5_INV_BITCOUNT) + _pow5bits_np(qa) - 1
    ja = -e2 + qa + ka
    vr = _f2d_mul_inv_np(mv, qa, ja)
    vp = _f2d_mul_inv_np(mp, qa, ja)
    vm = _f2d_mul_inv_np(mm, qa, ja)
    la = np.int32(rt.FLOAT_POW5_INV_BITCOUNT) + _pow5bits_np(
        np.maximum(qa - 1, 0)) - 1
    lrd = np.where(
        (qa != 0) & ((vp - np.uint64(1)) // np.uint64(10) <= vm // np.uint64(10)),
        _f2d_mul_inv_np(mv, np.maximum(qa - 1, 0), -e2 + qa - 1 + la)
        % np.uint64(10),
        np.uint64(0),
    )
    guard = qa <= 9
    mv_mod5 = mv % np.uint64(5) == 0
    vr_tz = guard & mv_mod5 & _multiple_of_pow5_np(mv, qa)
    vm_tz = guard & ~mv_mod5 & accept_bounds & _multiple_of_pow5_np(mm, qa)
    vp = vp - (
        guard & ~mv_mod5 & ~accept_bounds & _multiple_of_pow5_np(mp, qa)
    ).astype(np.uint64)
    return vr, vp, vm, qa, vm_tz, vr_tz, lrd


def _f2d_neg_np(e2, mv, mp, mm, mm_shift, accept_bounds):
    """Branch B of _f2d (e2 < 0), compacted rows."""
    neg_e2 = -e2
    qb = np.maximum(_log10_pow5_np(neg_e2), 0)
    ib = neg_e2 - qb
    kb = _pow5bits_np(ib) - np.int32(rt.FLOAT_POW5_BITCOUNT)
    jb = qb - kb
    vr = _f2d_mul_pow_np(mv, ib, jb)
    vp = _f2d_mul_pow_np(mp, ib, jb)
    vm = _f2d_mul_pow_np(mm, ib, jb)
    e10 = qb + e2
    jb2 = qb - 1 - (_pow5bits_np(ib + 1) - np.int32(rt.FLOAT_POW5_BITCOUNT))
    lrd = np.where(
        (qb != 0) & ((vp - np.uint64(1)) // np.uint64(10) <= vm // np.uint64(10)),
        _f2d_mul_pow_np(mv, ib + 1, jb2) % np.uint64(10),
        np.uint64(0),
    )
    q_le1 = qb <= 1
    vr_tz = q_le1 | ((qb < 31) & _multiple_of_pow2_np(mv, np.maximum(qb - 1, 0)))
    vm_tz = q_le1 & (mm_shift == 1)
    vp = vp - (q_le1 & ~accept_bounds).astype(np.uint64)
    return vr, vp, vm, e10, vm_tz, vr_tz, lrd


# twin: f2s_f2d
def _f2d_np(bits):
    """numpy twin of _f2d with branch compaction."""
    u = bits.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    ieee_mantissa = u & np.uint64((1 << 23) - 1)
    ieee_exponent = ((u >> np.uint64(23)) & np.uint64(0xFF)).astype(np.int32)

    denormal = ieee_exponent == 0
    e2 = np.where(denormal, np.int32(1 - 127 - 23 - 2), ieee_exponent - (127 + 23 + 2))
    m2 = np.where(denormal, ieee_mantissa, ieee_mantissa | np.uint64(1 << 23))
    even = (m2 & np.uint64(1)) == 0
    accept_bounds = even

    mv = np.uint64(4) * m2
    mp = mv + np.uint64(2)
    mm_shift = ((ieee_mantissa != 0) | (ieee_exponent <= 1)).astype(np.uint64)
    mm = mv - np.uint64(1) - mm_shift

    pos = e2 >= 0
    n = u.shape[0]
    vr = np.zeros(n, np.uint64)
    vp = np.zeros(n, np.uint64)
    vm = np.zeros(n, np.uint64)
    e10 = np.zeros(n, np.int32)
    vm_tz = np.zeros(n, np.bool_)
    vr_tz = np.zeros(n, np.bool_)
    lrd = np.zeros(n, np.uint64)
    for sel, branch in ((pos, _f2d_pos_np), (~pos, _f2d_neg_np)):
        idx = np.nonzero(sel)[0]
        if idx.size:
            (vr[idx], vp[idx], vm[idx], e10[idx], vm_tz[idx], vr_tz[idx],
             lrd[idx]) = branch(
                e2[idx], mv[idx], mp[idx], mm[idx], mm_shift[idx],
                accept_bounds[idx])
    return _shortest_loop_np(
        vr, vp, vm, e10, vm_tz, vr_tz, accept_bounds, 11, last_removed=lrd
    )


# twin: f2s_shortest
def _shortest_loop_np(vr, vp, vm, e10, vm_tz, vr_tz, accept_bounds, max_iter,
                      last_removed=None):
    """numpy twin of _shortest_loop with active-set compaction.

    A lane that fails the removal condition once never re-enters it (the
    divisions only apply to active lanes), so the survivor index set only
    shrinks — the compacted while-loop visits exactly the lanes the
    device's masked unroll would modify, in the same order."""
    vr, vp, vm = vr.copy(), vp.copy(), vm.copy()
    vm_tz, vr_tz = vm_tz.copy(), vr_tz.copy()
    removed = np.zeros(vr.shape, np.int32)
    lrd = np.zeros(vr.shape, np.uint64) if last_removed is None else last_removed.copy()

    ai = np.nonzero(vp // np.uint64(10) > vm // np.uint64(10))[0]
    it = 0
    while ai.size and it < max_iter:
        it += 1
        vm_tz[ai] &= vm[ai] % np.uint64(10) == 0
        vr_tz[ai] &= lrd[ai] == 0
        lrd[ai] = vr[ai] % np.uint64(10)
        vr[ai] //= np.uint64(10)
        vp[ai] //= np.uint64(10)
        vm[ai] //= np.uint64(10)
        removed[ai] += 1
        ai = ai[vp[ai] // np.uint64(10) > vm[ai] // np.uint64(10)]

    ai = np.nonzero(vm_tz & (vm % np.uint64(10) == 0))[0]
    it = 0
    while ai.size and it < max_iter:
        it += 1
        vr_tz[ai] &= lrd[ai] == 0
        lrd[ai] = vr[ai] % np.uint64(10)
        vr[ai] //= np.uint64(10)
        vp[ai] //= np.uint64(10)
        vm[ai] //= np.uint64(10)
        removed[ai] += 1
        ai = ai[vm[ai] % np.uint64(10) == 0]

    lrd = np.where(vr_tz & (lrd == 5) & (vr % np.uint64(2) == 0), np.uint64(4), lrd)
    round_up = ((vr == vm) & (~accept_bounds | ~vm_tz)) | (lrd >= 5)
    output = vr + round_up.astype(np.uint64)
    return output, e10 + removed


# --------------------------------------------------------------------------
# renderers + dispatch
# --------------------------------------------------------------------------


# twin: f2s_render
def _render_device(bits, negative, special_id, cls, is_float):
    """Lane value-class renderer: per-class compacted work scattered back
    through columnar/buckets.map_classes."""

    def kernel(cid, b_bits, b_neg, b_sid):
        with PHASES.phase("ryu"):
            if cid == CLS_SIMPLE:
                output, e10 = _simple_digits(b_bits, is_float)
            elif cid == CLS_RYU:
                output, e10 = (_f2d if is_float else _d2d)(b_bits)
            else:  # specials never reach the digit path; emit masks them
                output, e10 = b_bits, b_sid * 0
        with PHASES.phase("emit"):
            return _emit_fast(output, e10, b_neg, b_sid, is_float)

    return map_classes(cls, 3, kernel, [((MAX_D2S_LEN,), _U8), ((), _I32)],
                       row_args=[bits, negative, special_id])


# twin: f2s_render
def _render_host(bits, negative, special_id, cls, is_float):
    """numpy twin of _render_device."""
    n = bits.shape[0]
    padded = np.zeros((n, MAX_D2S_LEN), np.uint8)
    lens = np.zeros(n, np.int32)
    buckets = class_buckets(cls, 3)
    for cid, rows_np in buckets:
        whole = len(buckets) == 1 and rows_np.size == n
        if whole:
            b_bits, b_neg, b_sid = bits, negative, special_id
        else:
            b_bits = bits[rows_np]
            b_neg = negative[rows_np]
            b_sid = special_id[rows_np]
        with PHASES.phase("ryu"):
            if cid == CLS_SIMPLE:
                output, e10 = _simple_digits_np(b_bits, is_float)
            elif cid == CLS_RYU:
                output, e10 = (_f2d_np if is_float else _d2d_np)(b_bits)
            else:
                output, e10 = b_bits, b_sid * 0
        with PHASES.phase("emit"):
            p, l = _emit_np(output, e10, b_neg, b_sid, is_float)
        if whole:
            return p, l
        padded[rows_np] = p
        lens[rows_np] = l
    return padded, lens


def _strings_from_padded_np(padded, lens, validity, device) -> StringColumn:
    """Host mirror of columnar.column.strings_from_padded, assembled in
    numpy and moved to ``device`` once: ``chars`` holds exactly the rows'
    bytes (row-major boolean extraction IS the concatenation of each row's
    first len bytes)."""
    lens = lens.astype(np.int32)
    offsets = np.concatenate([np.zeros(1, np.int32), np.cumsum(lens, dtype=np.int32)])
    mask = np.arange(padded.shape[1], dtype=np.int32)[None, :] < lens[:, None]
    return StringColumn(torch.from_numpy(padded[mask]).to(device),
                        torch.from_numpy(offsets).to(device), validity)


def _device_render_enabled(dev: torch.device) -> bool:
    """``float_device_render``: True/False pin an arm; ``"auto"`` takes the
    lane arm for a CUDA column and the numpy twin for a CPU one."""
    v = config.get("float_device_render")
    if v == "auto":
        return dev.type != "cpu"
    return bool(v)


def _special_id_expr(is_nan, is_inf, is_zero, negative):
    """0:"0.0" 1:"-0.0" 2:"Infinity" 3:"-Infinity" 4:"NaN"; -1 normal."""
    return torch.where(is_nan, 4, torch.where(
        is_inf, torch.where(negative, 3, 2),
        torch.where(is_zero, torch.where(negative, 1, 0), -1))).to(_I32)


def _float_to_string_device(col: Column) -> StringColumn:
    """Lane arm: the value-class bucketed path, or (``float_bucketed`` off)
    the monolithic whole-column oracle."""
    if col.dtype.kind == Kind.FLOAT64:
        bits = col.data.to(_I64)
        negative = bits < 0
        mant = bits & ((1 << 52) - 1)
        expo = shr(bits, 52) & 0x7FF
        is_nan = (expo == 0x7FF) & (mant != 0)
        is_inf = (expo == 0x7FF) & (mant == 0)
        is_zero = (expo == 0) & (mant == 0)
        is_float = False
    else:
        bits32 = f32_to_bits(col.data)
        bits = bits32.to(_I64) & M32
        negative = bits32 < 0
        mant = bits & ((1 << 23) - 1)
        expo = shr(bits, 23) & 0xFF
        is_nan = (expo == 0xFF) & (mant != 0)
        is_inf = (expo == 0xFF) & (mant == 0)
        is_zero = (expo == 0) & (mant == 0)
        is_float = True
    special_id = _special_id_expr(is_nan, is_inf, is_zero, negative)

    if not config.get("float_bucketed"):
        with PHASES.phase("ryu"):
            output, e10 = (_f2d if is_float else _d2d)(bits)
        with PHASES.phase("emit"):
            padded, lens = _emit(output, e10, negative, special_id, is_float)
            return strings_from_padded(padded, lens, col.validity)

    with PHASES.phase("bucket"):  # the classes are host metadata: one copy of the bits
        cls = _classify_np(bits.cpu().numpy().view(np.uint64), special_id.cpu().numpy(),
                           is_float)
    padded, lens = _render_device(bits, negative, special_id, cls, is_float)
    with PHASES.phase("emit"):
        return strings_from_padded(padded, lens, col.validity)


def _float_to_string_host(col: Column) -> StringColumn:
    """The numpy twin: classify and render in numpy, then move the column to
    the input's device."""
    is_float = col.dtype.kind == Kind.FLOAT32
    with PHASES.phase("bucket"):
        data = col.data.cpu().numpy()
        if is_float:
            bits32 = data.view(np.int32)
            bits = bits32.astype(np.uint64) & np.uint64(0xFFFFFFFF)
            negative = bits32 < 0
            mant = bits & np.uint64((1 << 23) - 1)
            expo = (bits >> np.uint64(23)) & np.uint64(0xFF)
            is_nan = (expo == 0xFF) & (mant != 0)
            is_inf = (expo == 0xFF) & (mant == 0)
            is_zero = (expo == 0) & (mant == 0)
        else:
            bits = data.view(np.uint64)  # int64 IEEE bit patterns
            negative = data < 0
            mant = bits & np.uint64((1 << 52) - 1)
            expo = (bits >> np.uint64(52)) & np.uint64(0x7FF)
            is_nan = (expo == 0x7FF) & (mant != 0)
            is_inf = (expo == 0x7FF) & (mant == 0)
            is_zero = (expo == 0) & (mant == 0)
        special_id = np.where(
            is_nan,
            np.int32(4),
            np.where(
                is_inf,
                np.where(negative, np.int32(3), np.int32(2)),
                np.where(
                    is_zero,
                    np.where(negative, np.int32(1), np.int32(0)),
                    np.int32(-1),
                ),
            ),
        )
        cls = _classify_np(bits, special_id, is_float)
    padded, lens = _render_host(bits, negative, special_id, cls, is_float)
    with PHASES.phase("emit"):
        return _strings_from_padded_np(padded, lens, col.validity, col.device)


def float_to_string(col: Column) -> StringColumn:
    """Shortest round-trip decimal string of a FLOAT32/FLOAT64 column
    (spark_rapids_jni::float_to_string); the arm follows
    ``float_device_render`` (module doc)."""
    if col.dtype.kind not in (Kind.FLOAT32, Kind.FLOAT64):
        raise TypeError("float_to_string requires FLOAT32 or FLOAT64")
    if _device_render_enabled(col.device):
        return _float_to_string_device(col)
    return _float_to_string_host(col)
