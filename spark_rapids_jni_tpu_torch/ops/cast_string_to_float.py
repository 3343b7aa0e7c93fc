"""Spark-exact string -> float32/float64 cast (PyTorch port of
``ops/cast_string_to_float.py``).

Behavioral parity with the reference's warp-per-row parser
(cast_string_to_float.cu:598 string_to_float_kernel; parse stages :86-557),
quirks included:

- 'nan' (any case) is valid only as the exact 3-char string; leading
  whitespace or a sign make it null (and an ANSI error) but it still parses
  as NaN (check_for_nan :243-260);
- 'inf'/'infinity' allow leading whitespace and a sign and must end the
  string; garbage after them is null WITHOUT an ANSI error (:276);
- at most 19 significant digits accumulate into a u64; beyond that digits
  truncate with the reference's exact (slightly lossy) exponent accounting
  (parse_digits :327-470, max_holding rule :395-445);
- manual exponents read at most 4 digits (parse_manual_exp :505);
- a single trailing f/F/d/D is allowed, except after a zero value, where
  only whitespace may follow (:134-145);
- the value is digits x 10^exp in IEEE binary64 (subnormal two-step
  :158-195), cast to float32 at the end for FLOAT32 outputs.

Two arms, picked by ``config.cast_device_parse``:

- the lane arm: a padded-rectangle sweep per length bucket (prefix masks
  replace the warp's ballots; ``_scan_padded``) and the final assembly in
  exact integer binary64 (``utils.softfloat``; ``_assemble_device``), eager
  torch on the column's device;
- the numpy twin: the bucketed host scan (``_scan_np``) and the hardware
  binary64 assembly (``_assemble``), copied from the JAX package.

``"auto"`` gives a CUDA column the lane arm and a CPU column the twin;
``True``/``False`` pin an arm, and the result is on the column's device
either way.  The only host decision of the lane arm is ANSI mode's error
check (one scalar sync; the row's bytes are read only on the throw path).

Known <= 1-ulp divergence from the reference: for negative powers (10^-k)
the table holds the correctly rounded binary64 value, while CUDA's exp10 is
occasionally 1 ulp off (seen at exp10(-291)); this shows only at extreme
exponents, where the reference already departs from Java's parse.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.columnar.buckets import length_buckets, map_buckets
from spark_rapids_jni_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType, FLOAT64, Kind
from spark_rapids_jni_tpu_torch.obs.phases import PhaseTimes
from spark_rapids_jni_tpu_torch.ops.cast_string import CastException, _first_true, _row_string
from spark_rapids_jni_tpu_torch.utils.floatbits import bits_to_f32
from spark_rapids_jni_tpu_torch.utils.softfloat import (
    f64_bits_to_f32_bits,
    f64_div_bits,
    f64_mul_bits,
    u64_to_f64_bits,
)
from spark_rapids_jni_tpu_torch.utils.u64 import s64, uge, ule

MAX_SAFE_DIGITS = 19
MAX_HOLDING = ((1 << 64) - 1 - 9) // 10  # 1844674407370955160

PHASES = PhaseTimes("bucket", "parse", "assemble", name="cast_string_to_float")

_I32 = torch.int32
_I64 = torch.int64
_BOOL = torch.bool

# binary64 values of 10^k for k in [-360, 359].  Non-negative k: float(10**k)
# is correctly rounded, overflowing to inf past 308 (exp10 saturation).
# Negative k: libm pow (what CUDA's exp10 is within an ulp).
_EXP10_OFFSET = 360
_EXP10 = np.array(
    [float(np.power(10.0, k)) for k in range(-_EXP10_OFFSET, 0)]
    + [float(10**k) if k <= 308 else np.inf for k in range(360)],
    dtype=np.float64,
)
_EXP10_BITS = _EXP10.view(np.int64)
_EXP10_DEV: Dict[torch.device, torch.Tensor] = {}
_NAN_BITS = int(np.float64(np.nan).view(np.int64))


def _exp10(k: np.ndarray) -> np.ndarray:
    return _EXP10[np.clip(k + _EXP10_OFFSET, 0, len(_EXP10) - 1)]


def _exp10_bits(k: torch.Tensor) -> torch.Tensor:
    """binary64 bits of 10^k (the same clipped table as ``_exp10``)."""
    tab = _EXP10_DEV.get(k.device)
    if tab is None:
        tab = _EXP10_DEV[k.device] = torch.from_numpy(_EXP10_BITS.copy()).to(k.device)
    return tab[torch.clamp(k + _EXP10_OFFSET, 0, len(_EXP10) - 1)]


_SCAN_FIELDS = [
    ("lens", _I32), ("all_ws", _BOOL), ("negative", _BOOL),
    ("is_nan", _BOOL), ("inf3", _BOOL), ("inf_exact", _BOOL),
    ("n_lead_zeros", _I32), ("n_sig", _I32),
    ("n_digit_chars", _I32), ("decimal_pos", _I32),
    ("dot_in_run", _BOOL), ("val19", _I64), ("d20", _I64),
    ("has_exp", _BOOL), ("exp_neg", _BOOL), ("exp_val", _I32),
    ("exp_digits", _I32), ("has_suffix", _BOOL),
    ("tail_nonws", _BOOL), ("tail0_nonws", _BOOL),
]


def _scan(col: StringColumn) -> Dict[str, torch.Tensor]:
    """Per-row parse fields (dict of tensors on the column's device), the
    padded sweep run per length bucket so a long outlier pads no short row."""
    outs = map_buckets(col, _scan_padded, [((), dt) for _, dt in _SCAN_FIELDS])
    return {k: v for (k, _), v in zip(_SCAN_FIELDS, outs)}


# twin: s2f_scan
def _scan_padded(padded: torch.Tensor, lens: torch.Tensor, max_exp_digits: int = 4):
    """The parse sweep over one ``[n, L]`` zero-padded byte rectangle, as a
    tuple in ``_SCAN_FIELDS`` order (val19 and d20 are u64 bits in int64).

    ``max_exp_digits``: the Spark cast reads at most 4 manual-exponent digits
    (parse_manual_exp :505); JSON number re-rendering passes the full width,
    with the value saturated.  Masks stay bool/uint8 and the 19-digit value
    is a Horner sweep over the columns, so no ``[n, L]`` int64 temporary is
    ever built (the JAX package's rank x pow10 form needs three)."""
    n, L = padded.shape
    dev = padded.device
    lens = lens.to(_I32)
    pos = torch.arange(L, dtype=_I32, device=dev)[None, :]
    in_str = pos < lens[:, None]
    c = padded
    is_ws = ((c <= 0x1F) | (c == 32)) & in_str
    is_digit = (c >= 48) & (c <= 57) & in_str

    def char_at(p):
        """lowercased byte at position p (0 outside the string)."""
        v = torch.gather(c, 1, torch.clamp(p, 0, L - 1).to(_I64)[:, None])[:, 0]
        v = torch.where((v >= 65) & (v <= 90), v + 32, v)
        return torch.where((p >= 0) & (p < lens), v, 0)

    # leading whitespace: positions at or past the end count as non-ws, so
    # all-ws rows land on lens
    ws_end = torch.minimum(_first_true(~is_ws, L), lens)
    all_ws = ws_end >= lens

    c0 = char_at(ws_end)
    has_sign = (c0 == ord("+")) | (c0 == ord("-"))
    negative = c0 == ord("-")
    p0 = ws_end + has_sign.to(_I32)

    def match(p, word):
        ok = torch.ones((n,), dtype=_BOOL, device=dev)
        for k, ch in enumerate(word):
            ok &= char_at(p + k) == ord(ch)
        return ok

    is_nan = match(p0, "nan")
    inf3 = match(p0, "inf")
    inf8 = inf3 & match(p0 + 3, "inity")
    inf_exact = (inf3 & (p0 + 3 == lens)) | (inf8 & (p0 + 8 == lens))

    # ---- digit run [p0, stop): digits plus at most the first dot
    after_p0 = pos >= p0[:, None]
    first_dot = _first_true((c == 46) & in_str & after_p0, L)
    brk = after_p0 & ~(is_digit | (pos == first_dot[:, None]))
    stop = torch.minimum(_first_true(brk, L), lens)
    del brk
    dot_in_run = (first_dot < stop) & (first_dot >= p0)
    digit_in_run = is_digit & after_p0 & (pos < stop[:, None])
    del after_p0, is_digit

    # leading zeros before the dot (while the value is still zero)
    first_sig = _first_true(digit_in_run & (c != 48), L)
    pre_dot = pos < first_dot[:, None]
    lead_zero = digit_in_run & pre_dot & (pos < first_sig[:, None])
    n_lead_zeros = lead_zero.sum(1, dtype=_I32)
    sig_mask = digit_in_run & ~lead_zero
    del lead_zero
    n_sig = sig_mask.sum(1, dtype=_I32)
    n_digit_chars = digit_in_run.sum(1, dtype=_I32)
    decimal_pos = (sig_mask & pre_dot).sum(1, dtype=_I32)
    del digit_in_run, pre_dot

    # value of the first min(n_sig, 19) significant digits as u64 and the
    # 20th digit (post-dot zeros count as significant chars but keep the
    # value small, so the reference's +1-digit rule is reachable for
    # 0.00...ddd inputs): Horner over the columns, in digit order
    sig_t = sig_mask.t().contiguous()
    dig_t = (c - 48).t().contiguous()
    del sig_mask
    val19 = torch.zeros((n,), dtype=_I64, device=dev)
    d20 = torch.zeros((n,), dtype=_I64, device=dev)
    cnt = torch.zeros((n,), dtype=_I32, device=dev)
    for j in range(L):
        s_j = sig_t[j]
        d_j = dig_t[j].to(_I64)
        val19 = torch.where(s_j & (cnt < 19), val19 * 10 + d_j, val19)
        d20 = torch.where(s_j & (cnt == 19), d_j, d20)
        cnt = cnt + s_j.to(_I32)
    del sig_t, dig_t

    # ---- manual exponent at `stop`
    has_exp = char_at(stop) == ord("e")
    pe = stop + 1
    cs = char_at(pe)
    exp_has_sign = has_exp & ((cs == ord("+")) | (cs == ord("-")))
    exp_neg = exp_has_sign & (cs == ord("-"))
    pd = pe + exp_has_sign.to(_I32)
    # up to max_exp_digits digit chars; the value saturates so absurdly long
    # exponents stay order-of-magnitude right (-> 0.0 / inf)
    exp_digits = torch.zeros((n,), dtype=_I32, device=dev)
    exp_val = torch.zeros((n,), dtype=_I32, device=dev)
    still = torch.ones((n,), dtype=_BOOL, device=dev)
    for k in range(max_exp_digits):
        ck = char_at(pd + k)
        is_d = (ck >= 48) & (ck <= 57) & still & (pd + k < lens)
        exp_val = torch.where(is_d, torch.clamp(exp_val * 10 + (ck.to(_I32) - 48), max=99999),
                              exp_val)
        exp_digits = exp_digits + is_d.to(_I32)
        still = still & is_d
    p_after_exp = torch.where(has_exp, pd + exp_digits, stop)

    # ---- trailing: one f/d, then whitespace, then the end
    cf = char_at(p_after_exp)
    has_suffix = (cf == ord("f")) | (cf == ord("d"))
    pt = p_after_exp + has_suffix.to(_I32)
    nonws = in_str & ~is_ws
    tail_nonws = (nonws & (pos >= pt[:, None])).any(1)
    # zero-value rows allow only whitespace after the number (no suffix)
    tail0_nonws = (nonws & (pos >= p_after_exp[:, None])).any(1)

    fields = dict(
        lens=lens, all_ws=all_ws, negative=negative,
        is_nan=is_nan, inf3=inf3, inf_exact=inf_exact,
        n_lead_zeros=n_lead_zeros, n_sig=n_sig, n_digit_chars=n_digit_chars,
        decimal_pos=decimal_pos, dot_in_run=dot_in_run,
        val19=val19, d20=d20,
        has_exp=has_exp, exp_neg=exp_neg, exp_val=exp_val,
        exp_digits=exp_digits,
        has_suffix=has_suffix, tail_nonws=tail_nonws, tail0_nonws=tail0_nonws,
    )
    return tuple(fields[k].to(dt) for k, dt in _SCAN_FIELDS)


# twin: s2f_scan
def _scan_padded_np(padded, lens, max_exp_digits: int = 4):
    """numpy twin of _scan_padded: the same single-pass prefix-mask sweep
    over one [n, L] byte rectangle, lane-for-lane."""
    n, L = padded.shape
    lens = lens.astype(np.int32)
    pos_mat = np.arange(L, dtype=np.int32)[None, :]
    in_str = pos_mat < lens[:, None]
    c = padded
    lower = np.where((c >= 65) & (c <= 90), c + 32, c)  # ascii tolower

    is_ws = ((c <= 0x1F) | (c == 32)) & in_str
    is_digit = (c >= 48) & (c <= 57) & in_str
    is_dot = (c == 46) & in_str

    def first_true(mask, default):
        """index of first True per row, else default."""
        any_ = np.any(mask, axis=1)
        idx = np.argmax(mask, axis=1).astype(np.int32)
        return np.where(any_, idx, np.int32(default))

    def char_at(p):
        """lowercased char at position p (0 beyond string)."""
        pc = np.clip(p, 0, L - 1)
        v = np.take_along_axis(lower, pc[:, None], axis=1)[:, 0]
        return np.where((p >= 0) & (p < lens), v, np.uint8(0))

    ws_end = np.minimum(first_true(~is_ws, L), lens)
    all_ws = ws_end >= lens

    c0 = char_at(ws_end)
    has_sign = (c0 == ord("+")) | (c0 == ord("-"))
    negative = c0 == ord("-")
    p0 = ws_end + has_sign.astype(np.int32)

    def match(p, word):
        ok = np.ones((n,), np.bool_)
        for k, ch in enumerate(word):
            ok &= char_at(p + k) == ord(ch)
        return ok

    is_nan = match(p0, "nan")
    inf3 = match(p0, "inf")
    inf8 = inf3 & match(p0 + 3, "inity")
    inf_exact = (inf3 & (p0 + 3 == lens)) | (inf8 & (p0 + 8 == lens))

    after_p0 = pos_mat >= p0[:, None]
    dot_in_tail = is_dot & after_p0
    first_dot = first_true(dot_in_tail, L)
    run_char = is_digit | (pos_mat == first_dot[:, None])
    brk = after_p0 & ~run_char
    stop = first_true(brk, L)
    stop = np.minimum(stop, lens)
    in_run = after_p0 & (pos_mat < stop[:, None])
    dot_in_run = (first_dot < stop) & (first_dot >= p0)
    digit_in_run = is_digit & in_run

    nonzero_digit = digit_in_run & (c != 48)
    first_sig = first_true(nonzero_digit, L)
    pre_dot = pos_mat < first_dot[:, None]
    lead_zero = digit_in_run & pre_dot & (pos_mat < first_sig[:, None])
    n_lead_zeros = np.sum(lead_zero, axis=1).astype(np.int32)

    sig_mask = digit_in_run & ~lead_zero
    n_sig = np.sum(sig_mask, axis=1).astype(np.int32)
    n_digit_chars = np.sum(digit_in_run, axis=1).astype(np.int32)
    decimal_pos = np.sum(sig_mask & pre_dot, axis=1).astype(np.int32)

    rank = np.cumsum(sig_mask.astype(np.int32), axis=1) - 1
    pow10 = np.array([10**k for k in range(20)], dtype=np.uint64)
    digit_vals = (c - np.uint8(48)).astype(np.uint64)
    k19 = np.minimum(n_sig, 19)
    take19 = sig_mask & (rank < 19)
    w19 = pow10[np.clip(np.where(take19, (k19[:, None] - 1 - rank), 0), 0, 19)]
    val19 = np.sum(np.where(take19, digit_vals * w19, np.uint64(0)), axis=1)
    d20 = np.sum(
        np.where(sig_mask & (rank == 19), digit_vals, np.uint64(0)), axis=1
    )

    ce = char_at(stop)
    has_exp = ce == ord("e")
    pe = stop + 1
    cs = char_at(pe)
    exp_has_sign = has_exp & ((cs == ord("+")) | (cs == ord("-")))
    exp_neg = exp_has_sign & (cs == ord("-"))
    pd = pe + exp_has_sign.astype(np.int32)
    exp_digits = np.zeros((n,), np.int32)
    exp_val = np.zeros((n,), np.int32)
    still = np.ones((n,), np.bool_)
    for k in range(max_exp_digits):
        ck = char_at(pd + k)
        is_d = (ck >= 48) & (ck <= 57) & still & (pd + k < lens)
        exp_val = np.where(
            is_d,
            np.minimum(exp_val * 10 + (ck - 48).astype(np.int32), 99999),
            exp_val)
        exp_digits = exp_digits + is_d.astype(np.int32)
        still = still & is_d
    p_after_exp = np.where(has_exp, pd + exp_digits, stop)

    cf = char_at(p_after_exp)
    has_suffix = (cf == ord("f")) | (cf == ord("d"))
    pt = p_after_exp + has_suffix.astype(np.int32)
    tail = (pos_mat >= pt[:, None]) & in_str
    tail_nonws = np.any(tail & ~is_ws, axis=1)

    tail0 = (pos_mat >= p_after_exp[:, None]) & in_str
    tail0_nonws = np.any(tail0 & ~is_ws, axis=1)

    fields = dict(
        lens=lens, all_ws=all_ws, negative=negative,
        is_nan=is_nan, inf3=inf3, inf_exact=inf_exact,
        n_lead_zeros=n_lead_zeros, n_sig=n_sig, n_digit_chars=n_digit_chars,
        decimal_pos=decimal_pos, dot_in_run=dot_in_run,
        val19=val19, d20=d20,
        has_exp=has_exp, exp_neg=exp_neg, exp_val=exp_val,
        exp_digits=exp_digits,
        has_suffix=has_suffix, tail_nonws=tail_nonws, tail0_nonws=tail0_nonws,
    )
    return fields


def _scan_rect_np(padded, lens):
    """Optimized host scan over one zero-filled [n, L] rectangle.

    Equivalent to _scan_padded_np (the pinned twin mirror, kept as the
    cheap parity oracle) but restructured for throughput: the run counts
    collapse to O(n) boundary arithmetic (the run is contiguous, so counting
    chars is subtracting positions), the 19-digit value accumulates as a
    Horner sweep over transposed contiguous columns instead of a
    rank-cumsum + pow10 gather over uint64 rectangles, and the tail checks
    reduce to one last-non-ws position per row.  Requires bytes at and
    beyond each row's length to be zero (see _scan_np's rectangle build).
    """
    n, L = padded.shape
    lens = lens.astype(np.int32)
    c = padded
    nonws = (c > 0x1F) & (c != 32)  # sentinel \0 counts as ws
    is_digit = (c - np.uint8(48)) <= 9  # uint8 wraparound: one compare
    pos_mat = np.arange(L, dtype=np.int32)[None, :]
    # one-column gathers run as flat fancy indexing over a shared row-offset
    # vector: np.take_along_axis pays index broadcasting + a (n, 1) reshape
    # per call, which dominates these O(n) probes on a memory-bound host
    rowoff = np.arange(n, dtype=np.int64) * L
    cflat = c.reshape(-1)

    def first_true(mask, default):
        # checking mask at its own argmax is cheaper than a second np.any
        # reduction over the whole rectangle
        idx = np.argmax(mask, axis=1).astype(np.int32)
        found = mask.reshape(-1)[rowoff + idx]
        return np.where(found, idx, np.int32(default))

    def char_at(p):
        """lowercased char at position p (0 beyond string)."""
        pc = np.clip(p, 0, L - 1)
        v = cflat[rowoff + pc]
        v = np.where((v >= 65) & (v <= 90), v + 32, v)
        return np.where((p >= 0) & (p < lens), v, np.uint8(0))

    ws_end = np.minimum(first_true(nonws, L), lens)
    all_ws = ws_end >= lens

    c0 = char_at(ws_end)
    has_sign = (c0 == ord("+")) | (c0 == ord("-"))
    negative = c0 == ord("-")
    p0 = ws_end + has_sign.astype(np.int32)

    # nan / inf / infinity: only rows whose first payload char is n/i can
    # match, so the 8-char block compare runs on that (usually tiny) subset
    cp0 = char_at(p0)
    cand = np.nonzero((cp0 == ord("n")) | (cp0 == ord("i")))[0]
    is_nan = np.zeros((n,), np.bool_)
    inf3 = np.zeros((n,), np.bool_)
    inf_exact = np.zeros((n,), np.bool_)
    if cand.size:
        cs_ = c[cand]
        ps = p0[cand]
        ar8 = np.arange(8, dtype=np.int32)
        g = np.take_along_axis(cs_, np.minimum(ps[:, None] + ar8, L - 1), axis=1)
        g = np.where((g >= 65) & (g <= 90), g + 32, g)
        g = np.where(ps[:, None] + ar8 < lens[cand][:, None], g, np.uint8(0))

        def match(k0, word):
            ok = np.ones((cand.size,), np.bool_)
            for k, ch in enumerate(word):
                ok &= g[:, k0 + k] == ord(ch)
            return ok

        nan_s = match(0, "nan")
        inf3_s = match(0, "inf")
        inf8_s = inf3_s & match(3, "inity")
        is_nan[cand] = nan_s
        inf3[cand] = inf3_s
        inf_exact[cand] = (inf3_s & (ps + 3 == lens[cand])) | (
            inf8_s & (ps + 8 == lens[cand])
        )

    # digit run [p0, stop): contiguous digits plus at most the first dot.
    # Only ws/sign chars precede p0, so the first dot / first nonzero digit
    # anywhere IS the first one at >= p0 — no after-p0 masking needed.
    first_dot = first_true(c == 46, L)
    run_char = is_digit | (pos_mat == first_dot[:, None])
    after_p0 = pos_mat >= p0[:, None]
    stop = np.minimum(first_true(after_p0 & ~run_char, L), lens)
    dot_in_run = (first_dot < stop) & (first_dot >= p0)
    first_sig = first_true((c - np.uint8(49)) <= 8, L)  # c in '1'..'9'

    # the run is contiguous, so every count is boundary arithmetic:
    # [p0, min(first_dot, first_sig, stop)) are exactly the leading zeros
    n_digit_chars = (stop - p0) - dot_in_run.astype(np.int32)
    n_lead_zeros = np.minimum(np.minimum(first_dot, first_sig), stop) - p0
    n_sig = n_digit_chars - n_lead_zeros
    decimal_pos = np.minimum(first_dot, stop) - p0 - n_lead_zeros

    # first-19-digit value: Horner sweep over transposed contiguous columns.
    # sig = in-run digit past the dot or at/after the first nonzero digit,
    # i.e. a digit at position in [min(first_dot + 1, first_sig), stop).
    # The u8 digit columns feed the u64 accumulator unconverted — numpy's
    # buffered in-ufunc cast is ~35% cheaper than materializing a u64
    # column per iteration on a memory-bound host.
    sig_lo = np.minimum(first_dot + 1, first_sig)
    # sig = in-run digit at position >= sig_lo; the per-column flags come
    # from the one transposed digit rectangle plus two O(n) scalar-vs-row
    # compares per column — no (n, L) sig mask or second transpose copy
    dig_t = np.ascontiguousarray(c.T) - np.uint8(48)
    digit_t = dig_t <= np.uint8(9)
    val19 = np.zeros((n,), np.uint64)
    d20 = np.zeros((n,), np.uint64)
    cnt = np.zeros((n,), np.int32)
    capped = bool((n_sig > 19).any())  # else cnt never reaches 19
    one, nine = np.uint8(1), np.uint8(9)
    for j in range(min(L, int(stop.max(initial=0)))):  # sig positions < stop
        sig_j = digit_t[j] & (sig_lo <= j) & (j < stop)
        d_j = dig_t[j]
        take = sig_j & (cnt < 19) if capped else sig_j
        # val19 = val19 * 10 + d_j where take, else unchanged — as two
        # in-place u64 ops with arithmetic selects (x10/x1 multiplier,
        # digit-or-zero addend): no np.where temporaries on the hot loop
        np.multiply(val19, one + take * nine, out=val19, casting="unsafe")
        np.add(val19, d_j * take, out=val19, casting="unsafe")
        if capped:
            d20 = np.where(sig_j & (cnt == 19), d_j, d20)
            cnt += sig_j
    # mirror semantics: np.minimum(n_sig, 19) digits accumulated, 20th in d20

    # manual exponent: 4-char block gather at pd, then one vectorized
    # consecutive-digit accumulate (4 digits max out at 9999, so the
    # mirror's 99999 saturation clamp can never fire here)
    ce = char_at(stop)
    has_exp = ce == ord("e")
    pe = stop + 1
    cs2 = char_at(pe)
    exp_has_sign = has_exp & ((cs2 == ord("+")) | (cs2 == ord("-")))
    exp_neg = exp_has_sign & (cs2 == ord("-"))
    pd = pe + exp_has_sign.astype(np.int32)
    ar4 = np.arange(4, dtype=np.int32)
    ge = cflat[rowoff[:, None] + np.clip(pd[:, None] + ar4, 0, L - 1)]
    dmask = ((ge - np.uint8(48)) <= 9) & (pd[:, None] + ar4 < lens[:, None])
    run4 = np.logical_and.accumulate(dmask, axis=1)
    exp_digits = np.sum(run4, axis=1).astype(np.int32)
    pw4 = np.array([1, 10, 100, 1000], np.int32)
    shift = np.clip(exp_digits[:, None] - 1 - ar4, 0, 3)
    exp_val = np.sum(
        run4 * (ge - np.uint8(48)).astype(np.int32) * pw4[shift], axis=1
    ).astype(np.int32)
    p_after_exp = np.where(has_exp, pd + exp_digits, stop)

    cf = char_at(p_after_exp)
    has_suffix = (cf == ord("f")) | (cf == ord("d"))
    pt = p_after_exp + has_suffix.astype(np.int32)
    # trailing checks via the last non-ws position (sentinel zeros are ws)
    nonws_rev = nonws[:, ::-1]
    last_nonws = np.where(
        all_ws,  # all_ws == "no non-ws byte anywhere" (sentinel \0 is ws)
        np.int32(-1),
        np.int32(L - 1) - np.argmax(nonws_rev, axis=1).astype(np.int32),
    )
    tail_nonws = last_nonws >= pt
    tail0_nonws = last_nonws >= p_after_exp

    return dict(
        lens=lens, all_ws=all_ws, negative=negative,
        is_nan=is_nan, inf3=inf3, inf_exact=inf_exact,
        n_lead_zeros=n_lead_zeros, n_sig=n_sig, n_digit_chars=n_digit_chars,
        decimal_pos=decimal_pos, dot_in_run=dot_in_run,
        val19=val19, d20=d20,
        has_exp=has_exp, exp_neg=exp_neg, exp_val=exp_val,
        exp_digits=exp_digits,
        has_suffix=has_suffix, tail_nonws=tail_nonws, tail0_nonws=tail0_nonws,
    )


_SCAN_FIELDS_NP = {
    "lens": np.int32, "all_ws": np.bool_, "negative": np.bool_,
    "is_nan": np.bool_, "inf3": np.bool_, "inf_exact": np.bool_,
    "n_lead_zeros": np.int32, "n_sig": np.int32, "n_digit_chars": np.int32,
    "decimal_pos": np.int32, "dot_in_run": np.bool_, "val19": np.uint64,
    "d20": np.uint64, "has_exp": np.bool_, "exp_neg": np.bool_,
    "exp_val": np.int32, "exp_digits": np.int32, "has_suffix": np.bool_,
    "tail_nonws": np.bool_, "tail0_nonws": np.bool_,
}


def _scan_np(col: StringColumn):
    """Host mirror of _scan: pow2 length buckets over the numpy byte arrays
    (so short numerics never pay a long outlier's rectangle), each scanned by
    _scan_rect_np over a zero-filled rectangle clamped to the bucket's true
    max length (host rectangles have no shape cache to feed, so nothing
    forces the width itself up to a power of two)."""
    with PHASES.phase("bucket"):
        chars = col.chars.cpu().numpy()
        offsets = col.offsets.cpu().numpy()
        lens_all = (offsets[1:] - offsets[:-1]).astype(np.int32)
        n = lens_all.shape[0]
        buckets = [(w, rows.numpy()) for w, rows in
                   length_buckets(torch.from_numpy(lens_all), min_width=4)]
        # bucketing only pays when it prunes padded work (long outliers);
        # a flat length profile runs as ONE rectangle, skipping the
        # per-field scatter-backs entirely
        w_max = int(lens_all.max(initial=0))
        bucketed_work = sum(w * len(rows) for w, rows in buckets)
        mono = bool(n and n * w_max <= bucketed_work)
        if mono:
            buckets = [(w_max, np.arange(n, dtype=np.int64))]
    outs = {k: np.zeros(n, dt) for k, dt in _SCAN_FIELDS_NP.items()}
    for _, rows_np in buckets:
        n_valid = len(rows_np)
        with PHASES.phase("bucket"):
            lens = lens_all[rows_np]
            width = max(int(lens.max(initial=0)), 1)
            in_row = np.arange(width, dtype=np.int32)[None, :] < lens[:, None]
            if mono:
                # all rows in offset order: the chars buffer between
                # offsets[0] and offsets[-1] IS the row-major concatenation
                # of every row's bytes, so one boolean scatter fills the
                # rectangle — no (n, W) int32 index matrix, no gather, no
                # zeroing multiply
                padded = np.zeros((n_valid, width), np.uint8)
                padded[in_row] = chars[int(offsets[0]):int(offsets[-1])]
            else:
                starts = offsets[rows_np].astype(np.int32)
                idx = starts[:, None] + np.arange(
                    width, dtype=np.int32)[None, :]
                pad_chars = np.concatenate(
                    [chars, np.zeros((width,), np.uint8)]
                )
                padded = pad_chars[idx]
                padded *= in_row
        with PHASES.phase("parse"):
            fields = _scan_rect_np(padded, lens)
        with PHASES.phase("bucket"):
            if n_valid == n:
                for k, dt in _SCAN_FIELDS_NP.items():
                    outs[k] = fields[k].astype(dt)
            else:
                for k, dt in _SCAN_FIELDS_NP.items():
                    outs[k][rows_np] = fields[k].astype(dt)
    return outs


# twin: s2f_assemble
def _assemble_device(f: Dict[str, torch.Tensor]):
    """The reference's final double assembly (cast_string_to_float.cu:134-199)
    in exact integer binary64 arithmetic (``utils.softfloat``) on the
    fields' device.  Returns (bits int64, valid, except_) tensors; the host
    ``_assemble`` is its numpy twin."""
    lens = f["lens"].to(_I64)
    neg = f["negative"]
    sign_bit = neg.to(_I64) << 63
    n = lens.shape[0]
    dev = lens.device

    valid = torch.ones((n,), dtype=_BOOL, device=dev)
    except_ = torch.zeros((n,), dtype=_BOOL, device=dev)

    nan_rows = f["is_nan"]
    bad_nan = nan_rows & (lens != 3)
    valid &= ~bad_nan
    except_ |= bad_nan

    inf_rows = f["inf3"] & ~nan_rows
    ok_inf = inf_rows & f["inf_exact"]
    valid &= ~(inf_rows & ~f["inf_exact"])  # no ANSI error (cu :276)

    plain = ~nan_rows & ~inf_rows
    seen_digit = (f["n_digit_chars"] > 0) | (f["n_lead_zeros"] > 0)
    no_digits = plain & ~seen_digit
    valid &= ~no_digits
    except_ |= no_digits

    # 19-significant-char accumulation + truncation accounting (:395-445);
    # val19 and the sums are u64, compared unsigned
    n_sig = f["n_sig"].to(_I64)
    val19 = f["val19"]
    over = n_sig > 19
    val20 = val19 * 10 + f["d20"]
    can_add = over & ule(val19, MAX_HOLDING) & ule(val20, MAX_HOLDING)
    digits = torch.where(can_add, val20, val19)
    real_digits = torch.clamp(n_sig, max=19)
    truncated = torch.where(can_add, n_sig - 18, torch.where(over, n_sig - 19, 0))
    total_digits = real_digits + truncated
    exp_base = truncated - torch.where(f["dot_in_run"],
                                       total_digits - f["decimal_pos"].to(_I64), 0)

    bad_exp = plain & f["has_exp"] & (f["exp_digits"] == 0)
    valid &= ~bad_exp
    except_ |= bad_exp
    manual = torch.where(f["exp_neg"], -f["exp_val"], f["exp_val"]).to(_I64)
    manual = torch.where(f["has_exp"], manual, 0)

    zero = plain & (digits == 0) & seen_digit
    bad_zero_tail = zero & f["tail0_nonws"]
    valid &= ~bad_zero_tail
    except_ |= bad_zero_tail

    nonzero = plain & (digits != 0)
    bad_tail = nonzero & f["tail_nonws"]
    valid &= ~bad_tail
    except_ |= bad_tail

    # final assembly (:153-199) in softfloat binary64
    exp_ten = exp_base + manual
    digits_bits = u64_to_f64_bits(digits) | sign_bit
    nd = torch.ones((n,), dtype=_I64, device=dev)  # decimal digits of `digits`
    for k in range(1, 20):
        nd += uge(digits, s64(10**k)).to(_I64)

    too_big = exp_ten > 308
    sub_shift = -307 - exp_ten
    subnormal = ~too_big & (sub_shift > 0)
    dsub = f64_div_bits(digits_bits, _exp10_bits(nd - 1 + sub_shift))
    res_sub = f64_mul_bits(dsub, _exp10_bits(exp_ten + nd - 1 + sub_shift))
    e10 = _exp10_bits(torch.abs(exp_ten))
    res_norm = torch.where(exp_ten < 0, f64_div_bits(digits_bits, e10),
                           f64_mul_bits(digits_bits, e10))
    inf_bits = sign_bit | 0x7FF0000000000000
    res = torch.where(too_big, inf_bits, torch.where(subnormal, res_sub, res_norm))

    out = torch.zeros((n,), dtype=_I64, device=dev)
    out = torch.where(nan_rows, _NAN_BITS, out)
    out = torch.where(ok_inf, inf_bits, out)
    out = torch.where(zero, sign_bit, out)
    out = torch.where(nonzero, res, out)
    return out, valid, except_


# twin: s2f_assemble
def _assemble(f, out_dtype_np):
    """Host: replicate the reference's final double assembly (:134-199).

    The numpy twin of ``_assemble_device``: hardware binary64 is exactly
    the arithmetic the softfloat lane arm emulates."""
    f = {k: np.asarray(v) for k, v in f.items()}
    lens = f["lens"].astype(np.int64)
    n = lens.shape[0]
    out = np.zeros((n,), np.float64)
    valid = np.ones((n,), bool)
    except_ = np.zeros((n,), bool)

    sign = np.where(f["negative"], -1.0, 1.0)

    # nan: always writes NaN; only the bare 3-char string is valid
    nan_rows = f["is_nan"]
    out[nan_rows] = np.nan
    bad_nan = nan_rows & (lens != 3)
    valid[bad_nan] = False
    except_[bad_nan] = True

    # inf / infinity
    inf_rows = f["inf3"] & ~nan_rows
    ok_inf = inf_rows & f["inf_exact"]
    out[ok_inf] = np.where(f["negative"][ok_inf], -np.inf, np.inf)
    valid[inf_rows & ~f["inf_exact"]] = False  # no ANSI error (cu :276 comment)

    plain = ~nan_rows & ~inf_rows

    # no digits at all -> invalid + except (includes empty / all-ws strings)
    seen_digit = (f["n_digit_chars"] > 0) | (f["n_lead_zeros"] > 0)
    no_digits = plain & ~seen_digit
    valid[no_digits] = False
    except_[no_digits] = True

    # 19-significant-char accumulation with the reference's truncation
    # accounting (cast_string_to_float.cu:395-445).  The "+1 digit" rule only
    # fires when post-dot zeros pad the window (value stays <= max_holding/10,
    # e.g. "0.0123...": zeros count as chars but not value); for a normalized
    # 19-digit value digits*10 always overflows max_holding.
    n_sig = f["n_sig"].astype(np.int64)
    val19 = f["val19"]
    real_digits = np.minimum(n_sig, 19)
    over = n_sig > 19
    # the val19 <= MAX_HOLDING clause both mirrors the reference's outer
    # check and keeps the *10 below from wrapping u64
    with np.errstate(over="ignore"):
        can_add = over & (val19 <= np.uint64(MAX_HOLDING)) & (
            val19 * np.uint64(10) + f["d20"] <= np.uint64(MAX_HOLDING)
        )
        digits = np.where(can_add, val19 * np.uint64(10) + f["d20"], val19)
    # bug-compat: the reference counts one extra truncated char when it adds
    # the 20th digit without incrementing real_digits (:437)
    truncated = np.where(can_add, n_sig - 18, np.where(over, n_sig - 19, 0))

    total_digits = real_digits + truncated
    exp_base = truncated - np.where(
        f["dot_in_run"], total_digits - f["decimal_pos"].astype(np.int64), 0
    )

    # manual exponent; 'e' with no digits is invalid
    bad_exp = plain & f["has_exp"] & (f["exp_digits"] == 0)
    valid[bad_exp] = False
    except_[bad_exp] = True
    manual = np.where(f["exp_neg"], -f["exp_val"], f["exp_val"]).astype(np.int64)
    manual = np.where(f["has_exp"], manual, 0)

    zero = plain & (digits == 0) & seen_digit
    bad_zero_tail = zero & f["tail0_nonws"]
    valid[bad_zero_tail] = False
    except_[bad_zero_tail] = True
    out = np.where(zero, sign * 0.0, out)

    nonzero = plain & (digits != 0)
    bad_tail = nonzero & f["tail_nonws"]
    valid[bad_tail] = False
    except_[bad_tail] = True

    # final assembly in binary64 (cast_string_to_float.cu:153-199)
    exp_ten = (exp_base + manual).astype(np.int64)
    digitsf = sign * digits.astype(np.float64)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        res = np.zeros((n,), np.float64)
        too_big = exp_ten > 308
        res[too_big] = np.where(f["negative"][too_big], -np.inf, np.inf)
        sub_shift = -307 - exp_ten
        subnormal = ~too_big & (sub_shift > 0)
        if subnormal.any():
            nd = np.char.str_len(
                digits[subnormal].astype("U32")
            ).astype(np.int64)  # number of digits
            dsub = digitsf[subnormal] / _exp10(nd - 1 + sub_shift[subnormal])
            e2 = exp_ten[subnormal] + nd - 1 + sub_shift[subnormal]
            res[subnormal] = dsub * _exp10(e2)
        normal = ~too_big & ~subnormal
        exponent = _exp10(np.abs(exp_ten[normal]))
        dn = digitsf[normal]
        res[normal] = np.where(exp_ten[normal] < 0, dn / exponent, dn * exponent)
    out = np.where(nonzero, res, out)

    if out_dtype_np == np.float32:
        with np.errstate(over="ignore"):  # double->float32 overflow -> inf
            out = out.astype(np.float32)
    return out, valid, except_


def _device_parse_enabled(dev: torch.device) -> bool:
    """``cast_device_parse``: True/False pin an arm; ``"auto"`` takes the lane
    arm for a CUDA column and the numpy twin for a CPU one."""
    v = config.get("cast_device_parse")
    if v == "auto":
        return dev.type != "cpu"
    return bool(v)


def _raise_cast_error(col: StringColumn, row: int):
    raise CastException(_row_string(col, row, "replace"), row)


def _string_to_float_host(col: StringColumn, ansi_mode: bool, dtype: DType) -> Column:
    """The numpy twin: bucketed host scan + the hardware-binary64 assembly;
    the result goes back to the column's device."""
    f = _scan_np(col)
    with PHASES.phase("assemble"):
        out_np = np.float32 if dtype.kind == Kind.FLOAT32 else np.float64
        out, valid, except_ = _assemble(f, out_np)

    in_valid = col.is_valid().cpu().numpy()
    except_ = except_ & in_valid
    if ansi_mode and except_.any():
        _raise_cast_error(col, int(np.argmax(except_)))
    validity = torch.from_numpy(valid & in_valid).to(col.device)
    if dtype.kind == Kind.FLOAT64:
        out = out.view(np.int64)  # bit-pattern convention
    return Column(torch.from_numpy(out).to(col.device), validity, dtype)


def string_to_float(col: StringColumn, ansi_mode: bool, dtype: DType = FLOAT64) -> Column:
    """Parse a string column into FLOAT32/FLOAT64 with Spark semantics.

    Invalid rows become null, or raise CastException (with the first bad
    row) when ``ansi_mode`` (CastStringJni.cpp CATCH_CAST_EXCEPTION path).
    The arm follows ``cast_device_parse`` (module doc).
    """
    if dtype.kind not in (Kind.FLOAT32, Kind.FLOAT64):
        raise TypeError("string_to_float produces FLOAT32 or FLOAT64")
    if not _device_parse_enabled(col.device):
        return _string_to_float_host(col, ansi_mode, dtype)
    with PHASES.phase("parse"):
        f = _scan(col)
    with PHASES.phase("assemble"):
        bits, valid, except_ = _assemble_device(f)

    in_valid = col.is_valid()
    if ansi_mode:
        # the arm's one host decision: a scalar sync, the failing row's
        # bytes read only on the (exceptional) throw path
        with PHASES.phase("parse"):
            except_ = except_ & in_valid
            bad = bool(except_.any())
        if bad:
            _raise_cast_error(col, int(except_.to(torch.uint8).argmax()))
    validity = valid & in_valid
    if dtype.kind == Kind.FLOAT64:
        return Column(bits, validity, dtype)  # bit-pattern convention
    return Column(bits_to_f32(f64_bits_to_f32_bits(bits)), validity, dtype)
