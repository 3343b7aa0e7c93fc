"""Device-resident rendering for ``get_json_object`` (PyTorch port of
``ops/json_render_device.py``).

Torch re-expression of the host render pipeline in ops/get_json_object.py:
per-byte escape tables (``_byte_info``), per-token emission tables, path-name
matching, float re-rendering and the segment->bytes expansion (``_render``),
so a bucket's bytes stay on the card.  The host syncs per bucket chunk are a
few scalars: the float count and source width, and the output width.

Float re-rendering uses the Spark-exact parse (cast_string_to_float's scan
and softfloat assembly) followed by the Ryu digit core
(float_to_string._d2d/_emit).  For numbers with <= 15 significant digits and
|exp10| <= 22 this equals the host arm's correctly rounded strtod; beyond
that the two-step rounding may differ by 1 ulp from python/Java parsing, as
in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spark_rapids_jni_tpu_torch.ops import json_tokenizer as jt
from spark_rapids_jni_tpu_torch.ops.get_json_object import (
    _CONST_LEN,
    _CONST_MAXLEN,
    _CONST_TAB,
    _CONSTS,
    _CTRL_SHORT,
    _HEX_UP,
    _SEG_CONST,
    _SEG_ESC_TOK,
    _SEG_RAW_TOK,
    _UNESC,
)
from spark_rapids_jni_tpu_torch.ops.json_scan import SEG_SHIFT

_I32 = torch.int32
_I64 = torch.int64
_U8 = torch.uint8

# cells of a render block's [rows, width] temporaries at a time
RENDER_CELLS = 1 << 24

_TABS = {}


def _tab(name: str, device: torch.device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _TABS:
        src = {"unesc": _UNESC, "ctrl_short": _CTRL_SHORT, "hex_up": _HEX_UP,
               "const_tab": _CONST_TAB, "const_len": _CONST_LEN}[name]
        _TABS[key] = torch.from_numpy(src.copy()).to(device)
    return _TABS[key]


class DByteInfo(NamedTuple):
    """Device twin of get_json_object._ByteInfo (all [n, L]-shaped)."""

    b: torch.Tensor
    cls_esc: torch.Tensor
    cls_u: torch.Tensor
    cp: torch.Tensor
    ulen: torch.Tensor
    len_e: torch.Tensor
    cum_u: torch.Tensor  # [n, L + 1] int64 exclusive prefix sums
    cum_e: torch.Tensor
    cum_uni: torch.Tensor


def _take_rows(arr, idx):
    """``arr[i, idx[i, w]]`` (idx pre-clipped)."""
    return torch.gather(arr, 1, idx.to(_I64))


def _searchsorted_rows(a, v):
    """Per-row searchsorted-right: a [n, L] row-sorted, v [n, W] -> [n, W]."""
    return torch.searchsorted(a.contiguous(), v.to(a.dtype).contiguous(), right=True)


def _shift_in(x, k, fill=0):
    """``out[:, i] = x[:, i - k]`` (``fill`` before the start)."""
    out = torch.full_like(x, fill)
    out[:, k:] = x[:, : x.shape[1] - k]
    return out


def byte_info_device(b, lens, st_before) -> DByteInfo:
    """Port of _byte_info's numpy passes (the automaton result is shared)."""
    in_dq = st_before == jt._S_DQ
    in_sq = st_before == jt._S_SQ
    in_str = in_dq | in_sq
    cls_esc_all = (st_before == jt._S_DQE) | (st_before == jt._S_SQE)
    cls_u = cls_esc_all & (b == ord("u"))
    cls_esc = cls_esc_all & ~cls_u
    del cls_esc_all
    cls_hex = torch.zeros_like(cls_u)
    for k in range(1, 5):
        cls_hex |= _shift_in(cls_u, k, False)
    close_q = (in_dq & (b == ord('"'))) | (in_sq & (b == ord("'")))
    del in_dq, in_sq

    d = b.to(_I32)
    hexval = torch.zeros_like(d)
    hexval = torch.where((b >= ord("0")) & (b <= ord("9")), d - ord("0"), hexval)
    hexval = torch.where((b >= ord("a")) & (b <= ord("f")), d - ord("a") + 10, hexval)
    hexval = torch.where((b >= ord("A")) & (b <= ord("F")), d - ord("A") + 10, hexval)
    del d
    cp = torch.zeros_like(hexval)
    L = b.shape[1]
    for k in range(1, 5):
        cp[:, : L - k] |= hexval[:, k:] << (4 * (4 - k))
    del hexval
    ulen = torch.where(cp < 0x80, 1, torch.where(cp < 0x800, 2, 3)).to(_I32)

    normal = in_str & ~(in_str & (b == ord("\\"))) & ~close_q & ~cls_hex
    del close_q, cls_hex, in_str
    is_ctrl = normal & (b < 32)
    short_ctrl = is_ctrl & (_tab("ctrl_short", b.device)[
        torch.clamp(b, max=31).to(_I64)] != 0)

    len_u = torch.zeros(b.shape, dtype=_I32, device=b.device)
    len_u = torch.where(normal, 1, len_u)
    len_u = torch.where(cls_esc, 1, len_u)
    len_u = torch.where(cls_u, ulen, len_u)

    len_e = torch.zeros(b.shape, dtype=_I32, device=b.device)
    len_e = torch.where(normal, 1, len_e)
    len_e = torch.where(normal & (b == ord('"')), 2, len_e)
    len_e = torch.where(short_ctrl, 2, len_e)
    len_e = torch.where(is_ctrl & ~short_ctrl, 6, len_e)
    del normal, is_ctrl, short_ctrl
    two_byte = (b == ord('"')) | (b == ord("\\"))
    for ch in b"bfnrt":
        two_byte |= b == ch
    len_e = torch.where(cls_esc, torch.where(two_byte, 2, 1), len_e).to(_I32)
    len_e = torch.where(cls_u, ulen, len_e)

    def excl_cum(x):
        out = torch.zeros((x.shape[0], x.shape[1] + 1), dtype=_I64, device=x.device)
        out[:, 1:] = torch.cumsum(x, 1, dtype=_I64)
        return out

    return DByteInfo(b=b, cls_esc=cls_esc, cls_u=cls_u, cp=cp, ulen=ulen, len_e=len_e,
                     cum_u=excl_cum(len_u), cum_e=excl_cum(len_e), cum_uni=excl_cum(cls_u))


def _utf8_byte(cp, ulen, k):
    b1 = torch.where(ulen == 1, cp, torch.where(ulen == 2, 0xC0 | (cp >> 6), 0xE0 | (cp >> 12)))
    b2 = torch.where(ulen == 2, 0x80 | (cp & 0x3F), 0x80 | ((cp >> 6) & 0x3F))
    b3 = 0x80 | (cp & 0x3F)
    return torch.where(k == 0, b1, torch.where(k == 1, b2, b3)).to(_U8)


def _emission_byte(bi: DByteInfo, si, k, escaped: bool):
    """Byte ``k`` of the emission of source byte ``si`` (row-aligned)."""
    dev = si.device
    c = _take_rows(bi.b, si)
    u = _take_rows(bi.cls_u, si)
    esc = _take_rows(bi.cls_esc, si)
    unesc = _tab("unesc", dev)[c.to(_I64)]
    if not escaped:
        out = torch.where(esc, unesc, c)
        out = torch.where(u, _utf8_byte(_take_rows(bi.cp, si), _take_rows(bi.ulen, si), k), out)
        return out.to(_U8)
    ci = c.to(_I32)
    is_ctrl = ci < 32
    short = torch.where(is_ctrl, _tab("ctrl_short", dev)[torch.clamp(ci, max=31).to(_I64)], 0)
    long_bytes = torch.where(
        k == 0, ord("\\"), torch.where(
            k == 1, ord("u"), torch.where(
                (k == 2) | (k == 3), ord("0"), torch.where(
                    k == 4, torch.where(ci >= 16, ord("1"), ord("0")),
                    _tab("hex_up", dev)[(ci % 16).to(_I64)].to(_I32)))))
    ctrl_out = torch.where(short != 0, torch.where(k == 0, ord("\\"), short.to(_I32)),
                           long_bytes)
    norm_out = torch.where(ci == ord('"'), torch.where(k == 0, ord("\\"), ord('"')), ci)
    out = torch.where(is_ctrl, ctrl_out, norm_out)
    two = (ci == ord('"')) | (ci == ord("\\"))
    for ch in b"bfnrt":
        two = two | (ci == ch)
    esc_out = torch.where(two, torch.where(k == 0, ord("\\"), ci), unesc.to(_I32))
    esc_out = torch.where((ci == ord('"')) & (k == 1), ord('"'), esc_out)
    out = torch.where(esc, esc_out, out)
    out = torch.where(u, _utf8_byte(_take_rows(bi.cp, si), _take_rows(bi.ulen, si), k).to(_I32),
                      out)
    return out.to(_U8)


def token_tables_device(bi: DByteInfo, kind, start, end):
    """Device port of _token_tables: (len_raw, len_esc int64, has_uni,
    neg0 bool), all [n, T]."""
    L = bi.b.shape[1]
    s64 = start.to(_I64)
    e64 = end.to(_I64)
    is_str = (kind == jt.VALUE_STRING) | (kind == jt.FIELD_NAME)
    ps = torch.clamp(s64 + 1, max=L)
    pe = torch.clamp(e64 - 1, 0, L)
    pay_u = _take_rows(bi.cum_u, pe) - _take_rows(bi.cum_u, ps)
    pay_e = _take_rows(bi.cum_e, pe) - _take_rows(bi.cum_e, ps)
    has_uni = (_take_rows(bi.cum_uni, pe) - _take_rows(bi.cum_uni, ps)) > 0

    span = e64 - s64
    is_int = kind == jt.VALUE_NUMBER_INT
    neg0 = is_int & (span == 2) \
        & (_take_rows(bi.b, torch.clamp(s64, max=L - 1)) == ord("-")) \
        & (_take_rows(bi.b, torch.clamp(s64 + 1, max=L - 1)) == ord("0"))

    one = (kind == jt.START_OBJECT) | (kind == jt.END_OBJECT) | \
        (kind == jt.START_ARRAY) | (kind == jt.END_ARRAY)
    len_raw = torch.zeros(kind.shape, dtype=_I64, device=kind.device)
    len_raw = torch.where(one, 1, len_raw)
    len_raw = torch.where(kind == jt.VALUE_TRUE, 4, len_raw)
    len_raw = torch.where(kind == jt.VALUE_FALSE, 5, len_raw)
    len_raw = torch.where(kind == jt.VALUE_NULL, 4, len_raw)
    len_raw = torch.where(is_int, torch.where(neg0, 1, span), len_raw)
    len_esc = torch.where(one | (kind == jt.VALUE_TRUE) | (kind == jt.VALUE_FALSE)
                          | (kind == jt.VALUE_NULL) | is_int, len_raw, 0)
    len_raw = torch.where(is_str, pay_u, len_raw)
    len_esc = torch.where(is_str, pay_e + 2, len_esc)
    return len_raw, len_esc, has_uni, neg0


def _name_match_one(bi: DByteInfo, kind, start, len_raw, has_uni, end, name: bytes):
    """[n, T] bool: FIELD_NAME token payload unescapes to exactly ``name``.

    Per row: rows whose candidates are escape-free compare bytes at the
    payload start (one [n, L] table of ``len(name)`` shifted compares);
    rows with an escaped same-width candidate walk the unescape emission
    through ``cum_u``.  The walk runs only when some row needs it (one host
    sync), as the JAX package's ``lax.cond``.
    """
    n, T = kind.shape
    L = bi.b.shape[1]
    ok = (kind == jt.FIELD_NAME) & ~has_uni & (len_raw == len(name))
    m = len(name)
    if m == 0:
        return ok
    ps = torch.clamp(start.to(_I64) + 1, max=L)
    raw_w = end.to(_I64) - start.to(_I64) - 2  # quoted payload width
    no_esc = raw_w == m  # every non-unicode escape shrinks 2 raw -> 1 emitted
    need_slow = (ok & ~no_esc).any(1)

    table = torch.ones(bi.b.shape, dtype=torch.bool, device=bi.b.device)
    for q, ch in enumerate(name):
        col = torch.zeros_like(table)
        col[:, : max(L - q, 0)] = bi.b[:, q:] == ch
        table &= col
    fast = ok & no_esc & _take_rows(table, torch.clamp(ps, max=L - 1))
    del table
    if not bool(need_slow.any()):
        return fast
    base = _take_rows(bi.cum_u, ps)
    cu1 = bi.cum_u[:, 1:].contiguous()
    acc = ok
    for q, ch in enumerate(name):
        tgt = base + q
        si = torch.clamp(_searchsorted_rows(cu1, tgt), max=L - 1)
        k = tgt - _take_rows(bi.cum_u, si)
        acc = acc & (_emission_byte(bi, si, k, escaped=False) == ch)
    return torch.where(need_slow[:, None], acc, fast)


def name_matches_device(bi, kind, start, len_raw, has_uni, end, names):
    return [torch.zeros(kind.shape, dtype=torch.bool, device=kind.device) if nm is None
            else _name_match_one(bi, kind, start, len_raw, has_uni, end, nm)
            for nm in names]


# ---------------------------------------------------------------- floats ---

_FLOAT_W = 32  # Double.toString max ~24 chars + quoted-Infinity room


def _float_render(bits):
    """Ryu digits + Java formatting of parsed float bits, with the
    quoted-Infinity quirk (ftos_converter.cuh:1154)."""
    import importlib

    fts = importlib.import_module("spark_rapids_jni_tpu_torch.ops.float_to_string")
    mant = bits & ((1 << 52) - 1)
    expo = (bits >> 52) & 0x7FF
    is_nan = (expo == 0x7FF) & (mant != 0)
    is_inf = (expo == 0x7FF) & (mant == 0)
    is_zero = (expo == 0) & (mant == 0)
    negative = bits < 0
    output, e10 = fts._d2d(bits)
    special_id = fts._special_id_expr(is_nan, is_inf, is_zero, negative)
    padded, lens = fts._emit(output, e10, negative, special_id, is_float=False)
    lens = lens.to(_I64)
    inf = is_inf.to(_I64)

    # quoted-Infinity: shift right by one and wrap in quotes
    out_len = torch.where(is_inf, lens + 2, lens)
    lane = torch.arange(_FLOAT_W, dtype=_I64, device=bits.device)[None, :]
    wide = torch.zeros((padded.shape[0], max(_FLOAT_W, padded.shape[1])), dtype=_U8,
                       device=bits.device)
    wide[:, : padded.shape[1]] = padded
    gathered = _take_rows(wide, torch.clamp(lane - inf[:, None], 0, wide.shape[1] - 1))
    in_text = (lane >= inf[:, None]) & (lane < (lens + inf)[:, None])
    ftext = torch.where(in_text, gathered, 0)
    quote_pos = is_inf[:, None] & ((lane == 0) | (lane == out_len[:, None] - 1))
    ftext = torch.where(quote_pos, ord('"'), ftext).to(_U8)
    return ftext, out_len


def float_texts_device(b, kind, start, end, used):
    """Re-render the FLOAT tokens that ``used`` marks.

    Returns (ftext [nf, _FLOAT_W] uint8, flen [nf] int64, fidx [n, T] int64
    index or -1).  One host sync reads the float count and source width.
    Parsing is the Spark-exact parse with the full-width exponent; rendering
    is the Ryu digit core.
    """
    from spark_rapids_jni_tpu_torch.ops.cast_string_to_float import (
        _SCAN_FIELDS,
        _assemble_device,
        _scan_padded,
    )

    n, T = kind.shape
    L = b.shape[1]
    dev = kind.device
    fmask = (kind == jt.VALUE_NUMBER_FLOAT) & used
    ri, ti = torch.nonzero(fmask, as_tuple=True)
    nf = ri.numel()
    fidx = torch.full((n, T), -1, dtype=_I64, device=dev)
    if nf == 0:
        return (torch.zeros((0, _FLOAT_W), dtype=_U8, device=dev),
                torch.zeros((0,), dtype=_I64, device=dev), fidx)
    fidx[ri, ti] = torch.arange(nf, dtype=_I64, device=dev)
    fs = start[ri, ti].to(_I64)
    flen_src = (end[ri, ti].to(_I64) - fs).to(_I32)
    ws = 1 << max(int(flen_src.max()) - 1, 0).bit_length()
    lane = torch.arange(ws, dtype=_I64, device=dev)[None, :]
    raw = b[ri[:, None], torch.clamp(fs[:, None] + lane, 0, L - 1)]
    raw = torch.where(lane < flen_src[:, None], raw, 0).to(_U8)
    # full-width exponent reading (the 4-digit cap is a cast quirk)
    fields = _scan_padded(raw, flen_src, ws)
    bits, _valid, _exc = _assemble_device({k: v for (k, _), v in zip(_SCAN_FIELDS, fields)})
    ftext, out_len = _float_render(bits)
    return ftext, out_len, fidx


# ---------------------------------------------------------------- render ---


def measure(seg, err, kind, len_raw, len_esc, fidx, flen):
    """Per-segment lengths of packed segments [n, K]: returns (stype, sarg,
    segcum int64 [n, K], out_len int64 [n]); nulled rows measure 0."""
    T = kind.shape[1]
    stype = seg & ((1 << SEG_SHIFT) - 1)
    sarg = seg >> SEG_SHIFT
    targ = torch.clamp(sarg, 0, T - 1)
    nconst = len(_CONSTS)
    slen = torch.where(stype == _SEG_CONST,
                       _tab("const_len", seg.device)[torch.clamp(sarg, 0, nconst - 1).to(_I64)]
                       .to(_I64), 0)
    slen = torch.where(stype == _SEG_RAW_TOK, _take_rows(len_raw, targ), slen)
    slen = torch.where(stype == _SEG_ESC_TOK, _take_rows(len_esc, targ), slen)
    tok_ref = (stype == _SEG_RAW_TOK) | (stype == _SEG_ESC_TOK)
    NF = flen.shape[0]
    if NF:
        f_sel = tok_ref & (_take_rows(kind, targ) == jt.VALUE_NUMBER_FLOAT)
        fi = torch.clamp(_take_rows(fidx, targ), 0, NF - 1)
        slen = torch.where(f_sel, flen[fi], slen)
    segcum = torch.cumsum(slen, 1)
    out_len = torch.where(err, 0, segcum[:, -1])
    return stype, sarg, segcum, out_len


def render_device(bi: DByteInfo, stype, sarg, segcum, out_len, kind, start, tok_tabs,
                  floats, W: int):
    """Materialize output bytes [n, W] from measured segments (device port of
    _render's emission pass).  Rows render in power-of-two width classes of
    their own length (a row's bytes depend on its row alone, so one long row
    widens no short one), in blocks of at most RENDER_CELLS cells; one host
    sync reads the class sizes."""
    n = stype.shape[0]
    dev = stype.device
    out = torch.zeros((n, W), dtype=_U8, device=dev)
    wcls = torch.where(out_len > 0, torch.ceil(torch.log2(
        torch.clamp(out_len, min=1).to(torch.float64))).to(_I64) + 1, 0)
    sizes = torch.bincount(wcls, minlength=2).tolist()
    len_raw, len_esc, neg0 = tok_tabs
    ftext, flen, fidx = floats
    for c, size in enumerate(sizes):
        if c == 0 or size == 0:
            continue
        sel = torch.nonzero(wcls == c).flatten()
        Wc = min(1 << (c - 1), W)
        step = max(1, RENDER_CELLS // Wc)
        for r0 in range(0, size, step):
            rows = sel[r0:r0 + step]
            out[rows, :Wc] = _render_block(
                DByteInfo(*(t[rows] for t in bi)), stype[rows], sarg[rows], segcum[rows],
                out_len[rows], kind[rows], start[rows], len_esc[rows], neg0[rows], ftext, flen,
                fidx[rows], Wc)
    return out


def _render_block(bi, stype, sarg, segcum, out_len, kind, start, len_esc, neg0, ftext,
                  flen, fidx, W):
    n = stype.shape[0]
    T = kind.shape[1]
    L = bi.b.shape[1]
    S2 = stype.shape[1]
    dev = stype.device

    j = torch.arange(W, dtype=_I64, device=dev)[None, :].expand(n, W)
    si = torch.clamp(_searchsorted_rows(segcum, j), max=S2 - 1)
    prev = torch.where(si > 0, _take_rows(segcum, torch.clamp(si - 1, min=0)), 0)
    d = j - prev
    del prev
    st = _take_rows(stype, si)
    sa = _take_rows(sarg, si).to(_I64)
    del si
    ta = torch.clamp(sa, 0, T - 1)
    tk = _take_rows(kind, ta)
    ts = _take_rows(start, ta).to(_I64)

    out = torch.zeros((n, W), dtype=_U8, device=dev)
    cm = st == _SEG_CONST
    const_tab = _tab("const_tab", dev)
    out = torch.where(cm, const_tab.reshape(-1)[
        torch.clamp(sa, 0, len(_CONSTS) - 1) * _CONST_MAXLEN
        + torch.clamp(d, 0, _CONST_MAXLEN - 1)], out)

    is_str = (tk == jt.VALUE_STRING) | (tk == jt.FIELD_NAME)
    is_int = tk == jt.VALUE_NUMBER_INT
    is_float = tk == jt.VALUE_NUMBER_FLOAT
    one_char = (tk == jt.START_OBJECT) | (tk == jt.END_OBJECT) | \
        (tk == jt.START_ARRAY) | (tk == jt.END_ARRAY)
    lit = (tk == jt.VALUE_TRUE) | (tk == jt.VALUE_FALSE) | (tk == jt.VALUE_NULL)
    tokm = (st == _SEG_RAW_TOK) | (st == _SEG_ESC_TOK)
    escm = st == _SEG_ESC_TOK
    del st, cm, tk

    n0 = _take_rows(neg0, ta)
    src_byte = _take_rows(bi.b, torch.clamp(ts + d, 0, L - 1))
    out = torch.where(tokm & is_int, torch.where(n0, ord("0"), src_byte), out)
    out = torch.where(tokm & (one_char | lit), src_byte, out)
    del src_byte, n0, one_char, lit, is_int

    NF = flen.shape[0]
    if NF:
        fi2 = torch.clamp(_take_rows(fidx, ta), 0, NF - 1)
        fbyte = ftext.reshape(-1)[fi2 * ftext.shape[1] + torch.clamp(d, 0, ftext.shape[1] - 1)]
        out = torch.where(tokm & is_float, fbyte, out)
        del fi2, fbyte

    strm = tokm & is_str
    if bool(strm.any()):
        ps = torch.clamp(ts + 1, max=L)
        # raw (unescape) variant
        tgt = _take_rows(bi.cum_u, ps) + d
        siU = torch.clamp(_searchsorted_rows(bi.cum_u[:, 1:], tgt), max=L - 1)
        kU = tgt - _take_rows(bi.cum_u, siU)
        out = torch.where(strm & ~escm, _emission_byte(bi, siU, kU, False), out)
        del tgt, siU, kU
        # escaped variant: quote + payload + quote
        elen = _take_rows(len_esc, ta)
        quote = (d == 0) | (d == elen - 1)
        tgt_e = torch.clamp(_take_rows(bi.cum_e, ps) + (d - 1), min=0)
        siE = torch.clamp(_searchsorted_rows(bi.cum_e[:, 1:], tgt_e), max=L - 1)
        kE = tgt_e - _take_rows(bi.cum_e, siE)
        ebyte = _emission_byte(bi, siE, kE, True)
        out = torch.where(strm & escm, torch.where(quote, ord('"'), ebyte), out)
    return torch.where(j < out_len[:, None], out, 0).to(_U8)
