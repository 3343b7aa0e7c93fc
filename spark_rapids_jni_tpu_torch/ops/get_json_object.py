"""Spark ``get_json_object``: JSON-path extraction over string columns
(PyTorch port of ``ops/get_json_object.py``).

Parity target: ``JSONUtils.getJsonObject`` (JSONUtils.java:47) over
``spark_rapids_jni::get_json_object`` (get_json_object.cu:360 evaluate_path,
:891 kernel) with the json_parser.cuh:220 tokenizer semantics.  The reference
runs one sequential pushdown parser per row (one GPU thread each); here the
op runs in three stages, as in the JAX package:

1. **Tokenize** (ops/json_tokenizer.py): whole byte rectangles -> validated
   per-row token streams with O(1) open/close match indices.
2. **Path evaluation**: a *lockstep token machine*: every row advances
   through its token stream in parallel, one token (or one frame return) per
   step, with vectorized frame/generator stacks.  This is the explicit-stack
   form of evaluate_path's recursion (cases numbered as in
   get_json_object.cu:360-394); subtree skips are O(1) jumps through the
   tokenizer's match indices.
3. **Render**: each step emits up to two *segments* (constant bytes,
   raw/escaped string payloads, re-rendered numbers); per-byte
   escape/unescape emission tables + batched binary searches turn the
   segment streams into the output chars buffer.

Two arms, picked by ``config.json_device_render``: ``"auto"`` gives a CUDA
column the device arm (tokenize, the torch machine of ops/json_scan.py and
the render of ops/json_render_device.py, all on the card) and a CPU column
the host arm (the numpy machine and render, copied from the JAX package);
``True``/``False`` pin an arm.  Neither falls back to the other.

The host machine is *adaptive*: rows are grouped into token-count
sub-buckets (columnar/buckets.count_subbuckets) so short rows never pay the
bucket-wide step cap, and once at least half the rows of a sub-bucket
finish, state compacts down to the survivors (``json_compact``).  Rows that
exhaust the ``2T + json_step_margin`` step cap are nulled AND counted through
the obs seam (``seam(OP, "json:step_cap_truncated:<k>")``), so truncation is
observable instead of indistinguishable from a genuine null.

The device arm splits a length bucket into row chunks of at most
``CHUNK_BYTES`` padded bytes (the card's memory bound; the JAX package runs
whole buckets).  A chunk's token capacity ``T`` can then be below its
bucket's, which changes no output: a row needs at most ``2 * n_tokens + 2``
machine steps and ``n_tokens`` frames, and both caps (``2T + 40`` steps,
``min(86, T + 3)`` frames) stay above that for any ``T >= n_tokens``.

:func:`get_json_object_multiple_paths` evaluates P paths against ONE
tokenization: token streams, byte tables, float re-renders and per-name
match tables (deduplicated across paths) are built once per bucket and
fanned out to P machines (one stacked machine on the device arm).

Spark bug-compat quirks preserved (same set as tests/json_oracle.py):
``\\uXXXX`` emits decoded UTF-8 raw even in quoted output; a field name
containing ``\\u`` never matches a path name; ``-0`` normalizes to ``0``;
floats re-render via Java Double.toString with quoted ``"Infinity"``
(ftos_converter.cuh:1154); root-level trailing garbage is ignored; an
out-of-range array index drains tokens to the *next* close bracket at any
depth before returning (the reference's loop structure does the same).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.columnar.buckets import (
    PaddedBucket,
    count_subbuckets,
    padded_buckets,
    strings_from_buckets,
)
from spark_rapids_jni_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_jni_tpu_torch.columnar.dtypes import FLOAT64
from spark_rapids_jni_tpu_torch.obs.seam import OP, seam
from spark_rapids_jni_tpu_torch.ops import json_tokenizer as jt

__all__ = [
    "get_json_object",
    "get_json_object_multiple_paths",
    "parse_path",
    "phase_times",
    "reset_phase_times",
    "truncation_count",
    "WILDCARD",
    "INDEX",
    "NAMED",
    "MAX_PATH_DEPTH",
]

# path instruction types (JSONUtils.PathInstructionJni)
WILDCARD, INDEX, NAMED = 0, 1, 2
_P_END = 3  # sentinel: past the last path instruction

MAX_PATH_DEPTH = 16  # get_json_object.cu:51

# write styles (get_json_object.cu write_style)
_RAW, _QUOTED, _FLATTEN = 0, 1, 2

# frame cases (numbered after evaluate_path's case labels)
_F_CASE2, _F_CASE4, _F_CASE5, _F_CASE6, _F_CASE7, _F_CASE8, _F_COPY = range(7)

# frame sub-states
_SUB_NONE, _SUB_ENTERING, _SUB_WAITING, _SUB_DRAIN = 0, 1, 2, 3

# segment types (int/float tokens travel as RAW/ESC and are remapped by kind
# in _render — no dedicated segment types)
_SEG_NONE, _SEG_CONST, _SEG_RAW_TOK, _SEG_ESC_TOK = 0, 1, 2, 3
_SEG_COND_OPEN, _SEG_COND_CLOSE = 4, 5

# constant-byte table (segment arg for _SEG_CONST)
_CONSTS = [b"", b",", b":", b"[", b"]", b"{", b"}", b"true", b"false",
           b"null", b"0", b",["]
_C_EMPTY, _C_COMMA, _C_COLON, _C_OPEN_ARR, _C_CLOSE_ARR = 0, 1, 2, 3, 4
_C_OPEN_OBJ, _C_CLOSE_OBJ, _C_TRUE, _C_FALSE, _C_NULL, _C_ZERO = 5, 6, 7, 8, 9, 10
_C_COMMA_OPEN = 11
_CONST_MAXLEN = max(len(c) for c in _CONSTS)
_CONST_TAB = np.zeros((len(_CONSTS), _CONST_MAXLEN), np.uint8)
_CONST_LEN = np.zeros((len(_CONSTS),), np.int32)
for _i, _c in enumerate(_CONSTS):
    _CONST_TAB[_i, : len(_c)] = np.frombuffer(_c, np.uint8)
    _CONST_LEN[_i] = len(_c)

_SCALARS = (jt.VALUE_STRING, jt.VALUE_NUMBER_INT, jt.VALUE_NUMBER_FLOAT,
            jt.VALUE_TRUE, jt.VALUE_FALSE, jt.VALUE_NULL)

# simple-escape map: source escape char -> unescaped byte
_UNESC = np.zeros(256, np.uint8)
for _src, _dst in [(ord('"'), ord('"')), (ord("'"), ord("'")),
                   (ord("\\"), ord("\\")), (ord("/"), ord("/")),
                   (ord("b"), 8), (ord("f"), 12), (ord("n"), 10),
                   (ord("r"), 13), (ord("t"), 9)]:
    _UNESC[_src] = _dst
# ctrl-char short escapes: code -> second byte, 0 => long \u00XX form
_CTRL_SHORT = np.zeros(32, np.uint8)
for _code, _ch in [(8, ord("b")), (9, ord("t")), (10, ord("n")),
                   (12, ord("f")), (13, ord("r"))]:
    _CTRL_SHORT[_code] = _ch
_HEX_UP = np.frombuffer(b"0123456789ABCDEF", np.uint8)



# padded bytes per row chunk of the device arm (see the module doc)
CHUNK_BYTES = 1 << 28


# ---------------------------------------------------------------------------
# observability: phase wall-clock attribution + step-cap truncation counter
# ---------------------------------------------------------------------------

_PHASE_TIMES: Dict[str, float] = {"tokenize": 0.0, "evaluate": 0.0,
                                  "render": 0.0}
_COUNTERS: Dict[str, int] = {"step_cap_truncated": 0}
# get_json_object may run from several threads at once; the read-modify-write
# accumulator updates must not race
_OBS_LOCK = threading.Lock()


def reset_phase_times() -> None:
    """Zero the per-phase wall-clock accumulators."""
    with _OBS_LOCK:
        for k in _PHASE_TIMES:
            _PHASE_TIMES[k] = 0.0


def phase_times() -> Dict[str, float]:
    """Seconds spent per pipeline phase since the last reset.

    Host arm: exact wall clock per phase.  Device arm: CUDA work is
    asynchronous, so time lands on the phase whose sync point materialized
    the work (still attributable, just coarser).
    """
    with _OBS_LOCK:
        return dict(_PHASE_TIMES)


def truncation_count() -> int:
    """Process-lifetime count of rows nulled by the machine step cap."""
    with _OBS_LOCK:
        return _COUNTERS["step_cap_truncated"]


@contextlib.contextmanager
def _phase(key: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _OBS_LOCK:
            _PHASE_TIMES[key] += dt


def _note_truncation(k: int) -> None:
    """Surface step-cap truncation through the obs seam.

    A row that exhausts the step cap is nulled: indistinguishable, at the
    column level, from a genuine null result.  This crossing makes the
    difference observable: the fault injector can target it, the profiler
    records a cumulative counter, and the crossing name carries the per-call
    count.
    """
    if k <= 0:
        return
    with _OBS_LOCK:
        _COUNTERS["step_cap_truncated"] += int(k)
        total = _COUNTERS["step_cap_truncated"]
    with seam(OP, f"json:step_cap_truncated:{int(k)}"):
        from spark_rapids_jni_tpu_torch.obs.profiler import Profiler

        Profiler.counter("json.step_cap_truncated", total)


def parse_path(path: str) -> List[tuple]:
    """Parse ``$.a[2].*``-style JSON paths into instruction tuples.

    Mirrors Spark's JsonPathParser grammar subset the plugin passes down:
    ``$`` root, ``.name`` / ``['name']`` named fields, ``[n]`` index,
    ``.*`` / ``[*]`` wildcard.  Raises ValueError on malformed paths.
    """
    if not path.startswith("$"):
        raise ValueError(f"JSON path must start with $: {path!r}")
    out: List[tuple] = []
    i = 1
    while i < len(path):
        c = path[i]
        if c == ".":
            i += 1
            if i < len(path) and path[i] == "*":
                out.append((WILDCARD,))
                i += 1
                continue
            j = i
            while j < len(path) and path[j] not in ".[":
                j += 1
            if j == i:
                raise ValueError(f"empty field name in {path!r}")
            out.append((NAMED, path[i:j].encode()))
            i = j
        elif c == "[":
            if path.startswith("['", i):
                # non-greedy \['(.*?)'\] as in Spark's JsonPathParser:
                # names may contain ']'
                j = path.find("']", i + 2)
                if j < 0:
                    raise ValueError(
                        f"unterminated ['name'] selector in {path!r}")
                out.append((NAMED, path[i + 2 : j].encode()))
                i = j + 2  # past the closing '] pair
                continue
            j = path.find("]", i)
            if j < 0:
                raise ValueError(f"unterminated [...] selector in {path!r}")
            inner = path[i + 1 : j]
            if inner == "*":
                out.append((WILDCARD,))
            elif inner == "":
                raise ValueError(f"empty bracket selector in {path!r}")
            elif inner.startswith("-"):
                raise ValueError(f"negative array index in {path!r}")
            elif not (inner.isascii() and inner.isdigit()):
                # int() would accept '+1', ' 2', '1_0' — Spark's parser
                # grammar takes plain digits only
                raise ValueError(f"invalid array index {inner!r} in {path!r}")
            else:
                out.append((INDEX, int(inner)))
            i = j + 1
        else:
            raise ValueError(f"unexpected {c!r} in JSON path {path!r}")
    return out


def _batched_searchsorted_right(a: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Per-row ``searchsorted(a[r], v[r], side='right')``.

    ``a``: [n, m] row-sorted; ``v``: [n, q].  Returns int32 [n, q].  One
    ``np.searchsorted`` over the rows laid end to end, each row lifted by
    ``r * span`` (``span`` exceeds every value's range), so no row's values
    interleave with another's.
    """
    n, m = a.shape
    if n == 0 or m == 0 or v.size == 0:
        return np.zeros(v.shape, np.int32)
    lo = min(int(a.min()), int(v.min()))
    span = max(int(a.max()), int(v.max())) - lo + 1
    lift = (np.arange(n, dtype=np.int64) * span - lo)[:, None]
    flat = np.searchsorted((a.astype(np.int64) + lift).ravel(),
                           (v.astype(np.int64) + lift).ravel(), side="right")
    return (flat.reshape(v.shape) - np.arange(n, dtype=np.int64)[:, None] * m).astype(np.int32)


@dataclasses.dataclass
class _ByteInfo:
    """Per-byte escape/unescape emission tables for one bucket."""

    b: np.ndarray          # [n, L] uint8 source bytes
    cls_bs: np.ndarray     # backslash that leads an escape
    cls_esc: np.ndarray    # the escaped char (2nd byte of a simple escape)
    cls_u: np.ndarray      # the 'u' of a \\uXXXX escape
    cls_hex: np.ndarray    # one of the 4 hex digits of a \\u escape
    cp: np.ndarray         # [n, L] int32 codepoint (at the 'u' position)
    ulen: np.ndarray       # [n, L] utf8 byte length of cp (1..3)
    len_u: np.ndarray      # unescape emission length per byte
    len_e: np.ndarray      # escape emission length per byte
    cum_u: np.ndarray      # [n, L+1] exclusive prefix sums
    cum_e: np.ndarray
    cum_uni: np.ndarray    # [n, L+1] prefix count of \\u escapes
    cum_bs: np.ndarray     # [n, L+1] prefix count of escape-leading backslashes



def _byte_info(b_t: torch.Tensor, str_state: torch.Tensor) -> _ByteInfo:
    """Per-byte tables for a bucket (numpy, on the host), from its bytes and
    the tokenizer's string-automaton state AFTER each byte
    (TokenStream.str_state)."""
    st_after = str_state.cpu().numpy()
    st_before = np.zeros_like(st_after)
    st_before[:, 1:] = st_after[:, :-1]
    b = b_t.cpu().numpy()
    n, L = b.shape

    in_dq = (st_before == jt._S_DQ)
    in_sq = (st_before == jt._S_SQ)
    cls_esc_all = (st_before == jt._S_DQE) | (st_before == jt._S_SQE)
    cls_bs = (in_dq | in_sq) & (b == ord("\\"))
    cls_u = cls_esc_all & (b == ord("u"))
    cls_esc = cls_esc_all & ~cls_u
    cls_hex = np.zeros_like(cls_u)
    for k in range(1, 5):
        cls_hex[:, k:] |= cls_u[:, :-k]
    close_q = (in_dq & (b == ord('"'))) | (in_sq & (b == ord("'")))

    # codepoint at 'u' positions from the following 4 hex digits
    hexval = np.zeros(b.shape, np.int32)
    d = b.astype(np.int32)
    hexval = np.where((b >= ord("0")) & (b <= ord("9")), d - ord("0"), hexval)
    hexval = np.where((b >= ord("a")) & (b <= ord("f")), d - ord("a") + 10, hexval)
    hexval = np.where((b >= ord("A")) & (b <= ord("F")), d - ord("A") + 10, hexval)
    cp = np.zeros(b.shape, np.int32)
    for k in range(1, 5):
        sh = np.zeros(b.shape, np.int32)
        sh[:, :-k] = hexval[:, k:]
        cp |= sh << (4 * (4 - k))
    ulen = np.where(cp < 0x80, 1, np.where(cp < 0x800, 2, 3)).astype(np.int32)

    normal = (in_dq | in_sq) & ~cls_bs & ~close_q & ~cls_hex
    is_ctrl = normal & (b < 32)
    short_ctrl = is_ctrl & (_CTRL_SHORT[np.minimum(b, 31)] != 0)

    len_u = np.zeros(b.shape, np.int32)
    len_u = np.where(normal, 1, len_u)
    len_u = np.where(cls_esc, 1, len_u)
    len_u = np.where(cls_u, ulen, len_u)

    len_e = np.zeros(b.shape, np.int32)
    len_e = np.where(normal, 1, len_e)
    len_e = np.where(normal & (b == ord('"')), 2, len_e)
    len_e = np.where(short_ctrl, 2, len_e)
    len_e = np.where(is_ctrl & ~short_ctrl, 6, len_e)
    two_byte = (b == ord('"')) | (b == ord("\\"))
    for ch in b"bfnrt":
        two_byte |= b == ch
    len_e = np.where(cls_esc, np.where(two_byte, 2, 1), len_e)
    len_e = np.where(cls_u, ulen, len_e)

    def excl_cum(x):
        out = np.zeros((n, L + 1), np.int64)
        np.cumsum(x, axis=1, out=out[:, 1:])
        return out

    return _ByteInfo(
        b=b, cls_bs=cls_bs, cls_esc=cls_esc, cls_u=cls_u, cls_hex=cls_hex,
        cp=cp, ulen=ulen, len_u=len_u, len_e=len_e,
        cum_u=excl_cum(len_u), cum_e=excl_cum(len_e),
        cum_uni=excl_cum(cls_u.astype(np.int64)),
        cum_bs=excl_cum(cls_bs.astype(np.int64)),
    )


def _slice_byte_info(bi: _ByteInfo, sel: np.ndarray) -> _ByteInfo:
    """Row-subset view of a bucket's byte tables (token-count sub-buckets)."""
    return _ByteInfo(**{
        f.name: getattr(bi, f.name)[sel] for f in dataclasses.fields(_ByteInfo)
    })


def _utf8_byte(cp: np.ndarray, ulen: np.ndarray, k: np.ndarray) -> np.ndarray:
    """k-th UTF-8 byte of codepoint cp (json_parser.cuh:903 encoding)."""
    b1 = np.where(ulen == 1, cp,
                  np.where(ulen == 2, 0xC0 | (cp >> 6), 0xE0 | (cp >> 12)))
    b2 = np.where(ulen == 2, 0x80 | (cp & 0x3F), 0x80 | ((cp >> 6) & 0x3F))
    b3 = 0x80 | (cp & 0x3F)
    return np.where(k == 0, b1, np.where(k == 1, b2, b3)).astype(np.uint8)


def _emission_byte(bi: _ByteInfo, ri: np.ndarray, si: np.ndarray,
                   k: np.ndarray, escaped: bool) -> np.ndarray:
    """Byte ``k`` of source byte ``(ri, si)``'s emission."""
    c = bi.b[ri, si]
    if not escaped:
        out = c.copy()
        esc = bi.cls_esc[ri, si]
        out = np.where(esc, _UNESC[c], out)
        u = bi.cls_u[ri, si]
        out = np.where(u, _utf8_byte(bi.cp[ri, si], bi.ulen[ri, si], k), out)
        return out.astype(np.uint8)
    # escaped (quoted) emission
    is_ctrl = c < 32
    short = np.where(is_ctrl, _CTRL_SHORT[np.minimum(c, 31)], 0)
    # long ctrl: \ u 0 0 H L
    long_bytes = np.select(
        [k == 0, k == 1, k == 2, k == 3, k == 4],
        [ord("\\"), ord("u"), ord("0"), ord("0"),
         np.where(c >= 16, ord("1"), ord("0"))],
        default=_HEX_UP[c % 16],
    )
    ctrl_out = np.where(
        short != 0, np.where(k == 0, ord("\\"), short), long_bytes
    )
    # normal char: '"' -> \" ; else itself
    norm_out = np.where(
        c == ord('"'), np.where(k == 0, ord("\\"), ord('"')), c
    )
    out = np.where(is_ctrl, ctrl_out, norm_out)
    # simple escape char: 2-byte forms keep backslash, 1-byte map
    esc = bi.cls_esc[ri, si]
    two = (c == ord('"')) | (c == ord("\\"))
    for ch in b"bfnrt":
        two = two | (c == ch)
    esc_out = np.where(two, np.where(k == 0, ord("\\"), c), _UNESC[c])
    # \" is backslash then quote; \\ is backslash backslash; \b.. keep char
    esc_out = np.where((c == ord('"')) & (k == 1), ord('"'), esc_out)
    out = np.where(esc, esc_out, out)
    u = bi.cls_u[ri, si]
    out = np.where(u, _utf8_byte(bi.cp[ri, si], bi.ulen[ri, si], k), out)
    return out.astype(np.uint8)


def _token_tables(bi: _ByteInfo, kind, start, end):
    """Per-token emission lengths for raw and escaped variants, plus flags."""
    n, T = kind.shape
    s64 = start.astype(np.int64)
    e64 = end.astype(np.int64)
    rows = np.arange(n, dtype=np.int64)[:, None]
    L = bi.b.shape[1]

    is_str = (kind == jt.VALUE_STRING) | (kind == jt.FIELD_NAME)
    ps = np.minimum(s64 + 1, L)  # payload start (skip quote)
    pe = np.clip(e64 - 1, 0, L)  # payload end (before close quote)
    pay_u = bi.cum_u[rows, pe] - bi.cum_u[rows, ps]
    pay_e = bi.cum_e[rows, pe] - bi.cum_e[rows, ps]
    has_uni = (bi.cum_uni[rows, pe] - bi.cum_uni[rows, ps]) > 0

    span = e64 - s64
    is_int = kind == jt.VALUE_NUMBER_INT
    # -0 normalization (json_parser.cuh number copy: sign dropped for -0)
    neg0 = is_int & (span == 2) & (bi.b[rows, np.minimum(s64, L - 1)] == ord("-")) \
        & (bi.b[rows, np.minimum(s64 + 1, L - 1)] == ord("0"))

    len_raw = np.zeros((n, T), np.int64)
    len_esc = np.zeros((n, T), np.int64)
    one = (kind == jt.START_OBJECT) | (kind == jt.END_OBJECT) | \
        (kind == jt.START_ARRAY) | (kind == jt.END_ARRAY)
    len_raw = np.where(one, 1, len_raw)
    len_raw = np.where(kind == jt.VALUE_TRUE, 4, len_raw)
    len_raw = np.where(kind == jt.VALUE_FALSE, 5, len_raw)
    len_raw = np.where(kind == jt.VALUE_NULL, 4, len_raw)
    len_raw = np.where(is_int, np.where(neg0, 1, span), len_raw)
    len_esc = np.where(one | (kind == jt.VALUE_TRUE) | (kind == jt.VALUE_FALSE)
                       | (kind == jt.VALUE_NULL) | is_int, len_raw, len_esc)
    len_raw = np.where(is_str, pay_u, len_raw)
    len_esc = np.where(is_str, pay_e + 2, len_esc)
    return len_raw, len_esc, has_uni, neg0



def _float_texts(bi: _ByteInfo, kind, start, end, used=None):
    """Rendered Java Double.toString text per FLOAT token (host).

    Returns (ftext [nf, W] uint8, flen [nf], fidx [n, T] index or -1).
    Infinity renders quoted (ftos_converter.cuh:1154 quirk).  ``used``
    ([n, T] bool) restricts the build to tokens actually referenced by
    output segments.
    """
    from spark_rapids_jni_tpu_torch.ops.float_to_string import float_to_string

    n, T = kind.shape
    fmask = kind == jt.VALUE_NUMBER_FLOAT
    if used is not None:
        fmask = fmask & used
    ri, ti = np.nonzero(fmask)
    fidx = np.full((n, T), -1, np.int64)
    if len(ri) == 0:
        return np.zeros((0, 1), np.uint8), np.zeros((0,), np.int64), fidx
    nf = len(ri)
    fidx[ri, ti] = np.arange(nf)
    # gather each float's text into a padded byte matrix, parse via numpy's
    # bytes->float64 cast (correctly-rounded strtod, vectorized)
    fs = start[ri, ti].astype(np.int64)
    fe = end[ri, ti].astype(np.int64)
    wsrc = max(int((fe - fs).max()), 1)
    L = bi.b.shape[1]
    lane = np.arange(wsrc, dtype=np.int64)[None, :]
    raw = bi.b[ri[:, None], np.clip(fs[:, None] + lane, 0, L - 1)]
    raw = np.where(lane < (fe - fs)[:, None], raw, 0)
    vals = raw.view(f"S{wsrc}").reshape(nf).astype(np.float64)
    # a CPU column: float_to_string's numpy twin under "auto"
    sc = float_to_string(Column(torch.from_numpy(vals.view(np.int64).copy()), None, FLOAT64))
    offs = sc.offsets.cpu().numpy().astype(np.int64)
    chars = sc.chars.cpu().numpy()
    flen = offs[1:] - offs[:-1]
    is_inf = np.isinf(vals)
    out_len = np.where(is_inf, flen + 2, flen)  # quoted "Infinity" quirk
    W = max(int(out_len.max()), 1)
    lane = np.arange(W, dtype=np.int64)[None, :]
    src = offs[:-1, None] + lane - is_inf[:, None]  # shift 1 for open quote
    gathered = chars[np.clip(src, 0, max(len(chars) - 1, 0))]
    in_text = (lane >= is_inf[:, None]) & (lane < (flen + is_inf)[:, None])
    ftext = np.where(in_text, gathered, 0).astype(np.uint8)
    quote_pos = is_inf[:, None] & ((lane == 0) | (lane == out_len[:, None] - 1))
    ftext = np.where(quote_pos, ord('"'), ftext)
    return ftext, out_len, fidx


def _name_matches(bi: _ByteInfo, kind, start, end, names: Sequence[bytes],
                  len_raw, has_uni, cache: Optional[dict] = None):
    """[n, T] bool per path name: token payload unescapes to exactly name.

    Implements field_matches (get_json_object.cu / json_parser.cuh) including
    the \\u-never-matches quirk.  Work is restricted to *candidate* tokens
    (FIELD_NAME, right unescaped length, no \\u): escape-free payloads —
    the overwhelming majority — compare by direct byte gather; only
    payloads containing a backslash walk the per-byte emission tables.
    ``cache`` (name bytes -> table) deduplicates across a multi-path call's
    shared levels.
    """
    n, T = kind.shape
    L = bi.b.shape[1]
    # FIELD_NAME only: the machine consumes name matches solely at the
    # object-field step (CASE4 reads name_match at a FIELD_NAME token),
    # and the device matcher (json_render_device.py _name_match_one) is
    # narrowed the same way — the fuzz tier asserts host/device parity
    # on these tables, so the gates must not diverge.
    is_str = kind == jt.FIELD_NAME
    out = []
    for name in names:
        if name is None:
            out.append(np.zeros((n, T), bool))
            continue
        if cache is not None and name in cache:
            out.append(cache[name])
            continue
        m = len(name)
        ok = is_str & ~has_uni & (len_raw == m)
        ri, ti = np.nonzero(ok)
        if m > 0 and len(ri):
            nb = np.frombuffer(name, np.uint8)
            s64 = start[ri, ti].astype(np.int64)
            ps = np.minimum(s64 + 1, L)       # payload start (skip quote)
            pe = np.clip(end[ri, ti].astype(np.int64) - 1, 0, L)
            esc_free = (bi.cum_bs[ri, pe] - bi.cum_bs[ri, ps]) == 0
            good = np.zeros(len(ri), bool)
            f = np.nonzero(esc_free)[0]
            if len(f):
                # no backslash in the payload -> unescaped payload IS the
                # source bytes; len_raw == m already pinned the width
                lane = np.arange(m, dtype=np.int64)[None, :]
                src = np.minimum(ps[f, None] + lane, L - 1)
                good[f] = (bi.b[ri[f, None], src] == nb[None, :]).all(axis=1)
            s = np.nonzero(~esc_free)[0]
            if len(s):
                rs = ri[s]
                base = bi.cum_u[rs, ps[s]]    # output offset of payload start
                acc = np.ones(len(s), bool)
                cu = bi.cum_u[rs]             # [ns, L+1]
                for q in range(m):
                    tgt = (base + q)[:, None]
                    si = np.minimum(
                        _batched_searchsorted_right(cu[:, 1:], tgt), L - 1)
                    k = tgt - cu[np.arange(len(s))[:, None], si]
                    got = _emission_byte(
                        bi, np.broadcast_to(rs[:, None], si.shape), si, k,
                        escaped=False)
                    acc = acc & (got[:, 0] == nb[q])
                good[s] = acc
            ok[ri, ti] = good
        out.append(ok)
        if cache is not None:
            cache[name] = ok
    return out


class _Machine:
    """Vectorized lockstep evaluator for one (sub-)bucket (numpy, host).

    Mirrors the recursive oracle (tests/json_oracle.py _evaluate) as an
    explicit stack machine; one scan step = one token consumed or one frame
    return processed, across all *active* rows simultaneously.  Rows that
    finish are compacted away (``json_compact``): when at least half the
    current rows are done, state gathers down to the survivors and a row
    map carries their identity, so per-step cost tracks the live frontier
    instead of the original row count.  Per-step segments record their row
    map; :meth:`segment_tables` scatters them back into original-row-id
    space, which makes compaction invisible to the renderer.
    """

    def __init__(self, kind, match, ntok, ok, path_types, path_args,
                 name_match, *, compact=True, step_margin=40):
        self.kind = kind
        self.match = match
        self.ntok = ntok
        n, T = kind.shape
        self.n, self.T = n, T
        self.n0 = n                       # machine-entry row count
        self.compact = compact
        self.step_margin = step_margin
        P = len(path_types)
        self.ptype = np.asarray(list(path_types) + [_P_END], np.int32)
        self.parg = np.asarray(
            [a if isinstance(a, int) else 0 for a in path_args] + [0], np.int64
        )
        # [levels, n, T] stacked name-match tables (one gather per step
        # instead of a per-level python scan)
        self.nm_stack = (np.stack(name_match) if name_match
                         else np.zeros((0, n, T), bool))

        F = min(jt.MAX_DEPTH + MAX_PATH_DEPTH + 6, T + 3)
        G = min(MAX_PATH_DEPTH + 2, F)
        self.F, self.G = F, G
        self.rowmap = np.arange(n, dtype=np.int64)  # current -> entry row id
        self._rows = np.arange(n, dtype=np.int64)   # cached arange(cur_n)
        self.tcur = np.zeros((n,), np.int64)
        self.err = ~ok.copy()
        self.done = np.zeros((n,), bool)
        self.dirty_root = np.zeros((n,), np.int64)
        self.ret_valid = np.zeros((n,), bool)
        self.ret_dirty = np.zeros((n,), np.int64)
        self.fp = np.full((n,), -1, np.int64)  # -1 => root call pending
        self.f_case = np.zeros((n, F), np.int8)
        self.f_path = np.zeros((n, F), np.int32)
        self.f_style = np.zeros((n, F), np.int8)
        self.f_dirty = np.zeros((n, F), np.int64)
        self.f_sub = np.zeros((n, F), np.int8)
        self.f_aux = np.zeros((n, F), np.int64)   # remaining / end_tok / open step
        self.f_flag = np.zeros((n, F), bool)      # case6 need_comma / case8 with_wc
        self.g_depth = np.zeros((n, G), np.int64)
        self.g_empty = np.ones((n, G), bool)
        self.gp = np.zeros((n,), np.int64)
        self.entered_root = np.zeros((n,), bool)
        # entry-row-space results (banked as rows compact away)
        self.err_out = np.zeros((n,), bool)
        self.dirty_out = np.zeros((n,), np.int64)
        self.segs: List[tuple] = []  # per step: (rowmap, [m, 2, 2])
        # deferred case-6 open resolutions: (entry rows, open step, const id)
        self.patches: List[tuple] = []

    # -- small helpers ----------------------------------------------------
    def _set_frame(self, mask, field, val):
        arr = getattr(self, field)
        rows = np.nonzero(mask)[0]
        arr[rows, self.fp[rows]] = val[rows] if isinstance(val, np.ndarray) else val

    def _top(self, field):
        arr = getattr(self, field)
        return arr[self._rows, np.clip(self.fp, 0, self.F - 1)]

    def _gen_top(self, field):
        arr = getattr(self, field)
        return arr[self._rows, np.clip(self.gp, 0, self.G - 1)]

    def _set_gen(self, mask, field, val):
        arr = getattr(self, field)
        rows = np.nonzero(mask)[0]
        arr[rows, self.gp[rows]] = val[rows] if isinstance(val, np.ndarray) else val

    _STATE_FIELDS = ("tcur", "err", "done", "dirty_root", "ret_valid",
                     "ret_dirty", "fp", "f_case", "f_path", "f_style",
                     "f_dirty", "f_sub", "f_aux", "f_flag", "g_depth",
                     "g_empty", "gp", "entered_root", "kind", "match",
                     "ntok", "rowmap")

    def _bank(self, sel):
        """Record final results for current rows ``sel`` (entry space)."""
        tgt = self.rowmap[sel]
        self.err_out[tgt] = self.err[sel]
        self.dirty_out[tgt] = self.dirty_root[sel]

    def _compact(self, keep):
        """Gather machine state down to the rows still running."""
        fin = np.nonzero(~keep)[0]
        self._bank(fin)
        sel = np.nonzero(keep)[0]
        for f in self._STATE_FIELDS:
            setattr(self, f, getattr(self, f)[sel])
        self.nm_stack = self.nm_stack[:, sel]
        self.n = len(sel)
        self._rows = np.arange(self.n, dtype=np.int64)

    def run(self):
        """Step to quiescence; returns the step-cap truncation count.

        Populates ``err_out`` / ``dirty_out`` (entry row space) and the
        per-step segment record consumed by :meth:`segment_tables`.
        """
        S = max(2 * self.T + self.step_margin, 1)
        for s in range(S):
            live = ~(self.done | self.err)
            n_live = int(np.count_nonzero(live))
            if n_live == 0:
                break
            if self.compact and self.n >= 64 and 2 * n_live <= self.n:
                self._compact(live)
            self._step(s)
        # rows that exhausted the step cap: nulled, but observably so
        trunc = ~(self.done | self.err)
        n_trunc = int(np.count_nonzero(trunc))
        self.err |= trunc
        self._bank(self._rows)
        return n_trunc

    def segment_tables(self):
        """Scatter per-step segments back to entry-row space.

        Returns ``(stype, sarg)`` as [n0, 2*steps] int32 — compaction and
        sub-bucketing are invisible past this point.  Case-6 conditional
        opens recorded in ``patches`` resolve here; opens whose close never
        ran (err/truncated rows) stay _SEG_COND_OPEN and are dropped.
        """
        S = len(self.segs)
        stype = np.zeros((self.n0, 2 * max(S, 1)), np.int32)
        sarg = np.zeros_like(stype)
        for s, (rmap, seg) in enumerate(self.segs):
            stype[rmap, 2 * s] = seg[:, 0, 0]
            sarg[rmap, 2 * s] = seg[:, 0, 1]
            stype[rmap, 2 * s + 1] = seg[:, 1, 0]
            sarg[rmap, 2 * s + 1] = seg[:, 1, 1]
        for rows, g, const_id in self.patches:
            stype[rows, 2 * g] = _SEG_CONST
            sarg[rows, 2 * g] = const_id
        unresolved = stype == _SEG_COND_OPEN
        stype = np.where(unresolved, _SEG_NONE, stype)
        return stype, sarg

    def _step(self, s):
        n = self.n
        rows = self._rows
        seg = np.zeros((n, 2, 2), np.int32)  # slots x (type, arg)
        active = ~self.done & ~self.err

        # ---- 1) process pending returns ----------------------------------
        retm = active & self.ret_valid
        if retm.any():
            at_root = retm & (self.fp < 0)
            self.done |= at_root
            self.dirty_root = np.where(at_root, self.ret_dirty, self.dirty_root)
            fr = retm & ~at_root
            if fr.any():
                case = self._top("f_case")
                sub = self._top("f_sub")
                # accumulating cases
                acc = fr & np.isin(case, (_F_CASE2, _F_CASE5, _F_CASE6, _F_CASE7))
                self._set_frame(acc, "f_dirty", self._top("f_dirty") + self.ret_dirty)
                c4 = fr & (case == _F_CASE4) & (sub == _SUB_WAITING)
                bad = c4 & (self.ret_dirty == 0)
                self.err |= bad
                good = c4 & ~bad
                self._set_frame(good, "f_dirty", self.ret_dirty)
                self._set_frame(good, "f_flag", True)  # found
                self._set_frame(good, "f_sub", _SUB_NONE)
                c8 = fr & (case == _F_CASE8) & (sub == _SUB_WAITING)
                self._set_frame(c8, "f_dirty", self.ret_dirty)
                self._set_frame(c8, "f_sub", _SUB_DRAIN)
            self.ret_valid &= ~retm
            active = active & ~retm & ~self.err

        if not active.any():
            self.segs.append((self.rowmap, seg))
            return

        # ---- 2) frame-top / root dispatch --------------------------------
        out_of_tok = active & (self.tcur >= self.ntok)
        self.err |= out_of_tok
        active &= ~out_of_tok

        k = self.kind[rows, np.clip(self.tcur, 0, self.T - 1)].astype(np.int32)
        case = self._top("f_case")
        sub = self._top("f_sub")
        style = self._top("f_style")
        fpath = self._top("f_path")

        is_root = active & (self.fp < 0) & ~self.entered_root
        self.entered_root |= is_root

        close_arr = k == jt.END_ARRAY
        close_obj = k == jt.END_OBJECT

        # COPY frames: emit every token until end marker
        copym = active & (self.fp >= 0) & (case == _F_COPY)
        if copym.any():
            prevk = self.kind[rows, np.clip(self.tcur - 1, 0, self.T - 1)]
            sep_colon = prevk == jt.FIELD_NAME
            prev_valend = np.isin(prevk, _SCALARS) | \
                (prevk == jt.END_OBJECT) | (prevk == jt.END_ARRAY)
            cur_close = close_arr | close_obj
            sep_comma = prev_valend & ~cur_close
            seg[:, 0, 0] = np.where(copym & (sep_colon | sep_comma),
                                    _SEG_CONST, seg[:, 0, 0])
            seg[:, 0, 1] = np.where(copym & sep_colon, _C_COLON, seg[:, 0, 1])
            seg[:, 0, 1] = np.where(copym & sep_comma & ~sep_colon,
                                    _C_COMMA, seg[:, 0, 1])
            seg[:, 1, 0] = np.where(copym, _SEG_ESC_TOK, seg[:, 1, 0])
            seg[:, 1, 1] = np.where(copym, self.tcur, seg[:, 1, 1])
            at_end = copym & (self.tcur == self._top("f_aux"))
            self._pop_ret(at_end, np.ones(n, np.int64))
            self.tcur = np.where(copym, self.tcur + 1, self.tcur)
            active &= ~copym

        # CASE2: flatten-array loop
        c2 = active & (self.fp >= 0) & (case == _F_CASE2)
        c2_close = c2 & close_arr
        self._pop_ret(c2_close, self._top("f_dirty"))
        self.tcur = np.where(c2_close, self.tcur + 1, self.tcur)
        c2_enter = c2 & ~close_arr

        # CASE4: object field loop
        c4 = active & (self.fp >= 0) & (case == _F_CASE4)
        c4_entering = c4 & (sub == _SUB_ENTERING)
        c4 = c4 & (sub != _SUB_ENTERING)
        c4_close = c4 & close_obj
        self._pop_ret(c4_close, self._top("f_dirty"))
        self.tcur = np.where(c4_close, self.tcur + 1, self.tcur)
        c4_field = c4 & ~close_obj
        if c4_field.any():
            nm = np.zeros((n,), bool)
            nlvl = self.nm_stack.shape[0]
            if nlvl:
                sel = np.nonzero(c4_field)[0]
                nm[sel] = self.nm_stack[
                    np.clip(fpath[sel], 0, nlvl - 1), sel,
                    np.clip(self.tcur[sel], 0, self.T - 1)]
            found = self._top("f_flag")
            hit = c4_field & nm & ~found
            miss = c4_field & ~hit
            # skip field name + its value in one step
            vt = np.clip(self.tcur + 1, 0, self.T - 1)
            vkind = self.kind[rows, vt]
            vopen = (vkind == jt.START_OBJECT) | (vkind == jt.START_ARRAY)
            skip_to = np.where(vopen, self.match[rows, vt] + 1, self.tcur + 2)
            self.tcur = np.where(miss, skip_to, self.tcur)
            # matched: null value -> whole row null (evaluate_path named case)
            isnull = vkind == jt.VALUE_NULL
            self.err |= hit & isnull
            ok_hit = hit & ~isnull
            self.tcur = np.where(ok_hit, self.tcur + 1, self.tcur)
            self._set_frame(ok_hit, "f_sub", _SUB_ENTERING)
        c4_go = c4_entering  # dispatch child eval this step
        self._set_frame(c4_go, "f_sub", _SUB_WAITING)

        # CASE5: [*][*] loop
        c5 = active & (self.fp >= 0) & (case == _F_CASE5)
        c5_close = c5 & close_arr
        if c5_close.any():
            seg[:, 1, 0] = np.where(c5_close, _SEG_CONST, seg[:, 1, 0])
            seg[:, 1, 1] = np.where(c5_close, _C_CLOSE_ARR, seg[:, 1, 1])
            self._set_gen(c5_close, "g_depth", self._gen_top("g_depth") - 1)
            self._set_gen(c5_close, "g_empty", False)
            self._pop_ret(c5_close, self._top("f_dirty"))
            self.tcur = np.where(c5_close, self.tcur + 1, self.tcur)
        c5_enter = c5 & ~close_arr

        # CASE6: wildcard with child generator
        c6 = active & (self.fp >= 0) & (case == _F_CASE6)
        c6_close = c6 & close_arr
        if c6_close.any():
            # resolve both conditionals NOW (dirty count and need_comma are
            # final at close): the close emits its resolved const directly,
            # the matching open (slot 0 of step f_aux) resolves through a
            # deferred patch applied in segment_tables — no per-row loop,
            # no per-generation rescan of the segment stream at render
            d = self._top("f_dirty")
            ncf = self._top("f_flag")
            sel = np.nonzero(c6_close)[0]
            open_id = np.where(
                d > 1, np.where(ncf, _C_COMMA_OPEN, _C_OPEN_ARR),
                np.where((d == 1) & ncf, _C_COMMA, _C_EMPTY))
            close_id = np.where(d > 1, _C_CLOSE_ARR, _C_EMPTY)
            self.patches.append((self.rowmap[sel],
                                 self.f_aux[sel, self.fp[sel]],
                                 open_id[sel]))
            seg[:, 1, 0] = np.where(c6_close, _SEG_CONST, seg[:, 1, 0])
            seg[:, 1, 1] = np.where(c6_close, close_id, seg[:, 1, 1])
            self.gp = np.where(c6_close, self.gp - 1, self.gp)  # pop child gen
            # write_child_raw_value: parent empty=False when dirty>=1 & depth>0
            wrote = c6_close & (d >= 1) & (self._gen_top("g_depth") > 0)
            self._set_gen(wrote, "g_empty", False)
            self._pop_ret(c6_close, d)
            self.tcur = np.where(c6_close, self.tcur + 1, self.tcur)
        c6_enter = c6 & ~close_arr

        # CASE7: wildcard, quoted style
        c7 = active & (self.fp >= 0) & (case == _F_CASE7)
        c7_close = c7 & close_arr
        if c7_close.any():
            seg[:, 1, 0] = np.where(c7_close, _SEG_CONST, seg[:, 1, 0])
            seg[:, 1, 1] = np.where(c7_close, _C_CLOSE_ARR, seg[:, 1, 1])
            self._set_gen(c7_close, "g_depth", self._gen_top("g_depth") - 1)
            self._set_gen(c7_close, "g_empty", False)
            self._pop_ret(c7_close, self._top("f_dirty"))
            self.tcur = np.where(c7_close, self.tcur + 1, self.tcur)
        c7_enter = c7 & ~close_arr

        # CASE8: index
        c8 = active & (self.fp >= 0) & (case == _F_CASE8)
        c8_skip = c8 & (sub == _SUB_NONE) & (self._top("f_aux") > 0)
        if c8_skip.any():
            self.err |= c8_skip & close_arr  # index out of bounds mid-skip
            ok8 = c8_skip & ~close_arr
            isopen = (k == jt.START_OBJECT) | (k == jt.START_ARRAY)
            skip_to = np.where(isopen, self.match[rows, np.clip(
                self.tcur, 0, self.T - 1)] + 1, self.tcur + 1)
            self.tcur = np.where(ok8, skip_to, self.tcur)
            self._set_frame(ok8, "f_aux", self._top("f_aux") - 1)
        c8_go = c8 & (sub == _SUB_NONE) & (self._top("f_aux") <= 0) & ~c8_skip
        self._set_frame(c8_go, "f_sub", _SUB_WAITING)
        c8_drain = c8 & (sub == _SUB_DRAIN)
        if c8_drain.any():
            d_close = c8_drain & close_arr
            self._pop_ret(d_close, self._top("f_dirty"))
            d_skip = c8_drain & ~close_arr
            isopen = (k == jt.START_OBJECT) | (k == jt.START_ARRAY)
            skip_to = np.where(isopen, self.match[rows, np.clip(
                self.tcur, 0, self.T - 1)] + 1, self.tcur + 1)
            self.tcur = np.where(d_skip, skip_to, self.tcur)
            self.tcur = np.where(d_close, self.tcur + 1, self.tcur)

        # ---- 3) ENTER dispatch -------------------------------------------
        enter = is_root | c2_enter | c4_go | c5_enter | c6_enter | c7_enter \
            | c8_go
        # child style / path per source
        e_style = np.full((n,), _RAW, np.int8)
        e_path = np.zeros((n,), np.int32)
        e_style = np.where(c2_enter, _FLATTEN, e_style)
        e_path = np.where(c2_enter, len(self.ptype) - 1, e_path)  # path end
        e_style = np.where(c4_go, style, e_style)
        e_path = np.where(c4_go, fpath + 1, e_path)
        e_style = np.where(c5_enter, _FLATTEN, e_style)
        e_path = np.where(c5_enter, fpath, e_path)  # stored as idx+2 at push
        e_style = np.where(c6_enter, style, e_style)  # stored child style
        e_path = np.where(c6_enter, fpath, e_path)    # stored idx+1
        e_style = np.where(c7_enter, _QUOTED, e_style)
        e_path = np.where(c7_enter, fpath, e_path)    # stored idx+1
        c8_enter = c8_go
        wc8 = self._top("f_flag")
        e_style = np.where(c8_enter, np.where(wc8, _QUOTED, style), e_style)
        e_path = np.where(c8_enter, fpath, e_path)    # stored idx+1
        if enter.any():
            self._enter(enter, e_style, e_path, k, seg, s)

        self.segs.append((self.rowmap, seg))

    def _pop_ret(self, mask, dirty):
        if not mask.any():
            return
        self.ret_valid |= mask
        self.ret_dirty = np.where(mask, dirty, self.ret_dirty)
        self.fp = np.where(mask, self.fp - 1, self.fp)

    def _push(self, mask, case, style, path, aux=0, flag=False):
        if not mask.any():
            return
        self.fp = np.where(mask, self.fp + 1, self.fp)
        over = mask & (self.fp >= self.F)
        self.err |= over
        self.fp = np.where(over, self.F - 1, self.fp)
        m = mask & ~over
        self._set_frame(m, "f_case", case)
        self._set_frame(m, "f_style", style if isinstance(style, np.ndarray)
                        else np.full(self.n, style, np.int8))
        self._set_frame(m, "f_path", path if isinstance(path, np.ndarray)
                        else np.full(self.n, path, np.int32))
        self._set_frame(m, "f_dirty", np.zeros(self.n, np.int64))
        self._set_frame(m, "f_sub", _SUB_NONE)
        self._set_frame(m, "f_aux", aux if isinstance(aux, np.ndarray)
                        else np.full(self.n, aux, np.int64))
        self._set_frame(m, "f_flag", flag if isinstance(flag, np.ndarray)
                        else np.full(self.n, flag, bool))

    def _enter(self, mask, style, path_idx, k, seg, s):
        """evaluate_path dispatch at the current token (cases as numbered)."""
        n = self.n
        rows = self._rows
        pt = self.ptype[np.clip(path_idx, 0, len(self.ptype) - 1)]
        ptn = self.ptype[np.clip(path_idx + 1, 0, len(self.ptype) - 1)]
        path_end = pt == _P_END
        is_str = k == jt.VALUE_STRING
        is_arr = k == jt.START_ARRAY
        is_obj = k == jt.START_OBJECT
        tclip = np.clip(self.tcur, 0, self.T - 1)

        need_comma = (self._gen_top("g_depth") > 0) & ~self._gen_top("g_empty")

        c1 = mask & is_str & path_end & (style == _RAW)
        c2 = mask & is_arr & path_end & (style == _FLATTEN) & ~c1
        c3 = mask & path_end & ~c1 & ~c2
        rest = mask & ~path_end
        c4 = rest & is_obj & (pt == NAMED)
        c5 = rest & is_arr & (pt == WILDCARD) & (ptn == WILDCARD)
        c6 = rest & is_arr & (pt == WILDCARD) & (style != _QUOTED) & ~c5
        c7 = rest & is_arr & (pt == WILDCARD) & ~c5 & ~c6
        c8 = rest & is_arr & (pt == INDEX)
        c12 = rest & ~c4 & ~c5 & ~c6 & ~c7 & ~c8

        # case 1: raw string leaf
        if c1.any():
            seg[:, 1, 0] = np.where(c1, _SEG_RAW_TOK, seg[:, 1, 0])
            seg[:, 1, 1] = np.where(c1, self.tcur, seg[:, 1, 1])
            wrote = c1 & (self._gen_top("g_depth") > 0)
            self._set_gen(wrote, "g_empty", False)
            self.ret_valid |= c1
            self.ret_dirty = np.where(c1, 1, self.ret_dirty)
            self.tcur = np.where(c1, self.tcur + 1, self.tcur)

        # case 2: flatten into array
        self._push(c2, _F_CASE2, _FLATTEN, len(self.ptype) - 1)
        self.tcur = np.where(c2, self.tcur + 1, self.tcur)

        # case 3: copy current structure (escaped)
        if c3.any():
            badk = np.isin(k, (jt.FIELD_NAME, jt.END_OBJECT, jt.END_ARRAY,
                               jt.ERRORTOK, jt.PAD))
            self.err |= c3 & badk
            ok3 = c3 & ~badk
            seg[:, 0, 0] = np.where(ok3 & need_comma, _SEG_CONST, seg[:, 0, 0])
            seg[:, 0, 1] = np.where(ok3 & need_comma, _C_COMMA, seg[:, 0, 1])
            seg[:, 1, 0] = np.where(ok3, _SEG_ESC_TOK, seg[:, 1, 0])
            seg[:, 1, 1] = np.where(ok3, self.tcur, seg[:, 1, 1])
            self._set_gen(ok3 & (self._gen_top("g_depth") > 0), "g_empty", False)
            opn = ok3 & (is_arr | is_obj)
            self._push(opn, _F_COPY, _RAW, 0,
                       aux=self.match[rows, tclip].astype(np.int64))
            scal = ok3 & ~opn
            self.ret_valid |= scal
            self.ret_dirty = np.where(scal, 1, self.ret_dirty)
            self.tcur = np.where(ok3, self.tcur + 1, self.tcur)

        # case 4: object + named
        self._push(c4, _F_CASE4, style, path_idx)
        self.tcur = np.where(c4, self.tcur + 1, self.tcur)

        # case 5: [*][*]
        if c5.any():
            seg[:, 0, 0] = np.where(c5 & need_comma, _SEG_CONST, seg[:, 0, 0])
            seg[:, 0, 1] = np.where(c5 & need_comma, _C_COMMA, seg[:, 0, 1])
            seg[:, 1, 0] = np.where(c5, _SEG_CONST, seg[:, 1, 0])
            seg[:, 1, 1] = np.where(c5, _C_OPEN_ARR, seg[:, 1, 1])
            self._set_gen(c5, "g_depth", self._gen_top("g_depth") + 1)
            self._set_gen(c5, "g_empty", True)
            self._push(c5, _F_CASE5, style, path_idx + 2)
            self.tcur = np.where(c5, self.tcur + 1, self.tcur)

        # case 6: wildcard with child generator + deferred wrapping
        if c6.any():
            child_style = np.where(style == _RAW, _QUOTED, _FLATTEN).astype(np.int8)
            self._push(c6, _F_CASE6, child_style, path_idx + 1,
                       aux=np.full(n, s, np.int64), flag=need_comma)
            # push child generator
            self.gp = np.where(c6, self.gp + 1, self.gp)
            overg = c6 & (self.gp >= self.G)
            self.err |= overg
            self.gp = np.where(overg, self.G - 1, self.gp)
            self._set_gen(c6, "g_depth", 1)
            self._set_gen(c6, "g_empty", True)
            seg[:, 0, 0] = np.where(c6, _SEG_COND_OPEN, seg[:, 0, 0])
            seg[:, 0, 1] = np.where(c6, s, seg[:, 0, 1])
            self.tcur = np.where(c6, self.tcur + 1, self.tcur)

        # case 7: wildcard, quoted
        if c7.any():
            seg[:, 0, 0] = np.where(c7 & need_comma, _SEG_CONST, seg[:, 0, 0])
            seg[:, 0, 1] = np.where(c7 & need_comma, _C_COMMA, seg[:, 0, 1])
            seg[:, 1, 0] = np.where(c7, _SEG_CONST, seg[:, 1, 0])
            seg[:, 1, 1] = np.where(c7, _C_OPEN_ARR, seg[:, 1, 1])
            self._set_gen(c7, "g_depth", self._gen_top("g_depth") + 1)
            self._set_gen(c7, "g_empty", True)
            self._push(c7, _F_CASE7, style, path_idx + 1)
            self.tcur = np.where(c7, self.tcur + 1, self.tcur)

        # cases 8/9: index (+optional wildcard)
        if c8.any():
            idxv = self.parg[np.clip(path_idx, 0, len(self.parg) - 1)]
            self._push(c8, _F_CASE8, style, path_idx + 1,
                       aux=idxv, flag=(ptn == WILDCARD))
            self.tcur = np.where(c8, self.tcur + 1, self.tcur)

        # case 12: skip children, dirty 0
        if c12.any():
            isopen = is_arr | is_obj
            skip_to = np.where(isopen, self.match[rows, tclip] + 1,
                               self.tcur + 1)
            self.tcur = np.where(c12, skip_to, self.tcur)
            self.ret_valid |= c12
            self.ret_dirty = np.where(c12, 0, self.ret_dirty)


def _render(bi: _ByteInfo, stype, sarg, err, kind, start, end, len_raw,
            len_esc, neg0, ftext, flen, fidx):
    """Lay out the (already resolved) segment tables, materialize bytes."""
    n, T = kind.shape
    S2 = stype.shape[1]

    rows = np.arange(n)[:, None]
    targ = np.clip(sarg, 0, T - 1)
    slen = np.zeros((n, S2), np.int64)
    slen = np.where(stype == _SEG_CONST,
                    _CONST_LEN[np.clip(sarg, 0, len(_CONSTS) - 1)], slen)
    slen = np.where(stype == _SEG_RAW_TOK, len_raw[rows, targ], slen)
    slen = np.where(stype == _SEG_ESC_TOK, len_esc[rows, targ], slen)
    # RAW/ESC of non-string kinds resolve through the same tables; int/float
    # tokens appear as RAW/ESC too (copy) — map them:
    is_float_tok = kind[rows, targ] == jt.VALUE_NUMBER_FLOAT
    tok_ref = (stype == _SEG_RAW_TOK) | (stype == _SEG_ESC_TOK)
    f_sel = tok_ref & is_float_tok
    fi = np.clip(fidx[rows, targ], 0, max(len(flen) - 1, 0))
    if len(flen):
        slen = np.where(f_sel, flen[fi], slen)

    segcum = np.cumsum(slen, axis=1)  # inclusive
    out_len = segcum[:, -1]
    # nulled rows emit nothing
    out_len = np.where(err, 0, out_len)
    W = max(int(out_len.max()), 1)
    # rows render in power-of-two width classes of their own length (a row's
    # bytes depend on its row alone), so one long row widens no short one
    out = np.zeros((n, W), np.uint8)
    wcls = np.ceil(np.log2(np.maximum(out_len, 1))).astype(np.int64)
    for c in np.unique(wcls[out_len > 0]):
        sel = np.nonzero((wcls == c) & (out_len > 0))[0]
        Wc = min(1 << int(c), W)
        out[sel, :Wc] = _render_rows(
            _slice_byte_info(bi, sel), stype[sel], sarg[sel], segcum[sel], out_len[sel],
            kind[sel], start[sel], end[sel], len_esc[sel], neg0[sel], ftext, flen, fidx[sel], Wc)
    return out, out_len


def _render_rows(bi: _ByteInfo, stype, sarg, segcum, out_len, kind, start, end, len_esc,
                 neg0, ftext, flen, fidx, W: int):
    """The output bytes [n, W] of measured rows (``_render``'s emission)."""
    n, T = kind.shape
    S2 = stype.shape[1]
    rows = np.arange(n)[:, None]
    j = np.broadcast_to(np.arange(W, dtype=np.int64)[None, :], (n, W))
    si = _batched_searchsorted_right(segcum, j)  # segment of each out byte
    si = np.minimum(si, S2 - 1)
    prev = np.where(si > 0, segcum[rows, np.maximum(si - 1, 0)], 0)
    d = j - prev  # offset within segment
    st = stype[rows, si]
    sa = sarg[rows, si]
    ta = np.clip(sa, 0, T - 1)
    tk = kind[rows, ta]
    ts = start[rows, ta].astype(np.int64)
    te = end[rows, ta].astype(np.int64)
    L = bi.b.shape[1]

    out = np.zeros((n, W), np.uint8)
    # consts
    cm = st == _SEG_CONST
    out = np.where(cm, _CONST_TAB[np.clip(sa, 0, len(_CONSTS) - 1),
                                  np.clip(d, 0, _CONST_MAXLEN - 1)], out)
    # token text
    is_str = (tk == jt.VALUE_STRING) | (tk == jt.FIELD_NAME)
    is_int = tk == jt.VALUE_NUMBER_INT
    is_float = tk == jt.VALUE_NUMBER_FLOAT
    one_char = np.isin(tk, (jt.START_OBJECT, jt.END_OBJECT, jt.START_ARRAY,
                            jt.END_ARRAY))
    lit = np.isin(tk, (jt.VALUE_TRUE, jt.VALUE_FALSE, jt.VALUE_NULL))
    tokm = (st == _SEG_RAW_TOK) | (st == _SEG_ESC_TOK)
    escm = st == _SEG_ESC_TOK

    # ints: raw copy (or "0" for -0)
    im = tokm & is_int
    n0 = neg0[rows, ta]
    int_byte = bi.b[rows, np.clip(ts + d, 0, L - 1)]
    out = np.where(im, np.where(n0, ord("0"), int_byte), out)
    # structural single chars + literals: copy from source span directly
    sm = tokm & (one_char | lit)
    out = np.where(sm, bi.b[rows, np.clip(ts + d, 0, L - 1)], out)
    # floats
    if len(flen):
        fm = tokm & is_float
        fi2 = np.clip(fidx[rows, ta], 0, len(flen) - 1)
        out = np.where(fm, ftext[fi2, np.clip(d, 0, ftext.shape[1] - 1)], out)
    # strings
    strm = tokm & is_str
    if strm.any():
        ps = np.minimum(ts + 1, L)
        # raw (unescape) variant
        rm = strm & ~escm
        base_u = bi.cum_u[rows, ps]
        tgt = base_u + d
        siU = np.minimum(_batched_searchsorted_right(bi.cum_u[:, 1:], tgt), L - 1)
        kU = tgt - bi.cum_u[rows, siU]
        rbyte = _emission_byte(bi, rows * np.ones_like(siU), siU, kU, False)
        out = np.where(rm, rbyte, out)
        # escaped variant: quote + payload + quote
        em = strm & escm
        elen = len_esc[rows, ta]
        quote = (d == 0) | (d == elen - 1)
        base_e = bi.cum_e[rows, ps]
        tgt = base_e + (d - 1)
        siE = np.minimum(_batched_searchsorted_right(bi.cum_e[:, 1:],
                                                     np.maximum(tgt, 0)), L - 1)
        kE = np.maximum(tgt, 0) - bi.cum_e[rows, siE]
        ebyte = _emission_byte(bi, rows * np.ones_like(siE), siE, kE, True)
        out = np.where(em, np.where(quote, ord('"'), ebyte), out)

    in_bounds = j < out_len[:, None]
    return np.where(in_bounds, out, 0)



def _device_chunks(col: StringColumn) -> List[PaddedBucket]:
    """The column's padded buckets, each cut into row chunks of at most
    ``CHUNK_BYTES`` padded bytes (the device arm's memory bound)."""
    out = []
    for b in padded_buckets(col):
        step = max(1, CHUNK_BYTES // b.width)
        nr = b.rows.numel()
        for r0 in range(0, nr, step):
            r1 = min(nr, r0 + step)
            out.append(b if (r0, r1) == (0, nr) else
                       PaddedBucket(b.rows[r0:r1], b.bytes[r0:r1], b.lengths[r0:r1], b.width))
    return out


def _get_json_object_device(col: StringColumn, parts: Sequence[tuple]
                            ) -> List[StringColumn]:
    """Device arm: tokenize, byte tables, name match, the torch machine and
    segment rendering, all on the column's device.

    ``parts``: [(ptypes, pargs, names), ...], one entry per path.  All paths
    share one tokenization, byte-table build and float re-render per chunk,
    name-match tables are built once per *unique* name across paths, and one
    stacked machine runs every path (ops/json_scan.py).  Chunks are grouped
    by ``json_overlap_bytes`` of padded input x paths: a group runs its
    machines before its batched width syncs, and holding a group's tables at
    once is what the budget bounds.  Parity: the single-kernel residency of
    get_json_object.cu:891.
    """
    from spark_rapids_jni_tpu_torch.ops import json_render_device as jrd
    from spark_rapids_jni_tpu_torch.ops.json_scan import SEG_SHIFT, run_scan

    n = col.size
    P = len(parts)
    dev = col.device
    in_valid = col.is_valid()
    uniq_names: List[bytes] = []
    name_slot: Dict[bytes, int] = {}
    for _pt, _pa, names in parts:
        for nm in names:
            if nm is not None and nm not in name_slot:
                name_slot[nm] = len(uniq_names)
                uniq_names.append(nm)
    slots = [[None if nm is None else name_slot[nm] for nm in names]
             for _pt, _pa, names in parts]

    group_budget = max(int(config.get("json_overlap_bytes")), 1)
    groups, cur, cur_bytes = [], [], 0
    for ch in _device_chunks(col):
        cbytes = int(ch.bytes.shape[0]) * int(ch.bytes.shape[1]) * max(P, 1)
        if cur and cur_bytes + cbytes > group_budget:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(ch)
        cur_bytes += cbytes
    if cur:
        groups.append(cur)

    results: List[list] = [[] for _ in range(P)]
    valid_out = [torch.zeros((n,), dtype=torch.bool, device=dev) for _ in range(P)]
    for group in groups:
        ph1 = []
        n_trunc = 0
        for ch in group:
            with _phase("tokenize"):
                ts = jt.tokenize(ch.bytes, ch.lengths)
                bi = jrd.byte_info_device(ch.bytes, ch.lengths,
                                          jt._shift_right(ts.str_state, 1))
                ts.str_state = None
            with _phase("evaluate"):
                kind, start, end = ts.kind, ts.start, ts.end
                nr, T = kind.shape
                len_raw, len_esc, has_uni, neg0 = jrd.token_tables_device(bi, kind, start, end)
                nm_tab = torch.stack(jrd.name_matches_device(
                    bi, kind, start, len_raw, has_uni, end, uniq_names)
                    + [torch.zeros((nr, T), dtype=torch.bool, device=dev)])
                F = min(jt.MAX_DEPTH + MAX_PATH_DEPTH + 6, T + 3)
                G = min(MAX_PATH_DEPTH + 2, F)
                err, seg, trunc = run_scan(kind, ts.match, ts.n_tokens, ts.ok, nm_tab, parts,
                                           slots, T, F, G)
                del nm_tab, has_uni
                n_trunc += trunc
                err = err | ~in_valid[ch.rows][None, :]
                # float tokens some path emits: only those are re-rendered
                stype = seg & ((1 << SEG_SHIFT) - 1)
                ref = (stype == _SEG_RAW_TOK) | (stype == _SEG_ESC_TOK)
                qq = torch.arange(nr, device=dev)[None, :, None].expand(seg.shape)
                used = torch.zeros((nr, T), dtype=torch.bool, device=dev)
                used[qq[ref], torch.clamp(seg[ref] >> SEG_SHIFT, 0, T - 1).to(torch.int64)] = True
                del stype, ref, qq
            ph1.append(dict(ch=ch, bi=bi, kind=kind, start=start, end=end, err=err, seg=seg,
                            used=used, tabs=(len_raw, len_esc, neg0)))
        with _phase("evaluate"):
            _note_truncation(n_trunc)

        with _phase("render"):
            for p in ph1:
                ftext, flen, fidx = jrd.float_texts_device(
                    p["ch"].bytes, p["kind"], p["start"], p["end"], p.pop("used"))
                p["floats"] = (ftext, flen, fidx)
                len_raw, len_esc, _n0 = p["tabs"]
                p["measured"] = [jrd.measure(p["seg"][pi], p["err"][pi], p["kind"], len_raw,
                                             len_esc, fidx, flen) for pi in range(P)]
                del p["seg"]
            # one batched sync: every (chunk, path) output width at once
            wmaxes = torch.stack([m[3].max() for p in ph1 for m in p["measured"]]).tolist()
            wi = 0
            for p in ph1:
                ch = p["ch"]
                for pi, (stype, sarg, segcum, out_len) in enumerate(p["measured"]):
                    W = max(int(wmaxes[wi]), 1)
                    wi += 1
                    padded = jrd.render_device(p["bi"], stype, sarg, segcum, out_len,
                                               p["kind"], p["start"], p["tabs"], p["floats"], W)
                    valid_out[pi][ch.rows] = ~p["err"][pi]
                    results[pi].append((ch.rows, padded, out_len.to(torch.int32)))
                del p["measured"], p["bi"]

    return [strings_from_buckets(n, results[pi], valid_out[pi]) for pi in range(P)]


def _get_json_object_host(col: StringColumn, parts: Sequence[tuple]
                          ) -> List[StringColumn]:
    """Host arm: tokenize on the column's device, evaluate + render in
    numpy, the result moved back to the column's device.

    One tokenization, byte-table build, float re-render and (unique-)name
    match per bucket is shared by every path; rows are split into
    token-count sub-buckets (``json_subbucket_min_rows``) so a machine's
    step cap tracks its own rows' token counts, and each machine compacts
    to its active rows as they finish (``json_compact``).
    """
    n = col.size
    P = len(parts)
    dev = col.device
    in_valid = col.is_valid().cpu().numpy()
    compact = bool(config.get("json_compact"))
    sub_min = int(config.get("json_subbucket_min_rows"))
    margin = int(config.get("json_step_margin"))

    results: List[list] = [[] for _ in range(P)]
    valid_out = [np.zeros((n,), bool) for _ in range(P)]
    n_trunc = 0
    for b in padded_buckets(col):
        with _phase("tokenize"):
            ts = jt.tokenize(b.bytes, b.lengths)
            kind = ts.kind.cpu().numpy().astype(np.int32)
            start = ts.start.cpu().numpy()
            end = ts.end.cpu().numpy()
            match = ts.match.cpu().numpy()
            ntok = ts.n_tokens.cpu().numpy().astype(np.int64)
            ok = ts.ok.cpu().numpy()
            rows_np = b.rows.cpu().numpy()
            nv = len(rows_np)
            bi = _byte_info(b.bytes, ts.str_state)

        with _phase("evaluate"):
            len_raw, len_esc, has_uni, neg0 = _token_tables(bi, kind, start, end)
            nm_cache: dict = {}
            nm_paths = [
                _name_matches(bi, kind, start, end, names, len_raw, has_uni,
                              cache=nm_cache)
                for _pt, _pa, names in parts
            ]
        T = kind.shape[1]
        has_float = bool((kind == jt.VALUE_NUMBER_FLOAT).any())
        used_float = (np.zeros((nv, T), bool) if has_float else None)
        pending = []
        for sel, Tcap in count_subbuckets(ntok, T, min_rows=sub_min):
            whole = len(sel) == nv and Tcap == T
            if whole:
                kind_s, start_s, end_s, match_s = kind, start, end, match
                ntok_s, ok_s, bi_s, rows_s = ntok, ok, bi, rows_np
                lr_s, le_s, n0_s = len_raw, len_esc, neg0
            else:
                kind_s = kind[sel][:, :Tcap]
                start_s = start[sel][:, :Tcap]
                end_s = end[sel][:, :Tcap]
                match_s = match[sel][:, :Tcap]
                ntok_s, ok_s = ntok[sel], ok[sel]
                bi_s = _slice_byte_info(bi, sel)
                rows_s = rows_np[sel]
                lr_s = len_raw[sel][:, :Tcap]
                le_s = len_esc[sel][:, :Tcap]
                n0_s = neg0[sel][:, :Tcap]
            for pi, ((ptypes, pargs, _names), nm) in enumerate(
                    zip(parts, nm_paths)):
                with _phase("evaluate"):
                    nm_s = nm if whole else [t[sel][:, :Tcap] for t in nm]
                    m = _Machine(kind_s, match_s, ntok_s, ok_s, ptypes,
                                 pargs, nm_s, compact=compact,
                                 step_margin=margin)
                    n_trunc += m.run()
                    stype, sarg = m.segment_tables()
                    err = (m.err_out | (m.dirty_out <= 0)
                           | ~in_valid[rows_s])
                    if has_float:
                        # note float tokens this path actually emits, so
                        # the Ryu re-render below runs on just those
                        ref = (stype == _SEG_RAW_TOK) | \
                            (stype == _SEG_ESC_TOK)
                        ri2, si2 = np.nonzero(ref)
                        ta2 = np.clip(sarg[ri2, si2], 0, Tcap - 1)
                        fref = kind_s[ri2, ta2] == jt.VALUE_NUMBER_FLOAT
                        used_float[sel[ri2[fref]], ta2[fref]] = True
                pending.append((pi, sel, Tcap, whole, stype, sarg, err,
                                bi_s, kind_s, start_s, end_s, lr_s, le_s,
                                n0_s, rows_s))

        with _phase("render"):
            ftext, flen, fidx = _float_texts(bi, kind, start, end,
                                             used=used_float)
            for (pi, sel, Tcap, whole, stype, sarg, err, bi_s, kind_s,
                 start_s, end_s, lr_s, le_s, n0_s, rows_s) in pending:
                fidx_s = fidx if whole else fidx[sel][:, :Tcap]
                padded, out_len = _render(
                    bi_s, stype, sarg, err, kind_s, start_s, end_s,
                    lr_s, le_s, n0_s, ftext, flen, fidx_s)
                valid_out[pi][rows_s] = ~err
                out_len = np.where(~err, out_len, 0)
                results[pi].append((torch.from_numpy(rows_s).to(dev),
                                    torch.from_numpy(padded).to(dev),
                                    torch.from_numpy(out_len.astype(np.int32)).to(dev)))

    _note_truncation(n_trunc)
    return [strings_from_buckets(n, results[pi], torch.from_numpy(valid_out[pi]).to(dev))
            for pi in range(P)]


def _device_render_enabled(dev: torch.device) -> bool:
    """``json_device_render``: True/False pin an arm; ``"auto"`` takes the
    device arm for a CUDA column and the host arm for a CPU one."""
    v = config.get("json_device_render")
    if v == "auto":
        return dev.type != "cpu"
    return bool(v)


def _path_parts(path) -> tuple:
    if isinstance(path, str):
        path = parse_path(path)
    path = list(path)
    if len(path) > MAX_PATH_DEPTH:
        # get_json_object.cu:958 CUDF_FAIL("JSONPath query exceeds maximum depth")
        raise ValueError("JSONPath query exceeds maximum depth")
    ptypes = [p[0] for p in path]
    pargs = [p[1] if len(p) > 1 else 0 for p in path]
    names = [p[1] if p[0] == NAMED else None for p in path]
    return ptypes, pargs, names


def get_json_object_multiple_paths(
        col: StringColumn, paths: Sequence) -> List[StringColumn]:
    """Evaluate several JSON paths against ONE tokenization of ``col``.

    The reference ships ``JSONUtils.getJsonObjectMultiplePaths`` because
    tokenization dominates: parsing the column once and fanning the token
    stream out to P path machines makes P paths cost far less than P
    separate calls.

    ``paths``: sequence of path strings or instruction-tuple lists.
    Returns one StringColumn per path, in order, on ``col``'s device.
    """
    parts = [_path_parts(p) for p in paths]
    if not parts:
        return []
    n = col.size
    if n == 0:
        return [StringColumn(torch.zeros((0,), dtype=torch.uint8, device=col.device),
                             torch.zeros((1,), dtype=torch.int32, device=col.device), None)
                for _ in parts]
    if _device_render_enabled(col.device):
        return _get_json_object_device(col, parts)
    return _get_json_object_host(col, parts)


def get_json_object(col: StringColumn, path) -> StringColumn:
    """Evaluate a JSON path over every row (Spark ``get_json_object``).

    ``path``: instruction tuples (``(NAMED, bytes)``, ``(INDEX, int)``,
    ``(WILDCARD,)``) or a ``$.a[0].*`` string (parsed via parse_path).
    Returns a string column; unmatched/malformed/null rows are null.
    """
    return get_json_object_multiple_paths(col, [path])[0]
