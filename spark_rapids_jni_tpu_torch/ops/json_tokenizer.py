"""Vectorized Spark-JSON tokenizer: byte rectangles -> validated token streams
(PyTorch port of ``ops/json_tokenizer.py``).

The shared front half of ``get_json_object`` and ``from_json``.  The reference
parses per row with a sequential pushdown parser (json_parser.cuh:220, one
GPU thread per row); here tokenization is dense whole-rectangle passes over a
length bucket's ``[rows, width]`` byte matrix:

1. **String-context automaton**: 5 states (outside / in-double-quote /
   dq-escape / in-single-quote / sq-escape) give every byte its string
   context.
2. **Number DFA**: the grammar of json_parser.cuh ``try_parse_number``
   (leading-zero rejection, ``.`` needs digits both sides, an exponent needs
   digits; a valid prefix followed by junk splits into value + junk token,
   which reproduces the root-level trailing-garbage tolerance of
   json_parser.cuh:1250-1254), reset at every run start.
3. **Token compaction**: token-start bytes get ranks by row cumsum and land
   in dense ``[rows, T]`` token arrays.
4. **Grammar scan**: one lockstep loop over token steps, all rows at once:
   the object/array separator grammar of json_parser.cuh ``next_token``,
   nesting bounded at ``MAX_DEPTH=64`` (json_parser.cuh:46), FIELD_NAME
   context, matched open/close pairs (the evaluator's O(1) skip_children)
   and the root-value end, so trailing garbage is ignored.

The two automata run as one table lookup per byte column: each byte maps to
a small class code, and ``state = table[code * S + state]`` steps across the
columns.  That is ``width`` passes over ``[rows]`` vectors holding only the
``[rows, width]`` result, where the JAX package's associative scan over
transition functions composes ``[rows, width, S]`` maps in log-width passes
(the [rows, width, S] maps and their int64 gather indices would cost tens of
bytes per input byte on the card).  The outputs are the same states.

On a CUDA bucket :func:`tokenize` runs the torch compaction and grammar loop
on the card; on a CPU bucket it runs their numpy twins, as the JAX package
does on XLA:CPU.  Both give the same token streams.

Spark quirks preserved (same set as tests/json_oracle.py): single-quoted
strings, raw control chars legal inside strings, ``\\uXXXX`` must be 4 hex
digits, numbers reject leading zeros and bare ``.5``/``5.``, at most
MAX_NUM_LEN digits, root-level trailing garbage after a complete value is
ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device

__all__ = ["TokenStream", "tokenize", "MAX_DEPTH", "MAX_NUM_LEN"]

MAX_DEPTH = 64  # json_parser.cuh:46 max_json_nesting_depth
MAX_NUM_LEN = 1000  # json_parser.cuh max_num_len

# token kinds (aligned with tests/json_oracle.py)
ERRORTOK = 1
START_OBJECT, END_OBJECT, START_ARRAY, END_ARRAY = 3, 4, 5, 6
FIELD_NAME, VALUE_STRING = 7, 8
VALUE_NUMBER_INT, VALUE_NUMBER_FLOAT = 9, 10
VALUE_TRUE, VALUE_FALSE, VALUE_NULL = 11, 12, 13
COMMA, COLON = 14, 15  # internal: validated then dropped
PAD = 0

_I32 = torch.int32
_I64 = torch.int64
_U8 = torch.uint8
_BOOL = torch.bool

# string automaton states
_S_OUT, _S_DQ, _S_DQE, _S_SQ, _S_SQE = 0, 1, 2, 3, 4

# number DFA states
_N_IDLE, _N_NEG, _N_ZERO, _N_INT, _N_DOT, _N_FRAC = 0, 1, 2, 3, 4, 5
_N_EXP, _N_EXPS, _N_EXPD, _N_DONE, _N_ERR = 6, 7, 8, 9, 10

# grammar expect states
_E_VALUE = 0
_E_FIELD_OR_CLOSE = 1
_E_COLON = 2
_E_COMMA_OR_CLOSE_OBJ = 3
_E_FIELD = 4
_E_COMMA_OR_CLOSE_ARR = 5
_E_VALUE_OR_CLOSE = 6

# live-row checks of the grammar loop on the card: one host sync per this
# many steps (the loop ends early once every row is done or in error)
_CHECK_EVERY = 16


@dataclasses.dataclass
class TokenStream:
    """Validated, separator-free token stream for one length bucket.

    ``kind[r, t]`` is PAD beyond ``n_tokens[r]``.  ``start``/``end`` are byte
    spans into the bucket's byte matrix (strings include their quotes).
    ``match[r, t]`` is the index of the matching close for START_* tokens
    (self otherwise).  ``ok[r]`` is False for malformed rows (entire row ->
    NULL downstream).  ``str_state`` is the string-automaton state AFTER
    each byte ([n, L] int32): the escape tables of both get_json_object arms
    need exactly this matrix, so multi-path extraction skips a second
    automaton pass.
    """

    kind: torch.Tensor  # uint8 [n, T]
    start: torch.Tensor  # int32 [n, T]
    end: torch.Tensor  # int32 [n, T]
    match: torch.Tensor  # int32 [n, T]
    n_tokens: torch.Tensor  # int32 [n]
    ok: torch.Tensor  # bool [n]
    trailing: torch.Tensor  # bool [n]: tokens existed after the root value
    str_state: Optional[torch.Tensor] = None


def _pow2_at_least(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


# --- the two automata as (byte class x state) tables -------------------------

# string automaton byte classes: other, '"', "'", '\\', past the row's end
_SC_OTHER, _SC_DQ, _SC_SQ, _SC_BS, _SC_PAST = 0, 1, 2, 3, 4


def _string_table() -> np.ndarray:
    t = np.zeros((5, 5), np.int32)
    for c in range(5):
        for s in range(5):
            if c == _SC_PAST:
                t[c, s] = s  # identity past the row's end
            elif s == _S_OUT:
                t[c, s] = _S_DQ if c == _SC_DQ else _S_SQ if c == _SC_SQ else _S_OUT
            elif s == _S_DQ:
                t[c, s] = _S_DQE if c == _SC_BS else _S_OUT if c == _SC_DQ else _S_DQ
            elif s == _S_SQ:
                t[c, s] = _S_SQE if c == _SC_BS else _S_OUT if c == _SC_SQ else _S_SQ
            elif s == _S_DQE:
                t[c, s] = _S_DQ
            else:
                t[c, s] = _S_SQ
    return t.reshape(-1)


# number DFA byte classes (other, '0', '1'-'9', '-', '+', '.', 'e'/'E') in
# three modes: outside a run (identity), inside a run, at a run start
_NC_OTHER, _NC_D0, _NC_D19, _NC_MINUS, _NC_PLUS, _NC_DOT, _NC_E = range(7)
_N_STATES = 11


def _number_next(s: int, c: int) -> int:
    dig = c in (_NC_D0, _NC_D19)
    if s == _N_NEG:
        return _N_ZERO if c == _NC_D0 else _N_INT if c == _NC_D19 else _N_ERR
    if s == _N_ZERO:
        return (_N_DOT if c == _NC_DOT else _N_EXP if c == _NC_E
                else _N_ERR if dig else _N_DONE)
    if s == _N_INT:
        return (_N_INT if dig else _N_DOT if c == _NC_DOT else _N_EXP if c == _NC_E
                else _N_DONE)
    if s == _N_DOT:
        return _N_FRAC if dig else _N_ERR
    if s == _N_FRAC:
        return _N_FRAC if dig else _N_EXP if c == _NC_E else _N_DONE
    if s == _N_EXP:
        return _N_EXPD if dig else _N_EXPS if c in (_NC_MINUS, _NC_PLUS) else _N_ERR
    if s == _N_EXPS:
        return _N_EXPD if dig else _N_ERR
    if s == _N_EXPD:
        return _N_EXPD if dig else _N_DONE
    return s  # IDLE, DONE and ERR are absorbing


def _number_first(c: int) -> int:
    return {_NC_MINUS: _N_NEG, _NC_D0: _N_ZERO, _NC_D19: _N_INT}.get(c, _N_ERR)


def _number_table() -> np.ndarray:
    t = np.zeros((15, _N_STATES), np.int32)
    for s in range(_N_STATES):
        t[0, s] = s
        for c in range(7):
            t[1 + c, s] = _number_next(s, c)
            t[8 + c, s] = _number_first(c)
    return t.reshape(-1)


_TABLES = {}


def _table(name: str, device: torch.device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _TABLES:
        src = {"string": _string_table, "number": _number_table}[name]()
        _TABLES[key] = torch.from_numpy(src).to(device)
    return _TABLES[key]


def _run_automaton(codes: torch.Tensor, table: torch.Tensor, S: int) -> torch.Tensor:
    """State AFTER each byte of the automaton ``state' = table[code*S + state]``
    from state 0, stepped across the byte columns.  ``codes``: [n, L] class
    codes already multiplied by ``S`` (int32).  Returns int32 [n, L]."""
    n, L = codes.shape
    cols = codes.t().contiguous()
    out = torch.empty((L, n), dtype=_I32, device=codes.device)
    idx = torch.empty((n,), dtype=_I32, device=codes.device)
    st = torch.zeros((n,), dtype=_I32, device=codes.device)
    for i in range(L):
        torch.add(cols[i], st, out=idx)
        torch.index_select(table, 0, idx, out=out[i])
        st = out[i]
    return out.t().contiguous()


def _string_automaton(b: torch.Tensor, in_row: torch.Tensor) -> torch.Tensor:
    """state_after[r, i] of the 5-state string-context machine."""
    cls = torch.where(b == ord('"'), _SC_DQ,
                      torch.where(b == ord("'"), _SC_SQ,
                                  torch.where(b == ord("\\"), _SC_BS, _SC_OTHER)))
    cls = torch.where(in_row, cls, _SC_PAST).to(_I32) * 5
    return _run_automaton(cls, _table("string", b.device), 5)


def _number_dfa(b: torch.Tensor, run_start: torch.Tensor, in_num_run: torch.Tensor):
    """state_after of the number grammar DFA, reset at each run start."""
    cls = torch.full(b.shape, _NC_OTHER, dtype=_I32, device=b.device)
    cls = torch.where(b == ord("0"), _NC_D0, cls)
    cls = torch.where((b >= ord("1")) & (b <= ord("9")), _NC_D19, cls)
    cls = torch.where(b == ord("-"), _NC_MINUS, cls)
    cls = torch.where(b == ord("+"), _NC_PLUS, cls)
    cls = torch.where(b == ord("."), _NC_DOT, cls)
    cls = torch.where((b == ord("e")) | (b == ord("E")), _NC_E, cls)
    code = torch.where(run_start, 8 + cls, torch.where(in_num_run, 1 + cls, 0))
    return _run_automaton(code.to(_I32) * _N_STATES, _table("number", b.device), _N_STATES)


def _next_pos(mask: torch.Tensor, big: int) -> torch.Tensor:
    """For each i: smallest j >= i with mask[j], else ``big`` (per row)."""
    L = mask.shape[1]
    pos = torch.arange(L, dtype=_I32, device=mask.device)[None, :]
    cand = torch.where(mask, pos, big).to(_I32)
    return torch.flip(torch.cummin(torch.flip(cand, [1]), 1).values, [1])


def _shift_left(x: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    """``out[:, i] = x[:, i + k]`` (``fill`` past the end)."""
    out = torch.full_like(x, fill)
    if k < x.shape[1]:
        out[:, : x.shape[1] - k] = x[:, k:]
    return out


def _shift_right(x: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    """``out[:, i] = x[:, i - k]`` (``fill`` before the start)."""
    out = torch.full_like(x, fill)
    if k < x.shape[1]:
        out[:, k:] = x[:, : x.shape[1] - k]
    return out


def _take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[i, idx[i, w]]`` for arr [n, K], idx [n, W] (pre-clipped)."""
    return torch.gather(arr, 1, idx.to(_I64))


def _is_hex(b):
    return (((b >= ord("0")) & (b <= ord("9"))) | ((b >= ord("a")) & (b <= ord("f")))
            | ((b >= ord("A")) & (b <= ord("F"))))


def _scan_bytes(bytes_mat: torch.Tensor, lens: torch.Tensor):
    """Per-byte analysis: (token_start bool, kind int32, end int32, counts
    int32 [n], str_state int32) over one ``[n, L]`` byte rectangle."""
    n, L = bytes_mat.shape
    dev = bytes_mat.device
    b = bytes_mat
    lens = lens.to(_I32)
    pos = torch.arange(L, dtype=_I32, device=dev)[None, :]
    in_row = pos < lens[:, None]
    BIG = L + 1

    # ---- phase 1: string context ----------------------------------------
    st_after = _string_automaton(b, in_row)
    st_before = _shift_right(st_after, 1)

    is_open_q = (st_before == _S_OUT) & ((b == ord('"')) | (b == ord("'"))) & in_row
    is_close_q = (((st_before == _S_DQ) & (b == ord('"')))
                  | ((st_before == _S_SQ) & (b == ord("'")))) & in_row
    outside = (st_before == _S_OUT) & ~is_open_q & in_row
    escaped_char = ((st_before == _S_DQE) | (st_before == _S_SQE)) & in_row
    del st_before

    # escape validity: escaped char must be legal; \\u needs 4 in-row hex
    esc_ok = torch.zeros_like(in_row)
    for ch in b"\"'\\/bfnrtu":
        esc_ok |= b == ch
    bad_esc = escaped_char & ~esc_ok
    is_u = escaped_char & (b == ord("u"))
    hex_ok = _is_hex(b) & in_row
    u_ok = torch.ones_like(in_row)
    for k in range(1, 5):
        u_ok &= _shift_left(hex_ok, k, False)
    bad_esc = bad_esc | (is_u & ~u_ok)
    del esc_ok, escaped_char, is_u, hex_ok, u_ok
    next_bad_esc = _next_pos(bad_esc, BIG)
    next_close = _next_pos(is_close_q, BIG)
    del bad_esc, is_close_q

    # ---- phase 2: structural & runs -------------------------------------
    is_ws = ((b == 0x20) | (b == 0x09) | (b == 0x0A) | (b == 0x0D)) & in_row
    is_struct = ((b == ord("{")) | (b == ord("}")) | (b == ord("[")) | (b == ord("]"))
                 | (b == ord(",")) | (b == ord(":"))) & outside
    run_byte = outside & ~is_ws & ~is_struct
    del is_ws, outside
    run_start = run_byte & ~_shift_right(run_byte, 1, False)
    next_nonrun = _next_pos(~run_byte, BIG)  # first i >= here not in a run

    # ---- phase 3: number DFA + literals ---------------------------------
    nstate = _number_dfa(b, run_start, run_byte)
    done_entry = (nstate == _N_DONE) & (_shift_right(nstate, 1) != _N_DONE) & run_byte

    def match_word(word):
        ok = torch.ones_like(in_row)
        for k, ch in enumerate(word):
            ok &= (_shift_left(b, k) == ch) & _shift_left(in_row, k, False)
        return ok

    true_at = match_word(b"true")
    false_at = match_word(b"false")
    null_at = match_word(b"null")

    lit_junk = (_shift_right(run_start & true_at, 4, False)
                | _shift_right(run_start & null_at, 4, False)
                | _shift_right(run_start & false_at, 5, False)) & run_byte

    token_start = is_struct | is_open_q | run_start | done_entry | lit_junk
    del run_start, run_byte

    # ---- phase 4: per-start kind/end ------------------------------------
    is_digit_start = (b == ord("-")) | ((b >= ord("0")) & (b <= ord("9")))
    # number value end: first DONE entry or run end
    run_end = next_nonrun
    num_value_end = torch.minimum(_next_pos(done_entry, BIG), run_end)
    # number final state: state at value_end - 1
    num_final = _take_rows(nstate, torch.clamp(num_value_end - 1, 0, L - 1))
    del nstate
    num_valid = ((num_final == _N_ZERO) | (num_final == _N_INT) | (num_final == _N_FRAC)
                 | (num_final == _N_EXPD) | (num_final == _N_DONE))
    del num_final
    zcol = torch.zeros((n, 1), dtype=_I32, device=dev)
    end_idx = torch.clamp(num_value_end, 0, L)
    # digit count <= MAX_NUM_LEN over the value span
    is_digit_b = (b >= ord("0")) & (b <= ord("9")) & in_row
    dcum = torch.cat([zcol, torch.cumsum(is_digit_b, 1, dtype=_I32)], 1)
    ndigits = _take_rows(dcum, end_idx) - dcum[:, :L]
    del dcum, is_digit_b
    num_valid &= ndigits <= MAX_NUM_LEN
    del ndigits
    # float if '.' or e/E inside the value span
    dot_e = ((b == ord(".")) | (b == ord("e")) | (b == ord("E"))) & in_row
    decum = torch.cat([zcol, torch.cumsum(dot_e, 1, dtype=_I32)], 1)
    num_is_float = (_take_rows(decum, end_idx) - decum[:, :L]) > 0
    del decum, dot_e, end_idx

    # string token: end & validity
    str_bad = (next_close >= BIG - 1) | (next_bad_esc < next_close)
    del next_bad_esc

    def k8(v):  # a kind as an int8 scalar: the where-chains stay int8
        return torch.tensor(v, dtype=torch.int8, device=dev)

    struct_kind = torch.where(
        b == ord("{"), START_OBJECT, torch.where(
            b == ord("}"), END_OBJECT, torch.where(
                b == ord("["), START_ARRAY, torch.where(
                    b == ord("]"), END_ARRAY, torch.where(b == ord(","), k8(COMMA),
                                                          k8(COLON))))))
    lit_kind = torch.where(true_at, VALUE_TRUE,
                           torch.where(false_at, k8(VALUE_FALSE), k8(VALUE_NULL)))
    lit_match = true_at | false_at | null_at
    lit_len = 4 + false_at.to(_I32)
    num_kind = torch.where(num_valid, torch.where(num_is_float, k8(VALUE_NUMBER_FLOAT),
                                                  k8(VALUE_NUMBER_INT)), ERRORTOK)
    junk = done_entry | lit_junk
    kind_b = torch.where(
        is_struct, struct_kind, torch.where(
            is_open_q, torch.where(str_bad, k8(ERRORTOK), k8(VALUE_STRING)), torch.where(
                junk, ERRORTOK, torch.where(
                    is_digit_start, num_kind, torch.where(lit_match, lit_kind, ERRORTOK)))))
    end_b = torch.where(
        is_struct, pos + 1, torch.where(
            is_open_q, next_close + 1, torch.where(
                junk, run_end, torch.where(
                    is_digit_start, num_value_end,
                    torch.where(lit_match, pos + lit_len, run_end)))))

    counts = token_start.sum(1, dtype=_I32)
    return token_start, kind_b.to(_I32), end_b.to(_I32), counts, st_after


# twin: compact_tokens
def _compact_tokens(token_start, kind_b, end_b, T: int):
    """Phase 5: token-start bytes into dense [n, T] token arrays (torch, on
    the bucket's device)."""
    n, L = token_start.shape
    dev = token_start.device
    ri, li = torch.nonzero(token_start, as_tuple=True)
    rank = torch.cumsum(token_start, 1, dtype=_I32) - 1
    ci = torch.clamp(rank[ri, li], max=T - 1).to(_I64)
    tok_kind = torch.full((n, T), PAD, dtype=_U8, device=dev)
    tok_start = torch.zeros((n, T), dtype=_I32, device=dev)
    tok_end = torch.zeros((n, T), dtype=_I32, device=dev)
    tok_kind[ri, ci] = kind_b[ri, li].to(_U8)
    tok_start[ri, ci] = li.to(_I32)
    tok_end[ri, ci] = end_b[ri, li]
    return tok_kind, tok_start, tok_end


# twin: compact_tokens
def _compact_tokens_np(token_start, kind_b, end_b, T: int):
    """Numpy twin of :func:`_compact_tokens` (CPU buckets; identical
    outputs)."""
    n, L = token_start.shape
    ri, li = np.nonzero(token_start)
    rank = np.cumsum(token_start, axis=1) - 1
    ci = np.minimum(rank[ri, li], T - 1)
    tok_kind = np.full((n, T), PAD, np.uint8)
    tok_start = np.zeros((n, T), np.int32)
    tok_end = np.zeros((n, T), np.int32)
    tok_kind[ri, ci] = kind_b[ri, li]
    tok_start[ri, ci] = li
    tok_end[ri, ci] = end_b[ri, li]
    return tok_kind, tok_start, tok_end


def tokenize(bytes_mat: torch.Tensor, lens: torch.Tensor) -> TokenStream:
    """Tokenize one bucket's ``[n, L]`` byte matrix into a TokenStream on
    the bucket's device.

    One host sync reads the max token count (rounded to a power of two: the
    token capacity ``T``).  A CUDA bucket then runs the torch compaction and
    grammar loop on the card; a CPU bucket runs their numpy twins, which
    scatter only the real tokens and stop at the last live token.
    """
    n, L = bytes_mat.shape
    token_start, kind_b, end_b, counts, st_after = _scan_bytes(bytes_mat, lens)
    T = _pow2_at_least(int(counts.max()) if n else 0)
    if bytes_mat.device.type != "cpu":
        tok = _compact_tokens(token_start, kind_b, end_b, T)
        del token_start, kind_b, end_b
        res = _grammar_scan(*tok, counts)
    else:
        tok = _compact_tokens_np(token_start.numpy(), kind_b.numpy(), end_b.numpy(), T)
        res = tuple(torch.from_numpy(a) for a in _grammar_scan_np(*tok, counts.numpy()))
    return TokenStream(*res, str_state=st_after)


class _Grammar:
    """The lockstep grammar loop's state over ``n`` rows.  The step index
    lives on the device (``t``), so one step is the same kernels every time:
    on the card it is captured once as a CUDA graph and replayed.  Column 0
    of ``ctx`` and ``open_stack`` is a write sink (see json_scan._Scan)."""

    _STEP_OUT = ("depth", "expect", "err", "done")

    def __init__(self, kind, counts):
        n, T = kind.shape
        dev = kind.device
        self.depth = torch.zeros((n,), dtype=_I32, device=dev)
        self.ctx = torch.zeros((n, MAX_DEPTH + 1), dtype=_BOOL, device=dev)
        self.open_stack = torch.zeros((n, MAX_DEPTH + 1), dtype=_I32, device=dev)
        self.expect = torch.full((n,), _E_VALUE, dtype=_I32, device=dev)
        self.err = torch.zeros((n,), dtype=_BOOL, device=dev)
        self.done = torch.zeros((n,), dtype=_BOOL, device=dev)
        self.is_field_t = torch.zeros((T, n), dtype=_BOOL, device=dev)
        self.close_rec_t = torch.full((T, n), -1, dtype=_I32, device=dev)
        self.done_before_t = torch.zeros((T, n), dtype=_BOOL, device=dev)
        self.kind_t = kind.t().to(_I32).contiguous()
        self.counts = counts.to(_I32)
        self.t = torch.zeros((1,), dtype=_I64, device=dev)

    def step(self):
        t = self.t
        done, err, depth, expect = self.done, self.err, self.depth, self.expect
        self.done_before_t.index_copy_(0, t, done[None, :])
        active = ~done & ~err & (t.to(_I32) < self.counts)
        k = self.kind_t.index_select(0, t)[0]

        is_scalar = ((k == VALUE_STRING) | (k == VALUE_NUMBER_INT) | (k == VALUE_NUMBER_FLOAT)
                     | (k == VALUE_TRUE) | (k == VALUE_FALSE) | (k == VALUE_NULL))
        is_open_obj = k == START_OBJECT
        is_open_arr = k == START_ARRAY
        is_close_obj = k == END_OBJECT
        is_close_arr = k == END_ARRAY

        exp_value = (expect == _E_VALUE) | (expect == _E_VALUE_OR_CLOSE)
        take_scalar = exp_value & is_scalar
        take_open = exp_value & (is_open_obj | is_open_arr)
        take_field = ((expect == _E_FIELD_OR_CLOSE) | (expect == _E_FIELD)) & \
            (k == VALUE_STRING)
        take_colon = (expect == _E_COLON) & (k == COLON)
        take_comma_obj = (expect == _E_COMMA_OR_CLOSE_OBJ) & (k == COMMA)
        take_comma_arr = (expect == _E_COMMA_OR_CLOSE_ARR) & (k == COMMA)
        take_close_obj = ((expect == _E_FIELD_OR_CLOSE) | (expect == _E_COMMA_OR_CLOSE_OBJ)) \
            & is_close_obj
        take_close_arr = ((expect == _E_VALUE_OR_CLOSE) | (expect == _E_COMMA_OR_CLOSE_ARR)) \
            & is_close_arr
        take_close = take_close_obj | take_close_arr
        legal = (take_scalar | take_open | take_field | take_colon | take_comma_obj
                 | take_comma_arr | take_close)
        overflow = take_open & (depth >= MAX_DEPTH)
        err = err | (active & (~legal | overflow))
        do = active & legal & ~overflow

        push = do & take_open
        pop = do & take_close
        depth2 = depth + push.to(_I32) - pop.to(_I32)
        # matching open for a close: top of stack (read BEFORE this push)
        sel_pop = (torch.clamp(depth2, 0, MAX_DEPTH - 1) + 1).to(_I64)[:, None]
        popped_open = torch.gather(self.open_stack, 1, sel_pop)[:, 0]
        popped_is_obj = torch.gather(self.ctx, 1, sel_pop)[:, 0]
        sel = torch.where(push, torch.clamp(depth, 0, MAX_DEPTH - 1) + 1, 0).to(_I64)[:, None]
        self.ctx.scatter_(1, sel, is_open_obj[:, None])
        self.open_stack.scatter_(1, sel, t.to(_I32).expand(sel.shape))
        # recorded before the mismatch filter (the row errs anyway)
        self.close_rec_t.index_copy_(0, t, torch.where(pop, popped_open, -1)[None, :])
        mismatch = pop & (popped_is_obj != is_close_obj)
        err = err | mismatch
        do = do & ~mismatch
        pop = pop & ~mismatch
        depth2 = torch.where(mismatch, depth, depth2)

        completed = do & (take_scalar | pop)
        at_root = completed & (depth2 == 0)
        self.done = done | at_root
        parent_sel = (torch.clamp(depth2 - 1, 0, MAX_DEPTH - 1) + 1).to(_I64)[:, None]
        parent_obj = torch.gather(self.ctx, 1, parent_sel)[:, 0]
        after_value = torch.where(parent_obj, _E_COMMA_OR_CLOSE_OBJ, _E_COMMA_OR_CLOSE_ARR)
        self.expect = torch.where(
            completed & ~at_root, after_value, torch.where(
                do & take_open & is_open_obj, _E_FIELD_OR_CLOSE, torch.where(
                    do & take_open & is_open_arr, _E_VALUE_OR_CLOSE, torch.where(
                        do & take_field, _E_COLON, torch.where(
                            do & take_colon, _E_VALUE, torch.where(
                                do & take_comma_obj, _E_FIELD, torch.where(
                                    do & take_comma_arr, _E_VALUE, expect))))))).to(_I32)
        self.is_field_t.index_copy_(0, t, (do & take_field)[None, :])
        self.err = err
        self.depth = depth2
        self.t += 1

    def capture(self):
        """One step as a CUDA graph over the current state tensors."""
        static = {f: getattr(self, f) for f in self._STEP_OUT}
        graph = torch.cuda.CUDAGraph()
        with _device.graph_capture(graph):
            self.step()
            for f, v in static.items():
                v.copy_(getattr(self, f))
                setattr(self, f, v)
        return graph

    def live(self, t: int) -> bool:
        return bool((~self.done & ~self.err & (t < self.counts)).any())


# twin: grammar_scan
def _grammar_scan(kind, start, end, counts):
    """Lockstep grammar validation + match computation + separator drop
    (torch, on the tokens' device).  Steps stop once no row is live
    (checked every ``_CHECK_EVERY`` steps); the steps left would change
    nothing.  On the card each step after the first check is a replay of
    one captured CUDA graph."""
    n, T = kind.shape
    dev = kind.device
    g = _Grammar(kind, counts)
    graph = None
    for t in range(T):
        if t % _CHECK_EVERY == 0 and t and not g.live(t):
            g.done_before_t[t:] = g.done[None, :]
            break
        if dev.type == "cuda" and t >= _CHECK_EVERY:
            if graph is None:
                graph = g.capture()
            graph.replay()
        else:
            g.step()
    del graph
    counts = g.counts
    done, err = g.done, g.err

    ok = done & ~err  # err can only be set while not done
    is_field = g.is_field_t.t()
    close_rec = g.close_rec_t.t()
    done_before = g.done_before_t.t()
    del g
    kind = torch.where(is_field, FIELD_NAME, kind.to(_I32)).to(_U8)
    tok_idx = torch.arange(T, dtype=_I32, device=dev)[None, :].expand(n, T)
    match = tok_idx.clone()
    ri, ti = torch.nonzero(close_rec >= 0, as_tuple=True)
    match[ri, close_rec[ri, ti].to(_I64)] = ti.to(_I32)
    match = torch.where(close_rec >= 0, close_rec, match)

    keep = (~done_before & (kind != COMMA) & (kind != COLON) & (kind != PAD)
            & (tok_idx < counts[:, None]))
    new_idx = torch.cumsum(keep, 1, dtype=_I32) - 1
    n_tokens = keep.sum(1, dtype=_I32)
    ri, ti = torch.nonzero(keep, as_tuple=True)
    ci = new_idx[ri, ti].to(_I64)

    def compact(vals, fill, dtype):
        out = torch.full((n, T), fill, dtype=dtype, device=dev)
        out[ri, ci] = vals[ri, ti].to(dtype)
        return out

    kind2 = compact(kind, PAD, _U8)
    start2 = compact(start, 0, _I32)
    end2 = compact(end, 0, _I32)
    match_new = _take_rows(new_idx, torch.clamp(match, 0, T - 1))
    match2 = compact(match_new, 0, _I32)
    trailing = (done_before & (tok_idx < counts[:, None])).any(1)
    return kind2, start2, end2, match2, n_tokens, ok, trailing


# twin: grammar_scan
def _grammar_scan_np(kind, start, end, counts):
    """Numpy twin of :func:`_grammar_scan` (copied from the JAX package):
    identical grammar and outputs, with microsecond op dispatch and an exit
    at the last live token."""
    n, T = kind.shape
    rows = np.arange(n, dtype=np.int32)
    depth = np.zeros((n,), np.int32)
    ctx = np.zeros((n, MAX_DEPTH), bool)
    open_stack = np.zeros((n, MAX_DEPTH), np.int32)
    expect = np.full((n,), _E_VALUE, np.int32)
    err = np.zeros((n,), bool)
    done = np.zeros((n,), bool)
    is_field = np.zeros((n, T), bool)
    close_rec = np.full((n, T), -1, np.int32)
    done_before = np.zeros((n, T), bool)

    for t in range(T):
        done_before[:, t] = done
        active = ~done & ~err & (t < counts)
        if not active.any():
            done_before[:, t:] = done[:, None]
            break
        k = kind[:, t].astype(np.int32)

        is_scalar = (
            (k == VALUE_STRING) | (k == VALUE_NUMBER_INT)
            | (k == VALUE_NUMBER_FLOAT) | (k == VALUE_TRUE)
            | (k == VALUE_FALSE) | (k == VALUE_NULL)
        )
        is_open_obj = k == START_OBJECT
        is_open_arr = k == START_ARRAY
        is_close_obj = k == END_OBJECT
        is_close_arr = k == END_ARRAY
        is_comma = k == COMMA
        is_colon = k == COLON

        exp_value = (expect == _E_VALUE) | (expect == _E_VALUE_OR_CLOSE)

        take_scalar = exp_value & is_scalar
        take_open = exp_value & (is_open_obj | is_open_arr)
        take_field = (
            ((expect == _E_FIELD_OR_CLOSE) | (expect == _E_FIELD))
            & (k == VALUE_STRING)
        )
        take_colon = (expect == _E_COLON) & is_colon
        take_comma_obj = (expect == _E_COMMA_OR_CLOSE_OBJ) & is_comma
        take_comma_arr = (expect == _E_COMMA_OR_CLOSE_ARR) & is_comma
        take_close_obj = (
            ((expect == _E_FIELD_OR_CLOSE) | (expect == _E_COMMA_OR_CLOSE_OBJ))
            & is_close_obj
        )
        take_close_arr = (
            ((expect == _E_VALUE_OR_CLOSE) | (expect == _E_COMMA_OR_CLOSE_ARR))
            & is_close_arr
        )
        take_close = take_close_obj | take_close_arr
        legal = (
            take_scalar | take_open | take_field | take_colon
            | take_comma_obj | take_comma_arr | take_close
        )
        overflow = take_open & (depth >= MAX_DEPTH)
        err = err | (active & (~legal | overflow))
        do = active & legal & ~overflow

        push = do & take_open
        pop = do & take_close
        depth2 = depth + push.astype(np.int32) - pop.astype(np.int32)
        sel = np.clip(depth, 0, MAX_DEPTH - 1)
        pr = np.nonzero(push)[0]
        # matching open for a close: top of stack (read BEFORE this push)
        sel_pop = np.clip(depth2, 0, MAX_DEPTH - 1)
        popped_open = open_stack[rows, sel_pop]
        popped_is_obj = ctx[rows, sel_pop]
        ctx[pr, sel[pr]] = is_open_obj[pr]
        open_stack[pr, sel[pr]] = t
        # recorded PRE-mismatch-filter, exactly like the torch form (the
        # row errs anyway; keeping the record keeps ts.match bit-identical)
        close_rec[:, t] = np.where(pop, popped_open, -1)
        mismatch = pop & (popped_is_obj != is_close_obj)
        err = err | mismatch
        do = do & ~mismatch
        pop = pop & ~mismatch
        depth2 = np.where(mismatch, depth, depth2)

        completed = do & (take_scalar | pop)
        at_root = completed & (depth2 == 0)
        done = done | at_root
        parent_sel = np.clip(depth2 - 1, 0, MAX_DEPTH - 1)
        parent_obj = ctx[rows, parent_sel]
        after_value = np.where(
            parent_obj, _E_COMMA_OR_CLOSE_OBJ, _E_COMMA_OR_CLOSE_ARR
        )

        expect = np.where(
            completed & ~at_root, after_value,
            np.where(
                do & take_open & is_open_obj, _E_FIELD_OR_CLOSE,
                np.where(
                    do & take_open & is_open_arr, _E_VALUE_OR_CLOSE,
                    np.where(
                        do & take_field, _E_COLON,
                        np.where(
                            do & take_colon, _E_VALUE,
                            np.where(
                                do & take_comma_obj, _E_FIELD,
                                np.where(
                                    do & take_comma_arr, _E_VALUE, expect
                                ),
                            ),
                        ),
                    ),
                ),
            ),
        ).astype(np.int32)
        is_field[:, t] = do & take_field
        depth = depth2

    ok = done & ~err  # err can only be set while not done

    kind = np.where(is_field, np.uint8(FIELD_NAME), kind)
    tok_idx = np.broadcast_to(np.arange(T, dtype=np.int32)[None, :], (n, T))
    match = tok_idx.copy()
    ri, ti = np.nonzero(close_rec >= 0)
    match[ri, close_rec[ri, ti]] = ti
    has_close = close_rec >= 0
    match = np.where(has_close, close_rec, match)

    keep = (
        ~done_before
        & (kind != np.uint8(COMMA))
        & (kind != np.uint8(COLON))
        & (kind != np.uint8(PAD))
        & (tok_idx < counts[:, None])
    )
    new_idx = np.cumsum(keep.astype(np.int32), axis=1) - 1
    n_tokens = np.sum(keep, axis=1, dtype=np.int32)

    ri, ti = np.nonzero(keep)
    ci = new_idx[ri, ti]

    def compact(vals, fill, dtype):
        out = np.full((n, T), fill, dtype=dtype)
        out[ri, ci] = vals[ri, ti]
        return out

    kind2 = compact(kind, PAD, np.uint8)
    start2 = compact(np.asarray(start), 0, np.int32)
    end2 = compact(np.asarray(end), 0, np.int32)
    match_new = new_idx[rows[:, None], np.clip(match, 0, T - 1)]
    match2 = compact(match_new, 0, np.int32)

    trailing = np.any(done_before & (tok_idx < counts[:, None]), axis=1)
    return kind2, start2, end2, match2, n_tokens, ok, trailing.astype(bool)
