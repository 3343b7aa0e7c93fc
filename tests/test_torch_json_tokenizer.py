"""The PyTorch port's JSON tokenizer against the JAX package on the CPU.

The same byte rectangles (the JAX package's padded buckets of the tokenizer
corpus of tests/test_json_tokenizer.py and of a seeded fuzz of nested,
escaped, single-quoted and mutated documents) go through the port's
``tokenize`` and the JAX package's ``json_tokenizer.tokenize``; tolerance 0 on
every TokenStream field.  The port's torch compaction and grammar loop (the
card's path), forced on CPU tensors, are held against its numpy twins.
"""

import importlib

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import columnar as jc
from spark_rapids_jni_tpu.columnar.buckets import padded_buckets as jpadded_buckets
from spark_rapids_jni_tpu.ops import json_tokenizer as jjt
from spark_rapids_jni_tpu_torch.columnar.column import strings_from_bytes
from spark_rapids_jni_tpu_torch.ops import json_tokenizer as tjt

import json_oracle as jo
from test_json_tokenizer import CORPUS

FIELDS = ["kind", "start", "end", "match", "n_tokens", "ok", "trailing", "str_state"]

_ATOMS = [b"1", b"-0", b"0", b"-17", b"3.5", b"1e4", b"-2.5E-3", b"6.02e+23", b"true",
          b"false", b"null", b'"s"', b"'sq'", b'"a\\"b"', b'"\\u00e9x"', b'"\\t\\n\\\\"',
          b'"\\/"', b"'it\\'s'", b'""', b"00", b"1.", b".5", b"nul", b'"\\x"', b'"\\u12"']


def _fuzz_doc(rng, depth=0) -> bytes:
    r = rng.random()
    if depth > 4 or r < 0.3:
        return _ATOMS[rng.integers(len(_ATOMS))]
    k = int(rng.integers(0, 4))
    ws = b" " if rng.random() < 0.3 else b""
    if r < 0.6:
        return b"[" + (b"," + ws).join(_fuzz_doc(rng, depth + 1) for _ in range(k)) + b"]"
    return b"{" + b",".join(b'"k%d"' % i + ws + b":" + _fuzz_doc(rng, depth + 1)
                            for i in range(k)) + b"}"


def _mutate(rng, s: bytes) -> bytes:
    if not s:
        return s
    i = int(rng.integers(len(s)))
    op = rng.random()
    ch = bytes([int(rng.integers(32, 127))])
    if op < 0.4:
        return s[:i] + ch + s[i + 1:]
    if op < 0.7:
        return s[:i] + s[i + 1:]
    return s[:i] + ch + s[i:]


def fuzz_rows(seed=11, n=240):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n // 3):
        s = _fuzz_doc(rng)
        out += [s, _mutate(rng, s), b"  " + s + b" tail"]
    out.append(b"[" * 70)  # nesting past MAX_DEPTH
    return out


SOURCES = {"corpus": CORPUS, "fuzz": fuzz_rows()}
_CACHE = {}


def _tokenized(source):
    """Per JAX bucket: (its bytes and lengths as torch, JAX TokenStream as
    numpy, port TokenStream) -- computed once per source."""
    if source not in _CACHE:
        out = []
        for b in jpadded_buckets(jc.strings_from_bytes(SOURCES[source])):
            jts = jjt.tokenize(b.bytes, b.lengths)
            bytes_t = torch.from_numpy(np.array(b.bytes))
            lens_t = torch.from_numpy(np.array(b.lengths))
            out.append((bytes_t, lens_t, {f: np.asarray(getattr(jts, f)) for f in FIELDS},
                        tjt.tokenize(bytes_t, lens_t)))
        _CACHE[source] = out
    return _CACHE[source]


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_tokenize_matches_jax(source, field):
    for _b, _l, jts, pts in _tokenized(source):
        got = getattr(pts, field).numpy()
        want = jts[field]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{source}: {field}")
        if field != "n_tokens":  # int32 in the port; the JAX numpy twin's is int64
            assert got.dtype == want.dtype, field


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_torch_compaction_and_grammar_equal_numpy_twins(source):
    """The card's path (torch compaction, lockstep grammar loop with its
    early stop), forced on CPU tensors, against the numpy twins."""
    for bytes_t, lens_t, _j, pts in _tokenized(source):
        token_start, kind_b, end_b, counts, _st = tjt._scan_bytes(bytes_t, lens_t)
        T = tjt._pow2_at_least(int(counts.max()))
        tok = tjt._compact_tokens(token_start, kind_b, end_b, T)
        tok_np = tjt._compact_tokens_np(token_start.numpy(), kind_b.numpy(), end_b.numpy(), T)
        for a, b in zip(tok, tok_np):
            np.testing.assert_array_equal(a.numpy(), b)
        res = tjt._grammar_scan(*tok, counts)
        res_np = tjt._grammar_scan_np(*tok_np, counts.numpy())
        for name, a, b in zip(FIELDS, res, res_np):
            assert a.numpy().dtype == b.dtype, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        for name, a in zip(FIELDS, res):  # and the tokenize the CPU takes
            np.testing.assert_array_equal(a.numpy(), getattr(pts, name).numpy())


def test_grammar_loop_early_stop_matches_full_scan(monkeypatch):
    """Checking for live rows every step or every 16 gives the same stream
    (a step with no live row changes nothing)."""
    rows = [b'{"a":[1,{"b":2},3],"c":{}}', b"[1,2] junk", b"{", b"[" * 40 + b"]" * 40]
    col = strings_from_bytes(rows, device="cpu")
    bytes_t, lens_t = col.padded(64)
    token_start, kind_b, end_b, counts, _st = tjt._scan_bytes(bytes_t, lens_t)
    T = tjt._pow2_at_least(int(counts.max()))
    tok = tjt._compact_tokens(token_start, kind_b, end_b, T)
    every16 = tjt._grammar_scan(*tok, counts)
    monkeypatch.setattr(tjt, "_CHECK_EVERY", 1)
    every1 = tjt._grammar_scan(*tok, counts)
    for a, b in zip(every16, every1):
        assert torch.equal(a, b)


def test_tokens_match_the_sequential_oracle():
    """Valid rows tokenize to the oracle parser's (kind, start, end) stream,
    and every row gets the oracle's valid/invalid verdict."""
    for bytes_t, lens_t, _j, pts in _tokenized("corpus") + _tokenized("fuzz"):
        for i in range(bytes_t.shape[0]):
            data = bytes(bytes_t[i, :int(lens_t[i])].tolist())
            p = jo._Parser(data)
            toks, ok = [], None
            while ok is None:
                t = p.next_token()
                if t in (jo.SUCCESS, jo.ERRORTOK):
                    ok = t == jo.SUCCESS
                else:
                    toks.append((t, p.span()[0], p.span()[1]))
            assert bool(pts.ok[i]) == ok, data
            if ok:
                got = [(int(pts.kind[i, t]), int(pts.start[i, t]), int(pts.end[i, t]))
                       for t in range(int(pts.n_tokens[i]))]
                assert got == toks, data


def test_module_is_importable_without_jax_names():
    mod = importlib.import_module("spark_rapids_jni_tpu_torch.ops.json_tokenizer")
    assert mod.MAX_DEPTH == jjt.MAX_DEPTH and mod.MAX_NUM_LEN == jjt.MAX_NUM_LEN
    assert (mod.START_OBJECT, mod.FIELD_NAME, mod.VALUE_NULL) == \
        (jjt.START_OBJECT, jjt.FIELD_NAME, jjt.VALUE_NULL)
