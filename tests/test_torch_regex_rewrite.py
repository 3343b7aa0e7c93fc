"""The PyTorch port's ``literal_range_pattern`` and ``decode_utf8`` against
the JAX package on the CPU, bit for bit, and against the brute-force oracle
of tests/test_regex_rewrite.py: the RegexRewriteUtilsTest vectors, a seeded
fuzz over ASCII and CJK characters with nulls and empty rows, and a column
whose rows span several length buckets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar.column import strings_column as jstrings
from spark_rapids_jni_tpu.ops.regex_rewrite import literal_range_pattern as jlrp
from spark_rapids_jni_tpu.utils.utf8 import decode_utf8 as jdecode
from spark_rapids_jni_tpu_torch import ops
from spark_rapids_jni_tpu_torch.columnar.column import strings_column
from spark_rapids_jni_tpu_torch.ops.regex_rewrite import literal_range_pattern
from spark_rapids_jni_tpu_torch.utils.utf8 import decode_utf8
from tests.test_regex_rewrite import _oracle

_ALPHABET = list("ab1英伟9x") + ["\U0001F600", "é"]


def fuzz_rows(n, seed, max_chars=12):
    rng = np.random.default_rng(seed)
    rows = ["".join(_ALPHABET[i] for i in rng.integers(0, len(_ALPHABET),
                                                        rng.integers(0, max_chars + 1)))
            for _ in range(n)]
    return rows + [None, "", "ab", "ab11", "xab119", "英伟达1"]


def _same_bools(got, want):
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    if want.validity is None:
        assert got.validity is None
    else:
        np.testing.assert_array_equal(got.validity.numpy(), np.asarray(want.validity))


def test_reference_vectors():
    col = strings_column(["abc123", "aabc123", "aabc12", "abc1232", "aabc1232"], device="cpu")
    assert ops.literal_range_pattern(col, "abc", 3, 48, 57).to_list() == \
        [True, True, False, True, True]
    col = strings_column(["数据砖块", "火花-急流英伟达", "英伟达Nvidia", "火花-急流"], device="cpu")
    assert ops.literal_range_pattern(col, "英", 2, 19968, 40869).to_list() == \
        [False, True, True, False]


PATTERNS = [("ab", 2, 48, 57), ("英", 1, 19968, 40869), ("", 3, 0x61, 0x7A),
            ("x", 0, 0, 0), ("a", 1, 0x1F600, 0x1F64F)]


@pytest.mark.parametrize("prefix,range_len,lo,hi", PATTERNS)
def test_fuzz_matches_jax_and_oracle(prefix, range_len, lo, hi):
    rows = fuzz_rows(200, seed=7)
    got = literal_range_pattern(strings_column(rows, device="cpu"), prefix, range_len, lo, hi)
    _same_bools(got, jlrp(jstrings(rows), prefix, range_len, lo, hi))
    assert got.to_list() == [_oracle(s, prefix, range_len, lo, hi) for s in rows]


def test_rows_across_buckets():
    rows = fuzz_rows(40, seed=9) + ["x" * 40 + "ab12", "英" * 30 + "ab9", "b" * 130 + "ab00"]
    got = literal_range_pattern(strings_column(rows, device="cpu"), "ab", 2, 48, 57)
    _same_bools(got, jlrp(jstrings(rows), "ab", 2, 48, 57))
    assert got.to_list()[-3:] == [True, False, True]


def test_decode_utf8_matches_jax():
    rows = [s.encode() for s in fuzz_rows(64, seed=3) if s is not None]
    width = max(len(r) for r in rows) + 3
    padded = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = np.frombuffer(r, np.uint8)
    lens = np.array([len(r) for r in rows], np.int32)
    cp, nch = decode_utf8(torch.from_numpy(padded), torch.from_numpy(lens))
    jcp, jnch = jdecode(jnp.asarray(padded), jnp.asarray(lens))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(jcp))
    np.testing.assert_array_equal(nch.numpy(), np.asarray(jnch))
    assert [list(map(chr, cp[i, :nch[i]].tolist())) for i in range(3)] == \
        [list(r.decode()) for r in rows[:3]]
