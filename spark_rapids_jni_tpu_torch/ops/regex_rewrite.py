"""Fast-path replacement for the regex ``literal[start-end]{len,}`` (PyTorch
port of ``ops/regex_rewrite.py``).

Parity with the reference's literal_range_pattern (regex_rewrite_utils.cu:37
literal_range_pattern_fn): True where the string contains the literal prefix
immediately followed by at least ``range_len`` characters whose codepoints lie
in ``[start, end]``.  Null rows yield null (mask copied; stored value False).

The string column is decoded per length bucket to a char-compacted codepoint
matrix (utils.utf8) and the match is a shifted-AND reduction: for window
origin i, prefix equality uses ``m`` static shifts and the range check
``range_len`` more, all elementwise over ``[rows, chars]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spark_rapids_jni_tpu_torch.columnar.buckets import map_buckets
from spark_rapids_jni_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_jni_tpu_torch.columnar.dtypes import BOOL
from spark_rapids_jni_tpu_torch.utils.utf8 import decode_utf8


def literal_range_pattern(
    input: StringColumn, prefix: str, range_len: int, start: int, end: int
) -> Column:
    """Does each row match ``prefix`` + ``range_len`` chars in [start, end]?"""
    pat = [ord(c) for c in prefix]
    m = len(pat)
    window = m + range_len

    def kernel(padded, lens):
        cp, nchars = decode_utf8(padded, lens)
        n, L = cp.shape
        # pad chars so static window shifts stay in bounds
        cp_ext = F.pad(cp, (0, window), value=-1)
        ok = torch.ones((n, L), dtype=torch.bool, device=cp.device)
        for j, pc in enumerate(pat):
            ok &= cp_ext[:, j:j + L] == pc
        for j in range(range_len):
            c = cp_ext[:, m + j:m + j + L]
            ok &= (c >= start) & (c <= end)
        # origin must satisfy i <= nchars - m - range_len
        pos = torch.arange(L, dtype=torch.int32, device=cp.device)[None, :]
        return ((ok & (pos <= (nchars - window)[:, None])).any(dim=1),)

    (found,) = map_buckets(input, kernel, [((), torch.bool)])
    found = torch.where(input.is_valid(), found, False)
    return Column(found, input.validity, BOOL)
