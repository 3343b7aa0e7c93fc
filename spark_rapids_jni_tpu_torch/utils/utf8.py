"""Vectorized UTF-8 decoding over padded byte matrices (PyTorch port of
``utils/utf8.py``).

Several reference kernels operate on *characters* (codepoints) rather than
bytes: cudf::string_view indexes by character (regex_rewrite_utils.cu,
parse_uri.cu's UTF-8 handling).  This module decodes a dense ``[n, L]`` byte
matrix into a character-indexed codepoint matrix with elementwise torch:
classify lead bytes, read up to 3 continuation bytes through static shifts,
then compact to char positions with a cumsum scatter.

No validation is performed (matching cudf's permissive utf8 decode): invalid
sequences decode to whatever the bytes say.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def decode_utf8(padded: torch.Tensor, lens: torch.Tensor):
    """Decode ``bytes[n, L]`` (lengths in bytes) to characters.

    Returns ``(cp[n, L] int32, nchars[n] int32)`` where ``cp[:, k]`` is the
    codepoint of character ``k`` (0 beyond ``nchars``).  The output is
    char-compacted: column k holds the k-th character, not the byte at k.
    """
    n, L = padded.shape
    b = padded.to(torch.int32)
    pos = torch.arange(L, dtype=torch.int32, device=b.device)[None, :]
    in_str = pos < lens.to(torch.int32)[:, None]

    is_cont = (b & 0xC0) == 0x80
    is_lead = in_str & ~is_cont
    # bytes of the sequence: static shifts, zeros beyond L
    bp = F.pad(b, (0, 3))
    b1, b2, b3 = bp[:, 1:L + 1], bp[:, 2:L + 2], bp[:, 3:L + 3]

    one = b < 0x80
    two = (b & 0xE0) == 0xC0
    three = (b & 0xF0) == 0xE0
    # four = (b & 0xF8) == 0xF0 (the fall-through case)
    cp = torch.where(
        one, b,
        torch.where(
            two, ((b & 0x1F) << 6) | (b1 & 0x3F),
            torch.where(
                three, ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F),
                ((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6)
                | (b3 & 0x3F))))

    # compact to character positions: a non-lead byte goes to a spare column
    char_idx = torch.cumsum(is_lead.to(torch.int32), dim=1) - 1
    nchars = is_lead.sum(dim=1).to(torch.int32)
    out = torch.zeros((n, L + 1), dtype=torch.int32, device=b.device)
    tgt = torch.where(is_lead, char_idx, L).to(torch.int64)
    out.scatter_(1, tgt, torch.where(is_lead, cp, 0))
    return out[:, :L], nchars
