"""Spark ``from_json`` for MAP<STRING,STRING>: raw key/value span extraction
(PyTorch port of ``ops/from_json.py``).

Parity target: ``MapUtils.extractRawMapFromJsonString`` (MapUtils.java:31-53)
over ``from_json`` (map_utils.cu:644).  Per row of JSON text, every
*top-level object field* becomes one ``STRUCT<STRING,STRING>`` entry in a
``LIST`` column:

- keys: the field-name bytes without quotes, raw (no unescaping) --
  map_utils.cu node_ranges_fn (include_quote_char=false, :394-449);
- values: raw spans -- string values lose their quotes, numbers/literals are
  their exact text, nested objects/arrays keep their *entire original text*
  including internal whitespace (``[4,{},null,{"a":[{ }, {}] } ]``);
- null input rows -> null list rows (the reference replaces them with ``{}``
  before the parse and copies the input validity, map_utils.cu:86-90,:722);
- non-object rows contribute zero pairs (empty list);
- any malformed non-null row raises (the reference throws on any tokenizer
  error in the concatenated buffer, map_utils.cu:113-135 throw_if_error) --
  a whole-column error, not a per-row null.

Rows tokenize independently on their length bucket (ops/json_tokenizer.py);
with per-row token streams, "parent is the row object" is simply
"FIELD_NAME at container depth 1 under a root object", and the value is the
following token (its span extended to the matching close for containers).
Classification, pair compaction and the char gathers run on the column's
device; the host reads only scalar decisions (the malformed-row check, pair
counts, span widths and the output byte total).  Buckets are cut into row
chunks of at most ``get_json_object.CHUNK_BYTES`` padded bytes, as the
get_json_object device arm does (per-row work: the outputs do not change).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.columnar.column import ListColumn, StringColumn, StructColumn
from spark_rapids_jni_tpu_torch.ops import json_tokenizer as jt

__all__ = ["from_json", "JsonParsingException"]

_I32 = torch.int32
_I64 = torch.int64


class JsonParsingException(ValueError):
    """Malformed JSON in from_json input (maps the reference's throw);
    ``row`` is the first malformed row of the narrowest length bucket that
    holds one, as in the JAX package."""

    def __init__(self, msg: str, row: int = -1):
        super().__init__(msg)
        self.row = row


class _Classified(NamedTuple):
    bad: torch.Tensor  # [nr] malformed non-null row
    is_key: torch.Tensor  # [nr, T] top-level field names of valid rows
    krank: torch.Tensor  # [nr, T] within-row pair rank
    kstart: torch.Tensor  # [nr, T] key payload span (quotes stripped)
    kend: torch.Tensor
    vstart: torch.Tensor  # [nr, T] raw value span
    vend: torch.Tensor


def _classify(kind, start, end, match, ntok, ok, trailing, row_valid) -> _Classified:
    """Token-stream classification: which tokens are top-level keys, and the
    key/value spans of each."""
    nr, T = kind.shape
    bad = row_valid & (~ok | trailing)

    tok_idx = torch.arange(T, dtype=_I32, device=kind.device)[None, :]
    in_tok = tok_idx < ntok[:, None]
    opens = ((kind == jt.START_OBJECT) | (kind == jt.START_ARRAY)) & in_tok
    closes = ((kind == jt.END_OBJECT) | (kind == jt.END_ARRAY)) & in_tok
    depth_after = torch.cumsum(opens.to(_I32) - closes.to(_I32), 1, dtype=_I32)
    depth_before = depth_after - opens.to(_I32) + closes.to(_I32)
    root_is_obj = (kind[:, 0] == jt.START_OBJECT) & (ntok > 0)
    is_key = ((kind == jt.FIELD_NAME) & (depth_before == 1) & in_tok & root_is_obj[:, None]
              & row_valid[:, None] & ~bad[:, None])
    krank = torch.cumsum(is_key, 1, dtype=_I32) - 1

    vt = torch.clamp(tok_idx + 1, 0, T - 1).to(_I64).expand(nr, T)
    vkind = torch.gather(kind, 1, vt)
    vstart = torch.gather(start, 1, vt)
    vend0 = torch.gather(end, 1, vt)
    vmatch = torch.clamp(torch.gather(match, 1, vt), 0, T - 1).to(_I64)
    close_end = torch.gather(end, 1, vmatch)
    is_str = vkind == jt.VALUE_STRING
    is_container = (vkind == jt.START_OBJECT) | (vkind == jt.START_ARRAY)
    vstart = torch.where(is_str, vstart + 1, vstart)
    vend = torch.where(is_container, close_end, torch.where(is_str, vend0 - 1, vend0))
    return _Classified(bad=bad, is_key=is_key, krank=krank, kstart=start + 1, kend=end - 1,
                       vstart=vstart, vend=vend)


class _Pairs(NamedTuple):
    """Compacted per-chunk pair records ([npairs] tensors)."""

    loc_row: torch.Tensor  # chunk-local row index
    glob_row: torch.Tensor  # full-column row index
    krank: torch.Tensor
    ks: torch.Tensor
    ke: torch.Tensor
    vs: torch.Tensor
    ve: torch.Tensor


def _compact(cl: _Classified, rows) -> _Pairs:
    """The key tokens as pair records, in row-major token order."""
    ri, ti = torch.nonzero(cl.is_key, as_tuple=True)
    return _Pairs(loc_row=ri, glob_row=rows[ri], krank=cl.krank[ri, ti],
                  ks=cl.kstart[ri, ti], ke=cl.kend[ri, ti],
                  vs=cl.vstart[ri, ti], ve=cl.vend[ri, ti])


def _scatter_span_bytes(chars, b_bytes, loc, s, e, dst_off, W: int):
    """Copy each selected pair's [s, e) bytes into chars at dst_off."""
    lane = torch.arange(W, dtype=_I64, device=chars.device)[None, :]
    src = torch.clamp(s.to(_I64)[:, None] + lane, 0, b_bytes.shape[1] - 1)
    mat = b_bytes[loc[:, None], src]
    in_b = lane < (e - s).to(_I64)[:, None]
    dst = dst_off.to(_I64)[:, None] + lane
    chars[dst[in_b]] = mat[in_b]


def from_json(col: StringColumn) -> ListColumn:
    """Extract raw top-level key/value pairs per row.

    Returns ``LIST<STRUCT<STRING,STRING>>`` with the input's validity, on the
    column's device.  Raises :class:`JsonParsingException` naming the first
    malformed non-null row.
    """
    from spark_rapids_jni_tpu_torch.ops.get_json_object import _device_chunks

    n = col.size
    dev = col.device
    in_valid = col.is_valid()
    if n == 0:
        empty = StringColumn(torch.zeros((0,), dtype=torch.uint8, device=dev),
                             torch.zeros((1,), dtype=_I32, device=dev), None)
        return ListColumn(torch.zeros((1,), dtype=_I32, device=dev),
                          StructColumn((empty, empty), None), None)

    # chunks tokenize + classify in groups of json_overlap_bytes of padded
    # input; one batched pull per group reads (any-bad, bad-row, pair count)
    # of each chunk, and the group's [nr, T] matrices are freed as it drains
    group_budget = max(int(config.get("json_overlap_bytes")), 1)
    pair_counts = torch.zeros((n,), dtype=_I64, device=dev)
    recs = []  # (chunk, _Pairs)

    def _drain(group):
        geom = torch.stack([g[2] for g in group]).tolist()
        for i, (any_bad, bad_row, npairs) in enumerate(geom):
            ch, cl, _ = group[i]
            group[i] = None
            if any_bad:  # malformed non-null row: whole-op throw
                raise JsonParsingException(
                    f"JSON Parser encountered an invalid format at row {int(bad_row)}",
                    int(bad_row))
            if npairs == 0:
                continue
            pair_counts[ch.rows] += cl.is_key.sum(1, dtype=_I64)
            recs.append((ch, _compact(cl, ch.rows)))

    group, group_bytes = [], 0
    for ch in _device_chunks(col):
        ts = jt.tokenize(ch.bytes, ch.lengths)
        row_valid = in_valid[ch.rows]
        cl = _classify(ts.kind, ts.start, ts.end, ts.match, ts.n_tokens, ts.ok, ts.trailing,
                       row_valid)
        del ts
        any_bad = cl.bad.any().to(_I64)
        bad_row = ch.rows[torch.argmax(cl.bad.to(_I32))].to(_I64)
        cbytes = int(ch.bytes.shape[0]) * int(ch.bytes.shape[1])
        if group and group_bytes + cbytes > group_budget:
            _drain(group)
            group, group_bytes = [], 0
        group.append((ch, cl, torch.stack([any_bad, bad_row, cl.is_key.sum(dtype=_I64)])))
        group_bytes += cbytes
    if group:
        _drain(group)

    offsets = torch.zeros((n + 1,), dtype=_I64, device=dev)
    offsets[1:] = torch.cumsum(pair_counts, 0)
    total = int(offsets[-1])
    keys = _gather_spans(total, recs, lambda p: (p.ks, p.ke), offsets, dev)
    values = _gather_spans(total, recs, lambda p: (p.vs, p.ve), offsets, dev)
    return ListColumn(offsets.to(_I32), StructColumn((keys, values), None), col.validity)


def _gather_spans(total, recs, get_span, row_offsets, dev) -> StringColumn:
    """Assemble a StringColumn from per-chunk pair records.

    Final pair position = row_offsets[row] + within-row rank, so output
    order is row-major regardless of bucket assignment.  Host syncs: the
    output byte total and the chunks' max span widths (one batched pull).
    """
    if total == 0:
        return StringColumn(torch.zeros((0,), dtype=torch.uint8, device=dev),
                            torch.zeros((1,), dtype=_I32, device=dev), None)
    lens = torch.zeros((total,), dtype=_I64, device=dev)
    positions = []
    for _ch, p in recs:
        s, e = get_span(p)
        pos = row_offsets[p.glob_row] + p.krank.to(_I64)
        positions.append(pos)
        lens[pos] = (e - s).to(_I64)
    offs = torch.zeros((total + 1,), dtype=_I64, device=dev)
    offs[1:] = torch.cumsum(lens, 0)
    pulled = torch.stack([offs[-1]] + [(get_span(p)[1] - get_span(p)[0]).max().to(_I64)
                                       for _ch, p in recs]).tolist()
    chars = torch.zeros((int(pulled[0]),), dtype=torch.uint8, device=dev)
    for (ch, p), pos, wmax in zip(recs, positions, pulled[1:]):
        s, e = get_span(p)
        _scatter_span_bytes(chars, ch.bytes, p.loc_row, s, e, offs[pos], max(int(wmax), 1))
    return StringColumn(chars, offs.to(_I32), None)
