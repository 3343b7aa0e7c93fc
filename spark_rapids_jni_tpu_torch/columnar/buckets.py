"""Length- and value-class buckets for ragged walks (port of
columnar/buckets.py).

A whole-column padded view materializes ``n x max_len`` bytes, so one long
outlier would pad every row to its length.  Rows are grouped instead into
power-of-two length classes, and each class gets its own dense
``[rows, width]`` byte rectangle (:func:`padded_buckets`).  Ops consume the
classes through two drivers:

- :func:`map_buckets`: per-row fixed-shape outputs (parsed numbers,
  validity), scattered back into full-size ``[n, ...]`` tensors;
- :func:`strings_from_buckets`: per-row string outputs (each bucket yields
  its own padded result matrix), assembled into one Arrow-layout column.

:func:`class_buckets` / :func:`map_classes` split by an arbitrary small class
id instead (``float_to_string``'s specials / simple integers / full Ryu).
Bucket assignment is host metadata, as in the JAX package.  The JAX package also
pads each class's row count up to a power of two, which bounds XLA's set of
compiled shapes; eager torch compiles nothing, so the port compacts rows
exactly and its outputs are the same.  The hash kernel reads each row's bytes
straight from the Arrow buffer, so ``length_buckets`` alone serves it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar.column import StringColumn

# Narrowest padded bucket: strings shorter than this share one rectangle.
MIN_WIDTH = 32


@dataclasses.dataclass
class PaddedBucket:
    """One length class of a string column as a dense byte rectangle:
    ``bytes[i]`` is row ``rows[i]`` of the column, zero past ``lengths[i]``."""

    rows: torch.Tensor  # int64[n_rows] original row indices, ascending
    bytes: torch.Tensor  # uint8[n_rows, width]
    lengths: torch.Tensor  # int32[n_rows]
    width: int  # bucket width (a power of two, at least min_width)


def _next_pow2(v: torch.Tensor) -> torch.Tensor:
    """Element-wise next power of two of int64 ``v >= 1`` (exact, no float
    log), for values below 2**32."""
    v = v - 1
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    return v + 1


def length_buckets(lens: torch.Tensor, min_width: int = 1) -> List[Tuple[int, torch.Tensor]]:
    """Group row indices by power-of-two length class.

    Returns ``[(width, rows), ...]`` ordered by width, ``rows`` the int64
    indices (ascending, on ``lens``' device) of the rows whose length rounds
    up to ``width``; zero-length rows and rows shorter than ``min_width``
    land in the ``min_width`` class.  The same classes as the JAX package's
    ``length_buckets(lens, min_width, round_rows=False)``.
    """
    widths = torch.clamp(_next_pow2(torch.clamp(lens.to(torch.int64), min=1)), min=min_width)
    return [(w, torch.nonzero(widths == w).flatten())
            for w in torch.unique(widths).tolist()]


def class_buckets(classes: np.ndarray, n_classes: int) -> List[Tuple[int, np.ndarray]]:
    """Group row indices by a small class id in [0, n_classes): ``[(class_id,
    rows int64 ascending), ...]`` with empty classes left out.  ``classes``
    is host metadata (numpy)."""
    classes = np.asarray(classes)
    out = []
    for cid in range(n_classes):
        rows = np.nonzero(classes == cid)[0]
        if rows.size:
            out.append((cid, rows))
    return out


def map_classes(classes: np.ndarray, n_classes: int, kernel: Callable,
                out_init: Sequence[Tuple[tuple, torch.dtype]], *,
                row_args: Sequence[torch.Tensor]):
    """Run ``kernel(class_id, *row_args_for_class)`` per value class and
    scatter each output back into full-size tensors on ``row_args``' device.

    ``kernel`` returns a tuple matching ``out_init`` (``(trailing_shape,
    dtype)`` per output) with the class's row count as leading dim.  A
    column of one class skips the gather and the scatter.
    """
    n = len(np.asarray(classes))
    dev = row_args[0].device
    outs = [torch.zeros((n,) + tuple(shape), dtype=dt, device=dev) for shape, dt in out_init]
    for cid, rows_np in class_buckets(classes, n_classes):
        whole = rows_np.size == n
        rows = None if whole else torch.from_numpy(rows_np).to(dev)
        res = kernel(cid, *(row_args if whole else [a[rows] for a in row_args]))
        if not isinstance(res, (tuple, list)):
            res = (res,)
        if whole:
            return tuple(res)
        for o, r in zip(outs, res):
            o[rows] = r
    return tuple(outs)


def count_subbuckets(counts: np.ndarray, cap: int,
                     min_rows: int = 512) -> List[Tuple[np.ndarray, int]]:
    """Split one padded bucket's rows into power-of-two *count* classes.

    Second-axis companion to :func:`length_buckets`: a byte-width bucket
    bounds each row's padded width, but a per-row derived count (the JSON
    machine's token count) can still vary by orders of magnitude inside it,
    and lockstep consumers pay the bucket-wide maximum for every row.
    Grouping rows by ``next_pow2(counts)`` lets each class run with its own
    capacity.

    ``counts``: [n] per-row counts (``0 <= counts[i] <= cap``); ``cap``: the
    bucket-wide capacity (class capacities never exceed it); ``min_rows``:
    classes smaller than this merge into the next class up.  ``min_rows >=
    n`` degenerates to one class at ``cap``.  Returns ``[(rows int64
    ascending, class_cap), ...]`` with ascending ``class_cap``; every row
    appears in exactly one class.  Host metadata (numpy), as in the JAX
    package.
    """
    counts = np.asarray(counts)
    n = len(counts)
    if n == 0:
        return []
    cap = max(int(cap), 1)
    c = np.maximum(counts, 1).astype(np.int64) - 1
    for s in (1, 2, 4, 8, 16, 32):
        c |= c >> s
    widths = np.minimum(c + 1, cap)
    out: List[Tuple[np.ndarray, int]] = []
    pend: List[np.ndarray] = []
    pend_n = 0
    classes = sorted(set(widths.tolist()))
    for i, w in enumerate(classes):
        rows = np.nonzero(widths == w)[0].astype(np.int64)
        pend.append(rows)
        pend_n += len(rows)
        if pend_n >= min_rows or i == len(classes) - 1:
            out.append((np.sort(np.concatenate(pend)), int(w)))
            pend, pend_n = [], 0
    return out


def padded_buckets(col: StringColumn, min_width: int = MIN_WIDTH) -> List[PaddedBucket]:
    """Split ``col`` into power-of-two-width padded buckets, ordered by
    width (an empty column gives no bucket)."""
    if col.size == 0:
        return []
    lens = col.lengths()
    starts = col.offsets[:-1].to(torch.int64)
    nchars = col.chars.numel()
    out = []
    for w, rows in length_buckets(lens, min_width):
        blens = lens[rows]
        pos = torch.arange(w, dtype=torch.int64, device=col.device)
        in_row = pos[None, :] < blens[:, None]
        if nchars == 0:
            data = torch.zeros((rows.numel(), w), dtype=torch.uint8, device=col.device)
        else:
            idx = torch.clamp(starts[rows][:, None] + pos[None, :], max=nchars - 1)
            data = torch.where(in_row, col.chars[idx], 0)
        out.append(PaddedBucket(rows, data, blens, int(w)))
    return out


def map_buckets(col: StringColumn, kernel: Callable,
                out_init: Sequence[Tuple[tuple, torch.dtype]], *, min_width: int = MIN_WIDTH,
                row_args: Sequence[torch.Tensor] = ()):
    """Run ``kernel(bytes, lengths, *row_args_for_bucket)`` per bucket and
    scatter each output back into full-size tensors.

    ``kernel`` returns a tuple of tensors whose leading dim is the bucket's
    row count and whose trailing shape and dtype match ``out_init``.
    ``row_args`` are per-row tensors of the whole column (validity), gathered
    into each bucket before the call.  Returns the tuple of ``[n, *trailing]``
    tensors; a column of one bucket skips the scatter.
    """
    n = col.size
    buckets = padded_buckets(col, min_width=min_width)
    outs = [torch.zeros((n,) + tuple(shape), dtype=dt, device=col.device)
            for shape, dt in out_init]
    for b in buckets:
        whole = len(buckets) == 1
        res = kernel(b.bytes, b.lengths, *(row_args if whole else [a[b.rows] for a in row_args]))
        if not isinstance(res, (tuple, list)):
            res = (res,)
        if whole:
            return tuple(r.to(dt) for r, (_, dt) in zip(res, out_init))
        for o, r in zip(outs, res):
            o[b.rows] = r.to(o.dtype)
    return tuple(outs)


def strings_from_buckets(n: int, results: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                                         torch.Tensor]],
                         validity: Optional[torch.Tensor] = None) -> StringColumn:
    """Assemble per-bucket padded string results, ``(rows, padded[nb, w],
    lens[nb])`` each, into one StringColumn in the original row order;
    ``chars`` holds exactly the rows' bytes."""
    dev = results[0][1].device if results else torch.device("cpu")
    lens_full = torch.zeros((n,), dtype=torch.int32, device=dev)
    for rows, _, lens in results:
        lens_full[rows] = lens.to(torch.int32)
    offsets = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lens_full, 0, dtype=torch.int32)
    total = int(offsets[-1]) if n else 0
    chars = torch.zeros((total,), dtype=torch.uint8, device=dev)
    for rows, padded, lens in results:
        w = padded.shape[1]
        pos = torch.arange(w, dtype=torch.int64, device=dev)
        in_row = pos[None, :] < lens[:, None].to(torch.int64)
        tgt = offsets[:-1][rows].to(torch.int64)[:, None] + pos[None, :]
        chars[tgt[in_row]] = padded[in_row]
    return StringColumn(chars, offsets, validity)
